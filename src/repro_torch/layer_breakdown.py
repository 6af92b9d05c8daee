"""Paper Fig 7 on one NVIDIA GPU: each CRONet layer's share of the forward,
and the LUT-vs-exact SiLU comparison (paper §IV-D4).

    PYTHONPATH=src python -m repro_torch.layer_breakdown [--size medium]
        [--out FILE]

A port of ``benchmarks/layer_breakdown.py``, with its inputs: ones-valued
bf16 load volume and density history, weights from seed 0 in ``cfg.dtype``
(bf16), and a 2^14-element fp32 normal vector for SiLU. Each layer is one
call of its per-op kernel wrapper (``kernels/{conv,gemm,pool}``), each SiLU
one call of ``kernels/silu``. ``run`` returns the JAX module's rows,
``(name, microseconds per call, note)``: ``fig7/<layer>`` for the eight
layers and ``fig7/silu_lut`` with the exact SiLU beside it. On a CUDA
device the microseconds are CUDA-event times of synchronised eager calls
(the host's launch overhead included), and the note adds each call's device
time from CUDA-graph replay; the shares are of the summed device time, as
the paper's Fig 7 shares are of the device's. On the CPU (``device="cpu"``,
the plain versions) both are host wall times.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

PAPER_SHARES = {"branch/conv2d": 55.3, "trunk/aap3d": 18.1}


def _time_cpu(fn, reps: int = 3) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def _times(fn, cuda: bool):
    """(microseconds per call, device microseconds per call or None)."""
    if not cuda:
        return _time_cpu(fn), None
    from repro_torch.timing import cuda_ms, graph_ms
    return cuda_ms(fn, reps=20, warmup=3) * 1e3, graph_ms(fn) * 1e3


def run(size: str = "medium", device="cuda"):
    from repro_torch.common import init_params, resolve_device
    from repro_torch.configs.cronet import get_cronet_config
    from repro_torch.kernels import conv, gemm, pool, silu

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    cfg = get_cronet_config(size)
    params = init_params(cfg, seed=0, device=dev)
    tr, br = params["trunk"], params["branch"]
    bf16 = torch.bfloat16
    lv = torch.ones((1, 4, cfg.nely + 1, cfg.nelx + 1, 1), dtype=bf16,
                    device=dev)
    hist = torch.ones((cfg.hist_len, cfg.nely, cfg.nelx, 1), dtype=bf16,
                      device=dev)

    t1 = conv.conv3d(lv, tr["conv1"], depth_padding="causal_same",
                     fuse_silu=True)
    t2 = conv.conv3d(t1, tr["conv2"], fuse_silu=True)
    b1 = conv.conv2d(hist, br["conv1"], fuse_silu=True)
    b2 = conv.conv2d(b1, br["conv2"], fuse_silu=True)
    mp = pool.maxpool2d(b2)
    tfeat = pool.adaptive_avg_pool3d(t2, cfg.t_pool).reshape(1, -1)

    layers = {
        "trunk/conv3d1": lambda: conv.conv3d(lv, tr["conv1"],
                                             depth_padding="causal_same",
                                             fuse_silu=True),
        "trunk/conv3d2": lambda: conv.conv3d(t1, tr["conv2"], fuse_silu=True),
        "trunk/aap3d": lambda: pool.adaptive_avg_pool3d(t2, cfg.t_pool),
        "trunk/linear": lambda: gemm.gemm(tfeat, tr["fc1"], activation="silu"),
        "branch/conv2d": lambda: conv.conv2d(hist, br["conv1"], fuse_silu=True),
        "branch/conv2d2": lambda: conv.conv2d(b1, br["conv2"], fuse_silu=True),
        "branch/maxpool": lambda: pool.maxpool2d(b2),
        "branch/aap2d": lambda: pool.adaptive_avg_pool2d(mp, cfg.b_pool),
    }
    times = {k: _times(fn, cuda) for k, fn in layers.items()}
    share_of = {k: (dev_us if cuda else us) for k, (us, dev_us)
                in times.items()}
    total = sum(share_of.values())
    rows = []
    for k, (us, dev_us) in times.items():
        share = 100 * share_of[k] / total
        paper = PAPER_SHARES.get(k.replace("conv2d2", "conv2d"), None)
        note = (f"share={share:.1f}%"
                + (f" (paper {paper}%)" if paper else "")
                + (f" device_us={dev_us:.2f}" if cuda else ""))
        rows.append((f"fig7/{k}", round(us, 1), note))

    # LUT vs exact SiLU (the paper's AIE-ML trick, on the H100)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((1 << 14,), generator=gen).to(dev)
    us_lut, dev_lut = _times(lambda: silu.silu_lut(x), cuda)
    us_exact, dev_exact = _times(lambda: silu.silu_exact(x), cuda)
    faster = (dev_lut < dev_exact) if cuda else (us_lut < us_exact)
    rows.append(("fig7/silu_lut", round(us_lut, 1),
                 f"exact={us_exact:.1f}us"
                 + (f" device_us lut={dev_lut:.2f} exact={dev_exact:.2f}"
                    if cuda else "")
                 + f" -> LUT pays on AIE, {'' if faster else 'not '}on "
                 + ("the GPU" if cuda else "the CPU")))
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", default="medium",
                    choices=["small", "medium", "large"])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = run(args.size)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    text = json.dumps({"card": smi, "size": args.size, "rows": rows})
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
