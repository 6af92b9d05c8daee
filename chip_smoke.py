#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, one JSON line each on stdout:
  1. build  — nvcc builds every kernel from csrc/ (one process per source,
     in parallel); the card's name and power limit; TF32 switched off so
     the plain versions run in full fp32.
  2. kernels — each kernel wrapper against its plain PyTorch version on the
     card, at the main path's shapes (CRONet medium, 4 slots): cronet_fused
     at fp32 and bf16, solve_b_fused with a mix of need flags, an idle slot,
     a warm start and a shape-padded (elem_mask) batch; times of both.
  3. fusion — (a) each per-op kernel (conv2d, conv3d, gemm, maxpool2d,
     adaptive_avg_pool2d/3d) against its plain version at CRONet medium's
     layer shapes and at odd shapes, fp32 and bf16, timed beside its plain
     version and the one PyTorch call for the same function; (b)
     core.fusion.infer on the none / l1 / l2l3 paths at small, medium and
     large (fp32) against core.cronet.forward at 1e-4, with the median
     latency of 30 synchronised calls and the launches per call; every
     per-op kernel must be launched by (b).
  4. serving — TopoServingEngine(device="cuda") on medium, 4 slots, serving
     8 requests of 20 iterations (the MBB case plus off-distribution point
     loads) once with error_threshold=0.1 and once with 1e9; cronet_fused
     and solve_b_fused must be launched by that phase.
  5. contracts — one tick at width 4 equals the same slots' tick at width 2
     bitwise, and park -> restore -> step equals an uninterrupted step.
Then the card's nvidia-smi line, one `kernels` JSON line (each kernel's
launches from the phase that drives its path: serving for cronet_fused and
solve_b_fused, fusion (b) for the per-op kernels), and last
{"ok": true, "device": {...}}. Exits nonzero, without the ok line, when
there is no CUDA GPU, when the port is not beside this script, or when
any phase fails. Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
U_SCALE = 50.0
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12         # fp32 outside the tensor cores


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call, CUDA events around `reps` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device milliseconds per call: `reps` calls captured in one CUDA
    graph, replayed `replays` times between CUDA events, so the host's
    Python and launch overhead is out of the time."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def problems(fea2d, cfg, n, seed=0):
    """The MBB load case plus off-distribution point loads, built as
    examples/serve_topo.py builds its requests."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i == 0:
            out.append(fea2d.point_load_problem(cfg.nelx, cfg.nely))
        else:
            out.append(fea2d.point_load_problem(
                cfg.nelx, cfg.nely,
                load_node=(int(rng.integers(0, cfg.nelx - 1)), 0),
                load=(0.0, float(-0.5 - rng.random()))))
    return out


# ------------------------------------------------------------------ phases


def phase_build(ctx):
    import torch
    from repro_torch.kernels import _build, build_all
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build_s = build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in _build.build_logs.items()}
    ctx["smi"] = nvidia_smi()
    emit({"phase": "build", "build_s": build_s, "nvidia_smi": ctx["smi"],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                         "matmul": torch.backends.cuda.matmul.allow_tf32},
          "ptxas": ptxas})


def phase_kernels(ctx):
    import numpy as np
    import torch
    from repro_torch.common import init_params
    from repro_torch.core.cronet import count_macs
    from repro_torch.fea import fea2d, hybrid
    from repro_torch.kernels import cg_fused, cronet_pipeline
    dev, cfg = ctx["device"], ctx["cfg"]
    B = 4
    gen = torch.Generator().manual_seed(0)
    p32 = hybrid.cast_params(init_params(cfg, seed=0, device=dev), "fp32")
    bp = fea2d.stack_problems(problems(fea2d, cfg, B), device=dev)
    lv = fea2d.load_volume_b(bp)
    hist = torch.rand((B, cfg.hist_len, cfg.nely, cfg.nelx, 1),
                      generator=gen).to(dev)
    rows = {}

    # -- cronet_fused, fp32: against core.cronet.forward at fp32
    out = cronet_pipeline.cronet_fused(cfg, p32, lv, hist)
    ref = cronet_pipeline.cronet_fused_plain(cfg, p32, lv, hist)
    sync()
    err32 = float((out - ref).abs().max())
    ok32 = bool(torch.allclose(out, ref, rtol=1e-4, atol=1e-4))
    k_ms = cuda_ms(lambda: cronet_pipeline.cronet_fused(cfg, p32, lv, hist),
                   reps=20)
    p_ms = cuda_ms(lambda: cronet_pipeline.cronet_fused_plain(
        cfg, p32, lv, hist), reps=5)
    # -- bf16 weights and inputs: against the plain version at bf16 (5% of
    # max |ref|: bf16 rounds every plain intermediate, the kernel keeps
    # fp32) and against fp32 arithmetic on the same bf16 values (1e-4)
    p16 = hybrid.cast_params(p32, "bf16")
    lv16, hist16 = lv.bfloat16(), hist.bfloat16()
    out16 = cronet_pipeline.cronet_fused(cfg, p16, lv16, hist16)
    ref16 = cronet_pipeline.cronet_fused_plain(cfg, p16, lv16, hist16)
    ref16_32 = cronet_pipeline.cronet_fused_plain(
        cfg, hybrid.cast_params(p16, "fp32"), lv16.float(), hist16.float())
    sync()
    err16 = float((out16 - ref16).abs().max())
    ok16 = err16 <= 0.05 * float(ref16.abs().max())
    err16_32 = float((out16 - ref16_32).abs().max())
    ok16_32 = bool(torch.allclose(out16, ref16_32, rtol=1e-4, atol=1e-4))
    k16_ms = cuda_ms(lambda: cronet_pipeline.cronet_fused(
        cfg, p16, lv16, hist16), reps=20)
    flops = 2.0 * count_macs(cfg)["total"] * B
    nbytes = 4 * (lv.numel() + hist.numel() + B * cfg.p
                  + sum(v.numel() for part in p32.values()
                        for v in part.values()))
    rows["cronet_fused"] = dict(
        name="cronet_fused", route="cuda",
        source="src/repro_torch/csrc/cronet_fused.cu",
        replaces="src/repro/kernels/cronet_pipeline.py:142",
        max_abs_err=err32, ms=k_ms, kernel_ms=k_ms, plain_ms=p_ms,
        **bound(nbytes, flops, H100_FP32_FLOPS), library_ms=None)
    emit({"phase": "kernel", "name": "cronet_fused", "B": B,
          "fp32": {"max_abs_err": err32, "tol": "rtol=atol=1e-4",
                   "ok": ok32, "kernel_ms": k_ms, "plain_ms": p_ms,
                   "max_abs_ref": float(ref.abs().max())},
          "bf16": {"max_abs_err_vs_plain_bf16": err16,
                   "tol_vs_plain_bf16": "0.05 * max|ref|", "ok": ok16,
                   "max_abs_err_vs_fp32_on_bf16_values": err16_32,
                   "tol_vs_fp32": "rtol=atol=1e-4", "ok_fp32": ok16_32,
                   "kernel_ms": k16_ms},
          "library_ms": None})

    # -- solve_b_fused: need mix, an idle slot, a warm start; then elem_mask
    probs = problems(fea2d, cfg, 3, seed=1)
    idle = fea2d.idle_problem(cfg.nelx, cfg.nely)
    bp = fea2d.stack_problems([probs[0], probs[1], idle, probs[2]],
                              device=dev)
    X = (0.2 + 0.8 * torch.rand((4, cfg.nely, cfg.nelx),
                                generator=gen)).to(dev)
    U0, _ = cg_fused.solve_b_plain(bp, X, max_iter=5)
    need = torch.tensor([True, False, True, True], device=dev)
    small = [fea2d.point_load_problem(cfg.nelx - 2, cfg.nely - 2,
                                      load_node=(i * (cfg.nelx // 6), 0),
                                      load=(0.0, -1.0 - 0.2 * i))
             for i in range(4)]
    bpm = fea2d.stack_problems([fea2d.pad_problem(p, cfg.nelx, cfg.nely)
                                for p in small], device=dev)
    Xm = bpm.elem_mask * (0.3 + 0.6 * torch.rand(
        (4, cfg.nely, cfg.nelx), generator=gen).to(dev))
    cases = {"need_idle_warm": (bp, X, U0, need),
             "elem_mask": (bpm, Xm, None, None)}
    cg_report, err_cg, its_total, cg_ok = {}, 0.0, 0, True
    for label, (b, x, u0, nd) in cases.items():
        U, its = cg_fused.solve_b_fused(b, x, U0=u0, need=nd)
        Ur, itr = cg_fused.solve_b_plain(b, x, U0=u0, need=nd)
        sync()
        rel = ((U - Ur).norm(dim=1)
               / Ur.norm(dim=1).clamp_min(1e-30)).cpu().numpy()
        dits = (its - itr).abs().cpu().numpy()
        ok = bool(np.all(rel <= 1e-4) and np.all(dits <= 1))
        if nd is not None:   # the need=False slot keeps its warm start
            ok = ok and bool(torch.equal(U[1], (u0 * b.free_mask)[1]))
            ok = ok and int(its[1]) == 0 and int(its[2]) == 0
        cg_ok = cg_ok and ok
        err_cg = max(err_cg, float((U - Ur).abs().max()))
        its_total += int(its.sum())
        cg_report[label] = {"rel_l2": rel.tolist(),
                            "its": its.cpu().tolist(),
                            "its_plain": itr.cpu().tolist(),
                            "bitwise": bool(torch.equal(U, Ur)), "ok": ok}
    b, x, u0, nd = cases["need_idle_warm"]
    k_ms = cuda_ms(lambda: cg_fused.solve_b_fused(b, x, U0=u0, need=nd),
                   reps=10)
    p_ms = cuda_ms(lambda: cg_fused.solve_b_plain(b, x, U0=u0, need=nd),
                   reps=2)
    its_warm = cg_report["need_idle_warm"]["its"]
    ne, ndof = cfg.nelx * cfg.nely, 2 * (cfg.nelx + 1) * (cfg.nely + 1)
    # per slot iteration: KE apply (8 rows x 15) + e scale (8) per element;
    # assembly (3), free mask (1), two dots, two axpys, precondition (2),
    # P update and norm (2 each) per dof
    flops = float(sum(its_warm)) * (ne * 128 + ndof * 18)
    nbytes = 4 * (B * ne + 7 * B * ndof)
    rows["solve_b_fused"] = dict(
        name="solve_b_fused", route="cuda",
        source="src/repro_torch/csrc/cg_fused.cu",
        replaces="src/repro/kernels/cg_fused.py:194",
        max_abs_err=err_cg, ms=k_ms, kernel_ms=k_ms, plain_ms=p_ms,
        **bound(nbytes, flops, H100_FP32_FLOPS), library_ms=None)
    emit({"phase": "kernel", "name": "solve_b_fused", "cases": cg_report,
          "tol": "U rel L2 <= 1e-4, iterations +-1", "ok": cg_ok,
          "kernel_ms": k_ms, "plain_ms": p_ms, "iterations_timed": its_warm,
          "library_ms": None})
    ctx["rows"] = rows
    if not (ok32 and ok16 and ok16_32 and cg_ok):
        raise AssertionError("a kernel disagrees with its plain version")


def _valid_taps(n: int, k: int, causal: bool) -> int:
    """Taps of a k-wide filter that land inside n inputs, summed over the n
    outputs: SAME (centred) or causal (d .. d+k-1) padding."""
    lo = 0 if causal else k // 2
    return sum(1 for o in range(n) for t in range(k) if 0 <= o + t - lo < n)


def fusion_cases(cfg):
    """The per-op calls of one CRONet forward on the l1 path, per kernel:
    (label, times per forward, shape arguments)."""
    H, W = cfg.nodes
    T, ny, nx = cfg.hist_len, cfg.nely, cfg.nelx
    return {
        "conv3d": [("trunk1", 1, dict(x=(1, cfg.t_depth, H, W, 1),
                                      w=(2, 3, 3, 1, cfg.t_c1),
                                      depth_padding="causal_same")),
                   ("trunk2", 1, dict(x=(1, cfg.t_depth, H, W, cfg.t_c1),
                                      w=(1, 3, 3, cfg.t_c1, cfg.t_c2),
                                      depth_padding="same"))],
        "conv2d": [("branch1", 1, dict(x=(T, ny, nx, 1),
                                       w=(3, 3, 1, cfg.b_c1))),
                   ("branch2", 1, dict(x=(T, ny, nx, cfg.b_c1),
                                       w=(3, 3, cfg.b_c1, cfg.b_c2))),
                   ("odd_7x9", 0, dict(x=(2, 7, 9, 3), w=(3, 3, 3, 5)))],
        "gemm": [("trunk_fc1", 1, dict(m=1, k=cfg.trunk_features, n=cfg.mid,
                                       act="silu")),
                 ("fc2", 2, dict(m=1, k=cfg.mid, n=cfg.p, act=None)),
                 ("rnn_wx", T, dict(m=1, k=cfg.branch_features,
                                    n=cfg.rnn_hidden, act=None)),
                 ("rnn_wh", T, dict(m=1, k=cfg.rnn_hidden, n=cfg.rnn_hidden,
                                    act=None)),
                 ("branch_fc1", 1, dict(m=1, k=cfg.rnn_hidden, n=cfg.mid,
                                        act="silu")),
                 ("odd_33x70x9", 0, dict(m=33, k=70, n=9, act="tanh"))],
        "maxpool2d": [("branch", 1, dict(x=(T, ny, nx, cfg.b_c2))),
                      ("odd_7x9", 0, dict(x=(3, 7, 9, 8)))],
        "adaptive_avg_pool2d": [("branch", 1, dict(
            x=(T, ny // 2, nx // 2, cfg.b_c2), out=cfg.b_pool)),
            ("odd_7x9", 0, dict(x=(2, 7, 9, 6), out=(3, 4)))],
        "adaptive_avg_pool3d": [("trunk", 1, dict(
            x=(1, cfg.t_depth, H, W, cfg.t_c2), out=cfg.t_pool))],
    }


def fusion_call(name, args, dt, dev, gen):
    """(kernel call, plain call, library call, bytes, flops) for one case,
    on inputs made from ``gen``; the library call is the one PyTorch call
    that computes the same function (without a fused activation)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import conv, gemm, pool

    def rand(shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dt).to(dev)

    es = torch.empty((), dtype=dt).element_size()
    if name in ("conv2d", "conv3d"):
        x, w = rand(args["x"], 0.5), rand(args["w"], 0.3)
        cin, cout = w.shape[-2:]
        if name == "conv2d":
            B, H, W_ = x.shape[:3]
            D, kd, causal = 1, 1, False
            xc = x.permute(0, 3, 1, 2)                  # channels_last view
            wc = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            lib = lambda: F.conv2d(xc, wc, padding=1)  # noqa: E731
            kern = lambda fs: conv.conv2d(x, w, fuse_silu=fs)  # noqa: E731
            plain = lambda fs: conv.conv2d_plain(x, w, fuse_silu=fs)  # noqa
        else:
            B, D, H, W_ = x.shape[:4]
            kd = w.shape[0]
            dp = args["depth_padding"]
            causal = dp == "causal_same"
            xc = x.permute(0, 4, 1, 2, 3)
            wc = w.permute(4, 3, 0, 1, 2).contiguous(
                memory_format=torch.channels_last_3d)
            # symmetric depth padding kd-1: its last D slices are the
            # causal output (one extra slice of work for kd = 2)
            lib = lambda: F.conv3d(xc, wc, padding=(kd - 1, 1, 1))  # noqa
            kern = lambda fs: conv.conv3d(x, w, depth_padding=dp,  # noqa
                                          fuse_silu=fs)
            plain = lambda fs: conv.conv3d_plain(  # noqa: E731
                x, w, depth_padding=dp, fuse_silu=fs)
        macs = (B * _valid_taps(D, kd, causal) * _valid_taps(H, 3, False)
                * _valid_taps(W_, 3, False) * cin * cout)
        nbytes = es * (x.numel() + w.numel() + B * D * H * W_ * cout)
        return kern, plain, lib, nbytes, 2.0 * macs
    if name == "gemm":
        m, k, n = args["m"], args["k"], args["n"]
        x, w = rand((m, k), 0.3), rand((k, n), 0.3)
        act = args["act"]
        return (lambda fs: gemm.gemm(x, w, activation=act),
                lambda fs: gemm.gemm_plain(x, w, act),
                lambda: torch.matmul(x, w),
                es * (m * k + k * n + m * n), 2.0 * m * k * n)
    x = rand(args["x"])
    if name == "maxpool2d":
        B, H, W_, C = x.shape
        xc = x.permute(0, 3, 1, 2)
        return (lambda fs: pool.maxpool2d(x, 2),
                lambda fs: pool.maxpool2d_plain(x, 2),
                lambda: F.max_pool2d(xc, 2),
                es * (x.numel() + B * (H // 2) * (W_ // 2) * C),
                3.0 * B * (H // 2) * (W_ // 2) * C)
    out = args["out"]
    dims = x.shape[1:-1]
    adds = x.shape[0] * x.shape[-1]
    for n_in, n_out in zip(dims, out):
        s, e = pool.adaptive_bounds(n_in, n_out)
        adds *= sum(b - a for a, b in zip(s, e))
    nbytes = es * (x.numel() + x.shape[0] * x.shape[-1] * math.prod(out))
    if name == "adaptive_avg_pool2d":
        xc = x.permute(0, 3, 1, 2)
        return (lambda fs: pool.adaptive_avg_pool2d(x, out),
                lambda fs: pool.adaptive_avg_pool2d_plain(x, out),
                lambda: F.adaptive_avg_pool2d(xc, out), nbytes, float(adds))
    xc = x.permute(0, 4, 1, 2, 3)
    return (lambda fs: pool.adaptive_avg_pool3d(x, out),
            lambda fs: pool.adaptive_avg_pool3d_plain(x, out),
            lambda: F.adaptive_avg_pool3d(xc, out), nbytes, float(adds))


FUSION_TOL = {"float32": (2e-5, 2e-4), "bfloat16": (2e-2, 2e-1)}
FUSION_SOURCES = {
    "conv2d": ("conv.cu", "src/repro/kernels/conv.py:44"),
    "conv3d": ("conv.cu", "src/repro/kernels/conv.py:82"),
    "gemm": ("gemm.cu", "src/repro/kernels/gemm.py:48"),
    "maxpool2d": ("pool.cu", "src/repro/kernels/pool.py:34"),
    "adaptive_avg_pool2d": ("pool.cu", "src/repro/kernels/pool.py:58"),
    "adaptive_avg_pool3d": ("pool.cu", "src/repro/kernels/pool.py:89"),
}


def phase_fusion(ctx):
    """(a) each per-op kernel against its plain version at CRONet medium's
    layer shapes and odd shapes, fp32 and bf16, timed beside its plain
    version and the one PyTorch call for the same function; (b)
    fusion.infer on none / l1 / l2l3 at small, medium and large (fp32)
    against core.cronet.forward, with latency and launches per call."""
    import dataclasses
    import functools
    import statistics
    import torch
    from repro_torch import kernels
    from repro_torch.common import init_params
    from repro_torch.configs.cronet import get_cronet_config
    from repro_torch.core import cronet, fusion
    from repro_torch.fea import fea2d
    dev = ctx["device"]
    gen = torch.Generator().manual_seed(1)
    ok_all, per_kernel = True, {}
    for name, cases in fusion_cases(ctx["cfg"]).items():
        rep = {"cases": {}, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "call_ms": 0.0, "bytes": 0.0, "flops": 0.0,
               "max_abs_err": 0.0}
        for label, per_fwd, args in cases:
            for dname, dt in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
                kern, plain, lib, nbytes, flops = fusion_call(
                    name, args, dt, dev, gen)
                rtol, atol = FUSION_TOL[dname]
                errs, ok = [], True
                for fs in (False, True):     # convolutions: SiLU off / on
                    out, ref = kern(fs), plain(fs)
                    sync()
                    ok = ok and out.dtype == dt and bool(torch.allclose(
                        out.float(), ref.float(), rtol=rtol, atol=atol))
                    errs.append(float((out.float() - ref.float())
                                      .abs().max()))
                ok_all = ok_all and ok
                case = {"max_abs_err": max(errs), "ok": ok,
                        "tol": f"rtol={rtol} atol={atol}"}
                if dname == "float32":      # timed as the l1 path calls it
                    case.update(
                        ms=graph_ms(lambda: kern(True)),
                        plain_ms=graph_ms(lambda: plain(True)),
                        library_ms=graph_ms(lib),
                        call_ms=cuda_ms(lambda: kern(True), reps=50),
                        **bound(nbytes, flops, H100_FP32_FLOPS))
                    rep["max_abs_err"] = max(rep["max_abs_err"], max(errs))
                    if per_fwd:
                        for key in ("ms", "plain_ms", "library_ms",
                                    "call_ms"):
                            rep[key] += per_fwd * case[key]
                        rep["bytes"] += per_fwd * nbytes
                        rep["flops"] += per_fwd * flops
                rep["cases"][f"{label}/{dname}"] = case
        per_kernel[name] = rep
        emit({"phase": "fusion_kernel", "name": name, **rep})

    # (b) the three paths, driven through fusion.infer
    paths = {"none": fusion.FusionConfig(False, False, False),
             "l1": fusion.FusionConfig(True, False, False),
             "l2l3": fusion.FusionConfig(True, True, True)}
    kernels.reset_launch_counts()
    latency, graphed = {}, {}
    for size in ("small", "medium", "large"):
        cfg = dataclasses.replace(get_cronet_config(size), dtype="float32")
        params = init_params(cfg, seed=0, device=dev)
        bp = fea2d.stack_problems([fea2d.mbb_problem(cfg.nelx, cfg.nely)],
                                  device=dev)
        lv = fea2d.load_volume_b(bp)[0]
        hist = torch.rand((cfg.hist_len, cfg.nely, cfg.nelx, 1),
                          generator=gen).to(dev)
        ref = cronet.forward(cfg, params, lv[None], hist[None])[0]
        for pname, fc in paths.items():
            out = fusion.infer(cfg, params, lv, hist, fc)
            sync()
            err = float((out - ref).abs().max())
            ok = bool(torch.allclose(out, ref, rtol=1e-4, atol=1e-4))
            ok = ok and out.shape == ref.shape and bool(
                torch.isfinite(out).all())
            ok_all = ok_all and ok
            for _ in range(5):                   # warm-up
                fusion.infer(cfg, params, lv, hist, fc)
            before = sum(kernels.launch_counts().values())
            walls = []
            for _ in range(30):
                t0 = time.perf_counter()
                fusion.infer(cfg, params, lv, hist, fc)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            per_call = (sum(kernels.launch_counts().values()) - before) / 30
            graphed[f"{pname}/{size}"] = functools.partial(
                fusion.infer, cfg, params, lv, hist, fc)
            latency[f"{pname}/{size}"] = {
                "median_ms": statistics.median(walls), "min_ms": min(walls),
                "launches_per_call": per_call, "max_abs_err": err,
                "tol": "rtol=atol=1e-4", "ok": ok}
    counts = kernels.launch_counts()
    ctx["fusion_launches"] = counts
    # device time of a forward without the host: the path in a CUDA graph
    # (after the counts are read: capture is not a run of the path)
    for key, fn in graphed.items():
        latency[key]["graph_device_ms"] = graph_ms(fn, reps=5)
    emit({"phase": "fusion", "latency_ms": latency, "launches": counts})

    for name, rep in per_kernel.items():
        src, replaces = FUSION_SOURCES[name]
        ctx["rows"][name] = dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{src}",
            replaces=replaces, max_abs_err=rep["max_abs_err"], ms=rep["ms"],
            call_ms=rep["call_ms"], plain_ms=rep["plain_ms"],
            **bound(rep["bytes"], rep["flops"], H100_FP32_FLOPS),
            library_ms=rep["library_ms"])
    if not ok_all:
        raise AssertionError("a per-op kernel or a fusion path disagrees "
                             "with its plain version")
    missing = [n for n in FUSION_SOURCES if counts[n] == 0]
    if missing:
        raise AssertionError(f"fusion paths never launched {missing}")


def bound(nbytes: float, flops: float, peak: float) -> dict:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def phase_serving(ctx):
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.common import init_params
    from repro_torch.fea import fea2d
    from repro_torch.serve.topo_service import TopoServingEngine
    from repro_torch.serve.types import TopoRequest
    cfg = ctx["cfg"]
    params = init_params(cfg, seed=0, device=ctx["device"])
    kernels.reset_launch_counts()
    runs = {}
    for thr in (0.1, 1e9):
        eng = TopoServingEngine(cfg, params, U_SCALE, slots=4,
                                error_threshold=thr, device=ctx["device"])
        reqs = [TopoRequest(uid=i, problem=p, n_iter=20)
                for i, p in enumerate(problems(fea2d, cfg, 8))]
        t0 = time.perf_counter()
        done = eng.run(reqs)
        wall = time.perf_counter() - t0
        eng.shutdown()
        stats = eng.throughput_stats(wall_s=wall)
        comp = [r.compliance for r in done]
        runs[str(thr)] = {
            "wall_s": wall, "problems_per_s": stats["problems_per_s"],
            "p50_latency_s": stats["p50_latency_s"],
            "p99_latency_s": stats["p99_latency_s"],
            "cronet_iters": [r.cronet_iters for r in done],
            "fea_iters": [r.fea_iters for r in done],
            "cg_iters": [r.cg_iters for r in done], "compliance": comp}
        if not (all(r.done for r in done) and np.all(np.isfinite(comp))):
            raise AssertionError(f"threshold {thr}: unfinished or "
                                 "non-finite request")
    counts = kernels.launch_counts()
    ctx["launches"] = counts
    emit({"phase": "serving", "mesh": f"{cfg.nelx}x{cfg.nely}", "slots": 4,
          "requests": 8, "n_iter": 20, "runs": runs, "launches": counts})
    if sum(runs["1000000000.0"]["cronet_iters"]) == 0:
        raise AssertionError("surrogate never accepted at threshold 1e9")
    if min(counts["cronet_fused"], counts["solve_b_fused"]) == 0:
        raise AssertionError(f"a kernel was not launched: {counts}")


def phase_contracts(ctx):
    import torch
    from repro_torch.common import init_params
    from repro_torch.fea import fea2d, hybrid
    dev, cfg = ctx["device"], ctx["cfg"]
    params = hybrid.cast_params(init_params(cfg, seed=0, device=dev), "fp32")
    step = hybrid.make_hybrid_step(cfg, U_SCALE, 1e9, 3, 1.5, "fp32")
    probs = problems(fea2d, cfg, 4, seed=2)
    b4 = fea2d.stack_problems(probs, device=dev)
    b2 = fea2d.stack_problems(probs[:2], device=dev)
    lv4, lv2 = fea2d.load_volume_b(b4), fea2d.load_volume_b(b2)
    s4 = hybrid.init_state(cfg, b4)
    for _ in range(cfg.hist_len):
        s4 = step(params, b4, lv4, s4)
    s2 = hybrid.HybridState(*[t[:2].clone() for t in s4])

    def same(a, b, la, lb):
        return all(torch.equal(x[la], y[lb]) for x, y in zip(a, b))

    width_ok = True
    for _ in range(3):      # a surrogate tick, then a forced-FEA tick
        s4 = step(params, b4, lv4, s4)
        s2 = step(params, b2, lv2, s2)
        width_ok = width_ok and same(s4, s2, slice(0, 2), slice(0, 2))
    ref = step(params, b4, lv4, hybrid.HybridState(*[t.clone() for t in s4]))
    parked = hybrid.park_slot(s4, 1)
    hybrid.reset_slot(cfg, s4, 1, 0.5)
    hybrid.restore_slot(s4, 1, parked)
    park_ok = same(step(params, b4, lv4, s4), ref, slice(None), slice(None))
    emit({"phase": "contracts", "width4_vs_width2_bitwise": width_ok,
          "park_restore_bitwise": park_ok,
          "n_cronet": s4.n_cronet.cpu().tolist(),
          "n_fea": s4.n_fea.cpu().tolist()})
    if not (width_ok and park_ok):
        raise AssertionError("a bitwise contract failed on the card")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU; nothing to drive", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port is not beside this script "
              f"({SRC / 'repro_torch'} missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs.cronet import get_cronet_config
    ctx = {"device": torch.device("cuda"), "cfg": get_cronet_config("medium")}
    t0 = time.perf_counter()
    for phase in (phase_build, phase_kernels, phase_fusion, phase_serving,
                  phase_contracts):
        try:
            phase(ctx)
        except Exception:
            traceback.print_exc()
            print(f"chip_smoke: {phase.__name__} failed", file=sys.stderr)
            return 1
    kernels = []
    for name, row in ctx["rows"].items():
        phase = "fusion_launches" if name in FUSION_SOURCES else "launches"
        kernels.append({**row, "launches": ctx[phase][name]})
    print(ctx["smi"], flush=True)
    emit({"total_s": time.perf_counter() - t0})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
