"""Where a serving tick's time goes, on one NVIDIA GPU.

    PYTHONPATH=src python -m repro_torch.profile_tick [--out FILE]

Builds the serving path's tick at CRONet medium (30x20 mesh, 4 slots,
random weights from seed 0, u_scale 50, the MBB case plus off-distribution
point loads), runs it past the 10-tick warm-up, then reports as one JSON
object:
  * tick_ms — host wall time per tick (synchronised), mean over 12 ticks;
  * stages_ms — each stage of the tick alone, synchronised, mean over 5
    repetitions on the same warm state: the CRONet forward + decoder,
    the CG solve (every slot needing FEA), compliance and sensitivity,
    the sensitivity filter, the OC update;
  * profile — torch.profiler over 6 ticks: device time per kernel name
    (top 12), total device time, wall time, the device's idle share of the
    window, and launches per tick.
Requires a CUDA GPU; writes nothing but ``--out`` when given.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch


def _problems(fea2d, cfg, n):
    rng = np.random.default_rng(0)
    out = [fea2d.point_load_problem(cfg.nelx, cfg.nely)]
    for _ in range(n - 1):
        out.append(fea2d.point_load_problem(
            cfg.nelx, cfg.nely,
            load_node=(int(rng.integers(0, cfg.nelx - 1)), 0),
            load=(0.0, float(-0.5 - rng.random()))))
    return out


def _ms(fn, reps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def profile() -> dict:
    from repro_torch.common import init_params, resolve_device
    from repro_torch.configs.cronet import get_cronet_config
    from repro_torch.core import cronet
    from repro_torch.fea import fea2d, hybrid, simp
    from repro_torch.kernels import build_all, cronet_pipeline

    dev = resolve_device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build_all()
    cfg, slots, threshold = get_cronet_config("medium"), 4, 1e9
    params = hybrid.cast_params(init_params(cfg, 0, device=dev), "fp32")
    bp = fea2d.stack_problems(_problems(fea2d, cfg, slots), device=dev)
    lv = fea2d.load_volume_b(bp)
    step = hybrid.make_hybrid_step(cfg, 50.0, threshold, 3, 1.5, "fp32")
    state = hybrid.init_state(cfg, bp)
    for _ in range(cfg.hist_len + 2):
        state = step(params, bp, lv, state)
    torch.cuda.synchronize()

    ticks = 12
    t0 = time.perf_counter()
    s = state
    for _ in range(ticks):
        s = step(params, bp, lv, s)
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t0) / ticks * 1e3

    x, u = state.x, state.u
    need = torch.ones((slots,), dtype=torch.bool, device=dev)
    filt = simp.make_filter_b(cfg.nelx, cfg.nely)
    _, dc = fea2d.compliance_and_sens_b(bp, x, u)
    dc_f = filt(x, dc)
    dv = torch.ones_like(x[0]) / (cfg.nelx * cfg.nely)
    stages = {
        "forward_decode": _ms(lambda: cronet.decode_to_dofs(
            cfg, cronet_pipeline.cronet_fused(
                cfg, params, lv, state.hist[..., None])), 5),
        "cg_solve": _ms(lambda: fea2d.solve_b(bp, x, U0=u, need=need), 5),
        "compliance_sens": _ms(lambda: fea2d.compliance_and_sens_b(
            bp, x, u), 5),
        "filter": _ms(lambda: filt(x, dc), 5),
        "oc_update": _ms(lambda: simp.oc_update_b(x, dc_f, dv, bp.volfrac),
                         5),
    }

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    window = 6
    s = state
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(window):
            s = step(params, bp, lv, s)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / 1e3)
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return {
        "card": smi, "size": "medium", "slots": slots,
        "threshold": threshold,
        "tick_ms": tick_ms, "stages_ms": stages,
        "profile": {"ticks": window, "wall_ms": wall_ms,
                    "device_ms": device_ms,
                    "idle_share": max(0.0, 1.0 - device_ms / wall_ms),
                    "launches_per_tick": len(kernels) / window,
                    "top_kernels_ms": top},
        "n_cronet": s.n_cronet.cpu().tolist(), "n_fea": s.n_fea.cpu().tolist(),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    res = profile()
    text = json.dumps(res)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
