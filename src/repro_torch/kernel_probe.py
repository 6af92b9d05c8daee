"""Where the GEMV's and the CG solve's device time goes, on one NVIDIA GPU.

    PYTHONPATH=src python -m repro_torch.kernel_probe [--out FILE]

GEMV (csrc/gemm.cu): every GEMM of one CRONet medium ``l1`` forward, fp32
and bf16, timed by CUDA-graph replay under gemm_plan's plan and under the
plans it was chosen over (trunk fc1 with a cluster of 1, 2 and 4 blocks;
half and double the k lanes, and column tiles a quarter as wide,
elsewhere), beside an ``empty`` build of the
same source (the kernel returns at once: the launch floor of that grid and
cluster) and ``torch.matmul``.

CG (csrc/cg_fused.cu): the need_idle_warm batch of chip_smoke.py (CRONet
medium, 4 slots, a warm start, one idle and one need=False slot) run for a
fixed number of iterations (the loop's convergence test is cut, so every
build runs the same count) with one phase of the iteration taken out: the
stencil (K p becomes p), the two folds (each thread keeps its own value:
no barriers) or the IEEE division of the Jacobi step; ``skeleton`` takes
out all three. The full build runs at 128, 256, 512 and 1,024 threads a
block, the cut builds at block_threads' count. Per-iteration us = (time
at N iterations - time at 0) / N; the time at 0 is the launch, the
in-kernel setup and the write-out. A ``timed`` build counts the SM cycles
of each phase of an iteration (clock64 in thread 0, barrier waits
included) at 256, 512 and 1,024 threads. Beside them: a ``solve_b_fused`` call, eager and by graph replay, and the
device kernels torch.profiler sees in it.

Outputs of the cut builds are not results; only their times are read. The
phases are cut by editing a copy of each source at fixed anchors: an anchor
that is no longer found raises, so the probe follows the kernels or fails
loudly.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

GEMM_HOOKS = [  # (anchor, replacement)
    ("  __shared__ float part[kMaxWarps][kMaxCols];",
     "#ifdef EMPTY\n  if (M > 0) return;\n#endif\n"
     "  __shared__ float part[kMaxWarps][kMaxCols];"),
]
CG_HOOKS = [
    ("while (need_b && fnorm > 0.0f && rnorm > tol * fnorm && its < max_iter)",
     "while (need_b && its < max_iter)"),
    ("      const float2 k = stencil(P2, sh, geo[r], ee[r], KE);",
     "#ifdef NO_STENCIL\n      const float2 k = P2[geo[r].corner + sh + 1];\n"
     "#else\n      const float2 k = stencil(P2, sh, geo[r], ee[r], KE);\n"
     "#endif"),
    ("  for (int h = NPT / 2; h >= 1; h >>= 1)       // registers: the top",
     "#ifdef NO_FOLD\n#pragma unroll\n  for (int s = 0; s < NS; ++s) "
     "out[s] = v[s][0][0] + v[s][0][1];\n  if (nl > 0) return;\n#endif\n"
     "#pragma unroll\n"
     "  for (int h = NPT / 2; h >= 1; h >>= 1)       // registers: the top"),
    ("        const float z = rr / dg[r][c] * fr[r][c];",
     "#ifdef NO_DIV\n        const float z = rr * dg[r][c] * fr[r][c];\n"
     "#else\n        const float z = rr / dg[r][c] * fr[r][c];\n#endif"),
]
# the timed build: SM cycles (clock64) of each phase of an iteration, as
# thread 0 sees them (the barriers' waits included), summed over the solve
# and written over the first values of the slot's output
CG_PHASES = ("stencil", "fold1", "update", "fold2", "p_store", "barrier")
CG_HOOKS += [
    ("  int its = 0;\n  while (need_b",
     "#ifdef TIMED\n  long long t_acc[6] = {0, 0, 0, 0, 0, 0};\n"
     "  long long t0 = clock64();\n#define MARK(k) { const long long t1 = "
     "clock64(); t_acc[k] += t1 - t0; t0 = t1; }\n#else\n#define MARK(k)\n"
     "#endif\n  int its = 0;\n  while (need_b"),
    ("    float pkp[1];", "    MARK(0)\n    float pkp[1];"),
    ("    const float alpha = rz / clamp_min_nan(pkp[0], 1e-30f);",
     "    MARK(1)\n    const float alpha = rz / clamp_min_nan(pkp[0], 1e-30f);"),
    ("    float sums[2];", "    MARK(2)\n    float sums[2];"),
    ("    const float beta = sums[0] / clamp_min_nan(rz, 1e-30f);",
     "    MARK(3)\n    const float beta = sums[0] / clamp_min_nan(rz, 1e-30f);"),
    ("    rnorm = sqrtf(sums[1]);", "    MARK(4)\n    rnorm = sqrtf(sums[1]);"),
    ("    __syncthreads();                      // P is published\n",
     "    __syncthreads();                      // P is published\n"
     "    MARK(5)\n"),
    ("  if (tid == 0) its_out[b] = its;",
     "#ifdef TIMED\n  __syncthreads();\n  if (tid == 0)\n"
     "    for (int k = 0; k < 6; ++k) Uout[off + k] = (float)t_acc[k];\n"
     "#endif\n  if (tid == 0) its_out[b] = its;"),
]
GEMM_BUILDS = {"full": [], "empty": ["EMPTY"]}
CG_BUILDS = {"full": [], "no_stencil": ["NO_STENCIL"], "no_fold": ["NO_FOLD"],
             "no_div": ["NO_DIV"],
             "skeleton": ["NO_STENCIL", "NO_FOLD", "NO_DIV"],
             "timed": ["TIMED"]}
CG_ITERS = 300       # below need_idle_warm's 305: the full build converges
GEMM_CASES = {       # (M, K, N, activation), per forward
    "trunk_fc1": (1, 4800, 40, "silu", 1), "fc2": (1, 40, 2560, None, 2),
    "rnn_wx": (1, 32, 64, None, 10), "rnn_wh": (1, 64, 64, None, 10),
    "branch_fc1": (1, 64, 40, "silu", 1)}


def _edit(src: str, hooks, name: str) -> str:
    for anchor, repl in hooks:
        if anchor not in src:
            raise RuntimeError(f"kernel_probe: anchor not found in {name}: "
                               f"{anchor!r}")
        src = src.replace(anchor, repl)
    return src


def build(out_dir: Path, source: str, hooks, builds, extra):
    """One library per build of ``source``, all nvcc processes at once."""
    from repro_torch.kernels import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"{source}_probe.cu"
    cu.write_text(_edit((_build.CSRC / f"{source}.cu").read_text(), hooks,
                        f"{source}.cu"))
    procs = {}
    for name, macros in builds.items():
        so = out_dir / f"lib{source}_probe_{name}.so"
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.ARCH, *_build.COMMON_FLAGS, *extra,
             *[f"-D{m}" for m in macros], "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"kernel_probe: nvcc failed for {source} "
                               f"{name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def _plan_variants(M, K, N, dt):
    from repro_torch.kernels import gemm
    rule = gemm.gemm_plan(M, K, N, dt, dt)
    out = {"rule": rule}
    if rule.cluster > 1:
        for c in (1, 2, 4):
            kb = -(-K // c)
            kl = min(gemm.MAX_THREADS // rule.groups,
                     max(32 // rule.groups,
                         gemm._pow2_ceil(-(-kb // gemm.LOADS))))
            out[f"cluster{c}"] = rule._replace(
                cluster=c, kblock=kb, klanes=kl, threads=rule.groups * kl)
    else:
        for f, tag in ((0.5, "half_klanes"), (2, "double_klanes")):
            kl = int(rule.klanes * f)
            if 32 <= kl * rule.groups <= gemm.MAX_THREADS:
                out[tag] = rule._replace(klanes=kl, threads=rule.groups * kl)
        if rule.groups >= 4:     # narrower column tiles, four times as many
            g = rule.groups // 4
            kl = max(32 // g, rule.klanes)
            out["narrow_tiles"] = rule._replace(
                groups=g, klanes=kl, threads=g * kl, tiles=rule.tiles * 4)
    return out


def probe_gemm(out_dir: Path):
    import torch
    from repro_torch.kernels import _build
    from repro_torch.timing import graph_ms
    libs = build(out_dir, "gemm", GEMM_HOOKS, GEMM_BUILDS, [])
    for lib in libs.values():
        lib.gemm_forward.argtypes = ([ctypes.c_int] * 2
                                     + [ctypes.c_void_p] * 3
                                     + [ctypes.c_int] * 11
                                     + [ctypes.c_void_p])
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    report = {}
    for case, (M, K, N, act, per_fwd) in GEMM_CASES.items():
        for dt in (torch.float32, torch.bfloat16):
            x = (torch.randn((M, K), generator=gen) * 0.3).to(dt).to(dev)
            w = (torch.randn((K, N), generator=gen) * 0.3).to(dt).to(dev)
            out = torch.empty((M, N), dtype=dt, device=dev)
            code = _build.dtype_code(x)
            a = {None: 0, "silu": 1, "tanh": 2}[act]
            row = {"per_forward": per_fwd}
            for pname, p in _plan_variants(M, K, N, dt).items():
                row[f"{pname}/plan"] = p._asdict()
                for bname, lib in libs.items():
                    def call(lib=lib, p=p):
                        err = lib.gemm_forward(
                            code, code, x.data_ptr(), w.data_ptr(),
                            out.data_ptr(), M, K, N, a, p.vec, p.groups,
                            p.klanes, p.cluster, p.kblock, p.tiles, 0,
                            torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"kernel_probe: gemm error "
                                               f"{err} in {pname}")
                    row[f"{pname}/{bname}_us"] = 1e3 * graph_ms(
                        call, reps=20, replays=10)
            row["torch_matmul_us"] = 1e3 * graph_ms(
                lambda: torch.matmul(x, w), reps=20, replays=10)
            row["trivial_add_us"] = 1e3 * graph_ms(
                lambda: out.add_(0), reps=20, replays=10)
            report[f"{case}/{str(dt).split('.')[-1]}"] = row
    return report


def _cg_case():
    """chip_smoke.py's need_idle_warm batch: (bp, X, U0, need)."""
    import torch
    from repro_torch.configs.cronet import get_cronet_config
    from repro_torch.fea import fea2d
    from repro_torch.kernels import cg_fused
    import chip_smoke
    cfg = get_cronet_config("medium")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    probs = chip_smoke.problems(fea2d, cfg, 3, seed=1)
    idle = fea2d.idle_problem(cfg.nelx, cfg.nely)
    bp = fea2d.stack_problems([probs[0], probs[1], idle, probs[2]],
                              device=dev)
    X = (0.2 + 0.8 * torch.rand((4, cfg.nely, cfg.nelx),
                                generator=gen)).to(dev)
    U0, _ = cg_fused.solve_b_plain(bp, X, max_iter=5)
    need = torch.tensor([True, False, True, True], device=dev)
    return bp, X, U0, need


def probe_cg_wrapper():
    """A solve_b_fused call on the need_idle_warm batch: eager, by graph
    replay, and the device kernels torch.profiler sees in it. It uses only
    the wrapper's public signature, so it also times another tree's port
    (run this file by path with that tree's src first on PYTHONPATH)."""
    import torch
    from repro_torch.kernels import cg_fused
    from repro_torch.timing import cuda_ms, graph_ms
    bp, X, U0, need = _cg_case()
    report = {}
    # the wrapper: eager, by graph replay, and what torch.profiler sees
    call = lambda: cg_fused.solve_b_fused(bp, X, U0=U0, need=need)  # noqa
    report["wrapper_ms_eager"] = cuda_ms(call, reps=10)
    report["wrapper_ms_graph"] = graph_ms(call, reps=3, replays=3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(5):
            call()
        torch.cuda.synchronize()
    kern_us, other_us, other_n = 0.0, 0.0, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "cg_solve_kernel" in e.name:
            kern_us += e.device_time
        else:
            other_us += e.device_time
            other_n += 1
    report["profiled_per_call"] = {
        "cg_solve_kernel_us": kern_us / 5, "setup_kernels_us": other_us / 5,
        "setup_kernels": other_n / 5}
    return report


def probe_cg(out_dir: Path):
    import torch
    from repro_torch.kernels import cg_fused
    from repro_torch.timing import graph_ms
    libs = build(out_dir, "cg_fused", CG_HOOKS, CG_BUILDS, ["--fmad=false"])
    dev = torch.device("cuda")
    bp, X, U0, need = _cg_case()
    ins = [t.to(torch.float32).contiguous() for t in
           (X, bp.f, bp.free_mask, need, U0)]
    ke = cg_fused._host_ke(bp.KE)
    B, nely, nelx = X.shape
    nnode = (nelx + 1) * (nely + 1)
    pn = 1 << (nnode - 1).bit_length()
    U_out = torch.empty((B, 2 * nnode), device=dev)
    its = torch.empty((B,), dtype=torch.int32, device=dev)
    rule = cg_fused.block_threads(pn)
    report = {"iterations": CG_ITERS, "rule_threads": rule}
    for lib in libs.values():
        lib.cg_fused_solve.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
            + [ctypes.c_float] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    runs = [("full", t) for t in (128, 256, 512, 1024)]  # NPT 8 .. 1
    runs += [(name, rule) for name in libs if name not in ("full", "timed")]
    for name, threads in runs:
        lib, times = libs[name], {}
        for n_it in (0, CG_ITERS):
            def call(lib=lib, n_it=n_it, threads=threads):
                p = [t.data_ptr() for t in ins]
                err = lib.cg_fused_solve(
                    p[0], None, p[1], p[2], ctypes.cast(ke, ctypes.c_void_p),
                    p[3], p[4], U_out.data_ptr(), its.data_ptr(), B, nelx,
                    nely, pn, threads, float(bp.e_min), float(1 - bp.e_min),
                    1e-6, n_it, 0, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"kernel_probe: cg error {err}")
            times[n_it] = 1e3 * graph_ms(call, reps=5, replays=4)
        report[f"{name}/threads{threads}"] = {
            "us_at_0": times[0], f"us_at_{CG_ITERS}": times[CG_ITERS],
            "us_per_iteration": (times[CG_ITERS] - times[0]) / CG_ITERS}
    report.update(probe_cg_wrapper())
    # cycles by phase, the timed build at each block size, the slots that
    # iterate (0 and 3)
    for threads in (256, 512, 1024):
        lib = libs["timed"]
        err = lib.cg_fused_solve(
            ins[0].data_ptr(), None, ins[1].data_ptr(), ins[2].data_ptr(),
            ctypes.cast(ke, ctypes.c_void_p), ins[3].data_ptr(),
            ins[4].data_ptr(), U_out.data_ptr(), its.data_ptr(), B, nelx,
            nely, pn, threads, float(bp.e_min), float(1 - bp.e_min), 1e-6,
            CG_ITERS, 0, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"kernel_probe: cg error {err}")
        torch.cuda.synchronize()
        cyc = U_out[:, :6].double().cpu()
        n_it = its.cpu()
        report[f"cycles_per_iteration/threads{threads}"] = {
            f"slot{b}": dict(zip(CG_PHASES, (cyc[b] / max(int(n_it[b]), 1))
                                 .tolist()))
            for b in (0, 3)}
    return report


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--build-dir", default="build/kernel_probe")
    ap.add_argument("--cg-wrapper-only", action="store_true",
                    help="only time solve_b_fused calls (any tree's port)")
    args = ap.parse_args()
    import sys
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_probe: needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = Path(args.build_dir)
    if args.cg_wrapper_only:
        text = json.dumps({"card": smi, "cg": probe_cg_wrapper()})
    else:
        text = json.dumps({"card": smi, "gemm": probe_gemm(out_dir),
                           "cg": probe_cg(out_dir)})
    print(text)
    if args.out:
        Path(args.out).write_text(text + "\n")


if __name__ == "__main__":
    main()
