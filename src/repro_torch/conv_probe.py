"""Where a convolution call's device time goes, on one NVIDIA GPU.

    PYTHONPATH=src python -m repro_torch.conv_probe [--out FILE]

Builds csrc/conv.cu a few more times with one phase of each kernel taken
out (the copy-in, the multiply-adds, the stores, or all of the kernel:
``empty`` returns at once), and times every build by CUDA-graph replay at
CRONet medium's four convolution layers (fp32 on the SIMT kernel, the two
Cin-16 layers in bf16 on the tensor cores), SiLU on and off. Beside them:
the rule's tile plan against the alternatives it was chosen over (SIMT
without split-K; tensor cores with 16-channel tiles over two rows).
Outputs of the cut builds are not results; only their times are read. The
phases are cut by editing a copy of the source at fixed anchors: an anchor
that is no longer found raises, so the probe follows the kernel or fails
loudly.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

# phase -> macros; the anchors in csrc/conv.cu each macro switches
PHASES = {"full": [], "empty": ["EMPTY"], "no_copy": ["NO_COPY"],
          "no_compute": ["NO_COMPUTE"], "no_store": ["NO_STORE"],
          "skeleton": ["NO_COPY", "NO_COMPUTE", "NO_STORE"]}
HOOKS = [  # (anchor, replacement); each anchor must occur at least once
    ("  const Tile t = tile_of(g, p);",
     "#ifdef EMPTY\n  if (g.B > 0) return;\n#endif\n"
     "  const Tile t = tile_of(g, p);"),
    ("  for_halo(g, t, hr, hc,", "#ifndef NO_COPY\n  for_halo(g, t, hr, hc,"),
    ("  cp_async_wait_all();", "#endif\n  cp_async_wait_all();"),
    ("for (int q = grp; q < ntap; q += p.split)",
     "for (int q = grp; q < PROBE_N(ntap); q += p.split)"),
    ("    for (int dd = 0; dd < g.KD; ++dd)\n      for (int i = 0;",
     "    for (int dd = 0; dd < PROBE_N(g.KD); ++dd)\n      for (int i = 0;"),
    ("if (live && grp == 0 && co < g.Cout)",
     "if (live && grp == 0 && co < g.Cout && PROBE_STORE(acc[0][0]))"),
    ("if (px < P && co < g.Cout)",
     "if (px < P && co < g.Cout && PROBE_STORE(__bfloat162float(st[0])))"),
]
PRELUDE = """#ifdef NO_COMPUTE
#define PROBE_N(n) 0
#else
#define PROBE_N(n) (n)
#endif
#ifdef NO_STORE
#define PROBE_STORE(v) ((v) == 12345.678f)
#else
#define PROBE_STORE(v) true
#endif
"""
# (x, w) of CRONet medium's four layers, as 5-d calls
LAYERS = {"trunk1": ((1, 4, 21, 31, 1), (2, 3, 3, 1, 16)),
          "trunk2": ((1, 4, 21, 31, 16), (1, 3, 3, 16, 64)),
          "branch1": ((10, 1, 20, 30, 1), (1, 3, 3, 1, 16)),
          "branch2": ((10, 1, 20, 30, 16), (1, 3, 3, 16, 32))}


def probe_source(src: str) -> str:
    for anchor, repl in HOOKS:
        if anchor not in src:
            raise RuntimeError(f"conv_probe: anchor not found in conv.cu: "
                               f"{anchor!r}")
        src = src.replace(anchor, repl)
    return PRELUDE + src


def build(out_dir: Path):
    """One library per phase, all nvcc processes at once."""
    from repro_torch.kernels import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "conv_probe.cu"
    cu.write_text(probe_source((_build.CSRC / "conv.cu").read_text()))
    procs = {}
    for name, macros in PHASES.items():
        so = out_dir / f"libconv_probe_{name}.so"
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.ARCH, *_build.COMMON_FLAGS,
             *_build.INCLUDE,
             *[f"-D{m}" for m in macros], "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"conv_probe: nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.conv3d_forward.argtypes = ([ctypes.c_int] * 2
                                       + [ctypes.c_void_p] * 5
                                       + [ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p])
        lib.conv3d_tc_forward.argtypes = ([ctypes.c_void_p] * 5
                                          + [ctypes.c_int, ctypes.c_int,
                                             ctypes.c_void_p])
        libs[name] = lib
    return libs


def run(out_dir: Path):
    import torch
    from repro_torch.kernels import conv
    from repro_torch.timing import graph_ms
    libs = build(out_dir)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    I = ctypes.c_int
    report = {}
    for layer, (xs, ws) in LAYERS.items():
        dims = (*xs, *ws[:3], ws[4])
        for dt in (torch.float32, torch.bfloat16):
            kernel = conv.kernel_for(dt, xs[-1], ws[-1])
            if dt == torch.bfloat16 and kernel == "simt":
                continue                  # fp32 covers the SIMT kernel
            x = (torch.randn(xs, generator=gen) * 0.5).to(dt).to(dev)
            w = (torch.randn(ws, generator=gen) * 0.3).to(dt).to(dev)
            out = torch.empty(xs[:4] + (ws[4],), dtype=dt, device=dev)
            rule = conv.tile_plan(kernel, dims)
            plans = {"rule": rule}
            if kernel == "simt":
                plans["split_1"] = conv._plan(kernel, dims, rule.rows,
                                              rule.cols, rule.ct, split=1)
            else:
                plans["ct16_rows2"] = conv._plan(kernel, dims, 2, rule.cols,
                                                 16)
            code = 0 if dt == torch.float32 else 1
            row = {"kernel": kernel,
                   "plans": {k: p._asdict() for k, p in plans.items()}}
            for pname, plan in plans.items():
                cp = (I * 8)(plan.rows, plan.cols, plan.ct, plan.split,
                             plan.threads, plan.smem, *plan.grid)
                cd = (I * 9)(*dims)
                phases = PHASES if pname == "rule" else ["full"]
                for phase in phases:
                    lib = libs[phase]
                    for fuse in (1, 0):
                        def call(lib=lib, cp=cp, cd=cd, fuse=fuse):
                            s = torch.cuda.current_stream().cuda_stream
                            if kernel == "tc":
                                err = lib.conv3d_tc_forward(
                                    x.data_ptr(), w.data_ptr(),
                                    out.data_ptr(), cd, cp, fuse, 0, s)
                            else:
                                err = lib.conv3d_forward(
                                    code, code, x.data_ptr(), w.data_ptr(),
                                    out.data_ptr(), cd, cp, fuse, 0, s)
                            if err:
                                raise RuntimeError(f"conv_probe: error {err}")
                        row[f"{pname}/{phase}/silu{fuse}_us"] = 1e3 * graph_ms(
                            call, reps=20, replays=10)
            row["trivial_add_us"] = 1e3 * graph_ms(lambda: out.add_(0),
                                                   reps=20, replays=10)
            report[f"{layer}/{str(dt).split('.')[-1]}"] = row
    return report


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--build-dir", default="build/conv_probe")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("conv_probe: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    text = json.dumps({"card": smi, "layers": run(Path(args.build_dir))})
    print(text)
    if args.out:
        Path(args.out).write_text(text + "\n")


if __name__ == "__main__":
    main()
