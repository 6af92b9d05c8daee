"""Drive the full dry-run sweep: every (arch x shape x mesh) cell in its
own subprocess (a fresh fake process group a cell), resumable, failures
recorded as ``.err`` files. The counterpart of
``repro/launch/dryrun_all.py``; results land in
``experiments/dryrun_torch/<mesh>/<arch>__<shape>.json`` (never in the
reference's ``experiments/dryrun/``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun_all
      [--mesh single|multi|both] [--archs a,b,...] [--placed]
      [--timeout 1800] [--outdir experiments/dryrun_torch] [--jobs 1]
      [--table]

``--table`` prints a finished sweep as a markdown table (PERF.md §5).
A cell needs no card: it traces with meta tensors on a fake group.
``--jobs`` runs that many cells at once.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import subprocess
import sys
import time

ARCHS = [
    "qwen2.5-32b", "qwen2-72b", "granite-3-8b", "granite-8b",
    "recurrentgemma-2b", "internvl2-1b", "xlstm-1.3b", "deepseek-v3-671b",
    "granite-moe-3b-a800m", "hubert-xlarge",
]
SHAPE_NAMES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_cell(arch, shape, multi_pod, placed, outpath, timeout):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape, "--out", outpath]
    if multi_pod:
        cmd.append("--multi-pod")
    if placed:
        cmd.append("--placed")
    env = dict(os.environ, PYTHONPATH=SRC)
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout, env=env)
        if proc.returncode != 0:
            return {"error": proc.stderr[-2000:], "rc": proc.returncode,
                    "wall_s": round(time.time() - t0, 1)}
        return {"ok": True, "wall_s": round(time.time() - t0, 1)}
    except subprocess.TimeoutExpired:
        return {"error": f"timeout after {timeout}s",
                "wall_s": round(time.time() - t0, 1)}


def _row(d) -> str:
    """One mesh's columns of a cell: peak GB a device, the three terms,
    the dominant one, the bound, the useful share of the flops."""
    if d is None:
        return "not run | | | | | |"
    if d.get("skipped"):
        return "skipped | | | | | |"
    r = d["roofline"]
    return (f"{d['memory_analysis']['peak_bytes'] / 1e9:.2f} | "
            f"{r['compute_s']:.4g} | {r['memory_s']:.4g} "
            f"({r['memory_s_kernels']:.4g}) | {r['collective_s']:.4g} | "
            f"{r['dominant']} | {r['step_time_lower_bound_s']:.4g} | "
            f"{d['useful_flops_ratio']:.3g}")


def table(outdir: str) -> str:
    """The sweep in ``outdir`` as a markdown table, one row a cell and
    both meshes side by side."""
    def load(mesh, arch, shape):
        path = os.path.join(outdir, mesh, f"{arch}__{shape}.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    cols = ("peak GB | compute s | memory s (kernels) | collective s | "
            "dominant | bound s | useful")
    lines = [f"| cell | 16x16: {cols} | 2x16x16: {cols} |",
             "| --- |" + " --- |" * 14]
    for arch in ARCHS:
        for shape in SHAPE_NAMES:
            single, multi = (load(m, arch, shape) for m in ("single",
                                                           "multi"))
            if all(d is not None and d.get("skipped")
                   for d in (single, multi)):
                continue
            lines.append(f"| {arch} {shape} | {_row(single)} | "
                         f"{_row(multi)} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--archs", default=",".join(ARCHS))
    ap.add_argument("--shapes", default=",".join(SHAPE_NAMES))
    ap.add_argument("--placed", action="store_true")
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--outdir", default="experiments/dryrun_torch")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--table", action="store_true",
                    help="print the sweep in --outdir as a markdown table")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.outdir))
        return 0

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = []
    for multi_pod in meshes:
        mdir = os.path.join(args.outdir, ("multi" if multi_pod else "single")
                            + ("_placed" if args.placed else ""))
        os.makedirs(mdir, exist_ok=True)
        for arch in args.archs.split(","):
            for shape in args.shapes.split(","):
                cells.append((multi_pod, mdir, arch, shape,
                              os.path.join(mdir, f"{arch}__{shape}.json")))

    def one(cell):
        multi_pod, mdir, arch, shape, outpath = cell
        if os.path.exists(outpath):
            print(f"[skip exists] {mdir}/{arch}/{shape}", flush=True)
            return True
        print(f"[run] mesh={'multi' if multi_pod else 'single'} "
              f"{arch} {shape} ...", flush=True)
        res = run_cell(arch, shape, multi_pod, args.placed, outpath,
                       args.timeout)
        if res.get("ok"):
            print(f"  ok {arch} {shape} in {res['wall_s']}s", flush=True)
            return True
        with open(outpath + ".err", "w") as f:
            json.dump(res, f, indent=2)
        print(f"  FAILED {arch} {shape} ({res['wall_s']}s): "
              f"{str(res.get('error'))[-300:]}", flush=True)
        return False

    with cf.ThreadPoolExecutor(max(args.jobs, 1)) as pool:
        results = list(pool.map(one, cells))
    print(f"done: {sum(results)}/{len(cells)}, "
          f"failed: {len(results) - sum(results)}")
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
