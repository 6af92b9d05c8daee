"""The check's control: the plain reference put in the program's place and
computed one precision step lower (TF32 in the convolutions and products
where the configuration states float32 with TF32 off), judged by the
cell's own comparison (``bench/check.py``) on the ticks a run checks.

    python3 -m bench.control --workload <cell> --seeds 11 12 13 \
        --seconds 5

runs the cell once a seed, with a short window at the cell's own load, and
prints one JSON line a seed: the numbers the control reads and those the
program reads on the same ticks, beside the cell's limits, and whether the
check failed the control. It is not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(root: Path, cell_name: str, seed: int, seconds: float,
             device: str):
    from bench import harness
    lines = []
    res = harness.run(cell_name, seed, seconds, False, root=root,
                      device=device, control=True, log=lines.append)
    return {"workload": cell_name, "seed": seed,
            "control_failed": not res["correct"], "control": res["check"],
            "program": res["program_check"],
            "check_s": json.loads(next(
                line for line in lines if line.startswith("phases "))[7:]
                )["check"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from bench import run
    run.set_caches()
    for seed in args.seeds:
        print(json.dumps(run.finite(readings(ROOT, args.workload, seed,
                                             args.seconds, args.device))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
