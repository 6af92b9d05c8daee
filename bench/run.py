"""Run one benchmark cell once and print its result line.

    python3 -m bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's cards. The last
line of standard output is the result (JSON); the numbers the check
compared, each beside its limit, are the last lines of standard error. A
run that cannot give a result (no card, too few cards, a file missing, the
JAX package loaded) exits non-zero and prints none.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def set_caches():
    """The program's build and kernel caches at fixed paths inside the
    checkout (its nvcc libraries already live in ``build/kernels``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)


def finite(obj):
    """Non-finite numbers as strings, so the line stays strict JSON."""
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    return obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_caches()
    from bench import harness

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    try:
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), root=ROOT, t_start=T_START,
                             log=log)
    except harness.Refused as exc:
        log(f"refused: {exc}")
        return 2
    except Exception:
        traceback.print_exc()
        return 1
    loaded = harness.forbidden_modules()
    if loaded:
        log(f"refused: loaded {', '.join(loaded)} (JAX or its package)")
        return 3
    print(json.dumps(finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
