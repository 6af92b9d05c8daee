"""Serving launcher: batched greedy decoding with the ServingEngine, on
the card unless ``--device cpu``. A port of ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
        [--smoke] [--requests 8] [--slots 4] [--max-new 16] [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import List

import numpy as np


def make_requests(cfg, n: int, max_new: int, seed: int = 0) -> List:
    """The reference launcher's requests: prompts of 4-31 tokens drawn
    from ``default_rng(seed)``."""
    from repro_torch.serve.server import Request
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(
        0, cfg.vocab_size, size=int(rng.integers(4, 32))).astype(np.int32),
        max_new=max_new) for i in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.common import materialize
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.serve.server import ServingEngine

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduce()
    if not cfg.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode serving")
    params = materialize(M.param_specs(cfg), seed=0, device=args.device)
    engine = ServingEngine(cfg, params, slots=args.slots,
                           max_len=args.max_len, device=args.device)
    done = engine.run(make_requests(cfg, args.requests, args.max_new))
    for r in done[:4]:
        print(f"req {r.uid}: {r.output.tolist()}")
    print(engine.throughput_stats(done))
    return done


if __name__ == "__main__":
    main()
