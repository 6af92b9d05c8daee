"""Training launcher, on the card unless ``--device cpu``. A port of
``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \
        [--smoke] [--steps 100] [--batch 8] [--seq 256] [--microbatches 1] \
        [--compress-pod-grads] [--ckpt-dir DIR] [--device cpu]

``--smoke`` selects the reduced configuration. ``--mesh single|multi``
trains on the production mesh (``launch.mesh.make_production_mesh``: 16x16
or 2x16x16 ranks, one card each). Each rank runs this command under a
launcher that sets ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` (``torchrun``); the process group is started from them.
"""
from __future__ import annotations

import argparse
import os


def build(argv=None):
    """The ``Trainer`` the flags describe (not yet run)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-pod-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="none",
                    choices=["none", "single", "multi"],
                    help="'single'/'multi' build the production mesh "
                         "(requires enough ranks)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import get_config
    from repro_torch.optim import adamw
    from repro_torch.train.steps import TrainConfig
    from repro_torch.train.trainer import RunConfig, Trainer

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduce()
    mesh = None
    if args.mesh != "none":
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_production_mesh

        if not dist.is_initialized():
            if "WORLD_SIZE" not in os.environ:
                raise RuntimeError(
                    f"--mesh {args.mesh} needs a process group: run every "
                    "rank under a launcher that sets RANK, WORLD_SIZE, "
                    "MASTER_ADDR and MASTER_PORT (torchrun)")
            dist.init_process_group(
                "nccl" if args.device == "cuda" else "gloo")
        mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                    device=args.device)
    tc = TrainConfig(
        microbatches=args.microbatches,
        compress_pod_grads=args.compress_pod_grads,
        optimizer=adamw.AdamWConfig(
            lr=args.lr, warmup_steps=min(100, args.steps // 10 + 1),
            total_steps=args.steps))
    rc = RunConfig(steps=args.steps, batch=args.batch, seq=args.seq,
                   ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    return Trainer(cfg, tc, rc, device=args.device, mesh=mesh)


def main(argv=None):
    _, _, hist = build(argv).run(
        progress=lambda s, row: print(
            f"step {s:6d} loss={row['loss']:.4f} gnorm={row['grad_norm']:.2f} "
            f"lr={row['lr']:.2e} skipped={row['skipped_batches']}",
            flush=True))
    print(f"finished at step {hist[-1]['step']}, loss {hist[-1]['loss']:.4f}")
    return hist


if __name__ == "__main__":
    main()
