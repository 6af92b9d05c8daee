"""Training loop: the step, checkpoint and restart, preemption safety
(SIGTERM -> a final checkpoint), straggler-tolerant input prefetch and
metrics logging. The counterpart of ``repro.train.trainer``: on one device
(the card unless the caller asks for the CPU), or on a ``mesh``
(``launch.mesh``) that every rank of the process group runs the loop on in
step. With a mesh the params, the AdamW state and the EF-int8 error state
are DTensors on the params' shardings (``parallel.sharding``), placed at
init and at restore, so a checkpoint of any mesh shape (or none) resumes
on any other.

Checkpoints are ``repro_torch.checkpoint.manager``'s, in the reference's
layout and keys (``{"params", "opt"}`` with the ``AdamWState`` fields as
``opt/.mu/...``), so either package's trainer resumes from the other's.

One difference from the reference: the ``data_state`` saved with a
checkpoint is the position of the next batch the loop will take. The
reference saves its pipeline's own position, which the prefetch thread
has already moved up to ``buffer + 1`` batches ahead, so its resumed run
skips the batches that were waiting in the buffer. Both read the other's
state the same way.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import manager as ckpt
from repro_torch.common import materialize, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import PrefetchingLoader, TokenPipeline
from repro_torch.models import model as M
from repro_torch.optim import adamw, compress
from repro_torch.parallel import sharding as SH
from repro_torch.train.steps import TrainConfig, make_train_step


@dataclasses.dataclass
class RunConfig:
    steps: int = 100
    batch: int = 8
    seq: int = 128
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep_ckpts: int = 3
    log_every: int = 10
    seed: int = 0
    deadline_ms: Optional[float] = None   # straggler mitigation: skip batches
                                          # arriving later than this budget


class Trainer:
    def __init__(self, cfg: ModelConfig, tc: TrainConfig, rc: RunConfig,
                 device="cuda", mesh=None):
        self.cfg, self.tc, self.rc, self.mesh = cfg, tc, rc, mesh
        self.device = resolve_device(
            mesh.device_type if mesh is not None else device)
        self.specs = M.param_specs(cfg)
        self.shardings = (None if mesh is None else
                          SH.spec_tree_to_shardings(self.specs, mesh))
        self._preempted = False
        self.step_fn = make_train_step(cfg, tc, mesh)

    # -- state ------------------------------------------------------------
    def init_state(self):
        """Params from the port's ``materialize(specs, rc.seed)``: a torch
        generator's draws, not JAX's for the same seed."""
        params = materialize(self.specs, self.rc.seed, device=self.device)
        if self.mesh is not None:     # every rank drew the same full tensors
            params = SH.shard_tree(params, self.shardings)
        opt = adamw.init_state(self.tc.optimizer, params)
        err = (compress.init_error_state(params)
               if self.tc.compress_pod_grads else None)
        return params, opt, err

    def try_restore(self, params, opt):
        """(params, opt, data_state, step) from the newest checkpoint, or
        the given state at step 0 when there is none."""
        if not self.rc.ckpt_dir or ckpt.latest_step(self.rc.ckpt_dir) is None:
            return params, opt, None, 0
        shardings = None
        if self.mesh is not None:
            sh = self.shardings
            shardings = {"params": sh, "opt": adamw.AdamWState(
                None, sh, sh, sh if self.tc.optimizer.master_fp32 else ())}
        restored, extras = ckpt.restore(
            self.rc.ckpt_dir, {"params": params, "opt": opt},
            device=self.device, shardings=shardings)
        return (restored["params"], restored["opt"], extras.get("data_state"),
                extras.get("step", ckpt.latest_step(self.rc.ckpt_dir)))

    # -- preemption -------------------------------------------------------
    def _install_sigterm(self):
        def handler(signum, frame):
            self._preempted = True
        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not the main thread

    # -- loop ---------------------------------------------------------------
    def run(self, progress: Optional[Callable[[int, Dict], None]] = None):
        self._install_sigterm()
        params, opt, err = self.init_state()
        params, opt, data_state, start = self.try_restore(params, opt)
        pipe = (TokenPipeline.from_state(self.cfg, self.rc.batch, self.rc.seq,
                                         data_state)
                if data_state else
                TokenPipeline(self.cfg, self.rc.batch, self.rc.seq,
                              seed=self.rc.seed))
        next_data = pipe.state()      # the batch the loop takes next
        loader = PrefetchingLoader(pipe, buffer=2)
        history = []
        step = start
        skipped = 0
        try:
            while step < self.rc.steps:
                t0 = time.time()
                batch = next(loader)
                next_data = dict(next_data, step=next_data["step"] + 1)
                wait_ms = (time.time() - t0) * 1e3
                if (self.rc.deadline_ms is not None
                        and wait_ms > self.rc.deadline_ms and step > start):
                    skipped += 1     # straggler batch: drop, keep cadence
                    continue
                batch = {k: torch.from_numpy(v).to(self.device)
                         for k, v in batch.items()}
                if self.tc.compress_pod_grads:
                    params, opt, metrics, err = self.step_fn(params, opt,
                                                             batch, err)
                else:
                    params, opt, metrics = self.step_fn(params, opt, batch)
                step += 1
                if step % self.rc.log_every == 0 or step == self.rc.steps:
                    row = {k: float(v) for k, v in metrics.items()}
                    row["step"] = step
                    row["skipped_batches"] = skipped
                    history.append(row)
                    if progress:
                        progress(step, row)
                want_ckpt = (self.rc.ckpt_dir
                             and (step % self.rc.ckpt_every == 0
                                  or step == self.rc.steps or self._preempted))
                if want_ckpt:
                    ckpt.save(self.rc.ckpt_dir, step,
                              {"params": params, "opt": opt},
                              extras={"step": step, "data_state": next_data})
                    if self.mesh is None or dist.get_rank() == 0:
                        ckpt.prune_old(self.rc.ckpt_dir, self.rc.keep_ckpts)
                if self._preempted:
                    break
        finally:
            loader.stop()
        return params, opt, history
