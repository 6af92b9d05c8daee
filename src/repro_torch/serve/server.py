"""Batched LM serving engine: request queue -> prefill -> batched decode.
A port of ``repro/serve/server.py``.

Requests are taken in groups of ``slots``; each group's prompts are
left-padded with token 0 to the group's longest prompt and prefilled
together, then decoded greedily in one batch. As in the reference the
padding is attended (no mask), so a request's tokens depend on its
group's longest prompt.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.common import map_params, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.parallel import sharding as SH
from repro_torch.serve import decode as D
from repro_torch.serve.types import throughput_view


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # (Sp,) int32
    max_new: int = 16
    done: bool = False
    output: Optional[np.ndarray] = None
    latency_s: float = 0.0
    # actual occupancy of the slot-batched group this request decoded
    # in (<= engine slots for a partial final group). latency_s covers
    # the whole group, so wall-clock accounting divides by THIS, not by
    # the engine's slot width — padded slots did no work.
    group_size: int = 0


class ServingEngine:
    """Greedy decoding over a fixed slot grid on ``device`` (the card
    unless the caller asks for the CPU); ``params`` move there. On a
    ``mesh`` (every rank of its process group runs the same requests) the
    params are placed on their shardings (``parallel.sharding``) unless
    they are DTensors already, the slots are sharded over the batch axes,
    and each rank gathers the logits to pick the same tokens."""

    def __init__(self, cfg: ModelConfig, params, slots: int = 4,
                 max_len: int = 128, device="cuda", mesh=None):
        if not cfg.has_decode:
            raise ValueError(f"{cfg.name} is encoder-only")
        self.mesh = mesh
        self.device = resolve_device(
            mesh.device_type if mesh is not None else device)
        self.cfg = cfg
        if mesh is None:
            self.params = map_params(lambda t: t.to(self.device), params)
        else:
            self.params = SH.shard_tree(params, SH.spec_tree_to_shardings(
                M.param_specs(cfg), mesh))
        self.slots, self.max_len = slots, max_len

    def _greedy(self, lgts) -> torch.Tensor:
        # argmax takes the first maximum, as jnp.argmax does
        return torch.argmax(SH.full(lgts)[:, -1:, : self.cfg.vocab_size],
                            dim=-1)

    def run(self, requests: List[Request]):
        """Process all requests; returns them with outputs filled.

        Each group of up to `slots` requests is prefilled together into
        one cache, then decoded as a batch.
        """
        # a DTensor's views cannot be taken under inference mode
        with (torch.no_grad() if self.mesh is not None
              else torch.inference_mode()):
            return self._run(requests)

    def _run(self, requests: List[Request]):
        pending = list(requests)
        while pending:
            group = pending[: self.slots]
            pending = pending[self.slots:]
            # pad group to full slot count for a fixed-shape decode
            pad = self.slots - len(group)
            prompts = [r.prompt for r in group] + [group[-1].prompt] * pad
            plen = max(len(p) for p in prompts)
            toks = np.zeros((self.slots, plen), np.int64)
            for i, p in enumerate(prompts):
                toks[i, plen - len(p):] = p  # left-pad (simple alignment)
            batch = {"tokens": torch.from_numpy(toks).to(self.device)}
            t0 = time.perf_counter()
            lgts, cache = D.prefill(self.cfg, self.params, batch,
                                    max_len=self.max_len, mesh=self.mesh)
            nxt = self._greedy(lgts)
            outs = [nxt]
            steps = max(r.max_new for r in group)
            for _ in range(steps - 1):
                lgts, cache = D.decode_step(self.cfg, self.params, nxt, cache,
                                            mesh=self.mesh)
                nxt = self._greedy(lgts)
                outs.append(nxt)
            gen = torch.cat(outs, dim=1).cpu().numpy().astype(np.int32)
            dt = time.perf_counter() - t0
            for i, r in enumerate(group):
                r.output = gen[i, : r.max_new]
                r.done = True
                r.latency_s = dt
                r.group_size = len(group)
        return requests

    def throughput_stats(self, requests: List[Request]) -> Dict[str, float]:
        # wall clock: each latency_s covers a whole slot-batched group, so
        # every member contributes dt / group_size and each group sums to
        # its dt exactly once
        wall = sum(r.latency_s / max(r.group_size or self.slots, 1)
                   for r in requests)
        view = throughput_view(
            requests, latency=lambda r: r.latency_s, wall_s=wall,
            units=lambda r: (len(r.output)
                             if r.output is not None else 0))
        return {"total_new_tokens": int(view["units"]),
                "mean_batch_latency_s": view["mean_latency_s"],
                "tokens_per_s": view["units_per_s"]}
