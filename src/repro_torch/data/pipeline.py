"""Deterministic, resumable synthetic data pipelines: the counterpart of
``repro.data.pipeline``, on the same numpy draws, so one seed and step
give both packages the same batch bit for bit.

Token pipeline for the LM configurations (synthetic power-law tokens) and
the batch builders of the vlm and audio families. State is a (seed, step)
pair saved in every checkpoint, so a restart replays the exact stream. A
background prefetch thread hides host latency: a slow batch never blocks
the step more than ``buffer`` deep. Batches are numpy; the trainer moves
them to its device.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


class TokenPipeline:
    """Synthetic next-token-prediction stream (Zipf-ish unigram draw)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                 start_step: int = 0):
        self.cfg = cfg
        self.batch, self.seq, self.seed = batch, seq, seed
        self.step = start_step

    def state(self) -> Dict:
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_state(cls, cfg, batch, seq, state):
        return cls(cfg, batch, seq, seed=state["seed"],
                   start_step=state["step"])

    def _rng(self, step):
        return np.random.default_rng((self.seed, step))

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = self._rng(self.step)
        self.step += 1
        v = self.cfg.vocab_size
        # zipf-like unigram over the real vocab
        ranks = rng.integers(1, 1 << 30, size=(self.batch, self.seq),
                             dtype=np.int64)
        tokens = (np.log2(ranks.astype(np.float64)) / 30.0
                  * (v - 1)).astype(np.int32)
        tokens = np.clip(v - 1 - tokens, 0, v - 1)
        batch = {"tokens": tokens}
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = -1
        if self.cfg.family == "vlm":
            ft = self.cfg.frontend_tokens
            batch["tokens"] = tokens[:, : self.seq - ft]
            batch["patch_embeds"] = rng.standard_normal(
                (self.batch, ft, self.cfg.frontend_dim), dtype=np.float32)
            lab = np.full((self.batch, self.seq), -1, np.int32)
            lab[:, ft:] = np.roll(batch["tokens"], -1, axis=1)
            lab[:, -1] = -1
            labels = lab
        elif self.cfg.family == "audio":
            batch = {"frames": rng.standard_normal(
                (self.batch, self.seq, self.cfg.frontend_dim),
                dtype=np.float32)}
            # HuBERT-style masked prediction: ~8% of frames are targets
            mask = rng.random((self.batch, self.seq)) < 0.08
            labels = np.where(mask, tokens % self.cfg.vocab_size,
                              -1).astype(np.int32)
        batch["labels"] = labels.astype(np.int32)
        return batch


class PrefetchingLoader:
    """Wraps a pipeline with a daemon prefetch thread + bounded buffer."""

    def __init__(self, pipeline: TokenPipeline, buffer: int = 2):
        self.pipeline = pipeline
        self.q: "queue.Queue" = queue.Queue(maxsize=buffer)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _work(self):
        while not self._stop.is_set():
            batch = self.pipeline.next_batch()
            while not self._stop.is_set():
                try:
                    self.q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __next__(self):
        return self.q.get()

    def stop(self):
        self._stop.set()


def build_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0):
    """One concrete batch for smoke tests / benchmarks."""
    return TokenPipeline(cfg, shape.global_batch, shape.seq_len,
                         seed).next_batch()
