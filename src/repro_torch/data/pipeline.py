"""Deterministic synthetic data pipeline — the port's copy of
``repro/data/pipeline.py`` (numpy, the same draws).

* **Stateless resumability** — batch ``i`` is a pure function of
  ``(seed, step)`` (one ``SeedSequence([seed, step, host])`` stream), so a
  run restored at step k needs no data-loader state.
* **Host sharding** — each process draws only its ``[local_batch]`` slice.
* **Modality stubs** — the VLM / audio families get their precomputed
  patch or frame embeddings.

Token statistics: Zipfian-ish via squaring a uniform. The batches are
numpy arrays, bit for bit the reference's; the train step places them on
its device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.config import ModelConfig, ShapeConfig


@dataclass
class TokenPipeline:
    cfg: ModelConfig
    shape: ShapeConfig
    seed: int = 0
    process_index: int = 0
    num_processes: int = 1

    def __post_init__(self):
        if self.shape.global_batch % self.num_processes:
            raise ValueError("global batch not divisible across hosts")
        self.local_batch = self.shape.global_batch // self.num_processes

    def _rng(self, step: int) -> np.random.Generator:
        # counter-based: independent stream per (seed, step, host)
        return np.random.default_rng(
            np.random.SeedSequence(
                [self.seed, step, self.process_index]))

    def tokens(self, step: int) -> np.ndarray:
        rng = self._rng(step)
        seq = self.shape.seq_len
        if self.cfg.family == "vlm":
            seq -= self.cfg.n_frontend_tokens
        u = rng.random((self.local_batch, seq))
        return (u * u * (self.cfg.vocab - 1)).astype(np.int32)

    def stub(self, step: int) -> np.ndarray:
        """Batch ``step``'s modality stub: ``[local_batch, n, d_model]``
        float32, normal x 0.02, with ``n`` a VLM's ``n_frontend_tokens``
        (its patch embeddings) or an audio model's ``encoder_len`` (its
        frame embeddings)."""
        n = (self.cfg.n_frontend_tokens if self.cfg.family == "vlm"
             else self.cfg.encoder_len)
        rng = self._rng(step + (1 << 30))
        return rng.standard_normal(
            (self.local_batch, n, self.cfg.d_model)).astype(
                np.float32) * 0.02

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Full input dict for one local step (tokens + modality stubs)."""
        out: Dict[str, np.ndarray] = {"tokens": self.tokens(step)}
        if self.cfg.family == "vlm":
            out["prefix_embeds"] = self.stub(step)
        if self.cfg.family == "audio":
            out["frame_embeds"] = self.stub(step)
        return out


@dataclass
class QueryPipeline:
    """PIR query-index stream (client side of the serve loop)."""
    n_items: int
    batch: int
    seed: int = 0

    def indices(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        return rng.integers(0, self.n_items, size=self.batch, dtype=np.int64)
