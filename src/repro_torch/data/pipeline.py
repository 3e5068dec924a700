"""Deterministic synthetic LM data pipeline.

Counterpart of ``repro.data.pipeline``, the same NumPy draws in the same
order, so every batch is bitwise the reference's. Each batch is a pure
function of (seed, step, shard): a restarted or straggling host
recomputes exactly the batch it owes, so a resumed run replays the
batches of an uninterrupted one.

The token stream is a noisy affine recurrence over the vocab with
slowly varying per-sequence coefficients: enough structure for a small
model to lower its loss within a few hundred steps, with no corpus.
Batches are NumPy int32 arrays; the trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticLMData:
    vocab: int
    batch: int            # per-host batch
    seq: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0

    def batch_at(self, step: int) -> dict:
        """{"tokens", "labels"}: (batch, seq) int32, labels the tokens
        shifted by one."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard]))
        B, S, V = self.batch, self.seq + 1, self.vocab
        a = rng.integers(1, 8, size=(B, 1))
        b = rng.integers(0, V, size=(B, 1))
        noise = rng.integers(0, 4, size=(B, S))
        t0 = rng.integers(0, V, size=(B, 1))
        idx = np.arange(S)[None, :]
        toks = (t0 + a * idx + b * (idx // 16) + noise) % V
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
