"""Deterministic synthetic token pipeline (counterpart of
``repro.data.synthetic``).

Tokens follow a periodic permuted sequence with a (seed, row, step)
dependent phase plus light noise from a stateless per-(row, position) hash,
so a model visibly lowers its loss within a few steps and a restarted job
regenerates exactly the batch it would have seen: data is addressed by
global step, never by a cursor.  ``SyntheticLM`` is a numpy copy of the
reference's class; its batches are byte-equal to the reference's.
``make_batch`` puts one step's batch on the device as int64 tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    period: int = 97  # pattern period (prime, < any vocab here)
    noise: float = 0.05

    def _rows(self, step: int, rows: np.ndarray) -> np.ndarray:
        """Token rows (len(rows), seq_len+1) for a global step."""
        period = min(self.period, self.vocab)
        perm = np.random.Generator(
            np.random.Philox(key=[self.seed, 0xBEEF])
        ).permutation(self.vocab)[:period]
        phase = (rows * 31 + step * 7) % period
        t = np.arange(self.seq_len + 1)
        idx = (phase[:, None] + t[None, :]) % period
        toks = perm[idx]
        # stateless elementwise hash for noise injection
        rr = rows[:, None].astype(np.uint64)
        tt = t[None, :].astype(np.uint64)
        h = (rr * np.uint64(2654435761)
             ^ tt * np.uint64(40503)
             ^ np.uint64((self.seed * 7919 + step * 104729) & (2**63 - 1)))
        h = (h ^ (h >> np.uint64(13))) * np.uint64(0x9E3779B97F4A7C15)
        h ^= h >> np.uint64(7)
        mask = (h % np.uint64(100000)).astype(np.float64) < self.noise * 1e5
        repl = ((h >> np.uint64(17)) % np.uint64(self.vocab)).astype(np.int64)
        toks = np.where(mask, repl, toks)
        return toks.astype(np.int32)

    def host_slice(self, step: int, lo: int, hi: int) -> Dict[str, np.ndarray]:
        toks = self._rows(step, np.arange(lo, hi))
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def global_batch_np(self, step: int) -> Dict[str, np.ndarray]:
        return self.host_slice(step, 0, self.global_batch)


def make_batch(ds: SyntheticLM, step: int, device) -> Dict[str, torch.Tensor]:
    """The global batch of ``step`` as int64 tensors on ``device``."""
    return {name: torch.from_numpy(arr.astype(np.int64)).to(device)
            for name, arr in ds.global_batch_np(step).items()}
