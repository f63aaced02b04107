"""Slot cache pool (counterpart of ``repro.serving.cache.SlotCachePool``).

``n_slots`` resident rows per layer, each a preallocated
``(n_slots, s_max, KH, hd)`` K and V tensor, shared by a churn of requests.
``write`` copies a batch-1 prefill state into a slot's row **in place** —
the counterpart of the reference's donated graft — and the decode tick
updates the rows in place too.  Recycling leaks nothing: K/V rows past a
request's ``cur_index`` are masked in decode attention until the decode
loop overwrites them.  Under ``cfg.quant="int8"`` the K/V rows are int8 on
the static KV scale, and ``write`` quantizes into them through ``kv_cast``.
"""

from __future__ import annotations

import bisect
from collections import deque
from typing import Deque

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.formats import kv_cast
from repro_torch.models import api


class SlotCachePool:
    def __init__(self, cfg: ArchConfig, n_slots: int, s_max: int, dtype, device):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if s_max > cfg.max_seq:
            raise ValueError(f"s_max {s_max} exceeds max_seq {cfg.max_seq}")
        self.n_slots = n_slots
        self.s_max = s_max
        self.cache = api.make_cache(cfg, n_slots, s_max, dtype, device)
        self._free: Deque[int] = deque(range(n_slots))

    def can_admit(self) -> bool:
        return bool(self._free)

    def alloc(self) -> int:
        """Claim the lowest free slot; raises if none (check can_admit)."""
        if not self._free:
            raise RuntimeError("no free slot")
        return self._free.popleft()

    def free(self, slot: int) -> None:
        if slot in self._free or not 0 <= slot < self.n_slots:
            raise ValueError(f"bad free of slot {slot}")
        bisect.insort(self._free, slot)

    def write(self, slot: int, states) -> None:
        """Copy a batch-1 prefill state (per layer (1, s, KH, hd)) into
        positions [0, s) of the slot's row."""
        for dst, src in zip(self.cache, states):
            for name in ("k", "v"):
                s = src[name].shape[1]
                dst[name][slot, :s] = kv_cast(src[name][0], dst[name].dtype)

    @property
    def cache_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for st in self.cache for t in st.values())

    @staticmethod
    def grow(cfg: ArchConfig, states, s_max: int, dtype, device):
        """A batch-1 decode cache of length ``s_max`` holding a prefill state
        (the sequential reference's cache)."""
        pool = SlotCachePool(cfg, 1, s_max, dtype, device)
        pool.write(0, states)
        return pool.cache
