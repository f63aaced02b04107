"""Decode-cache pools (counterpart of ``repro.serving.cache``): the slot
pool and the paged pool, behind one surface the engine drives.

* :class:`SlotCachePool` — ``n_slots`` resident rows per layer, each a
  preallocated ``(n_slots, s_max, KH, hd)`` K and V tensor shared by a churn
  of requests.  ``write`` copies a batch-1 prefill state into a slot's row
  **in place** — the counterpart of the reference's donated graft — and the
  decode tick updates the rows in place too.  Recycling leaks nothing: K/V
  rows past a request's ``cur_index`` are masked in decode attention until
  the decode loop overwrites them.

* :class:`PagedCachePool` — the block-table layout: one shared
  ``(n_pages, page_size, KH, hd)`` K and V **page arena** a layer, sized to
  the expected load; each slot owns a row of page ids in the host block
  table, which the decode tick reads as one ``(n_slots, pages_per_slot)``
  device tensor (``layers/attention.py`` ``paged_cache_update`` /
  ``gather_pages``).  Pages are taken and freed one at a time with
  refcounts; a hash of the whole prompt lets identical prompts prefill once
  and decode off shared pages, the partial boundary page copied on write.

Page id 0 is the reserved **trash page**: a freed slot keeps an all-zero
table row and ``cur_index = 0``, so the writes the tick still makes for
inactive slots land there instead of in a page another slot holds.

Prefix sharing (``share=``): ``"exact"`` (default) — a request whose whole
prompt hashes to a cached entry skips prefill, reusing the entry's pages
and its first-token logits (the dense family has no state outside the
arena); ``"off"`` — no sharing.  ``"pages"`` (page-aligned partial prefixes
with a chunked prefill that resumes from a shared boundary) is not ported
yet (ROADMAP A8b).

Page reservation (``reserve=``): ``"prompt"`` (default) reserves the
prompt's pages at admission and grows a row one page at a time as decode
reaches a page boundary (``append_page`` / ``ensure_page``), so a request
that stops early holds no pages it never writes; ``"worst"`` reserves
prompt + gen - 1 positions up front.

Sharing is sound because a page's positions past a reader's ``cur_index``
are selected away in decode attention; the only conflict is two slots
writing the same (page, offset), which the copy-on-write of the boundary
page removes.  Under ``cfg.quant="int8"`` the rows or arenas are int8 on
the static KV scale, written through ``kv_cast``.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
from collections import Counter, OrderedDict, deque
from typing import Any, Deque, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.formats import kv_cast
from repro_torch.models import api

TRASH_PAGE = 0  # reserved: inactive slots write here (never read unmasked)


def make_paged_cache(cfg: ArchConfig, n_pages: int, page_size: int, dtype, device):
    """The paged twin of ``api.make_cache``: one zeroed (n_pages, page_size,
    KH, hd) K and V arena per layer, shared by every slot; int8 on the static
    KV scale under ``cfg.quant="int8"``, as the slot pool's rows are."""
    return api.make_cache(cfg, n_pages, page_size, dtype, device)


def _cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for st in cache for t in st.values())


# -- prefix index ------------------------------------------------------------


def request_prefix_key(prompt: np.ndarray) -> bytes:
    """Whole-prompt identity: the hash of the prompt's tokens, the
    reference's key for a request without encoder frames."""
    return b"P:" + hashlib.sha256(np.asarray(prompt, np.int32).tobytes()).digest()


@dataclasses.dataclass
class _PrefixEntry:
    """Whole-prompt cache record: the prompt's pages and its first-token
    logits, enough to admit an identical request with no prefill."""

    full_pages: Tuple[int, ...]
    tail_page: int   # -1 when the prompt is page-aligned
    n_tokens: int    # prompt length
    logits: Any      # (1, 1, V) last-position prefill logits (device)

    def pages(self) -> Tuple[int, ...]:
        return self.full_pages + ((self.tail_page,) if self.tail_page >= 0 else ())


@dataclasses.dataclass
class PrefixHit:
    """Result of a prefix lookup: ``entry`` set -> a whole-prompt hit (the
    prefill is skipped, the entry's pages attach, the tail by copy-on-write
    when the request will decode into it); else a miss."""

    entry: Optional[_PrefixEntry] = None
    tokens: int = 0               # prompt tokens covered by the hit
    keys: Tuple[bytes, ...] = ()  # index keys backing the hit (pinned
    # against eviction while this admission is in flight)

    @property
    def skip_prefill(self) -> bool:
        return self.entry is not None


class _Slot(int):
    """A slot id (int-compatible) carrying the admission's PrefixHit."""

    hit: PrefixHit


def _mk_slot(slot: int, hit: PrefixHit) -> _Slot:
    s = _Slot(slot)
    s.hit = hit
    return s


# -- slot pool ---------------------------------------------------------------


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

    def can_admit(self, req=None) -> bool:
        """Slot pools admit whenever a row is free (no page budget)."""
        return bool(self._free)

    def alloc(self, req=None) -> int:
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

    def ensure_page(self, slot: int, pos: int) -> bool:
        """Slot rows are max-length: every position is always backed."""
        return True

    def prefix_lookup(self, req) -> PrefixHit:
        """Slot pools never share prefixes: always a miss."""
        return PrefixHit()

    @property
    def cache_bytes(self) -> int:
        return _cache_bytes(self.cache)

    def stats(self) -> dict:
        return {"kind": "slot", "n_slots": self.n_slots, "s_max": self.s_max,
                "free_slots": len(self._free), "cache_bytes": self.cache_bytes}

    @staticmethod
    def grow(cfg: ArchConfig, states, s_max: int, dtype, device):
        """A batch-1 decode cache of length ``s_max`` holding a prefill state
        (the sequential reference's cache)."""
        pool = SlotCachePool(cfg, 1, s_max, dtype, device)
        pool.write(0, states)
        return pool.cache


# -- paged pool --------------------------------------------------------------


class PagedCachePool:
    """Block-table paged decode cache with refcounts and prefix sharing
    (the module docstring has the design).

    Host state: ``table`` (n_slots, pages_per_slot) int32 page ids, ``ref``
    per-page refcounts (a slot and a prefix entry each hold one; a page
    frees when its last holder lets go), the free-page deque and the LRU
    prefix index.  Admission that needs pages may evict cold prefix
    entries, never a page a slot still holds.
    """

    def __init__(self, cfg: ArchConfig, n_slots: int, s_max: int, dtype, device, *,
                 page_size: int = 16, n_pages: int = 0, share: str = "exact",
                 reserve: str = "prompt"):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if share == "pages":
            raise NotImplementedError(
                "share='pages' (page-level prefix sharing with a chunked prefill) is "
                "not ported yet (ROADMAP A8b)")
        if share not in ("exact", "off"):
            raise ValueError(f"share must be exact|off, got {share}")
        if reserve not in ("prompt", "worst"):
            raise ValueError(f"reserve must be prompt|worst, got {reserve}")
        if s_max > cfg.max_seq:
            raise ValueError(f"s_max {s_max} exceeds max_seq {cfg.max_seq}")
        self.n_slots = n_slots
        self.s_max = s_max
        self.page_size = page_size
        self.pages_per_slot = -(-s_max // page_size)
        # default: the worst case (every slot at s_max) + the trash page; at
        # that size the paged pool never refuses what the slot pool serves
        self.n_pages = int(n_pages) or n_slots * self.pages_per_slot + 1
        if self.n_pages < self.pages_per_slot + 1:
            raise ValueError(
                f"n_pages={self.n_pages} cannot fit one s_max={s_max} request "
                f"({self.pages_per_slot} pages) + the trash page")
        self.share = share
        self.reserve = reserve
        self.cache = make_paged_cache(cfg, self.n_pages, page_size, dtype, device)
        self.table = np.zeros((n_slots, self.pages_per_slot), np.int32)
        self.ref = np.zeros(self.n_pages, np.int32)
        self.ref[TRASH_PAGE] = 1  # pinned forever
        self._free_pages: Deque[int] = deque(range(1, self.n_pages))
        self._free_slots: Deque[int] = deque(range(n_slots))
        self._slot_pages: List[List[int]] = [[] for _ in range(n_slots)]
        self._slot_hit: List[Optional[PrefixHit]] = [None] * n_slots
        # highest written position + 1 per slot: admission sets it to the
        # prompt length, ensure_page advances it at each decode write
        self._slot_hiwater: List[int] = [0] * n_slots
        self._index: "OrderedDict[bytes, _PrefixEntry]" = OrderedDict()  # LRU
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.prefill_skips = 0
        self.cow_copies = 0
        self.evictions = 0
        self.peak_pages_in_use = 0
        self.appended_pages = 0
        self.reserved_pages_total = 0  # pages ever reserved (alloc + append)
        self.written_pages_total = 0   # written pages of freed slots

    # -- geometry / accounting --

    @property
    def pages_in_use(self) -> int:
        """Allocated pages (slots + prefix index), the trash page excluded."""
        return self.n_pages - 1 - len(self._free_pages)

    def _pages(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def pages_needed(self, req) -> int:
        """Pages reserved at admission: the prompt's (``reserve="prompt"``;
        decode appends the rest a page at a time) or the whole lifetime's,
        prompt + gen - 1 positions (``"worst"``; the last sampled token is
        never fed back)."""
        if self.reserve == "prompt":
            return self._pages(req.prompt_len)
        return self._pages(req.prompt_len + req.max_new_tokens - 1)

    # -- prefix index --

    def _lookup(self, req, touch: bool) -> PrefixHit:
        if self.share == "off" or req is None:
            return PrefixHit()
        key = request_prefix_key(req.prompt)
        e = self._index.get(key)
        if e is None:
            return PrefixHit()
        if touch:
            self._index.move_to_end(key)
        return PrefixHit(entry=e, tokens=e.n_tokens, keys=(key,))

    def prefix_lookup(self, req) -> PrefixHit:
        """Non-mutating query (no LRU touch, no pinning)."""
        return self._lookup(req, touch=False)

    def _release(self, pid: int) -> None:
        self.ref[pid] -= 1
        if self.ref[pid] == 0:
            self._free_pages.append(pid)

    def _drop_entry(self, key: bytes) -> None:
        e = self._index.pop(key)
        self.evictions += 1
        for pid in e.pages():
            self._release(pid)

    def _evictable(self, exclude: Tuple[bytes, ...]) -> int:
        """Pages that would free if every non-excluded entry were evicted
        (pages whose every ref is held by those entries)."""
        held: Counter = Counter()
        for k, e in self._index.items():
            if k not in exclude:
                held.update(e.pages())
        return sum(1 for pid, c in held.items() if self.ref[pid] == c)

    def _take_page(self, exclude: Tuple[bytes, ...] = ()) -> int:
        while not self._free_pages:
            cold = next((k for k in self._index if k not in exclude), None)
            if cold is None:
                break  # only pinned entries left
            self._drop_entry(cold)
        if not self._free_pages:
            raise RuntimeError("page arena exhausted (callers gate on can_admit)")
        return self._free_pages.popleft()

    def clear_prefix(self) -> None:
        """Drop every prefix-cache entry (releases its page refs)."""
        for k in list(self._index):
            self._drop_entry(k)

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write: duplicate one arena page, in place, in every layer."""
        for st in self.cache:
            for arena in st.values():
                arena[dst].copy_(arena[src])

    # -- admission --

    def can_admit(self, req=None) -> bool:
        """A free slot and enough pages (free now, or freeable by evicting
        prefix entries that do not back this request's hit)."""
        if not self._free_slots:
            return False
        if req is None:
            return True
        hit = self._lookup(req, touch=False)
        needed = self.pages_needed(req) - self._attached_pages(req, hit)
        if needed <= len(self._free_pages):
            return True
        return needed <= len(self._free_pages) + self._evictable(hit.keys)

    def _attached_pages(self, req, hit: PrefixHit) -> int:
        """Pages a hit contributes without a fresh page (the copied boundary
        page still costs one, so it does not count)."""
        if hit.entry is None:
            return 0
        n = len(hit.entry.full_pages)
        if hit.entry.tail_page >= 0 and req.max_new_tokens == 1:
            n += 1  # a read-only tail attaches, no copy
        return n

    def alloc(self, req=None) -> _Slot:
        """Claim a slot and reserve its pages: attach a hit's shared pages
        (ref++), copy the boundary page if this request will decode into it,
        take the rest fresh.  Returns an int-compatible slot whose ``.hit``
        carries the admission's PrefixHit."""
        if req is None:
            raise ValueError("PagedCachePool.alloc needs the request (pages are "
                             "sized to its prompt)")
        if not self._free_slots:
            raise RuntimeError("no free slot")
        worst = self._pages(req.prompt_len + req.max_new_tokens - 1)
        if worst > self.pages_per_slot:
            # checked against the lifetime footprint under prompt reservation
            # too: decode appends must never overflow the table row
            raise ValueError(f"request {req.rid}: needs {worst} pages > "
                             f"pages_per_slot={self.pages_per_slot}")
        n_total = self.pages_needed(req)
        hit = self._lookup(req, touch=True)
        slot = self._free_slots.popleft()
        row: List[int] = []
        if hit.entry is not None:
            e = hit.entry
            for pid in e.full_pages:
                self.ref[pid] += 1
                row.append(pid)
            if e.tail_page >= 0:
                if req.max_new_tokens > 1:
                    # the sharer writes positions >= prompt_len into this
                    # page while other sharers read it: copy it
                    dst = self._take_page(hit.keys)
                    self._copy_page(e.tail_page, dst)
                    self.cow_copies += 1
                    self.ref[dst] += 1
                    row.append(dst)
                else:
                    self.ref[e.tail_page] += 1
                    row.append(e.tail_page)
            self.prefix_hits += 1
            self.prefix_hit_tokens += e.n_tokens
        while len(row) < n_total:
            pid = self._take_page(hit.keys)
            self.ref[pid] += 1
            row.append(pid)
        self.table[slot, :] = TRASH_PAGE
        self.table[slot, :len(row)] = row
        self._slot_pages[slot] = row
        self._slot_hit[slot] = hit
        self._slot_hiwater[slot] = req.prompt_len
        self.reserved_pages_total += len(row)
        self.peak_pages_in_use = max(self.peak_pages_in_use, self.pages_in_use)
        return _mk_slot(slot, hit)

    def append_page(self, slot: int) -> bool:
        """Grow the slot's table row by one page at decode time (evicting
        cold prefix entries if needed).  False when the row is full or the
        arena is exhausted: the engine then preempts or raises
        ``AdmissionError``."""
        row = self._slot_pages[slot]
        if len(row) >= self.pages_per_slot:
            return False
        if not self._free_pages and not self._evictable(()):
            return False
        pid = self._take_page()
        self.ref[pid] += 1
        row.append(pid)
        self.table[slot, len(row) - 1] = pid
        self.appended_pages += 1
        self.reserved_pages_total += 1
        self.peak_pages_in_use = max(self.peak_pages_in_use, self.pages_in_use)
        return True

    def ensure_page(self, slot: int, pos: int) -> bool:
        """Back position ``pos`` with a page before the tick writes it,
        appending pages as decode crosses page boundaries; advances the
        slot's written mark.  False -> out of pages."""
        row = self._slot_pages[slot]
        while len(row) < pos // self.page_size + 1:
            if not self.append_page(slot):
                return False
        self._slot_hiwater[slot] = max(self._slot_hiwater[slot], pos + 1)
        return True

    def write(self, slot: int, states, req=None, logits=None) -> None:
        """The device writes of an admission ``alloc`` reserved.  On a
        whole-prompt hit there is none (the pages hold the prefill's K/V).
        Otherwise the batch-1 prefill K/V (per layer (1, s, KH, hd)),
        zero-padded to whole pages, goes into the slot's prompt pages, and
        the prompt is registered in the prefix index with ``logits``."""
        hit = self._slot_hit[slot] or PrefixHit()
        if hit.skip_prefill:
            self.prefill_skips += 1
            return
        if req is None:
            raise ValueError("PagedCachePool.write needs the request")
        n = self._pages(req.prompt_len)
        device = self.cache[0]["k"].device
        pids = torch.as_tensor(self.table[slot, :n], dtype=torch.int64, device=device)
        for dst, src in zip(self.cache, states):
            for name in ("k", "v"):
                buf = kv_cast(src[name][0], dst[name].dtype)  # (s, KH, hd)
                pad = n * self.page_size - buf.shape[0]
                buf = torch.nn.functional.pad(buf, (0, 0, 0, 0, 0, pad))
                dst[name][pids] = buf.reshape(n, self.page_size, *buf.shape[1:])
        if self.share != "off":
            self._register(slot, req, logits)

    def _register(self, slot: int, req, logits) -> None:
        key = request_prefix_key(req.prompt)
        if key in self._index:
            return
        f, r = divmod(req.prompt_len, self.page_size)
        full = tuple(int(p) for p in self.table[slot, :f])
        tail = int(self.table[slot, f]) if r else -1
        for pid in full + ((tail,) if r else ()):
            self.ref[pid] += 1
        self._index[key] = _PrefixEntry(full_pages=full, tail_page=tail,
                                        n_tokens=req.prompt_len, logits=logits)

    def free(self, slot: int) -> None:
        """Drop the slot's page refs (a page frees when its last holder, slot
        or prefix entry, lets go) and point its table row at the trash page,
        so the tick's writes for the idle slot cannot touch a recycled page."""
        if slot in self._free_slots or not 0 <= slot < self.n_slots:
            raise ValueError(f"bad free of slot {slot}")
        self.written_pages_total += self._written(slot)
        for pid in self._slot_pages[slot]:
            self._release(pid)
        self._slot_pages[slot] = []
        self._slot_hit[slot] = None
        self._slot_hiwater[slot] = 0
        self.table[slot, :] = TRASH_PAGE
        bisect.insort(self._free_slots, slot)

    def _written(self, slot: int) -> int:
        return min(self._pages(self._slot_hiwater[slot]), len(self._slot_pages[slot]))

    def row(self, slot: int):
        """The slot's dense (s_max, KH, hd) K and V views per layer, gathered
        from its pages (tests)."""
        idx = torch.as_tensor(self.table[slot], dtype=torch.int64,
                              device=self.cache[0]["k"].device)
        return [{name: st[name][idx].reshape(-1, *st[name].shape[2:])[:self.s_max]
                 for name in ("k", "v")} for st in self.cache]

    @property
    def cache_bytes(self) -> int:
        return _cache_bytes(self.cache)

    def stats(self) -> dict:
        # live slots' written pages (freed slots are in written_pages_total):
        # reserved against written is the waste prompt reservation removes
        live_written = sum(self._written(s) for s in range(self.n_slots)
                           if self._slot_pages[s])
        return {
            "kind": "paged",
            "n_slots": self.n_slots,
            "page_size": self.page_size,
            "n_pages": self.n_pages,
            "pages_per_slot": self.pages_per_slot,
            "reserve": self.reserve,
            "pages_in_use": self.pages_in_use,
            "peak_pages_in_use": self.peak_pages_in_use,
            "free_pages": len(self._free_pages),
            "free_slots": len(self._free_slots),
            "reserved_pages": self.reserved_pages_total,
            "written_pages": self.written_pages_total + live_written,
            "appended_pages": self.appended_pages,
            "prefix_entries": len(self._index),
            "prefix_hits": self.prefix_hits,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefill_skips": self.prefill_skips,
            "cow_copies": self.cow_copies,
            "evictions": self.evictions,
            "cache_bytes": self.cache_bytes,
        }
