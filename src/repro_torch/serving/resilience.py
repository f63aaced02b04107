"""Fault tolerance for the serving runtime (counterpart of
``repro.serving.resilience``): :class:`AdmissionError` only.

The engine raises it where its loop would otherwise spin forever: the pool
is idle and the head of the queue can never fit, or the last active request
cannot get the page its next decode step writes.  The rest of the
reference's module (deadlines, cancellation, retries with backoff and the
fault injector's slot poisoning) is not ported yet (ROADMAP A10b).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence


class AdmissionError(RuntimeError):
    """The head-of-line request can never be admitted: the pool is idle
    (nothing active to drain) and the request's slot or page needs exceed
    what the pool can free.

    Attributes: ``rid`` (the stuck request), ``pool_stats`` (the pool's
    ``stats()`` at raise time), ``queued`` (rids still waiting, head first),
    ``pages_needed`` (rid -> page budget, paged pools only).
    """

    def __init__(self, rid: int, pool_stats: dict, queued: Sequence[int] = (),
                 pages_needed: Optional[Dict[int, int]] = None):
        self.rid = rid
        self.pool_stats = dict(pool_stats)
        self.queued = list(queued)
        self.pages_needed = dict(pages_needed or {})
        parts = [f"request {rid} cannot be admitted and no active request can "
                 f"unblock it"]
        free = {k: v for k, v in self.pool_stats.items()
                if k in ("free_slots", "free_pages", "n_slots", "n_pages", "page_size",
                         "kind")}
        parts.append(f"pool: {free}")
        parts.append(f"queued rids: {self.queued}")
        if self.pages_needed:
            parts.append(f"pages needed: {self.pages_needed}")
        super().__init__("; ".join(parts))
