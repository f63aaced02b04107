"""Continuous-batching serving engine (counterpart of
``repro.serving.engine``: the slot and paged pools, greedy).

    arrivals -> admission queue -> slot scheduler -> prefill / decode ticks
             -> completion and slot reuse

* **Prefill** runs per request at its own prompt length, in one shot; its
  K/V is copied in place into the pool and the first token is sampled from
  the prefill logits (that timestamp is TTFT).
* **Decode ticks** run one decode step over the whole pool with a per-slot
  ``cur_index`` vector and sample greedily on the device; only the
  ``(n_slots,)`` token ids cross to the host.
* **Numeric guard** (always on): a tick folds each slot's
  ``all(isfinite(logits))`` into its token as sentinel ``-1``; a tripped
  slot is freed and its request finishes with ``"numeric_error"`` in the
  same tick, while the other slots keep their tokens (every row's math is
  its own, and masked cache rows are selected away, never multiplied).
  Non-finite prefill logits fail the request before it takes a slot.

* **int8** (``cfg.quant="int8"``): the engine quantizes the parameters at
  construction (per-tensor int8, dequantized leaf by leaf inside the
  steps) and keeps the slot pool's K/V in int8 on the static KV scale;
  every division site runs the fixed-point datapath.  The norms' int8
  activations take one scale over the whole tick batch, idle slots
  included, so an idle slot's operands (``cur = 0``, ``last_tok = 0``) are
  part of the computation, as in the reference.

The pool is chosen by ``EngineConfig.pool``: ``"slot"`` (default), a
max-length row per slot (:class:`SlotCachePool`), or ``"paged"``, the
block-table page arena (:class:`PagedCachePool`).  The paged engine admits
by the page budget of the request as it would prefill now
(``_effective_request``), reserving by default only the prompt's pages;
before each tick it backs every active slot's write position, oldest
admission first, appending a page as decode crosses a page boundary, and
the tick reads the whole block table as one device tensor.  When the arena
runs out, the youngest request is preempted (its pages freed, re-queued
behind the head) and later replayed: its prompt and all but the last
recorded token re-prefill as one prompt, no first token is sampled, and
decode resumes from the held token.  A head of line refused for
``preempt_after_ticks`` ticks, for want of pages or of a free slot (the
reference's rule, ROADMAP C10), preempts the youngest too; a request that
no draining can ever fit raises :class:`AdmissionError`.  With
``prefix="exact"`` a request whose whole prompt is cached skips its
prefill and decodes off the shared pages (the boundary page copied).  At
f32 the paged engine's tokens are the slot engine's, token for token.

Not ported yet: ``prefix="pages"`` with its chunked prefill (ROADMAP A8b),
stochastic and top-k sampling (A10a), deadlines, cancellation, retries and
fault injection (A10b), tracing (A11), the static scheduler (A12b) and the
mesh (A13).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.layers.quant import is_quantized, quantize_params
from repro_torch.serving.cache import PagedCachePool, SlotCachePool
from repro_torch.serving.requests import (FINISH_LENGTH, FINISH_NUMERIC,
                                          FINISH_STOP, FINISHED, QUEUED, RUNNING,
                                          GenerationResult, Request,
                                          RequestState)
from repro_torch.serving.resilience import AdmissionError
from repro_torch.serving.sampler import sample_greedy

POOLS = ("slot", "paged")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    n_slots: int = 4
    s_max: int = 0  # 0 -> cfg.max_seq
    max_prefill_per_tick: int = 1  # prefills admitted between decode ticks
    pool: str = "slot"      # slot | paged
    page_size: int = 16     # paged: tokens per arena page
    n_pages: int = 0        # paged: arena size; 0 -> worst case + trash page
    prefix: str = "exact"   # paged: prefix sharing, exact | off ("pages": A8b)
    page_reserve: str = "prompt"  # paged: prompt | worst admission budget
    preempt_after_ticks: int = 3  # paged: stalled-head ticks before a preempt


@dataclasses.dataclass
class ServeMetrics:
    n_requests: int = 0
    n_slots: int = 0
    prefill_tokens: int = 0   # prompt tokens processed by prefill
    first_tokens: int = 0     # tokens sampled from prefill logits
    decode_tokens: int = 0    # tokens sampled from decode ticks
    decode_ticks: int = 0
    prefill_time_s: float = 0.0
    decode_time_s: float = 0.0
    occupancy_ticks: int = 0  # sum over ticks of active slots
    peak_active: int = 0
    makespan_s: float = 0.0
    failed: int = 0           # numeric_error finishes
    cache_bytes: int = 0      # the pool's K/V tensors (rows or arena)
    prefill_skips: int = 0    # prefills skipped by exact prefix hits
    prefix_hits: int = 0      # admissions served from a cached prompt
    prefix_hit_tokens: int = 0  # prompt tokens those hits covered
    preempted: int = 0        # paged preempt-youngest events
    pool: dict = dataclasses.field(default_factory=dict)  # the pool's stats()
    ttft_s: Dict[int, float] = dataclasses.field(default_factory=dict)
    itl_samples: List[float] = dataclasses.field(default_factory=list)

    @property
    def decode_tok_per_s(self) -> float:
        if self.decode_ticks == 0:
            return 0.0
        return self.decode_tokens / max(self.decode_time_s, 1e-9)

    @property
    def occupancy(self) -> float:
        if self.decode_ticks == 0:
            return 0.0
        return self.occupancy_ticks / (self.decode_ticks * self.n_slots)


@dataclasses.dataclass
class ServeResult:
    """All results of one ``Engine.run``, by request id, and its metrics."""

    results: Dict[int, GenerationResult]
    metrics: ServeMetrics

    def __getitem__(self, rid: int) -> GenerationResult:
        return self.results[rid]


def _check_params(params, device: torch.device) -> None:
    where = (params["q"] if is_quantized(params) else params)["embed"].device
    if where.type != device.type:
        raise ValueError(f"params live on {where}, the engine runs on {device}")


def _check_greedy(req: Request) -> None:
    if req.sampling.stochastic or req.sampling.top_k:
        raise NotImplementedError(
            f"request {req.rid}: stochastic and top-k sampling are not ported "
            "yet (ROADMAP A10a); this port serves greedy requests")


def _prompt_tensor(req: Request, device) -> torch.Tensor:
    return torch.as_tensor(req.prompt[None, :], dtype=torch.int64, device=device)


class Engine:
    """Continuous-batching engine over one model and one cache pool, on
    ``device`` (``cuda`` unless the caller asks for the CPU).  Under
    ``cfg.quant="int8"`` ``self.params`` is the quantized tree and the pool
    holds int8 K/V."""

    def __init__(self, cfg: ArchConfig, params,
                 engine_cfg: Optional[EngineConfig] = None, *,
                 device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        _check_params(params, self.device)
        self.cfg = cfg
        self.ecfg = engine_cfg or EngineConfig()
        if self.ecfg.pool not in POOLS:
            raise ValueError(f"pool must be one of {POOLS}")
        if self.ecfg.page_reserve not in ("prompt", "worst"):
            raise ValueError(f"page_reserve must be prompt|worst, got {self.ecfg.page_reserve}")
        self._paged = self.ecfg.pool == "paged"
        if self._paged and self.ecfg.prefix == "pages":
            raise NotImplementedError(
                "prefix='pages' (page-level prefix sharing with a chunked prefill) is not "
                "ported yet (ROADMAP A8b); this port serves prefix='exact' or 'off'")
        self._policy = cfg.policy()  # raises for an unknown quant mode
        self.params = quantize_params(params) if cfg.quant != "none" else params
        self.s_max = self.ecfg.s_max or cfg.max_seq
        pages_per_slot = -(-self.s_max // self.ecfg.page_size)
        self._n_pages = self.ecfg.n_pages or self.ecfg.n_slots * pages_per_slot + 1
        self._prefill = make_prefill_step(cfg)
        # the paged tick cuts each row's view of its pages to s_max, so decode
        # attention runs at the slot pool's shapes
        self._decode = (make_decode_step(cfg, self.ecfg.page_size, self.s_max)
                        if self._paged else make_decode_step(cfg))

    def _make_pool(self):
        if self._paged:
            return PagedCachePool(self.cfg, self.ecfg.n_slots, self.s_max,
                                  self.cfg.compute_dtype, self.device,
                                  page_size=self.ecfg.page_size, n_pages=self._n_pages,
                                  share=self.ecfg.prefix, reserve=self.ecfg.page_reserve)
        return SlotCachePool(self.cfg, self.ecfg.n_slots, self.s_max,
                             self.cfg.compute_dtype, self.device)

    def _validate(self, req: Request) -> None:
        _check_greedy(req)
        if req.prompt_len + req.max_new_tokens - 1 > self.s_max:
            raise ValueError(
                f"request {req.rid}: prompt {req.prompt_len} + gen "
                f"{req.max_new_tokens} exceeds s_max={self.s_max}")
        if self._paged:
            need = -(-(req.prompt_len + req.max_new_tokens - 1) // self.ecfg.page_size)
            if need > self._n_pages - 1:
                raise ValueError(
                    f"request {req.rid}: needs {need} pages but the arena only has "
                    f"{self._n_pages - 1} (plus the trash page)")

    @staticmethod
    def _effective_request(st: RequestState) -> Request:
        """The request as it would prefill now: a preemption replay folds its
        recorded tokens, all but the held last one, into the prompt.
        Admission gates on this, since under prompt reservation a replay's
        footprint grows with its recorded tokens."""
        req = st.request
        if not st.tokens:
            return req
        prompt = np.concatenate([req.prompt, np.asarray(st.tokens[:-1], np.int32)])
        return Request(rid=req.rid, prompt=prompt,
                       max_new_tokens=req.max_new_tokens - len(st.tokens) + 1,
                       sampling=req.sampling)

    @torch.no_grad()
    def _tick(self, cache, cur: np.ndarray, last_tok: np.ndarray,
              table: Optional[np.ndarray] = None) -> np.ndarray:
        """One decode step over every slot; returns (n_slots,) token ids with
        ``-1`` for a slot whose logits are not all finite.  A paged pool's
        block table goes to the device here, once a tick."""
        cur_t = torch.as_tensor(cur, device=self.device)
        tok_t = torch.as_tensor(last_tok[:, None], device=self.device)
        paged = {}
        if table is not None:
            paged["page_table"] = torch.as_tensor(table, dtype=torch.int64,
                                                  device=self.device)
        logits, _ = self._decode(self.params, cache, cur_t, {"token": tok_t}, **paged)
        last = logits[:, -1, :]
        valid = torch.isfinite(last.to(torch.float32)).all(dim=-1)
        toks = torch.where(valid, sample_greedy(last, policy=self._policy), -1)
        return toks.cpu().numpy()

    @torch.no_grad()
    def _admit(self, st: RequestState, pool, metrics: ServeMetrics, clock) -> bool:
        """Prefill ``st`` into a slot and sample its first token.  Returns
        False when non-finite prefill logits failed it instead (the slot is
        released).  An exact prefix hit skips the prefill and samples from
        the cached logits.  A state that holds tokens is a preemption replay:
        its effective prompt re-prefills, no first token is sampled, and its
        held last token re-enters decode."""
        req = st.request
        replay = bool(st.tokens)
        eff = self._effective_request(st)
        t0 = time.perf_counter()
        slot = pool.alloc(eff)  # a paged pool resolves prefix hits here
        hit = getattr(slot, "hit", None)
        if hit is not None and hit.skip_prefill:
            logits, states = hit.entry.logits, None
            metrics.prefill_skips += 1
        else:
            logits, states, _ = self._prefill(self.params,
                                              {"tokens": _prompt_tensor(eff, self.device)})
            metrics.prefill_tokens += eff.prompt_len
        last = logits[:, -1, :]
        if not bool(torch.isfinite(last.to(torch.float32)).all()):
            # fail before the write, so the prefix index never caches it
            pool.free(int(slot))
            metrics.prefill_time_s += time.perf_counter() - t0
            st.reason, st.status, st.t_finish = FINISH_NUMERIC, FINISHED, clock()
            metrics.failed += 1
            return False
        if not replay:
            token = int(sample_greedy(last, policy=self._policy)[0])
        st.slot = int(slot)
        if self._paged:  # the paged pool pages the prompt and registers it
            pool.write(st.slot, states, req=eff, logits=logits)
        else:
            pool.write(st.slot, states)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # bill the copy to prefill
        metrics.prefill_time_s += time.perf_counter() - t0
        st.status = RUNNING
        if not replay:
            st.tokens.append(token)
            st.t_first_token = st.t_last_token = clock()
            metrics.first_tokens += 1
            metrics.ttft_s[req.rid] = st.ttft
        return True

    def run(self, requests: Sequence[Request]) -> ServeResult:
        """Serve ``requests`` to completion on the engine clock (wall time
        from the call); a request is admitted once the clock passes its
        ``arrival_time``, first come first served, as the pool's slots (and
        pages) allow."""
        rids = [r.rid for r in requests]
        if len(set(rids)) != len(rids):
            raise ValueError("duplicate request rids: outputs are keyed by rid")
        for req in requests:
            self._validate(req)
        n = self.ecfg.n_slots
        pool = self._make_pool()
        metrics = ServeMetrics(n_requests=len(requests), n_slots=n,
                               cache_bytes=pool.cache_bytes)
        t_start = time.perf_counter()
        clock = lambda: time.perf_counter() - t_start  # noqa: E731

        states = [RequestState(r, t_arrive=r.arrival_time)
                  for r in sorted(requests, key=lambda r: (r.arrival_time, r.rid))]
        pending: Deque[RequestState] = deque(states)
        ready: Deque[RequestState] = deque()
        active: Dict[int, RequestState] = {}  # slot -> state
        # host mirrors of the per-slot device vectors; a free slot keeps 0s
        # (a paged pool's writes for it then land at the trash page's start)
        cur = np.zeros(n, np.int64)
        last_tok = np.zeros(n, np.int64)
        admit_seq = 0
        stall = 0  # consecutive passes with the head of line refused

        def finish(st: RequestState, reason: Optional[str] = None) -> None:
            st.reason = reason
            st.t_finish, st.status = clock(), FINISHED
            pool.free(st.slot)
            cur[st.slot] = last_tok[st.slot] = 0
            st.slot = -1

        def start(st: RequestState) -> None:
            nonlocal admit_seq
            if not self._admit(st, pool, metrics, clock):
                return  # failed at prefill; its slot is released
            st.admit_seq, admit_seq = admit_seq, admit_seq + 1
            if st.done:  # max_new_tokens == 1: no decode steps
                finish(st)
                return
            active[st.slot] = st
            cur[st.slot], last_tok[st.slot] = st.cur_index, st.tokens[-1]

        def preempt_youngest() -> None:
            """Free the most recently admitted request's pages and re-queue it
            behind the stalled head; its recorded tokens replay when it is
            admitted again (``_admit``)."""
            slot, st = max(active.items(), key=lambda kv: kv[1].admit_seq)
            del active[slot]
            pool.free(slot)
            cur[slot] = last_tok[slot] = 0
            st.slot, st.status = -1, QUEUED
            metrics.preempted += 1
            ready.insert(min(1, len(ready)), st)

        def head_fits() -> bool:
            return pool.can_admit(self._effective_request(ready[0]))

        while pending or ready or active:
            now = clock()
            while pending and pending[0].t_arrive <= now:
                ready.append(pending.popleft())
            admitted = 0
            while ready and admitted < self.ecfg.max_prefill_per_tick and head_fits():
                start(ready.popleft())
                admitted += 1
            stall = stall + 1 if (ready and not admitted and active
                                  and not head_fits()) else 0
            if self._paged and active and stall >= self.ecfg.preempt_after_ticks:
                preempt_youngest()
                stall = 0
                continue  # retry admission before a tick
            if not active:
                if ready and not pending and not admitted:
                    # nothing running, nothing arriving, the head refused:
                    # the pool can never fit it
                    raise AdmissionError(
                        ready[0].request.rid, pool.stats(),
                        queued=[s.request.rid for s in ready],
                        pages_needed=({s.request.rid:
                                       pool.pages_needed(self._effective_request(s))
                                       for s in ready} if self._paged else None))
                if pending and not ready:  # idle until the next arrival
                    time.sleep(max(0.0, min(pending[0].t_arrive - clock(), 0.005)))
                continue
            if self._paged:
                # back every active slot's write position, oldest admission
                # first; a slot the arena cannot back is resolved in place by
                # preempting the youngest until its page lands (restarting
                # the pass would re-admit the preempted request first and
                # never reach the tick)
                for slot in sorted(active, key=lambda s: active[s].admit_seq):
                    while slot in active and not pool.ensure_page(slot, int(cur[slot])):
                        if len(active) > 1:
                            preempt_youngest()  # may preempt `slot` itself
                            continue
                        raise AdmissionError(
                            active[slot].request.rid, pool.stats(),
                            queued=[s.request.rid for s in ready],
                            pages_needed={active[slot].request.rid: 1})

            t0 = time.perf_counter()
            nxt = self._tick(pool.cache, cur, last_tok,
                             pool.table if self._paged else None)
            metrics.decode_time_s += time.perf_counter() - t0
            metrics.decode_ticks += 1
            metrics.occupancy_ticks += len(active)
            metrics.peak_active = max(metrics.peak_active, len(active))
            for slot in [s for s in active if nxt[s] < 0]:
                finish(active.pop(slot), FINISH_NUMERIC)  # quarantine: token never kept
                metrics.failed += 1
            metrics.decode_tokens += len(active)
            now = clock()
            for slot, st in list(active.items()):
                st.tokens.append(int(nxt[slot]))
                metrics.itl_samples.append(now - st.t_last_token)
                st.t_last_token = now
                if st.done:
                    finish(active.pop(slot))
                else:
                    cur[slot], last_tok[slot] = st.cur_index, st.tokens[-1]

        metrics.makespan_s = clock()
        metrics.pool = pool.stats()
        metrics.prefix_hits = metrics.pool.get("prefix_hits", 0)
        metrics.prefix_hit_tokens = metrics.pool.get("prefix_hit_tokens", 0)
        results = {
            st.request.rid: GenerationResult(
                rid=st.request.rid, prompt_len=st.request.prompt_len,
                tokens=np.asarray(st.tokens, np.int32),
                ttft_s=st.ttft if st.tokens else 0.0,
                finish_s=st.t_finish - st.t_arrive,
                finish_reason=st.finish_reason)
            for st in states}
        return ServeResult(results, metrics)


@torch.no_grad()
def generate_sequential(cfg: ArchConfig, params, request: Request, *,
                        s_max: Optional[int] = None,
                        device=DEFAULT_DEVICE) -> GenerationResult:
    """Single-request reference: prefill, then a batch-1 decode loop, with
    the same model entry points and sampler as the engine, so an
    engine-vs-sequential mismatch isolates the serving machinery.  Under
    ``cfg.quant="int8"`` its KV cache is int8, as the engine's; pass
    ``quantize_params(params)`` for the engine's int8 weights."""
    dev = resolve_device(device)
    _check_params(params, dev)
    _check_greedy(request)
    s_max = s_max or cfg.max_seq
    if request.prompt_len + request.max_new_tokens - 1 > s_max:
        raise ValueError(f"request {request.rid}: prompt + gen exceeds s_max={s_max}")
    policy = cfg.policy()
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    stop = request.sampling.stop
    t0 = time.perf_counter()
    logits, states, _ = prefill(params, {"tokens": _prompt_tensor(request, dev)})
    cache = SlotCachePool.grow(cfg, states, s_max, cfg.compute_dtype, dev)
    out = [int(sample_greedy(logits[:, -1, :], policy=policy)[0])]
    ttft = time.perf_counter() - t0
    for i in range(request.max_new_tokens - 1):
        if out[-1] == stop:
            break
        cur = torch.tensor([request.prompt_len + i], device=dev)
        token = torch.tensor([[out[-1]]], device=dev)
        lg, cache = decode(params, cache, cur, {"token": token})
        out.append(int(sample_greedy(lg[:, -1, :], policy=policy)[0]))
    return GenerationResult(
        rid=request.rid, prompt_len=request.prompt_len,
        tokens=np.asarray(out, np.int32), ttft_s=ttft,
        finish_s=time.perf_counter() - t0,
        finish_reason=FINISH_STOP if out[-1] == stop else FINISH_LENGTH)
