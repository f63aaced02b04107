"""Continuous-batching serving engine (counterpart of
``repro.serving.engine``, slot pool, greedy).

    arrivals -> admission queue -> slot scheduler -> prefill / decode ticks
             -> completion and slot reuse

* **Prefill** runs per request at its own prompt length; its K/V is copied
  in place into a :class:`SlotCachePool` row and the first token is sampled
  from the prefill logits (that timestamp is TTFT).
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

Not ported yet: the paged pool and prefix reuse (ROADMAP A8), stochastic
and top-k sampling (A10a), deadlines, cancellation, retries, preemption
and fault injection (A10b), tracing (A11), the static scheduler (A12b) and
the mesh (A13).
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
from repro_torch.serving.cache import SlotCachePool
from repro_torch.serving.requests import (FINISH_LENGTH, FINISH_NUMERIC,
                                          FINISH_STOP, FINISHED, RUNNING,
                                          GenerationResult, Request,
                                          RequestState)
from repro_torch.serving.sampler import sample_greedy


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    n_slots: int = 4
    s_max: int = 0  # 0 -> cfg.max_seq


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
    cache_bytes: int = 0      # the slot pool's K/V tensors
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
            "yet (ROADMAP A10); this port serves greedy requests")


def _prompt_tensor(req: Request, device) -> torch.Tensor:
    return torch.as_tensor(req.prompt[None, :], dtype=torch.int64, device=device)


class Engine:
    """Continuous-batching engine over one model and one slot pool, on
    ``device`` (``cuda`` unless the caller asks for the CPU).  Under
    ``cfg.quant="int8"`` ``self.params`` is the quantized tree."""

    def __init__(self, cfg: ArchConfig, params,
                 engine_cfg: Optional[EngineConfig] = None, *,
                 device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        _check_params(params, self.device)
        self.cfg = cfg
        self._policy = cfg.policy()  # raises for an unknown quant mode
        self.params = quantize_params(params) if cfg.quant != "none" else params
        self.ecfg = engine_cfg or EngineConfig()
        self.s_max = self.ecfg.s_max or cfg.max_seq
        self._prefill = make_prefill_step(cfg)
        self._decode = make_decode_step(cfg)

    def _validate(self, req: Request) -> None:
        _check_greedy(req)
        if req.prompt_len + req.max_new_tokens - 1 > self.s_max:
            raise ValueError(
                f"request {req.rid}: prompt {req.prompt_len} + gen "
                f"{req.max_new_tokens} exceeds s_max={self.s_max}")

    @torch.no_grad()
    def _tick(self, cache, cur: np.ndarray, last_tok: np.ndarray) -> np.ndarray:
        """One decode step over every slot; returns (n_slots,) token ids with
        ``-1`` for a slot whose logits are not all finite."""
        cur_t = torch.as_tensor(cur, device=self.device)
        tok_t = torch.as_tensor(last_tok[:, None], device=self.device)
        logits, _ = self._decode(self.params, cache, cur_t, {"token": tok_t})
        last = logits[:, -1, :]
        valid = torch.isfinite(last.to(torch.float32)).all(dim=-1)
        toks = torch.where(valid, sample_greedy(last, policy=self._policy), -1)
        return toks.cpu().numpy()

    @torch.no_grad()
    def _admit(self, st: RequestState, pool: SlotCachePool,
               metrics: ServeMetrics, clock) -> bool:
        """Prefill ``st`` into a free slot and sample its first token.
        Returns False when non-finite prefill logits failed it instead."""
        req = st.request
        t0 = time.perf_counter()
        slot = pool.alloc()
        logits, states, _ = self._prefill(self.params,
                                          {"tokens": _prompt_tensor(req, self.device)})
        metrics.prefill_tokens += req.prompt_len
        last = logits[:, -1, :]
        if not bool(torch.isfinite(last.to(torch.float32)).all()):
            pool.free(slot)
            metrics.prefill_time_s += time.perf_counter() - t0
            st.reason, st.status, st.t_finish = FINISH_NUMERIC, FINISHED, clock()
            metrics.failed += 1
            return False
        token = int(sample_greedy(last, policy=self._policy)[0])
        pool.write(slot, states)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # bill the copy to prefill
        metrics.prefill_time_s += time.perf_counter() - t0
        st.slot, st.status = slot, RUNNING
        st.tokens.append(token)
        st.t_first_token = st.t_last_token = clock()
        metrics.first_tokens += 1
        metrics.ttft_s[req.rid] = st.ttft
        return True

    def run(self, requests: Sequence[Request]) -> ServeResult:
        """Serve ``requests`` to completion on the engine clock (wall time
        from the call); a request is admitted once the clock passes its
        ``arrival_time``, first come first served."""
        rids = [r.rid for r in requests]
        if len(set(rids)) != len(rids):
            raise ValueError("duplicate request rids: outputs are keyed by rid")
        for req in requests:
            self._validate(req)
        n = self.ecfg.n_slots
        pool = SlotCachePool(self.cfg, n, self.s_max, self.cfg.compute_dtype, self.device)
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
        cur = np.zeros(n, np.int64)
        last_tok = np.zeros(n, np.int64)

        def finish(slot: int, reason: Optional[str] = None) -> None:
            st = active.pop(slot)
            st.reason = reason
            st.t_finish, st.status, st.slot = clock(), FINISHED, -1
            pool.free(slot)
            cur[slot] = last_tok[slot] = 0

        while pending or ready or active:
            now = clock()
            while pending and pending[0].t_arrive <= now:
                ready.append(pending.popleft())
            # one prefill between decode ticks (the reference's default)
            if ready and pool.can_admit():
                st = ready.popleft()
                if self._admit(st, pool, metrics, clock):
                    active[st.slot] = st
                    if st.done:  # max_new_tokens == 1: no decode steps
                        finish(st.slot)
                    else:
                        cur[st.slot], last_tok[st.slot] = st.cur_index, st.tokens[-1]
            if not active:
                if pending and not ready:  # idle until the next arrival
                    time.sleep(max(0.0, min(pending[0].t_arrive - clock(), 0.005)))
                continue

            t0 = time.perf_counter()
            nxt = self._tick(pool.cache, cur, last_tok)
            metrics.decode_time_s += time.perf_counter() - t0
            metrics.decode_ticks += 1
            metrics.occupancy_ticks += len(active)
            metrics.peak_active = max(metrics.peak_active, len(active))
            for slot in [s for s in active if nxt[s] < 0]:
                finish(slot, FINISH_NUMERIC)  # quarantine: token never kept
                metrics.failed += 1
            metrics.decode_tokens += len(active)
            now = clock()
            for slot, st in list(active.items()):
                st.tokens.append(int(nxt[slot]))
                metrics.itl_samples.append(now - st.t_last_token)
                st.t_last_token = now
                if st.done:
                    finish(slot)
                else:
                    cur[slot], last_tok[slot] = st.cur_index, st.tokens[-1]

        metrics.makespan_s = clock()
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
