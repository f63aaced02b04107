"""Request lifecycle and result types (copy of ``repro.serving.requests``,
without the reference's deprecated shims and the fields of features not
ported yet).

A :class:`Request` is what a client submits: prompt tokens, a generation
budget and a frozen :class:`SamplingParams`.  The engine wraps it in a
:class:`RequestState` and hands back a :class:`GenerationResult`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

QUEUED = "queued"      # admitted, waiting for a free slot
RUNNING = "running"    # prefilled into a slot, decoding
FINISHED = "finished"  # generation budget exhausted, slot freed

FINISH_LENGTH = "length"          # max_new_tokens exhausted
FINISH_STOP = "stop"              # sampled the stop token
FINISH_NUMERIC = "numeric_error"  # NaN/Inf logits: slot quarantined


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling policy.  ``temperature == 0`` is greedy, the
    only mode this port serves yet (stochastic sampling: ROADMAP A10).
    ``stop`` ends generation early when that token is sampled (it is kept
    in the output)."""

    temperature: float = 0.0
    top_k: int = 0
    stop: Optional[int] = None

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")

    @property
    def stochastic(self) -> bool:
        return self.temperature > 0


@dataclasses.dataclass
class Request:
    """One generation request; ``arrival_time`` is seconds from trace start
    (the engine admits it once its clock passes that)."""

    rid: int
    prompt: np.ndarray  # (s,) int32 token ids
    max_new_tokens: int
    arrival_time: float = 0.0
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens must be >= 1")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


@dataclasses.dataclass
class RequestState:
    """Engine-side view of one in-flight request; ``reason`` overrides the
    derived ``finish_reason`` on the quarantine path."""

    request: Request
    status: str = QUEUED
    slot: int = -1
    tokens: List[int] = dataclasses.field(default_factory=list)
    t_arrive: float = 0.0       # engine-clock seconds
    t_first_token: float = 0.0
    t_last_token: float = 0.0
    t_finish: float = 0.0
    reason: Optional[str] = None

    @property
    def cur_index(self) -> int:
        """Next cache write position (the last sampled token is not fed yet)."""
        return self.request.prompt_len + len(self.tokens) - 1

    @property
    def done(self) -> bool:
        if len(self.tokens) >= self.request.max_new_tokens:
            return True
        stop = self.request.sampling.stop
        return stop is not None and bool(self.tokens) and self.tokens[-1] == stop

    @property
    def finish_reason(self) -> str:
        if self.reason is not None:
            return self.reason
        stop = self.request.sampling.stop
        if stop is not None and self.tokens and self.tokens[-1] == stop:
            return FINISH_STOP
        return FINISH_LENGTH

    @property
    def ttft(self) -> float:
        return self.t_first_token - self.t_arrive


@dataclasses.dataclass
class GenerationResult:
    """What the engine (and ``generate_sequential``) hands back per request."""

    rid: int
    prompt_len: int
    tokens: np.ndarray  # (<= max_new_tokens,) int32, first from prefill
    ttft_s: float
    finish_s: float  # arrival -> last token, engine-clock seconds
    finish_reason: str = FINISH_LENGTH
