"""NumericsPolicy, float route (counterpart of ``repro.core.policy``).

Every division-shaped operation of the model stack (softmax denominators,
RMSNorm rsqrt, the attention epilogue, the sampler) goes through a policy:

* ``exact``        — torch's ``/`` and ``torch.rsqrt`` (baseline),
* ``gs_pipelined`` — unrolled Goldschmidt,
* ``gs_feedback``  — the paper's multiplier-reuse datapath.

The Goldschmidt ops carry the reference's VJPs
(:mod:`repro_torch.core.goldschmidt`), so clipping and the softmax
differentiate through them.

``p_bits``/``iters`` left ``None`` derive per call from ``target_bits`` (set
by the config to its compute dtype) or else the operand dtype.  The
reference's fixed-point route (its ``fmt`` field, ``quant="int8"``) is not
ported yet: ``ArchConfig.policy`` raises ``NotImplementedError`` for it
(ROADMAP A9).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import goldschmidt as gs

__all__ = ["NumericsPolicy", "EXACT", "GS_FEEDBACK", "GS_PIPELINED"]

_MODES = ("exact", "gs_pipelined", "gs_feedback")


@dataclasses.dataclass(frozen=True)
class NumericsPolicy:
    mode: str = "gs_feedback"
    p_bits: Optional[int] = None
    iters: Optional[int] = None
    target_bits: Optional[int] = None

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {self.mode!r}")

    @property
    def variant(self) -> str:
        return "pipelined" if self.mode == "gs_pipelined" else "feedback"

    def _gs_kw(self) -> dict:
        return {"p": self.p_bits, "iters": self.iters, "variant": self.variant,
                "target_bits": self.target_bits}

    def reciprocal(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "exact":
            return 1.0 / x
        return gs.gs_reciprocal(x, **self._gs_kw())

    def divide(self, n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        if self.mode == "exact":
            return n / d
        return gs.gs_divide(n, d, **self._gs_kw())

    def rsqrt(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "exact":
            return torch.rsqrt(x)
        return gs.gs_rsqrt(x, **self._gs_kw())

    def sqrt(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "exact":
            return torch.sqrt(x)
        return gs.gs_sqrt(x, **self._gs_kw())

    def kernel_precision(self, dtype) -> dict:
        """``p``/``iters`` for a fused kernel call site.

        When the policy's ``target_bits`` differs from the operand dtype's
        budget the pair is resolved here and pinned, so the kernel agrees
        with the tensor-op path; otherwise both stay ``None`` and the kernel
        front-end derives them from the operand dtype.
        """
        if (self.target_bits is not None
                and self.target_bits != gs.target_bits_for(dtype)):
            p, iters = gs.resolve_precision(
                dtype, self.p_bits, self.iters, self.target_bits)
            return {"p": p, "iters": iters}
        return {"p": self.p_bits, "iters": self.iters}

    def softmax(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Numerically stable softmax with a Goldschmidt denominator; the
        max is held constant under differentiation, as in the reference."""
        m = torch.amax(x, dim=dim, keepdim=True).detach()
        e = torch.exp(x - m)
        s = torch.sum(e, dim=dim, keepdim=True)
        return e * self.reciprocal(s)


EXACT = NumericsPolicy(mode="exact")
GS_FEEDBACK = NumericsPolicy(mode="gs_feedback")
GS_PIPELINED = NumericsPolicy(mode="gs_pipelined")
