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
by the config to its compute dtype) or else the operand dtype.

``fmt`` carries a :class:`~repro_torch.core.formats.NumericFormat`; with a
fixed-point format (``ArchConfig.quant="int8"``) the four primitives run
the integer datapath of :mod:`repro_torch.core.fixed_point_torch` instead of
the float Goldschmidt ops, so every division site of the int8 serving path
runs through the narrow hardware the paper builds.  That route is a
serving datapath and carries no VJP.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import fixed_point_torch as fpt
from repro_torch.core import goldschmidt as gs
from repro_torch.core.formats import NumericFormat

__all__ = ["NumericsPolicy", "EXACT", "GS_FEEDBACK", "GS_PIPELINED"]

_MODES = ("exact", "gs_pipelined", "gs_feedback")


@dataclasses.dataclass(frozen=True)
class NumericsPolicy:
    mode: str = "gs_feedback"
    p_bits: Optional[int] = None
    iters: Optional[int] = None
    target_bits: Optional[int] = None
    fmt: Optional[NumericFormat] = None  # None -> float route; fixed -> integer

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {self.mode!r}")

    @property
    def variant(self) -> str:
        return "pipelined" if self.mode == "gs_pipelined" else "feedback"

    @property
    def is_fixed(self) -> bool:
        """True when the Goldschmidt ops run the fixed-point datapath."""
        return (self.fmt is not None and self.fmt.kind == "fixed"
                and self.mode != "exact")

    def _gs_kw(self) -> dict:
        return {"p": self.p_bits, "iters": self.iters, "variant": self.variant,
                "target_bits": self.target_bits}

    def _fixed_kw(self) -> dict:
        return {"frac_bits": self.fmt.frac_bits, "p": self.fmt.p,
                "iters": self.fmt.iters}

    def reciprocal(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "exact":
            return 1.0 / x
        if self.is_fixed:
            return fpt.recip_f32(x, variant=self.variant,
                                 mitchell_iters=self.fmt.mitchell_iters,
                                 **self._fixed_kw())
        return gs.gs_reciprocal(x, **self._gs_kw())

    def divide(self, n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        if self.mode == "exact":
            return n / d
        if self.is_fixed:
            return fpt.divide_f32(n, d, variant=self.variant,
                                  mitchell_iters=self.fmt.mitchell_iters,
                                  **self._fixed_kw())
        return gs.gs_divide(n, d, **self._gs_kw())

    def rsqrt(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "exact":
            return torch.rsqrt(x)
        if self.is_fixed:
            return fpt.rsqrt_f32(x, **self._fixed_kw())
        return gs.gs_rsqrt(x, **self._gs_kw())

    def sqrt(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "exact":
            return torch.sqrt(x)
        if self.is_fixed:
            return fpt.sqrt_f32(x, **self._fixed_kw())
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
