"""Numeric formats and the int8 KV-cache quantization (counterpart of
``repro.core.formats``).

A :class:`NumericFormat` is a point on the ROM-vs-multiplier curve: a float
dtype with its ``(p, iters)`` pair, or a fixed-point datapath ``(frac_bits,
p, iters, mitchell_iters)``.  Each knows its **certified bits**: the float
ladder's seed bits, or, for fixed point, the max relative quotient error of
the bit-exact datapath (:class:`~repro_torch.core.fixed_point_torch.FixedPointTorch`)
over a dense operand grid, measured and never assumed.  ``format_for("int8")`` is
the quantized serving route's format.

The int8 KV cache uses one static symmetric scale, ``KV_SCALE = 4/127``:
writes quantize through :func:`kv_cast`, reads scale back through
:func:`kv_dequantize`.  The divisions and multiplies by the scale are f32
operations with the scale rounded to f32, as the reference's weak-typed
Python constants are, and the divisor is a device tensor, so the card
divides too (a division by a Python scalar on the card multiplies by its
reciprocal).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import goldschmidt as gs
from repro_torch.core import lut
from repro_torch.core.fixed_point_torch import FixedPointTorch

__all__ = ["NumericFormat", "format_for", "fixed_bits", "fixed_iters_needed",
           "fixed_precision_policy", "KV_AMAX", "KV_SCALE", "kv_quantize",
           "kv_cast", "kv_dequantize"]

DEFAULT_FRAC_BITS = 24
INT8_TARGET_BITS = 8  # an int8 tensor carries at most 8 significant bits


# ---------------------------------------------------------------------------
# measured accuracy of fixed-point (p, frac_bits, iters, mitchell) points
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _grid() -> Tuple[np.ndarray, np.ndarray]:
    # dense, endpoint-heavy operand grid over the mantissa domain [1, 2):
    # the ROM bucket edges are the worst cases
    d = np.linspace(1.0, 2.0, 513, endpoint=False)
    d = np.concatenate([d, np.minimum(d + 2.0 ** -16, 2.0 - 2.0 ** -30)])
    n = np.linspace(1.0, 2.0, 17, endpoint=False)
    nn, dd = np.meshgrid(n, d)
    return nn.ravel(), dd.ravel()


@functools.lru_cache(maxsize=None)
def fixed_bits(p: int, frac_bits: int, iters: int, mitchell_iters: int = 0) -> int:
    """Certified good bits of a fixed-point divide: the max relative
    quotient error of the datapath over the grid, floored to bits.  The
    operands enter the registers rounded to nearest."""
    dp = FixedPointTorch(p=p, frac_bits=frac_bits, mitchell_iters=mitchell_iters)
    n, d = _grid()
    n_reg, d_reg = (torch.from_numpy(np.rint(v * 2.0**frac_bits).astype(np.int64))
                    for v in (n, d))
    q, _ = dp.divide_pipelined(n_reg, d_reg, iters)
    exact = n / d
    rel = np.max(np.abs(q.numpy() * 2.0**-frac_bits - exact) / exact)
    if rel <= 0:
        return frac_bits
    return min(int(np.floor(-np.log2(rel))), frac_bits)


@functools.lru_cache(maxsize=None)
def fixed_iters_needed(p: int, frac_bits: int, target_bits: int,
                       mitchell_iters: int = 0) -> int:
    """Fewest passes that certify ``target_bits``, or the pass count where
    accuracy saturates once the Mitchell passes are behind."""
    prev = -1
    for it in range(0, 7):
        b = fixed_bits(p, frac_bits, it, mitchell_iters)
        if b >= target_bits:
            return it
        if b <= prev and it > mitchell_iters:
            return it - 1
        prev = b
    return 6


@functools.lru_cache(maxsize=None)
def fixed_precision_policy(frac_bits: int, target_bits: int,
                           mitchell_iters: int = 0,
                           max_seed_p: int = 9) -> Tuple[int, int]:
    """(p, iters) for a fixed datapath: the smallest table whose seed alone
    certifies the target, else the default table with the passes needed."""
    for cand in range(gs.DEFAULT_P, max_seed_p + 1):
        if cand + 2 > frac_bits:
            break
        if fixed_bits(cand, frac_bits, 0, mitchell_iters) >= target_bits:
            return cand, 0
    return gs.DEFAULT_P, fixed_iters_needed(gs.DEFAULT_P, frac_bits, target_bits,
                                            mitchell_iters)


# ---------------------------------------------------------------------------
# the format abstraction
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NumericFormat:
    """kind="float": ``dtype`` names a float type and (p, iters) come from
    its precision policy.  kind="fixed": a ``(frac_bits, p, iters,
    mitchell_iters)`` datapath certified by :func:`fixed_bits`."""

    kind: str  # "float" | "fixed"
    dtype: Optional[str] = None
    frac_bits: Optional[int] = None
    p: Optional[int] = None
    iters: Optional[int] = None
    mitchell_iters: int = 0

    def __post_init__(self):
        if self.kind not in ("float", "fixed"):
            raise ValueError(f"unknown format kind {self.kind!r}")
        if self.kind == "fixed" and self.frac_bits is None:
            raise ValueError("fixed formats need frac_bits")

    @classmethod
    def from_dtype(cls, dtype) -> "NumericFormat":
        name = dtype if isinstance(dtype, str) else str(dtype).split(".")[-1]
        p, iters = gs.precision_policy(name)
        return cls(kind="float", dtype=name, p=p, iters=iters)

    @classmethod
    def fixed(cls, frac_bits: int = DEFAULT_FRAC_BITS, *, p: Optional[int] = None,
              iters: Optional[int] = None, mitchell_iters: int = 0,
              target_bits: int = INT8_TARGET_BITS) -> "NumericFormat":
        if p is None or iters is None:
            fp, _ = fixed_precision_policy(frac_bits, target_bits, mitchell_iters)
            p = fp if p is None else p
            if iters is None:
                iters = fixed_iters_needed(p, frac_bits, target_bits, mitchell_iters)
        return cls(kind="fixed", frac_bits=frac_bits, p=p, iters=iters,
                   mitchell_iters=mitchell_iters)

    def certified_bits(self) -> int:
        if self.kind == "float":
            return min(gs.target_bits_for(self.dtype),
                       lut.seed_bits(self.p) * (2 ** self.iters))
        return fixed_bits(self.p, self.frac_bits, self.iters, self.mitchell_iters)

    def error_bound(self) -> float:
        """Max relative error this format is certified for."""
        return 2.0 ** -self.certified_bits()

    def precision(self) -> dict:
        """The kernel-facing knobs."""
        out = {"p": self.p, "iters": self.iters}
        if self.kind == "fixed":
            out.update(frac_bits=self.frac_bits, mitchell_iters=self.mitchell_iters)
        return out


def format_for(name) -> NumericFormat:
    """Format from a dtype name; ``"int8"`` is the fixed-point route."""
    if str(name) in ("int8", "i1", "torch.int8"):
        return NumericFormat.fixed(DEFAULT_FRAC_BITS, target_bits=INT8_TARGET_BITS)
    return NumericFormat.from_dtype(name)


# ---------------------------------------------------------------------------
# int8 KV-cache quantization (static symmetric scale)
# ---------------------------------------------------------------------------

KV_AMAX = 4.0
KV_SCALE = KV_AMAX / 127.0
_KV_SCALE_F32 = float(np.float32(KV_SCALE))


def kv_quantize(x: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / KV_SCALE), ±127)`` as int8; round half to even."""
    scale = torch.full((), _KV_SCALE_F32, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x.to(torch.float32) / scale),
                       -127.0, 127.0).to(torch.int8)


def kv_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Write-side cast into a cache leaf: quantize iff the leaf is int8."""
    if dtype == torch.int8 and x.is_floating_point():
        return kv_quantize(x)
    return x.to(dtype)


def kv_dequantize(x: torch.Tensor) -> torch.Tensor:
    """Read-side: int8 KV back to f32 (float caches just cast)."""
    if x.dtype == torch.int8:
        return x.to(torch.float32) * _KV_SCALE_F32
    return x.to(torch.float32)
