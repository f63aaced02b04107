"""Plain PyTorch versions of the kernels' device helpers.

Counterpart of ``repro.kernels.common``.  Each function here has a
``__device__ __forceinline__`` twin of the same name in
``csrc/gs_common.cuh``, with the same operation order (the CUDA side keeps
every multiply and add unfused with ``__fmul_rn``/``__fadd_rn``):

* ``split_fields`` / ``mantissa_to_m`` — the IEEE-754 field peel;
* ``pow2_from_biased`` — 2^(e-127) for a biased exponent clamped to
  [0, 254]; biased 0 gives +0 (flush at the range edge);
* ``gs_recip_core`` / ``gs_rsqrt_core`` — ROM seed plus the step-2 passes;
* ``recip_positive`` / ``rsqrt_positive`` / ``sqrt_positive`` — the
  epilogue forms for strictly positive normal inputs, as the fused kernels
  use them.

The ROM read, a one-hot × table matmul on the TPU, is an indexed load here
(``table[idx]``); on the card it is a load from the block's shared-memory
copy of the table.

The fixed-point helpers of the int8 kernels (``csrc/gs_fixed_common.cuh``)
have their twins in :mod:`repro_torch.core.fixed_point_torch`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.goldschmidt import (F32_EXP_MASK, F32_MANT_MASK,
                                          F32_ONE_BITS, _recip_iterate,
                                          _rsqrt_iterate)

NEG_INF = -1e30  # the kernels' finite mask value


def split_fields(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """IEEE-754 field peel: (sign_bits, biased_exp, mantissa_bits), int32."""
    bits = x.to(torch.float32).view(torch.int32)
    sign = bits & -(2**31)
    e = (bits >> 23) & F32_EXP_MASK
    return sign, e, bits & F32_MANT_MASK


def mantissa_to_m(mant: torch.Tensor) -> torch.Tensor:
    """Mantissa bits → m ∈ [1, 2)."""
    return (mant | F32_ONE_BITS).view(torch.float32)


def pow2_from_biased(e_biased: torch.Tensor) -> torch.Tensor:
    """2^(e_biased - 127) as f32 for e_biased clamped to [0, 254]."""
    return (e_biased.clamp(0, 254).to(torch.int32) << 23).view(torch.float32)


def gs_recip_core(m: torch.Tensor, table: torch.Tensor, mant: torch.Tensor, *,
                  p: int, iters: int, variant: str) -> torch.Tensor:
    """Goldschmidt reciprocal of m ∈ [1, 2) given its mantissa bits."""
    k1 = table[(mant >> (23 - p)).to(torch.int64)]
    return _recip_iterate(k1, m * k1, iters, variant)


def gs_rsqrt_core(m: torch.Tensor, table: torch.Tensor, *, p: int, iters: int,
                  variant: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(g, h) with g → sqrt(m), 2h → 1/sqrt(m), for m ∈ [1, 4)."""
    idx = torch.floor((m - 1.0) * ((1 << p) / 3.0)).to(torch.int64)
    y0 = table[idx.clamp(0, (1 << p) - 1)]
    return _rsqrt_iterate(m * y0, 0.5 * y0, iters, variant)


def recip_positive(x: torch.Tensor, table: torch.Tensor, *, p: int, iters: int,
                   variant: str) -> torch.Tensor:
    """1/x for strictly positive normal f32 x (no specials)."""
    _, e, mant = split_fields(x)
    q = gs_recip_core(mantissa_to_m(mant), table, mant, p=p, iters=iters,
                      variant=variant)
    return q * pow2_from_biased(254 - e)


def _rsqrt_fold(x: torch.Tensor):
    """x = m · 2^(2·half_e) with m ∈ [1, 4): an odd exponent folds into m."""
    _, e, mant = split_fields(x)
    m = mantissa_to_m(mant)
    E = e - 127
    odd = (E & 1) != 0
    return torch.where(odd, m * 2.0, m), torch.where(odd, E - 1, E) >> 1


def rsqrt_positive(x: torch.Tensor, table: torch.Tensor, *, p: int, iters: int,
                   variant: str) -> torch.Tensor:
    """1/sqrt(x) for strictly positive normal f32 x."""
    m, half_e = _rsqrt_fold(x)
    _, h = gs_rsqrt_core(m, table, p=p, iters=iters, variant=variant)
    return (2.0 * h) * pow2_from_biased(127 - half_e)


def sqrt_positive(x: torch.Tensor, table: torch.Tensor, *, p: int, iters: int,
                  variant: str) -> torch.Tensor:
    """sqrt(x) for strictly positive normal f32 x: the g-sequence."""
    m, half_e = _rsqrt_fold(x)
    g, _ = gs_rsqrt_core(m, table, p=p, iters=iters, variant=variant)
    return g * pow2_from_biased(127 + half_e)
