"""ROM reciprocal / rsqrt-seed tables (numpy; counterpart of ``repro.core.lut``).

A ``p``-bit-indexed table returns a ``(p+2)``-bit seed: entry ``i`` is the
(p+2)-bit rounding of the reciprocal (resp. reciprocal square root) of the
bucket midpoint, the Sarma–Matula "optimal" construction.  The reciprocal
table covers ``D ∈ [1, 2)`` in 2^p buckets of width 2^-p; the rsqrt table
covers ``M ∈ [1, 4)`` in 2^p buckets of width 3·2^-p.

The values are byte-equal to the reference tables for every ``p``; the
kernels receive the float view as a tensor, so ``p`` is a runtime argument.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "reciprocal_table_int",
    "reciprocal_table_f32",
    "rsqrt_table_int",
    "rsqrt_table_f32",
    "seed_rel_error_bound",
    "seed_rel_error_bound_rsqrt",
    "seed_bits",
]


def _check_p(p: int) -> None:
    if not (2 <= p <= 16):
        raise ValueError(f"table index width p={p} out of supported range [2, 16]")


@functools.lru_cache(maxsize=None)
def reciprocal_table_int(p: int) -> np.ndarray:
    """(p+2)-bit optimal reciprocal ROM; entries in ``[2^(p+1), 2^(p+2)]``."""
    _check_p(p)
    i = np.arange(2**p, dtype=np.float64)
    d_lo = 1.0 + i * 2.0**-p
    d_hi = 1.0 + (i + 1.0) * 2.0**-p
    k = np.rint(2.0 / (d_lo + d_hi) * 2.0 ** (p + 2)).astype(np.uint32)
    return np.clip(k, 2 ** (p + 1), 2 ** (p + 2)).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def reciprocal_table_f32(p: int) -> np.ndarray:
    """Float view of the ROM: entries are exactly ``k * 2^-(p+2)``."""
    return (reciprocal_table_int(p).astype(np.float64) * 2.0 ** -(p + 2)).astype(
        np.float32
    )


@functools.lru_cache(maxsize=None)
def rsqrt_table_int(p: int) -> np.ndarray:
    """(p+2)-bit rsqrt seed ROM over ``M ∈ [1, 4)``; geometric-mean midpoint."""
    _check_p(p)
    i = np.arange(2**p, dtype=np.float64)
    width = 3.0 * 2.0**-p
    m_lo = 1.0 + i * width
    m_hi = 1.0 + (i + 1.0) * width
    mid_rsqrt = 1.0 / np.sqrt(np.sqrt(m_lo * m_hi))
    k = np.rint(mid_rsqrt * 2.0 ** (p + 2)).astype(np.uint32)
    return np.clip(k, 2 ** (p + 1), 2 ** (p + 2)).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def rsqrt_table_f32(p: int) -> np.ndarray:
    return (rsqrt_table_int(p).astype(np.float64) * 2.0 ** -(p + 2)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def seed_rel_error_bound(p: int) -> float:
    """Measured max relative error of the reciprocal ROM (bucket endpoints)."""
    tab = reciprocal_table_int(p).astype(np.float64) * 2.0 ** -(p + 2)
    i = np.arange(2**p, dtype=np.float64)
    errs = [np.max(np.abs(tab * d - 1.0))
            for d in (1.0 + i * 2.0**-p, 1.0 + (i + 1) * 2.0**-p - 2.0**-53)]
    return float(max(errs))


@functools.lru_cache(maxsize=None)
def seed_rel_error_bound_rsqrt(p: int) -> float:
    """Measured max relative error of the rsqrt seed ROM over M ∈ [1, 4)."""
    tab = rsqrt_table_int(p).astype(np.float64) * 2.0 ** -(p + 2)
    i = np.arange(2**p, dtype=np.float64)
    width = 3.0 * 2.0**-p
    errs = [np.max(np.abs(tab * np.sqrt(m) - 1.0))
            for m in (1.0 + i * width, 1.0 + (i + 1) * width - 2.0**-50)]
    return float(max(errs))


@functools.lru_cache(maxsize=None)
def seed_bits(p: int) -> int:
    """Guaranteed good bits of the p-bit seed across both ROMs (measured)."""
    err = max(seed_rel_error_bound(p), seed_rel_error_bound_rsqrt(p))
    return int(np.floor(-np.log2(err)))
