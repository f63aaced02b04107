"""Goldschmidt reciprocal / divide / rsqrt / sqrt on torch tensors.

Counterpart of ``repro.core.goldschmidt`` (float route).  The arithmetic is
the same, op for op, with every multiply and add kept apart (as the CUDA
kernels keep them); on finite f32 normals the results equal the
reference's bit for bit wherever XLA does not contract a multiply-add into
an FMA, and lie within an ulp where it does (ROADMAP C):

    K1 = ROM[D],  q1 = N·K1,  r1 = D·K1
    K_{i+1} = 2 − r_i,  q_{i+1} = q_i·K_{i+1},  r_{i+1} = r_i·K_{i+1}

and for square roots ([4]'s coupled form)

    y0 = ROM_rsqrt[M],  g0 = M·y0,  h0 = y0/2
    r_i = 1/2 − g_i·h_i,  g_{i+1} = g_i + g_i·r_i,  h_{i+1} = h_i + h_i·r_i

Two variants of one datapath: ``feedback`` (the paper's single multiplier
pair: one ``(q, r)`` register pair updated in place over a runtime trip
count) and ``pipelined`` (one fresh pair per pass, the unrolled form).

Normalize/renormalize is the branch-free IEEE-754 field peel: subnormal
magnitudes are pre-scaled by 2^24 so the peel sees a true mantissa, and the
renormalize splits the exponent into two exact power-of-two factors so
gradual underflow and overflow round once.

Gradients: the bit peel has none, so each public op is a
``torch.autograd.Function`` whose backward is the reference's ``custom_vjp``
rule on the saved forward output q (the converged quotient is treated as
exact):

    d(1/x)     = -q²·ḡ
    d(n/d)     : dn = ḡ·GS(1/d),  dd = -ḡ·q·GS(1/d)   (unbroadcast)
    d(x^-1/2)  = -½·q³·ḡ
    d(sqrt x)  = ½·GS(1/q)·ḡ

where GS(1/·) is one more Goldschmidt reciprocal pass in the backward, so
no hardware divide runs there either.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.core import lut

__all__ = [
    "DEFAULT_P",
    "iters_needed",
    "target_bits_for",
    "precision_policy",
    "resolve_precision",
    "gs_reciprocal",
    "gs_divide",
    "gs_rsqrt",
    "gs_sqrt",
]

DEFAULT_P = 7  # table index bits; p+2 = 9-bit seed
MAX_SEED_P = 9  # widest table the seed-only search may pick

F32_EXP_MASK = 0xFF
F32_MANT_MASK = 0x007FFFFF
F32_ONE_BITS = 0x3F800000
_SUBNORM_SCALE = 2.0**24
_F32_TINY = 2.0**-126
VARIANTS = ("feedback", "pipelined")


def iters_needed(p: int, target_bits: int) -> int:
    """Step-2 passes for ``target_bits`` from the measured ``seed_bits(p)``."""
    bits = lut.seed_bits(p)
    iters = 0
    while bits < target_bits:
        bits *= 2
        iters += 1
    return iters


def _as_dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def target_bits_for(dtype) -> int:
    """Mantissa bits (incl. the implicit one) the output dtype can hold."""
    dtype = _as_dtype(dtype)
    if dtype in (torch.int8, torch.bfloat16):
        return 8
    if dtype == torch.float16:
        return 11
    if dtype == torch.float64:
        return 53
    return 24


def precision_policy(dtype=None, target_bits: int | None = None, *,
                     p: int | None = None,
                     max_seed_p: int = MAX_SEED_P) -> Tuple[int, int]:
    """The ``(p, iters)`` point on the ROM-vs-multiplier curve for a budget.

    fp32/fp64 budgets: ``(7, iters_needed(7, bits))`` = (7, 2) for fp32.
    Lower budgets: the smallest table in ``[7, max_seed_p]`` whose seed alone
    covers the target (bf16 → (8, 0)), else the default table with the
    measured pass count.  A pinned ``p`` derives its matching counter.
    """
    if target_bits is None:
        target_bits = target_bits_for(dtype) if dtype is not None else 24
    if p is not None:
        return p, iters_needed(p, target_bits)
    if target_bits < 24:
        for cand in range(DEFAULT_P, max_seed_p + 1):
            if lut.seed_bits(cand) >= target_bits:
                return cand, 0
    return DEFAULT_P, iters_needed(DEFAULT_P, target_bits)


def resolve_precision(dtype, p: int | None, iters: int | None,
                      target_bits: int | None = None) -> Tuple[int, int]:
    """Concretize one call's ``(p, iters)`` from possibly-None knobs."""
    if p is not None and iters is not None:
        return p, iters
    if target_bits is None:
        target_bits = target_bits_for(dtype)
    if p is None and iters is None:
        return precision_policy(target_bits=target_bits)
    if p is None:
        return DEFAULT_P, iters
    return p, iters_needed(p, target_bits)


@functools.lru_cache(maxsize=None)
def rom(kind: str, p: int, device: str) -> torch.Tensor:
    """The f32 ROM (``"recip"`` or ``"rsqrt"``) for width ``p`` on ``device``."""
    table = lut.reciprocal_table_f32(p) if kind == "recip" else lut.rsqrt_table_f32(p)
    return torch.from_numpy(table.copy()).to(device)


# ---------------------------------------------------------------------------
# bit peel
# ---------------------------------------------------------------------------


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e as f32 for int32 e ∈ [-126, 127]."""
    return ((e + 127) << 23).view(torch.float32)


def _normalize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x = m · 2^e with m ∈ [1, 2) for positive finite f32 x (subnormals too).

    Zeros, infs and nans give in-range garbage the callers overwrite.
    """
    sub = x < _F32_TINY
    scaled = torch.where(sub, x * _SUBNORM_SCALE, x)
    bits = scaled.view(torch.int32)
    e = ((bits >> 23) & F32_EXP_MASK) - 127
    m = ((bits & F32_MANT_MASK) | F32_ONE_BITS).view(torch.float32)
    return m, torch.where(sub, e - 24, e)


def _scale_pow2(q: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """q · 2^e for q ∈ [0.25, 2) and any int32 e, rounding once."""
    e = e.clamp(-152, 130)
    e1 = e.clamp(-124, 125)
    return (q * _pow2(e1)) * _pow2(e - e1)


# ---------------------------------------------------------------------------
# normalized-domain iterations
# ---------------------------------------------------------------------------


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")


def _lookup_reciprocal(m: torch.Tensor, p: int) -> torch.Tensor:
    idx = torch.floor((m - 1.0) * float(2**p)).to(torch.int64).clamp(0, 2**p - 1)
    return rom("recip", p, str(m.device))[idx]


def _lookup_rsqrt(m: torch.Tensor, p: int) -> torch.Tensor:
    idx = torch.floor((m - 1.0) * (2.0**p / 3.0)).to(torch.int64)
    return rom("rsqrt", p, str(m.device))[idx.clamp(0, 2**p - 1)]


def _recip_iterate(q: torch.Tensor, r: torch.Tensor, iters: int,
                   variant: str) -> torch.Tensor:
    """``iters`` step-2 passes: complement block, MULT X, MULT Y."""
    _check_variant(variant)
    if variant == "pipelined":
        for _ in range(iters):
            k = 2.0 - r
            q, r = q * k, r * k
        return q
    q, r = q.clone(), r.clone()  # the feedback register pair
    for _ in range(iters):
        k = 2.0 - r
        q.mul_(k)
        r.mul_(k)
    return q


def _rsqrt_iterate(g: torch.Tensor, h: torch.Tensor, iters: int,
                   variant: str) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_variant(variant)
    if variant == "pipelined":
        for _ in range(iters):
            r = 0.5 - g * h
            g, h = g + g * r, h + h * r
        return g, h
    g, h = g.clone(), h.clone()
    for _ in range(iters):
        r = 0.5 - g * h
        g.add_(g * r)
        h.add_(h * r)
    return g, h


def _rsqrt_seed(x32: torch.Tensor, p: int):
    """Peel x into m ∈ [1, 4) and an even exponent e; return (e, g0, h0)."""
    m, e = _normalize(x32)
    odd = (e % 2) != 0
    m = torch.where(odd, m * 2.0, m)
    e = torch.where(odd, e - 1, e)
    y0 = _lookup_rsqrt(m, p)
    return e, m * y0, 0.5 * y0


# ---------------------------------------------------------------------------
# full-range public ops
# ---------------------------------------------------------------------------


def _sign(x32: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.signbit(x32), -1.0, 1.0).to(torch.float32)


def _reciprocal_impl(d: torch.Tensor, p: int, iters: int,
                     variant: str) -> torch.Tensor:
    d32 = d.to(torch.float32)
    sign = _sign(d32)
    mag = d32.abs()
    m, e = _normalize(mag)
    k1 = _lookup_reciprocal(m, p)
    q = _recip_iterate(k1, m * k1, iters, variant)
    out = sign * _scale_pow2(q, -e)
    out = torch.where(mag == 0.0, sign * float("inf"), out)
    out = torch.where(torch.isinf(mag), sign * 0.0, out)
    out = torch.where(torch.isnan(d32), float("nan"), out)
    return out.to(d.dtype)


def _divide_impl(n: torch.Tensor, d: torch.Tensor, p: int, iters: int,
                 variant: str) -> torch.Tensor:
    """n/d with the numerator folded into q1 (MULT 1)."""
    dtype = torch.result_type(n, d)
    n32, d32 = n.to(torch.float32), d.to(torch.float32)
    sign = torch.where(torch.signbit(n32) ^ torch.signbit(d32), -1.0,
                       1.0).to(torch.float32)
    nmag, dmag = n32.abs(), d32.abs()
    mn, en = _normalize(nmag)
    md, ed = _normalize(dmag)
    k1 = _lookup_reciprocal(md, p)
    q = _recip_iterate(mn * k1, md * k1, iters, variant)
    out = sign * _scale_pow2(q, en - ed)
    inf = float("inf")
    out = torch.where(dmag == 0.0, sign * inf, out)
    out = torch.where(torch.isinf(dmag), sign * 0.0, out)
    out = torch.where((nmag == 0.0) & (dmag != 0.0), sign * 0.0, out)
    bad = (torch.isnan(n32) | torch.isnan(d32)
           | (torch.isinf(nmag) & torch.isinf(dmag))
           | ((nmag == 0.0) & (dmag == 0.0)))
    out = torch.where(bad, float("nan"), out)
    out = torch.where(torch.isinf(nmag) & ~torch.isinf(dmag), sign * inf, out)
    return out.to(dtype)


def _rsqrt_impl(x: torch.Tensor, p: int, iters: int, variant: str) -> torch.Tensor:
    """1/sqrt(x); rsqrt(±0) = ±inf, x < 0 or nan → nan."""
    x32 = x.to(torch.float32)
    e, g, h = _rsqrt_seed(x32, p)
    _, h = _rsqrt_iterate(g, h, iters, variant)
    out = _scale_pow2(2.0 * h, -(e // 2))
    out = torch.where(x32 == 0.0, torch.copysign(torch.full_like(x32, float("inf")), x32), out)
    out = torch.where(torch.isinf(x32), 0.0, out)
    out = torch.where((x32 < 0.0) | torch.isnan(x32), float("nan"), out)
    return out.to(x.dtype)


def _sqrt_impl(x: torch.Tensor, p: int, iters: int, variant: str) -> torch.Tensor:
    """sqrt(x), the g-sequence; sqrt(±0) = ±0, x < 0 → nan."""
    x32 = x.to(torch.float32)
    e, g, h = _rsqrt_seed(x32, p)
    g, _ = _rsqrt_iterate(g, h, iters, variant)
    out = _scale_pow2(g, e // 2)
    out = torch.where(x32 == 0.0, x32, out)
    out = torch.where(torch.isinf(x32), float("inf"), out)
    out = torch.where((x32 < 0.0) | torch.isnan(x32), float("nan"), out)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# VJPs on the saved forward output (the reference's custom_vjp rules)
# ---------------------------------------------------------------------------


def _unbroadcast(g: torch.Tensor, shape, dtype) -> torch.Tensor:
    """Reduce a cotangent back to a (possibly broadcast) operand's shape."""
    if tuple(g.shape) != tuple(shape):
        lead = g.dim() - len(shape)
        if lead:
            g = g.sum(dim=tuple(range(lead)))
        keep = tuple(i for i, (a, b) in enumerate(zip(g.shape, shape)) if a != b)
        if keep:
            g = g.sum(dim=keep, keepdim=True)
    return g.to(dtype)


class _Reciprocal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, d, p, iters, variant):
        q = _reciprocal_impl(d, p, iters, variant)
        ctx.save_for_backward(q)
        return q

    @staticmethod
    def backward(ctx, g):
        (q,) = ctx.saved_tensors
        q32 = q.to(torch.float32)
        return (-(q32 * q32) * g.to(torch.float32)).to(q.dtype), None, None, None


class _Divide(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n, d, p, iters, variant):
        q = _divide_impl(n, d, p, iters, variant)
        ctx.save_for_backward(q, n, d)
        ctx.gs = (p, iters, variant)
        return q

    @staticmethod
    def backward(ctx, g):
        q, n, d = ctx.saved_tensors
        inv_d = _reciprocal_impl(d.to(torch.float32), *ctx.gs)
        g32 = g.to(torch.float32)
        dn = g32 * inv_d
        dd = -g32 * q.to(torch.float32) * inv_d
        return (_unbroadcast(dn, n.shape, n.dtype), _unbroadcast(dd, d.shape, d.dtype),
                None, None, None)


class _Rsqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, p, iters, variant):
        q = _rsqrt_impl(x, p, iters, variant)
        ctx.save_for_backward(q)
        return q

    @staticmethod
    def backward(ctx, g):
        (q,) = ctx.saved_tensors
        q32 = q.to(torch.float32)
        return (-0.5 * q32 * q32 * q32 * g.to(torch.float32)).to(q.dtype), None, None, None


class _Sqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, p, iters, variant):
        q = _sqrt_impl(x, p, iters, variant)
        ctx.save_for_backward(q)
        ctx.gs = (p, iters, variant)
        return q

    @staticmethod
    def backward(ctx, g):
        (q,) = ctx.saved_tensors
        inv = _reciprocal_impl(q.to(torch.float32), *ctx.gs)
        return (0.5 * inv * g.to(torch.float32)).to(q.dtype), None, None, None


def gs_reciprocal(d: torch.Tensor, *, p: int | None = None,
                  iters: int | None = None, variant: str = "feedback",
                  target_bits: int | None = None) -> torch.Tensor:
    """Goldschmidt 1/d, any sign and scale; returns d's dtype.

    ``(p, iters)`` default to the :func:`precision_policy` pair for d's dtype
    (or ``target_bits``): (7, 2) for fp32, seed-only (8, 0) for bf16.
    Differentiable: ``-q²·ḡ`` on the saved quotient.
    """
    p, iters = resolve_precision(d.dtype, p, iters, target_bits)
    return _Reciprocal.apply(d, p, iters, variant)


def gs_divide(n: torch.Tensor, d: torch.Tensor, *, p: int | None = None,
              iters: int | None = None, variant: str = "feedback",
              target_bits: int | None = None) -> torch.Tensor:
    """Goldschmidt n/d (differentiable: one backward pass for 1/d)."""
    p, iters = resolve_precision(torch.result_type(n, d), p, iters, target_bits)
    return _Divide.apply(n, d, p, iters, variant)


def gs_rsqrt(x: torch.Tensor, *, p: int | None = None,
             iters: int | None = None, variant: str = "feedback",
             target_bits: int | None = None) -> torch.Tensor:
    """Goldschmidt 1/sqrt(x) (differentiable: ``-½q³·ḡ``)."""
    p, iters = resolve_precision(x.dtype, p, iters, target_bits)
    return _Rsqrt.apply(x, p, iters, variant)


def gs_sqrt(x: torch.Tensor, *, p: int | None = None,
            iters: int | None = None, variant: str = "feedback",
            target_bits: int | None = None) -> torch.Tensor:
    """Goldschmidt sqrt(x) (differentiable: ``½·GS(1/q)·ḡ``)."""
    p, iters = resolve_precision(x.dtype, p, iters, target_bits)
    return _Sqrt.apply(x, p, iters, variant)
