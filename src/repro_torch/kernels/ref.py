"""Plain PyTorch versions of the CUDA kernels (counterpart of
``repro.kernels.ref``).

Each function computes what its kernel computes, with the kernel's
Goldschmidt arithmetic (:mod:`repro_torch.kernels.common`).  The front-end
(:mod:`repro_torch.kernels.ops`) runs them for tensors on the CPU, the
tests hold them against the JAX package, and ``chip_smoke.py`` holds each
kernel against them on the card.  They are references, not fallbacks: a
CUDA tensor never reaches them through the front-end.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.fixed_point_torch import (FixedPointTorch, _mant_to_reg, _peel,
                                               _reg_to_f32, msb32, rom_words)
from repro_torch.core.goldschmidt import rom
from repro_torch.kernels import common


def rmsnorm(x: torch.Tensor, gain: torch.Tensor, *, eps: float, p: int,
            iters: int, variant: str, save_inv: bool = False):
    """``x · rsqrt(mean(x²) + eps) · gain`` over the last axis.

    fp32 statistics; the mean is a multiply by ``1/d``.  Returns x's dtype,
    plus the ``(rows, 1)`` f32 rsqrt column when ``save_inv``.
    """
    d = x.shape[-1]
    x32 = x.to(torch.float32)
    ms = torch.sum(x32 * x32, dim=-1, keepdim=True) * (1.0 / d)
    inv = common.rsqrt_positive(ms + eps, rom("rsqrt", p, str(x.device)),
                                p=p, iters=iters, variant=variant)
    out = (x32 * inv * gain.to(torch.float32)).to(x.dtype)
    return (out, inv.reshape(-1, 1)) if save_inv else out


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, sm_scale: Optional[float] = None,
              p: int, iters: int, variant: str, residuals: bool = False):
    """GQA attention; q (B, H, S, D), k/v (B, KH, S, D); head h reads KV
    head ``h // (H // KH)``.  Masked logits take the finite ``NEG_INF``;
    the epilogue is ``acc · GS(1 / max(l, 1e-30))`` as in the kernel.  With
    ``residuals`` also returns the (B, H, S) f32 row max ``m`` and the
    unguarded row sum ``l`` of ``exp(s - m)``."""
    b, h, s, d = q.shape
    kh = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qf = q.to(torch.float32).reshape(b, kh, h // kh, s, d)
    logits = _masked_logits(qf, k.to(torch.float32), sm_scale, causal)
    m = torch.amax(logits, dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    l = torch.sum(e, dim=-1, keepdim=True)
    inv = common.recip_positive(l.clamp_min(1e-30), rom("recip", p, str(q.device)),
                                p=p, iters=iters, variant=variant)
    acc = torch.einsum("bkgst,bktd->bkgsd", e, v.to(torch.float32))
    out = (acc * inv).reshape(b, h, s, d).to(q.dtype)
    if not residuals:
        return out
    return out, m.reshape(b, h, s), l.reshape(b, h, s)


def _masked_logits(qf: torch.Tensor, kf: torch.Tensor, sm_scale: float,
                   causal: bool) -> torch.Tensor:
    """``sm_scale · q kᵀ`` per GQA group, (b, kh, g, s, s); masked entries
    take ``NEG_INF``."""
    logits = torch.einsum("bkgsd,bktd->bkgst", qf, kf) * sm_scale
    if causal:
        s = qf.shape[-2]
        keep = torch.ones(s, s, dtype=torch.bool, device=qf.device).tril()
        logits = logits.masked_fill(~keep, common.NEG_INF)
    return logits


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, out: torch.Tensor, m: torch.Tensor,
                  l: torch.Tensor, *, causal: bool = True,
                  sm_scale: Optional[float] = None, p: int, iters: int,
                  variant: str):
    """(dq, dk, dv) of :func:`attention` from its output and residuals,
    written out as the kernels compute it:

        p_ij = exp(s_ij - m_i) · GS(1 / max(l_i, 1e-30))
        ds_ij = p_ij · (do_i·v_j - Δ_i) · sm_scale,  Δ_i = do_i·out_i
        dq = ds k,  dv = Σ_group pᵀ do,  dk = Σ_group dsᵀ q

    dq in q's dtype; dk, dv summed over each GQA group in f32, then cast."""
    b, h, s, d = q.shape
    kh = k.shape[1]
    g = h // kh
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qf = q.to(torch.float32).reshape(b, kh, g, s, d)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    dof = do.to(q.dtype).to(torch.float32).reshape(b, kh, g, s, d)
    delta = torch.sum(dof * out.to(torch.float32).reshape(b, kh, g, s, d), dim=-1)
    inv = common.recip_positive(l.clamp_min(1e-30), rom("recip", p, str(q.device)),
                                p=p, iters=iters, variant=variant)
    logits = _masked_logits(qf, kf, sm_scale, causal)
    pt = torch.exp(logits - m.reshape(b, kh, g, s, 1)) * inv.reshape(b, kh, g, s, 1)
    dp = torch.einsum("bkgsd,bktd->bkgst", dof, vf)
    ds = pt * (dp - delta[..., None]) * sm_scale
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, kf).reshape(b, h, s, d).to(q.dtype)
    dv = torch.einsum("bkgst,bkgsd->bktd", pt, dof).to(v.dtype)
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, qf).to(k.dtype)
    return dq, dk, dv


def adam_update(param: torch.Tensor, grad: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, bc: torch.Tensor, *, beta1: float, beta2: float,
                eps: float, weight_decay: float, p: int, iters: int, variant: str):
    """One AdamW step on one leaf, step by step as the kernel computes it;
    ``bc`` is the (3,) f32 ``(bc1, bc2, lr)`` operand.  Returns (param in its
    dtype, m, v in f32)."""
    bc1, bc2, lr = bc[0], bc[1], bc[2]
    g32, w = grad.to(torch.float32), param.to(torch.float32)
    m_new = beta1 * m + (1.0 - beta1) * g32
    v_new = beta2 * v + (1.0 - beta2) * g32 * g32
    v_hat = torch.clamp_min(v_new * bc2, 1e-38)
    s = common.sqrt_positive(v_hat, rom("rsqrt", p, str(param.device)), p=p,
                             iters=iters, variant=variant)
    inv = common.recip_positive(s + eps, rom("recip", p, str(param.device)), p=p,
                                iters=iters, variant=variant)
    update = (m_new * bc1) * inv
    p_new = w - lr * (update + weight_decay * w)
    return p_new.to(param.dtype), m_new, v_new


# -- the fixed-point kernels over int8 operands ---------------------------------


def _scale(scale, device) -> torch.Tensor:
    return torch.as_tensor(scale, dtype=torch.float32, device=device).reshape(())


def fixed_recip(x: torch.Tensor, scale, *, p: int, frac_bits: int, iters: int,
                variant: str, mitchell_iters: int) -> torch.Tensor:
    """``1/(x·scale)`` for int8 ``x``, elementwise, f32: ``|x|`` ∈ [1, 127]
    normalized by ``msb32``, the fixed divide with n = 1, then
    ``(q · 2^-e) · (1/scale)``; the sign restored, ``x == 0`` gives +inf."""
    xi = x.to(torch.int64)
    a = xi.abs().clamp_min(1)
    e = msb32(a)
    one = 1 << frac_bits
    m_reg = a << (frac_bits - e)
    idx = ((m_reg - one) >> (frac_bits - p)).clamp(0, (1 << p) - 1)
    dp = FixedPointTorch(p=p, frac_bits=frac_bits, mitchell_iters=mitchell_iters)
    q, _ = dp.divide(torch.full_like(m_reg, one), m_reg, iters, variant,
                     k1=rom_words("recip", p, frac_bits, str(x.device))[idx])
    inv_scale = 1.0 / _scale(scale, x.device)
    mag = _reg_to_f32(q, frac_bits) * common.pow2_from_biased(127 - e) * inv_scale
    out = torch.where(xi < 0, -mag, mag)
    return torch.where(xi == 0, torch.full_like(out, float("inf")), out)


def fixed_softmax(x: torch.Tensor, scale, *, p: int, frac_bits: int, iters: int,
                  variant: str, mitchell_iters: int) -> torch.Tensor:
    """``softmax(x·scale)`` over the last axis of int8 ``x``, f32: f32 max,
    exp and sum; the sum's mantissa peeled into a register, its fixed
    reciprocal scales the row."""
    v = x.to(torch.float32) * _scale(scale, x.device)
    e = torch.exp(v - torch.amax(v, dim=-1, keepdim=True))
    s = torch.sum(e, dim=-1, keepdim=True)  # ∈ [1, d]: a positive normal
    eb, mant, _ = _peel(s)
    idx = ((mant & 0x7FFFFF) >> (23 - p)).clamp(0, (1 << p) - 1)
    dp = FixedPointTorch(p=p, frac_bits=frac_bits, mitchell_iters=mitchell_iters)
    q, _ = dp.divide(torch.full_like(mant, 1 << frac_bits), _mant_to_reg(mant, frac_bits),
                     iters, variant, k1=rom_words("recip", p, frac_bits, str(x.device))[idx])
    return e * (_reg_to_f32(q, frac_bits) * common.pow2_from_biased(254 - eb))


def fixed_rmsnorm(x: torch.Tensor, scale, gain: torch.Tensor, *, eps: float, p: int,
                  frac_bits: int, iters: int) -> torch.Tensor:
    """RMSNorm of ``x·scale`` over the last axis of int8 ``x``, times
    ``gain``, f32.  The sum of squares is exact in integers; then, in f32,
    ``ms = ss·scale²·(1/d) + eps``, the fixed ``rsqrt_reg`` seeded from the
    rsqrt ROM at ``t // 3``, and ``((x·scale)·inv)·gain``."""
    d = x.shape[-1]
    xi = x.to(torch.int64)
    sc = _scale(scale, x.device)
    ss = torch.sum(xi * xi, dim=-1, keepdim=True).to(torch.float32)
    ms = ss * (sc * sc) * np.float32(1.0 / d) + np.float32(eps)
    eb, mant, _ = _peel(ms)
    ebits = eb - 127
    half_e = ebits >> 1
    m_reg = _mant_to_reg(mant, frac_bits) << (ebits - 2 * half_e)
    t = (m_reg - (1 << frac_bits)) >> (frac_bits - p)
    idx = (t // 3).clamp(0, (1 << p) - 1)
    h2 = FixedPointTorch(p=p, frac_bits=frac_bits).rsqrt_reg(
        m_reg, iters, y0=rom_words("rsqrt", p, frac_bits, str(x.device))[idx])
    inv = _reg_to_f32(h2, frac_bits) * common.pow2_from_biased(127 - half_e)
    return x.to(torch.float32) * sc * inv * gain.to(torch.float32)
