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

import torch

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
