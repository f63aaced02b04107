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
              p: int, iters: int, variant: str) -> torch.Tensor:
    """GQA attention; q (B, H, S, D), k/v (B, KH, S, D); head h reads KV
    head ``h // (H // KH)``.  Masked logits take the finite ``NEG_INF``;
    the epilogue is ``acc · GS(1 / max(l, 1e-30))`` as in the kernel."""
    b, h, s, d = q.shape
    kh = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qf = q.to(torch.float32).reshape(b, kh, h // kh, s, d)
    logits = torch.einsum("bkgsd,bktd->bkgst", qf, k.to(torch.float32)) * sm_scale
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, common.NEG_INF)
    m = torch.amax(logits, dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    l = torch.sum(e, dim=-1, keepdim=True).clamp_min(1e-30)
    inv = common.recip_positive(l, rom("recip", p, str(q.device)), p=p,
                                iters=iters, variant=variant)
    acc = torch.einsum("bkgst,bktd->bkgsd", e, v.to(torch.float32))
    return (acc * inv).reshape(b, h, s, d).to(q.dtype)
