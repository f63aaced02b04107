"""Flash-attention backward with a Goldschmidt recompute of 1/l: the CUDA
kernels' wrapper.

Replaces the backward of ``repro.kernels.flash_attention`` (the two
``pallas_call``s of ``_bwd_call``): ``csrc/flash_attention_bwd.cu`` holds
the dq kernel and the dk/dv kernel; their plain PyTorch version is
:func:`repro_torch.kernels.ref.attention_bwd`.  As in the reference, three
steps stay torch ops around the kernels: ``delta = Σ do·out`` (f32), the
GQA group-sum of the per-q-head dk/dv, and the casts.  ``launches_dq`` and
``launches_dkv`` count the launches of each kernel.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core.goldschmidt import rom
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import check_operands

launches_dq = 0
launches_dkv = 0


def _common_args(q, k, v, do, m, l, delta, table):
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), m.data_ptr(),
            l.data_ptr(), delta.data_ptr(), table.data_ptr())


def _tail(q, k, sm_scale, causal, p, iters, variant):
    b, h, s, d = q.shape
    return (b, h, k.shape[1], s, d, sm_scale, int(causal), p, iters,
            int(variant == "pipelined"), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)


def _check_stats(q: torch.Tensor, *stats: torch.Tensor) -> None:
    want = tuple(q.shape[:3])
    for t in stats:
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != want or not t.is_contiguous()):
            raise ValueError(f"row statistics must be contiguous {want} f32 on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def dq(q, k, v, do, m, l, delta, *, causal: bool, sm_scale: float, p: int,
       iters: int, variant: str) -> torch.Tensor:
    """One launch of the dq kernel; returns dq in q's dtype."""
    global launches_dq
    check_operands("flash_attention_bwd_dq", q, k, v, do)
    _check_stats(q, m, l, delta)
    build.check_datapath(p, iters, variant)
    out = torch.empty_like(q)
    table = rom("recip", p, str(q.device))
    rc = build.load().flash_attention_bwd_dq(
        *_common_args(q, k, v, do, m, l, delta, table), out.data_ptr(),
        *_tail(q, k, sm_scale, causal, p, iters, variant))
    build.check(rc, "flash_attention_bwd_dq")
    launches_dq += 1
    return out


def dkv(q, k, v, do, m, l, delta, *, causal: bool, sm_scale: float, p: int,
        iters: int, variant: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the dk/dv kernel; returns the per-q-head dk, dv as
    (B, H, S, D) f32."""
    global launches_dkv
    check_operands("flash_attention_bwd_dkv", q, k, v, do)
    _check_stats(q, m, l, delta)
    build.check_datapath(p, iters, variant)
    dk_h = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dv_h = torch.empty_like(dk_h)
    table = rom("recip", p, str(q.device))
    rc = build.load().flash_attention_bwd_dkv(
        *_common_args(q, k, v, do, m, l, delta, table), dk_h.data_ptr(), dv_h.data_ptr(),
        *_tail(q, k, sm_scale, causal, p, iters, variant))
    build.check(rc, "flash_attention_bwd_dkv")
    launches_dkv += 1
    return dk_h, dv_h


def flash_attention_bwd(q, k, v, do, out, m, l, *, causal: bool = True,
                        sm_scale: Optional[float] = None, p: int, iters: int,
                        variant: str):
    """(dq, dk, dv) at q/k/v's shapes and dtypes from the forward's ``out``
    and residuals ``m``, ``l``; ``do`` is the output's cotangent."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    do = do.to(q.dtype).contiguous()
    delta = torch.sum(do.to(torch.float32) * out.to(torch.float32), dim=-1)
    kw = dict(causal=causal, sm_scale=sm_scale, p=p, iters=iters, variant=variant)
    dq_ = dq(q, k, v, do, m, l, delta, **kw)
    dk_h, dv_h = dkv(q, k, v, do, m, l, delta, **kw)
    b, h, s, d = q.shape
    kh = k.shape[1]
    dk_ = dk_h.reshape(b, kh, h // kh, s, d).sum(dim=2).to(k.dtype)
    dv_ = dv_h.reshape(b, kh, h // kh, s, d).sum(dim=2).to(v.dtype)
    return dq_, dk_, dv_
