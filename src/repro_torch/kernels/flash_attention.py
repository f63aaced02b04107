"""Causal GQA flash-attention forward with a Goldschmidt epilogue: the CUDA
kernel's wrapper.

Replaces the forward of ``repro.kernels.flash_attention`` (its
``pallas_call`` in ``_fwd_call``).  The kernel is
``csrc/flash_attention.cu``; its plain PyTorch version is
:func:`repro_torch.kernels.ref.attention`.  Any ``S`` is taken as it is:
the kernel masks the ragged last block instead of shrinking its block size
to a divisor of ``S``.  With ``residuals`` the kernel also writes the
``(B, H, S)`` f32 row statistics ``m`` and ``l`` that the backward kernels
(:mod:`repro_torch.kernels.flash_attention_bwd`) read.  ``launches`` counts
the kernel launches this wrapper made.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.goldschmidt import rom
from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64)  # the head dims the kernel is compiled for
launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    p: int, iters: int, variant: str, residuals: bool = False):
    """q (B, H, S, D), k/v (B, KH, S, D) with D in ``HEAD_DIMS``: contiguous
    CUDA tensors of one dtype (f32 or bf16), H a multiple of KH.  Returns
    q's shape and dtype, plus (m, l) when ``residuals``."""
    global launches
    check_operands("flash_attention", q, k, v)
    build.check_datapath(p, iters, variant)
    b, h, s, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    m = l = None
    if residuals:
        m, l = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
                for _ in range(2))
    table = rom("recip", p, str(q.device))
    rc = build.load().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(), out.data_ptr(),
        m.data_ptr() if residuals else None, l.data_ptr() if residuals else None,
        b, h, k.shape[1], s, d, sm_scale, int(causal), p, iters,
        int(variant == "pipelined"), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention")
    launches += 1
    return (out, m, l) if residuals else out


def check_operands(kernel: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   *rest: torch.Tensor) -> None:
    """The operands the flash kernels take: q (and each of ``rest``)
    (B, H, S, D), k/v (B, KH, S, D), D in ``HEAD_DIMS``, H % KH == 0, one
    dtype of f32/bf16, contiguous, on one CUDA device."""
    tensors = (q, k, v, *rest)
    if not (q.is_cuda and all(t.device == q.device for t in tensors)):
        raise ValueError(f"{kernel} kernel needs CUDA tensors on one device")
    if q.dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"{kernel} kernel takes one dtype of f32/bf16, "
                        f"got {[t.dtype for t in tensors]}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, h, s, d = q.shape
    kh = k.shape[1]
    if (d not in HEAD_DIMS or k.shape != (b, kh, s, d) or h % kh
            or any(t.shape != q.shape for t in rest)):
        raise ValueError(f"{kernel} kernel needs D in {HEAD_DIMS}, matching B/S "
                         f"and H % KH == 0; got q {tuple(q.shape)}, k {tuple(k.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{kernel} kernel needs contiguous tensors")
