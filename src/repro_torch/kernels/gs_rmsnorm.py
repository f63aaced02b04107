"""Fused RMSNorm with a Goldschmidt rsqrt: the CUDA kernel's wrapper.

Replaces ``repro.kernels.gs_rmsnorm`` (its ``pallas_call`` in ``_run``).
The kernel is ``csrc/gs_rmsnorm.cu``; its plain PyTorch version is
:func:`repro_torch.kernels.ref.rmsnorm`.  ``launches`` counts the kernel
launches this wrapper made.
"""

from __future__ import annotations

import torch

from repro_torch.core.goldschmidt import rom
from repro_torch.kernels import build

launches = 0


def gs_rmsnorm(x: torch.Tensor, gain: torch.Tensor, *, eps: float, p: int,
               iters: int, variant: str, save_inv: bool = False):
    """RMSNorm over the last axis of a contiguous CUDA tensor (f32 or bf16);
    ``gain`` is ``(d,)`` f32 on the same device.  Returns x's dtype, plus
    the ``(rows, 1)`` f32 rsqrt column when ``save_inv``."""
    global launches
    if not x.is_cuda or gain.device != x.device:
        raise ValueError(f"gs_rmsnorm kernel needs CUDA tensors on one device, "
                         f"got x on {x.device}, gain on {gain.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gs_rmsnorm kernel takes f32 or bf16, got {x.dtype}")
    d = x.shape[-1]
    if gain.dtype != torch.float32 or tuple(gain.shape) != (d,):
        raise ValueError(f"gain must be ({d},) f32, got {tuple(gain.shape)} {gain.dtype}")
    if not (x.is_contiguous() and gain.is_contiguous()):
        raise ValueError("gs_rmsnorm kernel needs contiguous tensors")
    build.check_datapath(p, iters, variant)
    rows = x.numel() // d
    out = torch.empty_like(x)
    inv = torch.empty((rows, 1), dtype=torch.float32, device=x.device) if save_inv else None
    table = rom("rsqrt", p, str(x.device))
    # 1/d and 2^p/3 reach the kernel as f32, rounded as the reference rounds
    # its Python-float constants
    rc = build.load().gs_rmsnorm_launch(
        x.data_ptr(), gain.data_ptr(), table.data_ptr(), out.data_ptr(),
        inv.data_ptr() if save_inv else None, rows, d, 1.0 / d, eps, p, iters,
        int(variant == "pipelined"), 2.0**p / 3.0, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "gs_rmsnorm")
    launches += 1
    return (out, inv) if save_inv else out
