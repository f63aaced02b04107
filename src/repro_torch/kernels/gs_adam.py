"""Fused AdamW step with a Goldschmidt sqrt and reciprocal: the CUDA
kernel's wrapper.

Replaces ``repro.kernels.gs_adam`` (its ``pallas_call`` in
``gs_adam_update``).  The kernel is ``csrc/gs_adam.cu``; its plain PyTorch
version is :func:`repro_torch.kernels.ref.adam_update`.  The step's scalars
arrive as one 3-float device operand
(:func:`repro_torch.kernels.ops.adam_scalars`), so a schedule's learning
rate and the step counter never leave the card.
``launches`` counts the kernel launches this wrapper made.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.goldschmidt import rom
from repro_torch.kernels import build

launches = 0


def gs_adam_update(param: torch.Tensor, grad: torch.Tensor, m: torch.Tensor,
                   v: torch.Tensor, bc: torch.Tensor, *, beta1: float, beta2: float,
                   eps: float, weight_decay: float, p: int, iters: int,
                   variant: str) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One AdamW step on one parameter leaf: contiguous f32 CUDA tensors of
    one shape, ``bc`` the (3,) f32 operand.  Returns new (param, m, v)."""
    global launches
    tensors = (param, grad, m, v, bc)
    if not (param.is_cuda and all(t.device == param.device for t in tensors)):
        raise ValueError("gs_adam kernel needs CUDA tensors on one device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"gs_adam kernel takes f32, got {[t.dtype for t in tensors]}")
    if not (grad.shape == m.shape == v.shape == param.shape) or bc.shape != (3,):
        raise ValueError(f"gs_adam kernel needs one shape and bc (3,), got "
                         f"{[tuple(t.shape) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gs_adam kernel needs contiguous tensors")
    build.check_datapath(p, iters, variant)
    p_out, m_out, v_out = (torch.empty_like(param) for _ in range(3))
    rc = build.load().gs_adam_launch(
        param.data_ptr(), grad.data_ptr(), m.data_ptr(), v.data_ptr(), bc.data_ptr(),
        rom("recip", p, str(param.device)).data_ptr(),
        rom("rsqrt", p, str(param.device)).data_ptr(), p_out.data_ptr(),
        m_out.data_ptr(), v_out.data_ptr(), param.numel(), beta1, 1.0 - beta1, beta2,
        1.0 - beta2, eps, weight_decay, p, iters, int(variant == "pipelined"),
        2.0**p / 3.0, torch.cuda.current_stream(param.device).cuda_stream)
    build.check(rc, "gs_adam")
    launches += 1
    return p_out, m_out, v_out
