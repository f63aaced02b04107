"""Elementwise Goldschmidt reciprocal, rsqrt and sqrt: the CUDA kernels'
wrappers.

Replaces ``repro.kernels.gs_recip`` and ``repro.kernels.gs_rsqrt`` (their
``pallas_call`` in ``_run``; the latter behind both ``gs_rsqrt`` and
``gs_sqrt``).  The kernels are ``gs_recip_kernel`` and ``gs_rsqrt_kernel``
in ``csrc/gs_elementwise.cu``; their plain PyTorch versions are
:func:`repro_torch.kernels.ref.reciprocal` and
:func:`repro_torch.kernels.ref.rsqrt`.  ``launches_recip`` and
``launches_rsqrt`` count the launches of each kernel that this module made;
the rsqrt kernel counts in every mode.
"""

from __future__ import annotations

import torch

from repro_torch.core.goldschmidt import rom
from repro_torch.kernels import build

MODES = ("rsqrt", "sqrt", "sqrt_both")

launches_recip = 0
launches_rsqrt = 0


def check_operand(x: torch.Tensor, kernel: str) -> bool:
    """Raise unless ``x`` is a contiguous f32 or bf16 CUDA tensor; returns
    whether it is bf16."""
    if not x.is_cuda:
        raise ValueError(f"{kernel} kernel needs a CUDA tensor, got one on {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise TypeError(f"{kernel} kernel takes a contiguous f32 or bf16 tensor, "
                        f"got {x.dtype}{'' if x.is_contiguous() else ' (not contiguous)'}")
    return x.dtype == torch.bfloat16


def gs_recip(x: torch.Tensor, *, p: int, iters: int, variant: str) -> torch.Tensor:
    """1/x elementwise for a contiguous f32 or bf16 CUDA tensor of any shape;
    returns x's dtype."""
    global launches_recip
    is_bf16 = check_operand(x, "gs_recip")
    build.check_datapath(p, iters, variant)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    rc = build.load().gs_recip_launch(
        x.data_ptr(), rom("recip", p, str(x.device)).data_ptr(), out.data_ptr(),
        x.numel(), p, iters, int(variant == "pipelined"), int(is_bf16),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "gs_recip")
    launches_recip += 1
    return out


def gs_rsqrt(x: torch.Tensor, *, p: int, iters: int, variant: str, mode: str = "rsqrt"):
    """1/sqrt(x) (``mode="rsqrt"``), sqrt(x) (``"sqrt"``) or the pair
    ``(sqrt(x), 1/sqrt(x))`` from one launch (``"sqrt_both"``), elementwise
    for a contiguous f32 or bf16 CUDA tensor of any shape, in x's dtype."""
    global launches_rsqrt
    is_bf16 = check_operand(x, "gs_rsqrt")
    build.check_datapath(p, iters, variant)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    out0 = torch.empty_like(x)
    out1 = torch.empty_like(x) if mode == "sqrt_both" else None
    if x.numel() > 0:
        # 2^p/3 reaches the kernel as f32, rounded as the reference rounds
        # its Python-float constant
        rc = build.load().gs_rsqrt_launch(
            x.data_ptr(), rom("rsqrt", p, str(x.device)).data_ptr(), out0.data_ptr(),
            out1.data_ptr() if out1 is not None else None, x.numel(), p, iters,
            int(variant == "pipelined"), 2.0**p / 3.0, MODES.index(mode), int(is_bf16),
            torch.cuda.current_stream(x.device).cuda_stream)
        build.check(rc, "gs_rsqrt")
        launches_rsqrt += 1
    return (out0, out1) if mode == "sqrt_both" else out0
