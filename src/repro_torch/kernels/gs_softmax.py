"""Row softmax with a Goldschmidt reciprocal of the sum: the CUDA kernel's
wrapper.

Replaces ``repro.kernels.gs_softmax`` (its ``pallas_call`` in ``_run``).
The kernel is ``csrc/gs_softmax.cu``; its plain PyTorch version is
:func:`repro_torch.kernels.ref.softmax`.  ``launches`` counts the kernel
launches this wrapper made.
"""

from __future__ import annotations

import torch

from repro_torch.core.goldschmidt import rom
from repro_torch.kernels import build
from repro_torch.kernels.gs_elementwise import check_operand

launches = 0


def gs_softmax(x: torch.Tensor, *, p: int, iters: int, variant: str) -> torch.Tensor:
    """Softmax over the last axis of a contiguous f32 or bf16 CUDA tensor
    (any leading shape, any width), f32 inside; returns x's dtype."""
    global launches
    is_bf16 = check_operand(x, "gs_softmax")
    build.check_datapath(p, iters, variant)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    d = x.shape[-1]
    rc = build.load().gs_softmax_launch(
        x.data_ptr(), rom("recip", p, str(x.device)).data_ptr(), out.data_ptr(),
        x.numel() // d, d, p, iters, int(variant == "pipelined"), int(is_bf16),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "gs_softmax")
    launches += 1
    return out
