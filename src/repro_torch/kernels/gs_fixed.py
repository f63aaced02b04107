"""Fixed-point Goldschmidt kernels over int8 operands: the CUDA wrappers.

Replace the three ``pallas_call``s of ``repro.kernels.gs_fixed``
(``gs_fixed_recip``, ``gs_fixed_softmax``, ``gs_fixed_rmsnorm``).  The
kernels are ``csrc/gs_fixed.cu`` over the helpers of
``csrc/gs_fixed_common.cuh``; their plain PyTorch versions are
:func:`repro_torch.kernels.ref.fixed_recip`, ``fixed_softmax`` and
``fixed_rmsnorm``.  The per-tensor scale reaches a kernel as a
one-element f32 device operand, so a scale computed on the card is never
read back.  ``launches_recip``, ``launches_softmax`` and
``launches_rmsnorm`` count each kernel's launches.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.fixed_point_torch import rom_words
from repro_torch.kernels import build

launches_recip = 0
launches_softmax = 0
launches_rmsnorm = 0


@functools.lru_cache(maxsize=None)
def rom_words_u32(kind: str, p: int, frac_bits: int, device: str) -> torch.Tensor:
    """The ROM words left-aligned to ``frac_bits`` (at most 2^30) as the
    kernels' uint32 operand, held in an int32 tensor."""
    return rom_words(kind, p, frac_bits, device).to(torch.int32)


def scale_operand(scale, device: torch.device) -> torch.Tensor:
    """The per-tensor scale as a one-element f32 tensor on ``device``."""
    return torch.as_tensor(scale, dtype=torch.float32, device=device).reshape(1)


def _check(x: torch.Tensor, kernel: str, p: int, frac_bits: int, iters: int,
           variant: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{kernel} kernel needs a CUDA tensor, got one on {x.device}")
    if x.dtype != torch.int8 or not x.is_contiguous():
        raise TypeError(f"{kernel} kernel takes a contiguous int8 tensor, got {x.dtype}")
    build.check_datapath(p, iters, variant)
    if not p + 2 <= frac_bits <= 30:
        raise ValueError(f"frac_bits={frac_bits} outside [p+2, 30] for p={p}")


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def gs_fixed_recip(x: torch.Tensor, scale, *, p: int, frac_bits: int, iters: int,
                   variant: str, mitchell_iters: int) -> torch.Tensor:
    """1/(x·scale) elementwise for int8 ``x`` of any shape; f32 out.  The
    host-side ``1/scale`` is one f32 division, as in the reference."""
    global launches_recip
    _check(x, "gs_fixed_recip", p, frac_bits, iters, variant)
    inv_scale = 1.0 / scale_operand(scale, x.device)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    rc = build.load().gs_fixed_recip_launch(
        x.data_ptr(), inv_scale.data_ptr(),
        rom_words_u32("recip", p, frac_bits, str(x.device)).data_ptr(), out.data_ptr(),
        x.numel(), frac_bits, p, iters, int(variant == "pipelined"), mitchell_iters,
        _stream(x))
    build.check(rc, "gs_fixed_recip")
    launches_recip += 1
    return out


def gs_fixed_softmax(x: torch.Tensor, scale, *, p: int, frac_bits: int, iters: int,
                     variant: str, mitchell_iters: int) -> torch.Tensor:
    """softmax(x·scale) over the last axis of int8 ``x``; f32 out."""
    global launches_softmax
    _check(x, "gs_fixed_softmax", p, frac_bits, iters, variant)
    d = x.shape[-1]
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    rc = build.load().gs_fixed_softmax_launch(
        x.data_ptr(), scale_operand(scale, x.device).data_ptr(),
        rom_words_u32("recip", p, frac_bits, str(x.device)).data_ptr(), out.data_ptr(),
        x.numel() // d, d, frac_bits, p, iters, int(variant == "pipelined"),
        mitchell_iters, _stream(x))
    build.check(rc, "gs_fixed_softmax")
    launches_softmax += 1
    return out


def gs_fixed_rmsnorm(x: torch.Tensor, scale, gain: torch.Tensor, *, eps: float, p: int,
                     frac_bits: int, iters: int) -> torch.Tensor:
    """RMSNorm of (x·scale) over the last axis of int8 ``x``, times the
    ``(d,)`` f32 ``gain``; f32 out."""
    global launches_rmsnorm
    _check(x, "gs_fixed_rmsnorm", p, frac_bits, iters, "feedback")
    d = x.shape[-1]
    if gain.device != x.device or gain.dtype != torch.float32 or tuple(gain.shape) != (d,):
        raise ValueError(f"gain must be ({d},) f32 on {x.device}, got "
                         f"{tuple(gain.shape)} {gain.dtype} on {gain.device}")
    gain = gain.contiguous()
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    # 1/d and eps reach the kernel as f32, rounded as the reference rounds
    # its Python-float constants
    rc = build.load().gs_fixed_rmsnorm_launch(
        x.data_ptr(), scale_operand(scale, x.device).data_ptr(), gain.data_ptr(),
        rom_words_u32("rsqrt", p, frac_bits, str(x.device)).data_ptr(), out.data_ptr(),
        x.numel() // d, d, 1.0 / d, eps, frac_bits, p, iters, _stream(x))
    build.check(rc, "gs_fixed_rmsnorm")
    launches_rmsnorm += 1
    return out
