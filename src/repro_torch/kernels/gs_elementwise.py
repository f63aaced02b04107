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

The rsqrt kernel's launch plan is computed here, from pure functions the CPU
tests reach: 16-byte vectors when every operand is 16-byte aligned
(:func:`vector_width`), a grid of at most SMs x resident blocks
(:func:`grid_size`; :func:`grid_limits` queries the card once per instance).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.core.goldschmidt import rom
from repro_torch.kernels import build

MODES = ("rsqrt", "sqrt", "sqrt_both")
_MODE_CODES = {mode: i for i, mode in enumerate(MODES)}
RSQRT_THREADS = 128  # kRsqrtThreads in csrc/gs_elementwise.cu
VECTOR_BYTES = 16

launches_recip = 0
launches_rsqrt = 0
_limits: Dict[Tuple[int, str, bool, int], Tuple[int, int]] = {}


def vector_width(itemsize: int, *ptrs: int) -> int:
    """Elements a thread of the rsqrt kernel moves at once: a 16-byte vector
    (4 f32 or 8 bf16) when every pointer is 16-byte aligned, else 1."""
    return VECTOR_BYTES // itemsize if all(ptr % VECTOR_BYTES == 0 for ptr in ptrs) else 1


def grid_size(n: int, width: int, sms: int, resident: int) -> int:
    """Blocks of the rsqrt kernel for ``n`` elements: one a block's worth of
    ``width``-element threads, at most ``sms`` x ``resident`` (one wave that
    walks the rest in its grid-stride loop); 0 for ``n == 0`` (no launch)."""
    if n == 0:
        return 0
    return max(1, min(-(-n // (width * RSQRT_THREADS)), sms * resident))


def resident_blocks(mode: str, is_bf16: bool, width: int) -> int:
    """Blocks of one rsqrt kernel instance an SM of the current device holds
    at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    blocks = ctypes.c_int(0)
    rc = build.load().gs_rsqrt_occupancy(_MODE_CODES[mode], int(is_bf16), int(width > 1),
                                         ctypes.byref(blocks))
    build.check(rc, "gs_rsqrt occupancy")
    if blocks.value < 1:
        raise RuntimeError(f"gs_rsqrt: no block of the {mode} instance (bf16 {is_bf16}, "
                           f"width {width}) fits on an SM")
    return blocks.value


def grid_limits(device: torch.device, mode: str, is_bf16: bool, width: int) -> Tuple[int, int]:
    """(SMs, resident blocks) of an rsqrt kernel instance on ``device``,
    queried once per device and instance and then one dict lookup."""
    key = (device.index, mode, is_bf16, width)
    limits = _limits.get(key)
    if limits is None:
        with torch.cuda.device(device):
            limits = (torch.cuda.get_device_properties(device).multi_processor_count,
                      resident_blocks(mode, is_bf16, width))
        _limits[key] = limits
    return limits


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
    code = _MODE_CODES.get(mode)
    if code is None:
        raise ValueError(f"unknown mode {mode!r}")
    out0 = torch.empty_like(x)
    out1 = torch.empty_like(x) if code == 2 else None
    ptrs = [x.data_ptr(), out0.data_ptr()] + ([out1.data_ptr()] if code == 2 else [])
    width = vector_width(x.element_size(), *ptrs)
    n = x.numel()
    grid = grid_size(n, width, *grid_limits(x.device, mode, is_bf16, width)) if n else 0
    if grid:
        # 2^p/3 reaches the kernel as f32, rounded as the reference rounds
        # its Python-float constant
        rc = build.load().gs_rsqrt_launch(
            ptrs[0], rom("rsqrt", p, str(x.device)).data_ptr(), ptrs[1],
            ptrs[2] if code == 2 else None, n, p, iters, int(variant == "pipelined"),
            2.0**p / 3.0, code, int(is_bf16), int(width > 1), grid,
            torch.cuda.current_stream(x.device).cuda_stream)
        build.check(rc, "gs_rsqrt")
        launches_rsqrt += 1
    return (out0, out1) if mode == "sqrt_both" else out0
