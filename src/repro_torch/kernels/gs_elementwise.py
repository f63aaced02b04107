"""Elementwise Goldschmidt reciprocal, rsqrt and sqrt: the CUDA kernels'
wrappers.

Replaces ``repro.kernels.gs_recip`` and ``repro.kernels.gs_rsqrt`` (their
``pallas_call`` in ``_run``; the latter behind both ``gs_rsqrt`` and
``gs_sqrt``).  The kernels are ``gs_recip_kernel`` and ``gs_rsqrt_kernel``
in ``csrc/gs_elementwise.cu``, two instances of one vector loop; their
plain PyTorch versions are :func:`repro_torch.kernels.ref.reciprocal` and
:func:`repro_torch.kernels.ref.rsqrt`.  ``launches_recip`` and
``launches_rsqrt`` count the launches of each kernel that this module made;
the rsqrt kernel counts in every mode.

Both kernels share one launch plan, computed here from pure functions the
CPU tests reach: 16-byte vectors when every operand is 16-byte aligned
(:func:`vector_width`), a grid of at most SMs x resident blocks
(:func:`grid_size`; :func:`grid_limits` queries the card once per device
and instance).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.core.goldschmidt import rom
from repro_torch.kernels import build

MODES = ("rsqrt", "sqrt", "sqrt_both")
OPS = ("recip",) + MODES  # the op codes of csrc/gs_elementwise.cu
_OP_CODES = {op: i for i, op in enumerate(OPS)}
THREADS = 128  # kThreads in csrc/gs_elementwise.cu
VECTOR_BYTES = 16

launches_recip = 0
launches_rsqrt = 0
_limits: Dict[Tuple[int, str, bool, int], Tuple[int, int]] = {}


def vector_width(itemsize: int, *ptrs: int) -> int:
    """Elements a thread of the kernels moves at once: a 16-byte vector (4
    f32 or 8 bf16) when every pointer is 16-byte aligned, else 1."""
    return VECTOR_BYTES // itemsize if all(ptr % VECTOR_BYTES == 0 for ptr in ptrs) else 1


def grid_size(n: int, width: int, sms: int, resident: int) -> int:
    """Blocks of a kernel for ``n`` elements: one a block's worth of
    ``width``-element threads, at most ``sms`` x ``resident`` (one wave that
    walks the rest in its grid-stride loop); 0 for ``n == 0`` (no launch)."""
    if n == 0:
        return 0
    return max(1, min(-(-n // (width * THREADS)), sms * resident))


def resident_blocks(op: str, is_bf16: bool, width: int) -> int:
    """Blocks of one kernel instance (``op`` in :data:`OPS`) an SM of the
    current device holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    blocks = ctypes.c_int(0)
    rc = build.load().gs_elementwise_occupancy(_OP_CODES[op], int(is_bf16), int(width > 1),
                                               ctypes.byref(blocks))
    build.check(rc, f"gs_elementwise {op} occupancy")
    if blocks.value < 1:
        raise RuntimeError(f"gs_elementwise: no block of the {op} instance (bf16 {is_bf16}, "
                           f"width {width}) fits on an SM")
    return blocks.value


def grid_limits(device: torch.device, op: str, is_bf16: bool, width: int) -> Tuple[int, int]:
    """(SMs, resident blocks) of a kernel instance on ``device``, queried
    once per device and instance and then one dict lookup."""
    key = (device.index, op, is_bf16, width)
    limits = _limits.get(key)
    if limits is None:
        with torch.cuda.device(device):
            limits = (torch.cuda.get_device_properties(device).multi_processor_count,
                      resident_blocks(op, is_bf16, width))
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


def _launch(op: str, x: torch.Tensor, p: int, iters: int, variant: str):
    """The outputs of ``op`` on ``x`` (two for ``sqrt_both``) and whether a
    kernel was launched (not for an empty tensor)."""
    kernel = "gs_recip" if op == "recip" else "gs_rsqrt"
    is_bf16 = check_operand(x, kernel)
    build.check_datapath(p, iters, variant)
    outs = [torch.empty_like(x) for _ in range(2 if op == "sqrt_both" else 1)]
    ptrs = [x.data_ptr()] + [o.data_ptr() for o in outs]
    width = vector_width(x.element_size(), *ptrs)
    n, dev = x.numel(), x.device
    grid = grid_size(n, width, *grid_limits(dev, op, is_bf16, width)) if n else 0
    if grid:
        # 2^p/3 reaches the rsqrt kernel as f32, rounded as the reference
        # rounds its Python-float constant; the recip kernel ignores it.
        # The stream is torch's raw getter's: torch.cuda.current_stream
        # builds a Stream object, a few microseconds of host time a call.
        table = rom("recip" if op == "recip" else "rsqrt", p, str(dev))
        rc = build.load().gs_elementwise_launch(
            _OP_CODES[op], ptrs[0], table.data_ptr(), ptrs[1], ptrs[2] if op == "sqrt_both"
            else None, n, p, iters, int(variant == "pipelined"), 2.0**p / 3.0, int(is_bf16),
            int(width > 1), grid, torch._C._cuda_getCurrentRawStream(dev.index))
        build.check(rc, kernel)
    return outs, bool(grid)


def gs_recip(x: torch.Tensor, *, p: int, iters: int, variant: str) -> torch.Tensor:
    """1/x elementwise for a contiguous f32 or bf16 CUDA tensor of any shape;
    returns x's dtype."""
    global launches_recip
    (out,), launched = _launch("recip", x, p, iters, variant)
    launches_recip += launched
    return out


def gs_rsqrt(x: torch.Tensor, *, p: int, iters: int, variant: str, mode: str = "rsqrt"):
    """1/sqrt(x) (``mode="rsqrt"``), sqrt(x) (``"sqrt"``) or the pair
    ``(sqrt(x), 1/sqrt(x))`` from one launch (``"sqrt_both"``), elementwise
    for a contiguous f32 or bf16 CUDA tensor of any shape, in x's dtype."""
    global launches_rsqrt
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    outs, launched = _launch(mode, x, p, iters, variant)
    launches_rsqrt += launched
    return tuple(outs) if mode == "sqrt_both" else outs[0]
