"""Fused RMSNorm with a Goldschmidt rsqrt: the CUDA kernel's wrapper.

Replaces ``repro.kernels.gs_rmsnorm`` (its ``pallas_call`` in ``_run``).
The kernel is ``csrc/gs_rmsnorm.cu``; its plain PyTorch version is
:func:`repro_torch.kernels.ref.rmsnorm`.  ``launches`` counts the kernel
launches this wrapper made.

The launch plan is computed here from pure functions the CPU tests reach:
16-byte vectors when d is a multiple of the width and every pointer is
16-byte aligned (:func:`vector_width`), the vectors a thread holds and the
threads a row (:func:`row_plan`), rows a block (:func:`rows_per_block`), and
a grid of at most SMs x resident blocks (:func:`grid_size`;
:func:`grid_limits` queries the card once per device and instance).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.core.goldschmidt import rom
from repro_torch.kernels import build

VECTOR_BYTES = 16
VECS = (1, 2, 4, 8)  # the register instances: vectors a thread holds
MAX_ELEMENTS = 32    # elements a thread holds, at most
# threads a row (and a block) the plan aims for: on an H100 at d 2048, 64
# was slower at every shape and 256 at prefill and bf16 training (PERF.md)
ROW_THREADS = 128
MAX_THREADS = 512    # kMaxThreads in csrc/gs_rmsnorm.cu

launches = 0
_limits: Dict[Tuple, Tuple[int, int]] = {}
_tables: Dict[Tuple[int, int], torch.Tensor] = {}


class Plan(NamedTuple):
    width: int        # elements a vector: 4 (f32) or 8 (bf16) at 16 bytes, else 1
    vecs: int         # vectors a thread holds; 0: the looping instance
    row_threads: int  # threads a row, a multiple of 32
    rows_per_block: int

    @property
    def threads(self) -> int:
        return self.row_threads * self.rows_per_block


def vector_width(itemsize: int, d: int, *ptrs: int) -> int:
    """A 16-byte vector's elements when ``d`` is a multiple of them and
    every pointer is 16-byte aligned (every row then starts aligned), else 1."""
    width = VECTOR_BYTES // itemsize
    if d % width == 0 and all(ptr % VECTOR_BYTES == 0 for ptr in ptrs):
        return width
    return 1


@functools.lru_cache(maxsize=None)
def row_plan(d: int, width: int) -> Tuple[int, int]:
    """(vectors a thread holds, threads a row) for a row of ``d`` elements
    in ``width``-element vectors: the fewest vectors that fit the row in
    :data:`ROW_THREADS` threads, else the most (at most
    :data:`MAX_ELEMENTS` elements) in up to :data:`MAX_THREADS`; a wider row
    takes the looping instance, ``(0, MAX_THREADS)``."""
    nvec = d // width
    fits = [v for v in VECS if v * width <= MAX_ELEMENTS]
    for vecs in fits:
        threads = 32 * max(1, -(-nvec // (32 * vecs)))
        if threads <= ROW_THREADS:
            return vecs, threads
    threads = 32 * -(-nvec // (32 * fits[-1]))
    return (fits[-1], threads) if threads <= MAX_THREADS else (0, MAX_THREADS)


def rows_per_block(row_threads: int) -> int:
    """Rows a block: narrow rows share a block of :data:`ROW_THREADS`."""
    return max(1, ROW_THREADS // row_threads)


@functools.lru_cache(maxsize=None)
def launch_plan(d: int, itemsize: int, ptr_bits: int) -> Plan:
    """The plan for rows of ``d`` elements of ``itemsize`` bytes whose
    operands' pointers OR to ``ptr_bits`` (aligned when it is)."""
    width = vector_width(itemsize, d, ptr_bits)
    vecs, row_threads = row_plan(d, width)
    return Plan(width, vecs, row_threads, rows_per_block(row_threads))


def grid_size(rows: int, per_block: int, sms: int, resident: int) -> int:
    """Blocks for ``rows`` rows, ``per_block`` a block: at most ``sms`` x
    ``resident`` (one wave that walks the rest in its grid-stride loop); 0
    for no rows (no launch)."""
    if rows == 0:
        return 0
    return max(1, min(-(-rows // per_block), sms * resident))


def resident_blocks(is_bf16: bool, plan: Plan) -> int:
    """Blocks of the plan's instance an SM of the current device holds at
    once (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    blocks = ctypes.c_int(0)
    rc = build.load().gs_rmsnorm_occupancy(int(is_bf16), int(plan.width > 1), plan.vecs,
                                           plan.threads, ctypes.byref(blocks))
    build.check(rc, "gs_rmsnorm occupancy")
    if blocks.value < 1:
        raise RuntimeError(f"gs_rmsnorm: no block of {plan} (bf16 {is_bf16}) fits on an SM")
    return blocks.value


def grid_limits(device: torch.device, is_bf16: bool, plan: Plan) -> Tuple[int, int]:
    """(SMs, resident blocks) of the plan's instance on ``device``, queried
    once per device and instance and then one dict lookup."""
    key = (device.index, is_bf16, plan)
    limits = _limits.get(key)
    if limits is None:
        with torch.cuda.device(device):
            limits = (torch.cuda.get_device_properties(device).multi_processor_count,
                      resident_blocks(is_bf16, plan))
        _limits[key] = limits
    return limits


def rsqrt_table(p: int, device: torch.device) -> torch.Tensor:
    """The rsqrt ROM of width ``p`` on ``device``: one dict lookup a call."""
    key = (p, device.index)
    table = _tables.get(key)
    if table is None:
        table = _tables[key] = rom("rsqrt", p, str(device))
    return table


def check_operands(x: torch.Tensor, gain: torch.Tensor) -> bool:
    """Raise unless ``x`` is a contiguous f32 or bf16 CUDA tensor and
    ``gain`` a contiguous ``(d,)`` f32 tensor on its device; returns whether
    x is bf16."""
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
    return x.dtype == torch.bfloat16


def gs_rmsnorm(x: torch.Tensor, gain: torch.Tensor, *, eps: float, p: int,
               iters: int, variant: str, save_inv: bool = False):
    """RMSNorm over the last axis of a contiguous CUDA tensor (f32 or bf16);
    ``gain`` is ``(d,)`` f32 on the same device.  Returns x's dtype, plus
    the ``(rows, 1)`` f32 rsqrt column when ``save_inv``.  One launch a
    call, none for an empty x."""
    global launches
    is_bf16 = check_operands(x, gain)
    build.check_datapath(p, iters, variant)
    d, dev = x.shape[-1], x.device
    rows = x.numel() // d if d else 0
    out = torch.empty_like(x)
    inv = torch.empty((rows, 1), dtype=torch.float32, device=dev) if save_inv else None
    if rows:
        ptr_bits = (x.data_ptr() | gain.data_ptr() | out.data_ptr()) % VECTOR_BYTES
        plan = launch_plan(d, x.element_size(), ptr_bits)
        grid = grid_size(rows, plan.rows_per_block, *grid_limits(dev, is_bf16, plan))
        # 1/d and 2^p/3 reach the kernel as f32, rounded as the reference
        # rounds its Python-float constants.  The stream is torch's raw
        # getter's: torch.cuda.current_stream builds a Stream object a call.
        rc = build.load().gs_rmsnorm_launch(
            x.data_ptr(), gain.data_ptr(), rsqrt_table(p, dev).data_ptr(), out.data_ptr(),
            inv.data_ptr() if save_inv else None, rows, d, 1.0 / d, eps, p, iters,
            int(variant == "pipelined"), 2.0**p / 3.0, int(is_bf16), int(plan.width > 1),
            plan.vecs, plan.row_threads, plan.rows_per_block, grid,
            torch._C._cuda_getCurrentRawStream(dev.index))
        build.check(rc, "gs_rmsnorm")
        launches += 1
    return (out, inv) if save_inv else out
