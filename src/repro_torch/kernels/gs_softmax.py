"""Row softmax with a Goldschmidt reciprocal of the sum: the CUDA kernel's
wrapper.

Replaces ``repro.kernels.gs_softmax`` (its ``pallas_call`` in ``_run``).
The kernel is ``csrc/gs_softmax.cu``; its plain PyTorch version is
:func:`repro_torch.kernels.ref.softmax`.  ``launches`` counts the kernel
launches this wrapper made.

The launch plan is computed here from pure functions the CPU tests reach
(:func:`launch_plan`): 16-byte vectors when d is a multiple of the width and
x and out are 16-byte aligned; a row that :func:`gs_rmsnorm.row_plan` holds
in one block (up to 16384 elements in vectors, 4096 in single ones) takes a
block instance, several narrow rows a block; a wider row of vectors, up to
131072 elements, is split over a thread-block cluster of :data:`CLUSTER`
CTAs (:func:`cluster_plan`), one contiguous chunk a CTA at
:data:`CLUSTER_ELEMENTS` a thread, the CTAs exchanging their warps' sums and
maxima through distributed shared memory; a wider row, or a wide row of
single elements, takes the looping instance.  The grid is at most SMs x
resident blocks, or the clusters the card holds at once (:func:`grid_size`;
:func:`grid_limits` queries the card once per device and instance).
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.goldschmidt import rom
from repro_torch.kernels import build, gs_rmsnorm
from repro_torch.kernels.gs_elementwise import check_operand

VECTOR_BYTES = 16
BLOCK_THREADS = gs_rmsnorm.MAX_THREADS  # kMaxThreads in csrc/gs_softmax.cu
CLUSTER_THREADS = 1024  # kMaxClusterThreads: threads a CTA of a cluster, at most
CLUSTER_ELEMENTS = 16  # kClusterElements: elements a thread of a cluster holds
# the CTAs a cluster splits a row over (kMaxCluster, the portable limit).  On
# an H100 at (8, 32000) and (256, 32000), f32 and bf16, 8 CTAs a row beat 2,
# 4 and 16 CTAs and one block a row (PERF.md, the gs_softmax section)
CLUSTER = 8

launches = 0
_limits: Dict[Tuple, Tuple[int, int]] = {}


class Plan(NamedTuple):
    width: int        # elements a vector: 4 (f32) or 8 (bf16) at 16 bytes, else 1
    vecs: int         # vectors a thread holds; 0: the looping instance
    row_threads: int  # threads a row (in a cluster: a CTA's chunk), a multiple of 32
    rows_per_block: int
    cluster: int      # 0: a block instance; else the CTAs a row is split over

    @property
    def threads(self) -> int:
        return self.row_threads * self.rows_per_block


def cluster_plan(width: int, nvec: int, size: int = CLUSTER) -> Optional[Plan]:
    """A cluster instance's plan for a row of ``nvec`` ``width``-element
    vectors split over ``size`` CTAs (the timing sweep forces fewer):
    :data:`CLUSTER_ELEMENTS` a thread, the fewest whole warps that hold a
    chunk of ``nvec`` / ``size`` vectors; None past
    :data:`CLUSTER_THREADS` threads a CTA."""
    vecs, chunk = CLUSTER_ELEMENTS // width, -(-nvec // size)
    threads = 32 * -(-chunk // (32 * vecs))
    return Plan(width, vecs, threads, 1, size) if threads <= CLUSTER_THREADS else None


def launch_plan(d: int, itemsize: int, ptr_bits: int) -> Plan:
    """The plan for rows of ``d`` elements of ``itemsize`` bytes whose x and
    out pointers OR to ``ptr_bits`` (aligned when it is)."""
    width = gs_rmsnorm.vector_width(itemsize, d, ptr_bits)
    vecs, row_threads = gs_rmsnorm.row_plan(d, width)
    if vecs:
        return Plan(width, vecs, row_threads, gs_rmsnorm.rows_per_block(row_threads), 0)
    plan = cluster_plan(width, d // width) if width > 1 else None
    return plan or Plan(width, 0, BLOCK_THREADS, 1, 0)


def grid_size(rows: int, plan: Plan, sms: int, resident: int) -> int:
    """Blocks for ``rows`` rows: for a block plan at most ``sms`` x
    ``resident`` (blocks an SM holds; one wave that walks the rest in its
    grid-stride loop); for a cluster plan a cluster a row, at most
    ``resident`` clusters (those the card holds at once); 0 for no rows (no
    launch)."""
    if rows == 0:
        return 0
    if plan.cluster:
        return min(rows, resident) * plan.cluster
    return gs_rmsnorm.grid_size(rows, plan.rows_per_block, sms, resident)


def grid_limits(device: torch.device, is_bf16: bool, plan: Plan) -> Tuple[int, int]:
    """(SMs, resident units) of the plan's instance on ``device``: for a
    block plan the blocks an SM holds at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), for a cluster plan the
    clusters the device holds at once (cudaOccupancyMaxActiveClusters).
    Queried once per device and instance, then one dict lookup; raises if
    none fits."""
    key = (device.index, is_bf16, plan)
    limits = _limits.get(key)
    if limits is None:
        units = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = build.load().gs_softmax_occupancy(int(is_bf16), int(plan.width > 1), plan.vecs,
                                                   plan.cluster, plan.threads,
                                                   ctypes.byref(units))
            build.check(rc, "gs_softmax occupancy")
            sms = torch.cuda.get_device_properties(device).multi_processor_count
        if units.value < 1:
            raise RuntimeError(f"gs_softmax: no {'cluster' if plan.cluster else 'block'} of "
                               f"{plan} (bf16 {is_bf16}) fits on the card")
        limits = _limits[key] = (sms, units.value)
    return limits


def gs_softmax(x: torch.Tensor, *, p: int, iters: int, variant: str) -> torch.Tensor:
    """Softmax over the last axis of a contiguous f32 or bf16 CUDA tensor
    (any leading shape, any width), f32 inside; returns x's dtype.  One
    launch a call, none for an empty x."""
    global launches
    is_bf16 = check_operand(x, "gs_softmax")
    build.check_datapath(p, iters, variant)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    d, dev = x.shape[-1], x.device
    rows = x.numel() // d
    plan = launch_plan(d, x.element_size(), (x.data_ptr() | out.data_ptr()) % VECTOR_BYTES)
    grid = grid_size(rows, plan, *grid_limits(dev, is_bf16, plan))
    # the stream is torch's raw getter's: torch.cuda.current_stream builds a
    # Stream object a call
    rc = build.load().gs_softmax_launch(
        x.data_ptr(), rom("recip", p, str(dev)).data_ptr(), out.data_ptr(), rows, d, p, iters,
        int(variant == "pipelined"), int(is_bf16), int(plan.width > 1), plan.vecs,
        plan.row_threads, plan.rows_per_block, plan.cluster, grid,
        torch._C._cuda_getCurrentRawStream(dev.index))
    build.check(rc, "gs_softmax")
    launches += 1
    return out
