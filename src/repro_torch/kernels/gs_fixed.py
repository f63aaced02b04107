"""Fixed-point Goldschmidt kernels over int8 operands: the CUDA wrappers.

Replace the three ``pallas_call``s of ``repro.kernels.gs_fixed``
(``gs_fixed_recip``, ``gs_fixed_softmax``, ``gs_fixed_rmsnorm``).  The
kernels are ``csrc/gs_fixed.cu`` (recip), ``csrc/gs_fixed_softmax.cu`` and
``csrc/gs_fixed_rmsnorm.cu`` over the helpers of
``csrc/gs_fixed_common.cuh``; their plain PyTorch versions are
:func:`repro_torch.kernels.ref.fixed_recip`, ``fixed_softmax`` and
``fixed_rmsnorm``.  The per-tensor scale reaches a kernel as a
one-element f32 device operand, so a scale computed on the card is never
read back.  ``launches_recip``, ``launches_softmax`` and
``launches_rmsnorm`` count each kernel's launches.

The rmsnorm's launch plan is ``gs_rmsnorm``'s row plan at one byte an
element (:func:`launch_plan`): 16-byte vectors of 16 codes when d is a
multiple of 16 and every pointer is 16-byte aligned, the vectors a thread
holds and the threads a row, rows a block, and a grid of at most SMs x
resident blocks (:func:`grid_limits` queries the card once per device and
instance).  The recip's plan (:func:`recip_launch`) is elementwise: 32-bit
words of four codes when n >= 4, x is 4-byte and out 16-byte aligned, else
single codes; 4 words a lane when their trips fill two waves of resident
blocks, else 1; the 64 ROM words an int8 code can reach
(:func:`int8_recip_words`); 1/scale inside the kernel, so a call is one
launch.  The softmax's plan (:func:`softmax_plan`) is its own, so that
narrow rows leave no lane idle: 32-bit words of four codes when d is a
multiple of 4, x is 4-byte and out 16-byte aligned; a row is a power-of-two
segment of a warp (at d 128 one warp, a word a lane) or whole warps; when
the rows fill a wave of blocks, a narrow row packs into fewer lanes
(:func:`softmax_launch`: at d 128 eight words a lane, eight rows a warp).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.fixed_point_torch import rom_words
from repro_torch.kernels import build, gs_rmsnorm

VECTOR_BYTES = 16
# the widest row whose int8 sum of squares stays below 2^32 in the kernel's
# uint32 partials (128^2 x 2^17 = 2^31)
MAX_RMSNORM_D = 1 << 17
RECIP_WORD = 4  # int8 codes in the recip's 32-bit word
RECIP_WORDS = (1, 4)  # the word instances: words a lane holds in flight
RECIP_THREADS = 128  # kThreads in csrc/gs_fixed.cu
SOFTMAX_WORD = 4  # int8 codes in the softmax's 32-bit word
SOFTMAX_VECS = (1, 2, 4, 8)  # the register instances: vectors a thread holds
SOFTMAX_BLOCK = 128  # threads a block the plan aims for: narrow rows share it
SOFTMAX_MAX_THREADS = 512  # kMaxThreads in csrc/gs_fixed_softmax.cu

launches_recip = 0
launches_softmax = 0
launches_rmsnorm = 0
_roms: Dict[Tuple[str, int, int, Optional[int]], torch.Tensor] = {}
_limits: Dict[Tuple, Tuple[int, int]] = {}


def rom_words_u32(kind: str, p: int, frac_bits: int, device: torch.device) -> torch.Tensor:
    """The ROM words left-aligned to ``frac_bits`` (at most 2^30) as the
    kernels' uint32 operand, held in an int32 tensor on ``device``: built
    once per (kind, p, frac_bits, device index), then one dict lookup."""
    key = (kind, p, frac_bits, device.index)
    words = _roms.get(key)
    if words is None:
        words = _roms[key] = rom_words(kind, p, frac_bits, str(device)).to(torch.int32)
    return words


def int8_recip_words(p: int, frac_bits: int, device: torch.device) -> torch.Tensor:
    """The recip ROM words an int8 code's index reaches, in the recip
    kernel's operand: a magnitude has at most 7 significant bits, so for
    p >= 6 the index is j << (p - 6), j < 64, and these are the words at
    those indices (for p < 6 all 2^p).  Built once per (p, frac_bits,
    device index), then one dict lookup."""
    key = ("int8_recip", p, frac_bits, device.index)
    words = _roms.get(key)
    if words is None:
        step = 1 << max(p - 6, 0)
        words = _roms[key] = rom_words_u32("recip", p, frac_bits, device)[::step].contiguous()
    return words


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


def _stream(x: torch.Tensor) -> int:
    """x's device's current stream from torch's raw getter
    (``torch.cuda.current_stream`` builds a Stream object a call)."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def recip_width(n: int, x_ptr: int, out_ptr: int) -> int:
    """Codes a vector of the recip: a 32-bit word of 4 when ``n`` >= 4, x
    is 4-byte and out 16-byte aligned (every word and float4 store then
    is; the n % 4 tail runs one code a thread), else 1."""
    if n >= RECIP_WORD and x_ptr % RECIP_WORD == 0 and out_ptr % VECTOR_BYTES == 0:
        return RECIP_WORD
    return 1


def recip_plan(width: int, words: int) -> gs_rmsnorm.Plan:
    """The recip instance of ``width``-code vectors, ``words`` a lane in
    flight, in blocks of :data:`RECIP_THREADS` threads."""
    return gs_rmsnorm.Plan(width, words, RECIP_THREADS, 1)


def recip_launch(n: int, x_bits: int, out_bits: int,
                 device: torch.device) -> Tuple[gs_rmsnorm.Plan, int]:
    """(plan, grid) for ``n`` >= 1 codes whose x and out pointers are
    ``x_bits`` and ``out_bits`` past a 16-byte boundary: in words, 4 words
    a lane when their trips fill two waves of that instance's resident
    blocks (a grid of one wave, every lane loading its second trip's words
    while it computes the first's), else one vector a lane and a block per
    :data:`RECIP_THREADS` vectors, at most one wave.  On an H100 at
    (65536, 128) queued, 4 words a lane (3.1 waves) took 18.9 us and 1 word
    21.8; at (256, 128) one word a lane in 64 blocks took 2.79 and 4 words
    3.41."""
    width = recip_width(n, x_bits, out_bits)
    nvec = n // width
    if width > 1:
        words = RECIP_WORDS[-1]
        plan = recip_plan(width, words)
        sms, resident = grid_limits(device, plan, "recip")
        if nvec >= 2 * words * RECIP_THREADS * sms * resident:
            return plan, sms * resident
    plan = recip_plan(width, 1)
    return plan, gs_rmsnorm.grid_size(nvec, RECIP_THREADS, *grid_limits(device, plan, "recip"))


def gs_fixed_recip(x: torch.Tensor, scale, *, p: int, frac_bits: int, iters: int,
                   variant: str, mitchell_iters: int) -> torch.Tensor:
    """1/(x·scale) elementwise for int8 ``x`` of any shape; f32 out.  One
    launch a call, none for an empty x: the kernel takes the scale operand
    and rounds 1/scale itself, as the reference's one f32 division does."""
    global launches_recip
    _check(x, "gs_fixed_recip", p, frac_bits, iters, variant)
    dev, n = x.device, x.numel()
    out = torch.empty(x.shape, dtype=torch.float32, device=dev)
    if n:
        plan, grid = recip_launch(n, x.data_ptr() % VECTOR_BYTES, out.data_ptr() % VECTOR_BYTES,
                                  dev)
        rc = build.load().gs_fixed_recip_launch(
            x.data_ptr(), scale_operand(scale, dev).data_ptr(),
            int8_recip_words(p, frac_bits, dev).data_ptr(), out.data_ptr(), n, frac_bits,
            p, iters, int(variant == "pipelined"), mitchell_iters, int(plan.width > 1),
            plan.vecs, grid, _stream(x))
        build.check(rc, "gs_fixed_recip")
        launches_recip += 1
    return out


def launch_plan(d: int, ptr_bits: int) -> gs_rmsnorm.Plan:
    """The rmsnorm's plan for rows of ``d`` int8 codes whose operands'
    pointers OR to ``ptr_bits``: ``gs_rmsnorm``'s row plan at one byte an
    element, so 16-byte vectors hold 16 codes (at most 2 a thread: rows up
    to 16384 in registers) and single codes at most 8 (up to 4096)."""
    return gs_rmsnorm.launch_plan(d, 1, ptr_bits)


def resident_blocks(plan: gs_rmsnorm.Plan, kernel: str = "rmsnorm") -> int:
    """Blocks of the plan's instance of ``kernel`` (``"rmsnorm"``,
    ``"softmax"`` or ``"recip"``) an SM of the current device holds at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    blocks = ctypes.c_int(0)
    name = f"gs_fixed_{kernel}"
    rc = getattr(build.load(), f"{name}_occupancy")(int(plan.width > 1), plan.vecs,
                                                    plan.threads, ctypes.byref(blocks))
    build.check(rc, f"{name} occupancy")
    if blocks.value < 1:
        raise RuntimeError(f"{name}: no block of {plan} fits on an SM")
    return blocks.value


def grid_limits(device: torch.device, plan: gs_rmsnorm.Plan,
                kernel: str = "rmsnorm") -> Tuple[int, int]:
    """(SMs, resident blocks) of the plan's instance of ``kernel`` on
    ``device``, queried once per device, kernel and instance and then one
    dict lookup."""
    key = (kernel, device.index, plan)
    limits = _limits.get(key)
    if limits is None:
        with torch.cuda.device(device):
            limits = (torch.cuda.get_device_properties(device).multi_processor_count,
                      resident_blocks(plan, kernel))
        _limits[key] = limits
    return limits


def softmax_width(d: int, x_ptr: int, out_ptr: int) -> int:
    """Codes a vector of the softmax: a 32-bit word of 4 when ``d`` is a
    multiple of 4, x is 4-byte and out 16-byte aligned (every row's words
    and float4 stores then are), else 1."""
    if d % SOFTMAX_WORD == 0 and x_ptr % SOFTMAX_WORD == 0 and out_ptr % VECTOR_BYTES == 0:
        return SOFTMAX_WORD
    return 1


@functools.lru_cache(maxsize=None)
def softmax_row_plan(d: int, width: int) -> Tuple[int, int]:
    """(vectors a thread holds, threads a row) for a softmax row of ``d``
    codes in ``width``-code vectors: the fewest vectors that fit the row in
    one warp, as a power-of-two segment of it (d 128 in words: one vector
    in each of 32 lanes); else 8 vectors a thread in whole warps, up to
    :data:`SOFTMAX_MAX_THREADS`; a wider row takes the looping instance,
    ``(0, SOFTMAX_MAX_THREADS)``."""
    nvec = d // width
    for vecs in SOFTMAX_VECS:
        lanes = -(-nvec // vecs)
        if lanes <= 32:
            return vecs, 1 << (lanes - 1).bit_length()
    vecs = SOFTMAX_VECS[-1]
    threads = 32 * -(-nvec // (32 * vecs))
    return (vecs, threads) if threads <= SOFTMAX_MAX_THREADS else (0, SOFTMAX_MAX_THREADS)


def packed_row_plan(d: int, width: int) -> Tuple[int, int]:
    """A row of one warp in the fewest lanes, at most 8 vectors a lane, and
    the fewest vectors that fill them (d 128 in words: 8 words in each of 4
    lanes, eight rows a warp); the plain row plan where that saves no lane.
    More rows a warp put more loads in flight: on an H100 at (65536, 128)
    queued, 8 words a lane took 16.8 us, 2 or 4 words 18.7 and 1 word 20.1,
    while at 256 rows the plain plan's warp a row is the fastest."""
    vecs, row_threads = softmax_row_plan(d, width)
    nvec = d // width
    lanes = -(-nvec // SOFTMAX_VECS[-1])
    lanes = 1 << (lanes - 1).bit_length()
    if row_threads > 32 or lanes >= row_threads:
        return vecs, row_threads
    return next(v for v in SOFTMAX_VECS if v * lanes >= nvec), lanes


@functools.lru_cache(maxsize=None)
def softmax_plan(d: int, x_bits: int, out_bits: int, packed: bool = False) -> gs_rmsnorm.Plan:
    """The softmax's plan for rows of ``d`` codes whose x and out pointers
    are ``x_bits`` and ``out_bits`` past a 16-byte boundary, on
    :func:`softmax_row_plan` (or, ``packed``, :func:`packed_row_plan`):
    blocks of :data:`SOFTMAX_BLOCK` threads, or one row."""
    width = softmax_width(d, x_bits, out_bits)
    vecs, row_threads = (packed_row_plan if packed else softmax_row_plan)(d, width)
    return gs_rmsnorm.Plan(width, vecs, row_threads, max(1, SOFTMAX_BLOCK // row_threads))


def softmax_launch(rows: int, d: int, x_bits: int, out_bits: int,
                   device: torch.device) -> Tuple[gs_rmsnorm.Plan, int]:
    """(plan, grid) for ``rows`` rows: the packed plan when the rows fill
    one wave of its resident blocks (every lane it leaves idle is then
    another row's), else the plain plan, whose narrow rows spread over
    more warps; the grid at most SMs x resident blocks."""
    plan = softmax_plan(d, x_bits, out_bits)
    packed = softmax_plan(d, x_bits, out_bits, packed=True)
    if packed != plan:
        sms, resident = grid_limits(device, packed, "softmax")
        if rows >= packed.rows_per_block * sms * resident:
            return packed, sms * resident
    return plan, gs_rmsnorm.grid_size(rows, plan.rows_per_block,
                                      *grid_limits(device, plan, "softmax"))


def gs_fixed_softmax(x: torch.Tensor, scale, *, p: int, frac_bits: int, iters: int,
                     variant: str, mitchell_iters: int) -> torch.Tensor:
    """softmax(x·scale) over the last axis of int8 ``x``; f32 out.  One
    launch a call, none for an empty x; rows of no code are refused."""
    global launches_softmax
    _check(x, "gs_fixed_softmax", p, frac_bits, iters, variant)
    if x.dim() == 0 or x.shape[-1] == 0:
        raise ValueError(f"gs_fixed_softmax takes rows of at least one code, got shape "
                         f"{tuple(x.shape)}")
    d, dev = x.shape[-1], x.device
    out = torch.empty(x.shape, dtype=torch.float32, device=dev)
    rows = x.numel() // d
    if rows:
        plan, grid = softmax_launch(rows, d, x.data_ptr() % VECTOR_BYTES,
                                    out.data_ptr() % VECTOR_BYTES, dev)
        rc = build.load().gs_fixed_softmax_launch(
            x.data_ptr(), scale_operand(scale, dev).data_ptr(),
            rom_words_u32("recip", p, frac_bits, dev).data_ptr(), out.data_ptr(), rows, d,
            frac_bits, p, iters, int(variant == "pipelined"), mitchell_iters,
            int(plan.width > 1), plan.vecs, plan.row_threads, plan.rows_per_block, grid,
            _stream(x))
        build.check(rc, "gs_fixed_softmax")
        launches_softmax += 1
    return out


def gs_fixed_rmsnorm(x: torch.Tensor, scale, gain: torch.Tensor, *, eps: float, p: int,
                     frac_bits: int, iters: int) -> torch.Tensor:
    """RMSNorm of (x·scale) over the last axis of int8 ``x``, times the
    ``(d,)`` f32 ``gain``; f32 out.  One launch a call, none for an empty
    x."""
    global launches_rmsnorm
    _check(x, "gs_fixed_rmsnorm", p, frac_bits, iters, "feedback")
    d, dev = x.shape[-1], x.device
    if gain.device != dev or gain.dtype != torch.float32 or tuple(gain.shape) != (d,):
        raise ValueError(f"gain must be ({d},) f32 on {dev}, got "
                         f"{tuple(gain.shape)} {gain.dtype} on {gain.device}")
    if d > MAX_RMSNORM_D:
        raise ValueError(f"gs_fixed_rmsnorm takes rows of at most {MAX_RMSNORM_D} codes, "
                         f"got {d}")
    gain = gain.contiguous()
    out = torch.empty(x.shape, dtype=torch.float32, device=dev)
    rows = x.numel() // d if d else 0
    if rows:
        ptr_bits = (x.data_ptr() | gain.data_ptr() | out.data_ptr()) % VECTOR_BYTES
        plan = launch_plan(d, ptr_bits)
        grid = gs_rmsnorm.grid_size(rows, plan.rows_per_block, *grid_limits(dev, plan))
        # 1/d and eps reach the kernel as f32, rounded as the reference
        # rounds its Python-float constants
        rc = build.load().gs_fixed_rmsnorm_launch(
            x.data_ptr(), scale_operand(scale, dev).data_ptr(), gain.data_ptr(),
            rom_words_u32("rsqrt", p, frac_bits, dev).data_ptr(), out.data_ptr(), rows, d,
            1.0 / d, eps, frac_bits, p, iters, int(plan.width > 1), plan.vecs,
            plan.row_threads, plan.rows_per_block, grid, _stream(x))
        build.check(rc, "gs_fixed_rmsnorm")
        launches_rmsnorm += 1
    return out
