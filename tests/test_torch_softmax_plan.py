"""The launch plan of the float softmax kernel (``repro_torch.kernels.gs_softmax``),
its wrapper's arguments and the facts its arithmetic rests on, on the CPU.

The plan is pure Python: 16-byte vectors only when d is a multiple of the
width and x and out are 16-byte aligned; a row the block plan holds on a
block instance (several narrow rows a block); a wider row of vectors split
over a cluster of 8 CTAs, more threads a CTA as the row widens; rows past
what the cluster holds, and wide rows of single elements, on the looping
instance; the row covered by threads x elements x vectors x CTAs; a grid of
at least one block and at most SMs x resident blocks or the clusters the
card holds; no launch for an empty input.  The wrapper's arguments are
checked against a stand-in for the kernel library.  A numpy f32 emulation
of the kernel's sum order (each thread's elements, the warp's butterfly,
the warps in order, or a cluster's warps of every rank folded over the lanes
and a butterfly) covers every element once and stays within
the card's gate of the plain version on ``chip_smoke.py``'s 8a inputs; the
rows a sampler masks give the same NaN classes and exact zeros in the plain
version, the reference's Pallas kernel and the emulation.  The kernel
itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import contextlib
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from repro.kernels import gs_softmax as jsoftmax  # noqa: E402
from repro_torch.core.goldschmidt import rom  # noqa: E402
from repro_torch.kernels import build, common, ref  # noqa: E402
from repro_torch.kernels import gs_softmax as softmax_kernel  # noqa: E402

SMS = 132  # an H100's SMs
F32, BF16 = 4, 2  # itemsizes
WIDTH = {F32: 4, BF16: 8}  # elements of a 16-byte vector
# the widest rows a block instance holds: 512 threads x 32 elements in
# vectors, 512 x 8 single elements; the widest a cluster holds: 8 CTAs of
# 1024 threads x 16 elements
BLOCK_D = {True: 16384, False: 4096}
CLUSTER_D = 8 * 1024 * 16
DS = (1, 2, 37, 200, 384, 517, 1024, 4096, 4097, 16384, 16392, 32000, 65536, CLUSTER_D,
      CLUSTER_D + 8)
ROWS = (1, 2, 8, 37, 64, 131, 132, 256, 4096)
# the (dtype, p, iters, variant) points of chip_smoke's 8a at f32
F32_PRECISIONS = [(p, i, v) for name, p, i, v in chip_smoke.ELEMENTWISE_PRECISIONS
                  if name == "float32"]


def _plan(rows, d, itemsize, aligned=True):
    """The plan of ``rows`` rows of ``d`` (the rows do not change it)."""
    return softmax_kernel.launch_plan(d, itemsize, 0 if aligned else 4)


def _forced(d, itemsize, size):
    """A cluster of ``size`` CTAs a row, forced (the timing sweep's)."""
    return softmax_kernel.cluster_plan(WIDTH[itemsize], d // WIDTH[itemsize], size)


def test_vectors_only_when_d_and_both_pointers_allow_them():
    for d in (8, 200, 384, 4096, 32000):
        for itemsize in (F32, BF16):
            assert _plan(8, d, itemsize).width == WIDTH[itemsize], (d, itemsize)
            assert _plan(8, d, itemsize, aligned=False).width == 1, (d, itemsize)
    for d in (1, 2, 37, 517, 4097, 32001):
        assert _plan(8, d, F32).width == 1, d
    assert _plan(8, 4, BF16).width == 1  # bf16 vectors need d a multiple of 8
    for bits in (2, 4, 8, 12):
        assert softmax_kernel.launch_plan(384, F32, bits).width == 1, bits
    buf = torch.empty(2 * 384 + 8, dtype=torch.float32)
    assert buf.data_ptr() % 16 == 0
    for off in range(8):
        view = buf[off:off + 384]
        want = 4 if off % 4 == 0 else 1
        assert softmax_kernel.launch_plan(384, F32, view.data_ptr() % 16).width == want


@pytest.mark.parametrize("itemsize", [F32, BF16])
@pytest.mark.parametrize("aligned", [True, False])
def test_threads_times_vectors_times_cluster_cover_the_row(itemsize, aligned):
    for d in DS:
        for rows in ROWS:
            plan = _plan(rows, d, itemsize, aligned)
            width = plan.width
            nvec = d // width
            assert width in (1, WIDTH[itemsize]) and d % width == 0
            rt = plan.row_threads
            assert rt % 32 == 0 and plan.threads % 32 == 0, (d, rows)
            if plan.cluster:
                assert width > 1 and d > BLOCK_D[True], (d, rows)
                assert plan.cluster == softmax_kernel.CLUSTER == 8
                assert plan.rows_per_block == 1 and rt <= softmax_kernel.CLUSTER_THREADS
                assert plan.vecs * width == softmax_kernel.CLUSTER_ELEMENTS
                chunk = -(-nvec // plan.cluster)
                assert rt * plan.vecs >= chunk, (d, rows)
                assert (rt - 32) * plan.vecs < chunk, (d, rows)  # no whole warp idle
            elif plan.vecs:
                assert d <= BLOCK_D[width > 1], (d, rows)
                assert plan.threads <= softmax_kernel.BLOCK_THREADS
                assert rt * plan.vecs >= nvec and plan.vecs * width <= 32, (d, rows)
                assert (rt - 32) * plan.vecs < nvec, (d, rows)
            else:  # the looping instance
                assert d > (CLUSTER_D if width > 1 else BLOCK_D[False]), (d, rows)
                assert (rt, plan.rows_per_block) == (softmax_kernel.BLOCK_THREADS, 1)


def test_cluster_threads_by_width():
    """8 CTAs a row at every width of vectors past the block plan, each CTA
    the fewest whole warps that hold its chunk at 16 elements a thread, up
    to 1024 threads; the rows do not change it."""
    for itemsize in (F32, BF16):
        vecs = 16 // WIDTH[itemsize]
        for d in (16392, 32000, 65536, 100000, CLUSTER_D):
            plan = _plan(1, d, itemsize)
            assert all(_plan(rows, d, itemsize) == plan for rows in ROWS)
            chunk = -(-(d // WIDTH[itemsize]) // 8)
            assert (plan.cluster, plan.vecs) == (8, vecs), (d, itemsize)
            assert plan.row_threads == 32 * -(-chunk // (32 * vecs)) <= 1024, (d, itemsize)
    # a sampler's rows at a 32000-token vocabulary: 8 CTAs of 250 threads a
    # row (1000 float4, 500 bf16 vectors), at 2, 8 and 256 rows
    for itemsize in (F32, BF16):
        for rows in (2, 8, 256):
            plan = _plan(rows, 32000, itemsize)
            assert (plan.cluster, plan.row_threads) == (8, 256), (itemsize, rows)
    assert softmax_kernel.cluster_plan(4, 1 << 15).row_threads == 1024
    assert softmax_kernel.cluster_plan(4, (1 << 15) + 1) is None  # no cluster holds it


def test_rows_past_the_cluster_take_the_looping_instance():
    widest = _plan(1, CLUSTER_D, F32)
    assert (widest.cluster, widest.row_threads, widest.vecs) == (8, 1024, 4)
    past = _plan(1, CLUSTER_D + 4, F32)
    assert (past.vecs, past.cluster, past.row_threads) == (0, 0, softmax_kernel.BLOCK_THREADS)
    assert _plan(4096, 16384, F32).cluster == 0  # the block plan holds it
    assert _plan(1, 16388, F32).cluster == 8
    single = _plan(8, 4097, F32)  # single elements: no cluster instance
    assert (single.width, single.vecs, single.cluster) == (1, 0, 0)
    assert _plan(8, 32000, F32, aligned=False).vecs == 0


@pytest.mark.parametrize("size", [1, 2, 4, 8])
def test_forced_cluster_sizes_cover_the_row(size):
    """The sweep's forced clusters: each CTA the fewest whole warps that hold
    its chunk, at most 1024 threads, else no plan."""
    for itemsize in (F32, BF16):
        for d in (16392, 32000, 65536):
            nvec = d // WIDTH[itemsize]
            plan = _forced(d, itemsize, size)
            vecs = 16 // WIDTH[itemsize]
            chunk = -(-nvec // size)
            if 32 * -(-chunk // (32 * vecs)) > softmax_kernel.CLUSTER_THREADS:
                assert plan is None, (d, itemsize)
                continue
            assert (plan.cluster, plan.vecs, plan.rows_per_block) == (size, vecs, 1)
            assert plan.row_threads * plan.vecs >= chunk > (plan.row_threads - 32) * plan.vecs
    assert _forced(32000, F32, 8) == _plan(8, 32000, F32)
    assert _forced(32000, F32, 2).row_threads == 1024 and _forced(32000, F32, 1) is None


def test_grid_is_at_least_one_block_and_fits_the_limits():
    for d, itemsize in ((384, F32), (200, F32), (517, F32), (32000, F32), (32000, BF16),
                        (CLUSTER_D + 4, F32)):
        for rows in (0, 1, 8, 256, 4096, 100_000):
            plan = _plan(rows, d, itemsize)
            for resident in (1, 7, 16):
                grid = softmax_kernel.grid_size(rows, plan, SMS, resident)
                if rows == 0:
                    assert grid == 0
                    continue
                if plan.cluster:
                    assert grid % plan.cluster == 0
                    assert grid // plan.cluster == min(rows, resident)
                else:
                    assert 1 <= grid <= SMS * resident
                    assert grid * plan.rows_per_block >= rows or grid == SMS * resident
                    assert (grid - 1) * plan.rows_per_block < rows


class _KernelLibrary:
    """Records the arguments of each launch and occupancy query; returns
    cudaSuccess."""

    def __init__(self):
        self.launches = []
        self.queries = []

    def gs_softmax_launch(self, *args):
        self.launches.append(args)
        return 0

    def gs_softmax_occupancy(self, *args):
        self.queries.append(args[:-1])
        args[-1]._obj.value = 3
        return 0


def _stand_in(monkeypatch, resident=5):
    lib = _KernelLibrary()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(softmax_kernel, "check_operand",
                        lambda x, kernel: x.dtype == torch.bfloat16)
    monkeypatch.setattr(softmax_kernel, "grid_limits",
                        lambda device, is_bf16, plan: (SMS, resident))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 7,
                        raising=False)
    return lib


# (rows, d, storage offset of x, dtype, p, iters, variant): the benchmark's
# (16, 384), narrow and single-element rows, the sampler's (8, 32000) and
# (2, 32000), (256, 32000) at f32 and bf16, p 12, views one element in,
# wider clusters, and rows past what the cluster holds
CASES = ((16, 384, 0, "float32", 7, 2, "feedback"),
         (37, 200, 0, "float32", 7, 2, "feedback"),
         (33, 517, 0, "float32", 8, 0, "pipelined"),
         (8, 32000, 0, "float32", 7, 2, "feedback"),
         (2, 32000, 0, "float32", 12, 1, "pipelined"),
         (256, 32000, 0, "float32", 7, 2, "feedback"),
         (256, 32000, 0, "bfloat16", 8, 0, "feedback"),
         (16, 384, 1, "float32", 7, 2, "feedback"),
         (8, 32000, 1, "bfloat16", 7, 2, "feedback"),
         (8, 65536, 0, "float32", 7, 2, "feedback"),
         (4, CLUSTER_D, 0, "bfloat16", 7, 2, "feedback"),
         (2, CLUSTER_D + 4, 0, "float32", 7, 2, "feedback"))


@pytest.mark.parametrize("rows,d,offset,dtype,p,iters,variant", CASES)
def test_wrapper_launches_once_with_the_plan(monkeypatch, rows, d, offset, dtype, p, iters,
                                             variant):
    """One launch a call, counted on ``launches``, with x and out's
    pointers, the recip ROM of the call's p, the datapath's settings, and the
    plan of d, the alignment and the rows."""
    lib = _stand_in(monkeypatch)
    dt = getattr(torch, dtype)
    x = torch.zeros(rows * d + offset, dtype=dt)[offset:].view(rows, d)
    before = softmax_kernel.launches
    out = softmax_kernel.gs_softmax(x, p=p, iters=iters, variant=variant)
    assert softmax_kernel.launches == before + 1
    assert out.shape == x.shape and out.dtype == x.dtype
    assert len(lib.launches) == 1
    (x_ptr, rom_ptr, out_ptr, rows_, d_, p_, iters_, pipelined, is_bf16, vector, vecs,
     row_threads, per_block, cluster_, grid, stream) = lib.launches.pop()
    assert (x_ptr, out_ptr, rows_, d_, stream) == (x.data_ptr(), out.data_ptr(), rows, d, 7)
    assert (p_, iters_, pipelined, is_bf16) == (p, iters, int(variant == "pipelined"),
                                                int(dtype == "bfloat16"))
    table = rom("recip", p, "cpu")
    assert rom_ptr == table.data_ptr() and table.shape == (2**p,)
    bits = (x.data_ptr() | out.data_ptr()) % 16
    plan = softmax_kernel.launch_plan(d, x.element_size(), bits)
    assert (vector, vecs, row_threads, per_block, cluster_) == (
        int(plan.width > 1), plan.vecs, plan.row_threads, plan.rows_per_block, plan.cluster)
    assert vector == int(offset == 0 and d % WIDTH[x.element_size()] == 0)
    assert cluster_ == (8 if d > BLOCK_D[True] and vector and d <= CLUSTER_D else 0)
    assert grid == softmax_kernel.grid_size(rows, plan, SMS, 5)


@pytest.mark.parametrize("shape", [(0, 384), (2, 0), (0,), (3, 0, 32000)])
def test_wrapper_makes_no_launch_for_an_empty_input(monkeypatch, shape):
    lib = _stand_in(monkeypatch)
    before = softmax_kernel.launches
    out = softmax_kernel.gs_softmax(torch.empty(shape), p=7, iters=2, variant="feedback")
    assert out.shape == shape and softmax_kernel.launches == before and not lib.launches


def test_occupancy_is_queried_once_per_device_and_instance(monkeypatch):
    lib = _KernelLibrary()
    props = []
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: props.append(device) or
                        type("Props", (), {"multi_processor_count": SMS}))
    monkeypatch.setattr(softmax_kernel, "_limits", {})
    dev = torch.device("cpu")
    cluster, block = _plan(8, 32000, F32), _plan(16, 384, F32)
    for _ in range(3):
        assert softmax_kernel.grid_limits(dev, False, cluster) == (SMS, 3)
        assert softmax_kernel.grid_limits(dev, False, block) == (SMS, 3)
    assert lib.queries == [(0, 1, 4, 8, 256), (0, 1, 1, 0, 96)] and len(props) == 2


# -- the arithmetic the kernel rests on -----------------------------------------

def _butterfly(lanes: np.ndarray) -> np.ndarray:
    """An xor butterfly over the last axis (32 lanes); asserts every lane
    ends with the same bits (NaN aside) and returns lane 0's."""
    o = 16
    while o:
        lanes = lanes + lanes[..., np.arange(32) ^ o]
        o //= 2
    assert (lanes == lanes[..., :1]).all() | np.isnan(lanes).any()
    return lanes[..., 0]


def kernel_sums(e: np.ndarray, plan) -> np.ndarray:
    """The kernel's row sums of f32 ``e`` (rows, d) under ``plan``: each
    thread adds its elements in order (vector lo + t + k·row_threads of its
    CTA's chunk, then the vector's elements) and an xor butterfly sums each
    warp; a block plan then adds its warps' values in order, a cluster plan
    lays the value of warp w of rank r at entry r·warps + w, lane l adds
    entries l, l + 32, ... in order from 0, and an xor butterfly sums the
    lanes.  Every add rounds to f32.  Asserts that every element is added
    once."""
    rows, d = e.shape
    width, rt = plan.width, plan.row_threads
    nvec = d // width
    ranks = max(plan.cluster, 1)
    chunk = -(-nvec // ranks)
    seen = np.zeros(d, np.int64)
    entries = []  # each warp's value, rank-major
    for rank in range(ranks):
        lo, hi = rank * chunk, min(nvec, (rank + 1) * chunk)
        acc = np.zeros((rows, rt), np.float32)
        vecs = plan.vecs or -(-max(hi - lo, 0) // rt)
        for k in range(vecs):
            v = lo + k * rt + np.arange(rt)
            lanes = np.nonzero(v < hi)[0]
            for j in range(width):
                cols = v[lanes] * width + j
                acc[:, lanes] = acc[:, lanes] + e[:, cols]
                seen[cols] += 1
        entries += list(_butterfly(acc.reshape(rows, rt // 32, 32)).T)
    assert (seen == 1).all()
    if not plan.cluster:
        total = entries[0]
        for w in entries[1:]:
            total = total + w
        return total
    lanes = np.zeros((rows, 32), np.float32)
    for i, w in enumerate(entries):
        lanes[:, i % 32] = lanes[:, i % 32] + w
    return _butterfly(lanes)


def emulated_softmax(x: np.ndarray, plan, p: int, iters: int, variant: str) -> torch.Tensor:
    """The kernel's arithmetic in f32: the row max (NaN if the row holds
    one), e = exp(x - M), the sum in the kernel's order, the plain version's
    Goldschmidt reciprocal of it, e · inv."""
    m = np.max(x, axis=-1, keepdims=True)
    with np.errstate(invalid="ignore"):
        e = np.exp(x - m).astype(np.float32)
    s = torch.from_numpy(kernel_sums(e, plan)).reshape(-1, 1)
    inv = common.recip_positive(s, rom("recip", p, "cpu"), p=p, iters=iters, variant=variant)
    return torch.from_numpy(e) * inv


def _gate(got: torch.Tensor, want: torch.Tensor) -> None:
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    fin = ~nan
    assert ((got - want).abs()[fin] <= chip_smoke.SOFTMAX_F32_RTOL * want[fin]).all()


def _gate_inputs():
    """chip_smoke.py's 8a softmax rows (SOFTMAX_SHAPES, the same numpy
    draws) with each one's plan on an H100, then (8, 32000) forced onto
    clusters of 2 and 4 CTAs and (8, 32000) one element into its storage."""
    _, rows = chip_smoke.bench_kernel_inputs()
    cases = [(x, _plan(*x.shape, F32)) for x in rows]
    wide = rows[chip_smoke.SOFTMAX_SHAPES.index((8, 32000))]
    cases += [(wide, _forced(32000, F32, size)) for size in (2, 4)]
    cases.append((wide, _plan(8, 32000, F32, aligned=False)))
    return cases


@pytest.mark.parametrize("p,iters,variant", F32_PRECISIONS)
def test_kernel_sum_order_stays_within_the_card_gate(p, iters, variant):
    """On chip_smoke.py's 8a inputs, every plan's sum order (the plain
    version's arithmetic with the row sum taken as the kernel adds) stays
    within SOFTMAX_F32_RTOL of the plain version elementwise, and the same
    sum gives the same output in every CTA of a row (it is one number a
    row); at the plain version's own sums the emulation is the plain
    version."""
    for x, plan in _gate_inputs():
        tx = torch.from_numpy(x)
        want = ref.softmax(tx, p=p, iters=iters, variant=variant)
        _gate(emulated_softmax(x, plan, p, iters, variant), want)
    e = torch.exp(tx - torch.amax(tx, dim=-1, keepdim=True))
    inv = common.recip_positive(e.sum(-1, keepdim=True), rom("recip", p, "cpu"), p=p,
                                iters=iters, variant=variant)
    assert torch.equal(e * inv, want)


def test_kernel_sum_order_at_a_decode_batch_of_256():
    """(256, 32000), 4 x randn: the order of the cluster of 8 and of the
    sweep's clusters of 2 and 4 within the gate."""
    x = (4 * np.random.RandomState(29).randn(256, 32000)).astype(np.float32)
    want = ref.softmax(torch.from_numpy(x), p=7, iters=2, variant="feedback")
    for plan in (_plan(256, 32000, F32), _forced(32000, F32, 2), _forced(32000, F32, 4)):
        _gate(emulated_softmax(x, plan, 7, 2, "feedback"), want)


@pytest.mark.parametrize("d", chip_smoke.SOFTMAX_MASKED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_rows_give_the_reference_nan_classes_and_zeros(d, dtype):
    """A leading -inf chunk, a row of -inf, a +inf and a NaN: the plain
    version, the reference's Pallas kernel (interpret mode) and, at f32, the
    kernel's emulation on its plan and on a cluster of 4 give NaN in the
    same places
    (the whole row for -inf everywhere or a NaN; the +inf's place, with
    exact zeros elsewhere) and 0 exactly where one does; the finite rest
    within 2^-12 of the reference's value (f32) or one ulp (bf16)."""
    x = chip_smoke.masked_rows(d)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    kw = dict(p=7, iters=2, variant="feedback")
    want = ref.softmax(tx, **kw)
    pallas = torch.from_numpy(np.array(
        jsoftmax._run(jnp.asarray(x).astype(dtype), block_rows=8, interpret=True,
                      **kw).astype(jnp.float32)))
    got = want.float()
    nan = torch.isnan(got)
    assert nan[1].all() and nan[3].all() and nan[0].sum() == 0
    assert nan[2].sum() == 1 and (got[2][~nan[2]] == 0).all()
    assert (got[0, :d // 2] == 0).all() and (got[0, d // 2:] > 0).all()
    assert torch.equal(torch.isnan(pallas), nan)
    assert torch.equal(pallas == 0, got == 0)
    fin = ~nan & (got > 0)
    if dtype == "float32":
        assert ((pallas - got).abs()[fin] <= 2.0**-12 * got[fin]).all()
        plans = [_plan(4, d, F32)] + ([_forced(d, F32, 4)] if d > BLOCK_D[True] else [])
        for plan in plans:
            _gate(emulated_softmax(x, plan, **kw), want)
    else:
        ulps = (pallas.to(torch.bfloat16).view(torch.int16).int()
                - want.view(torch.int16).int()).abs()
        assert (ulps[fin] <= 1).all()
