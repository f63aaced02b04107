"""The launch plan of the rmsnorm kernel (``repro_torch.kernels.gs_rmsnorm``)
and its wrapper's arguments, on the CPU.

The plan is pure Python: 16-byte vectors only when d is a multiple of the
width and every pointer is 16-byte aligned, the row covered by threads x
width x vectors, rows past the largest register plan on the looping
instance, a grid of at least one block and at most SMs x resident blocks,
and no launch for an empty input.  The wrapper's arguments are checked here
against a stand-in for the kernel library; the kernel itself is held
against the plain version on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import gs_rmsnorm as rms_kernel  # noqa: E402

WIDTHS = {torch.float32: 4, torch.bfloat16: 8}
# the widest rows that stay in registers: 512 threads x 32 elements at
# 16-byte vectors, 512 x 8 at one element
REGISTER_PLAN_D = {4: 16384, 8: 16384, 1: 4096}
DS = (1, 8, 37, 64, 72, 200, 256, 2048, 4096, 5632, 8192, 16384, 16388, 16392, 4097, 32768)


def _itemsize(dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vector_width_only_when_d_divides_and_every_pointer_is_aligned(dtype):
    size, width = _itemsize(dtype), WIDTHS[dtype]
    assert rms_kernel.vector_width(size, 2048, 0, 16, 4096) == width
    assert rms_kernel.vector_width(size, width, 256) == width
    for d in (width + 1, 37, 2048 + width // 2, 1):
        assert rms_kernel.vector_width(size, d, 0, 16, 4096) == 1, d
    buf = torch.empty(4096, dtype=dtype)
    assert buf.data_ptr() % 16 == 0
    for off in range(1, 16 // size):
        view = buf[off:off + 2048]
        assert view.is_contiguous()
        assert rms_kernel.vector_width(size, 2048, view.data_ptr()) == 1
        assert rms_kernel.vector_width(size, 2048, buf.data_ptr(), view.data_ptr()) == 1
        assert rms_kernel.vector_width(size, 2048, 0, 0, off * size) == 1


@pytest.mark.parametrize("width", [1, 4, 8])
def test_row_plan_covers_the_row_in_registers(width):
    for d in DS:
        if d % width:
            continue
        vecs, threads = rms_kernel.row_plan(d, width)
        assert threads % 32 == 0 and 32 <= threads <= rms_kernel.MAX_THREADS
        if d > REGISTER_PLAN_D[width]:
            assert (vecs, threads) == (0, rms_kernel.MAX_THREADS), d
            continue
        assert vecs in rms_kernel.VECS and vecs * width <= rms_kernel.MAX_ELEMENTS, d
        assert threads * width * vecs >= d, d
        # no whole warp idle, and no fewer vectors a thread would do in the
        # threads the plan aims for
        assert (threads - 32) * width * vecs < d or threads == 32, d
        smaller = [v for v in rms_kernel.VECS if v < vecs]
        assert all(32 * -(-d // (width * v * 32)) > rms_kernel.ROW_THREADS for v in smaller), d


@pytest.mark.parametrize("width", [1, 4, 8])
def test_rows_past_the_register_plan_take_the_looping_instance(width):
    widest = REGISTER_PLAN_D[width]
    vecs, threads = rms_kernel.row_plan(widest, width)
    assert vecs > 0 and threads * width * vecs == widest
    assert rms_kernel.row_plan(widest + width, width) == (0, rms_kernel.MAX_THREADS)


def test_narrow_rows_share_a_block_of_the_planned_threads():
    # (d, itemsize, a pointer): f32 and bf16 rows, aligned or one f32 in
    for d, itemsize, ptr, width in ((37, 4, 0, 1), (72, 4, 0, 4), (72, 4, 4, 1),
                                    (200, 4, 0, 4), (200, 2, 0, 8), (2048, 4, 0, 4),
                                    (2048, 2, 0, 8), (8192, 4, 0, 4), (4097, 4, 0, 1)):
        plan = rms_kernel.launch_plan(d, itemsize, ptr)
        assert plan.width == width, d
        assert plan.rows_per_block == max(1, rms_kernel.ROW_THREADS // plan.row_threads)
        assert plan.threads <= max(rms_kernel.ROW_THREADS, plan.row_threads)
        assert plan.threads <= rms_kernel.MAX_THREADS


def test_grid_is_at_least_one_block_and_fits_the_limits():
    assert rms_kernel.grid_size(0, 1, 132, 8) == 0
    for rows in (1, 3, 4, 97, 333, 2048, 100_000):
        for per_block in (1, 2, 4):
            for sms, resident in ((132, 1), (132, 9), (132, 16), (1, 1)):
                grid = rms_kernel.grid_size(rows, per_block, sms, resident)
                assert 1 <= grid <= sms * resident
                # a block for every row group, unless the wave is full
                assert grid * per_block >= rows or grid == sms * resident
                assert (grid - 1) * per_block < rows


class _KernelLibrary:
    """Records the arguments of each launch; returns cudaSuccess."""

    def __init__(self):
        self.launches = []

    def gs_rmsnorm_launch(self, *args):
        self.launches.append(args)
        return 0


def _stand_in(monkeypatch):
    lib = _KernelLibrary()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(rms_kernel, "check_operands",
                        lambda x, gain: x.dtype == torch.bfloat16)
    monkeypatch.setattr(rms_kernel, "grid_limits", lambda device, is_bf16, plan: (3, 2))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 7,
                        raising=False)
    return lib


@pytest.mark.parametrize("save_inv", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_launches_once_with_the_plan(monkeypatch, dtype, save_inv):
    """One launch a call, counted on ``launches``, with x, gain, out and the
    rsqrt column's pointers, the rsqrt table of the call's p, the datapath
    settings, and the launch plan of d, the dtype and the alignment."""
    lib = _stand_in(monkeypatch)
    width = WIDTHS[dtype]
    gain_buf = torch.ones(16392 + 1)
    cases = ((4, 2048, 0, 7, "feedback"), (333, 2048, 0, 12, "pipelined"),
             (5, 37, 0, 8, "feedback"), (13, 200, 0, 7, "pipelined"), (3, 2048, 1, 7, "feedback"),
             (2, 16392, 0, 7, "feedback"), (2, 4097, 0, 9, "feedback"), (1, 2048, 0, 5, "feedback"))
    for rows, d, off, p, variant in cases:
        buf = torch.ones(rows * d + off, dtype=dtype)
        x = buf[off:].view(rows, d)
        gain = gain_buf[:d]
        before = rms_kernel.launches
        result = rms_kernel.gs_rmsnorm(x, gain, eps=1e-5, p=p, iters=1, variant=variant,
                                       save_inv=save_inv)
        assert rms_kernel.launches == before + 1
        out, inv = result if save_inv else (result, None)
        assert out.shape == x.shape and out.dtype == dtype
        assert len(lib.launches) == 1
        (x_ptr, gain_ptr, rom_ptr, out_ptr, inv_ptr, rows_, d_, inv_d, eps, p_, iters,
         pipelined, scale, is_bf16, vector, vecs, row_threads, per_block, grid,
         stream) = lib.launches.pop()
        assert (x_ptr, gain_ptr, out_ptr, rows_, d_, p_, iters, stream) == (
            x.data_ptr(), gain.data_ptr(), out.data_ptr(), rows, d, p, 1, 7)
        assert inv_ptr == (inv.data_ptr() if save_inv else None)
        if save_inv:
            assert inv.shape == (rows, 1) and inv.dtype == torch.float32
        assert rom_ptr == rms_kernel.rom("rsqrt", p, "cpu").data_ptr()
        assert (inv_d, eps, scale) == (1.0 / d, 1e-5, 2.0**p / 3.0)
        assert pipelined == int(variant == "pipelined")
        assert is_bf16 == int(dtype == torch.bfloat16)
        aligned = off == 0 and d % width == 0
        assert vector == int(aligned)
        plan = rms_kernel.launch_plan(d, x.element_size(),
                                      (x.data_ptr() | gain.data_ptr() | out.data_ptr()) % 16)
        assert (plan.width > 1) == aligned
        assert (vecs, row_threads, per_block) == plan[1:]
        assert (vecs == 0) == (d > REGISTER_PLAN_D[plan.width])
        assert vecs == 0 or row_threads * plan.width * vecs >= d
        assert grid == rms_kernel.grid_size(rows, per_block, 3, 2)
        assert 1 <= grid <= 3 * 2


def test_wrapper_makes_no_launch_for_zero_rows(monkeypatch):
    _stand_in(monkeypatch)

    def no_library():
        raise AssertionError("an empty input loaded the kernel library")

    monkeypatch.setattr(build, "load", no_library)
    monkeypatch.setattr(rms_kernel, "grid_limits", lambda *a: no_library())
    before = rms_kernel.launches
    for dtype in (torch.float32, torch.bfloat16):
        out, inv = rms_kernel.gs_rmsnorm(torch.empty(0, 2048, dtype=dtype), torch.ones(2048),
                                         eps=1e-5, p=7, iters=2, variant="feedback",
                                         save_inv=True)
        assert out.shape == (0, 2048) and out.dtype == dtype and inv.shape == (0, 1)
    assert rms_kernel.launches == before


def test_rsqrt_table_is_the_rom_of_the_call_p():
    cpu = torch.device("cpu")
    for p in (5, 7, 8, 12):
        table = rms_kernel.rsqrt_table(p, cpu)
        assert table is rms_kernel.rsqrt_table(p, cpu)
        assert table.shape == (2**p,) and table.dtype == torch.float32
        assert torch.equal(table, rms_kernel.rom("rsqrt", p, "cpu"))


def test_wrapper_raises_on_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        rms_kernel.gs_rmsnorm(torch.randn(2, 64), torch.ones(64), eps=1e-6, p=7, iters=2,
                              variant="feedback")
