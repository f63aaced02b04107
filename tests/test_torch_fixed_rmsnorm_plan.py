"""The launch plan of the int8 rmsnorm kernel (``gs_fixed_rmsnorm`` in
``repro_torch.kernels.gs_fixed``) and its wrapper's arguments, on the CPU.

The plan is pure Python: 16-byte vectors of 16 codes only when d is a
multiple of 16 and every pointer is 16-byte aligned, the row covered by
threads x 16 x vectors, rows past the largest register plan on the looping
instance, a grid of at least one block and at most SMs x resident blocks,
and no launch for an empty input.  The wrapper's arguments are checked here
against a stand-in for the kernel library; the kernel itself is held
bit for bit against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core.fixed_point_torch import rom_words  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import gs_fixed as fixed_kernel  # noqa: E402
from repro_torch.kernels import gs_rmsnorm as rms_kernel  # noqa: E402

CODES = 16  # int8 codes in a 16-byte vector
# the widest rows that stay in registers: 512 threads x 2 vectors of 16
# codes, 512 x 8 single codes
REGISTER_PLAN_D = {CODES: 16384, 1: 4096}
DS = (1, 16, 37, 64, 200, 208, 2048, 4096, 4097, 5632, 8192, 16384, 16400, 32768, 1 << 17)


def test_vectors_only_when_d_divides_by_16_and_every_pointer_is_aligned():
    for d in (16, 2048, 8192, 16400):
        assert fixed_kernel.launch_plan(d, 0).width == CODES, d
    for d in (1, 8, 37, 200, 2048 + 4, 4097):
        assert fixed_kernel.launch_plan(d, 0).width == 1, d
    buf = torch.empty(4096 + 16, dtype=torch.int8)
    assert buf.data_ptr() % 16 == 0
    for off in range(1, 16):
        view = buf[off:off + 2048]
        assert view.is_contiguous()
        assert fixed_kernel.launch_plan(2048, view.data_ptr() % 16).width == 1, off
    # an aligned x with a gain or an output 4 bytes off
    assert fixed_kernel.launch_plan(2048, (0 | buf.data_ptr() | 4) % 16).width == 1


@pytest.mark.parametrize("width", [1, CODES])
def test_threads_times_codes_times_vectors_cover_the_row(width):
    for d in DS:
        if d % width:
            continue
        plan = fixed_kernel.launch_plan(d, 0 if width > 1 else 1)
        assert plan.width == width, d
        assert plan.row_threads % 32 == 0 and 32 <= plan.row_threads <= rms_kernel.MAX_THREADS
        assert plan.threads <= rms_kernel.MAX_THREADS
        if d > REGISTER_PLAN_D[width]:
            assert plan.vecs == 0, d
            continue
        assert plan.vecs in rms_kernel.VECS and plan.vecs * width <= 32, d
        assert plan.row_threads * width * plan.vecs >= d, d
        # no whole warp idle
        assert (plan.row_threads - 32) * width * plan.vecs < d or plan.row_threads == 32, d


@pytest.mark.parametrize("width", [1, CODES])
def test_rows_past_the_register_plan_take_the_looping_instance(width):
    widest = REGISTER_PLAN_D[width]
    ptr_bits = 0 if width > 1 else 1
    plan = fixed_kernel.launch_plan(widest, ptr_bits)
    assert plan.vecs > 0 and plan.row_threads * width * plan.vecs == widest
    past = fixed_kernel.launch_plan(widest + width, ptr_bits)
    assert (past.vecs, past.row_threads) == (0, rms_kernel.MAX_THREADS)


def test_decode_and_prefill_rows_take_one_vector_a_thread_in_four_warps():
    """d 2048, the model's width: 128 threads a row, one 16-code vector each."""
    plan = fixed_kernel.launch_plan(2048, 0)
    assert (plan.width, plan.vecs, plan.row_threads, plan.rows_per_block) == (CODES, 1, 128, 1)


def test_grid_is_at_least_one_block_and_fits_the_limits():
    for d in (37, 200, 2048, 8192, 16400):
        plan = fixed_kernel.launch_plan(d, 0)
        assert rms_kernel.grid_size(0, plan.rows_per_block, 132, 8) == 0
        for rows in (1, 4, 333, 2048, 100_000):
            for sms, resident in ((132, 1), (132, 4), (132, 16), (1, 1)):
                grid = rms_kernel.grid_size(rows, plan.rows_per_block, sms, resident)
                assert 1 <= grid <= sms * resident
                assert grid * plan.rows_per_block >= rows or grid == sms * resident
                assert (grid - 1) * plan.rows_per_block < rows


class _KernelLibrary:
    """Records the arguments of each launch; returns cudaSuccess."""

    def __init__(self):
        self.launches = []

    def gs_fixed_rmsnorm_launch(self, *args):
        self.launches.append(args)
        return 0


def _stand_in(monkeypatch):
    lib = _KernelLibrary()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(fixed_kernel, "_check", lambda *args: None)
    monkeypatch.setattr(fixed_kernel, "grid_limits", lambda device, plan: (3, 2))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 7,
                        raising=False)
    return lib


# (rows, d, storage offset of x, p, frac_bits, iters): decode, prefill, the
# training batch, p 12, the Mitchell format's (7, 24), frac 30, narrow and
# ragged rows, an offset view, and rows past both register plans
CASES = ((4, 2048, 0, 8, 24, 0), (333, 2048, 0, 8, 24, 0), (2048, 2048, 0, 8, 24, 0),
         (333, 2048, 0, 12, 24, 0), (4, 2048, 0, 7, 24, 2), (4, 2048, 0, 8, 30, 0),
         (5, 37, 0, 8, 24, 0), (13, 200, 0, 8, 24, 0), (3, 2048, 1, 8, 24, 0),
         (3, 8192, 0, 8, 24, 0), (2, 16400, 0, 8, 24, 0), (2, 4097, 0, 8, 24, 0))


@pytest.mark.parametrize("rows,d,offset,p,frac_bits,iters", CASES)
def test_wrapper_launches_once_with_the_plan(monkeypatch, rows, d, offset, p, frac_bits,
                                             iters):
    """One launch a call, counted on ``launches_rmsnorm``, with x, scale,
    gain and out's pointers, the rsqrt words of the call's p and frac_bits,
    1/d and eps, and the launch plan of d and the alignment."""
    lib = _stand_in(monkeypatch)
    buf = torch.ones(rows * d + offset, dtype=torch.int8)
    x = buf[offset:].view(rows, d)
    gain = torch.ones(d)
    scale = torch.tensor([0.02])
    before = fixed_kernel.launches_rmsnorm
    out = fixed_kernel.gs_fixed_rmsnorm(x, scale, gain, eps=1e-5, p=p, frac_bits=frac_bits,
                                        iters=iters)
    assert fixed_kernel.launches_rmsnorm == before + 1
    assert out.shape == x.shape and out.dtype == torch.float32
    assert len(lib.launches) == 1
    (x_ptr, scale_ptr, gain_ptr, words_ptr, out_ptr, rows_, d_, inv_d, eps, frac_, p_, iters_,
     vector, vecs, row_threads, per_block, grid, stream) = lib.launches.pop()
    assert (x_ptr, scale_ptr, gain_ptr, out_ptr, rows_, d_, stream) == (
        x.data_ptr(), scale.data_ptr(), gain.data_ptr(), out.data_ptr(), rows, d, 7)
    assert (inv_d, eps, frac_, p_, iters_) == (1.0 / d, 1e-5, frac_bits, p, iters)
    words = fixed_kernel.rom_words_u32("rsqrt", p, frac_bits, x.device)
    assert words_ptr == words.data_ptr()
    assert words.dtype == torch.int32 and words.shape == (2**p,)
    assert torch.equal(words.long(), rom_words("rsqrt", p, frac_bits, "cpu"))
    aligned = offset == 0 and d % CODES == 0
    assert vector == int(aligned)
    plan = fixed_kernel.launch_plan(
        d, (x.data_ptr() | gain.data_ptr() | out.data_ptr()) % 16)
    assert (plan.width == CODES) == aligned
    assert (vecs, row_threads, per_block) == (plan.vecs, plan.row_threads, plan.rows_per_block)
    assert (vecs == 0) == (d > REGISTER_PLAN_D[plan.width])
    assert vecs == 0 or row_threads * plan.width * vecs >= d
    assert grid == rms_kernel.grid_size(rows, per_block, 3, 2)
    assert 1 <= grid <= 3 * 2


def test_rsqrt_words_are_built_once_per_format_and_device():
    cpu = torch.device("cpu")
    for p, frac_bits in ((8, 24), (7, 24), (8, 30), (12, 24)):
        words = fixed_kernel.rom_words_u32("rsqrt", p, frac_bits, cpu)
        assert words is fixed_kernel.rom_words_u32("rsqrt", p, frac_bits, cpu)
        assert words is not fixed_kernel.rom_words_u32("recip", p, frac_bits, cpu)
        assert torch.equal(words.long(), rom_words("rsqrt", p, frac_bits, "cpu"))


def test_wrapper_makes_no_launch_for_zero_rows(monkeypatch):
    _stand_in(monkeypatch)

    def no_library(*args):
        raise AssertionError("an empty input loaded the kernel library")

    monkeypatch.setattr(build, "load", no_library)
    monkeypatch.setattr(fixed_kernel, "grid_limits", no_library)
    before = fixed_kernel.launches_rmsnorm
    out = fixed_kernel.gs_fixed_rmsnorm(torch.empty(0, 2048, dtype=torch.int8), 0.02,
                                        torch.ones(2048), eps=1e-5, p=8, frac_bits=24, iters=0)
    assert out.shape == (0, 2048) and out.dtype == torch.float32
    assert fixed_kernel.launches_rmsnorm == before


def test_wrapper_refuses_rows_wider_than_the_exact_sum(monkeypatch):
    _stand_in(monkeypatch)
    d = fixed_kernel.MAX_RMSNORM_D + 16
    with pytest.raises(ValueError, match="at most"):
        fixed_kernel.gs_fixed_rmsnorm(torch.ones(1, d, dtype=torch.int8), 0.02, torch.ones(d),
                                      eps=1e-5, p=8, frac_bits=24, iters=0)


def test_wrapper_raises_on_a_cpu_non_int8_or_non_contiguous_x():
    kw = dict(eps=1e-5, p=8, frac_bits=24, iters=0)
    with pytest.raises(ValueError, match="CUDA"):
        fixed_kernel.gs_fixed_rmsnorm(torch.ones(2, 64, dtype=torch.int8), 0.02,
                                      torch.ones(64), **kw)
    with pytest.raises(ValueError, match="CUDA"):
        fixed_kernel.gs_fixed_rmsnorm(torch.ones(2, 64), 0.02, torch.ones(64), **kw)


@pytest.mark.parametrize("bad", ["float", "strided"])
def test_wrapper_raises_on_a_non_int8_or_non_contiguous_x(monkeypatch, bad):
    """Past the device check (a stand-in CUDA tensor), x must be contiguous
    int8: the wrapper raises and launches nothing."""
    lib = _KernelLibrary()
    monkeypatch.setattr(build, "load", lambda: lib)
    x = (torch.ones(2, 64) if bad == "float"
         else torch.ones(2, 128, dtype=torch.int8)[:, ::2])
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    with pytest.raises(TypeError, match="contiguous int8"):
        fixed_kernel.gs_fixed_rmsnorm(x, 0.02, torch.ones(64), eps=1e-5, p=8, frac_bits=24,
                                      iters=0)
    assert lib.launches == []
