"""The launch plan that the recip and rsqrt kernels share
(``repro_torch.kernels.gs_elementwise``) and their plain versions on
storage-offset views, on the CPU.

The plan is pure Python: 16-byte vectors only when every operand is 16-byte
aligned, a grid of at least one block and at most SMs x resident blocks, and
no launch for an empty tensor.  The wrapper's arguments are checked here
against a stand-in for the kernel library; the kernels themselves are held
against the plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import gs_elementwise as elementwise_kernel  # noqa: E402


@pytest.mark.parametrize("dtype,width", [(torch.float32, 4), (torch.bfloat16, 8)])
def test_vector_width_only_when_every_pointer_is_aligned(dtype, width):
    size = torch.tensor([], dtype=dtype).element_size()
    assert elementwise_kernel.vector_width(size, 0, 16, 4096) == width
    assert elementwise_kernel.vector_width(size, 256) == width
    buf = torch.empty(64, dtype=dtype)
    assert buf.data_ptr() % 16 == 0
    assert elementwise_kernel.vector_width(size, buf.data_ptr(), buf[16 // size:].data_ptr()) \
        == width
    for off in range(1, 16 // size):
        view = buf[off:]
        assert view.is_contiguous()
        assert elementwise_kernel.vector_width(size, view.data_ptr()) == 1
        assert elementwise_kernel.vector_width(size, buf.data_ptr(), view.data_ptr()) == 1
        assert elementwise_kernel.vector_width(size, 0, 16 + off * size) == 1
        assert elementwise_kernel.vector_width(size, off * size, 0, 0) == 1


def test_grid_is_at_least_one_block_and_at_most_one_wave():
    threads = elementwise_kernel.THREADS
    for n in (1, 3, 7, 4097, 256 * 128, 4096 * 128, 65536 * 128):
        for width in (1, 4, 8):
            for sms, resident in ((132, 1), (132, 5), (132, 16), (1, 1)):
                grid = elementwise_kernel.grid_size(n, width, sms, resident)
                assert 1 <= grid <= sms * resident
                # enough threads for every vector, unless the wave is full
                assert grid * threads * width >= n or grid == sms * resident
                assert (grid - 1) * threads * width < n


def test_empty_tensor_makes_no_launch(monkeypatch):
    assert elementwise_kernel.grid_size(0, 4, 132, 8) == 0

    def no_library():
        raise AssertionError("an empty tensor loaded the kernel library")

    monkeypatch.setattr(build, "load", no_library)
    monkeypatch.setattr(elementwise_kernel, "check_operand", lambda x, kernel: False)
    before = elementwise_kernel.launches_rsqrt
    for mode in elementwise_kernel.MODES:
        out = elementwise_kernel.gs_rsqrt(torch.empty(0, 128), p=7, iters=2,
                                          variant="feedback", mode=mode)
        assert all(t.shape == (0, 128) for t in (out if mode == "sqrt_both" else (out,)))
    assert elementwise_kernel.launches_rsqrt == before
    before = elementwise_kernel.launches_recip
    out = elementwise_kernel.gs_recip(torch.empty(0, 128, dtype=torch.bfloat16), p=7,
                                      iters=2, variant="feedback")
    assert out.shape == (0, 128) and out.dtype == torch.bfloat16
    assert elementwise_kernel.launches_recip == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_rsqrt_on_storage_offset_views_matches_contiguous(dtype):
    r = np.random.RandomState(4)
    x = np.exp2(r.uniform(-60, 60, (33, 17))) * np.where(r.rand(33, 17) < 0.5, -1, 1)
    x = torch.from_numpy(x).float().to(dtype)
    ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for off in (1, 2, 3):
        buf = torch.empty(x.numel() + off, dtype=dtype)
        view = buf[off:].view(x.shape)
        view.copy_(x)
        assert view.is_contiguous() and view.storage_offset() == off
        for mode in elementwise_kernel.MODES:
            got = ref.rsqrt(view, p=7, iters=2, variant="feedback", mode=mode)
            want = ref.rsqrt(x, p=7, iters=2, variant="feedback", mode=mode)
            for a, b in zip(*((got, want) if mode == "sqrt_both" else ((got,), (want,)))):
                same = (a.view(ints) == b.view(ints)) | (torch.isnan(a) & torch.isnan(b))
                assert bool(same.all()), (mode, off)


def _bit_equal(a, b):
    ints = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    same = (a.view(ints) == b.view(ints)) | (torch.isnan(a) & torch.isnan(b))
    return a.dtype == b.dtype and bool(same.all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_reciprocal_on_storage_offset_views_matches_contiguous(dtype):
    r = np.random.RandomState(5)
    x = np.exp2(r.uniform(-130, 130, (33, 17))) * np.where(r.rand(33, 17) < 0.5, -1, 1)
    x.flat[:6] = [0.0, -0.0, np.inf, -np.inf, np.nan, 2.0**127]
    x = torch.from_numpy(x).float().to(dtype)
    want = ref.reciprocal(x, p=7, iters=2, variant="feedback")
    for off in (1, 2, 3):
        buf = torch.empty(x.numel() + off, dtype=dtype)
        view = buf[off:].view(x.shape)
        view.copy_(x)
        assert view.is_contiguous() and view.storage_offset() == off
        assert _bit_equal(ref.reciprocal(view, p=7, iters=2, variant="feedback"), want), off


class _KernelLibrary:
    """Records the arguments of each launch; returns cudaSuccess."""

    def __init__(self):
        self.launches = []

    def gs_elementwise_launch(self, *args):
        self.launches.append(args)
        return 0


@pytest.mark.parametrize("op", elementwise_kernel.OPS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_launches_the_shared_plan(monkeypatch, op, dtype):
    """Each op's wrapper passes its op code, its ROM, 16-byte vectors only
    when x and every output are aligned, and a grid between 1 and SMs x
    resident blocks; one launch counted on its own kernel's counter."""
    lib = _KernelLibrary()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(elementwise_kernel, "check_operand",
                        lambda x, kernel: x.dtype == torch.bfloat16)
    monkeypatch.setattr(elementwise_kernel, "grid_limits",
                        lambda device, op_, is_bf16, width: (3, 2))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 7,
                        raising=False)
    counter = "launches_recip" if op == "recip" else "launches_rsqrt"
    vec = 16 // torch.tensor([], dtype=dtype).element_size()
    kw = dict(p=7, iters=2, variant="pipelined")
    buf = torch.ones(4096 + 3, dtype=dtype)
    for n, off in ((4096, 0), (4096, 1), (4096, 3), (vec + 1, 0), (1, 0), (2000 * 128, 0)):
        if n > buf.numel() - off:
            buf = torch.ones(n, dtype=dtype)
        x = buf[off:off + n]
        before = getattr(elementwise_kernel, counter)
        if op == "recip":
            outs = (elementwise_kernel.gs_recip(x, **kw),)
        else:
            outs = elementwise_kernel.gs_rsqrt(x, mode=op, **kw)
            outs = outs if op == "sqrt_both" else (outs,)
        assert getattr(elementwise_kernel, counter) == before + 1
        args = lib.launches.pop()
        (code, x_ptr, rom_ptr, out0, out1, n_, p, iters, pipelined, scale, is_bf16, vector,
         grid, stream) = args
        assert (code, x_ptr, n_, p, iters, pipelined, stream) == (
            elementwise_kernel.OPS.index(op), x.data_ptr(), n, 7, 2, 1, 7)
        assert out0 == outs[0].data_ptr() and is_bf16 == int(dtype == torch.bfloat16)
        assert out1 == (outs[1].data_ptr() if op == "sqrt_both" else None)
        table = elementwise_kernel.rom("recip" if op == "recip" else "rsqrt", 7, "cpu")
        assert rom_ptr == table.data_ptr() and scale == 2.0**7 / 3.0
        aligned = all(t.data_ptr() % 16 == 0 for t in (x,) + tuple(outs))
        assert vector == int(aligned) and aligned == (off == 0)
        width = vec if aligned else 1
        assert 1 <= grid <= 3 * 2
        assert grid == min(-(-n // (width * elementwise_kernel.THREADS)), 3 * 2)
