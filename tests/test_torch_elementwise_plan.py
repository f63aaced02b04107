"""The rsqrt kernel's launch plan (``repro_torch.kernels.gs_elementwise``) and
its plain version on storage-offset views, on the CPU.

The plan is pure Python: 16-byte vectors only when every operand is 16-byte
aligned, a grid of at least one block and at most SMs x resident blocks, and
no launch for an empty tensor.  The kernel itself is held against the plain
version on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
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
    threads = elementwise_kernel.RSQRT_THREADS
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
