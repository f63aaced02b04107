"""The launch plan of the int8 reciprocal kernel (``gs_fixed_recip`` in
``repro_torch.kernels.gs_fixed``), its wrapper's arguments and the facts
its arithmetic rests on, on the CPU.

The plan is pure Python: 32-bit words of four codes only when n >= 4, x is
4-byte and out 16-byte aligned; 4 words a lane when their trips fill two
waves of resident blocks, else 1; the kernel's grid-stride loop
over threads x words x 4 codes, plus the n % 4 tail, covering every code
once; a grid of at least one block and at most SMs x resident blocks; no
launch for an empty input.  The wrapper's arguments are checked against a
stand-in for the kernel library: one launch a call, with the scale
operand itself (the kernel rounds 1/scale).  The plain version is held bit
for bit against the reference's Pallas kernel over all 256 codes, and
torch's ``1.0 / scale`` against IEEE f32 division, the rounding the kernel's
``__frcp_rn`` gives.  The kernel itself is held against the plain version
on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jnp = pytest.importorskip("jax.numpy")

from repro.core import formats as jformats  # noqa: E402
from repro.kernels import gs_fixed as jfixed  # noqa: E402
from repro_torch.core import formats  # noqa: E402
from repro_torch.core.fixed_point_torch import rom_words  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import gs_fixed as fixed_kernel  # noqa: E402
from repro_torch.kernels import gs_rmsnorm as rms_kernel  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

WORD = 4  # int8 codes in a 32-bit word
THREADS = 128  # kThreads in csrc/gs_fixed.cu
# chip_smoke.py's FIXED_RECIP_SCALES: both signs, a scale whose 1/scale
# rounds, and powers of two far from 1
SCALES = (0.02, -0.02, 4 / 127, 1.0, 2.0 ** -20, 2.0 ** 20)
CODES = np.arange(-128, 128).astype(np.int8)


def _formats(m):
    """benchmarks/bench_kernels.py's three fixed formats, from module ``m``."""
    return {"frac24": m.format_for("int8"), "frac30": m.NumericFormat.fixed(30),
            "mitchell": m.NumericFormat.fixed(24, p=7, mitchell_iters=1)}


def test_words_only_when_n_and_every_pointer_allow_them():
    for n in (4, 5, 7, 128, 32768, 1 << 23):
        assert fixed_kernel.recip_width(n, 0, 0) == WORD, n
        assert fixed_kernel.recip_width(n, 4, 0) == WORD, n  # x 4-byte aligned
        assert fixed_kernel.recip_width(n, 12, 0) == WORD, n
    for n in (1, 2, 3):  # no whole word
        assert fixed_kernel.recip_width(n, 0, 0) == 1, n
    for x_bits in (1, 2, 3, 5, 6, 7, 9, 15):
        assert fixed_kernel.recip_width(128, x_bits, 0) == 1, x_bits
    for out_bits in (4, 8, 12):  # float4 stores need a 16-byte aligned out
        assert fixed_kernel.recip_width(128, 0, out_bits) == 1, out_bits
    buf = torch.empty(4096 + 16, dtype=torch.int8)
    assert buf.data_ptr() % 16 == 0
    for off in range(16):
        view = buf[off:off + 2048]
        want = WORD if off % WORD == 0 else 1
        assert fixed_kernel.recip_width(view.numel(), view.data_ptr() % 16, 0) == want, off


def _launch(n: int, sms: int, resident: int, monkeypatch, width: int = WORD):
    """recip_launch's (plan, grid) for ``n`` codes at ``width`` on a card of
    ``sms`` SMs holding ``resident`` blocks of every instance."""
    monkeypatch.setattr(fixed_kernel, "grid_limits",
                        lambda device, plan, kernel="rmsnorm": (sms, resident))
    return fixed_kernel.recip_launch(n, 0 if width == WORD else 1, 0, torch.device("cpu"))


WAVE = THREADS * 132 * 8  # a wave's lanes on 132 SMs holding 8 blocks


@pytest.mark.parametrize("n,words", [(4, 1), (256 * 128, 1), (2 * WORD * 2 * WAVE, 1),
                                     (2 * WORD * 4 * WAVE - 4, 1), (2 * WORD * 4 * WAVE, 4),
                                     (2 * WORD * 8 * WAVE, 4), (65536 * 128, 4)])
def test_the_most_words_whose_trips_fill_two_waves(monkeypatch, n, words):
    """On a card of 132 SMs holding 8 blocks of 128 threads: the benchmark's
    (256, 128) keeps a word a lane in 64 blocks; n whose words fill two
    waves of the 4-word instance take it, in a grid of one wave, and no n
    takes more; (65536, 128) takes 4 words a lane."""
    plan, grid = _launch(n, 132, 8, monkeypatch)
    assert (plan.width, plan.vecs, plan.threads) == (WORD, words, THREADS)
    assert plan == fixed_kernel.recip_plan(WORD, words)
    nvec = n // WORD
    if words > 1:
        assert nvec >= 2 * words * WAVE and grid == 132 * 8
    more = [w for w in fixed_kernel.RECIP_WORDS if w > words]
    assert all(nvec < 2 * w * WAVE for w in more)
    if words == 1:
        assert grid == rms_kernel.grid_size(nvec, THREADS, 132, 8)
    assert (_launch(256 * 128, 132, 8, monkeypatch)[1]) == 64


@pytest.mark.parametrize("width", [1, WORD])
def test_grid_is_at_least_one_block_and_fits_the_limits(monkeypatch, width):
    for n in (4, 5, 131, 512, 4097, 32768, 1 << 20, 1 << 23):
        for sms, resident in ((132, 1), (132, 16), (1, 1), (3, 2)):
            plan, grid = _launch(n, sms, resident, monkeypatch, width)
            assert plan.width == width and plan.vecs in fixed_kernel.RECIP_WORDS
            assert 1 <= grid <= sms * resident
            nvec = n // width
            assert (grid - 1) * THREADS * plan.vecs < nvec  # no block without a vector


def _covered(n: int, width: int, words: int, grid: int) -> np.ndarray:
    """How often the kernel's loop touches each of ``n`` codes: thread t of
    block b takes the vectors b·T·words + t + k·T (k < words) of each trip,
    the trips a grid's T·words·grid vectors apart, then the first block's
    threads one code each of a word launch's n % 4 tail."""
    hits = np.zeros(n, np.int64)
    nvec = n // width
    chunk, stride = THREADS * words, grid * THREADS * words
    for b in range(grid):
        for t in range(THREADS):
            base = b * chunk + t
            while base < nvec:
                for k in range(words):
                    v = base + k * THREADS
                    if v < nvec:
                        hits[v * width:(v + 1) * width] += 1
                base += stride
            i = nvec * width + t
            if width > 1 and b == 0 and i < n:
                hits[i] += 1
    return hits


@pytest.mark.parametrize("n", [1, 3, 4, 7, 9, 999, 2051, 4099, 4097, 32771])
@pytest.mark.parametrize("sms,resident", [(1, 1), (3, 2)])
def test_threads_times_words_times_codes_and_the_tail_cover_every_code_once(
        monkeypatch, n, sms, resident):
    """Each plan the wrapper picks, on small grids (one block makes many
    trips), touches every code exactly once; the word launches at every
    words value are reached."""
    for width in (1, WORD):
        plan, grid = _launch(n, sms, resident, monkeypatch, width)
        if n < WORD:
            assert plan.width == 1
        assert (_covered(n, plan.width, plan.vecs, grid) == 1).all(), (n, width, plan, grid)
        for words in fixed_kernel.RECIP_WORDS if plan.width == WORD else ():  # forced
            forced = rms_kernel.grid_size(n // plan.width, THREADS * words, sms, resident)
            assert (_covered(n, plan.width, words, forced) == 1).all(), (n, width, words)


def test_one_block_reaches_every_word_instance(monkeypatch):
    """chip_smoke.py's one-block cases (one SM holding one block) take 4
    words a lane over many trips and at the threshold, and 1 word; a word
    below the threshold takes 1."""
    got = [_launch(n, 1, 1, monkeypatch)[0].vecs for n in (32771, 4099, 4095, 999)]
    assert got == [4, 4, 1, 1]


class _KernelLibrary:
    """Records the arguments of each launch; returns cudaSuccess."""

    def __init__(self):
        self.launches = []

    def gs_fixed_recip_launch(self, *args):
        self.launches.append(args)
        return 0


def _stand_in(monkeypatch):
    lib = _KernelLibrary()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(fixed_kernel, "_check", lambda *args: None)
    monkeypatch.setattr(fixed_kernel, "grid_limits",
                        lambda device, plan, kernel="rmsnorm": (3, 2))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 7,
                        raising=False)
    return lib


# (shape, storage offset of x, p, frac_bits, iters, mitchell_iters, variant):
# the benchmark's shapes at p 8 and p 12, the three formats, every code,
# views 1, 2, 3 and 4 bytes in, lengths below and just past a word, and a
# length with a tail
CASES = (((256, 128), 0, 8, 24, 0, 0, "feedback"), ((65536, 128), 0, 8, 24, 0, 0, "feedback"),
         ((256, 128), 0, 12, 24, 0, 0, "feedback"), ((256, 128), 0, 8, 30, 0, 0, "pipelined"),
         ((256, 128), 0, 7, 24, 2, 1, "pipelined"), ((256,), 0, 8, 24, 0, 0, "feedback"),
         ((256, 128), 1, 8, 24, 0, 0, "feedback"), ((256, 128), 2, 8, 24, 0, 0, "feedback"),
         ((256, 128), 3, 8, 24, 0, 0, "feedback"), ((256, 128), 4, 8, 24, 0, 0, "feedback"),
         ((3,), 0, 8, 24, 0, 0, "feedback"), ((5,), 0, 8, 24, 0, 0, "feedback"),
         ((4097,), 0, 8, 24, 0, 0, "feedback"), ((3, 5, 40), 0, 12, 30, 1, 0, "feedback"))


@pytest.mark.parametrize("shape,offset,p,frac_bits,iters,mitchell,variant", CASES)
def test_wrapper_launches_once_with_the_plan(monkeypatch, shape, offset, p, frac_bits, iters,
                                             mitchell, variant):
    """One launch a call, counted on ``launches_recip``, with x's and out's
    pointers, the scale operand's own pointer (no reciprocal tensor: the
    kernel rounds 1/scale), the recip words of the call's p and frac_bits,
    the datapath's settings, and the plan of n and the alignment."""
    lib = _stand_in(monkeypatch)
    n = int(np.prod(shape))
    buf = torch.ones(n + offset, dtype=torch.int8)
    x = buf[offset:].view(shape)
    scale = torch.tensor([0.02])
    before = fixed_kernel.launches_recip
    out = fixed_kernel.gs_fixed_recip(x, scale, p=p, frac_bits=frac_bits, iters=iters,
                                      variant=variant, mitchell_iters=mitchell)
    assert fixed_kernel.launches_recip == before + 1
    assert out.shape == x.shape and out.dtype == torch.float32
    assert len(lib.launches) == 1
    (x_ptr, scale_ptr, words_ptr, out_ptr, n_, frac_, p_, iters_, pipelined, mitchell_, vector,
     lane_words, grid, stream) = lib.launches.pop()
    assert (x_ptr, scale_ptr, out_ptr, n_, stream) == (
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), n, 7)
    assert (frac_, p_, iters_, pipelined, mitchell_) == (
        frac_bits, p, iters, int(variant == "pipelined"), mitchell)
    words = fixed_kernel.int8_recip_words(p, frac_bits, x.device)
    assert words_ptr == words.data_ptr()
    step = 1 << max(p - 6, 0)
    assert words.dtype == torch.int32 and words.shape == (2**p // step,) and words.is_contiguous()
    assert torch.equal(words.long(), rom_words("recip", p, frac_bits, "cpu")[::step])
    aligned = n >= WORD and x.data_ptr() % WORD == 0 and out.data_ptr() % 16 == 0
    assert vector == int(aligned) and aligned == (n >= WORD and offset % WORD == 0)
    plan, want_grid = fixed_kernel.recip_launch(n, x.data_ptr() % 16, out.data_ptr() % 16,
                                                x.device)
    assert (lane_words, grid) == (plan.vecs, want_grid)
    assert 1 <= grid <= 3 * 2


def test_wrapper_takes_a_python_scale_as_a_device_operand(monkeypatch):
    """A Python float scale reaches the kernel as a one-element f32 tensor
    of its value; a () scale tensor as itself."""
    lib = _stand_in(monkeypatch)
    seen = []
    real = fixed_kernel.scale_operand

    def recording(scale, device):
        t = real(scale, device)
        seen.append(t)
        return t

    monkeypatch.setattr(fixed_kernel, "scale_operand", recording)
    x = torch.ones(64, dtype=torch.int8)
    kw = dict(p=8, frac_bits=24, iters=0, variant="feedback", mitchell_iters=0)
    fixed_kernel.gs_fixed_recip(x, 4 / 127, **kw)
    scalar = torch.tensor(-0.02)
    fixed_kernel.gs_fixed_recip(x, scalar, **kw)
    assert seen[0].dtype == torch.float32 and seen[0].shape == (1,)
    assert seen[0].item() == np.float32(4 / 127)
    assert lib.launches[0][1] == seen[0].data_ptr()
    assert lib.launches[1][1] == scalar.data_ptr() == seen[1].data_ptr()


@pytest.mark.parametrize("shape", [(0, 128), (2, 0, 37), (0,)])
def test_wrapper_makes_no_launch_for_no_codes(monkeypatch, shape):
    _stand_in(monkeypatch)

    def no_library(*args):
        raise AssertionError("the wrapper reached the kernel library")

    monkeypatch.setattr(build, "load", no_library)
    monkeypatch.setattr(fixed_kernel, "grid_limits", no_library)
    before = fixed_kernel.launches_recip
    out = fixed_kernel.gs_fixed_recip(torch.empty(shape, dtype=torch.int8), 0.02, p=8,
                                      frac_bits=24, iters=0, variant="feedback",
                                      mitchell_iters=0)
    assert out.shape == shape and out.dtype == torch.float32
    assert fixed_kernel.launches_recip == before


def test_wrapper_raises_on_a_cpu_tensor():
    kw = dict(p=8, frac_bits=24, iters=0, variant="feedback", mitchell_iters=0)
    before = fixed_kernel.launches_recip
    with pytest.raises(ValueError, match="CUDA"):
        fixed_kernel.gs_fixed_recip(torch.ones(2, 64, dtype=torch.int8), 0.02, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        fixed_kernel.gs_fixed_recip(torch.ones(2, 64), 0.02, **kw)
    assert fixed_kernel.launches_recip == before


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
        fixed_kernel.gs_fixed_recip(x, 0.02, p=8, frac_bits=24, iters=0, variant="feedback",
                                    mitchell_iters=0)
    assert lib.launches == []


# -- the arithmetic the kernel rests on -----------------------------------------

@pytest.mark.parametrize("p", range(5, 13))
def test_every_code_reaches_a_word_of_the_int8_table(p):
    """The plain version's ROM index of every code -128..127 is j << (p - 6)
    with j < 64 for p >= 6 (any index for p < 6), so the kernel's word
    int8_recip_words[idx >> max(p - 6, 0)] is the ROM's word at idx."""
    cpu = torch.device("cpu")
    for frac_bits in sorted({p + 2, 24, 30}):
        a = torch.from_numpy(CODES.astype(np.int64)).abs().clamp_min(1)
        e = ref.msb32(a)
        one = 1 << frac_bits
        idx = (((a << (frac_bits - e)) - one) >> (frac_bits - p)).clamp(0, (1 << p) - 1)
        shift = max(p - 6, 0)
        table = fixed_kernel.int8_recip_words(p, frac_bits, cpu).long()
        assert table.shape == (min(64, 2**p),)
        assert ((idx >> shift) << shift == idx).all()
        assert torch.equal(table[idx >> shift], rom_words("recip", p, frac_bits, "cpu")[idx])
        assert fixed_kernel.int8_recip_words(p, frac_bits, cpu) is fixed_kernel.int8_recip_words(
            p, frac_bits, cpu)


@pytest.mark.parametrize("fmt_name", ["frac24", "frac30", "mitchell"])
@pytest.mark.parametrize("p", [None, 12])
@pytest.mark.parametrize("variant", ["feedback", "pipelined"])
def test_plain_version_on_every_code_matches_pallas_bit_for_bit(fmt_name, p, variant):
    """All 256 codes, -128 included, at every scale: the plain version (the
    kernel's yardstick on the card) bit-equal to the reference's Pallas
    kernel in interpret mode, in the format's own p and at p 12."""
    fmt, jfmt = _formats(formats)[fmt_name], _formats(jformats)[fmt_name]
    kw = dict(fmt.precision(), variant=variant)
    assert kw == dict(jfmt.precision(), variant=variant)
    if p is not None:
        kw["p"] = p
    for scale in SCALES:
        got = ref.fixed_recip(torch.from_numpy(CODES), scale, **kw).numpy()
        want = np.asarray(jfixed.gs_fixed_recip(jnp.asarray(CODES), scale, interpret=True,
                                                **kw))
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32),
                                      err_msg=f"scale {scale}")
        assert got[128] == np.inf  # the zero code
        assert (np.sign(got[CODES != 0]) == np.sign(CODES[CODES != 0] * scale)).all()


@pytest.mark.parametrize("scale", SCALES)
def test_torch_one_over_scale_is_the_ieee_f32_reciprocal(scale):
    """The plain version's 1.0 / scale (torch's f32 division) equals
    numpy's IEEE f32 1 / s bit for bit: the correctly rounded reciprocal,
    which the kernel's __frcp_rn also gives."""
    got = (1.0 / ref._scale(scale, torch.device("cpu"))).numpy().reshape(-1)
    want = np.float32(1.0) / np.float32(scale)
    assert got.dtype == np.float32 and got.shape == (1,)
    assert got.view(np.uint32)[0] == np.asarray(want).view(np.uint32)
