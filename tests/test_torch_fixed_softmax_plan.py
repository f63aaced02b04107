"""The launch plan of the int8 softmax kernel (``gs_fixed_softmax`` in
``repro_torch.kernels.gs_fixed``), its wrapper's arguments and the facts
its arithmetic rests on, on the CPU.

The plan is pure Python: 32-bit words of four codes only when d is a
multiple of 4, x is 4-byte and out 16-byte aligned; at d 128 every lane of
every warp holds a word; the row covered by threads x codes x vectors; a
packed plan (eight rows a warp at d 128) only when the rows fill a wave of
its blocks; rows past the register plans on the looping instance; a grid
of at least one block and at most SMs x resident blocks; no launch for an
empty input and a refusal for rows of no code.  The wrapper's arguments are checked
against a stand-in for the kernel library.  The kernel's max is one
multiply of the row's max (or, for a negative scale, min) code, which is
the plain version's amax bit for bit; its sum runs in the plan's lane order
and stays within the card's gate of the plain version.  The kernel itself
is held against the plain version on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core import formats  # noqa: E402
from repro_torch.core.fixed_point_torch import rom_words  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import gs_fixed as fixed_kernel  # noqa: E402
from repro_torch.kernels import gs_rmsnorm as rms_kernel  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

WORD = 4  # int8 codes in a 32-bit word
# the widest rows that stay in registers: 512 threads x 8 words of 4 codes,
# 512 x 8 single codes
REGISTER_PLAN_D = {WORD: 16384, 1: 4096}
DS = (1, 2, 4, 16, 37, 64, 128, 200, 256, 1024, 1028, 2048, 2049, 4096, 4097, 4100, 16384,
      16388, 16400, 1 << 17)
# the card's gate on the kernel against the plain version (chip_smoke.py)
SOFTMAX_PLAIN_RTOL = 2.0 ** -12


def _plan(d: int, width: int):
    """The plan of ``d`` with pointers that allow ``width``-code vectors."""
    return fixed_kernel.softmax_plan(d, 0, 0) if width == WORD else fixed_kernel.softmax_plan(
        d, 1, 0)


def _packed(d: int, width: int):
    """The packed plan of ``d`` with pointers that allow ``width``-code
    vectors."""
    return fixed_kernel.softmax_plan(d, 0 if width == WORD else 1, 0, packed=True)


def test_words_only_when_d_and_every_pointer_allow_them():
    for d in (4, 16, 128, 200, 2048, 16400):
        assert fixed_kernel.softmax_plan(d, 0, 0).width == WORD, d
        assert fixed_kernel.softmax_plan(d, 4, 0).width == WORD, d  # x 4-byte aligned
        assert fixed_kernel.softmax_plan(d, 0, 0, packed=True).width == WORD, d
    for d in (1, 2, 37, 130, 4097):
        assert fixed_kernel.softmax_plan(d, 0, 0).width == 1, d
    for x_bits in (1, 2, 3, 5, 6, 7, 9, 15):
        assert fixed_kernel.softmax_plan(128, x_bits, 0).width == 1, x_bits
    for out_bits in (4, 8, 12):  # float4 stores need a 16-byte aligned out
        assert fixed_kernel.softmax_plan(128, 0, out_bits).width == 1, out_bits
        assert fixed_kernel.softmax_plan(128, 0, out_bits, packed=True).width == 1, out_bits
    buf = torch.empty(4096 + 16, dtype=torch.int8)
    assert buf.data_ptr() % 16 == 0
    for off in range(16):
        view = buf[off:off + 2048]
        assert view.is_contiguous()
        want = WORD if off % WORD == 0 else 1
        assert fixed_kernel.softmax_plan(2048, view.data_ptr() % 16, 0).width == want, off


def test_every_lane_of_every_warp_holds_codes_at_d_128():
    """d 128, the benchmark's width: a warp a row, one word of four codes a
    lane, four rows in a block of 128 threads."""
    plan = fixed_kernel.softmax_plan(128, 0, 0)
    assert (plan.width, plan.vecs, plan.row_threads, plan.rows_per_block) == (WORD, 1, 32, 4)
    assert plan.threads % 32 == 0
    assert plan.row_threads * plan.width * plan.vecs == 128
    assert 128 // plan.width == plan.row_threads  # every lane holds a word


@pytest.mark.parametrize("width", [1, WORD])
def test_threads_times_codes_times_vectors_cover_the_row(width):
    for d in DS:
        if d % width:
            continue
        plan = _plan(d, width)
        assert plan.width == width, d
        rt = plan.row_threads
        assert plan.threads % 32 == 0 and plan.threads <= fixed_kernel.SOFTMAX_MAX_THREADS, d
        assert plan.threads % rt == 0, d
        if rt <= 32:
            assert rt & (rt - 1) == 0, d  # a power-of-two segment of a warp
        else:
            assert rt % 32 == 0, d
        if d > REGISTER_PLAN_D[width]:
            assert (plan.vecs, rt) == (0, fixed_kernel.SOFTMAX_MAX_THREADS), d
            continue
        assert plan.vecs in fixed_kernel.SOFTMAX_VECS, d
        assert rt * width * plan.vecs >= d, d
        if rt <= 32:  # more than half the segment's lanes hold codes
            assert (rt // 2) * width * plan.vecs < d or rt == 1, d
        else:  # no whole warp idle
            assert (rt - 32) * width * plan.vecs < d, d


@pytest.mark.parametrize("width", [1, WORD])
def test_the_packed_plan_holds_a_narrow_row_in_the_fewest_lanes(width):
    """A row of one warp in the fewest lanes at most 8 vectors a lane allow,
    and the fewest vectors that fill them (d 128 in words: 8 words in each
    of 4 lanes, every lane holding codes); the plain plan where that saves
    no lane."""
    most = fixed_kernel.SOFTMAX_VECS[-1]
    for d in DS:
        if d % width:
            continue
        plain, packed = _plan(d, width), _packed(d, width)
        assert packed.width == plain.width
        if packed == plain:
            rt = plain.row_threads  # no fewer lanes hold the row
            assert rt > 32 or rt == 1 or (rt // 2) * width * most < d, d
            continue
        rt, vecs = packed.row_threads, packed.vecs
        assert rt < plain.row_threads <= 32 and rt & (rt - 1) == 0, d
        assert vecs in fixed_kernel.SOFTMAX_VECS and vecs >= plain.vecs, d
        assert packed.threads == fixed_kernel.SOFTMAX_BLOCK, d
        assert rt * width * vecs >= d, d  # the row is covered
        assert (rt // 2) * width * most < d or rt == 1, d  # in the fewest lanes
        assert (vecs // 2) * rt * width < d or vecs == 1, d  # by the fewest vectors
    plan = _packed(128, WORD)
    assert (plan.vecs, plan.row_threads, plan.rows_per_block) == (8, 4, 32)
    assert plan.row_threads * plan.width * plan.vecs == 128  # every lane holds codes


@pytest.mark.parametrize("rows,packs", [(1, False), (256, False), (4096, False),
                                        (32 * 132 * 8 - 1, False), (32 * 132 * 8, True),
                                        (65536, True)])
def test_rows_that_fill_a_wave_of_packed_blocks_take_the_packed_plan(monkeypatch, rows, packs):
    """At d 128 on a card of 132 SMs holding 8 blocks of 128 threads: few
    rows keep a warp a row (more warps in flight), rows that fill a wave of
    packed blocks (32 rows a block) take eight rows a warp and a grid of
    one wave."""
    monkeypatch.setattr(fixed_kernel, "grid_limits",
                        lambda device, plan, kernel="rmsnorm": (132, 8))
    plan, grid = fixed_kernel.softmax_launch(rows, 128, 0, 0, torch.device("cpu"))
    assert plan == (_packed(128, WORD) if packs else _plan(128, WORD))
    assert grid == rms_kernel.grid_size(rows, plan.rows_per_block, 132, 8)
    assert (grid == 132 * 8) == (rows > 4 * (132 * 8 - 1))


@pytest.mark.parametrize("width", [1, WORD])
def test_rows_past_the_register_plan_take_the_looping_instance(width):
    widest = REGISTER_PLAN_D[width]
    plan = _plan(widest, width)
    assert plan.vecs > 0 and plan.row_threads * width * plan.vecs == widest
    past = _plan(widest + width, width)
    assert (past.vecs, past.row_threads) == (0, fixed_kernel.SOFTMAX_MAX_THREADS)


def test_grid_is_at_least_one_block_and_fits_the_limits():
    for d in (1, 37, 128, 200, 4096, 16400):
        plan = fixed_kernel.softmax_plan(d, 0, 0)
        assert rms_kernel.grid_size(0, plan.rows_per_block, 132, 8) == 0
        for rows in (1, 4, 256, 65536, 100_000):
            for sms, resident in ((132, 1), (132, 16), (1, 1)):
                grid = rms_kernel.grid_size(rows, plan.rows_per_block, sms, resident)
                assert 1 <= grid <= sms * resident
                assert grid * plan.rows_per_block >= rows or grid == sms * resident
                assert (grid - 1) * plan.rows_per_block < rows


class _KernelLibrary:
    """Records the arguments of each launch; returns cudaSuccess."""

    def __init__(self):
        self.launches = []

    def gs_fixed_softmax_launch(self, *args):
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


# (rows, d, storage offset of x, p, frac_bits, iters, mitchell_iters, variant):
# the benchmark's shapes at p 8 and p 12, the three formats, narrow and
# ragged rows, d 1, views 1 and 4 bytes in, rows of several warps and rows
# past both register plans
CASES = ((256, 128, 0, 8, 24, 0, 0, "feedback"), (65536, 128, 0, 8, 24, 0, 0, "feedback"),
         (256, 128, 0, 12, 24, 0, 0, "feedback"), (256, 128, 0, 8, 30, 0, 0, "pipelined"),
         (256, 128, 0, 7, 24, 2, 1, "pipelined"), (37, 200, 0, 8, 24, 0, 0, "feedback"),
         (7, 37, 0, 8, 24, 0, 0, "feedback"), (33, 1, 0, 8, 24, 0, 0, "feedback"),
         (9, 64, 0, 8, 24, 0, 0, "feedback"), (33, 128, 1, 8, 24, 0, 0, "feedback"),
         (33, 128, 4, 8, 24, 0, 0, "feedback"), (5, 4096, 0, 8, 24, 0, 0, "feedback"),
         (3, 2049, 0, 8, 24, 0, 0, "feedback"), (2, 16400, 0, 8, 24, 0, 0, "feedback"),
         (2, 4097, 0, 8, 24, 0, 0, "feedback"))


@pytest.mark.parametrize("rows,d,offset,p,frac_bits,iters,mitchell,variant", CASES)
def test_wrapper_launches_once_with_the_plan(monkeypatch, rows, d, offset, p, frac_bits, iters,
                                             mitchell, variant):
    """One launch a call, counted on ``launches_softmax``, with x, scale and
    out's pointers, the recip words of the call's p and frac_bits, the
    datapath's settings, and the plan of d and the alignment."""
    lib = _stand_in(monkeypatch)
    buf = torch.ones(rows * d + offset, dtype=torch.int8)
    x = buf[offset:].view(rows, d)
    scale = torch.tensor([0.02])
    before = fixed_kernel.launches_softmax
    out = fixed_kernel.gs_fixed_softmax(x, scale, p=p, frac_bits=frac_bits, iters=iters,
                                        variant=variant, mitchell_iters=mitchell)
    assert fixed_kernel.launches_softmax == before + 1
    assert out.shape == x.shape and out.dtype == torch.float32
    assert len(lib.launches) == 1
    (x_ptr, scale_ptr, words_ptr, out_ptr, rows_, d_, frac_, p_, iters_, pipelined, mitchell_,
     vector, vecs, row_threads, per_block, grid, stream) = lib.launches.pop()
    assert (x_ptr, scale_ptr, out_ptr, rows_, d_, stream) == (
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d, 7)
    assert (frac_, p_, iters_, pipelined, mitchell_) == (
        frac_bits, p, iters, int(variant == "pipelined"), mitchell)
    words = fixed_kernel.rom_words_u32("recip", p, frac_bits, x.device)
    assert words_ptr == words.data_ptr()
    assert words.dtype == torch.int32 and words.shape == (2**p,)
    assert torch.equal(words.long(), rom_words("recip", p, frac_bits, "cpu"))
    aligned = (x.data_ptr() % WORD == 0 and out.data_ptr() % 16 == 0 and d % WORD == 0)
    assert vector == int(aligned) and aligned == (offset % WORD == 0 and d % WORD == 0)
    bits = (x.data_ptr() % 16, out.data_ptr() % 16)
    plain = fixed_kernel.softmax_plan(d, *bits)
    packed = fixed_kernel.softmax_plan(d, *bits, packed=True)
    # the packed plan only where it packs and the rows fill a wave of its
    # blocks (3 SMs x 2 resident in the stand-in)
    fills = packed != plain and rows >= packed.rows_per_block * 3 * 2
    plan = packed if fills else plain
    assert (vecs, row_threads, per_block) == (plan.vecs, plan.row_threads, plan.rows_per_block)
    assert (vecs == 0) == (d > REGISTER_PLAN_D[plan.width])
    assert vecs == 0 or row_threads * plan.width * vecs >= d
    assert grid == rms_kernel.grid_size(rows, per_block, 3, 2)
    assert 1 <= grid <= 3 * 2


def _no_library(*args):
    raise AssertionError("the wrapper reached the kernel library")


@pytest.mark.parametrize("shape", [(0, 128), (2, 0, 37), (0, 1)])
def test_wrapper_makes_no_launch_for_zero_rows(monkeypatch, shape):
    _stand_in(monkeypatch)
    monkeypatch.setattr(build, "load", _no_library)
    monkeypatch.setattr(fixed_kernel, "grid_limits", _no_library)
    before = fixed_kernel.launches_softmax
    out = fixed_kernel.gs_fixed_softmax(torch.empty(shape, dtype=torch.int8), 0.02, p=8,
                                        frac_bits=24, iters=0, variant="feedback",
                                        mitchell_iters=0)
    assert out.shape == shape and out.dtype == torch.float32
    assert fixed_kernel.launches_softmax == before


@pytest.mark.parametrize("shape", [(3, 0), (0, 0), ()])
def test_wrapper_refuses_rows_of_no_code(monkeypatch, shape):
    """d 0 (and a 0-d x) raises ValueError before any arithmetic or launch."""
    _stand_in(monkeypatch)
    monkeypatch.setattr(build, "load", _no_library)
    monkeypatch.setattr(fixed_kernel, "grid_limits", _no_library)
    before = fixed_kernel.launches_softmax
    with pytest.raises(ValueError, match="at least one code"):
        fixed_kernel.gs_fixed_softmax(torch.empty(shape, dtype=torch.int8), 0.02, p=8,
                                      frac_bits=24, iters=0, variant="feedback",
                                      mitchell_iters=0)
    assert fixed_kernel.launches_softmax == before


def test_recip_words_are_built_once_per_format_and_device():
    cpu = torch.device("cpu")
    for p, frac_bits in ((8, 24), (7, 24), (8, 30), (12, 24)):
        words = fixed_kernel.rom_words_u32("recip", p, frac_bits, cpu)
        assert words is fixed_kernel.rom_words_u32("recip", p, frac_bits, cpu)
        assert torch.equal(words.long(), rom_words("recip", p, frac_bits, "cpu"))


# -- the arithmetic the kernel rests on -----------------------------------------

def _codes(kind: str, rows: int, d: int, seed: int) -> np.ndarray:
    """int8 rows: random codes over the full range, a row max (and min) held
    twice, or one repeated code a row."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-128, 128, (rows, d)).astype(np.int8)
    if kind == "max_twice":
        for r in range(rows):
            hi, lo = x[r].argmax(), x[r].argmin()
            x[r, (hi + 1) % d] = x[r, hi]
            x[r, (lo + 2) % d] = x[r, lo]
    elif kind == "repeated":
        x[:] = rng.randint(-128, 128, (rows, 1)).astype(np.int8)
    return x


@pytest.mark.parametrize("kind", ["random", "max_twice", "repeated"])
@pytest.mark.parametrize("scale", [0.02, -0.02, 1e-30, 3e4])
def test_plain_row_max_is_one_multiply_of_the_max_or_min_code(kind, scale):
    """The plain version's row max, amax over fl(code · scale), equals
    fl(max code · scale) bit for bit for a positive scale and fl(min code ·
    scale) for a negative one: rounding is monotone."""
    x = _codes(kind, 64, 128, 11)
    tx = torch.from_numpy(x)
    v = tx.to(torch.float32) * ref._scale(scale, tx.device)  # the plain version's v
    got = torch.amax(v, dim=-1).numpy()
    code = x.max(-1) if scale > 0 else x.min(-1)
    want = code.astype(np.float32) * np.float32(scale)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_plain_softmax_at_scale_zero_is_uniform_whatever_the_zero_signs():
    """At scale 0, v holds +0 and -0: amax picks either, and exp(v - m) is 1
    both ways, so every output is the fixed 1/d."""
    x = torch.from_numpy(_codes("random", 8, 128, 12))
    kw = dict(formats.format_for("int8").precision(), variant="feedback")
    out = ref.fixed_softmax(x, 0.0, **kw)
    assert torch.equal(out, out[:1, :1].expand_as(out))
    v = x.to(torch.float32) * ref._scale(0.0, x.device)
    for m in (0.0, -0.0):  # the kernel's m, one multiply of a code by 0
        assert torch.equal(torch.exp(v - m), torch.ones_like(v))


def _lane_order_sum(e: np.ndarray, plan) -> np.ndarray:
    """The kernel's row sums of f32 ``e`` (rows, d) under ``plan``: each lane
    adds its codes in order (vector k = t + k·row_threads, then its codes),
    an xor butterfly over the segment or warp, then the warps' partials in
    order; every add rounds to f32."""
    rows, d = e.shape
    rt, width = plan.row_threads, plan.width
    nvec = d // width
    vecs = plan.vecs or -(-nvec // rt)
    acc = np.zeros((rows, rt), np.float32)
    for k in range(vecs):
        for t in range(rt):
            v = t + k * rt
            if v < nvec:
                for j in range(width):
                    acc[:, t] = acc[:, t] + e[:, v * width + j]
    lanes = min(rt, 32)
    warps = acc.reshape(rows, -1, lanes)
    o = lanes // 2
    while o:
        warps = warps + warps[:, :, np.arange(lanes) ^ o]
        o //= 2
    total = warps[:, 0, 0]
    for w in range(1, warps.shape[1]):
        total = total + warps[:, w, 0]
    assert (warps == warps[:, :, :1]).all()  # every lane holds the same bits
    return total


def _fixed_softmax_from_sum(x: torch.Tensor, scale: float, s: torch.Tensor, kw) -> torch.Tensor:
    """ref.fixed_softmax's output from the row sums ``s`` (rows, 1) and its
    own e: its peel, ROM word and fixed divide, then e · inv."""
    from repro_torch.core.fixed_point_torch import FixedPointTorch
    from repro_torch.kernels import common

    p, frac_bits = kw["p"], kw["frac_bits"]
    v = x.to(torch.float32) * ref._scale(scale, x.device)
    e = torch.exp(v - torch.amax(v, dim=-1, keepdim=True))
    eb, mant, _ = ref._peel(s)
    idx = ((mant & 0x7FFFFF) >> (23 - p)).clamp(0, (1 << p) - 1)
    dp = FixedPointTorch(p=p, frac_bits=frac_bits, mitchell_iters=kw["mitchell_iters"])
    q, _ = dp.divide(torch.full_like(mant, 1 << frac_bits), ref._mant_to_reg(mant, frac_bits),
                     kw["iters"], kw["variant"], k1=rom_words("recip", p, frac_bits, "cpu")[idx])
    return e * (ref._reg_to_f32(q, frac_bits) * common.pow2_from_biased(254 - eb))


@pytest.mark.parametrize("d,width", [(128, WORD), (200, WORD), (37, 1), (64, WORD),
                                     (4096, WORD), (2049, 1)])
@pytest.mark.parametrize("scale", [0.02, -0.02])
def test_lane_order_sum_stays_within_the_card_gate(d, width, scale):
    """The plain version's arithmetic with its row sum taken in the plan's
    lane order (as the kernel adds) stays within SOFTMAX_PLAIN_RTOL of the
    plain version elementwise, in the three formats."""
    x = torch.from_numpy(_codes("random", 6, d, d))
    plan = _plan(d, width)
    v = x.to(torch.float32) * ref._scale(scale, x.device)
    e = torch.exp(v - torch.amax(v, dim=-1, keepdim=True))
    s = torch.from_numpy(_lane_order_sum(e.numpy(), plan)).reshape(-1, 1)
    for fmt in (formats.format_for("int8"), formats.NumericFormat.fixed(30),
                formats.NumericFormat.fixed(24, p=7, mitchell_iters=1)):
        kw = dict(fmt.precision(), variant="feedback")
        want = ref.fixed_softmax(x, scale, **kw)
        got = _fixed_softmax_from_sum(x, scale, s, kw)
        assert ((got - want).abs() <= SOFTMAX_PLAIN_RTOL * want).all()
        # the emulation is the plain version when the sums agree
        assert torch.equal(_fixed_softmax_from_sum(x, scale, e.sum(-1, keepdim=True), kw), want)
