"""Port's fixed-point datapath and formats vs ``repro.core`` on the same inputs.

* ``FixedPointTorch`` (``mult``, ``mitchell_mult``, ``divide`` in both
  variants, ``rsqrt_reg``) register for register against the JAX datapath
  ``FixedPointJax`` and the numpy emulation ``FixedPointDatapath``, over
  p 5..12 x frac_bits 16/24/30 x variant x mitchell 0/1/2: equal, no
  tolerance.
* ``recip_f32``, ``divide_f32``, ``rsqrt_f32``, ``sqrt_f32`` bit-equal on
  normal f32 inputs whose results are normal; the specials (0, ±inf, NaN,
  negatives) equal too; subnormal inputs and results apart (XLA's CPU
  backend flushes them, ROADMAP C2).
* ``format_for("int8")``, ``fixed_bits``, ``fixed_precision_policy``,
  ``certified_bits`` and ``NumericsPolicy`` under ``quant="int8"`` equal to
  the reference's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import formats as jformats  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.core.fixed_point import FixedPointDatapath, msb  # noqa: E402
from repro.core import fixed_point_jax as fpj  # noqa: E402
from repro_torch.configs import tinyllama_1_1b  # noqa: E402
from repro_torch.core import fixed_point_torch as fpt  # noqa: E402
from repro_torch.core import formats  # noqa: E402

PASSES = 2
F32 = np.float32


def _operands(rng, n=384):
    """Mantissa-domain operands, the ROM bucket edges included."""
    d = rng.uniform(1.0, 2.0, n)
    d = np.concatenate([d, [1.0, 1.5, 2.0 - 2.0 ** -20],
                        1.0 + np.arange(1, 8) / 8.0 + 1e-9])
    return rng.uniform(1.0, 2.0 - 1e-9, d.shape[0]), d


def _t(reg: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(reg).astype(np.int64))


def _u64(x) -> np.ndarray:
    return np.asarray(x).astype(np.uint64)


@pytest.mark.parametrize("mitchell", [0, 1, 2])
@pytest.mark.parametrize("variant", ["feedback", "pipelined"])
@pytest.mark.parametrize("frac_bits", [16, 24, 30])
@pytest.mark.parametrize("p", range(5, 13))
def test_divide_registers_equal(p, frac_bits, variant, mitchell):
    rng = np.random.RandomState(p * 100 + frac_bits)
    n, d = _operands(rng)
    np_dp = FixedPointDatapath(p=p, frac_bits=frac_bits, mitchell_iters=mitchell)
    jx_dp = fpj.FixedPointJax(p=p, frac_bits=frac_bits, mitchell_iters=mitchell)
    dp = fpt.FixedPointTorch(p=p, frac_bits=frac_bits, mitchell_iters=mitchell)
    n_reg, d_reg = np_dp.encode(n), np_dp.encode(d)
    want = (np_dp.divide_pipelined if variant == "pipelined"
            else np_dp.divide_feedback)(n, d, PASSES)
    jq, jr = jx_dp.divide(jnp.asarray(n_reg.astype(np.uint32)),
                          jnp.asarray(d_reg.astype(np.uint32)), PASSES, variant)
    q, r = dp.divide(_t(n_reg), _t(d_reg), PASSES, variant)
    for got, jax_reg, np_reg in ((q, jq, want.q), (r, jr, want.r)):
        np.testing.assert_array_equal(_u64(got), np_reg)
        np.testing.assert_array_equal(_u64(got), _u64(jax_reg))
    # the primitive blocks on the same registers, and a ROM seed handed in
    k = dp.complement(dp.mult(_t(d_reg), dp.rom(_t(d_reg))))
    for name in ("mult", "mitchell_mult"):
        got = getattr(dp, name)(_t(d_reg), k)
        np.testing.assert_array_equal(_u64(got), getattr(np_dp, name)(d_reg, _u64(k)))
        np.testing.assert_array_equal(
            _u64(got), _u64(getattr(jx_dp, name)(jnp.asarray(d_reg.astype(np.uint32)),
                                                 jnp.asarray(_u64(k).astype(np.uint32)))))
    q_seeded, _ = dp.divide(_t(n_reg), _t(d_reg), PASSES, variant, k1=dp.rom(_t(d_reg)))
    np.testing.assert_array_equal(_u64(q_seeded), want.q)


@pytest.mark.parametrize("frac_bits", [16, 24, 30])
@pytest.mark.parametrize("p", range(5, 13))
def test_rsqrt_registers_equal(p, frac_bits):
    rng = np.random.RandomState(7 * p + frac_bits)
    m = np.concatenate([rng.uniform(1.0, 4.0, 384), [1.0, 2.0, 3.0, 4.0 - 2.0**-20]])
    m_reg = np.rint(m * 2.0**frac_bits).astype(np.uint64)
    jx_dp = fpj.FixedPointJax(p=p, frac_bits=frac_bits)
    dp = fpt.FixedPointTorch(p=p, frac_bits=frac_bits)
    for passes in (0, 1, 2, 3):
        got = dp.rsqrt_reg(_t(m_reg), passes)
        want = jx_dp.rsqrt_reg(jnp.asarray(m_reg.astype(np.uint32)), passes)
        np.testing.assert_array_equal(_u64(got), _u64(want), err_msg=f"passes {passes}")


def test_msb_and_extreme_registers():
    """Leading-one detect on 0 and the top of the register, and Mitchell
    products at the edges (zero operands, wrapping shifts)."""
    regs = np.array([0, 1, 2, 3, 255, 2**16, 2**24 + 5, 2**31, 2**32 - 1], np.uint64)
    np.testing.assert_array_equal(_u64(fpt.msb32(_t(regs))), msb(regs))
    np.testing.assert_array_equal(_u64(fpt.msb32(_t(regs))),
                                  _u64(fpj.msb32(jnp.asarray(regs.astype(np.uint32)))))
    a, b = np.meshgrid(regs, regs)
    a, b = a.ravel(), b.ravel()
    for frac_bits in (16, 24, 30):
        dp = fpt.FixedPointTorch(p=7, frac_bits=frac_bits)
        jx_dp = fpj.FixedPointJax(p=7, frac_bits=frac_bits)
        for name in ("mult", "mitchell_mult"):
            got = getattr(dp, name)(_t(a), _t(b))
            want = getattr(jx_dp, name)(jnp.asarray(a.astype(np.uint32)),
                                        jnp.asarray(b.astype(np.uint32)))
            np.testing.assert_array_equal(_u64(got), _u64(want), err_msg=f"{name} F={frac_bits}")
        np.testing.assert_array_equal(_u64(dp.complement(_t(a))),
                                      _u64(jx_dp.complement(jnp.asarray(a.astype(np.uint32)))))


# -- the f32 wrappers --------------------------------------------------------

WRAP_FORMATS = [dict(frac_bits=24, p=8, iters=0), dict(frac_bits=28, p=7, iters=2),
                dict(frac_bits=30, p=7, iters=1), dict(frac_bits=16, p=7, iters=2)]


def _normals(rng, n=2000):
    """Normal f32 inputs of both signs across the exponent range."""
    mant = rng.uniform(1.0, 2.0, n)
    exp = rng.randint(-120, 120, n)
    x = (mant * 2.0**exp * rng.choice([-1.0, 1.0], n)).astype(F32)
    return np.concatenate([x, F32([1.0, -1.0, 2.0, 0.5, 1.5, 3.0, 1.0 + 2**-23])])


def _bits(x) -> np.ndarray:
    return np.asarray(x, F32).view(np.uint32)


def _not_subnormal(x) -> np.ndarray:
    a = np.abs(np.asarray(x, F32))
    return (a == 0) | (a >= np.finfo(F32).tiny)


@pytest.mark.parametrize("variant", ["feedback", "pipelined"])
@pytest.mark.parametrize("fmt", WRAP_FORMATS, ids=lambda f: "F{frac_bits}p{p}i{iters}".format(**f))
def test_f32_wrappers_bit_equal_on_normals(fmt, variant):
    rng = np.random.RandomState(fmt["frac_bits"] + fmt["p"])
    x, y = _normals(rng), _normals(rng)
    cases = [
        (fpt.recip_f32(torch.from_numpy(x), variant=variant, mitchell_iters=1, **fmt),
         fpj.recip_f32(jnp.asarray(x), variant=variant, mitchell_iters=1, **fmt)),
        (fpt.recip_f32(torch.from_numpy(x), variant=variant, **fmt),
         fpj.recip_f32(jnp.asarray(x), variant=variant, **fmt)),
        (fpt.divide_f32(torch.from_numpy(x), torch.from_numpy(y), variant=variant, **fmt),
         fpj.divide_f32(jnp.asarray(x), jnp.asarray(y), variant=variant, **fmt)),
        (fpt.rsqrt_f32(torch.from_numpy(np.abs(x)), **fmt),
         fpj.rsqrt_f32(jnp.asarray(np.abs(x)), **fmt)),
        (fpt.sqrt_f32(torch.from_numpy(np.abs(x)), **fmt),
         fpj.sqrt_f32(jnp.asarray(np.abs(x)), **fmt)),
    ]
    for i, (got, want) in enumerate(cases):
        got, want = got.numpy(), np.asarray(want)
        normal = _not_subnormal(got) & _not_subnormal(want)
        assert normal.mean() > 0.95, f"case {i}: too few normal results"
        np.testing.assert_array_equal(_bits(got)[normal], _bits(want)[normal],
                                      err_msg=f"case {i}")
        # the rest are results below the normal range: torch rounds them to
        # subnormals, XLA's CPU backend flushes them to zero (ROADMAP C2)
        assert np.all(np.abs(got[~normal]) < 2 * np.finfo(F32).tiny), f"case {i}"


def test_f32_wrapper_specials_and_subnormals():
    fmt = dict(frac_bits=24, p=8, iters=0)
    special = F32([0.0, -0.0, np.inf, -np.inf, np.nan, -1.0, -2.5])
    for fn_t, fn_j in ((fpt.recip_f32, fpj.recip_f32), (fpt.rsqrt_f32, fpj.rsqrt_f32),
                       (fpt.sqrt_f32, fpj.sqrt_f32)):
        got = fn_t(torch.from_numpy(special), **fmt).numpy()
        want = np.asarray(fn_j(jnp.asarray(special), **fmt))
        if fn_t is fpt.recip_f32:  # -1, -2.5: normal negatives, through the datapath
            np.testing.assert_array_equal(_bits(got), _bits(want))
        else:
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
    d = F32([1.0, 0.0, np.inf, -3.0, np.nan])
    got = fpt.divide_f32(torch.from_numpy(F32([1.0] * 5)), torch.from_numpy(d), **fmt).numpy()
    want = np.asarray(fpj.divide_f32(jnp.ones(5, jnp.float32), jnp.asarray(d), **fmt))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
    # subnormal inputs: torch divides them (a large finite or inf result),
    # XLA flushes them to ±0 first and returns ±inf (ROADMAP C2)
    sub = F32([1e-40, -3e-42])
    got = fpt.recip_f32(torch.from_numpy(sub), **fmt).numpy()
    np.testing.assert_array_equal(got, (1.0 / sub.astype(np.float64)).astype(F32))


# -- formats -----------------------------------------------------------------


@pytest.mark.parametrize("mitchell", [0, 1])
@pytest.mark.parametrize("frac_bits", [16, 20, 24, 28, 30])
def test_fixed_formats_match(frac_bits, mitchell):
    """Certification runs the torch datapath over the grid; the reference
    runs its numpy emulation: the same bits at every point."""
    for p in (7, 8):
        for iters in (0, 1, 2):
            assert (formats.fixed_bits(p, frac_bits, iters, mitchell)
                    == jformats.fixed_bits(p, frac_bits, iters, mitchell))
    assert (formats.fixed_precision_policy(frac_bits, 8, mitchell)
            == jformats.fixed_precision_policy(frac_bits, 8, mitchell))
    assert (formats.fixed_iters_needed(7, frac_bits, 8, mitchell)
            == jformats.fixed_iters_needed(7, frac_bits, 8, mitchell))


def test_int8_format_and_policy_match():
    mine, ref = formats.format_for("int8"), jformats.format_for("int8")
    assert (mine.kind, mine.frac_bits, mine.p, mine.iters, mine.mitchell_iters) == (
        ref.kind, ref.frac_bits, ref.p, ref.iters, ref.mitchell_iters)
    assert mine.certified_bits() == ref.certified_bits() >= formats.INT8_TARGET_BITS
    assert mine.precision() == ref.precision()
    for name in ("float32", "bfloat16"):
        assert formats.format_for(name).precision() == jformats.format_for(name).precision()
        assert formats.format_for(name).certified_bits() == jformats.format_for(
            name).certified_bits()
    for build in (lambda m: m.NumericFormat.fixed(30),
                  lambda m: m.NumericFormat.fixed(24, p=7, mitchell_iters=1)):
        assert build(formats).precision() == build(jformats).precision()
        assert build(formats).error_bound() == build(jformats).error_bound()
    pol = tinyllama_1_1b.smoke(quant="int8", dtype="float32").policy()
    jpol = jpolicy.NumericsPolicy(mode="gs_feedback", target_bits=24, fmt=ref)
    assert pol.is_fixed and jpol.is_fixed and pol.fmt.precision() == ref.precision()
    x = (np.random.RandomState(2).randn(4, 33) * 3).astype(F32)
    for op in ("reciprocal", "rsqrt"):
        arg = np.abs(x) + F32(0.1)
        got = getattr(pol, op)(torch.from_numpy(arg)).numpy()
        want = np.asarray(getattr(jpol, op)(jnp.asarray(arg)))
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=op)
    # softmax: torch's exp and row sum may differ from XLA's in the last ulp,
    # which can move the sum's ROM bucket: held to 2 x the format's bound
    np.testing.assert_allclose(pol.softmax(torch.from_numpy(x)).numpy(),
                               np.asarray(jpol.softmax(jnp.asarray(x))),
                               rtol=2 * ref.error_bound(), atol=0)
