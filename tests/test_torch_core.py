"""Port's float Goldschmidt datapath vs ``repro.core`` on the same inputs.

* ROM tables byte-equal for p 5..12.
* ``gs_reciprocal/divide/rsqrt/sqrt`` on finite f32 normals (outputs normal
  too) for (7, 2), (8, 0), (12, 1) x both variants:
  - bit-identical to an unfused numpy float32 twin of the datapath;
  - bit-identical to the JAX reference wherever XLA evaluates it unfused,
    and within 2 ulp elsewhere: XLA's CPU backend contracts ``2 - m*k1``
    and the rsqrt updates into FMAs (its own variants differ by the same
    contraction; ROADMAP C records the case).
* IEEE special classes (±0, subnormal, ±inf, nan, powers of two, the
  signs of rsqrt(-0) and sqrt(-0)) against torch's own exact ops.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import goldschmidt as jgs  # noqa: E402
from repro.core import lut as jlut  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro_torch.configs import tinyllama_1_1b  # noqa: E402
from repro_torch.core import goldschmidt as gs  # noqa: E402
from repro_torch.core import lut  # noqa: E402
from repro_torch.core import policy  # noqa: E402

F32 = np.float32
OPS = ("recip", "divide", "rsqrt", "sqrt")
PAIRS = [(7, 2), (8, 0), (12, 1)]
VARIANTS = ("feedback", "pipelined")


@pytest.mark.parametrize("p", range(5, 13))
def test_tables_byte_equal(p):
    assert lut.reciprocal_table_f32(p).tobytes() == jlut.reciprocal_table_f32(p).tobytes()
    assert lut.rsqrt_table_f32(p).tobytes() == jlut.rsqrt_table_f32(p).tobytes()
    assert lut.seed_bits(p) == jlut.seed_bits(p)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_precision_policy_matches(dtype):
    assert gs.target_bits_for(dtype) == jgs.target_bits_for(dtype)
    assert gs.precision_policy(dtype) == jgs.precision_policy(dtype)
    for p, iters, tb in [(None, None, None), (9, None, None), (None, 1, None),
                         (None, None, 8), (12, 1, None)]:
        assert (gs.resolve_precision(dtype, p, iters, tb)
                == jgs.resolve_precision(jnp.dtype(dtype), p, iters, tb))
    for p in range(5, 13):
        assert gs.iters_needed(p, 24) == jgs.iters_needed(p, 24)


# -- an unfused numpy float32 twin of the datapath (normal inputs) ----------


def _np_peel(x):
    bits = np.abs(x).view(np.int32)
    e = ((bits >> 23) & 0xFF) - 127
    return ((bits & 0x7FFFFF) | 0x3F800000).view(F32), e


def _np_pow2(e):
    return ((e + 127) << 23).astype(np.int32).view(F32)


def _np_scale(q, e):
    e = np.clip(e, -152, 130)
    e1 = np.clip(e, -124, 125)
    return (q * _np_pow2(e1)) * _np_pow2(e - e1)


def _np_recip_iter(q, r, iters):
    for _ in range(iters):
        k = F32(2) - r
        q, r = q * k, r * k
    return q


def _np_rsqrt_seed(x, p, iters):
    m, e = _np_peel(x)
    odd = (e % 2) != 0
    m = np.where(odd, m * F32(2), m)
    e = np.where(odd, e - 1, e)
    idx = np.clip(np.floor((m - F32(1)) * F32(2.0**p / 3.0)).astype(np.int64), 0, 2**p - 1)
    y0 = jlut.rsqrt_table_f32(p)[idx]
    g, h = m * y0, F32(0.5) * y0
    for _ in range(iters):
        r = F32(0.5) - g * h
        g, h = g + g * r, h + h * r
    return e, g, h


def _np_op(op, args, p, iters):
    tab = jlut.reciprocal_table_f32(p)
    if op in ("recip", "divide"):
        n, d = args if op == "divide" else (np.ones_like(args[0]), args[0])
        mn, en = _np_peel(n)
        md, ed = _np_peel(d)
        k1 = tab[np.floor((md - F32(1)) * F32(2**p)).astype(np.int64)]
        q = _np_recip_iter(mn * k1 if op == "divide" else k1, md * k1, iters)
        sign = np.where(np.signbit(n) ^ np.signbit(d), F32(-1), F32(1))
        return sign * _np_scale(q, en - ed if op == "divide" else -ed)
    e, g, h = _np_rsqrt_seed(args[0], p, iters)
    if op == "rsqrt":
        return _np_scale(F32(2) * h, -(e // 2))
    return _np_scale(g, e // 2)


def _inputs(op):
    r = np.random.RandomState(20)
    x = np.exp2(r.uniform(-60, 60, 20000)).astype(F32)
    if op in ("rsqrt", "sqrt"):
        return (x,)
    x = x * np.where(r.rand(x.size) < 0.5, -1, 1).astype(F32)
    if op == "recip":
        return (x,)
    n = (np.exp2(r.uniform(-60, 60, x.size))
         * np.where(r.rand(x.size) < 0.5, -1, 1)).astype(F32)
    return (n, x)


_PORT = {"recip": gs.gs_reciprocal, "divide": gs.gs_divide,
         "rsqrt": gs.gs_rsqrt, "sqrt": gs.gs_sqrt}
_REF = {"recip": jgs.gs_reciprocal, "divide": jgs.gs_divide,
        "rsqrt": jgs.gs_rsqrt, "sqrt": jgs.gs_sqrt}


def _reference_unfused(op, p, iters, variant):
    """Where XLA CPU evaluates the reference without contracting an FMA: no
    passes at all, or the reciprocal loop it keeps as a while loop (iters
    >= 2, feedback), whose ``2 - r`` reads the loop-carried register."""
    return iters == 0 or (op in ("recip", "divide") and variant == "feedback"
                          and iters >= 2)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("p,iters", PAIRS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_bit_parity_on_normals(op, p, iters, variant):
    args = _inputs(op)
    got = _PORT[op](*map(torch.from_numpy, args), p=p, iters=iters,
                    variant=variant).numpy()
    assert np.all(np.abs(got) >= F32(2.0**-126)) and np.all(np.isfinite(got))
    np.testing.assert_array_equal(got.view(np.int32),
                                  _np_op(op, args, p, iters).view(np.int32))
    want = np.asarray(_REF[op](*map(jnp.asarray, args), p=p, iters=iters,
                               variant=variant))
    ulp = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
    assert ulp.max() <= (0 if _reference_unfused(op, p, iters, variant) else 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
class TestSpecialValues:
    def test_signed_zeros(self, dtype):
        z = torch.tensor([0.0, -0.0], dtype=dtype)
        r = gs.gs_reciprocal(z).double()
        assert r[0] == float("inf") and r[1] == float("-inf")
        q = gs.gs_divide(z, torch.tensor([3.0, 3.0], dtype=dtype)).double()
        assert q[0] == 0 and not torch.signbit(q[0]) and torch.signbit(q[1])
        q = gs.gs_divide(torch.tensor([1.0, -1.0], dtype=dtype), z).double()
        assert torch.all(q == float("inf"))  # -1/-0 = +inf
        rs = gs.gs_rsqrt(z).double()
        assert rs[0] == float("inf") and rs[1] == float("-inf")  # IEEE rsqrt(±0)
        sq = gs.gs_sqrt(z).double()
        assert sq[0] == 0 and not torch.signbit(sq[0])
        assert sq[1] == 0 and torch.signbit(sq[1])  # IEEE sqrt(-0) = -0

    def test_inf_nan(self, dtype):
        inf = torch.tensor([float("inf"), float("-inf")], dtype=dtype)
        r = gs.gs_reciprocal(inf).double()
        assert r[0] == 0 and not torch.signbit(r[0]) and torch.signbit(r[1])
        assert torch.isnan(gs.gs_reciprocal(torch.tensor([float("nan")], dtype=dtype))).all()
        two = torch.tensor([2.0, 2.0], dtype=dtype)
        q = gs.gs_divide(inf, two).double()
        assert q[0] == float("inf") and q[1] == float("-inf")
        assert torch.all(gs.gs_divide(two, inf) == 0)
        bad = gs.gs_divide(torch.tensor([float("inf"), 0.0, float("nan")], dtype=dtype),
                           torch.tensor([float("inf"), 0.0, 1.0], dtype=dtype))
        assert torch.isnan(bad).all()
        assert torch.isnan(gs.gs_rsqrt(torch.tensor([-1.0, float("nan")], dtype=dtype))).all()
        assert gs.gs_sqrt(torch.tensor([float("inf")], dtype=dtype)).item() == float("inf")

    def test_subnormal_inputs(self, dtype):
        """vs torch's exact ops on the same (IEEE, no flush) CPU backend:
        the pre-scale peel keeps subnormal operands in bound."""
        fi = torch.finfo(dtype)
        nmant = 7 if dtype == torch.bfloat16 else 23
        sub0 = fi.tiny * 2.0**-nmant  # smallest subnormal
        x = torch.tensor([fi.tiny / 2, fi.tiny / 4, sub0 * 3], dtype=dtype)
        p, iters = gs.precision_policy(dtype)
        bits = min(lut.seed_bits(p) * 2**iters, 21)
        bound = 3.0 * (2.0**-bits + 2.0**-nmant)
        for got, ref in ((gs.gs_reciprocal(x), 1.0 / x), (gs.gs_rsqrt(x), torch.rsqrt(x)),
                         (gs.gs_sqrt(x), torch.sqrt(x))):
            got, ref = got.double(), ref.double()
            inf = torch.isinf(ref)
            assert torch.equal(torch.isinf(got), inf), (got, ref)
            err = (got[~inf] - ref[~inf]).abs()
            assert torch.all(err <= bound * ref[~inf].abs() + 2 * fi.tiny), (got, ref)

    def test_exact_powers_of_two(self, dtype):
        k = torch.tensor([2.0**e for e in range(-40, 41)], dtype=dtype)
        got = gs.gs_reciprocal(k).double()
        ref = 1.0 / k.double()
        if dtype == torch.float32:
            assert torch.equal(got, ref)
        else:
            assert torch.all((got - ref).abs() <= 2.0**-7 * ref)


def test_policy_matches_reference():
    r = np.random.RandomState(3)
    x = (r.randn(6, 50) * 4).astype(F32)
    for mode in ("gs_feedback", "gs_pipelined", "exact"):
        for tb in (None, 8):
            port = policy.NumericsPolicy(mode=mode, target_bits=tb)
            ref = jpolicy.NumericsPolicy(mode=mode, target_bits=tb)
            got = port.softmax(torch.from_numpy(x)).numpy()
            want = np.asarray(ref.softmax(jnp.asarray(x)))
            np.testing.assert_allclose(got, want, rtol=2.0**-20, atol=2.0**-30)
            for dt in ("float32", "bfloat16"):
                assert port.kernel_precision(dt) == ref.kernel_precision(jnp.dtype(dt))


def test_int8_format_not_ported():
    """``quant="int8"`` gives the fixed-point policy; an unknown mode raises
    ``ValueError``, as in the reference (``tests/test_quant.py``)."""
    pol = tinyllama_1_1b.smoke(quant="int8").policy()
    assert pol.is_fixed and pol.fmt.kind == "fixed" and pol.fmt.frac_bits == 24
    assert not tinyllama_1_1b.smoke().policy().is_fixed
    with pytest.raises(ValueError, match="quant"):
        tinyllama_1_1b.smoke(quant="int3").policy()
