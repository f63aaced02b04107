"""The TF32 split arithmetic of the flash backward kernels, on the CPU.

``csrc/flash_attention_bwd.cu`` runs its products on TF32 tensor cores with
each f32 operand split into hi = rna_tf32(x) and lo = rna_tf32(x - hi)
(``csrc/flash_mma.cuh``).  ``kernels.ref.tf32_round`` mirrors
``cvt.rna.tf32.f32`` and ``kernels.ref.split_matmul`` the passes; here:

* ``tf32_round`` against hand-computed bit patterns (ties away from zero,
  the carry into the exponent, overflow to inf, inf/NaN/±0 unchanged,
  subnormals) and against an independent f64 rounding on random normals;
* the attention backward with every product through ``split_matmul(..., 3)``
  within 2^-15 of ``ref.attention_bwd`` run in f64, and within 1e-5 of the
  JAX package's Pallas backward (interpret mode);
* three passes at least 16x more accurate than one (why a single TF32 pass
  on f32 data is ruled out);
* on operands exact in TF32 (bf16 values), one pass equals the f32 product
  bit for bit, and two passes equal three;
* at bf16 inputs, the per-q-head dk, dv with two passes on p and ds within
  the card's gate (10x the plain f32 version's error against the f64
  oracle), and one pass outside it.

The flash forward (``csrc/flash_attention.cu``) runs q k^T and p v the same
way, and ``kernels.ref.attention`` takes the same ``product`` hook:

* the forward with both products through ``split_matmul(..., 3)`` within
  1e-5 of the JAX package's Pallas forward (interpret mode), and one pass
  at least 16x less accurate than three against ``ref.attention`` in f64;
* with the default hook, ``ref.attention`` bit-equal to the function as it
  was before it took the hook (its f32 numbers are what the tests against
  the JAX package hold).

The kernels themselves are held against these on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jflash  # noqa: E402
from repro_torch.core.goldschmidt import rom  # noqa: E402
from repro_torch.kernels import common, ref  # noqa: E402

KW = dict(p=7, iters=2, variant="feedback")

# (f32 word in, TF32 word out) for cvt.rna.tf32.f32
BIT_CASES = {
    "one": (0x3F800000, 0x3F800000),
    "below_tie": (0x3F800FFF, 0x3F800000),
    "tie_even_up": (0x3F801000, 0x3F802000),
    "tie_odd_up": (0x3F803000, 0x3F804000),
    "above_tie": (0x3F801001, 0x3F802000),
    "negative_tie": (0xBF801000, 0xBF802000),
    "negative_below_tie": (0xBF800FFF, 0xBF800000),
    "carry_into_exponent": (0x3FFFF000, 0x40000000),
    "largest_tf32": (0x7F7FE000, 0x7F7FE000),
    "largest_f32_to_inf": (0x7F7FFFFF, 0x7F800000),
    "plus_inf": (0x7F800000, 0x7F800000),
    "minus_inf": (0xFF800000, 0xFF800000),
    "quiet_nan_payload": (0x7FC00001, 0x7FC00001),
    "nan_low_bits_only": (0x7F800001, 0x7F800001),
    "plus_zero": (0x00000000, 0x00000000),
    "minus_zero": (0x80000000, 0x80000000),
    "subnormal_tie": (0x00001000, 0x00002000),
    "subnormal_below_tie": (0x00000FFF, 0x00000000),
    "subnormal_carry_to_normal": (0x007FF000, 0x00800000),
    "negative_subnormal": (0x80001800, 0x80002000),
}


def _word(x: int) -> torch.Tensor:
    return torch.tensor([np.uint32(x).view(np.int32)], dtype=torch.int32).view(torch.float32)


@pytest.mark.parametrize("case", sorted(BIT_CASES))
def test_tf32_round_bit_patterns(case):
    word_in, word_out = BIT_CASES[case]
    got = ref.tf32_round(_word(word_in)).view(torch.int32).item()
    assert np.int32(got).view(np.uint32) == word_out, f"{case}: {got & 0xFFFFFFFF:#010x}"


def test_tf32_round_matches_an_f64_rounding():
    r = np.random.RandomState(0)
    x = (r.randn(20000) * np.exp(r.uniform(-60, 60, 20000))).astype(np.float32)
    got = ref.tf32_round(torch.from_numpy(x)).numpy().astype(np.float64)
    x64 = x.astype(np.float64)
    ulp = np.exp2(np.floor(np.log2(np.abs(x64))) - 10)  # 10 fraction bits
    want = np.sign(x64) * np.floor(np.abs(x64) / ulp + 0.5) * ulp  # ties away from zero
    np.testing.assert_array_equal(got, want)
    words = torch.from_numpy(got.astype(np.float32)).view(torch.int32)
    assert int((words & 0x1FFF).abs().max()) == 0
    assert torch.equal(ref.tf32_round(torch.from_numpy(got.astype(np.float32))),
                       torch.from_numpy(got.astype(np.float32)))


def _bwd_inputs(s=97, h=4, kh=2, d=64, seed=0):
    r = np.random.RandomState(seed)
    mk = lambda n: torch.from_numpy(r.randn(2, n, s, d).astype(np.float32))  # noqa: E731
    return mk(h), mk(kh), mk(kh), mk(h)


def _split(passes):
    return lambda eq, a, b: ref.split_matmul(a, b, passes, eq)


def _max_err(got, want) -> float:
    """Max error over the largest element of ``want``, worst of dq, dk, dv."""
    return max(((a.double() - b).abs().max() / b.abs().max()).item()
               for a, b in zip(got, want))


@pytest.mark.parametrize("causal", [True, False])
def test_three_passes_match_the_f64_oracle(causal):
    q, k, v, do = _bwd_inputs()
    kw = dict(causal=causal, **KW)
    out, m, l = ref.attention(q, k, v, residuals=True, **kw)
    oracle = ref.attention_bwd(q.double(), k.double(), v.double(), do, out, m, l, **kw)
    assert all(t.dtype == torch.float64 for t in oracle)
    split = ref.attention_bwd(q, k, v, do, out, m, l, product=_split(3), **kw)
    assert all(t.dtype == torch.float32 for t in split)
    assert _max_err(split, oracle) <= 2.0**-15
    one = ref.attention_bwd(q, k, v, do, out, m, l, product=_split(1), **kw)
    assert _max_err(one, oracle) >= 16 * _max_err(split, oracle)


def _bf16_passes(p_passes):
    """The kernels' passes at bf16 inputs: one where both operands are bf16
    values (s and dp), ``p_passes`` where p or ds, f32, is the left one."""
    return lambda eq, a, b: ref.split_matmul(a, b, p_passes if eq.startswith("bkgst") else 1,
                                             eq)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_per_head_dkv_passes_and_one_pass_fails_the_oracle_gate(causal):
    """The card's bf16 gate on the dk/dv kernel's f32 per-q-head output: max
    |error| against the f64 oracle at most 10x the plain f32 version's.  Two
    passes with p and ds stay inside it; one pass does not."""
    q, k, v, do = (t.to(torch.bfloat16) for t in _bwd_inputs(s=97, h=8, kh=2, seed=3))
    kw = dict(causal=causal, p=8, iters=0, variant="feedback")
    out, m, l = ref.attention(q, k, v, residuals=True, **kw)
    ke, ve = (t.repeat_interleave(4, dim=1) for t in (k, v))
    oracle = ref.attention_bwd(q.double(), ke.double(), ve.double(), do, out, m, l, **kw)[1:]
    runs = {name: ref.attention_bwd(q, ke.float(), ve.float(), do, out, m, l, product=prod,
                                    **kw)[1:]
            for name, prod in (("plain", torch.einsum), ("two", _bf16_passes(2)),
                               ("one", _bf16_passes(1)))}
    for i in range(2):
        err = {name: (got[i].double() - oracle[i]).abs().max().item()
               for name, got in runs.items()}
        assert runs["two"][i].dtype == torch.float32
        assert err["two"] <= 10 * err["plain"]
        assert err["one"] > 10 * err["plain"]


def test_three_passes_match_the_pallas_backward():
    q, k, v, do = _bwd_inputs(s=64, d=32, seed=1)
    fwd = lambda a, b, c: jflash.flash_attention(  # noqa: E731
        a, b, c, causal=True, block_q=32, block_kv=32, p=7, iters=2, interpret=True,
        block_q_bwd=32, block_kv_bwd=32)
    _, vjp = jax.vjp(fwd, *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = vjp(jnp.asarray(do.numpy()))
    out, m, l = ref.attention(q, k, v, residuals=True, causal=True, **KW)
    got = ref.attention_bwd(q, k, v, do, out, m, l, causal=True, product=_split(3), **KW)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = np.asarray(b, np.float64)
        assert a.shape == b.shape, name
        assert np.abs(a.numpy() - b).max() / np.abs(b).max() < 1e-5, name


@pytest.mark.parametrize("causal", [True, False])
def test_forward_three_passes_match_pallas_and_one_pass_does_not(causal):
    q, k, v, _ = _bwd_inputs(s=97, h=8, kh=2, seed=4)
    kw = dict(causal=causal, **KW)
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    want, _, _ = jflash._fwd_call(jq, jk, jv, causal, 1.0 / math.sqrt(64), 97, 97, 7, 2,
                                  "feedback", True, False)
    want = np.asarray(want, np.float64)
    three = ref.attention(q, k, v, product=_split(3), **kw)
    assert three.dtype == torch.float32
    assert np.abs(three.numpy() - want).max() / np.abs(want).max() < 1e-5
    oracle = ref.attention(q.double(), k.double(), v.double(), **kw)
    assert oracle.dtype == torch.float64
    one = ref.attention(q, k, v, product=_split(1), **kw)
    err3, err1 = ((t.double() - oracle).abs().max().item() for t in (three, one))
    assert err1 >= 16 * err3


def _attention_before_the_hook(q, k, v, *, causal, p, iters, variant):
    """``ref.attention`` with residuals, as it was before it took a
    ``product`` hook."""
    b, h, s, d = q.shape
    kh = k.shape[1]
    qf = q.to(torch.float32).reshape(b, kh, h // kh, s, d)
    logits = torch.einsum("bkgsd,bktd->bkgst", qf, k.to(torch.float32)) * (1.0 / math.sqrt(d))
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool).tril()
        logits = logits.masked_fill(~keep, common.NEG_INF)
    m = torch.amax(logits, dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    l = torch.sum(e, dim=-1, keepdim=True)
    inv = common.recip_positive(l.clamp_min(1e-30), rom("recip", p, "cpu"), p=p,
                                iters=iters, variant=variant)
    acc = torch.einsum("bkgst,bktd->bkgsd", e, v.to(torch.float32))
    out = (acc * inv).reshape(b, h, s, d).to(q.dtype)
    return out, m.reshape(b, h, s), l.reshape(b, h, s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_default_hook_is_bit_equal_to_the_attention_before_it(dtype, causal):
    q, k, v, _ = (t.to(dtype) for t in _bwd_inputs(s=97, h=8, kh=2, seed=5))
    kw = dict(causal=causal, **KW)
    got = ref.attention(q, k, v, residuals=True, **kw)
    want = _attention_before_the_hook(q, k, v, **kw)
    ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got[0].view(ints), want[0].view(ints))
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == torch.float32 and torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(ref.attention(q, k, v, **kw).view(ints), want[0].view(ints))


@pytest.mark.parametrize("equation", ["...ij,...jk->...ik", "bkgst,bktd->bkgsd",
                                      "bkgst,bkgsd->bktd"])
def test_tf32_exact_operands(equation):
    r = np.random.RandomState(2)
    shape_a, shape_b = {"...ij,...jk->...ik": ((3, 17, 40), (3, 40, 9)),
                        "bkgst,bktd->bkgsd": ((1, 2, 2, 13, 13), (1, 2, 13, 16)),
                        "bkgst,bkgsd->bktd": ((1, 2, 2, 13, 13), (1, 2, 2, 13, 16))}[equation]
    a, b = (torch.from_numpy(r.randn(*sh).astype(np.float32)).to(torch.bfloat16).float()
            for sh in (shape_a, shape_b))
    exact = torch.einsum(equation, a, b)
    one = ref.split_matmul(a, b, 1, equation)
    assert torch.equal(one.view(torch.int32), exact.view(torch.int32))
    assert torch.equal(ref.split_matmul(a, b, 3, equation), exact)
    # an f32 left operand against an exact right one: two passes are the three
    a32 = torch.from_numpy(r.randn(*shape_a).astype(np.float32))
    assert torch.equal(ref.split_matmul(a32, b, 2, equation),
                       ref.split_matmul(a32, b, 3, equation))


def test_split_matmul_refuses_other_pass_counts():
    with pytest.raises(ValueError):
        ref.split_matmul(torch.ones(2, 2), torch.ones(2, 2), 4)
