"""Port's backward rules vs the JAX package's (CPU, numpy-seeded inputs).

* The four Goldschmidt VJPs (``repro_torch.core.goldschmidt``) against
  ``jax.grad`` of ``repro.core.goldschmidt``: within 2^-20 relative to the
  largest element (the rules are the same expressions on a forward output
  that XLA may round an ulp apart by contracting a multiply-add).
* The RMSNorm autograd rule against ``jax.vjp`` of ``repro.kernels.ops
  .gs_rmsnorm``, and the flash forward residuals and ``attention_bwd``
  against ``jax.vjp`` of ``repro.kernels.flash_attention.flash_attention``,
  both Pallas kernels in interpret mode as ``tests/test_grads.py`` runs
  them: f32 within 1e-5 relative to the largest element (sums taken in
  another order).
* The plain fused AdamW (``kernels.ref.adam_update``) against
  ``repro.kernels.gs_adam.gs_adam_update`` (interpret) over three steps:
  within 2 f32 ulp per element at the scale of the terms of its last sum
  (see the test for why).

The CUDA kernels themselves are held against these plain versions by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import goldschmidt as jgs  # noqa: E402
from repro.kernels import flash_attention as jflash  # noqa: E402
from repro.kernels import gs_adam as jadam  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import goldschmidt as gs  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as flash_bwd_kernel  # noqa: E402
from repro_torch.kernels import gs_adam as adam_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

VARIANTS = ("feedback", "pipelined")


def _maxrel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _pos(shape, seed):
    r = np.random.RandomState(seed)
    return np.exp(r.uniform(-3, 3, shape)).astype(np.float32)


def _leaf(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).requires_grad_()


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("op", ["gs_reciprocal", "gs_rsqrt", "gs_sqrt"])
def test_unary_vjp_matches_jax(op, variant):
    x = _pos((257,), 1)
    g = np.random.RandomState(2).randn(257).astype(np.float32)
    _, vjp = jax.vjp(lambda a: getattr(jgs, op)(a, variant=variant), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    t = _leaf(x)
    (got,) = torch.autograd.grad(getattr(gs, op)(t, variant=variant), t, torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == t.shape
    assert _maxrel(got.numpy(), want) < 2.0**-20


@pytest.mark.parametrize("variant", VARIANTS)
def test_divide_vjp_matches_jax_with_broadcast(variant):
    n = np.random.RandomState(3).randn(6, 40).astype(np.float32)
    d = _pos((40,), 4)
    g = np.random.RandomState(5).randn(6, 40).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jgs.gs_divide(a, b, variant=variant),
                     jnp.asarray(n), jnp.asarray(d))
    want_n, want_d = vjp(jnp.asarray(g))
    tn, td = _leaf(n), _leaf(d)
    got_n, got_d = torch.autograd.grad(gs.gs_divide(tn, td, variant=variant), (tn, td),
                                       torch.from_numpy(g))
    assert got_n.shape == tn.shape and got_d.shape == td.shape
    assert _maxrel(got_n.numpy(), want_n) < 2.0**-20
    assert _maxrel(got_d.numpy(), want_d) < 2.0**-20


def test_policy_softmax_differentiates_through_the_reciprocal():
    from repro.core.policy import GS_FEEDBACK as JPOL
    from repro_torch.core.policy import GS_FEEDBACK as POL

    x = np.random.RandomState(6).randn(3, 17).astype(np.float32) * 4
    g = np.random.RandomState(7).randn(3, 17).astype(np.float32)
    _, vjp = jax.vjp(lambda a: JPOL.softmax(a), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    t = _leaf(x)
    (got,) = torch.autograd.grad(POL.softmax(t), t, torch.from_numpy(g))
    assert _maxrel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("rows,d", [(7, 64), (12, 200)])
def test_rmsnorm_vjp_matches_jax(rows, d):
    r = np.random.RandomState(rows + d)
    x = (r.randn(2, rows, d) * 3).astype(np.float32)
    gain = (1 + 0.1 * r.randn(d)).astype(np.float32)
    g = r.randn(2, rows, d).astype(np.float32)
    want_y, vjp = jax.vjp(lambda a, w: jops.gs_rmsnorm(a, w, eps=1e-5),
                          jnp.asarray(x), jnp.asarray(gain))
    want_dx, want_dgain = vjp(jnp.asarray(g))
    tx, tg = _leaf(x), _leaf(gain)
    y = ops.gs_rmsnorm(tx, tg, eps=1e-5)
    dx, dgain = torch.autograd.grad(y, (tx, tg), torch.from_numpy(g))
    assert _maxrel(y.detach().numpy(), want_y) < 1e-6
    assert dx.shape == tx.shape and dgain.shape == tg.shape
    assert _maxrel(dx.numpy(), want_dx) < 1e-5
    assert _maxrel(dgain.numpy(), want_dgain) < 1e-5


# (S, reference block): one block, several blocks (its online rescale), and
# a ragged S the reference tiles with a divisor block of 11
FLASH_CASES = [(32, 32), (32, 16), (33, 11)]


def _flash_inputs(s, heads=4, kv_heads=2, d=16, seed=0):
    r = np.random.RandomState(seed + s)
    mk = lambda h: r.randn(2, h, s, d).astype(np.float32)  # noqa: E731
    return mk(heads), mk(kv_heads), mk(kv_heads), mk(heads)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,block", FLASH_CASES)
def test_flash_residuals_match_pallas(s, block, causal):
    q, k, v, _ = _flash_inputs(s)
    out, m, l = jflash._fwd_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                                 0.25, block, block, 7, 2, "feedback", True, True)
    got, got_m, got_l = ref.attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                      p=7, iters=2, variant="feedback", residuals=True)
    assert got_m.shape == got_l.shape == (2, 4, s) and got_l.dtype == torch.float32
    assert _maxrel(got.numpy(), out) < 1e-5
    np.testing.assert_allclose(got_m.numpy(), np.asarray(m), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(l), rtol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,block", FLASH_CASES)
def test_flash_bwd_matches_pallas_vjp(s, block, causal):
    q, k, v, do = _flash_inputs(s, seed=1)
    fwd = lambda a, b, c: jflash.flash_attention(  # noqa: E731
        a, b, c, causal=causal, block_q=block, block_kv=block, p=7, iters=2,
        interpret=True, block_q_bwd=block, block_kv_bwd=block)
    _, vjp = jax.vjp(fwd, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    kw = dict(causal=causal, p=7, iters=2, variant="feedback")
    out, m, l = ref.attention(tq, tk, tv, residuals=True, **kw)
    got = ref.attention_bwd(tq, tk, tv, torch.from_numpy(do), out, m, l, **kw)
    for name, a, b in zip("dq dk dv".split(), got, want):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        assert _maxrel(a.numpy(), b) < 1e-5, name
    # the front-end's autograd rule routes CPU tensors to the same plain versions
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    front = torch.autograd.grad(ops.flash_attention(*leaves, **kw), leaves,
                                torch.from_numpy(do))
    for a, b in zip(front, got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_flash_bwd_bf16_keeps_the_reference_dtypes():
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in _flash_inputs(24))
    kw = dict(causal=True, p=8, iters=0, variant="feedback")
    out, m, l = ref.attention(q, k, v, residuals=True, **kw)
    dq, dk, dv = ref.attention_bwd(q, k, v, do, out, m, l, **kw)
    assert (m.dtype, l.dtype) == (torch.float32, torch.float32)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.bfloat16,) * 3
    assert dk.shape == k.shape and dq.shape == q.shape


def _within_2_ulp(got, want, scale) -> bool:
    """|got - want| <= 2 f32 ulp at ``scale``, elementwise."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    return bool(np.all(err <= 2 * np.spacing(np.abs(scale).astype(np.float32))))


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adam_update_matches_pallas_within_2_ulp(weight_decay):
    """Three steps, each from the same state for both.  XLA's CPU backend
    contracts the reference's multiply-adds into FMAs (ROADMAP C) and the
    port keeps them apart, which moves a sum by up to half an ulp of its
    larger term; so each output is held within 2 ulp at the scale of the
    terms of its last sum (the result's own scale where they do not
    cancel)."""
    r = np.random.RandomState(8)
    n = 1000  # not a multiple of the reference's (32, 128) tile
    b1, b2, lr = 0.9, 0.95, 1e-3
    hp = dict(beta1=b1, beta2=b2, eps=1e-8, weight_decay=weight_decay)
    w = r.randn(n).astype(np.float32)
    m, v = np.zeros(n, np.float32), np.zeros(n, np.float32)
    for step in (1, 2, 3):
        g = (r.randn(n) * 10.0 ** r.uniform(-4, 1, n)).astype(np.float32)
        g[::97] = 0.0  # untouched elements: v stays 0, the 1e-38 clamp
        want = jadam.gs_adam_update(*map(jnp.asarray, (w, g, m, v)), jnp.asarray(step),
                                    lr=lr, p=7, iters=2, interpret=True, **hp)
        bc = ops.adam_scalars(step, lr, beta1=b1, beta2=b2, device="cpu")
        got = [t.numpy() for t in ops.gs_adam_update(*map(torch.from_numpy, (w, g, m, v)),
                                                     bc, **hp)]
        assert all(t.dtype == np.float32 for t in got)
        f32 = np.float32
        scale_m = np.maximum(np.abs(f32(b1) * m), np.abs(f32(1 - b1) * g))
        scale_v = np.maximum(np.abs(f32(b2) * v), np.abs(f32(1 - b2) * g * g))
        scale_p = np.maximum(np.abs(w), np.abs(np.asarray(want[0]) - w))
        for name, a, b, scale in zip("pmv", got, want, (scale_p, scale_m, scale_v)):
            assert _within_2_ulp(a, b, scale), (step, name)
        w, m, v = got


def test_cpu_training_ops_launch_no_kernel():
    ops.reset_launch_counts()
    q = torch.randn(1, 4, 9, 16, requires_grad=True)
    kv = torch.randn(1, 2, 9, 16, requires_grad=True)
    ops.flash_attention(q, kv, kv).sum().backward()
    x = torch.randn(3, 16, requires_grad=True)
    ops.gs_rmsnorm(x, torch.ones(16)).sum().backward()
    bc = ops.adam_scalars(1, 1e-3, beta1=0.9, beta2=0.95, device="cpu")
    ops.gs_adam_update(torch.randn(5), torch.randn(5), torch.zeros(5), torch.zeros(5), bc)
    assert set(ops.launch_counts().values()) == {0}
    assert q.grad is not None and kv.grad is not None and x.grad is not None


def test_new_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never run a CPU path of their own."""
    q = torch.randn(1, 2, 4, 16)
    st = torch.zeros(1, 2, 4)
    kw = dict(causal=True, sm_scale=0.25, p=7, iters=2, variant="feedback")
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd_kernel.dq(q, q, q, q, st, st, st, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd_kernel.dkv(q, q, q, q, st, st, st, **kw)
    bc = torch.ones(3)
    with pytest.raises(ValueError, match="CUDA"):
        adam_kernel.gs_adam_update(torch.ones(4), torch.ones(4), torch.ones(4), torch.ones(4),
                                   bc, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.0,
                                   p=7, iters=2, variant="feedback")

