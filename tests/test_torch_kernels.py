"""Port's kernel front-end vs the JAX Pallas kernels (interpret mode).

On the CPU the front-end runs each kernel's plain PyTorch version; those
are held against ``repro.kernels.gs_rmsnorm`` and
``repro.kernels.flash_attention`` run as ``tests/test_kernels.py`` runs
them, at the reference's ``ERR_BOUNDS`` (f32 2^-15, bf16 2^-4) and the
rsqrt column within 2^-20 relative; the elementwise reciprocal and
rsqrt/sqrt within 2 f32 ulp (XLA's CPU backend contracts some of the
reference's multiply-adds into FMAs, ROADMAP C1) or one bf16 ulp, with
equal special classes; the softmax within 2^-12 of the value; the four
VJPs and the chunked flash attention against the reference's.  The CUDA
kernels themselves are held against the plain versions by
``tests/test_torch_cuda.py`` (it skips without a card) and by
``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.policy import GS_FEEDBACK as JGS_FEEDBACK  # noqa: E402
from repro.kernels import common as jcommon  # noqa: E402
from repro.kernels import flash_attention as jflash  # noqa: E402
from repro.kernels import gs_recip as jrecip  # noqa: E402
from repro.kernels import gs_rmsnorm as jrms  # noqa: E402
from repro.kernels import gs_rsqrt as jrsqrt  # noqa: E402
from repro.kernels import gs_softmax as jsoftmax  # noqa: E402
from repro.layers import attention as jattention  # noqa: E402
from repro_torch.core.policy import GS_FEEDBACK  # noqa: E402
from repro_torch.kernels import flash_attention as flash_kernel  # noqa: E402
from repro_torch.kernels import gs_elementwise as elementwise_kernel  # noqa: E402
from repro_torch.kernels import gs_rmsnorm as rms_kernel  # noqa: E402
from repro_torch.kernels import gs_softmax as softmax_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.layers import attention as attention_layer  # noqa: E402

BOUND = {"float32": 2.0**-15, "bfloat16": 2.0**-4}
# (dtype, p, iters, variant): each dtype with the pairs its accuracy budget
# resolves to, as the reference's ERR_BOUNDS assume (seed-only (8, 0) is
# accurate to 2^-8, so it is held at the bf16 bound)
PRECISIONS = [("float32", 7, 2, "feedback"), ("float32", 12, 1, "pipelined"),
              ("bfloat16", 8, 0, "feedback"), ("bfloat16", 8, 0, "pipelined")]


def _cast(a: np.ndarray, dtype: str):
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(getattr(torch, dtype))


def _np(t):
    return np.asarray(t, np.float32) if not torch.is_tensor(t) else t.float().numpy()


@pytest.mark.parametrize("rows,d", [(5, 72), (13, 200)])
@pytest.mark.parametrize("dtype,p,iters,variant", PRECISIONS)
def test_rmsnorm_matches_pallas(dtype, rows, d, p, iters, variant):
    r = np.random.RandomState(rows * d + p)
    x = (r.randn(rows, d) * 3).astype(np.float32)
    gain = (1 + 0.1 * r.randn(d)).astype(np.float32)
    jx, tx = _cast(x, dtype)
    want, want_inv = jrms._run(jx, jnp.asarray(gain), eps=1e-5, p=p, iters=iters,
                               variant=variant, block_rows=8, interpret=True,
                               save_inv=True)
    got, got_inv = ops.gs_rmsnorm(tx, torch.from_numpy(gain), eps=1e-5, p=p,
                                  iters=iters, variant=variant, save_inv=True)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert np.abs(_np(got) - _np(want)).max() <= BOUND[dtype]
    np.testing.assert_allclose(got_inv.numpy(), np.asarray(want_inv), rtol=2.0**-20)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,heads,kv_heads", [(8, 4, 2), (33, 8, 2), (64, 8, 4)])
def test_flash_matches_pallas(dtype, s, heads, kv_heads):
    r = np.random.RandomState(s + heads)
    q = r.randn(2, heads, s, 16).astype(np.float32)
    k = r.randn(2, kv_heads, s, 16).astype(np.float32)
    v = r.randn(2, kv_heads, s, 16).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_cast(a, dtype) for a in (q, k, v))
    p, iters = (7, 2) if dtype == "float32" else (8, 0)
    blk = jcommon.fit_block(s, 128)
    want = jflash.flash_attention(jq, jk, jv, causal=True, block_q=blk,
                                  block_kv=blk, p=p, iters=iters, interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert np.abs(_np(got) - _np(want)).max() <= BOUND[dtype]


# ±0, the smallest subnormal, ±inf, NaN, -2, the largest and smallest normal
SPECIALS = np.array([0.0, -0.0, 1e-45, np.inf, -np.inf, np.nan, -2.0,
                     np.finfo(np.float32).max, np.finfo(np.float32).tiny], np.float32)
ELEMENTWISE_SHAPES = [(5, 72), (33, 517), (1, 1), "specials"]
ULPS = {"float32": 2, "bfloat16": 1}  # the elementwise ops' limit against Pallas


def _elementwise_input(shape, seed: int, signed: bool) -> np.ndarray:
    """Magnitudes log-uniform over 2^-60..2^61 (results stay normal: XLA's
    CPU backend flushes subnormal results, ROADMAP C2), or the specials."""
    if shape == "specials":
        return SPECIALS
    r = np.random.RandomState(seed)
    x = np.exp2(r.uniform(-60, 60, shape)) * (1 + r.rand(*shape))
    if signed:
        x *= np.where(r.rand(*shape) < 0.5, -1.0, 1.0)
    return x.astype(np.float32)


def _ordered(bits: np.ndarray) -> np.ndarray:
    """Sign-magnitude bit patterns as integers that count representable
    values (±0 both map to 0)."""
    b = bits.astype(np.int64)
    width = 8 * bits.dtype.itemsize
    mag = b & ((1 << (width - 1)) - 1)
    return np.where(b < 0, -mag, mag)


def _assert_close_in_ulps(got: torch.Tensor, want, ulps: int):
    """Equal special classes (NaN, ±inf, ±0 by sign); finite values at
    most ``ulps`` units in the last place of their dtype apart."""
    w = np.asarray(want)
    if got.dtype == torch.bfloat16:
        g_bits, w_bits = got.view(torch.int16).numpy(), w.view(np.int16)
        g, w = got.float().numpy(), w.astype(np.float32)
    else:
        g = got.numpy()
        g_bits, w_bits = g.view(np.int32), w.view(np.int32)
    assert got.shape == w.shape
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    num = ~np.isnan(w)
    np.testing.assert_array_equal(np.isinf(g[num]), np.isinf(w[num]))
    np.testing.assert_array_equal(g[num] == 0, w[num] == 0)
    np.testing.assert_array_equal(np.signbit(g[num]), np.signbit(w[num]))
    fin = np.isfinite(w)
    dist = np.abs(_ordered(g_bits[fin]) - _ordered(w_bits[fin]))
    assert dist.max(initial=0) <= ulps, f"{dist.max()} ulps apart"


@pytest.mark.parametrize("shape", ELEMENTWISE_SHAPES, ids=str)
@pytest.mark.parametrize("dtype,p,iters,variant", PRECISIONS)
def test_reciprocal_matches_pallas(dtype, shape, p, iters, variant):
    jx, tx = _cast(_elementwise_input(shape, 11, signed=True), dtype)
    want = jrecip._run(jx, p=p, iters=iters, variant=variant, block_rows=64,
                       interpret=True)
    got = ops.gs_recip(tx, p=p, iters=iters, variant=variant)
    assert got.dtype == tx.dtype
    _assert_close_in_ulps(got, want, ULPS[dtype])


@pytest.mark.parametrize("shape", ELEMENTWISE_SHAPES, ids=str)
@pytest.mark.parametrize("dtype,p,iters,variant", PRECISIONS)
def test_rsqrt_sqrt_and_both_match_pallas(dtype, shape, p, iters, variant):
    """The three modes of one datapath; ``sqrt_both`` returns (sqrt, rsqrt)."""
    jx, tx = _cast(_elementwise_input(shape, 12, signed=False), dtype)
    kw = dict(p=p, iters=iters, variant=variant)
    for mode in ("rsqrt", "sqrt", "sqrt_both"):
        want = jrsqrt._run(jx, block_rows=64, interpret=True, mode=mode, **kw)
        got = ref.rsqrt(tx, mode=mode, **kw)
        if mode != "sqrt_both":
            want, got = (want,), (got,)
        for g, w in zip(got, want):
            assert g.dtype == tx.dtype
            _assert_close_in_ulps(g, w, ULPS[dtype])
    _assert_close_in_ulps(ops.gs_rsqrt(tx, **kw), jrsqrt._run(
        jx, block_rows=64, interpret=True, mode="rsqrt", **kw), ULPS[dtype])


@pytest.mark.parametrize("shape", [(16, 384), (5, 200), (3, 1)])
@pytest.mark.parametrize("dtype,p,iters,variant", PRECISIONS)
def test_softmax_matches_pallas(dtype, shape, p, iters, variant):
    """f32 within 2^-12 of the value: exp and the sum's order differ by
    ulps between XLA and torch, a neighbouring ROM word moves a row by
    2^-p >= 2^-8; and within the f32 ERR_BOUNDS row (2^-18) of the exact
    softmax.  bf16 within one ulp."""
    x = (np.random.RandomState(shape[0] * shape[1]).randn(*shape) * 4).astype(np.float32)
    jx, tx = _cast(x, dtype)
    want = jsoftmax._run(jx, p=p, iters=iters, variant=variant, block_rows=8,
                         interpret=True)
    got = ops.gs_softmax(tx, p=p, iters=iters, variant=variant)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    if dtype == "bfloat16":
        _assert_close_in_ulps(got, want, 1)
        return
    w = np.asarray(want)
    assert (np.abs(got.numpy() - w) <= 2.0**-12 * w).all()
    assert np.abs(got.numpy() - ref.softmax_exact(tx).numpy()).max() <= 2.0**-18


VJPS = {"gs_recip": (jrecip.gs_recip, ops.gs_recip, False),
        "gs_rsqrt": (jrsqrt.gs_rsqrt, ops.gs_rsqrt, False),
        "gs_sqrt": (jrsqrt.gs_sqrt, ops.gs_sqrt, False),
        "gs_softmax": (jsoftmax.gs_softmax, ops.gs_softmax, True)}


@pytest.mark.parametrize("name", sorted(VJPS))
@pytest.mark.parametrize("p,iters,variant", [(7, 2, "feedback"), (12, 1, "pipelined")])
def test_vjps_match_the_reference(name, p, iters, variant):
    """``torch.autograd.grad`` through the front-end against ``jax.vjp``
    through the Pallas custom_vjp, within 2^-18 of the largest element."""
    jfn, tfn, rows = VJPS[name]
    r = np.random.RandomState(len(name) + p)
    x = (r.randn(6, 40) * 3 if rows else r.uniform(0.05, 20.0, (6, 40))).astype(np.float32)
    g = r.randn(6, 40).astype(np.float32)
    kw = dict(p=p, iters=iters, variant=variant)
    _, vjp = jax.vjp(lambda a: jfn(a, interpret=True, **kw), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad(tfn(tx, **kw), tx, torch.from_numpy(g))
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 2.0**-18 * np.abs(want).max()


@pytest.mark.parametrize("block", [64, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_chunked_matches_the_reference(dtype, block):
    r = np.random.RandomState(block)
    q = r.randn(1, 64, 4, 16).astype(np.float32)
    k, v = (r.randn(1, 64, 2, 16).astype(np.float32) for _ in range(2))
    (jq, tq), (jk, tk), (jv, tv) = (_cast(a, dtype) for a in (q, k, v))
    want = jattention.flash_chunked(jq, jk, jv, policy=JGS_FEEDBACK, causal=True,
                                    q_block=block, kv_block=block)
    got = attention_layer.flash_chunked(tq, tk, tv, policy=GS_FEEDBACK, causal=True,
                                        q_block=block, kv_block=block)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert np.abs(_np(got) - _np(want)).max() <= BOUND[dtype]


def test_cpu_tensors_take_plain_versions_and_count_no_launch():
    ops.reset_launch_counts()
    x = torch.randn(3, 64)
    np.testing.assert_array_equal(
        ops.gs_rmsnorm(x, torch.ones(64)).numpy(),
        ref.rmsnorm(x, torch.ones(64), eps=1e-6, p=7, iters=2, variant="feedback").numpy())
    q = torch.randn(1, 4, 5, 64)
    ops.flash_attention(q, q[:, :2], q[:, :2])
    x = torch.rand(3, 64) + 0.5
    for op, plain in ((ops.gs_recip, ref.reciprocal), (ops.gs_rsqrt, ref.rsqrt),
                      (ops.gs_softmax, ref.softmax)):
        np.testing.assert_array_equal(
            op(x).numpy(), plain(x, p=7, iters=2, variant="feedback").numpy())
    np.testing.assert_array_equal(
        ops.gs_sqrt(x).numpy(), ref.rsqrt(x, p=7, iters=2, variant="feedback",
                                          mode="sqrt").numpy())
    assert ops.launch_counts() == {"gs_rmsnorm": 0, "flash_attention": 0,
                                   "flash_attention_bwd_dq": 0,
                                   "flash_attention_bwd_dkv": 0, "gs_adam": 0,
                                   "gs_fixed_recip": 0, "gs_fixed_softmax": 0,
                                   "gs_fixed_rmsnorm": 0, "gs_recip": 0, "gs_rsqrt": 0,
                                   "gs_softmax": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never run a CPU path of their own."""
    with pytest.raises(ValueError, match="CUDA"):
        rms_kernel.gs_rmsnorm(torch.randn(2, 64), torch.ones(64), eps=1e-6, p=7,
                              iters=2, variant="feedback")
    q = torch.randn(1, 2, 4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        flash_kernel.flash_attention(q, q, q, p=7, iters=2, variant="feedback")
    x = torch.rand(2, 64)
    for call in (lambda: elementwise_kernel.gs_recip(x, p=7, iters=2, variant="feedback"),
                 lambda: elementwise_kernel.gs_rsqrt(x, p=7, iters=2, variant="feedback",
                                               mode="sqrt_both"),
                 lambda: softmax_kernel.gs_softmax(x, p=7, iters=2, variant="feedback")):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="device meta"):
        ops.gs_rmsnorm(torch.empty(2, 64, device="meta"), torch.ones(64))
    for op in (ops.gs_recip, ops.gs_rsqrt, ops.gs_sqrt, ops.gs_softmax):
        with pytest.raises(ValueError, match="device meta"):
            op(torch.empty(2, 64, device="meta"))
