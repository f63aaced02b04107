"""Port's int8 serving path vs ``repro`` (smoke tinyllama, f32, quant="int8").

* ``quantize_params`` on bridged parameters bit-equal to the reference's in
  its stacked layout (one scale per weight name over all layers, the
  per-layer norm gains quantized too), ``dequantize_params`` equal too.
* ``kv_quantize`` / ``kv_cast`` / ``kv_dequantize`` bit-equal, half steps
  and values beyond ``KV_AMAX`` included.
* The plain ``fixed_recip`` / ``fixed_rmsnorm`` / ``fixed_softmax`` against
  the reference's Pallas kernels in interpret mode on the three formats of
  ``benchmarks/bench_kernels.py`` and ragged shapes: recip bit-equal;
  rmsnorm bit-equal to an unfused numpy f32 twin and within 2 x the
  format's error bound of the reference (XLA may contract ``ms``'s
  multiply-add, ROADMAP C1); softmax within 2 x the bound (its exp and row
  sum are torch's and XLA's own).
* ``norms.rmsnorm`` under the int8 policy against the reference's
  ``kernel_impl="pallas"`` norm, within 2 x the bound.
* Prefill and three decode steps of the int8 smoke model (int8 KV cache)
  within 1e-3 of the largest |logit| of the reference's.
* The int8 ``Engine`` token for token with ``repro.serving.Engine`` under
  ``quant="int8"``, ``kernel_impl="pallas"``, on the staggered trace of
  ``test_torch_serving.py`` at n_slots 1, 2 and 4; the reference's own
  invariances (first token equal to the f32 sequential run, shared-prompt
  requests equal); resident bytes.

The reference's kernel fallback is switched off here, so a Pallas failure
fails the test instead of running the float oracle.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.core import fixed_point_jax as fpj  # noqa: E402
from repro.core import formats as jformats  # noqa: E402
from repro.kernels import gs_fixed as jfixed  # noqa: E402
from repro.kernels.tuning import dispatch  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.layers import norms as jnorms  # noqa: E402
from repro.layers import quant as jquant  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serving import cache as jcache  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.core import formats  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.steps import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.layers import norms, quant  # noqa: E402
from repro_torch.serving import (FINISH_LENGTH, Engine, EngineConfig, Request,  # noqa: E402
                                 SlotCachePool, generate_sequential)

F32 = dict(dtype="float32", param_dtype="float32")
TRACE = [(6, 5, 0.0), (9, 8, 0.0), (13, 3, 0.01), (9, 6, 0.02), (6, 7, 0.02),
         (13, 4, 0.03)]  # test_torch_serving.py's staggered trace


def _bench_formats(m):
    """benchmarks/bench_kernels.py's three fixed formats, from module ``m``."""
    return {"frac24": m.format_for("int8"), "frac30": m.NumericFormat.fixed(30),
            "mitchell": m.NumericFormat.fixed(24, p=7, mitchell_iters=1)}


FORMATS = _bench_formats(formats)


@pytest.fixture(scope="module", autouse=True)
def no_reference_fallback():
    dispatch.enable_fallback(False)
    yield
    dispatch.enable_fallback(None)


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.get_smoke("tinyllama-1.1b", **F32)
    cfg = configs.get_smoke("tinyllama-1.1b", **F32)
    jparams = japi.init(jcfg, jax.random.key(0))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    jcfg_q = dataclasses.replace(jcfg, quant="int8", kernel_impl="pallas")
    cfg_q = dataclasses.replace(cfg, quant="int8")
    return jcfg, jparams, cfg, params, jcfg_q, cfg_q


# -- weights and KV ------------------------------------------------------------


def test_quantize_params_matches_the_stacked_reference(model):
    jcfg, jparams, cfg, params, _, _ = model
    jq = jax.tree.map(np.asarray, jquant.quantize_params(jparams))
    q = quant.quantize_params(params)
    assert quant.is_quantized(q) and quant.quantize_params(q) is q
    got_q = bridge.params_to_numpy(q["q"])
    assert jax.tree.structure(got_q) == jax.tree.structure(jq["q"])
    for path, want in jax.tree_util.tree_leaves_with_path(jq["q"]):
        got = got_q
        for key in path:
            got = got[key.key]
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=str(path))
    # the stacked norm gains are 2-D there, so they quantize; final_norm passes
    assert jq["q"]["layers"]["pos0"]["norm1"]["scale"].dtype == np.int8
    assert q["q"]["layers"][0]["norm1"]["scale"].dtype == torch.int8
    assert q["q"]["final_norm"]["scale"].dtype == torch.float32
    # one scale per stacked leaf: every layer holds the reference's scalar
    for name in ("wq", "wo"):
        want = jq["s"]["layers"]["pos0"]["attn"][name]
        for layer in q["s"]["layers"]:
            assert np.float32(layer["attn"][name].item()) == want
    np.testing.assert_array_equal(q["s"]["embed"].numpy(), jq["s"]["embed"])
    deq = bridge.params_to_numpy(quant.dequantize_params(q))
    jdeq = jax.tree.map(np.asarray, jquant.dequantize_params(jquant.quantize_params(jparams)))
    for a, b in zip(jax.tree.leaves(deq), jax.tree.leaves(jdeq)):
        np.testing.assert_array_equal(a, b)
    view = quant.maybe_dequantize(q)  # leaves dequantized as they are read
    full = quant.dequantize_params(q)
    for name in ("wq", "wo"):
        np.testing.assert_array_equal(view["layers"][1]["attn"][name].numpy(),
                                      full["layers"][1]["attn"][name].numpy())
    np.testing.assert_array_equal(view["embed"].numpy(), full["embed"].numpy())
    assert quant.maybe_dequantize(params) is params
    assert quant.tree_bytes(q) == jquant.tree_bytes(jquant.quantize_params(jparams))


def _half_steps():
    """f32 values whose quotient by the f32 KV scale is exactly k + 0.5."""
    s = np.float32(formats.KV_SCALE)
    cand = ((np.arange(-130, 130) + 0.5).astype(np.float32) * s).astype(np.float32)
    cand = np.concatenate([cand, np.nextafter(cand, np.float32(np.inf)),
                           np.nextafter(cand, np.float32(-np.inf))])
    q = cand / s
    return cand[(q - np.floor(q)) == np.float32(0.5)]


def test_kv_quantization_bit_equal():
    r = np.random.RandomState(3)
    halves = _half_steps()
    assert halves.size > 20  # ties to even are exercised
    x = np.concatenate([r.randn(500).astype(np.float32) * 2, halves,
                        np.float32([0.0, -0.0, 4.0, -4.0, 4.02, -4.02, 5.0, -9.5, 100.0,
                                    -1e6])])
    got = formats.kv_quantize(torch.from_numpy(x)).numpy()
    want = np.asarray(jformats.kv_quantize(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    assert got.max() == 127 and got.min() == -127
    for dt, jdt in ((torch.int8, jnp.int8), (torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        c = formats.kv_cast(torch.from_numpy(x), dt)
        jc = jformats.kv_cast(jnp.asarray(x), jdt)
        np.testing.assert_array_equal(c.float().numpy(), np.asarray(jc.astype(jnp.float32)))
        np.testing.assert_array_equal(formats.kv_dequantize(c).numpy(),
                                      np.asarray(jformats.kv_dequantize(jc)))
    assert formats.KV_SCALE == jformats.KV_SCALE and formats.KV_AMAX == jformats.KV_AMAX


# -- the plain fixed kernels against the Pallas kernels ---------------------------


def _int8(shape, seed):
    x = np.random.RandomState(seed).randint(-127, 128, shape).astype(np.int8)
    return x


def _np_fixed_rmsnorm(x, scale, gain, eps, fmt):
    """Unfused numpy f32 twin of the fixed rmsnorm; the rsqrt register comes
    from the reference's integer datapath (no float in it)."""
    f32 = np.float32
    d = x.shape[-1]
    ss = np.sum(x.astype(np.int64) ** 2, axis=-1, keepdims=True).astype(f32)
    sc = f32(scale)
    ms = f32(f32(f32(ss * f32(sc * sc)) * f32(1.0 / d)) + f32(eps))
    bits = ms.view(np.uint32).astype(np.int64)
    eb = (bits >> 23) & 0xFF
    mant = (bits & 0x7FFFFF) | (1 << 23)
    F, p = fmt.frac_bits, fmt.p
    ebits = eb - 127
    half_e = ebits >> 1
    m_reg = (mant << (F - 23) if F >= 23 else mant >> (23 - F)) << (ebits - 2 * half_e)
    idx = np.clip(((m_reg - (1 << F)) >> (F - p)) // 3, 0, (1 << p) - 1)
    from repro.core import lut as jlut
    y0 = jlut.rsqrt_table_int(p).astype(np.int64)[idx] << (F - p - 2)
    h2 = np.asarray(fpj.FixedPointJax(p=p, frac_bits=F).rsqrt_reg(
        jnp.asarray(m_reg.astype(np.uint32)), fmt.iters, y0=jnp.asarray(y0.astype(np.uint32))))
    inv = f32(h2.astype(f32) * f32(2.0 ** -F)) * ((np.clip(127 - half_e, 0, 254) << 23)
                                                   .astype(np.int32).view(f32))
    return f32(f32(f32(x.astype(f32) * sc) * inv) * gain)


@pytest.mark.parametrize("shape", [(64, 128), (37, 200), (3, 5, 40)])
@pytest.mark.parametrize("fmt_name", list(FORMATS))
@pytest.mark.parametrize("variant", ["feedback", "pipelined"])
def test_plain_fixed_kernels_match_pallas(shape, fmt_name, variant):
    fmt, jfmt = FORMATS[fmt_name], _bench_formats(jformats)[fmt_name]
    kw = dict(fmt.precision(), variant=variant)
    bound = 2 * jfmt.error_bound()
    x = _int8(shape, len(shape) * 100 + shape[-1])
    x.flat[::17] = 0  # recip's +inf lanes
    scale = 0.02
    gain = np.random.RandomState(9).randn(shape[-1]).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)

    got = ref.fixed_recip(tx, scale, **kw).numpy()
    want = np.asarray(jfixed.gs_fixed_recip(jx, scale, interpret=True, **kw))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))

    got = ref.fixed_softmax(tx, scale, **kw).numpy()
    want = np.asarray(jfixed.gs_fixed_softmax(jx, scale, interpret=True, **kw))
    np.testing.assert_allclose(got, want, rtol=bound, atol=0)

    rkw = dict(eps=1e-6, p=fmt.p, frac_bits=fmt.frac_bits, iters=fmt.iters)
    got = ref.fixed_rmsnorm(tx, scale, torch.from_numpy(gain), **rkw).numpy()
    twin = _np_fixed_rmsnorm(x, scale, gain, 1e-6, fmt)
    np.testing.assert_array_equal(got.view(np.uint32), twin.view(np.uint32))
    want = np.asarray(jfixed.gs_fixed_rmsnorm(jx, scale, jnp.asarray(gain), interpret=True,
                                              eps=1e-6, **kw))
    np.testing.assert_allclose(got, want, rtol=bound, atol=0)
    # the front-ends take the plain versions for CPU tensors and count nothing
    ops.reset_launch_counts()
    np.testing.assert_array_equal(ops.gs_fixed_rmsnorm(tx, scale, torch.from_numpy(gain),
                                                       **rkw).numpy(), got)
    np.testing.assert_array_equal(ops.gs_fixed_recip(tx, scale, **kw).numpy(),
                                  ref.fixed_recip(tx, scale, **kw).numpy())
    np.testing.assert_array_equal(ops.gs_fixed_softmax(tx, scale, **kw).numpy(),
                                  ref.fixed_softmax(tx, scale, **kw).numpy())
    assert sum(ops.launch_counts().values()) == 0


def test_rmsnorm_int8_policy_matches_reference(model):
    _, _, _, _, jcfg_q, cfg_q = model
    x = (np.random.RandomState(11).randn(2, 7, 64) * 2).astype(np.float32)
    gain = (1 + 0.1 * np.random.RandomState(12).randn(64)).astype(np.float32)
    got = norms.rmsnorm({"scale": torch.from_numpy(gain)}, torch.from_numpy(x), eps=1e-5,
                        policy=cfg_q.policy()).numpy()
    want = np.asarray(jnorms.rmsnorm({"scale": jnp.asarray(gain)}, jnp.asarray(x), eps=1e-5,
                                     policy=jcfg_q.policy(), kernel_impl="pallas"))
    bound = 2 * cfg_q.policy().fmt.error_bound()
    np.testing.assert_allclose(got, want, rtol=bound, atol=0)


# -- the model and the engine --------------------------------------------------------


B, S, S_MAX, STEPS = 2, 11, 24, 3


def test_int8_prefill_and_decode_logits_match(model):
    _, jparams, _, params, jcfg_q, cfg_q = model
    r = np.random.RandomState(5)
    tokens = r.randint(0, cfg_q.vocab, (B, S))
    steps = [r.randint(0, cfg_q.vocab, (B, 1)) for _ in range(STEPS)]
    jq = jquant.quantize_params(jparams)
    jprefill = jax.jit(jsteps.make_prefill_step(jcfg_q))
    jdecode = jax.jit(jsteps.make_decode_step(jcfg_q))
    logits, states, _ = jprefill(jq, {"tokens": jnp.asarray(tokens, jnp.int32)})
    want = [np.asarray(logits)]
    cache = jcache.remap_kv_leaves(japi.make_cache(jcfg_q, B, S_MAX, jnp.float32), jnp.int8)
    cache = jax.tree.map(lambda d, s: jcache._graft_leaf(d, s, (0,) * d.ndim), cache, states)
    for i, tok in enumerate(steps):
        logits, cache = jdecode(jq, cache, jnp.int32(S + i), {"token": jnp.asarray(tok, jnp.int32)})
        want.append(np.asarray(logits))

    q = quant.quantize_params(params)
    logits, states, _ = make_prefill_step(cfg_q)(q, {"tokens": torch.from_numpy(tokens)})
    got = [logits.numpy()]
    pool = SlotCachePool(cfg_q, B, S_MAX, torch.float32, "cpu")
    for b in range(B):
        pool.write(b, [{k: v[b:b + 1] for k, v in st.items()} for st in states])
    assert pool.cache[0]["k"].dtype == torch.int8
    cache = pool.cache
    for i, tok in enumerate(steps):
        logits, cache = make_decode_step(cfg_q)(q, cache, torch.full((B,), S + i),
                                                {"token": torch.from_numpy(tok)})
        got.append(logits.numpy())
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (B, 1, cfg_q.vocab)
        assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max(), f"step {i}"


@pytest.fixture(scope="module")
def served(model):
    jcfg, jparams, cfg, params, jcfg_q, cfg_q = model
    r = np.random.RandomState(0)
    prompts = [r.randint(0, cfg.vocab, (s,)) for s, _, _ in TRACE]
    jreqs = [jserving.Request(rid=i, prompt=p, max_new_tokens=g, arrival_time=t)
             for i, (p, (_, g, t)) in enumerate(zip(prompts, TRACE))]
    ref = {}
    for n_slots in (1, 2, 4):
        outs, _ = jserving.Engine(jcfg_q, jparams,
                                  jserving.EngineConfig(n_slots=n_slots)).run(jreqs)
        ref[n_slots] = [np.asarray(outs[i].tokens) for i in range(len(TRACE))]
    return prompts, ref


def _requests(prompts):
    return [Request(rid=i, prompt=p, max_new_tokens=g, arrival_time=t)
            for i, (p, (_, g, t)) in enumerate(zip(prompts, TRACE))]


@pytest.mark.parametrize("n_slots", [1, 2, 4])
def test_int8_engine_matches_reference_engine(model, served, n_slots):
    _, _, _, params, _, cfg_q = model
    prompts, ref = served
    res = Engine(cfg_q, params, EngineConfig(n_slots=n_slots), device="cpu").run(
        _requests(prompts))
    for i, want in enumerate(ref[n_slots]):
        np.testing.assert_array_equal(res[i].tokens, want, err_msg=f"req {i}")
        assert res[i].finish_reason == FINISH_LENGTH
    assert res.metrics.failed == 0


def test_int8_engine_invariances_and_bytes(model):
    """The reference's own checks (tests/test_quant.py): shared-prompt
    requests agree exactly, their first token is the f32 sequential run's,
    and the int8 engine keeps under 0.3 of the f32 parameter bytes and a
    smaller cache."""
    _, _, cfg, params, _, cfg_q = model
    prompt = np.random.RandomState(10).randint(0, cfg.vocab, (10,))
    reqs = [Request(rid=i, prompt=prompt, max_new_tokens=6) for i in range(3)]
    eng_q = Engine(cfg_q, params, EngineConfig(n_slots=2, s_max=24), device="cpu")
    eng_f = Engine(cfg, params, EngineConfig(n_slots=2, s_max=24), device="cpu")
    res_q, res_f = eng_q.run(reqs), eng_f.run(reqs)
    seq = generate_sequential(cfg, params, reqs[0], s_max=24, device="cpu")
    for r in reqs:
        assert len(res_q[r.rid].tokens) == r.max_new_tokens
        assert int(res_q[r.rid].tokens[0]) == int(seq.tokens[0])
        np.testing.assert_array_equal(res_q[r.rid].tokens, res_q[0].tokens)
    assert quant.tree_bytes(eng_q.params) < 0.3 * quant.tree_bytes(eng_f.params)
    assert res_q.metrics.cache_bytes < res_f.metrics.cache_bytes
    assert res_q.metrics.cache_bytes * 4 == res_f.metrics.cache_bytes


def test_unknown_quant_rejected(model):
    _, _, cfg, params, _, _ = model
    with pytest.raises(ValueError, match="quant"):
        Engine(dataclasses.replace(cfg, quant="int3"), params, device="cpu")


def test_fixed_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never run a CPU path of their own."""
    from repro_torch.kernels import gs_fixed as fixed_kernel

    x = torch.ones(2, 8, dtype=torch.int8)
    kw = dict(p=8, frac_bits=24, iters=0)
    with pytest.raises(ValueError, match="CUDA"):
        fixed_kernel.gs_fixed_recip(x, 1.0, variant="feedback", mitchell_iters=0, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        fixed_kernel.gs_fixed_softmax(x, 1.0, variant="feedback", mitchell_iters=0, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        fixed_kernel.gs_fixed_rmsnorm(x, 1.0, torch.ones(8), eps=1e-6, **kw)
    with pytest.raises(ValueError, match="device meta"):
        ops.gs_fixed_rmsnorm(torch.empty(2, 8, dtype=torch.int8, device="meta"), 1.0,
                             torch.ones(8), eps=1e-6, **kw)
