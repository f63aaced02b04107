"""Port's tinyllama stack vs ``repro.models.api`` (smoke config, fp32).

The reference's parameters reach the port through ``bridge``; prefill
logits and three decode steps (per-row cache positions) must agree within
1e-4 absolute with the reference run with ``kernel_impl`` set to ``jnp``
and to ``pallas`` (interpret mode).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serving import SlotCachePool as JPool  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving import SlotCachePool  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")
B, S, S_MAX, STEPS = 2, 11, 24, 3


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.get_smoke("tinyllama-1.1b", **F32)
    cfg = configs.get_smoke("tinyllama-1.1b", **F32)
    jparams = japi.init(jcfg, jax.random.key(0))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _reference_logits(jcfg, jparams, tokens, steps):
    prefill = jax.jit(lambda p, t: japi.prefill(jcfg, p, {"tokens": t})[:2])
    decode = jax.jit(lambda p, c, i, t: japi.decode_step(jcfg, p, c, i, {"token": t}))
    logits, states = prefill(jparams, jnp.asarray(tokens))
    out = [np.asarray(logits)]
    cache = JPool.grow(jcfg, states, B, S_MAX, jnp.float32)
    for i, tok in enumerate(steps):
        logits, cache = decode(jparams, cache, jnp.int32(S + i), jnp.asarray(tok))
        out.append(np.asarray(logits))
    return out


def _port_logits(cfg, params, tokens, steps):
    with torch.no_grad():
        logits, states, _ = api.prefill(cfg, params, {"tokens": torch.from_numpy(tokens)})
        out = [logits.numpy()]
        pool = SlotCachePool(cfg, B, S_MAX, torch.float32, "cpu")
        for b in range(B):
            pool.write(b, [{k: v[b:b + 1] for k, v in st.items()} for st in states])
        cache = pool.cache
        for i, tok in enumerate(steps):
            cur = torch.full((B,), S + i, dtype=torch.int64)
            logits, cache = api.decode_step(cfg, params, cache, cur,
                                            {"token": torch.from_numpy(tok)})
            out.append(logits.numpy())
    return out


@pytest.mark.parametrize("kernel_impl", ["jnp", "pallas"])
def test_prefill_and_decode_logits_match(model, kernel_impl):
    jcfg, jparams, cfg, params = model
    jcfg = dataclasses.replace(jcfg, kernel_impl=kernel_impl)
    r = np.random.RandomState(5)
    tokens = r.randint(0, cfg.vocab, (B, S)).astype(np.int64)
    steps = [r.randint(0, cfg.vocab, (B, 1)).astype(np.int64) for _ in range(STEPS)]
    want = _reference_logits(jcfg, jparams, tokens.astype(np.int32),
                             [s.astype(np.int32) for s in steps])
    got = _port_logits(cfg, params, tokens, steps)
    assert len(got) == len(want) == STEPS + 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (B, 1, cfg.vocab)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=f"step {i}")


def test_port_init_has_the_bridged_tree(model):
    _, _, cfg, bridged = model
    fresh = api.init(cfg, seed=3, device="cpu")

    def spec(tree):
        if isinstance(tree, dict):
            return {k: spec(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [spec(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)

    assert spec(fresh) == spec(bridged)
    assert len(fresh["layers"]) == cfg.n_layers
    again = api.init(cfg, seed=3, device="cpu")
    assert torch.equal(fresh["lm_head"], again["lm_head"])  # seeded generator


def test_bridge_rejects_a_wrong_layer_axis(model):
    _, jparams, cfg, _ = model
    tree = jax.tree.map(np.asarray, jparams)
    tree["layers"]["pos0"]["norm1"]["scale"] = tree["layers"]["pos0"]["norm1"]["scale"][:1]
    with pytest.raises(ValueError, match="n_groups"):
        bridge.params_from_numpy(tree, cfg, "cpu")
