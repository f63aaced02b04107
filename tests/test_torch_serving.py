"""Port's serving path vs ``repro.serving`` (smoke tinyllama, fp32, greedy).

A staggered 6-request trace (three prompt lengths, six generation
lengths) goes through the reference's ``generate_sequential`` once; the port's
``generate_sequential`` and its ``Engine.run`` over 1, 2 and 4 slots must
produce the same tokens, token for token.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving import (FINISH_LENGTH, FINISH_NUMERIC, Engine,  # noqa: E402
                                 EngineConfig, Request, SamplingParams,
                                 SlotCachePool, generate_sequential)

F32 = dict(dtype="float32", param_dtype="float32")
# (prompt_len, max_new_tokens, arrival_time); few distinct prompt lengths
# keep the reference's prefill compiles (one per length) cheap
TRACE = [(6, 5, 0.0), (9, 8, 0.0), (13, 3, 0.01), (9, 6, 0.02), (6, 7, 0.02),
         (13, 4, 0.03)]


@pytest.fixture(scope="module")
def served():
    jcfg = jconfigs.get_smoke("tinyllama-1.1b", **F32)
    cfg = configs.get_smoke("tinyllama-1.1b", **F32)
    jparams = japi.init(jcfg, jax.random.key(0))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    r = np.random.RandomState(0)
    prompts = [r.randint(0, cfg.vocab, (s,)) for s, _, _ in TRACE]
    ref = [np.asarray(jserving.generate_sequential(
        jcfg, jparams, jserving.Request(rid=i, prompt=p, max_new_tokens=g)).tokens)
        for i, (p, (_, g, _)) in enumerate(zip(prompts, TRACE))]
    return cfg, params, prompts, ref


def _requests(prompts):
    return [Request(rid=i, prompt=p, max_new_tokens=g, arrival_time=t)
            for i, (p, (_, g, t)) in enumerate(zip(prompts, TRACE))]


def test_generate_sequential_matches_reference(served):
    cfg, params, prompts, ref = served
    for req, want in zip(_requests(prompts), ref):
        got = generate_sequential(cfg, params, req, device="cpu")
        np.testing.assert_array_equal(got.tokens, want, err_msg=f"req {req.rid}")
        assert got.finish_reason == FINISH_LENGTH


@pytest.mark.parametrize("n_slots", [1, 2, 4])
def test_engine_matches_reference(served, n_slots):
    cfg, params, prompts, ref = served
    res = Engine(cfg, params, EngineConfig(n_slots=n_slots), device="cpu").run(
        _requests(prompts))
    for i, want in enumerate(ref):
        np.testing.assert_array_equal(res[i].tokens, want, err_msg=f"req {i}")
        assert res[i].finish_reason == FINISH_LENGTH
    m = res.metrics
    assert m.decode_tokens == sum(g - 1 for _, g, _ in TRACE)
    assert m.prefill_tokens == sum(s for s, _, _ in TRACE)
    assert m.first_tokens == len(TRACE) and m.failed == 0
    assert m.peak_active <= n_slots and m.decode_ticks > 0


def test_nan_row_is_quarantined_and_neighbours_keep_tokens(served, monkeypatch):
    """NaN in one slot's cached K: that request finishes "numeric_error"
    with only its prefill token; every other request (including the ones
    that later reuse its slot) keeps the reference's tokens."""
    cfg, params, prompts, ref = served
    victim = 1  # the second admission: requests are admitted in rid order
    write = SlotCachePool.write
    writes = []

    def poisoned_write(self, slot, states):
        write(self, slot, states)
        writes.append(slot)
        if len(writes) == victim + 1:
            self.cache[0]["k"][slot, 0] = float("nan")

    monkeypatch.setattr(SlotCachePool, "write", poisoned_write)
    res = Engine(cfg, params, EngineConfig(n_slots=2), device="cpu").run(
        _requests(prompts))
    assert res[victim].finish_reason == FINISH_NUMERIC
    np.testing.assert_array_equal(res[victim].tokens, ref[victim][:1])
    assert res.metrics.failed == 1
    for i, want in enumerate(ref):
        if i != victim:
            np.testing.assert_array_equal(res[i].tokens, want, err_msg=f"req {i}")


def test_stop_token_ends_a_request(served):
    cfg, params, prompts, ref = served
    req = Request(rid=0, prompt=prompts[1], max_new_tokens=8,
                  sampling=SamplingParams(stop=int(ref[1][2])))
    got = Engine(cfg, params, EngineConfig(n_slots=1), device="cpu").run([req])[0]
    np.testing.assert_array_equal(got.tokens, ref[1][:3])
    assert got.finish_reason == "stop"


def test_stochastic_sampling_not_ported(served):
    cfg, params, prompts, _ = served
    req = Request(rid=0, prompt=prompts[0], max_new_tokens=2,
                  sampling=SamplingParams(temperature=0.7))
    with pytest.raises(NotImplementedError, match="A10"):
        Engine(cfg, params, device="cpu").run([req])


def test_entry_points_default_to_cuda_and_never_move_to_cpu(served):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is usable")
    cfg, params, prompts, _ = served
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_sequential(cfg, params, _requests(prompts)[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init(cfg)
