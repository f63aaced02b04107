"""Port's paged pool and paged engine vs ``repro.serving`` (smoke tinyllama,
2 layers, f32 and int8, greedy).

* ``PagedCachePool`` host accounting: the cases of
  ``tests/test_serving.py::TestPagedCachePool`` run on the port's pool and
  on the reference's, call for call; the block tables, the refcounts, each
  call's result and ``stats()`` (key by key, on the keys both have) must be
  equal.  The reference's own hard-coded numbers are not used.
* ``Engine(pool="paged")`` against the reference's paged engine on the same
  traces (every arrival at 0, so both schedules are deterministic): tokens
  token for token, the pool's ``stats()``, and the preemption, prefix-hit
  and prefill counters; against the port's slot engine and its
  ``generate_sequential`` too.  The cases: ``prefix`` exact and off, one
  slot recycling, the tight arena (3 slots, 7 pages of 4) that preempts,
  eight requests on one prompt, ``page_reserve="worst"``, and int8.
* ``prefix="pages"`` raises ``NotImplementedError`` (ROADMAP A8b), and
  ``AdmissionError`` is raised where the reference raises it (an arena
  squeezed before the first tick; the reference squeezes it with its fault
  injector, the port test takes the same pages out of the free list).
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
from repro.kernels.tuning import dispatch  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.runtime.failures import ServeFaultInjector  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving import (AdmissionError, Engine, EngineConfig,  # noqa: E402
                                 PagedCachePool, Request, generate_sequential)
from repro_torch.serving.cache import TRASH_PAGE, request_prefix_key  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")
S_MAX, PAGE = 22, 4  # the reference's paged tests: 6 pages a slot


@pytest.fixture(scope="module", autouse=True)
def no_reference_fallback():
    """The int8 reference runs its Pallas kernels, never the float oracle."""
    dispatch.enable_fallback(False)
    yield
    dispatch.enable_fallback(None)


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.get_smoke("tinyllama-1.1b", **F32)
    cfg = configs.get_smoke("tinyllama-1.1b", **F32)
    jparams = japi.init(jcfg, jax.random.key(20))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _prompts(cfg, seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab, (s,)) for s in lens]


def _paged(**kw):
    base = dict(n_slots=2, s_max=S_MAX, pool="paged", page_size=PAGE)
    base.update(kw)
    return base


def _shared(a: dict, b: dict) -> tuple:
    """(a, b) restricted to the keys both have."""
    keys = sorted(set(a) & set(b))
    return {k: a[k] for k in keys}, {k: b[k] for k in keys}


def _serve_both(model, prompts, gens, ecfg: dict, quant=False):
    """The same trace through the reference's engine and the port's."""
    jcfg, jparams, cfg, params = model
    if quant:
        jcfg = dataclasses.replace(jcfg, quant="int8", kernel_impl="pallas")
        cfg = dataclasses.replace(cfg, quant="int8")
    jouts, jm = jserving.Engine(jcfg, jparams, jserving.EngineConfig(**ecfg)).run(
        [jserving.Request(rid=i, prompt=p, max_new_tokens=g)
         for i, (p, g) in enumerate(zip(prompts, gens))])
    res = Engine(cfg, params, EngineConfig(**ecfg), device="cpu").run(
        [Request(rid=i, prompt=p, max_new_tokens=g) for i, (p, g) in enumerate(zip(prompts,
                                                                                 gens))])
    for i in range(len(prompts)):
        np.testing.assert_array_equal(res[i].tokens, np.asarray(jouts[i].tokens),
                                      err_msg=f"req {i}")
        assert res[i].finish_reason == jouts[i].finish_reason
    m = res.metrics
    for name in ("prefill_tokens", "prefill_skips", "prefix_hits", "prefix_hit_tokens",
                 "preempted", "first_tokens", "decode_tokens", "decode_ticks",
                 "peak_active", "failed"):
        assert getattr(m, name) == getattr(jm, name), name
    got, want = _shared(m.pool, jm.pool)
    assert got == want
    assert set(m.pool) <= set(jm.pool)
    return res


def _assert_sequential(model, prompts, gens, res):
    _, _, cfg, params = model
    for i, (p, g) in enumerate(zip(prompts, gens)):
        seq = generate_sequential(cfg, params, Request(rid=i, prompt=p, max_new_tokens=g),
                                  s_max=S_MAX, device="cpu")
        np.testing.assert_array_equal(res[i].tokens, seq.tokens, err_msg=f"req {i}")


# -- the engine ------------------------------------------------------------------

PARITY = ((6, 5), (9, 8), (4, 3), (7, 6))  # (prompt, gen): the reference's trace


@pytest.mark.parametrize("prefix", ["exact", "off"])
def test_paged_matches_reference_slot_and_sequential(model, prefix):
    _, _, cfg, params = model
    prompts = _prompts(cfg, 20, [s for s, _ in PARITY])
    gens = [g for _, g in PARITY]
    res = _serve_both(model, prompts, gens, _paged(prefix=prefix))
    slot = Engine(cfg, params, EngineConfig(n_slots=2, s_max=S_MAX), device="cpu").run(
        [Request(rid=i, prompt=p, max_new_tokens=g)
         for i, (p, g) in enumerate(zip(prompts, gens))])
    for i in range(len(prompts)):
        np.testing.assert_array_equal(res[i].tokens, slot[i].tokens, err_msg=f"req {i}")
    _assert_sequential(model, prompts, gens, res)
    pool = res.metrics.pool
    assert pool["kind"] == "paged" and pool["pages_per_slot"] == 6
    assert pool["prefix_entries"] == (len(prompts) if prefix == "exact" else 0)
    assert res.metrics.cache_bytes == pool["cache_bytes"]


def test_paged_single_slot_recycling_returns_every_page(model):
    _, _, cfg, _ = model
    specs = ((8, 4), (5, 6), (10, 3), (6, 5))
    prompts = _prompts(cfg, 21, [s for s, _ in specs])
    gens = [g for _, g in specs]
    res = _serve_both(model, prompts, gens, _paged(n_slots=1, prefix="off"))
    _assert_sequential(model, prompts, gens, res)
    pool = res.metrics.pool
    assert pool["pages_in_use"] == 0 and pool["peak_pages_in_use"] > 0
    assert pool["prefix_entries"] == 0 and pool["free_pages"] == pool["n_pages"] - 1


def test_paged_tight_arena_preempts_as_the_reference_does(model):
    """3 slots on 7 pages of 4 (6 a slot plus the trash page): prompt
    reservation admits all three, decode-time appends run out, the youngest
    is preempted and replayed; as often as in the reference."""
    _, _, cfg, _ = model
    specs = ((9, 8), (10, 7), (8, 9))
    prompts = _prompts(cfg, 22, [s for s, _ in specs])
    gens = [g for _, g in specs]
    res = _serve_both(model, prompts, gens, _paged(n_slots=3, n_pages=7))
    _assert_sequential(model, prompts, gens, res)
    m = res.metrics
    assert m.preempted >= 1 and m.pool["appended_pages"] >= 1
    assert m.prefill_tokens > sum(len(p) for p in prompts)  # the replays


def test_shared_prompt_prefills_once_across_8_requests(model):
    _, _, cfg, _ = model
    prompts = _prompts(cfg, 23, [6]) * 8
    gens = [5] * 8
    res = _serve_both(model, prompts, gens, _paged(n_slots=4))
    _assert_sequential(model, prompts, gens, res)
    m = res.metrics
    assert m.prefill_skips >= 1 and m.pool["cow_copies"] >= 1
    assert m.prefix_hits == m.prefill_skips and m.prefix_hit_tokens == 6 * m.prefix_hits


def test_worst_reservation_matches_reference(model):
    _, _, cfg, _ = model
    specs = ((9, 8), (10, 7), (8, 9))
    prompts = _prompts(cfg, 24, [s for s, _ in specs])
    gens = [g for _, g in specs]
    res = _serve_both(model, prompts, gens,
                      _paged(n_slots=3, n_pages=9, page_reserve="worst", prefix="off"))
    _assert_sequential(model, prompts, gens, res)
    m = res.metrics
    assert m.pool["reserve"] == "worst" and m.pool["appended_pages"] == 0
    # two lifetimes of 4 pages fit the 8 usable pages: the third waits, and
    # the stalled head preempts the youngest after preempt_after_ticks ticks
    assert m.peak_active == 2 and m.preempted >= 1


def test_int8_paged_matches_int8_slot_and_reference(model):
    _, _, cfg, params = model
    prompts = _prompts(cfg, 20, [s for s, _ in PARITY])
    gens = [g for _, g in PARITY]
    res = _serve_both(model, prompts, gens, _paged(), quant=True)
    cfg_q = dataclasses.replace(cfg, quant="int8")
    slot = Engine(cfg_q, params, EngineConfig(n_slots=2, s_max=S_MAX), device="cpu").run(
        [Request(rid=i, prompt=p, max_new_tokens=g)
         for i, (p, g) in enumerate(zip(prompts, gens))])
    for i in range(len(prompts)):
        np.testing.assert_array_equal(res[i].tokens, slot[i].tokens, err_msg=f"req {i}")
    arena = Engine(cfg_q, params, EngineConfig(**_paged()), device="cpu")._make_pool().cache
    assert arena[0]["k"].dtype == torch.int8
    assert res.metrics.cache_bytes == sum(t.numel() for st in arena for t in st.values())


def test_pages_prefix_mode_is_not_ported(model):
    _, _, cfg, params = model
    with pytest.raises(NotImplementedError, match="A8b"):
        Engine(cfg, params, EngineConfig(**_paged(prefix="pages")), device="cpu")
    with pytest.raises(NotImplementedError, match="A8b"):
        PagedCachePool(cfg, 2, S_MAX, torch.float32, "cpu", page_size=PAGE, share="pages")


@pytest.mark.parametrize("squeeze", [4, 5])
def test_squeezed_arena_raises_admission_error_as_the_reference(model, monkeypatch, squeeze):
    """2 slots on 6 pages of 4 with ``squeeze`` pages taken before the first
    tick: with 4 taken the prompt's page fits and the first decode-time
    append fails; with 5 the prompt does not fit an idle pool."""
    jcfg, jparams, cfg, params = model
    prompt = _prompts(cfg, 14, [4])[0]
    ecfg = dict(n_slots=2, s_max=16, pool="paged", page_size=4, n_pages=6, prefix="off")
    with pytest.raises(jserving.AdmissionError) as want:
        jserving.Engine(jcfg, jparams, jserving.EngineConfig(
            **ecfg, injector=ServeFaultInjector(squeeze={0: squeeze}))).run(
            [jserving.Request(rid=7, prompt=prompt, max_new_tokens=9)])
    engine = Engine(cfg, params, EngineConfig(**ecfg), device="cpu")
    make = engine._make_pool

    def squeezed():
        pool = make()
        for _ in range(squeeze):
            pool.ref[pool._free_pages.popleft()] += 1
        return pool

    monkeypatch.setattr(engine, "_make_pool", squeezed)
    with pytest.raises(AdmissionError) as got:
        engine.run([Request(rid=7, prompt=prompt, max_new_tokens=9)])
    assert (got.value.rid, got.value.queued, got.value.pages_needed) == (
        want.value.rid, want.value.queued, want.value.pages_needed)
    a, b = _shared(got.value.pool_stats, want.value.pool_stats)
    assert a == b
    assert "request 7 cannot be admitted" in str(got.value)


def test_admission_error_attributes_and_message():
    err = AdmissionError(7, {"kind": "paged", "n_pages": 6, "free_pages": 1,
                             "free_slots": 2, "page_size": 4, "prefix_hits": 0},
                         queued=[7, 9], pages_needed={7: 3, 9: 2})
    assert isinstance(err, RuntimeError) and err.rid == 7
    assert err.queued == [7, 9] and err.pages_needed == {7: 3, 9: 2}
    msg = str(err)
    assert "free_pages" in msg and "queued rids: [7, 9]" in msg and "pages needed" in msg
    assert "prefix_hits" not in msg


# -- the pool's host accounting, call for call against the reference -------------


class _Pools:
    """The port's and the reference's paged pools driven by the same calls."""

    def __init__(self, model, n_slots=2, **kw):
        self.jcfg, self.jparams, self.cfg, self.params = model
        kw.setdefault("page_size", 4)
        kw.setdefault("n_pages", 0)
        self.port = PagedCachePool(self.cfg, n_slots, 16, torch.float32, "cpu", **kw)
        self.ref = jserving.PagedCachePool(self.jcfg, n_slots, 16, jnp.float32, **kw)

    def both(self, name, *args):
        """Call ``name`` on both pools (a request argument as each side's
        Request); return the port's result after checking it against the
        reference's, and the tables, refcounts and stats."""
        def conv(a, jside):
            if isinstance(a, tuple):  # (rid, prompt, gen)
                rid, prompt, gen = a
                cls = jserving.Request if jside else Request
                return cls(rid=rid, prompt=np.asarray(prompt, np.int32), max_new_tokens=gen)
            return a

        got = getattr(self.port, name)(*[conv(a, False) for a in args])
        want = getattr(self.ref, name)(*[conv(a, True) for a in args])
        assert (got is None and want is None) or got == want, (name, got, want)
        self.check()
        return got

    def write(self, slot, spec):
        """Prefill ``spec`` on each side and write it into ``slot``."""
        rid, prompt, gen = spec
        prompt = np.asarray(prompt, np.int32)
        jreq = jserving.Request(rid=rid, prompt=prompt, max_new_tokens=gen)
        logits, states, _ = japi.prefill(self.jcfg, self.jparams,
                                         jserving.prefill_batch(self.jcfg, jreq))
        self.ref.write(int(slot), states, req=jreq, logits=logits)
        req = Request(rid=rid, prompt=prompt, max_new_tokens=gen)
        logits, states, _ = api.prefill(self.cfg, self.params,
                                        {"tokens": torch.as_tensor(prompt[None]).long()})
        self.port.write(int(slot), states, req=req, logits=logits)
        self.check()

    def check(self):
        np.testing.assert_array_equal(self.port.table, self.ref.table)
        np.testing.assert_array_equal(self.port.ref, self.ref.ref)
        a, b = _shared(self.port.stats(), self.ref.stats())
        assert a == b
        assert self.port.pages_in_use == self.ref.pages_in_use
        assert list(self.port._index) == list(self.ref._index)


def _arange(n):
    return np.arange(n, dtype=np.int32)


def test_pool_alloc_reserves_prompt_pages_and_appends_grow(model):
    p = _Pools(model)
    req = (0, _arange(5), 6)
    slot = p.both("alloc", req)
    assert not slot.hit.skip_prefill
    for pos in (5, 8):
        assert p.both("ensure_page", int(slot), pos)
    p.write(slot, req)
    p.both("free", int(slot))
    p.both("clear_prefix")
    assert int(p.port.ref.sum()) == 1  # only the pinned trash page


def test_pool_worst_reservation(model):
    p = _Pools(model, reserve="worst")
    slot = p.both("alloc", (0, _arange(5), 6))
    p.both("ensure_page", int(slot), 9)
    assert p.port.stats()["reserve"] == "worst"


def test_pool_append_fails_cleanly_when_the_arena_is_full(model):
    p = _Pools(model, n_pages=5, share="off")
    s0 = p.both("alloc", (0, _arange(9), 8))
    p.both("alloc", (1, _arange(3), 8))
    assert p.both("append_page", int(s0)) is False
    assert p.both("ensure_page", int(s0), 9) is True
    assert p.both("ensure_page", int(s0), 12) is False


def test_pool_trash_page_is_never_freed(model):
    p = _Pools(model)
    req = (1, _arange(4), 2)
    slot = p.both("alloc", req)
    assert TRASH_PAGE not in p.port._slot_pages[int(slot)]
    p.write(slot, req)
    p.both("free", int(slot))
    assert (p.port.table[int(slot)] == TRASH_PAGE).all() and p.port.ref[TRASH_PAGE] == 1


def test_pool_exact_hit_skips_prefill_and_copies_the_tail_page(model):
    p = _Pools(model)
    req = (0, _arange(6), 4)
    s0 = p.both("alloc", req)
    p.write(s0, req)
    s1 = p.both("alloc", (1, _arange(6), 4))
    assert s1.hit.skip_prefill and p.port.cow_copies == 1
    p.port.write(int(s1), None)  # an exact hit writes nothing
    p.ref.write(int(s1), None)
    p.check()
    src, dst = p.port.table[int(s0), 1], p.port.table[int(s1), 1]
    assert src != dst
    for st in p.port.cache:
        for arena in st.values():
            torch.testing.assert_close(arena[dst], arena[src], rtol=0, atol=0)
            assert arena[dst].abs().sum() > 0
    # the copied page is private: freeing the sharer keeps the entry's pages
    p.both("free", int(s1))
    p.both("free", int(s0))


def test_pool_read_only_sharer_attaches_the_tail_without_a_copy(model):
    p = _Pools(model)
    req = (0, _arange(6), 4)
    s0 = p.both("alloc", req)
    p.write(s0, req)
    s1 = p.both("alloc", (1, _arange(6), 1))
    assert s1.hit.skip_prefill and p.port.cow_copies == 0
    assert p.port.table[int(s1), 1] == p.port.table[int(s0), 1]


def test_pool_eviction_frees_cold_entries_but_never_slot_pages(model):
    p = _Pools(model, n_slots=1, n_pages=7)
    for rid, n in ((0, 5), (1, 9)):
        req = (rid, np.full(n, rid, np.int32), 2)
        s = p.both("alloc", req)
        p.write(s, req)
        p.both("free", int(s))
    big = (2, _arange(12), 5)
    assert p.both("can_admit", big)
    s = p.both("alloc", big)
    assert p.port.evictions > 0 and len(p.port._slot_pages[int(s)]) == 3


def test_pool_can_admit_counts_the_page_budget(model):
    p = _Pools(model, n_pages=5, share="off")
    r0, r1 = (0, _arange(9), 8), (1, _arange(9), 8)
    assert p.both("can_admit", r0)
    s0 = p.both("alloc", r0)
    assert not p.both("can_admit", r1)
    p.write(s0, r0)
    p.both("free", int(s0))
    assert p.both("can_admit", r1)


def test_pool_alloc_requires_the_request(model):
    p = _Pools(model)
    with pytest.raises(ValueError):
        p.port.alloc()


def test_pool_row_gathers_the_dense_view(model):
    p = _Pools(model)
    req = (0, _arange(6), 2)
    s = p.both("alloc", req)
    p.write(s, req)
    want = p.ref.row(int(s))["pos0"]  # the reference stacks the layers
    for layer, st in enumerate(p.port.row(int(s))):
        for name in ("k", "v"):
            assert st[name].shape == (16, 2, 16)
            np.testing.assert_allclose(st[name].numpy(), np.asarray(want[name][layer]),
                                       rtol=1e-5, atol=1e-6)


def test_prefix_key_matches_the_reference():
    from repro.serving.cache import request_prefix_key as jkey

    prompt = np.arange(37, dtype=np.int32) * 7
    assert request_prefix_key(prompt) == jkey(prompt)
