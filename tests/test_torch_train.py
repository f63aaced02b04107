"""Port's training path vs the JAX package's (CPU, smoke tinyllama, f32).

* ``SyntheticLM`` batches byte-equal to the reference's; ``cosine`` and
  ``wsd`` within 2^-22 relative (f32 ``cos``/``pow`` of two libraries).
* Loss and every gradient leaf against ``jax.value_and_grad(api.loss_fn)``
  with ``kernel_impl="pallas"`` (the Pallas kernels in interpret mode):
  loss within 1e-3, grads within 1e-3 relative to each leaf's largest
  element, the tolerances of ``tests/test_grads.py``.
* One ``make_train_step`` against the reference's, leaf by leaf: params,
  m and v within 1e-3 relative to each leaf's largest element, step equal.
* Checkpoints cross both ways between ``repro.checkpoint`` and
  ``repro_torch.checkpoint``, bf16 leaves included.
* ``run_training`` with injected failures resumes to the same losses as an
  uninterrupted run, bit for bit, as ``tests/test_fault_tolerance.py``
  asserts for the reference.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.data import synthetic as jdata  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.data import synthetic as data  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.optim import adamw_init, schedules  # noqa: E402
from repro_torch.runtime.driver import TrainState, run_training  # noqa: E402
from repro_torch.runtime.failures import StragglerClock  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")
B, S = 2, 32
HP = dict(peak_lr=1e-3, warmup=0, total=10)  # warmup 0: the first step moves


def _maxrel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _leaves(tree, prefix=""):
    """{path: leaf} of a nested dict of arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.get_smoke("tinyllama-1.1b", kernel_impl="pallas", **F32)
    cfg = configs.get_smoke("tinyllama-1.1b", **F32)
    jparams = japi.init(jcfg, jax.random.key(0))
    host = jax.tree.map(np.asarray, jparams)
    ds = jdata.SyntheticLM(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=3)
    return jcfg, jparams, host, cfg, ds


def test_synthetic_batches_byte_equal():
    for kw in (dict(vocab=256, seq_len=32, global_batch=4, seed=0),
               dict(vocab=32000, seq_len=17, global_batch=3, seed=5, noise=0.2)):
        ref_ds, ds = jdata.SyntheticLM(**kw), data.SyntheticLM(**kw)
        for step in (0, 1, 7, 1000):
            want, got = ref_ds.global_batch_np(step), ds.global_batch_np(step)
            for name in ("tokens", "labels"):
                assert got[name].dtype == want[name].dtype
                assert got[name].tobytes() == want[name].tobytes()
            dev = data.make_batch(ds, step, "cpu")
            assert dev["tokens"].dtype == torch.int64
            np.testing.assert_array_equal(dev["labels"].numpy(), want["labels"])


def test_schedules_match():
    steps_ = np.arange(0, 130)
    cos_kw = dict(peak_lr=3e-4, warmup=10, total=100)
    wsd_kw = dict(peak_lr=1e-3, warmup=10, stable=80, decay=10)
    for name, kw in (("cosine", cos_kw), ("wsd", wsd_kw)):
        want = np.asarray(getattr(jsched, name)(jnp.asarray(steps_), **kw))
        got = getattr(schedules, name)(torch.from_numpy(steps_), **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=2.0**-22, atol=0)
        assert float(getattr(schedules, name)(5, **kw)) == pytest.approx(float(want[5]))


def test_loss_and_grads_match_value_and_grad(model):
    jcfg, jparams, host, cfg, ds = model
    batch = ds.global_batch_np(0)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: japi.loss_fn(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}))(jparams)
    params = bridge.params_from_numpy(host, cfg, "cpu")
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = api.loss_fn(cfg, live, data.make_batch(data.SyntheticLM(
        vocab=cfg.vocab, seq_len=S, global_batch=B, seed=3), 0, "cpu"))
    grads = torch.autograd.grad(loss, tree_leaves(live))
    grad_tree = bridge.params_to_numpy(tree_unflatten(live, list(grads)))
    assert abs(loss.item() - float(want_loss)) < 1e-3
    want = _leaves(jax.tree.map(np.asarray, want_grads))
    got = _leaves(grad_tree)
    assert got.keys() == want.keys()
    worst = {k: _maxrel(got[k], want[k]) for k in want}
    assert max(worst.values()) < 1e-3, worst


def test_train_step_matches_reference(model):
    jcfg, jparams, host, cfg, ds = model
    batch = ds.global_batch_np(1)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jsteps.TrainHParams(**HP)))
    jp, jopt, jmet = jstep(jparams, jadamw_init(jparams),
                           {k: jnp.asarray(v) for k, v in batch.items()})
    params = bridge.params_from_numpy(host, cfg, "cpu")
    ops.reset_launch_counts()
    new_p, new_opt, met = steps.make_train_step(cfg, steps.TrainHParams(**HP))(
        params, adamw_init(params), {k: torch.from_numpy(v.astype(np.int64))
                                     for k, v in batch.items()})
    assert set(ops.launch_counts().values()) == {0}  # CPU tensors: plain versions
    assert abs(float(met["loss"]) - float(jmet["loss"])) < 1e-4
    assert abs(float(met["grad_norm"]) - float(jmet["grad_norm"])) < 1e-4 * float(jmet["grad_norm"])
    got = _leaves(bridge.state_to_numpy(new_p, new_opt))
    want = _leaves(jax.tree.map(np.asarray, {"params": jp, "opt_state": jopt}))
    assert got.keys() == want.keys()
    assert int(got["/opt_state/step"]) == int(want["/opt_state/step"]) == 1
    worst = {k: _maxrel(got[k], want[k]) for k in want if not k.endswith("step")}
    assert max(worst.values()) < 1e-3, worst
    # the step moved the params
    before = _leaves(host)
    assert any(np.abs(got["/params" + k] - before[k]).max() > 1e-4 for k in before)


def _jtree_equal(a, b):
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def test_checkpoint_crosses_both_ways(model, tmp_path):
    jcfg, jparams, host, cfg, ds = model
    params = bridge.params_from_numpy(host, cfg, "cpu")
    opt = adamw_init(params)
    opt["m"]["embed"] += 0.5
    opt["step"] += 7
    tree = bridge.state_to_numpy(params, opt)
    # port -> reference
    path = ckpt.save_checkpoint(str(tmp_path / "port"), 7, tree, fingerprint="x")
    like = {"params": jparams, "opt_state": jadamw_init(jparams)}
    restored, manifest = jckpt.load_checkpoint(path, like)
    assert manifest["step"] == 7
    assert _jtree_equal(restored["params"], jparams)
    assert float(restored["opt_state"]["m"]["embed"][0, 0]) == 0.5
    assert int(restored["opt_state"]["step"]) == 7
    # reference -> port
    jopt = jadamw_init(jparams)
    jopt["v"]["lm_head"] = jopt["v"]["lm_head"] + 0.25
    path = jckpt.save_checkpoint(str(tmp_path / "ref"), 3,
                                 {"params": jparams, "opt_state": jopt})
    loaded, manifest = ckpt.load_checkpoint(path)
    p2, opt2 = bridge.state_from_numpy(loaded, cfg, "cpu")
    assert manifest["step"] == 3 and int(opt2["step"]) == 0
    got, want = _leaves(bridge.params_to_numpy(p2)), _leaves(host)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    assert float(opt2["v"]["lm_head"][0, 0]) == 0.25


def test_checkpoint_bf16_leaves_cross_both_ways(tmp_path):
    x = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    bf = torch.from_numpy(x).to(torch.bfloat16)
    path = ckpt.save_checkpoint(str(tmp_path / "port"), 1, {"w": bf, "n": torch.arange(4)})
    restored, _ = jckpt.load_checkpoint(
        path, {"w": jnp.zeros((3, 5), jnp.bfloat16), "n": jnp.zeros(4, jnp.int32)})
    np.testing.assert_array_equal(np.asarray(restored["w"]).astype(np.float32),
                                  bf.float().numpy())
    path = jckpt.save_checkpoint(str(tmp_path / "ref"), 1,
                                 {"w": jnp.asarray(x.astype(ml_dtypes.bfloat16))})
    loaded, manifest = ckpt.load_checkpoint(path)
    assert manifest["leaves"]["w"]["encoded"] and loaded["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(loaded["w"].float().numpy(), bf.float().numpy())


def _run(tmp_path, fail_at=(), steps_=10, **over):
    args = train.parser().parse_args(
        ["--smoke", "--steps", str(steps_), "--batch", "2", "--seq", "16", "--device", "cpu",
         "--dtype", "float32", "--ckpt-every", "3", "--ckpt-dir", str(tmp_path),
         "--log-every", "0", "--fail-at", *map(str, fail_at)])
    _, kw = train.build(args)
    kw.update(over)
    return run_training(**kw)


def test_run_training_resumes_bit_exactly(tmp_path):
    clean = _run(tmp_path / "clean")
    failed = _run(tmp_path / "failed", fail_at=(5, 8))
    assert failed["restarts"] == 2 and clean["restarts"] == 0
    assert clean["losses"] == failed["losses"]
    assert np.mean([clean["losses"][s] for s in (7, 8, 9)]) < np.mean(
        [clean["losses"][s] for s in (0, 1, 2)])
    final = ckpt.latest_step(str(tmp_path / "failed"))
    assert final == 10
    # the final checkpoint holds the final state, in the reference's layout
    tree, _ = ckpt.load_checkpoint(str(tmp_path / "failed" / f"step_{final:08d}"))
    p, opt = bridge.state_from_numpy(tree, dataclasses.replace(
        configs.get_smoke("tinyllama-1.1b"), dtype="float32"), "cpu")
    assert int(opt["step"]) == 10
    np.testing.assert_array_equal(p["embed"].numpy(),
                                  failed["state"].params["embed"].numpy())


def test_run_training_straggler_remesh_keeps_the_losses(tmp_path):
    """The re-mesh path: a persistent straggler triggers a checkpoint and a
    rebuilt step function; on one card the numbers do not change."""
    clean = _run(tmp_path / "clean", steps_=14)
    out = _run(tmp_path / "slow", steps_=14, clock=StragglerClock(slow_from=5))
    assert out["remeshes"] >= 1 and out["state"].step == 14
    assert out["losses"] == clean["losses"]


def test_run_training_refuses_a_checkpoint_of_another_model(tmp_path):
    _run(tmp_path, steps_=3)
    with pytest.raises(ValueError, match="does not match"):
        _run(tmp_path, steps_=6, init_state=_wider_state)


def _wider_state():
    cfg = configs.get_smoke("tinyllama-1.1b", dtype="float32", d_ff=256)
    params = api.init(cfg, seed=0, device="cpu")
    return TrainState(params, adamw_init(params), 0)


def test_run_training_exhausted_restarts_raise(tmp_path):
    from repro_torch.runtime.failures import ChipFailure

    with pytest.raises(ChipFailure):
        # 12 distinct failing steps > MAX_RESTARTS (8)
        _run(tmp_path, fail_at=range(12), steps_=12)
