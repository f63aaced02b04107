"""Phase 7b's int8 card-vs-CPU gate of ``chip_smoke.py``, on the CPU.

The gate holds a run of the 2-layer full-width tinyllama-1.1b int8 cut
against the CPU's run of it: (a) every norm-input int8 code within 1 of the
CPU's, (b) at most 2% of them differing, (c) the worst-step logits gap at
most 4 x 2^-8.  Here the "card" run is a second CPU run whose prefill
attention output is perturbed through a wrapper around
``repro_torch.kernels.ref.attention``, the plain version the CPU prefill
calls once per layer:

* each element moved by one ulp in a seeded direction (a rounding tie, as
  another summation order or a tensor-core product gives): passes;
* both products on a single TF32 pass (``ref.split_matmul(..., 1)``, a
  wrong kernel) and a 1e-4 relative noise: fail, all three gates.

The gate is imported from ``chip_smoke.py`` at the repository root, not
copied.  One run of the cut takes some seconds.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

STEPS = 8  # 7b's prefill + 8 teacher-forced decode steps, prompt 97, seed 0


@pytest.fixture(scope="module")
def cpu_run():
    cfg, host, prompt = chip_smoke.int8_cut(seed=0)
    tokens = []
    logits, codes = chip_smoke.int8_trajectory(cfg, host, prompt, STEPS, "cpu", tokens)
    return cfg, host, prompt, tokens, logits, codes


def _one_ulp(seed):
    r = np.random.RandomState(seed)

    def perturb(out):
        up = torch.from_numpy(r.rand(*out.shape) < 0.5)
        toward = torch.where(up, float("inf"), float("-inf")).to(out.dtype)
        return torch.nextafter(out, toward)

    return perturb


def _noise(scale, seed=0):
    r = np.random.RandomState(seed)
    return lambda out: out * torch.from_numpy(
        (1 + scale * r.randn(*out.shape)).astype(np.float32))


def _perturbed_run(cpu_run, monkeypatch, perturb=None, product=None):
    cfg, host, prompt, tokens, _, _ = cpu_run
    real = ref.attention
    calls = []

    def wrapped(q, k, v, **kw):
        assert not kw.get("residuals"), "the serving prefill takes no residuals"
        calls.append(q.shape)
        if product is not None:
            kw["product"] = product
        out = real(q, k, v, **kw)
        return out if perturb is None else perturb(out)

    monkeypatch.setattr(ref, "attention", wrapped)
    run = chip_smoke.int8_trajectory(cfg, host, prompt, STEPS, "cpu", list(tokens))
    assert len(calls) == cfg.n_layers  # the prefill's attention, one per layer
    return run


def _gate(cpu_run, run):
    cfg, _, _, _, logits, codes = cpu_run
    return chip_smoke.int8_gate(*run, logits, codes, unit=cfg.policy().fmt.error_bound())


def test_the_cut_and_its_codes(cpu_run):
    cfg, _, prompt, tokens, logits, codes = cpu_run
    # 5 norms (2 layers x 2, the final norm) at the prefill and each step
    assert len(codes) == (2 * cfg.n_layers + 1) * (STEPS + 1)
    assert all(c.dtype == torch.int8 and int(c.abs().max()) == 127 for c in codes)
    assert len(tokens) == STEPS and len(logits) == STEPS + 1
    assert codes[0].shape == (1, len(prompt), cfg.d_model)
    assert chip_smoke.INT8_GAP_MARGIN * cfg.policy().fmt.error_bound() == 1.5625e-2


def test_an_unperturbed_run_is_identical(cpu_run, monkeypatch):
    st = _gate(cpu_run, _perturbed_run(cpu_run, monkeypatch))
    assert st["n_differ"] == 0 and st["worst_gap"] == 0.0


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_one_ulp_passes(cpu_run, monkeypatch, seed):
    st = _gate(cpu_run, _perturbed_run(cpu_run, monkeypatch, perturb=_one_ulp(seed)))
    assert st["max_code_diff"] <= chip_smoke.INT8_CODE_STEP


@pytest.mark.parametrize("wrong", ["tf32_one_pass", "noise_1e-4"])
def test_a_wrong_attention_fails_all_three_gates(cpu_run, monkeypatch, wrong):
    if wrong == "tf32_one_pass":
        run = _perturbed_run(cpu_run, monkeypatch,
                             product=lambda eq, a, b: ref.split_matmul(a, b, 1, eq))
    else:
        run = _perturbed_run(cpu_run, monkeypatch, perturb=_noise(1e-4))
    cfg, _, _, _, logits, codes = cpu_run
    st = chip_smoke.int8_gate_stats(*run, logits, codes)
    unit = cfg.policy().fmt.error_bound()
    assert st["max_code_diff"] > chip_smoke.INT8_CODE_STEP
    assert st["share"] > chip_smoke.INT8_CODE_SHARE
    assert st["worst_gap"] > chip_smoke.INT8_GAP_MARGIN * unit
    with pytest.raises(SystemExit):
        chip_smoke.int8_gate(*run, logits, codes, unit=unit)
