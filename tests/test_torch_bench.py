"""The port's kernel benchmark (``repro_torch.benchmarks``) against the
reference's ``benchmarks/bench_kernels.py``.

Both sweeps run once, at smoke size, on this CPU: the reference's Pallas
kernels in interpret mode, the port's plain PyTorch versions.  The inputs
are the same numpy draws, so row for row the two must name the same
kernel, dtype, policy, config, bound and target, both must be within
bound, and their errors must agree to a quarter of the bound.  The CLI is
driven as a user drives it.  The kernels themselves run the same sweep on
the card in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from benchmarks import bench_kernels as jbench  # noqa: E402
from repro.kernels.tuning import dispatch  # noqa: E402
from repro_torch.benchmarks import bench_kernels, run  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N_ROWS = 42  # 5 kernels x 2 dtypes x 3 rows + gs_adam's 3 + 3 formats x 3 int8 kernels
IMPL = {"pallas": "plain", "jnp": "torch"}  # the reference's impl -> the port's on the CPU
KEYS = ("kernel", "dtype", "policy", "config", "err_bound", "target_bits")


@pytest.fixture(scope="module")
def sweeps():
    before = dispatch.fallback_stats()
    want = jbench.records(smoke=True)
    # the reference's rows came from its Pallas kernels, not its jnp fallback
    assert dispatch.fallback_stats() == before
    return want, bench_kernels.records(smoke=True, device="cpu")


def test_rows_match_the_reference_row_for_row(sweeps):
    want, got = sweeps
    assert len(want) == len(got) == N_ROWS
    for w, g in zip(want, got):
        assert {k: g[k] for k in KEYS} == {k: w[k] for k in KEYS}
        assert g["impl"] == IMPL[w["impl"]] and g["device"] == "cpu"


@pytest.mark.parametrize("i", range(N_ROWS))
def test_row_error_within_bound_and_near_the_reference(sweeps, i):
    want, got = sweeps
    w, g = want[i], got[i]
    assert w["ok"] and g["ok"], (w, g)
    assert abs(g["max_err"] - w["max_err"]) <= g["err_bound"] / 4, (w, g)


def test_bounds_are_the_reference_bounds():
    assert bench_kernels.ERR_BOUNDS == jbench.ERR_BOUNDS
    assert bench_kernels.FIXED_MARGIN == jbench.FIXED_MARGIN


def test_expected_launches_count_the_kernel_rows(sweeps):
    """On the card each kernel row launches its kernel calls_per_row times;
    the tensor-op rows launch none."""
    _, got = sweeps
    on_card = [dict(r, impl="cuda" if r["impl"] == "plain" else r["impl"]) for r in got]
    want = bench_kernels.expected_launches(on_card, smoke=False)
    per_row = bench_kernels.calls_per_row(False)
    assert per_row == 1 + bench_kernels.WARMUP + bench_kernels.repeats_for(False)
    assert want == {"gs_recip": 4 * per_row, "gs_rsqrt": 4 * per_row, "gs_softmax": 4 * per_row,
                    "gs_rmsnorm": 4 * per_row, "flash_attention": 4 * per_row,
                    "gs_adam": 2 * per_row, "gs_fixed_recip": 3 * per_row,
                    "gs_fixed_softmax": 3 * per_row, "gs_fixed_rmsnorm": 3 * per_row}


def test_cli_smoke_check_on_the_cpu_writes_the_rows(tmp_path):
    out = tmp_path / "bench.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.run", "--smoke", "--check",
         "--device", "cpu", "--json", str(out)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(out.read_text())
    assert doc["smoke"] is True and doc["device"] == "cpu"
    assert len(doc["rows"]) == N_ROWS and all(r["ok"] for r in doc["rows"])
    assert proc.stdout.splitlines()[0] == "name,us_per_call,derived"
    assert len(proc.stdout.splitlines()) == 1 + N_ROWS


def test_cli_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "bench.json"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--smoke", "--device", "cuda", "--json", str(out)])
    assert not out.exists()
