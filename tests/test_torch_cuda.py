"""The port's CUDA kernels and serving path on a GPU.

Every test here needs an NVIDIA GPU and nvcc and skips without them (the
kernels have no CPU mode).  The file imports no JAX, so it also runs on a
GPU machine without it: ``python -m pytest tests/test_torch_cuda.py -q``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import flash_attention as flash_kernel  # noqa: E402
from repro_torch.kernels import gs_rmsnorm as rms_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving import Engine, EngineConfig, Request, generate_sequential  # noqa: E402

BOUND = {torch.float32: 2.0**-15, torch.bfloat16: 2.0**-4}
# each dtype with the (p, iters) pairs its accuracy budget resolves to, as
# the reference's ERR_BOUNDS assume: a seed-only (8, 0) datapath on f32
# inputs is accurate to 2^-8, and a last-ulp difference in a row sum can
# move its ROM index by one bucket
PRECISIONS = {torch.float32: [(7, 2, "feedback"), (7, 2, "pipelined"), (12, 1, "pipelined")],
              torch.bfloat16: [(8, 0, "feedback"), (8, 0, "pipelined")]}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_versions(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for rows, d in ((4, 2048), (97, 2048), (13, 200)):
        x = torch.randn(rows, d, generator=g, device=cuda_device).to(dtype)
        gain = 1 + 0.1 * torch.randn(d, generator=g, device=cuda_device)
        for p, iters, variant in PRECISIONS[dtype]:
            kw = dict(eps=1e-5, p=p, iters=iters, variant=variant)
            got, got_inv = rms_kernel.gs_rmsnorm(x, gain, save_inv=True, **kw)
            want, want_inv = ref.rmsnorm(x, gain, save_inv=True, **kw)
            assert (got.float() - want.float()).abs().max().item() <= BOUND[dtype]
            assert ((got_inv - want_inv).abs() / want_inv).max().item() <= 2.0**-20
    for s, h, kh, hd in ((33, 32, 4, 64), (97, 32, 4, 64), (128, 32, 4, 64), (11, 4, 2, 16)):
        q = torch.randn(2, h, s, hd, generator=g, device=cuda_device).to(dtype)
        k, v = (torch.randn(2, kh, s, hd, generator=g, device=cuda_device).to(dtype)
                for _ in range(2))
        for p, iters, variant in PRECISIONS[dtype]:
            kw = dict(causal=True, p=p, iters=iters, variant=variant)
            got = flash_kernel.flash_attention(q, k, v, **kw)
            want = ref.attention(q, k, v, **kw)
            assert (got.float() - want.float()).abs().max().item() <= BOUND[dtype]
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_smoke_engine_runs_the_kernels(cuda_device):
    cfg = configs.get_smoke("tinyllama-1.1b", dtype="float32")
    params = api.init(cfg, seed=0, device=cuda_device)
    r = np.random.RandomState(0)
    reqs = [Request(rid=i, prompt=r.randint(0, cfg.vocab, (s,)), max_new_tokens=g,
                    arrival_time=t)
            for i, (s, g, t) in enumerate([(6, 5, 0.0), (9, 8, 0.0), (13, 4, 0.01)])]
    ops.reset_launch_counts()
    res = Engine(cfg, params, EngineConfig(n_slots=2)).run(reqs)
    m = res.metrics
    assert ops.launch_counts() == {
        "gs_rmsnorm": (2 * cfg.n_layers + 1) * (m.first_tokens + m.decode_ticks),
        "flash_attention": cfg.n_layers * m.first_tokens}
    for req in reqs:
        np.testing.assert_array_equal(res[req.rid].tokens,
                                      generate_sequential(cfg, params, req).tokens)
