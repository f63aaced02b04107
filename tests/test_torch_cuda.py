"""The port's CUDA kernels, serving and training paths on a GPU.

Every test here needs an NVIDIA GPU and nvcc and skips without them (the
kernels have no CPU mode).  The file imports no JAX, so it also runs on a
GPU machine without it: ``python -m pytest tests/test_torch_cuda.py -q``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import configs  # noqa: E402
from repro_torch.benchmarks import bench_kernels  # noqa: E402
from repro_torch.core import formats  # noqa: E402
from repro_torch.kernels import flash_attention as flash_kernel  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as flash_bwd_kernel  # noqa: E402
from repro_torch.kernels import gs_adam as adam_kernel  # noqa: E402
from repro_torch.kernels import gs_elementwise as elementwise_kernel  # noqa: E402
from repro_torch.kernels import gs_fixed as fixed_kernel  # noqa: E402
from repro_torch.kernels import gs_rmsnorm as rms_kernel  # noqa: E402
from repro_torch.kernels import gs_softmax as softmax_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.steps import TrainHParams, lr_at, make_train_step  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update  # noqa: E402
from repro_torch.optim.adamw import clip_by_global_norm  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten  # noqa: E402
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
        "flash_attention": cfg.n_layers * m.first_tokens,
        "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0, "gs_adam": 0,
        "gs_fixed_recip": 0, "gs_fixed_softmax": 0, "gs_fixed_rmsnorm": 0,
        "gs_recip": 0, "gs_rsqrt": 0, "gs_softmax": 0}
    for req in reqs:
        np.testing.assert_array_equal(res[req.rid].tokens,
                                      generate_sequential(cfg, params, req).tokens)


def _err(got, want) -> float:
    """Max error over the plain version's largest element."""
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernels_match_plain_versions(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    for s, h, kh, hd, causal in ((97, 32, 4, 64, True), (128, 8, 2, 32, False),
                                 (11, 4, 2, 16, True), (70, 4, 4, 16, False)):
        q, do = (torch.randn(2, h, s, hd, generator=g, device=cuda_device).to(dtype)
                 for _ in range(2))
        k, v = (torch.randn(2, kh, s, hd, generator=g, device=cuda_device).to(dtype)
                for _ in range(2))
        for p, iters, variant in PRECISIONS[dtype]:
            kw = dict(causal=causal, p=p, iters=iters, variant=variant)
            out, m, l = flash_kernel.flash_attention(q, k, v, residuals=True, **kw)
            want_out, want_m, want_l = ref.attention(q, k, v, residuals=True, **kw)
            assert (out.float() - want_out.float()).abs().max().item() <= BOUND[dtype]
            assert ((m - want_m).abs() / want_m.abs().clamp_min(1.0)).max().item() <= 1e-5
            assert ((l - want_l).abs() / want_l).max().item() <= 1e-5
            got = flash_bwd_kernel.flash_attention_bwd(q, k, v, do, out, m, l, **kw)
            want = ref.attention_bwd(q, k, v, do, out, m, l, **kw)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert _err(a, b) <= BOUND[dtype]
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_adam_kernel_matches_plain_version(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    for n in (1, 1000, 131 * 129, 1 << 20):
        w, grad = (torch.randn(n, generator=g, device=cuda_device) for _ in range(2))
        grad[::7] = 0.0
        m = 0.1 * torch.randn(n, generator=g, device=cuda_device)
        v = torch.rand(n, generator=g, device=cuda_device) * 1e-2
        v[::7] = 0.0
        for step in (1, 3):
            for p, iters, variant in PRECISIONS[torch.float32]:
                bc = ops.adam_scalars(step, 1e-3, beta1=0.9, beta2=0.95, device=cuda_device)
                kw = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1, p=p,
                          iters=iters, variant=variant)
                got = adam_kernel.gs_adam_update(w, grad, m, v, bc, **kw)
                want = ref.adam_update(w, grad, m, v, bc, **kw)
                for a, b in zip(got, want):
                    assert _err(a, b) <= 2.0**-18
    torch.cuda.synchronize()


def _smoke_step(device):
    cfg = configs.get_smoke("tinyllama-1.1b", dtype="float32")
    params = api.init(cfg, seed=0, device="cpu")
    params = tree_map(lambda t: t.to(device), params)
    r = np.random.RandomState(0)
    batch = {k: torch.from_numpy(r.randint(0, cfg.vocab, (2, 40))).to(device)
             for k in ("tokens", "labels")}
    step = make_train_step(cfg, TrainHParams(peak_lr=1e-3, warmup=0, total=10))
    return cfg, step(params, adamw_init(params), batch)


@pytest.mark.cuda
def test_smoke_train_step_on_the_card_matches_the_cpu(cuda_device):
    torch.backends.cuda.matmul.allow_tf32 = False
    ops.reset_launch_counts()
    cfg, (p_gpu, opt_gpu, met_gpu) = _smoke_step(cuda_device)
    counts = ops.launch_counts()
    n_leaves = len(tree_leaves(p_gpu))
    assert counts == {"gs_rmsnorm": 2 * cfg.n_layers + 1, "flash_attention": cfg.n_layers,
                      "flash_attention_bwd_dq": cfg.n_layers,
                      "flash_attention_bwd_dkv": cfg.n_layers, "gs_adam": n_leaves,
                      "gs_fixed_recip": 0, "gs_fixed_softmax": 0, "gs_fixed_rmsnorm": 0,
        "gs_recip": 0, "gs_rsqrt": 0, "gs_softmax": 0}
    _, (p_cpu, opt_cpu, met_cpu) = _smoke_step("cpu")
    assert abs(met_gpu["loss"].item() - met_cpu["loss"].item()) <= 1e-4 * met_cpu["loss"].item()
    # m and v hold the clipped gradients after one step from zeros
    for a, b in zip(tree_leaves((opt_gpu["m"], opt_gpu["v"])),
                    tree_leaves((opt_cpu["m"], opt_cpu["v"]))):
        assert _err(a.cpu(), b) <= 1e-3
    # the first AdamW update g / (|g| + eps) is ill-conditioned where the
    # clipped gradient is nonzero and within 10·eps of 0: there lr/4 bounds
    # the difference, as in chip_smoke.py phase 6
    for a, b, m in zip(tree_leaves(p_gpu), tree_leaves(p_cpu), tree_leaves(opt_cpu["m"])):
        d = (a.cpu() - b).abs()
        ill = (m.abs() < 0.1 * 10 * 1e-8) & (m != 0)
        assert (torch.where(ill, 0.0, d).max() / b.abs().max()).item() <= 1e-3
        if ill.any():
            near = d[ill].max().item()
            assert near <= 1e-3 / 4, f"{near:.3e} where the clipped gradient is near 0"
    assert int(opt_gpu["step"]) == 1


@pytest.mark.cuda
def test_adamw_update_on_the_same_gradients_matches_the_cpu(cuda_device):
    """The update alone: the CPU's clipped gradients of the smoke step
    through the card's adamw_update (gs_adam) and the CPU's (its plain
    version), the ill-conditioned elements included."""
    cfg = configs.get_smoke("tinyllama-1.1b", dtype="float32")
    hp = TrainHParams(peak_lr=1e-3, warmup=0, total=10)
    policy = cfg.optimizer_policy()
    host = api.init(cfg, seed=0, device="cpu")
    r = np.random.RandomState(0)
    batch = {k: torch.from_numpy(r.randint(0, cfg.vocab, (2, 40))) for k in ("tokens", "labels")}
    live = tree_map(lambda t: t.detach().requires_grad_(), host)
    grads = torch.autograd.grad(api.loss_fn(cfg, live, batch), tree_leaves(live))
    clipped, _ = clip_by_global_norm(tree_unflatten(host, list(grads)), hp.clip_norm, policy)
    out = {}
    for dev in (cuda_device, "cpu"):
        params = tree_map(lambda t: t.to(dev), host)
        state = adamw_init(params)
        new_p, new_o, _ = adamw_update(
            params, tree_map(lambda t: t.to(dev), clipped), state, lr=lr_at(hp, state["step"]),
            policy=policy, beta1=hp.beta1, beta2=hp.beta2, weight_decay=hp.weight_decay,
            clip_norm=None)
        out[dev] = tree_leaves((new_p, new_o["m"], new_o["v"]))
    for a, b in zip(out[cuda_device], out["cpu"]):
        assert _err(a.cpu(), b) <= 2.0**-18


# benchmarks/bench_kernels.py's three fixed formats
FIXED_FORMATS = (formats.format_for("int8"), formats.NumericFormat.fixed(30),
                 formats.NumericFormat.fixed(24, p=7, mitchell_iters=1))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["feedback", "pipelined"])
def test_fixed_kernels_match_plain_versions(cuda_device, variant):
    """recip and rmsnorm bit-equal to their plain versions; softmax (the row
    sum's order is the kernel's own) within 2^-12 of the plain value,
    elementwise: above the sum-order spread (d·2^-24, 1.2e-4 at d = 2048),
    below a neighbouring ROM word (2^-p >= 2^-8)."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    for shape in ((256, 128), (4, 2048), (37, 200)):
        x = torch.randint(-127, 128, shape, generator=g, device=cuda_device, dtype=torch.int8)
        x.view(-1)[::17] = 0
        gain = 1 + 0.1 * torch.randn(shape[-1], generator=g, device=cuda_device)
        scale = torch.tensor(0.02, device=cuda_device)
        for fmt in FIXED_FORMATS:
            kw = dict(fmt.precision(), variant=variant)
            assert torch.equal(fixed_kernel.gs_fixed_recip(x, scale, **kw),
                               ref.fixed_recip(x, scale, **kw))
            got = fixed_kernel.gs_fixed_softmax(x, scale, **kw)
            want = ref.fixed_softmax(x, scale, **kw)
            assert ((got - want).abs() <= 2.0 ** -12 * want).all()
            rkw = dict(eps=1e-5, p=fmt.p, frac_bits=fmt.frac_bits, iters=fmt.iters)
            assert torch.equal(fixed_kernel.gs_fixed_rmsnorm(x, scale, gain, **rkw),
                               ref.fixed_rmsnorm(x, scale, gain, **rkw))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_smoke_int8_engine_runs_the_fixed_kernel(cuda_device):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_smoke("tinyllama-1.1b", dtype="float32", quant="int8")
    params = api.init(cfg, seed=0, device=cuda_device)
    r = np.random.RandomState(0)
    reqs = [Request(rid=i, prompt=r.randint(0, cfg.vocab, (s,)), max_new_tokens=g)
            for i, (s, g) in enumerate([(6, 5), (9, 8), (13, 4)])]
    engine = Engine(cfg, params, EngineConfig(n_slots=2))
    assert engine.params["q"]["embed"].dtype == torch.int8
    ops.reset_launch_counts()
    res = engine.run(reqs)
    m = res.metrics
    assert ops.launch_counts() == {
        "gs_rmsnorm": 0, "flash_attention": cfg.n_layers * m.first_tokens,
        "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0, "gs_adam": 0,
        "gs_fixed_recip": 0, "gs_fixed_softmax": 0,
        "gs_fixed_rmsnorm": (2 * cfg.n_layers + 1) * (m.first_tokens + m.decode_ticks),
        "gs_recip": 0, "gs_rsqrt": 0, "gs_softmax": 0}
    again = engine.run(reqs)
    for req in reqs:
        toks = res[req.rid].tokens
        assert len(toks) == req.max_new_tokens and 0 <= toks.min() and toks.max() < cfg.vocab
        np.testing.assert_array_equal(again[req.rid].tokens, toks)


# the (dtype, p, iters, variant) grid of tests/test_torch_kernels.py, and two
# f32 points whose Goldschmidt error (2^-9 seed-only, 2^-14 after one pass)
# stands far above f32 roundoff, so that an exact 1/sum in gs_softmax fails
ELEMENTWISE_PRECISIONS = [(torch.float32, 7, 2, "feedback"), (torch.float32, 12, 1, "pipelined"),
                          (torch.bfloat16, 8, 0, "feedback"), (torch.bfloat16, 8, 0, "pipelined"),
                          (torch.float32, 8, 0, "feedback"), (torch.float32, 7, 1, "pipelined")]
# ±0, the smallest subnormal, ±inf, NaN, -2, the largest and smallest normal
SPECIALS = [0.0, -0.0, 1e-45, float("inf"), float("-inf"), float("nan"), -2.0,
            3.4028234663852886e38, 1.1754943508222875e-38]


def _bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit patterns, any NaN matching any NaN."""
    ints = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    same = (a.view(ints) == b.view(ints)) | (torch.isnan(a) & torch.isnan(b))
    return a.dtype == b.dtype and a.shape == b.shape and bool(same.all())


def _elementwise_inputs(device):
    """Signed magnitudes log-uniform over 2^-60..2^61 at three shapes, and
    the specials."""
    r = np.random.RandomState(0)
    out = []
    for shape in ((256, 128), (33, 517), (4096, 128)):
        x = np.exp2(r.uniform(-60, 60, shape)) * (1 + r.rand(*shape))
        out.append(torch.from_numpy(x * np.where(r.rand(*shape) < 0.5, -1, 1))
                   .float().to(device))
    out.append(torch.tensor(SPECIALS, device=device))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,p,iters,variant", ELEMENTWISE_PRECISIONS)
def test_elementwise_kernels_are_bit_equal_to_plain_versions(cuda_device, dtype, p, iters,
                                                             variant):
    kw = dict(p=p, iters=iters, variant=variant)
    ops.reset_launch_counts()
    xs = _elementwise_inputs(cuda_device)
    for x in xs:
        x = x.to(dtype)
        assert _bit_equal(elementwise_kernel.gs_recip(x, **kw), ref.reciprocal(x, **kw))
        for mode in ("rsqrt", "sqrt"):
            assert _bit_equal(elementwise_kernel.gs_rsqrt(x, mode=mode, **kw),
                              ref.rsqrt(x, mode=mode, **kw))
        got = elementwise_kernel.gs_rsqrt(x, mode="sqrt_both", **kw)
        want = ref.rsqrt(x, mode="sqrt_both", **kw)
        assert all(_bit_equal(a, b) for a, b in zip(got, want))
    counts = ops.launch_counts()
    assert counts["gs_recip"] == len(xs) and counts["gs_rsqrt"] == 3 * len(xs)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,p,iters,variant", ELEMENTWISE_PRECISIONS)
def test_softmax_kernel_matches_plain_version(cuda_device, dtype, p, iters, variant):
    """f32 within 2^-18 of the plain value (the row sum's order is the
    kernel's own, exp is expf), bf16 within one ulp."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    kw = dict(p=p, iters=iters, variant=variant)
    for shape in ((16, 384), (37, 200), (8, 32000)):
        x = (4 * torch.randn(shape, generator=g, device=cuda_device)).to(dtype)
        got, want = softmax_kernel.gs_softmax(x, **kw), ref.softmax(x, **kw)
        assert got.dtype == dtype and got.shape == x.shape
        if dtype == torch.float32:
            assert ((got - want).abs() <= 2.0**-18 * want).all()
        else:
            assert ((got.view(torch.int16).int() - want.view(torch.int16).int()).abs() <= 1).all()
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_elementwise_vjps_on_the_card_match_the_cpu(cuda_device, dtype):
    r = np.random.RandomState(3)
    pos = torch.from_numpy(r.uniform(0.05, 20.0, (64, 128)).astype(np.float32)).to(dtype)
    rows = torch.from_numpy((4 * r.randn(16, 384)).astype(np.float32)).to(dtype)
    bound = {torch.float32: 2.0**-18, torch.bfloat16: 2.0**-7}[dtype]
    for op, x, tol in ((ops.gs_recip, pos, bound), (ops.gs_rsqrt, pos, bound),
                       (ops.gs_sqrt, pos, bound),
                       (ops.gs_softmax, rows, max(bound, 2.0**-12))):
        cot = torch.from_numpy(r.randn(*x.shape).astype(np.float32)).to(dtype)
        grads = []
        for dev in (cuda_device, "cpu"):
            xd = x.to(dev).requires_grad_()
            (gd,) = torch.autograd.grad(op(xd), xd, cot.to(dev))
            grads.append(gd.float().cpu())
        assert (grads[0] - grads[1]).abs().max() <= tol * grads[1].abs().max()


@pytest.mark.cuda
def test_bench_records_on_the_card_are_ok_and_launch_each_kernel(cuda_device):
    torch.backends.cuda.matmul.allow_tf32 = False
    ops.reset_launch_counts()
    recs = bench_kernels.records(smoke=True, device=cuda_device)
    counts = ops.launch_counts()
    assert len(recs) == 42 and all(r["ok"] for r in recs), [r for r in recs if not r["ok"]]
    launched = bench_kernels.expected_launches(recs, smoke=True)
    assert counts == {name: launched.get(name, 0) for name in counts}
    assert {"gs_recip", "gs_rsqrt", "gs_softmax"} <= set(launched)
