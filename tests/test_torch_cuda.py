"""The port's CUDA kernels, serving and training paths on a GPU.

Every test here needs an NVIDIA GPU and nvcc and skips without them (the
kernels have no CPU mode).  The file imports no JAX, so it also runs on a
GPU machine without it: ``python -m pytest tests/test_torch_cuda.py -q``.
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
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


# (rows, d, storage offset, zero row): one row to a full training batch;
# d 37 (the one-element instance), 200 (narrow rows, several a block), 2048
# and 8192 (the row in registers), 16392 past the largest register plan and
# 4097 past the one-element plan (the looping instances); a view one element
# into its storage (not 16-byte aligned: the one-element instance); a row of
# zeros (ms = 0, so the row's rsqrt is eps's)
RMSNORM_SHAPES = [(1, 2048, 0, False), (4, 2048, 0, False), (333, 2048, 0, False),
                  (2048, 2048, 0, False), (5, 37, 0, False), (13, 200, 0, False),
                  (3, 8192, 0, False), (3, 16392, 0, False), (2, 4097, 0, False),
                  (33, 2048, 1, False), (6, 2048, 0, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,offset,zero_row", RMSNORM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_plans_match_plain_version(cuda_device, dtype, rows, d, offset,
                                                  zero_row):
    g = torch.Generator(device=cuda_device).manual_seed(rows * d + offset)
    buf = (3 * torch.randn(rows * d + offset, generator=g, device=cuda_device)).to(dtype)
    x = buf[offset:].view(rows, d)
    if zero_row:
        x[rows // 2] = 0
    gain = 1 + 0.1 * torch.randn(d, generator=g, device=cuda_device)
    assert x.is_contiguous() and x.storage_offset() == offset
    for p, iters, variant in PRECISIONS[dtype]:
        kw = dict(eps=1e-5, p=p, iters=iters, variant=variant)
        before = rms_kernel.launches
        got, got_inv = rms_kernel.gs_rmsnorm(x, gain, save_inv=True, **kw)
        assert rms_kernel.launches == before + 1
        want, want_inv = ref.rmsnorm(x, gain, save_inv=True, **kw)
        assert (got.float() - want.float()).abs().max().item() <= BOUND[dtype]
        assert ((got_inv - want_inv).abs() / want_inv).max().item() <= 2.0**-20
        if zero_row:
            assert not got[rows // 2].any()
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


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_paged_engine_matches_the_slot_engine_on_a_2_layer_cut(cuda_device, quant):
    """Full-width tinyllama cut to 2 layers: the paged engine (page size 16)
    gives the slot engine's tokens, launches the norm kernel at every norm of
    every prefill and tick and the flash forward at every prefill, and ends
    with every page free.  At f32 the arena holds one s_max request and 3
    pages more, so decode-time appends run out and the youngest request is
    preempted and replayed; int8 (one activation scale over the tick batch)
    keeps the slot engine's schedule: the default arena, and no preemption
    of the youngest while the head of line waits for a slot."""
    import dataclasses

    cfg = dataclasses.replace(configs.get_config("tinyllama-1.1b", dtype="float32"),
                              n_layers=2, quant=quant)
    params = api.init(cfg, seed=0, device=cuda_device)
    r = np.random.RandomState(1)
    reqs = [Request(rid=i, prompt=r.randint(0, cfg.vocab, (s,)), max_new_tokens=12)
            for i, s in enumerate((45, 97, 150, 64, 33))]
    s_max = 150 + 12
    slot = Engine(cfg, params, EngineConfig(n_slots=3, s_max=s_max)).run(reqs)
    n_pages = -(-s_max // 16) + 1 + 3 if quant == "none" else 0
    stall = 3 if quant == "none" else chip_smoke.NO_STALL_PREEMPT
    engine = Engine(cfg, params, EngineConfig(n_slots=3, s_max=s_max, pool="paged",
                                              n_pages=n_pages, prefix="off",
                                              preempt_after_ticks=stall))
    ops.reset_launch_counts()
    res = engine.run(reqs)
    counts = ops.launch_counts()
    for req in reqs:
        np.testing.assert_array_equal(res[req.rid].tokens, slot[req.rid].tokens)
    m = res.metrics
    if quant == "none":
        assert m.preempted >= 1 and m.pool["appended_pages"] >= 1
    assert m.pool["pages_in_use"] == 0 and m.pool["free_slots"] == 3
    prefills = m.first_tokens + m.preempted
    norm = "gs_rmsnorm" if quant == "none" else "gs_fixed_rmsnorm"
    assert counts[norm] == (2 * cfg.n_layers + 1) * (prefills + m.decode_ticks)
    assert counts["flash_attention"] == cfg.n_layers * prefills


def _err(got, want) -> float:
    """Max error over the plain version's largest element."""
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


# (S, H, KH, D, causal): ragged and whole 64-row tiles (S 512 runs eight
# and the diagonal), D 64/32/16, GQA groups 1, 2, 4 and 8, causal and not
FLASH_BWD_SHAPES = ((97, 32, 4, 64, True), (128, 8, 2, 32, False), (11, 4, 2, 16, True),
                    (70, 4, 4, 16, False), (512, 8, 1, 64, True), (512, 4, 4, 64, False),
                    (333, 8, 8, 32, True), (333, 8, 1, 16, False), (512, 4, 2, 16, True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernels_match_plain_versions(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    for s, h, kh, hd, causal in FLASH_BWD_SHAPES:
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
@pytest.mark.parametrize("s,h,kh,hd,causal", [(512, 8, 1, 64, True), (333, 8, 8, 32, True),
                                             (128, 8, 2, 32, False), (70, 4, 4, 16, False)])
def test_flash_backward_kernels_match_an_f64_oracle(cuda_device, s, h, kh, hd, causal):
    """The kernels' products are three TF32 passes: dq, dk, dv within 10x the
    plain f32 version's max error against the plain version run in f64 (a
    single TF32 pass, about 11 bits, would not be)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(4)
    q, do = (torch.randn(2, h, s, hd, generator=g, device=cuda_device) for _ in range(2))
    k, v = (torch.randn(2, kh, s, hd, generator=g, device=cuda_device) for _ in range(2))
    kw = dict(causal=causal, p=7, iters=2, variant="feedback")
    out, m, l = flash_kernel.flash_attention(q, k, v, residuals=True, **kw)
    got = flash_bwd_kernel.flash_attention_bwd(q, k, v, do, out, m, l, **kw)
    want = ref.attention_bwd(q, k, v, do, out, m, l, **kw)
    oracle = ref.attention_bwd(q.double(), k.double(), v.double(), do, out, m, l, **kw)
    for a, b, o in zip(got, want, oracle):
        err = (a.double() - o).abs().max().item()
        assert err <= 10 * (b.double() - o).abs().max().item()
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("s,h,kh,hd,causal", [(512, 8, 1, 64, True), (333, 8, 8, 32, True),
                                             (97, 32, 4, 64, False), (70, 4, 2, 16, True)])
def test_flash_forward_kernel_matches_an_f64_oracle(cuda_device, s, h, kh, hd, causal):
    """The forward's products are three TF32 passes at f32: its output, and
    its (m, l) residuals, within 10x the plain f32 version's max error
    against the plain version run in f64."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(6)
    q = torch.randn(2, h, s, hd, generator=g, device=cuda_device)
    k, v = (torch.randn(2, kh, s, hd, generator=g, device=cuda_device) for _ in range(2))
    kw = dict(causal=causal, p=7, iters=2, variant="feedback")
    got = flash_kernel.flash_attention(q, k, v, residuals=True, **kw)
    want = ref.attention(q, k, v, residuals=True, **kw)
    oracle = ref.attention(q.double(), k.double(), v.double(), residuals=True, **kw)
    for a, b, o in zip(got, want, oracle):
        assert a.dtype == torch.float32 and a.shape == o.shape
        err = (a.double() - o).abs().max().item()
        assert err <= 10 * (b.double() - o).abs().max().item()
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("s,h,kh,hd,causal", [(512, 8, 1, 64, True), (333, 8, 8, 32, True),
                                             (128, 8, 2, 32, False), (70, 4, 4, 16, False)])
def test_flash_backward_dkv_kernel_matches_an_f64_oracle_at_bf16(cuda_device, s, h, kh, hd,
                                                                 causal):
    """At bf16 the products with the f32 p and ds are two TF32 passes: the
    dk/dv kernel's own f32 per-q-head dk, dv (before the group-sum and the
    cast) within 10x the plain f32 version's max error against the plain
    version run in f64.  k and v are repeated per q head, so that the plain
    version's dk, dv are per q head too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q, do = (torch.randn(2, h, s, hd, generator=g, device=cuda_device).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(2, kh, s, hd, generator=g, device=cuda_device).bfloat16()
            for _ in range(2))
    kw = dict(causal=causal, p=8, iters=0, variant="feedback")
    out, m, l = flash_kernel.flash_attention(q, k, v, residuals=True, **kw)
    delta = torch.sum(do.float() * out.float(), dim=-1)
    got = flash_bwd_kernel.dkv(q, k, v, do, m, l, delta, sm_scale=1.0 / math.sqrt(hd),
                                **kw)
    ke, ve = (t.repeat_interleave(h // kh, dim=1) for t in (k, v))
    want = ref.attention_bwd(q, ke.float(), ve.float(), do, out, m, l, **kw)[1:]
    oracle = ref.attention_bwd(q.double(), ke.double(), ve.double(), do, out, m, l, **kw)[1:]
    for a, b, o in zip(got, want, oracle):
        assert a.dtype == torch.float32 and a.shape == o.shape
        err = (a.double() - o).abs().max().item()
        assert err <= 10 * (b.double() - o).abs().max().item()
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("s", [70, 333])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_keep_the_plain_versions_nan_classes(cuda_device, s, causal):
    """A NaN, a +inf and an overflowing value in a q row: the forward with and
    without residuals and the backward pair put NaN, +inf and -inf where the
    plain versions (TF32 passes emulated) do; the row max keeps a NaN."""
    result = chip_smoke.flash_nan_classes(causal, s=s)
    assert all(ok for ok, _, _ in result.values()), result
    # m: NaN on the NaN row and on the +inf row (its TF32 lo part is NaN)
    assert result["m"][1][0] == 2 and result["l"][1][0] == len(chip_smoke.FLASH_SPECIAL_ROWS)


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


# gs_fixed_rmsnorm's launch plans: (rows, d, storage offset, special rows):
# rows 1 to the 2048-token prefill at d 2048 (16-byte vectors, one a
# thread), d 37 and 200 (single codes; narrow rows several a block), 8192
# (two vectors a thread), 16400 and 4097 past the register plans (the
# looping instances), a view one byte into its storage (single codes), and
# a row of zeros (ss = 0, so ms = eps) beside a row of ±127 (the largest ss)
FIXED_RMSNORM_SHAPES = [(1, 2048, 0, False), (4, 2048, 0, True), (333, 2048, 0, False),
                        (2048, 2048, 0, False), (5, 37, 0, False), (13, 200, 0, False),
                        (3, 8192, 0, False), (2, 16400, 0, True), (2, 4097, 0, False),
                        (33, 2048, 1, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,offset,special", FIXED_RMSNORM_SHAPES)
def test_fixed_rmsnorm_kernel_plans_are_bit_equal(cuda_device, rows, d, offset, special):
    """Every plan bit-equal to the plain version in the three formats and at
    p 12, one launch a call."""
    g = torch.Generator(device=cuda_device).manual_seed(rows * d + offset)
    buf = torch.randint(-127, 128, (rows * d + offset,), generator=g, device=cuda_device,
                        dtype=torch.int8)
    x = buf[offset:].view(rows, d)
    if special:
        x[0] = 0
        x[-1] = torch.where(torch.arange(d, device=cuda_device) % 3 == 0, -127, 127)
    assert x.is_contiguous() and x.storage_offset() == offset
    gain = 1 + 0.1 * torch.randn(d, generator=g, device=cuda_device)
    scale = torch.tensor(0.02, device=cuda_device)
    for fmt in FIXED_FORMATS + (formats.NumericFormat.fixed(24, p=12),):
        rkw = dict(eps=1e-5, p=fmt.p, frac_bits=fmt.frac_bits, iters=fmt.iters)
        before = fixed_kernel.launches_rmsnorm
        got = fixed_kernel.gs_fixed_rmsnorm(x, scale, gain, **rkw)
        assert fixed_kernel.launches_rmsnorm == before + 1
        assert torch.equal(got, ref.fixed_rmsnorm(x, scale, gain, **rkw))
        if special:
            assert not got[0].any()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_fixed_rmsnorm_launch_plan_on_the_card(cuda_device):
    """Every plan's instance fits on an SM, and the 2048-row prefill's grid
    is a block a row up to one wave of resident blocks."""
    card_sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for d, ptr_bits in ((2048, 0), (8192, 0), (16400, 0), (37, 0), (200, 0), (2048, 1),
                        (4096, 1), (4097, 0)):
        plan = fixed_kernel.launch_plan(d, ptr_bits)
        sms, resident = fixed_kernel.grid_limits(cuda_device, plan)
        assert sms == card_sms and resident >= 1
        assert rms_kernel.grid_size(2048, plan.rows_per_block, sms, resident) == min(
            -(-2048 // plan.rows_per_block), sms * resident)


# gs_fixed_softmax's launch plans (chip_smoke.py's FIXED_SOFTMAX_SHAPES):
# (rows, d, storage offset, special rows, packed): d 128 (a warp a row, a
# word of four codes a lane) at 256 and 4096 rows, the packed plans at d 128,
# 200 and 37 (on a grid of one block, whose wave the rows fill), d 64
# (half-warp segments), d 1, 37 (single codes), 200, 1024, 4096, 4100 and
# 2049 (rows of several warps), 16400 and 4097 past the register plans,
# views one and four bytes in, and a row of one repeated code beside a row
# holding its max and min twice.  No case holds thousands of rows: there a
# one-ulp difference between the kernel's row sum and torch's crosses a ROM
# bucket boundary in some row, and a seed-only format moves that row by
# ~2^-8, past SOFTMAX_PLAIN_RTOL, while both stay within the oracle's gate.
FIXED_SOFTMAX_SHAPES = [(256, 128, 0, True, False), (4096, 128, 0, False, False),
                        (256, 128, 0, True, True), (64, 200, 0, False, True),
                        (333, 37, 0, True, True), (9, 64, 0, True, False),
                        (33, 1, 0, False, False), (7, 37, 0, True, False),
                        (37, 200, 0, False, False), (6, 1024, 0, False, False),
                        (5, 4096, 0, True, False), (3, 4100, 0, False, False),
                        (3, 2049, 0, False, False), (2, 16400, 0, True, False),
                        (2, 4097, 0, False, False), (33, 128, 1, True, False),
                        (33, 128, 4, False, False)]
FIXED_MARGIN = 2.0  # benchmarks/bench_kernels.py: each int8 row's gate is 2 x its bound
# chip_smoke.py's SOFTMAX_PLAIN_RTOL: the row sum's order is the kernel's own
SOFTMAX_PLAIN_RTOL = 2.0 ** -12


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [0.02, -0.02])
@pytest.mark.parametrize("rows,d,offset,special,packed", FIXED_SOFTMAX_SHAPES)
def test_fixed_softmax_kernel_plans_match_plain_version(cuda_device, monkeypatch, rows, d,
                                                        offset, special, packed, scale):
    """Every plan in the three formats and at p 12, both variants: within
    SOFTMAX_PLAIN_RTOL of the plain version elementwise and within
    FIXED_MARGIN x the format's bound of an f64 oracle, one launch a call."""
    if packed:  # one SM holding one block: the rows fill the wave, so the plan packs
        monkeypatch.setattr(fixed_kernel, "grid_limits",
                            lambda device, plan, kernel="rmsnorm": (1, 1))
    assert fixed_kernel.softmax_launch(rows, d, offset % 16, 0, cuda_device)[0] == (
        fixed_kernel.softmax_plan(d, offset % 16, 0, packed=packed))
    rng = np.random.RandomState(rows * d + offset)
    buf = rng.randint(-127, 128, rows * d + offset).astype(np.int8)
    x_np = buf[offset:].reshape(rows, d)
    if special:
        x_np[0] = 77
        last = x_np[-1]
        if d > 3:
            last[1], last[2] = last.max(), last.min()
            last[0], last[3] = last[1], last[2]
    x = torch.from_numpy(buf).to(cuda_device)[offset:].view(rows, d)
    assert x.is_contiguous() and x.storage_offset() == offset
    xf = x_np.astype(np.float64) * scale
    e = np.exp(xf - xf.max(-1, keepdims=True))
    exact = e / e.sum(-1, keepdims=True)
    sc = torch.tensor(scale, device=cuda_device)
    for fmt in FIXED_FORMATS + (formats.NumericFormat.fixed(24, p=12),):
        for variant in ("feedback", "pipelined"):
            kw = dict(fmt.precision(), variant=variant)
            before = fixed_kernel.launches_softmax
            got = fixed_kernel.gs_fixed_softmax(x, sc, **kw)
            assert fixed_kernel.launches_softmax == before + 1
            want = ref.fixed_softmax(x, sc, **kw)
            assert ((got - want).abs() <= SOFTMAX_PLAIN_RTOL * want).all()
            oracle = np.abs(got.double().cpu().numpy() - exact).max()
            assert oracle <= FIXED_MARGIN * fmt.error_bound()
            if special:  # one repeated code: e all 1, every output the fixed 1/d
                assert torch.equal(got[0], got[0, :1].expand(d))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_fixed_softmax_makes_no_launch_for_no_rows(cuda_device):
    kw = dict(formats.format_for("int8").precision(), variant="feedback")
    before = fixed_kernel.launches_softmax
    out = fixed_kernel.gs_fixed_softmax(torch.empty(0, 128, dtype=torch.int8, device=cuda_device),
                                        torch.tensor(0.02, device=cuda_device), **kw)
    assert out.shape == (0, 128) and fixed_kernel.launches_softmax == before
    with pytest.raises(ValueError, match="at least one code"):
        fixed_kernel.gs_fixed_softmax(torch.empty(4, 0, dtype=torch.int8, device=cuda_device),
                                      0.02, **kw)


@pytest.mark.cuda
def test_fixed_softmax_launch_plan_on_the_card(cuda_device):
    """Every plan's instance, plain and packed, fits on an SM; the benchmark's
    (256, 128) keeps a warp a row and (65536, 128) packs eight rows a warp in
    a grid of one wave."""
    card_sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for rows, d, offset, _, _ in FIXED_SOFTMAX_SHAPES:
        for packed in (False, True):
            plan = fixed_kernel.softmax_plan(d, offset % 16, 0, packed=packed)
            sms, resident = fixed_kernel.grid_limits(cuda_device, plan, "softmax")
            assert sms == card_sms and resident >= 1
    plain, packed = (fixed_kernel.softmax_plan(128, 0, 0, packed=p) for p in (False, True))
    assert fixed_kernel.softmax_launch(256, 128, 0, 0, cuda_device)[0] == plain
    plan, grid = fixed_kernel.softmax_launch(65536, 128, 0, 0, cuda_device)
    sms, resident = fixed_kernel.grid_limits(cuda_device, packed, "softmax")
    assert plan == packed and grid == sms * resident


# gs_fixed_recip's scales (chip_smoke.py's FIXED_RECIP_SCALES): both signs,
# a scale whose 1/scale rounds, and powers of two far from 1
FIXED_RECIP_SCALES = (0.02, -0.02, 4 / 127, 1.0, 2.0 ** -20, 2.0 ** 20)


def _recip_inputs(device):
    """Every code -128..127 (aligned, and 1, 2 and 3 bytes into their
    storage: the single-code instance), (256, 128) and (65536, 128) with
    every 17th code 0 (the latter many trips a lane), lengths 1-7, 9 and
    4097 (an n % 4 tail, or no whole word), and (256, 128) views 1, 2 and 3
    bytes in."""
    codes = torch.arange(-128, 128, device=device).to(torch.int8)
    g = torch.Generator(device=device).manual_seed(12)
    inputs = [_offset_view(codes, off) for off in (0, 1, 2, 3)]
    for shape in ((256, 128), (65536, 128)):
        x = torch.randint(-128, 128, shape, generator=g, device=device, dtype=torch.int8)
        x.view(-1)[::17] = 0
        inputs.append(x)
    inputs += [inputs[4].flatten()[:n] for n in (1, 2, 3, 4, 5, 6, 7, 9, 4097)]
    inputs += [_offset_view(inputs[4], off) for off in (1, 2, 3)]
    return inputs


def _recip_is_bit_equal(x, kw) -> None:
    """gs_fixed_recip at every FIXED_RECIP_SCALES scale: one launch a call,
    bit-equal to the plain version."""
    for s in FIXED_RECIP_SCALES:
        scale = torch.tensor(s, device=x.device)
        before = fixed_kernel.launches_recip
        got = fixed_kernel.gs_fixed_recip(x, scale, **kw)
        assert fixed_kernel.launches_recip == before + 1
        assert _bit_equal(got, ref.fixed_recip(x, scale, **kw)), (
            tuple(x.shape), x.storage_offset(), s, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["feedback", "pipelined"])
def test_fixed_recip_kernel_on_codes_views_tails_and_trips_is_bit_equal(cuda_device, variant):
    """Every code, the single-code instance, the word instances' tails and
    grid-stride loop, in the three formats and at p 12, at every scale:
    bit-equal to the plain version, one launch a call, none for no codes."""
    for x in _recip_inputs(cuda_device):
        for fmt in FIXED_FORMATS + (formats.NumericFormat.fixed(24, p=12),):
            _recip_is_bit_equal(x, dict(fmt.precision(), variant=variant))
    kw = dict(FIXED_FORMATS[0].precision(), variant=variant)
    before = fixed_kernel.launches_recip
    empty = torch.empty(0, 128, dtype=torch.int8, device=cuda_device)
    assert fixed_kernel.gs_fixed_recip(empty, 0.02, **kw).shape == empty.shape
    assert fixed_kernel.launches_recip == before
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n,words", [(32771, 4), (4099, 4), (999, 1)])
def test_fixed_recip_word_instances_on_one_block_are_bit_equal(cuda_device, monkeypatch, n,
                                                               words):
    """On a grid of one block (one SM holding one block, so 4 words a lane
    once their trips fill it twice, else 1), each word instance makes many
    trips and runs a tail, bit-equal to the plain version in every format."""
    monkeypatch.setattr(fixed_kernel, "grid_limits", lambda device, plan, kernel="rmsnorm": (1, 1))
    g = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.randint(-128, 128, (n,), generator=g, device=cuda_device, dtype=torch.int8)
    plan, grid = fixed_kernel.recip_launch(n, x.data_ptr() % 16, 0, cuda_device)
    assert (plan.width, plan.vecs, grid) == (4, words, 1)
    for fmt in FIXED_FORMATS + (formats.NumericFormat.fixed(24, p=12),):
        for variant in ("feedback", "pipelined"):
            _recip_is_bit_equal(x, dict(fmt.precision(), variant=variant))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_fixed_recip_launch_plan_on_the_card(cuda_device):
    """Every gs_fixed_recip_kernel instance fits on an SM; the benchmark's
    (256, 128) takes a word a lane in a block per 128 words, and
    (65536, 128), whose trips fill two waves, 4 words a lane."""
    card_sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for width, words in [(1, 1)] + [(4, w) for w in fixed_kernel.RECIP_WORDS]:
        sms, resident = fixed_kernel.grid_limits(cuda_device, fixed_kernel.recip_plan(width, words),
                                                 "recip")
        assert sms == card_sms and resident >= 1
    plan, grid = fixed_kernel.recip_launch(256 * 128, 0, 0, cuda_device)
    assert (plan.width, plan.vecs, grid) == (4, 1, 64)
    plan, grid = fixed_kernel.recip_launch(65536 * 128, 0, 0, cuda_device)
    sms, resident = fixed_kernel.grid_limits(cuda_device, plan, "recip")
    assert plan.vecs == 4 and grid == sms * resident
    assert 65536 * 32 >= 2 * plan.vecs * fixed_kernel.RECIP_THREADS * grid


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


# gs_softmax's launch plans (chip_smoke.py's SOFTMAX_SHAPES beyond the three
# above): single elements (33, 517), a cluster of 8 CTAs (2, 32000), a decode
# batch of 256 at a 32000-token vocabulary, the widest row the cluster holds
# and a row past it (the looping instance); then views one element into their storage,
# (8, 32000) forced onto clusters of 2 and 4 CTAs (the timing sweep's), and
# the rows a sampler masks
SOFTMAX_PLAN_SHAPES = ((33, 517), (2, 32000), (256, 32000), (2, 131072), (2, 131076))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,p,iters,variant", ELEMENTWISE_PRECISIONS)
def test_softmax_kernel_plans_match_plain_version(cuda_device, monkeypatch, dtype, p, iters,
                                                   variant):
    """Each launch plan within chip_smoke.py's card gate of the plain
    version (f32 2^-18 of the value, bf16 one ulp, NaN in the same places),
    one launch a call, masked rows with the plain version's NaN classes and
    exact zeros."""
    kw = dict(p=p, iters=iters, variant=variant)
    r = np.random.RandomState(13)
    rows = [(4 * r.randn(*shape)).astype(np.float32) for shape in SOFTMAX_PLAN_SHAPES]
    cases = [(torch.from_numpy(x).to(cuda_device).to(dtype), None) for x in rows]
    cases += [(_offset_view(x, 1), None) for x, _ in cases[:2]]
    chosen = softmax_kernel.launch_plan

    def forced(size):
        def launch_plan(d, itemsize, ptr_bits):
            width = softmax_kernel.gs_rmsnorm.vector_width(itemsize, d, ptr_bits)
            return softmax_kernel.cluster_plan(width, d // width, size)
        return launch_plan

    wide = torch.from_numpy((4 * r.randn(8, 32000)).astype(np.float32)).to(cuda_device)
    cases += [(wide.to(dtype), forced(size)) for size in (2, 4)]
    cases += [(torch.from_numpy(chip_smoke.masked_rows(d)).to(cuda_device).to(dtype), None)
              for d in chip_smoke.SOFTMAX_MASKED]
    for x, plan_of in cases:
        monkeypatch.setattr(softmax_kernel, "launch_plan", plan_of or chosen)
        before = softmax_kernel.launches
        got = softmax_kernel.gs_softmax(x, **kw)
        assert softmax_kernel.launches == before + 1
        assert got.shape == x.shape
        assert chip_smoke.softmax_gate(got, ref.softmax(x, **kw))[0], (tuple(x.shape), plan_of)
    monkeypatch.setattr(softmax_kernel, "launch_plan", chosen)
    empty = softmax_kernel.gs_softmax(torch.empty(0, 384, device=cuda_device), **kw)
    assert empty.shape == (0, 384) and softmax_kernel.launches == before + 1
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


def _offset_view(x: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of ``x`` that starts ``offset`` elements into its
    storage."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    return view


# the bit patterns of ±0, ±the smallest bf16 subnormal, the smallest normal,
# a biased exponent of 253 and 254 (the reciprocal's subnormal and ±0) and
# 255 (±inf, NaN of both signs), each exact in bf16
SPECIAL_BITS = [0x00000000, 0x80000000, 0x00010000, 0x80010000, 0x00800000, 0x80800000,
                0x7E800000, 0xFEC00000, 0x7F000000, 0xFF400000, 0x7F800000, 0xFF800000,
                0x7FC00000, 0xFFC10000]


def _plan_inputs(device, dtype):
    """The inputs that reach the kernels' other paths: (256, 128) views 1, 2
    and 3 elements into their storage (the width-1 instance), lengths that
    end in a partial vector of either width, and (65536, 128), where a
    thread makes many trips."""
    xs = _elementwise_inputs(device)
    inputs = [_offset_view(xs[0].to(dtype), off) for off in (1, 2, 3)]
    inputs += [xs[2].to(dtype).flatten()[:n] for n in (1, 2, 3, 4, 5, 6, 7, 9, 4097)]
    g = torch.Generator(device=device).manual_seed(11)
    shape = (65536, 128)
    mag = torch.exp2(120 * torch.rand(shape, generator=g, device=device) - 60)
    sign = torch.where(torch.rand(shape, generator=g, device=device) < 0.5, -1.0, 1.0)
    inputs.append((mag * sign).to(dtype))
    return inputs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,p,iters,variant", ELEMENTWISE_PRECISIONS)
def test_rsqrt_kernel_on_offsets_tails_and_many_trips_is_bit_equal(cuda_device, dtype, p,
                                                                   iters, variant):
    """gs_rsqrt_kernel's width-1 instance (views 1, 2 and 3 elements into
    their storage), its tail (lengths that end in a partial vector) and its
    grid-stride loop ((65536, 128), many trips a thread), in all three
    modes, one launch a call; an empty tensor makes none."""
    kw = dict(p=p, iters=iters, variant=variant)
    for x in _plan_inputs(cuda_device, dtype):
        for mode in ("rsqrt", "sqrt", "sqrt_both"):
            before = elementwise_kernel.launches_rsqrt
            got = elementwise_kernel.gs_rsqrt(x, mode=mode, **kw)
            assert elementwise_kernel.launches_rsqrt == before + 1
            want = ref.rsqrt(x, mode=mode, **kw)
            if mode != "sqrt_both":
                got, want = (got,), (want,)
            assert all(_bit_equal(a, b) for a, b in zip(got, want)), (
                mode, tuple(x.shape), x.storage_offset())
    before = elementwise_kernel.launches_rsqrt
    empty = torch.empty(0, 128, dtype=dtype, device=cuda_device)
    assert elementwise_kernel.gs_rsqrt(empty, mode="sqrt_both", **kw)[0].shape == empty.shape
    assert elementwise_kernel.launches_rsqrt == before
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,p,iters,variant", ELEMENTWISE_PRECISIONS)
def test_recip_kernel_on_offsets_tails_specials_and_many_trips_is_bit_equal(
        cuda_device, dtype, p, iters, variant):
    """gs_recip_kernel's width-1 instance, its tails of every length below
    a vector, its grid-stride loop, and the specials at biased exponents 0,
    253, 254 and 255 of both signs, alone and spread over vectors of normal
    numbers; one launch a call, none for an empty tensor."""
    kw = dict(p=p, iters=iters, variant=variant)
    specials = torch.from_numpy(np.array(SPECIAL_BITS, dtype=np.uint32).view(np.float32))
    specials = specials.to(cuda_device)
    spread = _elementwise_inputs(cuda_device)[0].flatten()[:1024].clone()
    spread[::7][:len(SPECIAL_BITS)] = specials
    inputs = _plan_inputs(cuda_device, dtype) + [specials.to(dtype), spread.to(dtype)]
    for x in inputs:
        before = elementwise_kernel.launches_recip
        got = elementwise_kernel.gs_recip(x, **kw)
        assert elementwise_kernel.launches_recip == before + 1
        assert _bit_equal(got, ref.reciprocal(x, **kw)), (tuple(x.shape), x.storage_offset())
    if dtype == torch.float32:
        bits = elementwise_kernel.gs_recip(specials, **kw).cpu().numpy().view(np.uint32)
        # ±inf from ±0, ±0 at e = 254, at most 2^-126 at e = 253, the canonical NaN
        assert list(bits[[0, 1, 8, 9, 12, 13]]) == [0x7F800000, 0xFF800000, 0, 0x80000000,
                                                    0x7FC00000, 0x7FC00000]
        assert 0 < bits[6] <= 0x00800000
    before = elementwise_kernel.launches_recip
    empty = torch.empty(0, 128, dtype=dtype, device=cuda_device)
    assert elementwise_kernel.gs_recip(empty, **kw).shape == empty.shape
    assert elementwise_kernel.launches_recip == before
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_rsqrt_launch_plan_on_the_card(cuda_device):
    """Every gs_rsqrt_kernel and gs_recip_kernel instance fits on an SM, and
    a large call's grid is one wave of resident blocks on the card's SMs."""
    card_sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for op in elementwise_kernel.OPS:
        for is_bf16, vec in ((False, 4), (True, 8)):
            for width in (1, vec):
                sms, resident = elementwise_kernel.grid_limits(cuda_device, op, is_bf16, width)
                assert sms == card_sms and resident >= 1
                assert elementwise_kernel.grid_size(65536 * 128, width, sms,
                                                    resident) == sms * resident
