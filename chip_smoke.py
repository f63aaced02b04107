#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits nonzero before the last line:

1. Device: the card's name and power limit (``nvidia-smi``), TF32 off for
   matmuls and cuDNN, and the CUDA kernels built from ``csrc/`` with nvcc.
2. Kernels vs their plain PyTorch versions on the card: gs_rmsnorm at
   (rows, 2048), flash attention at (1, 32, S, 64) / (1, 4, S, 64), f32 and
   bf16, held to the reference's ERR_BOUNDS (f32 2^-15, bf16 2^-4); then at
   the training shapes: the forward's (m, l) residuals, and dq, dk, dv at
   (4, 32, S, 64) / (4, 4, S, 64), S 512 and 333, causal, f32 and bf16 (the
   ``flash_attention`` row, as max error over the plain version's largest
   element); gs_adam on a 1.1e6-element leaf and on one of 131 x 129
   elements (the ``gs_adam`` row, f32 2^-18).
3. Serve full-width tinyllama-1.1b (random weights from ``--seed``):
   ``Engine.run`` over 4 slots on 8 staggered requests (prompts 45..333
   tokens, 32 generated each) at float32, token for token against
   ``generate_sequential``; then the published dtype (bf16 activations,
   fp32 params) on the same trace, whose tokens must be valid.  Both runs
   must launch gs_rmsnorm 45 x (prefills + decode ticks) times and flash
   attention 22 x prefills times.
4. Timing at the main paths' shapes: each kernel, its plain version and
   one PyTorch call computing the same function (``F.rms_norm`` x gain;
   ``F.scaled_dot_product_attention`` on heads expanded beforehand, and its
   backward for dq and dk/dv; ``torch.optim.AdamW(fused=True).step()``) as
   a yardstick the port never calls — per call from CUDA events over
   back-to-back calls (host launch cost included) and as device time from
   torch.profiler — beside the least time the card could take.
5. Where a serving run's time goes: wall vs device-busy time and the top
   kernels of one short request, from torch.profiler.
6. Train: (a) one step of a 2-layer full-width tinyllama (batch 2, seq 128,
   f32) on the card through the kernels and on the CPU through the plain
   versions, from the same weights: loss within 1e-4 relative, m and v
   (the clipped gradients) leaf by leaf within 1e-3 of the largest
   element, the params too except where the clipped gradient is within
   10·eps of 0 (there the first Adam step g / (|g| + eps) is
   ill-conditioned, and the bound is lr/4); then the update alone, the
   CPU's clipped gradients through the card's AdamW (gs_adam) and the
   CPU's, params, m and v within gs_adam's 2^-18; (b) full-width
   22-layer tinyllama-1.1b, batch 4 x 512 tokens, f32, 10 steps of
   ``run_training`` with a checkpoint at step 5: finite, falling loss,
   exact launch counts, step time, tokens/s, peak memory and where one
   step's device time goes (torch.profiler); (c) the published dtype (bf16
   activations, f32 params), 3 steps, finite loss.
7. Serve full-width tinyllama-1.1b int8 (``quant="int8"``: int8 weights,
   int8 KV, every division site on the fixed-point datapath): (a) the
   three fixed kernels (gs_fixed_recip, gs_fixed_softmax,
   gs_fixed_rmsnorm) against their plain versions on the card, over the
   three formats of ``benchmarks/bench_kernels.py`` and both variants, at
   (256, 128), (37, 200) and, for the rmsnorm, (4, 2048) and (333, 2048):
   recip and rmsnorm bit-equal, all three within 2 x the format's error
   bound of an f64 oracle (the bench's gate); (b) a 2-layer full-width cut
   on the card and on the CPU, teacher-forced with the CPU's tokens through
   a prefill and 8 decode steps: logits within 2 x the int8 format's bound
   (2^-7) of the largest |logit| at every step; (c) ``Engine.run`` on phase
   3's trace: valid tokens, exact launch counts, resident int8 params below
   0.3 x the f32 tree, params + KV cache within 0.55 x the analytic bf16
   pair (``benchmarks/bench_serve.py``'s QUANT_BYTES_BUDGET), the same
   tokens on a second run; TTFT, tok/s, peak memory and the share of phase
   3's f32 tokens matched as a prefix (printed, not gated), and phase 5's
   profile of one request through the int8 engine; (d) the three
   kernels timed at the path's shapes beside their plain versions and a
   dequantize-then-library call (``F.rms_norm``, ``torch.reciprocal``,
   ``torch.softmax`` on ``x.float() * scale``).
8. The kernel benchmark's kernels (gs_recip, gs_rsqrt / gs_sqrt,
   gs_softmax), whose only caller is the kernel benchmark, in the reference
   too: (a) each against its plain version over the (dtype, p, iters,
   variant) grid of ``tests/test_torch_kernels.py`` and two f32 points,
   (8, 0) and (7, 1), where the Goldschmidt error shows: gs_recip and the
   three modes of gs_rsqrt bit-equal (any NaN matching any NaN) at
   (256, 128), (33, 517), (4096, 128) and on a row of specials, gs_softmax at
   (16, 384), (37, 200) and (8, 32000) within 2^-18 of the plain value (f32)
   or one ulp (bf16), every launch counted; (b) their VJPs through
   ``kernels.ops`` on the card against the same on the CPU; (c) gs_rmsnorm,
   flash_attention and gs_adam on the benchmark's own full-size inputs
   against their plain versions at phase 2's limits (gs_adam bit-equal), then
   the port's kernel benchmark (``repro_torch.benchmarks.bench_kernels.records``,
   full size) on the card: every row within its bound, every launch the
   benchmark's loop makes counted exactly; (d) the three kernels timed at
   the benchmark's shapes and at (4096, 128) / (8, 32000) beside their plain
   versions and ``torch.reciprocal`` / ``torch.rsqrt`` / ``torch.sqrt`` /
   ``torch.softmax``.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

ERR_BOUNDS = {"float32": 2.0**-15, "bfloat16": 2.0**-4}  # benchmarks/bench_kernels.py:149
NEAR_TIE = 1e-6  # top-2 probability gap below which a greedy flip is excused
# H100 SXM data-sheet peaks (dense): device memory and compute by input type
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PROMPTS = (97, 150, 333, 64, 211, 128, 45, 270)
ARRIVALS = (0.0, 0.0, 0.05, 0.1, 0.15, 0.2, 0.25, 0.3)
GEN = 32
N_SLOTS = 4


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int) -> float:
    """Median over 5 rounds of the mean time of ``n`` back-to-back calls,
    from CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(5):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        stop.synchronize()
        rounds.append(start.elapsed_time(stop) / n)
    return sorted(rounds)[2]


def profiled(fn):
    """Run ``fn`` under torch.profiler (CUPTI); return (wall ms, the CUDA
    device events) or (wall ms, []) when the profiler sees no device work."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    return wall, [e for e in prof.events() if e.device_type == cuda]


def device_ms(fn, n: int):
    """Device time per call: the summed duration of the CUDA work ``n``
    calls launched; None when the profiler reports no device events in
    three tries (a trace can come back empty)."""
    fn()

    def calls():
        for _ in range(n):
            fn()

    for _ in range(3):
        _, events = profiled(calls)
        if events:
            return sum(e.time_range.elapsed_us() for e in events) / n / 1e3
    return None


# -- phase 2 -------------------------------------------------------------------


def check_kernels():
    from repro_torch.kernels import flash_attention as flash_kernel
    from repro_torch.kernels import gs_rmsnorm as rms_kernel
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    worst = {"gs_rmsnorm": 0.0, "flash_attention": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        bound = ERR_BOUNDS[name]
        for rows in (4, 97, 333, 512):
            x = (3 * torch.randn(rows, 2048, generator=g, device=dev)).to(dtype)
            gain = 1 + 0.1 * torch.randn(2048, generator=g, device=dev)
            for p, iters in ((7, 2), (8, 0)):
                for variant in ("feedback", "pipelined"):
                    kw = dict(eps=1e-5, p=p, iters=iters, variant=variant)
                    err = (rms_kernel.gs_rmsnorm(x, gain, **kw).float()
                           - ref.rmsnorm(x, gain, **kw).float()).abs().max().item()
                    print(f"  gs_rmsnorm {name} ({rows}, 2048) p={p} iters={iters} "
                          f"{variant}: max|err| {err:.3e} (bound {bound:.3e})")
                    if not err <= bound:
                        fail(f"gs_rmsnorm {name} rows={rows} p={p} {variant}: {err}")
                    worst["gs_rmsnorm"] = max(worst["gs_rmsnorm"], err)
        p, iters = (7, 2) if dtype == torch.float32 else (8, 0)
        for s in (33, 97, 128, 333, 512):
            q = torch.randn(1, 32, s, 64, generator=g, device=dev).to(dtype)
            k, v = (torch.randn(1, 4, s, 64, generator=g, device=dev).to(dtype)
                    for _ in range(2))
            kw = dict(causal=True, p=p, iters=iters, variant="feedback")
            err = (flash_kernel.flash_attention(q, k, v, **kw).float()
                   - ref.attention(q, k, v, **kw).float()).abs().max().item()
            print(f"  flash_attention {name} (1, 32, {s}, 64) causal p={p} "
                  f"iters={iters}: max|err| {err:.3e} (bound {bound:.3e})")
            if not err <= bound:
                fail(f"flash_attention {name} S={s}: {err}")
            worst["flash_attention"] = max(worst["flash_attention"], err)
    torch.cuda.synchronize()
    return worst


def rel_err(got, want) -> float:
    """Max error over the plain version's largest element."""
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max()).item()


def check_training_kernels():
    """The backward and optimizer kernels at the training path's shapes;
    returns the worst max |error| of each kernel."""
    from repro_torch.kernels import flash_attention as flash_kernel
    from repro_torch.kernels import flash_attention_bwd as bwd_kernel
    from repro_torch.kernels import gs_adam as adam_kernel
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    worst = {"flash_attention_bwd_dq": 0.0, "flash_attention_bwd_dkv": 0.0, "gs_adam": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        bound = ERR_BOUNDS[name]
        p, iters = (7, 2) if dtype == torch.float32 else (8, 0)
        kw = dict(causal=True, p=p, iters=iters, variant="feedback")
        for s in (512, 333):
            q, do = (torch.randn(4, 32, s, 64, generator=g, device=dev).to(dtype)
                     for _ in range(2))
            k, v = (torch.randn(4, 4, s, 64, generator=g, device=dev).to(dtype)
                    for _ in range(2))
            out, m, l = flash_kernel.flash_attention(q, k, v, residuals=True, **kw)
            want_out, want_m, want_l = ref.attention(q, k, v, residuals=True, **kw)
            res_err = max(((m - want_m).abs() / want_m.abs().clamp_min(1.0)).max().item(),
                          ((l - want_l).abs() / want_l).max().item())
            out_err = (out.float() - want_out.float()).abs().max().item()
            want = ref.attention_bwd(q, k, v, do, out, m, l, **kw)
            got = bwd_kernel.flash_attention_bwd(q, k, v, do, out, m, l, **kw)
            errs = [rel_err(a, b) for a, b in zip(got, want)]
            abs_errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, want)]
            print(f"  flash residuals {name} (4, 32, {s}, 64): out max|err| {out_err:.3e}, "
                  f"m/l max rel err {res_err:.3e}; backward dq/dk/dv max err over the "
                  f"largest element {errs[0]:.3e} / {errs[1]:.3e} / {errs[2]:.3e} "
                  f"(bound {bound:.3e})")
            if not (out_err <= bound and res_err <= 1e-5 and max(errs) <= bound):
                fail(f"flash training kernels {name} S={s}: out {out_err}, m/l {res_err}, "
                     f"grads {errs}")
            worst["flash_attention_bwd_dq"] = max(worst["flash_attention_bwd_dq"], abs_errs[0])
            worst["flash_attention_bwd_dkv"] = max(worst["flash_attention_bwd_dkv"],
                                                   *abs_errs[1:])
    bound = 2.0**-18  # benchmarks/bench_kernels.py ERR_BOUNDS["gs_adam"], f32
    for n in (1_100_000, 131 * 129):
        w, grad = (torch.randn(n, generator=g, device=dev) for _ in range(2))
        m = 0.1 * torch.randn(n, generator=g, device=dev)
        v = 1e-2 * torch.rand(n, generator=g, device=dev)
        grad[::97] = 0.0
        v[::97] = 0.0
        for step in (1, 10):
            bc = ops.adam_scalars(step, 1e-3, beta1=0.9, beta2=0.95, device=dev)
            kw = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1, p=7, iters=2,
                      variant="feedback")
            got = adam_kernel.gs_adam_update(w, grad, m, v, bc, **kw)
            want = ref.adam_update(w, grad, m, v, bc, **kw)
            errs = [rel_err(a, b) for a, b in zip(got, want)]
            print(f"  gs_adam f32 ({n},) step {step}: p/m/v max err over the largest "
                  f"element {errs[0]:.3e} / {errs[1]:.3e} / {errs[2]:.3e} (bound {bound:.3e})")
            if not max(errs) <= bound:
                fail(f"gs_adam n={n} step={step}: {errs}")
            worst["gs_adam"] = max(worst["gs_adam"], *[(a - b).abs().max().item()
                                                       for a, b in zip(got, want)])
    torch.cuda.synchronize()
    return worst


# -- phase 3 -------------------------------------------------------------------


def trace(vocab: int, seed: int):
    from repro_torch.serving import Request

    rng = np.random.RandomState(seed)
    return [Request(rid=i, prompt=rng.randint(0, vocab, (s,)), max_new_tokens=GEN,
                    arrival_time=t) for i, (s, t) in enumerate(zip(PROMPTS, ARRIVALS))]


def top2_gap(cfg, params, prompt, prefix) -> float:
    """Top-2 probability gap of the greedy step after ``prompt + prefix``."""
    from repro_torch.models import api

    tokens = torch.as_tensor(list(prompt) + list(prefix), device="cuda")[None]
    with torch.no_grad():
        logits, _, _ = api.prefill(cfg, params, {"tokens": tokens})
        probs = cfg.policy().softmax(logits[0, -1].float())
    top = torch.topk(probs, 2).values
    return float(top[0] - top[1])


def serve_run(engine, reqs, n_layers: int, fixed: bool = False):
    """One counted main-path run: counters zeroed just before, read just
    after.  The float path runs gs_rmsnorm, the int8 path (``fixed``)
    gs_fixed_rmsnorm, at every norm."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    res = engine.run(reqs)
    counts = ops.launch_counts()
    m = res.metrics
    norm = "gs_fixed_rmsnorm" if fixed else "gs_rmsnorm"
    want = {name: 0 for name in counts}  # the training kernels, the other norm: none
    want.update({norm: (2 * n_layers + 1) * (m.first_tokens + m.decode_ticks),
                 "flash_attention": n_layers * m.first_tokens})
    print(f"  launches {counts}; expected {want} "
          f"({m.first_tokens} prefills, {m.decode_ticks} decode ticks)")
    if counts != want or min(counts[norm], counts["flash_attention"]) == 0:
        fail(f"launch counts {counts} != {want}")
    return res, counts


def serve(seed: int):
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.serving import (FINISH_NUMERIC, Engine, EngineConfig, Request,
                                     generate_sequential)
    from repro_torch.tree import tree_leaves

    cfg = configs.get_config("tinyllama-1.1b", dtype="float32")
    s_max = max(PROMPTS) + GEN
    t0 = time.perf_counter()
    params = api.init(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
          f"{n_params / 1e9:.3f} B f32 params initialised in "
          f"{time.perf_counter() - t0:.1f} s")
    reqs = trace(cfg.vocab, seed)

    t0 = time.perf_counter()
    seq = {r.rid: generate_sequential(cfg, params, r, s_max=s_max).tokens for r in reqs}
    print(f"  generate_sequential: {len(reqs)} requests in {time.perf_counter() - t0:.1f} s")

    engine = Engine(cfg, params, EngineConfig(n_slots=N_SLOTS, s_max=s_max))
    engine.run([Request(rid=0, prompt=reqs[0].prompt, max_new_tokens=2)])  # warm-up
    res, counts = serve_run(engine, reqs, cfg.n_layers)
    flips = []
    for r in reqs:
        got, want = res[r.rid].tokens, seq[r.rid]
        if np.array_equal(got, want):
            continue
        n = min(len(got), len(want))
        t = int(np.argmax(got[:n] != want[:n])) if np.any(got[:n] != want[:n]) else n
        gap = top2_gap(cfg, params, r.prompt, want[:t])
        print(f"  req {r.rid}: engine and sequential differ from step {t}, top-2 "
              f"probability gap {gap:.3e}")
        if not gap < NEAR_TIE:
            fail(f"req {r.rid}: engine tokens {got.tolist()} != sequential "
                 f"{want.tolist()} (gap {gap:.3e} is no near-tie)")
        flips.append((r.rid, t, gap))
    m = res.metrics
    ttft = sorted(m.ttft_s.values())
    print(f"  float32 Engine.run == generate_sequential on {len(reqs)} requests "
          f"({len(flips)} near-tie flips); TTFT median {np.median(ttft) * 1e3:.1f} ms "
          f"(max {ttft[-1] * 1e3:.1f} ms), decode {m.decode_tok_per_s:.1f} tok/s over "
          f"{m.decode_ticks} ticks, occupancy {m.occupancy:.2f}, makespan "
          f"{m.makespan_s:.2f} s")
    serve_stats = {"ttft_ms_median": float(np.median(ttft) * 1e3),
                   "decode_tok_per_s": m.decode_tok_per_s, "flips": flips}

    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    engine = Engine(bf16, params, EngineConfig(n_slots=N_SLOTS, s_max=s_max))
    res16, _ = serve_run(engine, reqs, cfg.n_layers)
    for r in reqs:
        tok = res16[r.rid].tokens
        if (res16[r.rid].finish_reason == FINISH_NUMERIC or len(tok) != GEN
                or tok.min() < 0 or tok.max() >= cfg.vocab):
            fail(f"bf16 req {r.rid}: {res16[r.rid].finish_reason} {tok.tolist()}")
    m16 = res16.metrics
    ttft16 = float(np.median(list(m16.ttft_s.values())) * 1e3)
    same = sum(int(np.array_equal(res16[r.rid].tokens, seq[r.rid])) for r in reqs)
    print(f"  bfloat16 Engine.run: {len(reqs)} requests, valid tokens, {same} of "
          f"{len(reqs)} equal to float32; TTFT median {ttft16:.1f} ms, decode "
          f"{m16.decode_tok_per_s:.1f} tok/s")
    serve_stats["bf16"] = {"ttft_ms_median": ttft16, "decode_tok_per_s": m16.decode_tok_per_s}
    del params, engine
    torch.cuda.empty_cache()
    return counts, serve_stats, seq


# -- phase 4 -------------------------------------------------------------------


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_kernels():
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as flash_kernel
    from repro_torch.kernels import gs_rmsnorm as rms_kernel
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    rows = {}
    d = 2048
    gain = 1 + 0.1 * torch.randn(d, generator=g, device=dev)
    for label, n_rows in (("decode", N_SLOTS), ("prefill", max(PROMPTS))):
        x = torch.randn(n_rows, d, generator=g, device=dev)
        kw = dict(eps=1e-5, p=7, iters=2, variant="feedback")
        t = cuda_ms(lambda: rms_kernel.gs_rmsnorm(x, gain, **kw), 200)
        t_plain = cuda_ms(lambda: ref.rmsnorm(x, gain, **kw), 20)
        t_lib = cuda_ms(lambda: F.rms_norm(x, (d,), weight=gain, eps=1e-5), 200)
        dev_ms = [device_ms(f, 50) for f in (
            lambda: rms_kernel.gs_rmsnorm(x, gain, **kw), lambda: ref.rmsnorm(x, gain, **kw),
            lambda: F.rms_norm(x, (d,), weight=gain, eps=1e-5))]
        b, by = bound_ms(n_rows * d * 8 + 4 * d, 4 * n_rows * d, "float32")
        rows[("gs_rmsnorm", label)] = dict(ms=t, plain_ms=t_plain, library_ms=t_lib,
                                           bound_ms=b, bound_by=by, device_ms=dev_ms,
                                           shape=f"({n_rows}, {d}) float32")
    s, h, kh, hd = max(PROMPTS), 32, 4, 64
    for name, dtype, (p, iters) in (("float32", torch.float32, (7, 2)),
                                    ("bfloat16", torch.bfloat16, (8, 0))):
        q = torch.randn(1, h, s, hd, generator=g, device=dev).to(dtype)
        k, v = (torch.randn(1, kh, s, hd, generator=g, device=dev).to(dtype)
                for _ in range(2))
        kw = dict(causal=True, p=p, iters=iters, variant="feedback")
        t = cuda_ms(lambda: flash_kernel.flash_attention(q, k, v, **kw), 50)
        t_plain = cuda_ms(lambda: ref.attention(q, k, v, **kw), 10)
        ke, ve = k.repeat_interleave(h // kh, dim=1), v.repeat_interleave(h // kh, dim=1)
        t_lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True), 50)
        dev_ms = [device_ms(f, 20) for f in (
            lambda: flash_kernel.flash_attention(q, k, v, **kw),
            lambda: ref.attention(q, k, v, **kw),
            lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True))]
        pairs = s * (s + 1) // 2  # causal (query, key) pairs this input needs
        elt = q.element_size()
        b, by = bound_ms((2 * h + 2 * kh) * s * hd * elt, 4 * h * hd * pairs, name)
        rows[("flash_attention", name)] = dict(ms=t, plain_ms=t_plain, library_ms=t_lib,
                                               bound_ms=b, bound_by=by, device_ms=dev_ms,
                                               shape=f"(1, {h}, {s}, {hd}) {name}")
    us = lambda v: "not measured" if v is None else f"{v * 1e3:.1f} us"  # noqa: E731
    for (kname, label), r in rows.items():
        print(f"  {kname} {label} {r['shape']}: per call (CUDA events, back to back) "
              f"kernel {us(r['ms'])}, plain {us(r['plain_ms'])}, library "
              f"{us(r['library_ms'])}; device time (profiler) kernel "
              f"{us(r['device_ms'][0])}, plain {us(r['device_ms'][1])}, library "
              f"{us(r['device_ms'][2])}; bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")
    return rows


def time_training_kernels():
    """The training path's kernels at its full-width shapes: the flash
    backward at (4, 32, 512, 64) / (4, 4, 512, 64) f32, causal, and gs_adam
    on the embedding leaf (32000 x 2048)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as flash_kernel
    from repro_torch.kernels import flash_attention_bwd as bwd_kernel
    from repro_torch.kernels import gs_adam as adam_kernel
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    rows = {}
    b, h, kh, s, hd = 4, 32, 4, 512, 64
    q, do = (torch.randn(b, h, s, hd, generator=g, device=dev) for _ in range(2))
    k, v = (torch.randn(b, kh, s, hd, generator=g, device=dev) for _ in range(2))
    kw = dict(causal=True, sm_scale=hd**-0.5, p=7, iters=2, variant="feedback")
    out, m, l = flash_kernel.flash_attention(q, k, v, residuals=True, **kw)
    delta = torch.sum(do * out, dim=-1)
    dq_call = lambda: bwd_kernel.dq(q, k, v, do, m, l, delta, **kw)  # noqa: E731
    dkv_call = lambda: bwd_kernel.dkv(q, k, v, do, m, l, delta, **kw)  # noqa: E731
    plain = lambda: ref.attention_bwd(q, k, v, do, out, m, l, **kw)  # noqa: E731
    qe = q.clone().requires_grad_()
    ke = k.repeat_interleave(h // kh, dim=1).requires_grad_()
    ve = v.repeat_interleave(h // kh, dim=1).requires_grad_()
    sdpa_out = F.scaled_dot_product_attention(qe, ke, ve, is_causal=True)
    lib = lambda: torch.autograd.grad(sdpa_out, (qe, ke, ve), do, retain_graph=True)  # noqa: E731
    fwd = lambda: flash_kernel.flash_attention(q, k, v, residuals=True, **kw)  # noqa: E731
    t = {name: cuda_ms(fn, n) for name, fn, n in (
        ("dq", dq_call, 10), ("dkv", dkv_call, 10), ("plain", plain, 3), ("lib", lib, 10),
        ("fwd", fwd, 10))}
    dev_ms = {name: device_ms(fn, 5) for name, fn in (
        ("dq", dq_call), ("dkv", dkv_call), ("plain", plain), ("lib", lib), ("fwd", fwd))}
    pairs = s * (s + 1) // 2  # causal (query, key) pairs this input needs
    mm = 2 * b * h * hd * pairs  # flops of one S x S x D product over these pairs
    elt = 4
    in_bytes = (2 * b * h + 2 * b * kh) * s * hd * elt + 3 * b * h * s * 4
    for name, n_mm, out_bytes in (("dq", 3, b * h * s * hd * elt),
                                  ("dkv", 4, 2 * b * h * s * hd * 4)):
        bound, by = bound_ms(in_bytes + out_bytes, n_mm * mm, "float32")
        rows[("flash_attention_bwd_" + name, "float32")] = dict(
            ms=t[name], plain_ms=t["plain"], library_ms=t["lib"], bound_ms=bound,
            bound_by=by, device_ms=[dev_ms[name], dev_ms["plain"], dev_ms["lib"]],
            shape=f"({b}, {h}, {s}, {hd}) float32 causal")
    pair_bound, _ = bound_ms(in_bytes + 3 * b * h * s * hd * 4, 5 * mm, "float32")
    us = lambda x: "not measured" if x is None else f"{x * 1e3:.1f} us"  # noqa: E731
    print(f"  flash forward with residuals ({b}, {h}, {s}, {hd}) f32: {us(t['fwd'])} per "
          f"call, device time {us(dev_ms['fwd'])}")
    print(f"  flash backward pair (dq + dk/dv) {(t['dq'] + t['dkv']) * 1e3:.1f} us against "
          f"the pair's bound {pair_bound * 1e3:.2f} us (2.5x the forward's matmul flops); "
          f"SDPA backward {t['lib'] * 1e3:.1f} us (it computes dq, dk and dv in one call)")

    n = 32000 * 2048
    w, grad = (torch.randn(n, generator=g, device=dev) for _ in range(2))
    m0 = 0.1 * torch.randn(n, generator=g, device=dev)
    v0 = 1e-2 * torch.rand(n, generator=g, device=dev)
    bc = ops.adam_scalars(3, 1e-3, beta1=0.9, beta2=0.95, device=dev)
    akw = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1, p=7, iters=2,
               variant="feedback")
    kern = lambda: adam_kernel.gs_adam_update(w, grad, m0, v0, bc, **akw)  # noqa: E731
    plain = lambda: ref.adam_update(w, grad, m0, v0, bc, **akw)  # noqa: E731
    leaf = torch.nn.Parameter(w.clone())
    leaf.grad = grad.clone()
    opt = torch.optim.AdamW([leaf], lr=1e-3, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1,
                            fused=True)
    lib = opt.step
    t = [cuda_ms(kern, 10), cuda_ms(plain, 2), cuda_ms(lib, 10)]
    dev_t = [device_ms(fn, 5) for fn in (kern, plain, lib)]
    bound, by = bound_ms(28 * n, 30 * n, "float32")
    rows[("gs_adam", "float32")] = dict(ms=t[0], plain_ms=t[1], library_ms=t[2],
                                        bound_ms=bound, bound_by=by, device_ms=dev_t,
                                        shape=f"({n},) float32")
    for (kname, label), r in rows.items():
        print(f"  {kname} {r['shape']}: per call (CUDA events, back to back) kernel "
              f"{us(r['ms'])}, plain {us(r['plain_ms'])}, library {us(r['library_ms'])}; "
              f"device time (profiler) kernel {us(r['device_ms'][0])}, plain "
              f"{us(r['device_ms'][1])}, library {us(r['device_ms'][2])}; bound "
              f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")
    del q, k, v, do, out, w, grad, m0, v0, leaf, opt
    torch.cuda.empty_cache()
    return rows


def profile_engine(engine, prompt) -> None:
    """One request through ``engine`` under the profiler, for prefill alone
    (gen 1) and prefill + 8 decode ticks (gen 9): wall time, device busy
    time, device events, and the kernels that take the most device time."""
    from repro_torch.serving import Request

    for gen in (1, 9):
        req = Request(rid=0, prompt=prompt, max_new_tokens=gen)
        engine.run([req])  # warm
        wall, events = profiled(lambda: engine.run([req]))
        if not events:
            print(f"  gen {gen}: wall {wall:.1f} ms; device time not measured "
                  "(the profiler saw no CUDA events)")
            continue
        busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
        by_name = {}
        for e in events:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        print(f"  gen {gen}: wall {wall:.1f} ms, device busy {busy:.1f} ms "
              f"({100 * busy / wall:.1f}%), {len(events)} device events")
        for name, ms in top:
            print(f"    {ms:8.2f} ms  {name[:110]}")


def profile_serving(seed: int):
    """Where a serving run's time goes: one request (prompt 97, 9 tokens)
    through the f32 engine under the profiler."""
    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.serving import Engine, EngineConfig

    cfg = configs.get_config("tinyllama-1.1b", dtype="float32")
    params = api.init(cfg, seed=seed, device="cuda")
    engine = Engine(cfg, params, EngineConfig(n_slots=N_SLOTS, s_max=max(PROMPTS) + GEN))
    profile_engine(engine, np.random.RandomState(seed).randint(0, cfg.vocab, (97,)))
    del params, engine
    torch.cuda.empty_cache()


# -- phase 6 -------------------------------------------------------------------


def train_args(**over):
    """Parsed ``repro_torch.launch.train`` arguments for full-width tinyllama."""
    from repro_torch.launch import train

    argv = ["--arch", "tinyllama-1.1b", "--device", "cuda", "--log-every", "1"]
    for key, val in over.items():
        argv += [f"--{key.replace('_', '-')}", str(val)]
    return train.parser().parse_args(argv)


def check_train_step_against_cpu(seed: int):
    """(a) one step of a 2-layer full-width tinyllama on the card (kernels)
    and on the CPU (plain versions) from the same weights and batch."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data.synthetic import SyntheticLM, make_batch
    from repro_torch.launch.steps import TrainHParams, lr_at, make_train_step
    from repro_torch.models import api
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.optim.adamw import clip_by_global_norm
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    cfg = dataclasses.replace(configs.get_config("tinyllama-1.1b", dtype="float32"),
                              n_layers=2)
    hp = TrainHParams(peak_lr=1e-3, warmup=0, total=10)  # warmup 0: step 0 moves
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=128, global_batch=2, seed=seed)
    host = api.init(cfg, seed=seed, device="cpu")
    out = {}
    for dev in ("cuda", "cpu"):
        params = tree_map(lambda t: t.to(dev), host)
        t0 = time.perf_counter()
        out[dev] = make_train_step(cfg, hp)(params, adamw_init(params),
                                            make_batch(ds, 0, dev))
        loss = out[dev][2]["loss"].item()
        print(f"  2-layer step on {dev}: loss {loss:.6f}, grad norm "
              f"{out[dev][2]['grad_norm'].item():.6f}, {time.perf_counter() - t0:.1f} s")
    (p_gpu, o_gpu, m_gpu), (p_cpu, o_cpu, m_cpu) = out["cuda"], out["cpu"]
    loss_err = abs(m_gpu["loss"].item() - m_cpu["loss"].item()) / abs(m_cpu["loss"].item())
    # m = (1-b1)·g and v = (1-b2)·g² after one step from zeros: they hold the
    # clipped gradients themselves, leaf by leaf
    mv_err = max(rel_err(a.cpu(), b) for a, b in zip(
        tree_leaves((o_gpu["m"], o_gpu["v"])), tree_leaves((o_cpu["m"], o_cpu["v"]))))
    # the first AdamW step is u = g / (|g| + eps): where the clipped gradient
    # is nonzero but within 10·eps of 0, u is a ratio of two near-zero
    # numbers, and the last-ulp differences of two summation orders move it
    # (8.6e-5 at most with seed 0 on an H100); there the bound is lr/4,
    # elsewhere 1e-3 of the leaf's largest element
    near_bound = hp.peak_lr / 4
    near_zero, p_err, p_err_near = 0, 0.0, 0.0
    for a, b, m in zip(tree_leaves(p_gpu), tree_leaves(p_cpu), tree_leaves(o_cpu["m"])):
        d = (a.cpu() - b).abs()
        ill = (m.abs() < (1 - hp.beta1) * 10 * 1e-8) & (m != 0)  # exact 0: no update
        near_zero += int(ill.sum())
        p_err = max(p_err, (torch.where(ill, 0.0, d).max() / b.abs().max()).item())
        p_err_near = max(p_err_near, d[ill].max().item() if ill.any() else 0.0)
    moved = max((a.cpu() - b).abs().max().item()
                for a, b in zip(tree_leaves(p_gpu), tree_leaves(host)))
    n = sum(t.numel() for t in tree_leaves(host))
    print(f"  card vs CPU: loss rel err {loss_err:.3e} (bound 1e-4); m, v (the clipped "
          f"gradients) worst leaf err over its largest element {mv_err:.3e} (bound 1e-3); "
          f"params worst leaf err over its largest element {p_err:.3e} (bound 1e-3) on "
          f"{n - near_zero} of {n} elements; on the {near_zero} whose clipped gradient is "
          f"nonzero and within 10·eps of 0, max |err| {p_err_near:.3e} (bound lr/4 = "
          f"{near_bound:.1e}); the step moved a param by up to {moved:.3e}")
    if not (loss_err <= 1e-4 and mv_err <= 1e-3 and p_err <= 1e-3
            and p_err_near <= near_bound and moved > 0):
        fail(f"2-layer train step: loss err {loss_err}, m/v err {mv_err}, param err {p_err} "
             f"/ {p_err_near} near zero, moved {moved}")
    del out, p_gpu, o_gpu, m_gpu
    torch.cuda.empty_cache()

    # the update alone on the same inputs, the ill-conditioned elements
    # included: the CPU's clipped gradients of this batch through the card's
    # adamw_update (the gs_adam kernel, once per leaf) and the CPU's (its
    # plain version), held to gs_adam's bound
    policy = cfg.optimizer_policy()
    live = tree_map(lambda t: t.detach().requires_grad_(), host)
    grads = torch.autograd.grad(api.loss_fn(cfg, live, make_batch(ds, 0, "cpu")),
                                tree_leaves(live))
    clipped, _ = clip_by_global_norm(tree_unflatten(host, list(grads)), hp.clip_norm, policy)
    del live, grads
    upd = {}
    for dev in ("cuda", "cpu"):
        params = tree_map(lambda t: t.to(dev), host)
        state = adamw_init(params)
        new_p, new_o, _ = adamw_update(
            params, tree_map(lambda t: t.to(dev), clipped), state, lr=lr_at(hp, state["step"]),
            policy=policy, beta1=hp.beta1, beta2=hp.beta2, weight_decay=hp.weight_decay,
            clip_norm=None)
        upd[dev] = tree_leaves((new_p, new_o["m"], new_o["v"]))
    upd_err = max(rel_err(a.cpu(), b) for a, b in zip(upd["cuda"], upd["cpu"]))
    near_abs = 0.0
    for a, b, g in zip(upd["cuda"], upd["cpu"], tree_leaves(clipped)):  # the params
        ill = (g.abs() < 10 * 1e-8) & (g != 0)
        if ill.any():
            near_abs = max(near_abs, (a.cpu() - b).abs()[ill].max().item())
    print(f"  AdamW alone on the CPU's clipped gradients, card vs CPU: params, m, v worst "
          f"leaf err over its largest element {upd_err:.3e} (bound 2^-18 = {2.0**-18:.3e}); "
          f"on the params whose clipped gradient is nonzero and within 10·eps of 0, "
          f"max |err| {near_abs:.3e}")
    if not upd_err <= 2.0**-18:
        fail(f"2-layer AdamW update on the same gradients: err {upd_err}")
    del upd, clipped, host
    torch.cuda.empty_cache()


def step_breakdown(events, wall_ms: float):
    """Device time of one step by kernel family, and the top kernels."""
    families = (("flash bwd dq", "flash_bwd_dq"), ("flash bwd dk/dv", "flash_bwd_dkv"),
                ("flash fwd", "flash_fwd"), ("gs_adam", "gs_adam"),
                ("gs_rmsnorm", "gs_rmsnorm"), ("matmul (cuBLAS)", "gemm"))
    by_family, by_name = {}, {}
    for e in events:
        ms = e.time_range.elapsed_us() / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
        fam = next((f for f, key in families if key in e.name), "other")
        by_family[fam] = by_family.get(fam, 0.0) + ms
    busy = sum(by_family.values())
    print(f"  one step under the profiler: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall_ms:.1f}%), {len(events)} device events")
    for fam, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"    {ms:9.2f} ms  {100 * ms / busy:5.1f}%  {fam}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {ms:9.2f} ms  {name[:110]}")
    return busy, by_family


def train_full(seed: int, dtype: str, steps: int, ckpt_every: int):
    """(b)/(c): ``run_training`` on full-width tinyllama-1.1b, batch 4 x 512;
    the launch counters zeroed just before and read just after."""
    import shutil

    from repro_torch.checkpoint import latest_step
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.runtime.driver import run_training
    from repro_torch.tree import tree_leaves

    ckpt_dir = ROOT / "build" / f"chip_smoke_ckpt_{dtype}"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    args = train_args(steps=steps, batch=4, seq=512, dtype=dtype, seed=seed,
                      ckpt_every=ckpt_every, ckpt_dir=ckpt_dir)
    cfg, kw = train.build(args)
    make_step_fn, step_ms = kw["make_step_fn"], []

    def timed_step_fn():
        fn = make_step_fn()

        def step(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        return step

    kw["make_step_fn"] = timed_step_fn
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    stats = run_training(**kw)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [stats["losses"][i] for i in range(steps)]
    n_leaves = len(tree_leaves(stats["state"].params))
    want = {name: 0 for name in counts}  # the int8 kernels: none
    want.update({"gs_rmsnorm": (2 * cfg.n_layers + 1) * steps,
                 "flash_attention": cfg.n_layers * steps,
                 "flash_attention_bwd_dq": cfg.n_layers * steps,
                 "flash_attention_bwd_dkv": cfg.n_layers * steps, "gs_adam": n_leaves * steps})
    med = float(np.median(step_ms[1:])) if len(step_ms) > 1 else step_ms[0]
    tokens = args.batch * args.seq
    print(f"  {dtype}: {cfg.n_layers} layers, {n_leaves} parameter leaves, {steps} steps in "
          f"{wall:.1f} s (checkpoints included); losses {[round(x, 4) for x in losses]}")
    print(f"  step time: first {step_ms[0]:.1f} ms, median of the rest {med:.1f} ms "
          f"-> {tokens / med * 1e3:.0f} tokens/s; peak device memory {peak_gb:.2f} GB")
    print(f"  launches {counts}; expected {want}")
    if not all(np.isfinite(losses)):
        fail(f"{dtype} training: non-finite loss {losses}")
    if counts != want:
        fail(f"{dtype} training launch counts {counts} != {want}")
    last = latest_step(str(ckpt_dir))
    with open(ckpt_dir / f"step_{last:08d}" / "manifest.json") as f:
        manifest = json.load(f)
    print(f"  final checkpoint: step {manifest['step']}, {len(manifest['leaves'])} leaves in "
          f"the reference's layout (e.g. {sorted(manifest['leaves'])[0]})")
    if manifest["step"] != steps or "opt_state__step" not in manifest["leaves"]:
        fail(f"{dtype} training: final checkpoint {manifest['step']} is not step {steps}")
    result = dict(losses=losses, step_ms=step_ms, median_step_ms=med,
                  tokens_per_s=tokens / med * 1e3, peak_gb=peak_gb, counts=counts)
    if dtype == "float32":
        if not np.mean(losses[-3:]) < np.mean(losses[:3]):
            fail(f"float32 training: loss did not fall {losses}")
        state = stats["state"]
        step = kw["make_step_fn"]()
        batch = kw["make_batch"](steps)
        step(state.params, state.opt_state, batch)  # warm
        wall_ms, events = profiled(lambda: step(state.params, state.opt_state, batch))
        if events:
            result["busy_ms"], result["by_family"] = step_breakdown(events, wall_ms)
            result["profiled_wall_ms"] = wall_ms
        else:
            print(f"  one step: wall {wall_ms:.1f} ms; device time not measured "
                  "(the profiler saw no CUDA events)")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    del stats
    torch.cuda.empty_cache()
    return result


# -- phase 7 -------------------------------------------------------------------

FIXED_MARGIN = 2.0  # benchmarks/bench_kernels.py: each int8 row's gate is 2 x its bound
QUANT_BYTES_BUDGET = 0.55  # benchmarks/bench_serve.py: int8 params + cache vs bf16
FIXED_KERNELS = ("gs_fixed_recip", "gs_fixed_softmax", "gs_fixed_rmsnorm")
# gs_fixed_softmax vs its plain version, elementwise relative.  The two sum
# the row in different orders, at most d·2^-24 relative apart (1.2e-5 at
# d = 200), and share every other step; a neighbouring ROM word or a wrong
# reciprocal moves a row by 2^-p (>= 2^-8) or more.  2^-12 lies between.
SOFTMAX_PLAIN_RTOL = 2.0 ** -12


def fixed_formats():
    """benchmarks/bench_kernels.py's three formats: the int8 default
    (frac 24, seed-only), a wide register, and a Mitchell first pass."""
    from repro_torch.core import formats

    return (("frac24", formats.format_for("int8")), ("frac30", formats.NumericFormat.fixed(30)),
            ("mitchell", formats.NumericFormat.fixed(24, p=7, mitchell_iters=1)))


def fixed_oracle_errors(x: np.ndarray, scale: float, gain: np.ndarray, outs):
    """bench_kernels.py's errors against an f64 oracle: recip relative,
    softmax absolute, rmsnorm over the largest element (eps 1e-6)."""
    xf = x.astype(np.float64) * scale
    e = np.exp(xf - xf.max(-1, keepdims=True))
    rn = xf / np.sqrt(np.mean(xf * xf, axis=-1, keepdims=True) + 1e-6) * gain
    recip, softmax, rmsnorm = (o.double().cpu().numpy() for o in outs)
    return {"gs_fixed_recip": float(np.max(np.abs(recip - 1.0 / xf) * np.abs(xf))),
            "gs_fixed_softmax": float(np.max(np.abs(softmax - e / e.sum(-1, keepdims=True)))),
            "gs_fixed_rmsnorm": float(np.max(np.abs(rmsnorm - rn)) / np.max(np.abs(rn)))}


def check_fixed_kernels():
    """(a) each kernel against its plain version and the f64 oracle; returns
    the worst |kernel - plain| of each.  recip and rmsnorm must be
    bit-equal, softmax within SOFTMAX_PLAIN_RTOL of the plain value."""
    from repro_torch.kernels import gs_fixed as fixed_kernel
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    worst = {name: 0.0 for name in FIXED_KERNELS}
    shapes = (((256, 128), FIXED_KERNELS), ((37, 200), FIXED_KERNELS),
              ((4, 2048), ("gs_fixed_rmsnorm",)), ((333, 2048), ("gs_fixed_rmsnorm",)))
    for i, (shape, names) in enumerate(shapes):
        rng = np.random.RandomState(7 + i)  # bench_kernels.py's case at i = 0
        x_np = rng.randint(-127, 128, shape).astype(np.int8)
        x_np[x_np == 0] = 1
        gain_np = rng.randn(shape[-1]).astype(np.float32)
        x, gain = torch.from_numpy(x_np).to(dev), torch.from_numpy(gain_np).to(dev)
        with_zeros = x.clone()
        with_zeros.view(-1)[::17] = 0  # recip's +inf lanes, bit-equal too
        scale = torch.tensor(0.02, device=dev)
        for fname, fmt in fixed_formats():
            bound = FIXED_MARGIN * fmt.error_bound()
            for variant in ("feedback", "pipelined"):
                kw = dict(fmt.precision(), variant=variant)
                rkw = dict(eps=1e-6, p=fmt.p, frac_bits=fmt.frac_bits, iters=fmt.iters)
                got = {"gs_fixed_recip": fixed_kernel.gs_fixed_recip(x, scale, **kw),
                       "gs_fixed_softmax": fixed_kernel.gs_fixed_softmax(x, scale, **kw),
                       "gs_fixed_rmsnorm": fixed_kernel.gs_fixed_rmsnorm(x, scale, gain, **rkw)}
                want = {"gs_fixed_recip": ref.fixed_recip(x, scale, **kw),
                        "gs_fixed_softmax": ref.fixed_softmax(x, scale, **kw),
                        "gs_fixed_rmsnorm": ref.fixed_rmsnorm(x, scale, gain, **rkw)}
                oracle = fixed_oracle_errors(x_np, 0.02, gain_np, [got[n] for n in FIXED_KERNELS])
                zeros_equal = torch.equal(fixed_kernel.gs_fixed_recip(with_zeros, scale, **kw),
                                          ref.fixed_recip(with_zeros, scale, **kw))
                errs = {n: (got[n] - want[n]).abs().max().item() for n in names}
                rel = ""
                if "gs_fixed_softmax" in names:
                    sm_rel = ((got["gs_fixed_softmax"] - want["gs_fixed_softmax"]).abs()
                              / want["gs_fixed_softmax"]).max().item()
                    rel = f" (softmax relative {sm_rel:.3e}, limit {SOFTMAX_PLAIN_RTOL:.3e})"
                    if not sm_rel <= SOFTMAX_PLAIN_RTOL:
                        fail(f"gs_fixed_softmax {shape} {fname} {variant}: |kernel - plain| "
                             f"/ plain {sm_rel:.3e} > {SOFTMAX_PLAIN_RTOL:.3e}")
                print(f"  {shape} {fname} {variant}: max|kernel - plain| "
                      + ", ".join(f"{n} {errs[n]:.3e}" for n in names) + rel
                      + "; vs the f64 oracle "
                      + ", ".join(f"{n} {oracle[n]:.3e}" for n in names)
                      + f" (bound {bound:.3e})")
                for n in names:
                    worst[n] = max(worst[n], errs[n])
                    if not oracle[n] <= bound:
                        fail(f"{n} {shape} {fname} {variant}: oracle error {oracle[n]} > {bound}")
                exact = [n for n in names if n != "gs_fixed_softmax"]
                if any(errs[n] != 0.0 for n in exact) or (
                        "gs_fixed_recip" in names and not zeros_equal):
                    fail(f"{shape} {fname} {variant}: recip/rmsnorm not bit-equal to the "
                         f"plain version: {errs}, zeros equal {zeros_equal}")
    torch.cuda.synchronize()
    return worst


def int8_card_vs_cpu(seed: int, steps: int = 8, prompt_len: int = 97):
    """(b) a 2-layer full-width int8 cut, teacher-forced: the same prompt and
    the CPU's greedy tokens through both devices."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.layers.quant import quantize_params
    from repro_torch.models import api
    from repro_torch.serving import SlotCachePool
    from repro_torch.serving.sampler import sample_greedy
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(configs.get_config("tinyllama-1.1b", dtype="float32"),
                              n_layers=2, quant="int8")
    host = api.init(cfg, seed=seed, device="cpu")
    prompt = np.random.RandomState(seed).randint(0, cfg.vocab, (prompt_len,))
    policy = cfg.policy()
    logits, tokens = {}, []  # tokens: the CPU's greedy choices, fed to both
    for dev in ("cpu", "cuda"):
        params = quantize_params(tree_map(lambda t: t.to(dev), host))
        prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
        lg, states, _ = prefill(params, {"tokens": torch.as_tensor(prompt[None], device=dev)})
        cache = SlotCachePool.grow(cfg, states, prompt_len + steps, torch.float32, dev)
        logits[dev] = [lg[0, -1].cpu()]
        for i in range(steps):
            if dev == "cpu":
                tokens.append(int(sample_greedy(logits["cpu"][i][None], policy=policy)[0]))
            lg, cache = decode(params, cache, torch.tensor([prompt_len + i], device=dev),
                               {"token": torch.tensor([[tokens[i]]], device=dev)})
            logits[dev].append(lg[0, -1].cpu())
        del params, cache
    bound = FIXED_MARGIN * policy.fmt.error_bound()
    worst = 0.0
    for i, (a, b) in enumerate(zip(logits["cuda"], logits["cpu"])):
        err = ((a - b).abs().max() / b.abs().max()).item()
        worst = max(worst, err)
        if not err <= bound:
            fail(f"int8 card vs CPU, step {i}: logits differ by {err:.3e} of the largest "
                 f"(bound {bound:.3e})")
    print(f"  2-layer full-width int8, prompt {prompt_len}, prefill + {steps} teacher-forced "
          f"decode steps: card vs CPU logits worst max|diff| / max|logit| {worst:.3e} "
          f"(bound 2 x 2^-{policy.fmt.certified_bits()} = {bound:.3e})")
    del host
    return worst


def serve_int8(seed: int, seq_f32):
    """(c) the full-width int8 engine on phase 3's trace."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.layers.quant import tree_bytes
    from repro_torch.models import api
    from repro_torch.serving import FINISH_NUMERIC, Engine, EngineConfig, Request

    cfg = configs.get_config("tinyllama-1.1b", dtype="float32")
    cfg_q = dataclasses.replace(cfg, quant="int8")
    s_max = max(PROMPTS) + GEN
    params = api.init(cfg, seed=seed, device="cuda")
    f32_bytes = tree_bytes(params)
    reqs = trace(cfg.vocab, seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine = Engine(cfg_q, params, EngineConfig(n_slots=N_SLOTS, s_max=s_max))
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    del params  # the engine holds only the int8 tree
    torch.cuda.empty_cache()
    q_bytes = tree_bytes(engine.params)
    engine.run([Request(rid=0, prompt=reqs[0].prompt, max_new_tokens=2)])  # warm-up
    torch.cuda.reset_peak_memory_stats()
    res, counts = serve_run(engine, reqs, cfg.n_layers, fixed=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for r in reqs:
        tok = res[r.rid].tokens
        if (res[r.rid].finish_reason == FINISH_NUMERIC or len(tok) != GEN
                or tok.min() < 0 or tok.max() >= cfg.vocab):
            fail(f"int8 req {r.rid}: {res[r.rid].finish_reason} {tok.tolist()}")
    again = engine.run(reqs)
    if not all(np.array_equal(again[r.rid].tokens, res[r.rid].tokens) for r in reqs):
        fail("int8 engine: a second run of the same trace gave other tokens")
    m = res.metrics
    cache_f32 = m.cache_bytes * 4  # the same pool with f32 K/V
    bf16_baseline = (f32_bytes + cache_f32) / 2.0
    ratio_params = q_bytes / f32_bytes
    ratio_budget = (q_bytes + m.cache_bytes) / bf16_baseline
    matched = 0
    for r in reqs:
        got, want = res[r.rid].tokens, seq_f32[r.rid]
        n = min(len(got), len(want))
        diff = np.nonzero(got[:n] != want[:n])[0]
        matched += int(diff[0]) if diff.size else n
    share = matched / sum(len(t) for t in seq_f32.values())
    ttft = sorted(m.ttft_s.values())
    print(f"  int8 Engine.run: {len(reqs)} requests, {GEN} valid tokens each, the same on a "
          f"second run; quantized in {t_quant:.2f} s; resident params {q_bytes / 1e9:.3f} GB "
          f"= {ratio_params:.4f} of the f32 tree's {f32_bytes / 1e9:.3f} GB (gate < 0.3); "
          f"params + int8 KV cache {(q_bytes + m.cache_bytes) / 1e9:.3f} GB = "
          f"{ratio_budget:.4f} of the analytic bf16 pair {bf16_baseline / 1e9:.3f} GB "
          f"(gate <= {QUANT_BYTES_BUDGET})")
    print(f"  int8 TTFT median {np.median(ttft) * 1e3:.1f} ms (max {ttft[-1] * 1e3:.1f} ms), "
          f"decode {m.decode_tok_per_s:.1f} tok/s over {m.decode_ticks} ticks, peak device "
          f"memory {peak_gb:.2f} GB; {share:.4f} of phase 3's f32 sequential tokens matched "
          f"as a prefix ({matched} of {sum(len(t) for t in seq_f32.values())}; printed, not "
          f"gated: with random weights the top-2 gaps lie far below int8's 2^-8)")
    if not ratio_params < 0.3:
        fail(f"int8 resident params {ratio_params:.4f} of f32, gate < 0.3")
    if not ratio_budget <= QUANT_BYTES_BUDGET:
        fail(f"int8 params + cache {ratio_budget:.4f} of the bf16 pair, gate "
             f"<= {QUANT_BYTES_BUDGET}")
    print("  where an int8 serving run's time goes (profiler, prompt 97):")
    profile_engine(engine, np.random.RandomState(seed).randint(0, cfg.vocab, (97,)))
    stats = {"ttft_ms_median": float(np.median(ttft) * 1e3),
             "decode_tok_per_s": m.decode_tok_per_s, "peak_gb": peak_gb,
             "param_bytes": q_bytes, "f32_param_bytes": f32_bytes,
             "cache_bytes": m.cache_bytes, "params_ratio": ratio_params,
             "bytes_vs_bf16": ratio_budget, "f32_prefix_share": share}
    del engine
    torch.cuda.empty_cache()
    return counts, stats


def time_fixed_kernels():
    """(d) the three kernels at the path's shapes."""
    import torch.nn.functional as F

    from repro_torch.core import formats
    from repro_torch.kernels import gs_fixed as fixed_kernel
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    kw = dict(formats.format_for("int8").precision(), variant="feedback")
    rkw = dict(eps=1e-5, p=kw["p"], frac_bits=kw["frac_bits"], iters=kw["iters"])
    scale = torch.tensor(0.02, device=dev)
    rows = {}
    cases = [("gs_fixed_rmsnorm", (N_SLOTS, 2048), "decode"),
             ("gs_fixed_rmsnorm", (max(PROMPTS), 2048), "prefill"),
             ("gs_fixed_rmsnorm", (256, 128), "bench"), ("gs_fixed_recip", (256, 128), "bench"),
             ("gs_fixed_softmax", (256, 128), "bench")]
    for name, shape, label in cases:
        x = torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
        gain = 1 + 0.1 * torch.randn(shape[-1], generator=g, device=dev)
        n = x.numel()
        if name == "gs_fixed_rmsnorm":
            kern = lambda: fixed_kernel.gs_fixed_rmsnorm(x, scale, gain, **rkw)  # noqa: E731
            plain = lambda: ref.fixed_rmsnorm(x, scale, gain, **rkw)  # noqa: E731
            lib = lambda: F.rms_norm(x.float() * scale, (shape[-1],), weight=gain,  # noqa: E731
                                     eps=1e-5)
            nbytes, flops = n * (1 + 4) + 4 * shape[-1], 5 * n
        elif name == "gs_fixed_recip":
            kern = lambda: fixed_kernel.gs_fixed_recip(x, scale, **kw)  # noqa: E731
            plain = lambda: ref.fixed_recip(x, scale, **kw)  # noqa: E731
            lib = lambda: torch.reciprocal(x.float() * scale)  # noqa: E731
            nbytes, flops = n * (1 + 4), 3 * n
        else:
            kern = lambda: fixed_kernel.gs_fixed_softmax(x, scale, **kw)  # noqa: E731
            plain = lambda: ref.fixed_softmax(x, scale, **kw)  # noqa: E731
            lib = lambda: torch.softmax(x.float() * scale, dim=-1)  # noqa: E731
            nbytes, flops = n * (1 + 4), 6 * n
        b, by = bound_ms(nbytes, flops, "float32")
        rows[(name, label)] = dict(
            ms=cuda_ms(kern, 200), plain_ms=cuda_ms(plain, 20), library_ms=cuda_ms(lib, 200),
            bound_ms=b, bound_by=by, device_ms=[device_ms(f, 50) for f in (kern, plain, lib)],
            shape=f"{shape} int8")
    us = lambda v: "not measured" if v is None else f"{v * 1e3:.1f} us"  # noqa: E731
    for (kname, label), r in rows.items():
        print(f"  {kname} {label} {r['shape']}: per call (CUDA events, back to back) kernel "
              f"{us(r['ms'])}, plain {us(r['plain_ms'])}, dequant + library {us(r['library_ms'])}; "
              f"device time (profiler) kernel {us(r['device_ms'][0])}, plain "
              f"{us(r['device_ms'][1])}, dequant + library {us(r['device_ms'][2])}; bound "
              f"{r['bound_ms'] * 1e3:.3f} us ({r['bound_by']})")
    return rows


# -- phase 8 -------------------------------------------------------------------

# the (dtype, p, iters, variant) grid of tests/test_torch_kernels.py, and two
# f32 points whose Goldschmidt error (2^-9 seed-only, 2^-14 after one pass)
# stands far above f32 roundoff, so that an exact 1/sum in gs_softmax fails
ELEMENTWISE_PRECISIONS = (("float32", 7, 2, "feedback"), ("float32", 12, 1, "pipelined"),
                          ("bfloat16", 8, 0, "feedback"), ("bfloat16", 8, 0, "pipelined"),
                          ("float32", 8, 0, "feedback"), ("float32", 7, 1, "pipelined"))
# ±0, the smallest subnormal, ±inf, NaN, -2, the largest and smallest normal
SPECIALS = [0.0, -0.0, 1e-45, float("inf"), float("-inf"), float("nan"), -2.0,
            3.4028234663852886e38, 1.1754943508222875e-38]
# gs_softmax vs its plain version, elementwise relative at f32: expf and the
# row sum's order differ by ulps (4.8e-7 at most on the H100, 8 times less
# than this limit); an exact 1/sum instead of the Goldschmidt one moves a
# row by the datapath's error, 2^-9 at (8, 0) and 2^-14 at (7, 1).
SOFTMAX_F32_RTOL = 2.0 ** -18
BENCH_KERNELS = ("gs_recip", "gs_rsqrt", "gs_softmax")


def bit_equal(a, b) -> bool:
    """Equal dtype, shape and bit patterns, any NaN matching any NaN."""
    ints = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    same = (a.view(ints) == b.view(ints)) | (torch.isnan(a) & torch.isnan(b))
    return a.dtype == b.dtype and a.shape == b.shape and bool(same.all())


def max_abs_diff(a, b) -> float:
    """max |a - b| over the elements where both are finite."""
    fin = torch.isfinite(a) & torch.isfinite(b)
    return (a.float() - b.float()).abs()[fin].max().item() if fin.any() else 0.0


def check_bench_kernels():
    """(a) gs_recip and gs_rsqrt's three modes bit-equal to their plain
    versions, gs_softmax within SOFTMAX_F32_RTOL (f32) or one ulp (bf16);
    returns the worst |kernel - plain| of each."""
    from repro_torch.kernels import gs_elementwise as elementwise_kernel
    from repro_torch.kernels import gs_softmax as softmax_kernel
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    r = np.random.RandomState(8)
    xs = []
    for shape in ((256, 128), (33, 517), (4096, 128)):
        mag = np.exp2(r.uniform(-60, 60, shape)) * (1 + r.rand(*shape))
        xs.append(torch.from_numpy(mag * np.where(r.rand(*shape) < 0.5, -1, 1)).float().to(dev))
    xs.append(torch.tensor(SPECIALS, device=dev))
    rows = [torch.from_numpy(4 * r.randn(*shape)).float().to(dev)
            for shape in ((16, 384), (37, 200), (8, 32000))]
    worst = {name: 0.0 for name in BENCH_KERNELS}
    calls = {name: 0 for name in BENCH_KERNELS}
    ops.reset_launch_counts()
    for dname, p, iters, variant in ELEMENTWISE_PRECISIONS:
        dtype = getattr(torch, dname)
        kw = dict(p=p, iters=iters, variant=variant)
        for x32 in xs:
            x = x32.to(dtype)
            pairs = [("gs_recip", "recip", elementwise_kernel.gs_recip(x, **kw),
                      ref.reciprocal(x, **kw))]
            for mode in ("rsqrt", "sqrt"):
                pairs.append(("gs_rsqrt", mode, elementwise_kernel.gs_rsqrt(x, mode=mode, **kw),
                              ref.rsqrt(x, mode=mode, **kw)))
            got = elementwise_kernel.gs_rsqrt(x, mode="sqrt_both", **kw)
            want = ref.rsqrt(x, mode="sqrt_both", **kw)
            pairs += [("gs_rsqrt", "sqrt_both: sqrt", got[0], want[0]),
                      ("gs_rsqrt", "sqrt_both: rsqrt", got[1], want[1])]
            calls["gs_recip"] += 1
            calls["gs_rsqrt"] += 3
            for name, what, a, b in pairs:
                if not bit_equal(a, b):
                    fail(f"{what} {dname} {tuple(x.shape)} p={p} iters={iters} {variant}: "
                         f"not bit-equal to the plain version (max |diff| "
                         f"{max_abs_diff(a, b):.3e}, NaN classes equal "
                         f"{bool((torch.isnan(a) == torch.isnan(b)).all())})")
                worst[name] = max(worst[name], max_abs_diff(a, b))
        print(f"  {dname} p={p} iters={iters} {variant}: gs_recip, gs_rsqrt (rsqrt, sqrt, "
              f"sqrt_both) bit-equal to the plain versions at (256, 128), (33, 517), "
              f"(4096, 128) and the {len(SPECIALS)} specials")
        for x32 in rows:
            x = x32.to(dtype)
            got, want = softmax_kernel.gs_softmax(x, **kw), ref.softmax(x, **kw)
            calls["gs_softmax"] += 1
            if dtype == torch.float32:
                pos = want > 0
                err = ((got - want).abs()[pos] / want[pos]).max().item()
                ok = bool(((got - want).abs() <= SOFTMAX_F32_RTOL * want).all())
                limit = f"relative, limit {SOFTMAX_F32_RTOL:.3e}"
            else:
                err = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs().max().item()
                ok = err <= 1
                limit = "ulps, limit 1"
            print(f"    gs_softmax {tuple(x.shape)}: max |kernel - plain| "
                  f"{max_abs_diff(got, want):.3e}, {err:.3e} {limit}")
            if not ok or got.dtype != dtype:
                fail(f"gs_softmax {dname} {tuple(x.shape)} p={p} {variant}: {err} ({limit})")
            worst["gs_softmax"] = max(worst["gs_softmax"], max_abs_diff(got, want))
    counts = ops.launch_counts()
    if {name: counts[name] for name in BENCH_KERNELS} != calls:
        fail(f"8a launches {counts} != the calls made {calls}")
    print(f"  launches {calls}, as many as the calls made")
    torch.cuda.synchronize()
    return worst


def check_bench_vjps():
    """(b) torch.autograd.grad through ops.gs_recip/rsqrt/sqrt/softmax on
    the card against the CPU: within 2^-18 (f32) or 2^-7 (bf16) of the
    largest element; the softmax's at least 2^-12, as its forward."""
    from repro_torch.kernels import ops

    r = np.random.RandomState(9)
    for dtype, bound in ((torch.float32, 2.0**-18), (torch.bfloat16, 2.0**-7)):
        pos = torch.from_numpy(r.uniform(0.05, 20.0, (256, 128))).float().to(dtype)
        rows = torch.from_numpy(4 * r.randn(16, 384)).float().to(dtype)
        errs = {}
        for name, op, x, tol in (("gs_recip", ops.gs_recip, pos, bound),
                                 ("gs_rsqrt", ops.gs_rsqrt, pos, bound),
                                 ("gs_sqrt", ops.gs_sqrt, pos, bound),
                                 ("gs_softmax", ops.gs_softmax, rows, max(bound, 2.0**-12))):
            cot = torch.from_numpy(r.randn(*x.shape)).float().to(dtype)
            grads = []
            for dev in ("cuda", "cpu"):
                xd = x.to(dev).requires_grad_()
                (gd,) = torch.autograd.grad(op(xd), xd, cot.to(dev))
                grads.append(gd.float().cpu())
            errs[name] = ((grads[0] - grads[1]).abs().max() / grads[1].abs().max()).item()
            if not errs[name] <= tol:
                fail(f"{name} VJP {dtype}: card vs CPU {errs[name]:.3e} > {tol:.3e}")
        print(f"  {str(dtype).split('.')[-1]} VJPs, card vs CPU, max err over the largest "
              "element: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (bound {bound:.3e}, softmax {max(bound, 2.0**-12):.3e})")


def check_bench_shapes():
    """(c) before the benchmark: the kernels of its float rows that phase 2
    holds at other shapes (gs_rmsnorm, flash_attention, gs_adam), on the
    benchmark's own full-size numpy draws, at f32 and bf16 (gs_adam at f32,
    the one dtype the benchmark and the kernel take) under both policies and
    both variants, against their plain versions at phase 2's limits
    (gs_adam bit-equal); returns the worst |kernel - plain| of each."""
    from repro_torch.benchmarks import bench_kernels
    from repro_torch.core.goldschmidt import DEFAULT_P, precision_policy
    from repro_torch.kernels import flash_attention as flash_kernel
    from repro_torch.kernels import gs_adam as adam_kernel
    from repro_torch.kernels import gs_rmsnorm as rms_kernel
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    args_np = {case[0]: case[1] for case in bench_kernels._bench_cases(smoke=False)}
    worst = {"gs_rmsnorm": 0.0, "flash_attention": 0.0, "gs_adam": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        bound = ERR_BOUNDS[name]
        nx, ng = (torch.from_numpy(a).to(dtype).to(dev) for a in args_np["gs_rmsnorm"])
        gain = ng.float()  # the benchmark widens a bf16 gain exactly
        q, k, v = (torch.from_numpy(a).to(dtype).to(dev) for a in args_np["flash_attention"])
        # the seed policy and the dtype's (one point at f32)
        for p, iters in dict.fromkeys(((DEFAULT_P, 2), precision_policy(dtype))):
            for variant in ("feedback", "pipelined"):
                kw = dict(p=p, iters=iters, variant=variant)
                pairs = [("gs_rmsnorm", tuple(nx.shape),
                          rms_kernel.gs_rmsnorm(nx, gain, eps=1e-6, **kw),
                          ref.rmsnorm(nx, gain, eps=1e-6, **kw)),
                         ("flash_attention", tuple(q.shape),
                          flash_kernel.flash_attention(q, k, v, causal=True, **kw),
                          ref.attention(q, k, v, causal=True, **kw))]
                for kname, shape, got, want in pairs:
                    err = (got.float() - want.float()).abs().max().item()
                    print(f"  {kname} {name} {shape} p={p} iters={iters} {variant}: "
                          f"max |kernel - plain| {err:.3e} (bound {bound:.3e})")
                    if not (err <= bound and got.dtype == dtype):
                        fail(f"{kname} {name} {shape} p={p} {variant} at the benchmark's "
                             f"shape: {err}")
                    worst[kname] = max(worst[kname], err)
    w, g, m, v = (torch.from_numpy(a).to(dev) for a in args_np["gs_adam"])
    bc = ops.adam_scalars(1, 1e-3, beta1=0.9, beta2=0.999, device=dev)
    for p, iters in dict.fromkeys(((DEFAULT_P, 2), precision_policy(torch.float32))):
        for variant in ("feedback", "pipelined"):
            kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0, p=p, iters=iters,
                      variant=variant)
            got = adam_kernel.gs_adam_update(w, g, m, v, bc, **kw)
            want = ref.adam_update(w, g, m, v, bc, **kw)
            if not all(bit_equal(a, b) for a, b in zip(got, want)):
                fail(f"gs_adam ({w.numel()},) p={p} iters={iters} {variant}: p/m/v not "
                     f"bit-equal to the plain version, max |diff| "
                     f"{[max_abs_diff(a, b) for a, b in zip(got, want)]}")
            worst["gs_adam"] = max(worst["gs_adam"], *[max_abs_diff(a, b)
                                                       for a, b in zip(got, want)])
    print(f"  gs_adam float32 ({w.numel()},) step 1: p, m, v bit-equal to the plain version "
          f"at p={DEFAULT_P} iters=2 (both policies at f32), both variants")
    torch.cuda.synchronize()
    return worst


def run_bench():
    """(c) the port's kernel benchmark at full size on the card: every row
    within its bound; the launch counters zeroed just before and read just
    after must equal the launches its loop makes."""
    from repro_torch.benchmarks import bench_kernels
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    recs = bench_kernels.records(smoke=False, device="cuda")
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    for r in recs:
        cfg = r["config"]
        pi = f"p={cfg['p']}/i={cfg['iters']}" if cfg else "-"
        print(f"  {r['kernel']} {r['dtype']} {r['impl']} {r['policy']} {pi}: "
              f"{r['us_per_call']} us per call, max_err {r['max_err']:.3e} "
              f"(bound {r['err_bound']:.3e}) ok={r['ok']}")
    bad = [r for r in recs if not r["ok"]]
    if bad:
        fail(f"kernel benchmark rows over their bound: {bad}")
    launched = bench_kernels.expected_launches(recs, smoke=False)
    want = {name: launched.get(name, 0) for name in counts}
    print(f"  {len(recs)} rows in {wall:.1f} s, all within bound; launches {counts}; expected "
          f"{want} ({bench_kernels.calls_per_row(False)} calls per kernel row)")
    if counts != want or min(counts[name] for name in BENCH_KERNELS) == 0:
        fail(f"kernel benchmark launch counts {counts} != {want}")
    return counts


def time_bench_kernels():
    """(d) the three kernels on positive f32 inputs (the benchmark's draw),
    p 7, iters 2, feedback."""
    from repro_torch.kernels import gs_elementwise as elementwise_kernel
    from repro_torch.kernels import gs_softmax as softmax_kernel
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    kw = dict(p=7, iters=2, variant="feedback")
    rows = {}
    cases = [("gs_recip", "recip", (256, 128), "bench"), ("gs_recip", "recip", (4096, 128), "large"),
             ("gs_rsqrt", "rsqrt", (256, 128), "bench"), ("gs_rsqrt", "rsqrt", (4096, 128), "large"),
             ("gs_rsqrt", "sqrt", (256, 128), "bench sqrt"),
             ("gs_rsqrt", "sqrt", (4096, 128), "large sqrt"),
             ("gs_softmax", "softmax", (16, 384), "bench"),
             ("gs_softmax", "softmax", (8, 32000), "large")]
    for name, fn, shape, label in cases:
        n = shape[0] * shape[1]
        if fn == "softmax":
            x = 4 * torch.randn(shape, generator=g, device=dev)
            kern = lambda: softmax_kernel.gs_softmax(x, **kw)  # noqa: E731
            plain = lambda: ref.softmax(x, **kw)  # noqa: E731
            lib = lambda: torch.softmax(x, dim=-1)  # noqa: E731
            flops = 7 * n  # max, two subtracts, two exps, an add and a multiply
        else:
            x = torch.randn(shape, generator=g, device=dev).abs() + 0.1
            if fn == "recip":
                kern = lambda: elementwise_kernel.gs_recip(x, **kw)  # noqa: E731
                plain = lambda: ref.reciprocal(x, **kw)  # noqa: E731
                lib = lambda: torch.reciprocal(x)  # noqa: E731
                flops = (2 + 3 * kw["iters"]) * n
            else:
                kern = lambda: elementwise_kernel.gs_rsqrt(x, mode=fn, **kw)  # noqa: E731
                plain = lambda: ref.rsqrt(x, mode=fn, **kw)  # noqa: E731
                lib = (lambda: torch.rsqrt(x)) if fn == "rsqrt" else (lambda: torch.sqrt(x))
                flops = (4 + 6 * kw["iters"]) * n
        b, by = bound_ms(8 * n, flops, "float32")  # read 4 bytes and write 4 per element
        rows[(name, label)] = dict(
            ms=cuda_ms(kern, 200), plain_ms=cuda_ms(plain, 20), library_ms=cuda_ms(lib, 200),
            bound_ms=b, bound_by=by, device_ms=[device_ms(f, 50) for f in (kern, plain, lib)],
            shape=f"{shape} float32" + (" sqrt" if fn == "sqrt" else ""))
    us = lambda v: "not measured" if v is None else f"{v * 1e3:.2f} us"  # noqa: E731
    for (kname, label), r in rows.items():
        print(f"  {kname} {label} {r['shape']}: per call (CUDA events, back to back) kernel "
              f"{us(r['ms'])}, plain {us(r['plain_ms'])}, library {us(r['library_ms'])}; "
              f"device time (profiler) kernel {us(r['device_ms'][0])}, plain "
              f"{us(r['device_ms'][1])}, library {us(r['device_ms'][2])}; bound "
              f"{r['bound_ms'] * 1e3:.3f} us ({r['bound_by']})")
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from the repository")
    sys.path.insert(0, str(SRC))
    if not torch.cuda.is_available():
        fail("torch finds no CUDA device")
    t_start = time.perf_counter()

    print("== 1. device")
    smi = nvidia_smi_line()
    print(smi)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s): {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}, torch.backends.cudnn.allow_tf32 = "
          f"{torch.backends.cudnn.allow_tf32}")
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    lib = build.build()
    build.load()
    print(f"  built {lib.name} from {[s.name for s in build.sources()]} in "
          f"{time.perf_counter() - t0:.1f} s")
    log = build.BUILD_DIR / "build.log"
    for line in (log.read_text().splitlines() if log.exists() else []):
        if "registers" in line or "spill" in line:
            print("   ", line.strip())

    print("== 2. kernels vs plain versions")
    worst = check_kernels()
    worst.update(check_training_kernels())

    print("== 3. serve full-width tinyllama-1.1b")
    counts, stats, seq_f32 = serve(args.seed)

    print("== 4. timing at the main paths' shapes")
    timing = time_kernels()
    timing.update(time_training_kernels())

    print("== 5. where a serving run's time goes (profiler)")
    profile_serving(args.seed)

    print("== 6. train full-width tinyllama-1.1b")
    check_train_step_against_cpu(args.seed)
    train32 = train_full(args.seed, "float32", steps=10, ckpt_every=5)
    train16 = train_full(args.seed, "bfloat16", steps=3, ckpt_every=5)

    print("== 7. serve full-width tinyllama-1.1b int8")
    worst.update(check_fixed_kernels())
    int8_card_vs_cpu(args.seed)
    counts_int8, stats["int8"] = serve_int8(args.seed, seq_f32)
    timing.update(time_fixed_kernels())

    print("== 8. the kernel benchmark's kernels: gs_recip, gs_rsqrt / gs_sqrt, gs_softmax")
    t8 = time.perf_counter()
    worst.update(check_bench_kernels())
    check_bench_vjps()
    for name, err in check_bench_shapes().items():
        worst[name] = max(worst[name], err)
    counts_bench = run_bench()
    timing.update(time_bench_kernels())
    print(f"  phase 8 took {time.perf_counter() - t8:.1f} s")

    picks = {"gs_rmsnorm": ("decode", "gs_rmsnorm.cu", "gs_rmsnorm.py:64"),
             "flash_attention": ("float32", "flash_attention.cu", "flash_attention.py:142"),
             "flash_attention_bwd_dq": ("float32", "flash_attention_bwd.cu",
                                        "flash_attention.py:311"),
             "flash_attention_bwd_dkv": ("float32", "flash_attention_bwd.cu",
                                         "flash_attention.py:338"),
             "gs_adam": ("float32", "gs_adam.cu", "gs_adam.py:114"),
             "gs_fixed_recip": ("bench", "gs_fixed.cu", "gs_fixed.py:135"),
             "gs_fixed_softmax": ("bench", "gs_fixed.cu", "gs_fixed.py:205"),
             "gs_fixed_rmsnorm": ("decode", "gs_fixed.cu", "gs_fixed.py:282"),
             "gs_recip": ("bench", "gs_elementwise.cu", "gs_recip.py:72"),
             "gs_rsqrt": ("bench", "gs_elementwise.cu", "gs_rsqrt.py:78"),
             "gs_softmax": ("bench", "gs_softmax.cu", "gs_softmax.py:55")}
    kernels = []
    for name, (label, source, replaces) in picks.items():
        r = timing[(name, label)]
        if name in BENCH_KERNELS:  # launches from phase 8c, the kernel benchmark
            launches = counts_bench[name]
        elif name in FIXED_KERNELS:  # launches from phase 7c, the int8 path
            launches = counts_int8[name]
        elif name in ("gs_rmsnorm", "flash_attention"):
            launches = counts[name]
        else:
            launches = train32["counts"][name]
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{source}",
               "replaces": f"src/repro/kernels/{replaces}", "launches": launches,
               "max_abs_err": worst[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
               "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
               "library_ms": r["library_ms"], "device_ms": r["device_ms"][0],
               "shape": r["shape"], "launches_serve_f32": counts[name],
               "launches_train_f32": train32["counts"][name],
               "launches_int8_serve": counts_int8[name], "launches_bench": counts_bench[name]}
        if name in ("gs_fixed_recip", "gs_fixed_softmax"):
            row["note"] = ("not on a model path of the reference either: only 7a and 7d "
                           "launch it; library_ms is a dequantize plus one call")
        elif name == "gs_fixed_rmsnorm":
            row["note"] = "library_ms is a dequantize plus F.rms_norm"
        elif name in BENCH_KERNELS:
            row["note"] = ("not on a model path of the reference either: launches are the "
                           "kernel benchmark's (8c)")
        kernels.append(row)
    train_stats = {k: {key: v[key] for key in ("median_step_ms", "tokens_per_s", "peak_gb",
                                                "losses")}
                   for k, v in (("float32", train32), ("bfloat16", train16))}
    train_stats["float32"]["busy_ms"] = train32.get("busy_ms")
    train_stats["float32"]["profiled_wall_ms"] = train32.get("profiled_wall_ms")
    print(f"  training: {json.dumps(train_stats)}")
    print(f"  serving: {json.dumps(stats)}")
    print(f"  total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
