#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits nonzero before the last line:

1. Device: the card's name and power limit (``nvidia-smi``), TF32 off for
   matmuls and cuDNN, and the CUDA kernels built from ``csrc/`` with nvcc.
2. Kernels vs their plain PyTorch versions on the card: gs_rmsnorm at
   (rows, 2048), flash attention at (1, 32, S, 64) / (1, 4, S, 64), f32 and
   bf16, held to the reference's ERR_BOUNDS (f32 2^-15, bf16 2^-4).
3. Serve full-width tinyllama-1.1b (random weights from ``--seed``):
   ``Engine.run`` over 4 slots on 8 staggered requests (prompts 45..333
   tokens, 32 generated each) at float32, token for token against
   ``generate_sequential``; then the published dtype (bf16 activations,
   fp32 params) on the same trace, whose tokens must be valid.  Both runs
   must launch gs_rmsnorm 45 x (prefills + decode ticks) times and flash
   attention 22 x prefills times.
4. Timing at the main path's shapes: each kernel, its plain version and
   one PyTorch call computing the same function (``F.rms_norm`` x gain;
   ``F.scaled_dot_product_attention`` on heads expanded beforehand) as a
   yardstick the port never calls — per call from CUDA events over
   back-to-back calls (host launch cost included) and as device time from
   torch.profiler — beside the least time the card could take.
5. Where a serving run's time goes: wall vs device-busy time and the top
   kernels of one short request, from torch.profiler.

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
    calls launched; None when the profiler reports no device events."""
    fn()

    def calls():
        for _ in range(n):
            fn()

    _, events = profiled(calls)
    total_us = sum(e.time_range.elapsed_us() for e in events)
    return total_us / n / 1e3 if events else None


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


def serve_run(engine, reqs, n_layers: int):
    """One counted main-path run: counters zeroed just before, read just after."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    res = engine.run(reqs)
    counts = ops.launch_counts()
    m = res.metrics
    want = {"gs_rmsnorm": (2 * n_layers + 1) * (m.first_tokens + m.decode_ticks),
            "flash_attention": n_layers * m.first_tokens}
    print(f"  launches {counts}; expected {want} "
          f"({m.first_tokens} prefills, {m.decode_ticks} decode ticks)")
    if counts != want or min(counts.values()) == 0:
        fail(f"launch counts {counts} != {want}")
    return res, counts


def serve(seed: int):
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.serving import (FINISH_NUMERIC, Engine, EngineConfig, Request,
                                     generate_sequential)

    cfg = configs.get_config("tinyllama-1.1b", dtype="float32")
    s_max = max(PROMPTS) + GEN
    t0 = time.perf_counter()
    params = api.init(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
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
    return counts, serve_stats


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


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


def profile_serving(seed: int):
    """Where a serving run's time goes: one request (prompt 97, 9 tokens)
    through the f32 engine under the profiler — wall time, device busy
    time, kernel launches, and the kernels that take the most device time."""
    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.serving import Engine, EngineConfig, Request

    cfg = configs.get_config("tinyllama-1.1b", dtype="float32")
    params = api.init(cfg, seed=seed, device="cuda")
    engine = Engine(cfg, params, EngineConfig(n_slots=N_SLOTS, s_max=max(PROMPTS) + GEN))
    prompt = np.random.RandomState(seed).randint(0, cfg.vocab, (97,))
    for gen in (1, 9):  # gen 1: prefill alone; gen 9: prefill + 8 decode ticks
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
    del params, engine
    torch.cuda.empty_cache()


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

    print("== 3. serve full-width tinyllama-1.1b")
    counts, stats = serve(args.seed)

    print("== 4. timing at the main path's shapes")
    timing = time_kernels()

    print("== 5. where a serving run's time goes (profiler)")
    profile_serving(args.seed)

    picks = {"gs_rmsnorm": ("decode", "src/repro_torch/kernels/csrc/gs_rmsnorm.cu",
                            "src/repro/kernels/gs_rmsnorm.py:64"),
             "flash_attention": ("float32", "src/repro_torch/kernels/csrc/flash_attention.cu",
                                 "src/repro/kernels/flash_attention.py:142")}
    kernels = []
    for name, (label, source, replaces) in picks.items():
        r = timing[(name, label)]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": worst[name], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "device_ms": r["device_ms"][0], "shape": r["shape"]})
    print(f"  serving: {json.dumps(stats)}")
    print(f"  total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
