"""Kernel validation sweep and timing (counterpart of
``benchmarks/bench_kernels.py``).

:func:`records` gives the rows of ``BENCH_kernels_torch.json`` (``python -m
repro_torch.benchmarks.run --smoke``): per kernel × dtype × precision
policy (``seed`` = the fixed (7, 2) literals, ``dtype`` = the
``precision_policy`` pair) the kernel's µs per call and its max error
against an exact oracle, beside the error bound of the reference's rows;
then one row per kernel and dtype for the Goldschmidt path in tensor ops
(the reference's ``jnp`` rows), and the int8 rows of the fixed-point
kernels under three formats.  The inputs are the reference's own numpy
draws (``RandomState(42)`` and ``RandomState(7)``, in its order, at its
smoke and full sizes), so the two sweeps see equal inputs.

``impl`` says what ran: ``cuda`` (the hand-written kernel on the card),
``plain`` (its plain PyTorch version, on a CPU tensor) or ``torch`` (the
tensor-op path).  On the card a call is timed with CUDA events around it,
host launch cost included; on the CPU with the host clock.  Each row runs
its function once for the error, then ``WARMUP`` calls and ``repeats``
timed calls, and reports the median.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import formats
from repro_torch.core import goldschmidt as gs
from repro_torch.core.goldschmidt import DEFAULT_P, precision_policy, target_bits_for
from repro_torch.core.policy import GS_FEEDBACK
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.layers.attention import flash_chunked

# Max-err bound per (kernel, dtype), the reference's: ~4x the measured
# seed-state error rounded up to a power of two.  recip/rsqrt are relative
# errors; the fused kernels are absolute against an exact oracle.
ERR_BOUNDS = {
    ("gs_recip", "float32"): 2.0 ** -20,
    ("gs_recip", "bfloat16"): 2.0 ** -7,
    ("gs_rsqrt", "float32"): 2.0 ** -20,
    ("gs_rsqrt", "bfloat16"): 2.0 ** -7,
    ("gs_softmax", "float32"): 2.0 ** -18,
    ("gs_softmax", "bfloat16"): 2.0 ** -6,
    ("gs_rmsnorm", "float32"): 2.0 ** -15,
    ("gs_rmsnorm", "bfloat16"): 2.0 ** -4,
    ("flash_attention", "float32"): 2.0 ** -15,
    ("flash_attention", "bfloat16"): 2.0 ** -4,
    ("gs_adam", "float32"): 2.0 ** -18,
}

# Each int8 row is gated by its own format's certified bound x2, as in the
# reference: the fused kernels add an int8 normalize and an exponent unfold
# around the certified divide.
FIXED_MARGIN = 2.0

WARMUP = 1  # untimed calls before the timed ones


def repeats_for(smoke: bool) -> int:
    return 1 if smoke else 5


def calls_per_row(smoke: bool) -> int:
    """Calls of a row's function: one for the error, then the timing's."""
    return 1 + WARMUP + repeats_for(smoke)


def time_call(fn, device: torch.device, repeats: int) -> float:
    """Median µs of one call of ``fn`` over ``repeats`` calls after
    ``WARMUP`` untimed ones: CUDA events around each call on the card (the
    host's launch cost included), the host clock on the CPU."""
    for _ in range(WARMUP):
        fn()
    ts = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            ts.append(start.elapsed_time(stop) * 1e3)
    else:
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(ts))


def _np32(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def _impl(device: torch.device) -> str:
    return "cuda" if device.type == "cuda" else "plain"


# -- the Goldschmidt path in tensor ops: the reference's jnp rows ----------------
# Each pins the (7, 2) seed literals, as the reference's ref.reciprocal /
# rsqrt / softmax / rmsnorm / adam_update do; the chunked flash derives its
# epilogue's precision from the f32 row sums.


def _torch_recip(x):
    return gs.gs_reciprocal(x, p=DEFAULT_P, iters=2)


def _torch_rsqrt(x):
    return gs.gs_rsqrt(x, p=DEFAULT_P, iters=2)


def _torch_softmax(x):
    m = torch.amax(x, dim=-1, keepdim=True)
    e = torch.exp(x.to(torch.float32) - m.to(torch.float32))
    s = torch.sum(e, dim=-1, keepdim=True)
    return (e * gs.gs_reciprocal(s, p=DEFAULT_P, iters=2)).to(x.dtype)


def _torch_rmsnorm(x, gain, eps=1e-6):
    x32 = x.to(torch.float32)
    ms = torch.mean(x32 * x32, dim=-1, keepdim=True)
    inv = gs.gs_rsqrt(ms + eps, p=DEFAULT_P, iters=2)
    return (x32 * inv * gain.to(torch.float32)).to(x.dtype)


def _torch_adam(param, grad, m, v, *, lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                weight_decay=0.0, step=1):
    """The reference's jnp AdamW step: a Goldschmidt sqrt and reciprocal for
    the denominator; returns the new param."""
    g32 = grad.to(torch.float32)
    m_new = beta1 * m + (1.0 - beta1) * g32
    v_new = beta2 * v + (1.0 - beta2) * g32 * g32
    bc1 = 1.0 / (1.0 - beta1**step)
    bc2 = 1.0 / (1.0 - beta2**step)
    denom = gs.gs_sqrt(v_new * bc2, p=DEFAULT_P, iters=2) + eps
    update = (m_new * bc1) * gs.gs_reciprocal(denom, p=DEFAULT_P, iters=2)
    w = param.to(torch.float32)
    return (w - lr * (update + weight_decay * w)).to(param.dtype)


def _flash_chunked_gs(q, k, v):
    """The flash rows' tensor-op path: the chunked online-softmax with the
    Goldschmidt epilogue (a real GS path, not the exact oracle)."""
    def t(a):
        return a.transpose(1, 2)

    return t(flash_chunked(t(q), t(k), t(v), policy=GS_FEEDBACK, causal=True,
                           q_block=64, kv_block=64))


def _kernel_adam(p_, g_, m_, v_, **cfg):
    bc = ops.adam_scalars(1, 1e-3, beta1=0.9, beta2=0.999, device=p_.device)
    return ops.gs_adam_update(p_, g_, m_, v_, bc, **cfg)[0]


def _bench_cases(smoke: bool):
    """(kernel, numpy args, kernel fn, tensor-op fn, err fn) per kernel."""
    r = np.random.RandomState(42)
    s = 128 if smoke else 256

    def cpu(args):
        return [a.cpu() for a in args]

    pos = np.abs(r.randn(s, 128)).astype(np.float32) + 0.1
    sm = (r.randn(16, 384) * 4).astype(np.float32)
    nx = r.randn(32, 512).astype(np.float32)
    ng = r.randn(512).astype(np.float32)
    q = r.randn(1, 4, s, 64).astype(np.float32)
    kv = r.randn(1, 2, s, 64).astype(np.float32)
    ap = r.randn(2048).astype(np.float32)
    ag = r.randn(2048).astype(np.float32)
    az = np.zeros(2048, np.float32)

    return [
        ("gs_recip", (pos,), ops.gs_recip, _torch_recip,
         lambda got, args: np.abs(_np32(got) * _np32(args[0]) - 1.0).max()),
        ("gs_rsqrt", (pos,), ops.gs_rsqrt, _torch_rsqrt,
         lambda got, args: np.abs(
             _np32(got) * np.sqrt(_np32(args[0]).astype(np.float64)) - 1.0).max()),
        ("gs_softmax", (sm,), ops.gs_softmax, _torch_softmax,
         lambda got, args: np.abs(
             _np32(got) - _np32(ref.softmax_exact(args[0].cpu()))).max()),
        # the kernel takes an f32 gain: a bf16 row's gain is widened exactly
        ("gs_rmsnorm", (nx, ng),
         lambda x, g, **kw: ops.gs_rmsnorm(x, g.to(torch.float32), **kw), _torch_rmsnorm,
         lambda got, args: np.abs(
             _np32(got) - _np32(ref.rmsnorm_exact(*cpu(args)))).max()),
        ("flash_attention", (q, kv, kv), ops.flash_attention, _flash_chunked_gs,
         lambda got, args: np.abs(
             _np32(got) - _np32(ref.attention_exact(*cpu(args), causal=True))).max()),
        ("gs_adam", (ap, ag, az, np.abs(az)), _kernel_adam, _torch_adam,
         lambda got, args: np.abs(
             _np32(got) - _np32(ref.adam_update_exact(*cpu(args), lr=1e-3, step=1)[0])).max()),
    ]


# -- fixed-point int8 rows --------------------------------------------------------


def _fixed_formats():
    """The swept formats: the resolved int8 default (frac 24, seed-only
    (8, 0)), a wide register, and a Mitchell first pass."""
    return (
        ("frac24", formats.format_for("int8")),
        ("frac30", formats.NumericFormat.fixed(30)),
        ("mitchell", formats.NumericFormat.fixed(24, p=7, mitchell_iters=1)),
    )


def _fixed_cases(smoke: bool, device: torch.device):
    r = np.random.RandomState(7)
    rows_n = 64 if smoke else 256
    x = r.randint(-127, 128, (rows_n, 128)).astype(np.int8)
    x[x == 0] = 1
    scale = 0.02
    gain = r.randn(128).astype(np.float32)
    xf = x.astype(np.float64) * scale

    recip_want = 1.0 / xf

    def recip_err(got):
        return float(np.max(np.abs(_np32(got) - recip_want) / np.abs(recip_want)))

    e = np.exp(xf - xf.max(-1, keepdims=True))
    sm_want = e / e.sum(-1, keepdims=True)

    def softmax_err(got):
        return float(np.max(np.abs(_np32(got) - sm_want)))

    ms = np.mean(xf * xf, axis=-1, keepdims=True) + 1e-6
    rn_want = xf / np.sqrt(ms) * gain

    def rmsnorm_err(got):
        return float(np.max(np.abs(_np32(got) - rn_want)) / np.max(np.abs(rn_want)))

    xt, gt = torch.from_numpy(x).to(device), torch.from_numpy(gain).to(device)
    st = torch.tensor(scale, dtype=torch.float32, device=device)
    return [
        ("gs_fixed_recip", lambda **c: ops.gs_fixed_recip(xt, st, **c), recip_err),
        ("gs_fixed_softmax", lambda **c: ops.gs_fixed_softmax(xt, st, **c), softmax_err),
        ("gs_fixed_rmsnorm", lambda **c: ops.gs_fixed_rmsnorm(xt, st, gt, eps=1e-6, **c),
         rmsnorm_err),
    ]


def _row(kernel, dtype, impl, policy, config, us, err, bound, target_bits, device):
    return {"kernel": kernel, "dtype": dtype, "impl": impl, "policy": policy,
            "config": config, "us_per_call": round(us, 1), "max_err": err,
            "err_bound": bound, "ok": bool(err <= bound), "target_bits": target_bits,
            "device": device.type}


def fixed_records(smoke: bool = False, device="cuda"):
    """The int8 rows: the fused fixed-point kernels on int8 operands, per
    swept format, errors against a float64 oracle (recip and rmsnorm
    relative, softmax absolute)."""
    device = resolve_device(device)
    repeats = repeats_for(smoke)
    cases = _fixed_cases(smoke, device)
    out = []
    for fmt_name, fmt in _fixed_formats():
        cfg = fmt.precision()
        bound = FIXED_MARGIN * fmt.error_bound()
        for kernel, fn, err_fn in cases:
            err = err_fn(fn(**cfg))
            us = time_call(lambda: fn(**cfg), device, repeats)
            out.append(_row(kernel, "int8", _impl(device), fmt_name, cfg, us, err, bound,
                            formats.INT8_TARGET_BITS, device))
    return out


def records(smoke: bool = False, device="cuda"):
    """The rows of ``BENCH_kernels_torch.json``: every float kernel at f32
    and bf16 (``gs_adam`` at f32) under both policies, the tensor-op path
    once per kernel and dtype, then the int8 rows."""
    device = resolve_device(device)
    repeats = repeats_for(smoke)
    out = []
    for kernel, args_np, kernel_fn, torch_fn, err_fn in _bench_cases(smoke):
        dtypes = ("float32",) if kernel == "gs_adam" else ("float32", "bfloat16")
        for dtype_name in dtypes:
            dtype = getattr(torch, dtype_name)
            args = tuple(torch.from_numpy(a).to(dtype).to(device) for a in args_np)
            seed_cfg = {"p": DEFAULT_P, "iters": 2}
            pol_cfg = dict(zip(("p", "iters"), precision_policy(dtype)))
            bound = ERR_BOUNDS[(kernel, dtype_name)]
            for policy_name, cfg in (("seed", seed_cfg), ("dtype", pol_cfg)):
                err = float(err_fn(kernel_fn(*args, **cfg), args))
                us = time_call(lambda: kernel_fn(*args, **cfg), device, repeats)
                out.append(_row(kernel, dtype_name, _impl(device), policy_name, cfg, us, err,
                                bound, target_bits_for(dtype), device))
            us = time_call(lambda: torch_fn(*args), device, repeats)
            err = float(err_fn(torch_fn(*args), args))
            out.append(_row(kernel, dtype_name, "torch",
                            "dtype" if kernel == "flash_attention" else "seed", {}, us, err,
                            bound, target_bits_for(dtype), device))
    out.extend(fixed_records(smoke, device))
    return out


def expected_launches(recs, smoke: bool):
    """The kernel launches ``records(smoke)`` on the card makes: every
    ``cuda`` row calls its kernel ``calls_per_row`` times, and a row's
    ``kernel`` names its launch counter; the ``torch`` rows launch none."""
    want = {}
    for r in recs:
        if r["impl"] == "cuda":
            want[r["kernel"]] = want.get(r["kernel"], 0) + calls_per_row(smoke)
    return want


# -- the CSV rows of ``run.py --only kernels`` ------------------------------------


def rows(device="cuda"):
    """One call per kernel at the front-end's default settings against its
    exact oracle (the reference's ``rows()`` without its tuned-vs-default
    rows, which wait for the port's tuning)."""
    device = resolve_device(device)
    out = []
    r = np.random.RandomState(0)

    def on(*arrays):
        return [torch.from_numpy(a).to(device) for a in arrays]

    def timed(fn):
        return round(time_call(fn, device, 1), 1)

    for shape in ((64, 128), (33, 517)):
        x_np = np.abs(r.randn(*shape)).astype(np.float32) + 0.1
        (x,) = on(x_np)
        err = np.abs(_np32(ops.gs_recip(x)) * x_np - 1.0).max()
        out.append({"name": f"k_recip_{shape[0]}x{shape[1]}",
                    "us_per_call": timed(lambda: ops.gs_recip(x)),
                    "derived": f"max_rel_err={err:.2e}"})

    (x,) = on(r.randn(16, 384).astype(np.float32) * 4)
    err = np.abs(_np32(ops.gs_softmax(x)) - _np32(ref.softmax_exact(x.cpu()))).max()
    out.append({"name": "k_softmax_16x384", "us_per_call": timed(lambda: ops.gs_softmax(x)),
                "derived": f"max_abs_err={err:.2e}"})

    x, g = on(r.randn(32, 512).astype(np.float32), r.randn(512).astype(np.float32))
    err = np.abs(_np32(ops.gs_rmsnorm(x, g)) - _np32(ref.rmsnorm_exact(x.cpu(), g.cpu()))).max()
    out.append({"name": "k_rmsnorm_32x512", "us_per_call": timed(lambda: ops.gs_rmsnorm(x, g)),
                "derived": f"max_abs_err={err:.2e}"})

    q, k, v = on(r.randn(1, 4, 256, 64).astype(np.float32),
                 r.randn(1, 2, 256, 64).astype(np.float32),
                 r.randn(1, 2, 256, 64).astype(np.float32))
    err = np.abs(_np32(ops.flash_attention(q, k, v, causal=True)) - _np32(
        ref.attention_exact(q.cpu(), k.cpu(), v.cpu(), causal=True))).max()
    out.append({"name": "k_flash_gqa_256",
                "us_per_call": timed(lambda: ops.flash_attention(q, k, v, causal=True)),
                "derived": f"max_abs_err={err:.2e}"})

    p0, gr = on(r.randn(1000).astype(np.float32), r.randn(1000).astype(np.float32))
    m, vv = on(np.zeros(1000, np.float32), np.zeros(1000, np.float32))

    def adam():
        bc = ops.adam_scalars(1, 1e-3, beta1=0.9, beta2=0.999, device=device)
        return ops.gs_adam_update(p0, gr, m, vv, bc)

    want = ref.adam_update_exact(p0.cpu(), gr.cpu(), m.cpu(), vv.cpu(), lr=1e-3, step=1)
    err = max(np.abs(_np32(a) - _np32(b)).max() for a, b in zip(adam(), want))
    out.append({"name": "k_adam_1000", "us_per_call": timed(adam),
                "derived": f"max_abs_err={err:.2e}"})
    return out
