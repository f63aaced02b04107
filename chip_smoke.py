#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits nonzero before the last line:

1. Device: the card's name and power limit (``nvidia-smi``), TF32 off for
   matmuls and cuDNN, and the CUDA kernels built from ``csrc/`` with nvcc;
   the registers and spills ``-Xptxas -v`` reports, failing on any spill
   in the flash kernels (forward, dq, dk/dv) or on an instance of them
   without tensor-core (HMMA) instructions in ``cuobjdump -sass``; the
   registers and SASS instructions of each of gs_recip_kernel's 4 and
   gs_rsqrt_kernel's 12 instances, failing on a spill, on shared memory or
   a barrier in one, or on a 16-byte vector instance without 16-byte loads
   through the read-only path and stores (LDG.E.128.CONSTANT / STG.E.128);
   the registers, shared memory and SASS instructions of each of
   gs_rmsnorm_kernel's 19 instances, failing on a spill, on shared memory
   beyond its per-warp partial sums (static plus the launch's dynamic part;
   a staged ROM copy would be more), or on a 16-byte vector instance
   without LDG.E.128 and STG.E.128; the same for gs_fixed_rmsnorm_kernel's
   8 instances, whose vector instances must hold 16-byte loads of x and
   gain (five a vector a thread holds) and four 16-byte stores a vector;
   the same for gs_fixed_softmax_kernel's 10 instances (no spill, shared
   memory only for the per-warp partials of the max and the sum, a float4
   store a word in each word instance); the same for
   gs_fixed_recip_kernel's 3 instances (no spill, no shared memory or
   barrier, a float4 store for each word a lane holds in each word
   instance), then the SASS instruction counts and digests of the softmax's
   and the rmsnorm's 18 instances; the same for gs_softmax_kernel's 21
   instances (19 block, 2 cluster: no spill, shared memory only for the
   per-warp partials and the cluster's two exchanges (no 2^p ROM), 16-byte loads and
   stores in each vector instance, the cluster barrier in each cluster
   instance), then the SASS instruction counts and digests of the
   gs_recip, gs_rsqrt and gs_rmsnorm instances.
2. Kernels vs their plain PyTorch versions on the card: gs_rmsnorm at
   (rows, 2048), and with its rsqrt column (within 2^-20 relative) on each
   launch plan: rows 1 and 2048, d 37, 200, 8192, 16392 and 4097 (the last
   two past the register plans), a view one element into its storage and a
   row of zeros; flash attention at (1, 32, S, 64) / (1, 4, S, 64), f32 and
   bf16, held to the reference's ERR_BOUNDS (f32 2^-15, bf16 2^-4), and at
   f32, S 333 and 512, within 10x the plain f32 version's max |error|
   against the plain version run in f64 (the forward's products are three
   TF32 tensor-core passes); then at
   the training shapes: the forward's (m, l) residuals, and dq, dk, dv at
   (4, 32, S, 64) / (4, 4, S, 64), S 512 and 333, causal, f32 and bf16 (the
   ``flash_attention`` row, as max error over the plain version's largest
   element), and within 10x the plain f32 version's max |error| against the
   plain version run in f64: at f32 dq, dk, dv (the kernels' products are
   three TF32 tensor-core passes; a single pass keeps about 11 bits), at
   bf16 the dk/dv kernel's f32 per-q-head dk, dv (two passes with p, ds);
   gs_adam on a 1.1e6-element leaf and on one of 131 x 129 elements (the
   ``gs_adam`` row, f32 2^-18); then the flash forward (with and without
   its residuals) and the backward pair on q rows holding a NaN, a +inf and
   a value whose scores overflow, causal and not, with NaN, +inf and -inf in
   the same places as the plain versions' (their TF32 passes emulated).
3. Serve full-width tinyllama-1.1b (random weights from ``--seed``):
   ``Engine.run`` over 4 slots on 8 staggered requests (prompts 45..333
   tokens, 32 generated each) at float32, token for token against
   ``generate_sequential``; then the published dtype (bf16 activations,
   fp32 params) on the same trace, whose tokens must be valid.  Both runs
   must launch gs_rmsnorm 45 x (prefills + decode ticks) times and flash
   attention 22 x prefills times.
3b. The same parameters and trace through the paged pool
   (``EngineConfig(pool="paged")``, page size 16), launch counts as in 3
   with a preempted request's replay counted as a prefill and an exact
   prefix hit's skipped one not: (a) the default arena, prefix sharing
   off, tokens equal to the slot engine's and to ``generate_sequential``'s
   under 3's near-tie rule, TTFT median and decode tok/s beside 3's and the
   arena's bytes beside the slot pool's (printed, not gated); (b) an arena
   of one s_max request and 8 pages more: at least one preemption and one
   decode-time page append, the same tokens; (c) requests 3, 5 and 7 on
   request 0's prompt under ``prefix="exact"``: at least one prefill
   skipped and one page copied on write, tokens equal to
   ``generate_sequential``'s; (d) in phase 7c, the int8 trace through the
   paged pool (int8 arena), tokens equal to the int8 slot engine's.  Every
   run ends with every slot free and no page in use but the prefix
   index's; each prints the pool's ``stats()``.
4. Timing at the main paths' shapes: gs_rmsnorm at decode (4, 2048),
   prefill (333, 2048) at f32, bf16 and p 12, and the training batch
   (2048, 2048) with the rsqrt column at f32 and bf16 on copies cycled past
   the L2, device time queued back to back (``queued_ms``) beside
   ``F.rms_norm`` and the bytes bound, with the SM and memory clocks
   nvidia-smi samples meanwhile; then each kernel, its plain version and
   one PyTorch call computing the same function (``F.rms_norm`` x gain;
   ``F.scaled_dot_product_attention`` on heads expanded beforehand, and its
   backward for dq and dk/dv; ``torch.optim.AdamW(fused=True).step()``) as
   a yardstick the port never calls — per call from CUDA events over
   back-to-back calls (host launch cost included) and as device time from
   torch.profiler — beside the least time the card could take (for the
   flash kernels at f32, at the 3xTF32 tensor-core rate, with the fp32 FMA
   bound beside it); the forward's device time over SDPA forward's at
   (1, 32, 333, 64) and, with residuals, at (4, 32, 512, 64); the backward
   pair's over SDPA backward's, and the kernels SDPA backward runs; then the
   three flash kernels queued back to back (``queued_ms``) beside SDPA's
   forward: the forward at (1, 32, 333, 64) f32 and bf16, and at
   (4, 32, 512, 64) f32 the forward with residuals, dq and dk/dv.
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
   bound of an f64 oracle (the bench's gate); then gs_fixed_rmsnorm on each
   launch plan in the three formats and at p 12, bit-equal, one launch a
   call, within the oracle's gate: rows 1, 4, 333 and 2048 at d 2048, d 37,
   200 and 8192, 16400 and 4097 past the register plans, a view one byte
   into its storage, a row of zeros beside a row of ±127; then
   gs_fixed_softmax on each of its launch plans in the three formats and
   at p 12, both variants and scales ±0.02, one launch a call (none for
   no rows), within 2^-12 of the plain version and the oracle's gate:
   (256, 128) and 4096 rows at d 128 (a warp a row, a word a lane), the
   packed plans at d 128, 200 and 37 (on a grid of one block), d 64
   (half-warp segments), 1, 37, 200, 1024, 4096, 4100 and 2049 (rows of
   several warps), 16400 and 4097 past the register plans, views one and
   four bytes into their storage, a row of one repeated code beside a row
   holding its max twice; then gs_fixed_recip in the three formats and at
   p 12, both variants, at scales ±0.02, 4/127, 1, 2^-20 and 2^20,
   bit-equal, one launch a call (in ``launches_recip`` and in the
   profiler's trace; none for no codes), within the oracle's gate: every
   code -128..127 aligned and 1, 2 and 3 bytes into its storage, (256, 128)
   and (65536, 128) with every 17th code 0, lengths 1-7, 9 and 4097,
   (256, 128) views 1, 2 and 3 bytes in, and 4 and 1 words a lane on a
   grid of one block; (b) a 2-layer full-width cut
   on the card and on the CPU, teacher-forced with the CPU's tokens through
   a prefill and 8 decode steps, the int8 codes each of the 5 norms is
   given recorded at every step: (i) every card code within 1 of the
   CPU's, (ii) at most 2% of them differing, (iii) logits within 4 x the
   int8 format's bound (2^-8) of the largest |logit| at every step (a
   one-ulp difference in one element can move a norm's scale and flip the
   codes at rounding boundaries by 1; a fault moves more, or by more);
   (c) ``Engine.run`` on phase 3's trace: valid tokens, exact launch
   counts, resident int8 params below 0.3 x the f32 tree, params + KV
   cache within 0.55 x the analytic bf16 pair
   (``benchmarks/bench_serve.py``'s QUANT_BYTES_BUDGET), the same tokens on
   a second run; TTFT, tok/s, peak memory and the share of phase
   3's f32 tokens matched as a prefix (printed, not gated), 3b (d) (the
   same trace through the int8 paged pool, the int8 slot engine's tokens),
   and phase 5's profile of one request through the int8 engine; (d) the three
   kernels timed beside their plain versions and a dequantize-then-library
   call (``F.rms_norm``, ``torch.reciprocal``, ``torch.softmax`` on
   ``x.float() * scale``), queued back to back (``queued_ms``) and per
   call, with the SM and memory clocks nvidia-smi samples meanwhile:
   gs_fixed_rmsnorm at the decode tick (4, 2048), the prefill (333, 2048)
   at p 8 and p 12 and a 2048-token prefill on copies cycled past the L2,
   also beside ``F.rms_norm`` alone on an f32 copy of its input;
   gs_fixed_recip and gs_fixed_softmax at (256, 128) and at (65536, 128)
   on copies cycled past the L2, and both at (256, 128) at p 12.
8. The kernel benchmark's kernels (gs_recip, gs_rsqrt / gs_sqrt,
   gs_softmax), whose only caller is the kernel benchmark, in the reference
   too: (a) each against its plain version over the (dtype, p, iters,
   variant) grid of ``tests/test_torch_kernels.py`` and two f32 points,
   (8, 0) and (7, 1), where the Goldschmidt error shows: gs_recip and the
   three modes of gs_rsqrt bit-equal (any NaN matching any NaN) at
   (256, 128), (33, 517), (4096, 128), on a row of specials, on (256, 128)
   views 1, 2 and 3 elements into their storage and on lengths 1 to 7, 9
   and 4097, gs_softmax on each launch plan (``SOFTMAX_SHAPES``: (16, 384),
   (37, 200), d 517, (8, 32000), (2, 32000), (256, 32000), (2, 131072)
   (the widest row the cluster of 8 holds) and a row past it; views one
   element into their storage; rows with a -inf half, all -inf, a +inf, a
   NaN) within 2^-18 of the plain value (f32) or one ulp (bf16), NaN in
   the same places, every launch counted; (b) their VJPs through
   ``kernels.ops`` on the card against the same on the CPU; (c) gs_rmsnorm,
   flash_attention and gs_adam on the benchmark's own full-size inputs
   against their plain versions at phase 2's limits (gs_adam bit-equal), then
   the port's kernel benchmark (``repro_torch.benchmarks.bench_kernels.records``,
   full size) on the card: every row within its bound, every launch the
   benchmark's loop makes counted exactly; (d) the three kernels timed at
   the benchmark's shapes and at (4096, 128) / (8, 32000), gs_recip and
   gs_rsqrt's three modes also at (65536, 128) on copies cycled past the
   L2, gs_recip and gs_rsqrt at bf16 and at p 12, gs_softmax at
   (256, 32000) f32 and bf16 on copies cycled past the L2 and at
   (8, 32000) p 12, beside their plain
   versions and ``torch.reciprocal`` / ``torch.rsqrt`` / ``torch.sqrt`` /
   ``torch.softmax``, with the SM and memory clocks nvidia-smi samples
   meanwhile.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import math
import re
import shutil
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
# H100 SXM data-sheet peaks (dense): device memory and compute by input type;
# "tf32x3" is an f32-accurate product as three TF32 tensor-core passes, the
# flash backward kernels' route
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32x3": 495e12 / 3}
ORACLE_FACTOR = 10  # flash backward vs an f64 oracle: at most 10x the plain f32 error
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


def sass(lib: Path) -> str:
    """The built library's SASS (``cuobjdump -sass``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                         timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump: {out.stderr.strip()[-500:]}")
    return out.stdout


def hmma_counts(sass_text: str) -> dict:
    """Tensor-core (HMMA) instructions in each instance of the flash kernels
    (the forward, dq and dk/dv), from the library's SASS."""
    counts, name = {}, None
    for line in sass_text.splitlines():
        found = re.search(r"Function : \S*(flash_(?:fwd|bwd_\w+?)_kernel)I(\w+?)Li(\d+)E",
                          line)
        if "Function :" in line:
            name = None
            if found:
                kernel, dtype, d = found.groups()
                name = f"{kernel}<{'float' if dtype == 'f' else 'bf16'}, {d}>"
                counts[name] = 0
        elif name and "HMMA" in line:
            counts[name] += 1
    return counts


# gs_recip_kernel<T, width> and gs_rsqrt_kernel<T, mode, width> as they are
# mangled
ELEMENTWISE_INSTANCE = re.compile(
    r"gs_(recip|rsqrt)_kernelI(f|13__nv_bfloat16)(?:Li(\d)E)?Li(\d)EE")
# 2 dtypes x 2 widths for gs_recip_kernel, x 3 modes for gs_rsqrt_kernel
ELEMENTWISE_INSTANCES = {"recip": 4, "rsqrt": 12}


def elementwise_instance_name(found) -> str:
    kernel, dtype, mode, width = found.groups()
    mode = "" if mode is None else f", mode {mode}"
    return (f"gs_{kernel}_kernel<{'float' if dtype == 'f' else 'bf16'}{mode}, "
            f"width {width}>")


def instance_report(pattern, name_of, ops: dict, log_text: str, sass_text: str) -> dict:
    """Registers, spill bytes and static shared memory (the build's
    ``-Xptxas -v`` report), and the SASS instructions (NOP padding aside)
    and the instructions matching each of ``ops``' patterns, of each kernel
    instance whose mangled name matches ``pattern``, named by ``name_of``."""
    report, name = {}, None
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            found = pattern.search(line)
            name = name_of(found) if found else None
            if name:
                report[name] = {"smem": 0}
        elif name:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            regs = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            if spill:
                report[name]["spill"] = int(spill.group(1)) + int(spill.group(2))
            if regs:
                report[name]["registers"] = int(regs.group(1))
            if smem:
                report[name]["smem"] = int(smem.group(1))
    name = None
    for line in sass_text.splitlines():
        if "Function :" in line:
            found = pattern.search(line)
            name = name_of(found) if found else None
            if name:
                report.setdefault(name, {}).update({op: 0 for op in ops}, instructions=0)
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line) and "NOP" not in line:
            report[name]["instructions"] += 1
            for op, op_pattern in ops.items():
                report[name][op] += bool(re.search(op_pattern, line))
    return report


def check_elementwise_build(lib: Path, log_text: str, sass_text: str) -> None:
    """Phase 1 for gs_recip_kernel and gs_rsqrt_kernel: every instance's
    registers and SASS instructions; no spill, no shared memory and no
    barrier in any, and 16-byte loads through the read-only path and
    16-byte stores (LDG.E.128.CONSTANT / STG.E.128) in each vector
    instance."""
    ops = {"LDG.E.128.CONSTANT": r"\bLDG\.E\.128\.CONSTANT\b",
           "STG.E.128": r"\bSTG\.E\.128\b", "shared/barrier": r"\b(?:LDS|STS|BAR)\b"}
    report = instance_report(ELEMENTWISE_INSTANCE, elementwise_instance_name, ops, log_text,
                             sass_text)
    for name in sorted(report):
        print(f"  {name}: {report[name]}")
    found = {k: sum(name.startswith(f"gs_{k}_kernel<") for name in report)
             for k in ELEMENTWISE_INSTANCES}
    if found != ELEMENTWISE_INSTANCES:
        fail(f"expected {ELEMENTWISE_INSTANCES} instances of gs_recip_kernel / gs_rsqrt_kernel "
             f"in {lib.name}'s report and SASS, found {sorted(report)}")
    for name, r in report.items():
        if "registers" not in r or r.get("spill") != 0 or "instructions" not in r:
            fail(f"{name} spills or has no register report or SASS: {r}")
        if r["smem"] or r["shared/barrier"]:
            fail(f"{name} uses shared memory or a barrier: {r}")
        if not name.endswith("width 1>") and not (r["LDG.E.128.CONSTANT"] and r["STG.E.128"]):
            fail(f"{name} lacks 16-byte loads or stores: {r}")


# gs_rmsnorm_kernel<T, width, vecs> as it is mangled
RMSNORM_INSTANCE = re.compile(r"gs_rmsnorm_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)EE")
# vecs 0 (the loop), 1, 2, 4, 8 at both widths, bf16 16-byte vectors up to 4
RMSNORM_INSTANCES = 19
# the launch's dynamic shared memory (csrc/gs_rmsnorm.cu, launch<T>)
RMSNORM_DYNAMIC_SMEM = 0


def rmsnorm_instance_name(found) -> str:
    dtype, width, vecs = found.groups()
    return (f"gs_rmsnorm_kernel<{'float' if dtype == 'f' else 'bf16'}, width {width}, "
            f"vecs {vecs}>")


def check_rmsnorm_build(lib: Path, log_text: str, sass_text: str) -> None:
    """Phase 1 for gs_rmsnorm_kernel: every instance's registers, shared
    memory and SASS instructions; no spill, no shared memory beyond the
    per-warp partial sums (two rows' worth, static plus the launch's dynamic
    part: a staged ROM would be 2^p entries more), and 16-byte loads and
    stores in each vector instance."""
    from repro_torch.kernels import gs_rmsnorm as rms_kernel

    partials = 2 * (rms_kernel.MAX_THREADS // 32) * 4
    ops = {"LDG.E.128": r"\bLDG\.E\.128\b", "STG.E.128": r"\bSTG\.E\.128\b",
           "LDS/STS": r"\b(?:LDS|STS)\b", "BAR": r"\bBAR\b"}
    report = instance_report(RMSNORM_INSTANCE, rmsnorm_instance_name, ops, log_text, sass_text)
    for name in sorted(report):
        print(f"  {name}: {report[name]}")
    if len(report) != RMSNORM_INSTANCES:
        fail(f"expected {RMSNORM_INSTANCES} instances of gs_rmsnorm_kernel in {lib.name}'s "
             f"report and SASS, found {sorted(report)}")
    for name, r in report.items():
        if "registers" not in r or r.get("spill") != 0 or "instructions" not in r:
            fail(f"{name} spills or has no register report or SASS: {r}")
        if r["smem"] + RMSNORM_DYNAMIC_SMEM > partials:
            fail(f"{name} uses {r['smem']} + {RMSNORM_DYNAMIC_SMEM} bytes of shared memory, "
                 f"more than the {partials} bytes of per-warp partial sums")
        if "width 1," not in name and not (r["LDG.E.128"] and r["STG.E.128"]):
            fail(f"{name} lacks 16-byte loads or stores: {r}")


# gs_fixed_rmsnorm_kernel<width, vecs> as it is mangled
FIXED_RMSNORM_INSTANCE = re.compile(r"gs_fixed_rmsnorm_kernelILi(\d+)ELi(\d+)EE")
# vecs 0 (the loop), 1, 2 at 16-byte vectors; 0, 1, 2, 4, 8 at one code
FIXED_RMSNORM_INSTANCES = 8
FIXED_RMSNORM_DYNAMIC_SMEM = 0  # the launch's (csrc/gs_fixed_rmsnorm.cu)
# the int8 kernels this PR's recip work leaves as they were, each instance
# by its mangled name: their SASS digests are the control of an A/B
FIXED_OTHERS = re.compile(r"(gs_fixed_(?:softmax|rmsnorm)_kernelILi\d+ELi\d+EE)")


def fixed_rmsnorm_instance_name(found) -> str:
    width, vecs = found.groups()
    return f"gs_fixed_rmsnorm_kernel<width {width}, vecs {vecs}>"


def check_fixed_rmsnorm_build(lib: Path, log_text: str, sass_text: str) -> None:
    """Phase 1 for gs_fixed_rmsnorm_kernel: every instance's registers,
    shared memory and SASS instructions; no spill, no shared memory beyond
    the per-warp partial sums (two rows' worth, static plus the launch's
    dynamic part: a staged rsqrt ROM would be 2^p words more), and in each
    16-byte vector instance 16-byte loads of x and gain (one and four a
    vector a thread holds, LDG.E.128 with or without .CONSTANT) and four
    16-byte stores a vector."""
    from repro_torch.kernels import gs_rmsnorm as rms_kernel

    partials = 2 * (rms_kernel.MAX_THREADS // 32) * 4
    ops = {"LDG.E.128": r"\bLDG\.E\.128\b", "STG.E.128": r"\bSTG\.E\.128\b",
           "LDS/STS": r"\b(?:LDS|STS)\b", "BAR": r"\bBAR\b", "IDP.4A": r"\bIDP\.4A\b",
           "REDUX": r"\bREDUX\b", "SHFL": r"\bSHFL\b"}
    report = instance_report(FIXED_RMSNORM_INSTANCE, fixed_rmsnorm_instance_name, ops,
                             log_text, sass_text)
    for name in sorted(report):
        print(f"  {name}: {report[name]}")
    if len(report) != FIXED_RMSNORM_INSTANCES:
        fail(f"expected {FIXED_RMSNORM_INSTANCES} instances of gs_fixed_rmsnorm_kernel in "
             f"{lib.name}'s report and SASS, found {sorted(report)}")
    for name, r in report.items():
        if "registers" not in r or r.get("spill") != 0 or "instructions" not in r:
            fail(f"{name} spills or has no register report or SASS: {r}")
        if r["smem"] + FIXED_RMSNORM_DYNAMIC_SMEM > partials:
            fail(f"{name} uses {r['smem']} + {FIXED_RMSNORM_DYNAMIC_SMEM} bytes of shared "
                 f"memory, more than the {partials} bytes of per-warp partial sums")
        vecs = max(1, int(name.split("vecs ")[1].rstrip(">")))
        if "width 1," not in name and not (r["LDG.E.128"] >= 5 * vecs
                                           and r["STG.E.128"] >= 4 * vecs):
            fail(f"{name} lacks 16-byte loads of x and gain or 16-byte stores: {r}")


# gs_fixed_softmax_kernel<width, vecs> as it is mangled
FIXED_SOFTMAX_INSTANCE = re.compile(r"gs_fixed_softmax_kernelILi(\d+)ELi(\d+)EE")
# vecs 0 (the loop), 1, 2, 4, 8 at 32-bit words of four codes and at one code
FIXED_SOFTMAX_INSTANCES = 10


def fixed_softmax_instance_name(found) -> str:
    width, vecs = found.groups()
    return f"gs_fixed_softmax_kernel<width {width}, vecs {vecs}>"


def check_fixed_softmax_build(lib: Path, log_text: str, sass_text: str) -> None:
    """Phase 1 for gs_fixed_softmax_kernel: every instance's registers,
    shared memory and SASS instructions; no spill, no shared memory beyond
    the per-warp partials of the max and the sum (a staged recip ROM would
    be 2^p words more: the launch asks for no dynamic shared memory), and in
    each word instance a float4 store (STG.E.128, or STG.E.EF.128 as a
    streaming store) a word a thread holds."""
    from repro_torch.kernels import gs_fixed as fixed_kernel

    partials = 2 * (fixed_kernel.SOFTMAX_MAX_THREADS // 32) * 4
    ops = {"LDG.E": r"\bLDG\.E\b", "LDG.E.S8": r"\bLDG\.E\.S8\b",
           "STG.E*.128": r"\bSTG\.E(?:\.[A-Z0-9]+)*\.128\b", "LDS/STS": r"\b(?:LDS|STS)\b",
           "BAR": r"\bBAR\b",
           "REDUX": r"\bREDUX\b", "SHFL": r"\bSHFL\b", "MUFU.EX2": r"\bMUFU\.EX2\b"}
    report = instance_report(FIXED_SOFTMAX_INSTANCE, fixed_softmax_instance_name, ops,
                             log_text, sass_text)
    for name in sorted(report):
        print(f"  {name}: {report[name]}")
    if len(report) != FIXED_SOFTMAX_INSTANCES:
        fail(f"expected {FIXED_SOFTMAX_INSTANCES} instances of gs_fixed_softmax_kernel in "
             f"{lib.name}'s report and SASS, found {sorted(report)}")
    for name, r in report.items():
        if "registers" not in r or r.get("spill") != 0 or "instructions" not in r:
            fail(f"{name} spills or has no register report or SASS: {r}")
        if r["smem"] > partials:
            fail(f"{name} uses {r['smem']} bytes of shared memory, more than the {partials} "
                 f"bytes of per-warp partials")
        vecs = max(1, int(name.split("vecs ")[1].rstrip(">")))
        if "width 1," not in name and r["STG.E*.128"] < vecs:
            fail(f"{name} lacks a float4 store a word: {r}")


# gs_fixed_recip_kernel<width, words> as it is mangled
FIXED_RECIP_INSTANCE = re.compile(r"gs_fixed_recip_kernelILi(\d+)ELi(\d+)EE")
# words 1 and 4 a lane at 32-bit words of four codes; one code a lane
FIXED_RECIP_INSTANCES = 3


def fixed_recip_instance_name(found) -> str:
    width, words = found.groups()
    return f"gs_fixed_recip_kernel<width {width}, words {words}>"


def check_fixed_recip_build(lib: Path, log_text: str, sass_text: str) -> None:
    """Phase 1 for gs_fixed_recip_kernel: every instance's registers, shared
    memory and SASS instructions; no spill, no shared memory and no barrier
    (the ROM is read through the read-only cache, not staged), and in each
    word instance a float4 store (STG.E.128, or STG.E.EF.128 as a streaming
    store) for each word a lane holds.  Then the SASS instruction counts and
    digests of the other int8 kernels' instances (``FIXED_OTHERS``)."""
    ops = {"LDG.E": r"\bLDG\.E\b", "LDG.E.CONSTANT": r"\bLDG\.E\.CONSTANT\b",
           "STG.E*.128": r"\bSTG\.E(?:\.[A-Z0-9]+)*\.128\b",
           "shared/barrier": r"\b(?:LDS|STS|BAR)\b"}
    report = instance_report(FIXED_RECIP_INSTANCE, fixed_recip_instance_name, ops, log_text,
                             sass_text)
    for name in sorted(report):
        print(f"  {name}: {report[name]}")
    if len(report) != FIXED_RECIP_INSTANCES:
        fail(f"expected {FIXED_RECIP_INSTANCES} instances of gs_fixed_recip_kernel in "
             f"{lib.name}'s report and SASS, found {sorted(report)}")
    for name, r in report.items():
        if "registers" not in r or r.get("spill") != 0 or "instructions" not in r:
            fail(f"{name} spills or has no register report or SASS: {r}")
        if r["smem"] or r["shared/barrier"]:
            fail(f"{name} uses shared memory or a barrier: {r}")
        words = int(name.split("words ")[1].rstrip(">"))
        if "width 1," not in name and r["STG.E*.128"] < words:
            fail(f"{name} lacks a float4 store a word: {r}")
    print(f"  SASS (NOP padding aside) of the other int8 kernels: "
          f"{json.dumps(sass_digests(FIXED_OTHERS, sass_text))}")


# gs_softmax_kernel<T, width, vecs, cluster> as it is mangled
SOFTMAX_INSTANCE = re.compile(r"gs_softmax_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELb([01])EE")
# block instances: vecs 0 (the loop), 1, 2, 4, 8 at both widths, bf16 16-byte
# vectors up to 4; cluster instances: 16-byte vectors, 16 elements a thread
SOFTMAX_INSTANCES = {"block": 19, "cluster": 2}
# the cluster barrier (barrier.cluster.arrive / wait) in SASS
CLUSTER_BARRIER = r"\bUCGABAR_(?:ARV|WAIT)\b"
# the elementwise and rmsnorm kernels, each instance by its mangled name: a
# gs_softmax change leaves their SASS as it was (the control of an A/B)
FLOAT_OTHERS = re.compile(r"(gs_(?:recip|rsqrt|rmsnorm)_kernelI\w+?EE)")


def softmax_instance_name(found) -> str:
    dtype, width, vecs, cluster = found.groups()
    kind = "cluster" if cluster == "1" else "block"
    return (f"gs_softmax_kernel<{'float' if dtype == 'f' else 'bf16'}, width {width}, "
            f"vecs {vecs}, {kind}>")


def check_softmax_build(lib: Path, log_text: str, sass_text: str) -> None:
    """Phase 1 for gs_softmax_kernel: every instance's registers, shared
    memory and SASS instructions; no spill, no shared memory beyond the
    per-warp partials of the max and the sum and the cluster's two
    exchanges (a staged recip ROM would be 2^p entries more: the launch
    asks for no dynamic shared memory), 16-byte loads and stores
    (LDG.E.128, STG.E.128 or its streaming form) in each vector instance,
    and the cluster barrier in each cluster instance."""
    from repro_torch.kernels import gs_softmax as softmax_kernel

    # per-warp max and sum partials, and two exchanges of a (sum, max) pair
    # for each warp of each rank and an mbarrier each
    warps = softmax_kernel.CLUSTER_THREADS // 32
    partials = 2 * warps * 4 + 2 * (softmax_kernel.CLUSTER * warps * 8 + 8)
    ops = {"LDG.E*.128": r"\bLDG\.E(?:\.[A-Z0-9]+)*\.128\b",
           "STG.E*.128": r"\bSTG\.E(?:\.[A-Z0-9]+)*\.128\b", "LDS/STS": r"\b(?:LDS|STS)\b",
           "BAR": r"\bBAR\b", "cluster barrier": CLUSTER_BARRIER, "SHFL": r"\bSHFL\b",
           "MUFU.EX2": r"\bMUFU\.EX2\b"}
    report = instance_report(SOFTMAX_INSTANCE, softmax_instance_name, ops, log_text, sass_text)
    for name in sorted(report):
        print(f"  {name}: {report[name]}")
    found = {k: sum(name.endswith(f", {k}>") for name in report) for k in SOFTMAX_INSTANCES}
    if found != SOFTMAX_INSTANCES:
        fail(f"expected {SOFTMAX_INSTANCES} instances of gs_softmax_kernel in {lib.name}'s "
             f"report and SASS, found {sorted(report)}")
    for name, r in report.items():
        if "registers" not in r or r.get("spill") != 0 or "instructions" not in r:
            fail(f"{name} spills or has no register report or SASS: {r}")
        if r["smem"] > partials:
            fail(f"{name} uses {r['smem']} bytes of shared memory, more than the {partials} "
                 f"bytes of per-warp partials and cluster exchanges")
        if "width 1," not in name and not (r["LDG.E*.128"] and r["STG.E*.128"]):
            fail(f"{name} lacks 16-byte loads or stores: {r}")
        if name.endswith(", cluster>") and not r["cluster barrier"]:
            fail(f"{name} has no cluster barrier ({CLUSTER_BARRIER}): {r}")
    print(f"  SASS (NOP padding aside) of the elementwise and rmsnorm kernels: "
          f"{json.dumps(sass_digests(FLOAT_OTHERS, sass_text))}")


def sass_digests(pattern, sass_text: str) -> dict:
    """Of each kernel function whose mangled name matches ``pattern`` (named
    by its first group): its SASS instructions (NOP padding aside) and a
    digest of their text without addresses, encodings and label numbers, so
    that a function compiled into two libraries digests the same when its
    code is the same."""
    code, name = {}, None
    for line in sass_text.splitlines():
        if "Function :" in line:
            found = pattern.search(line)
            name = found.group(1) if found else None
            if name:
                code[name] = []
        elif name:
            op = re.search(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)", line)
            if op and "NOP" not in op.group(1):
                code[name].append(re.sub(r"\.L_x_\d+", ".L_x", op.group(1).strip()))
    return {name: {"instructions": len(ops),
                   "digest": hashlib.sha256("\n".join(ops).encode()).hexdigest()[:16]}
            for name, ops in sorted(code.items())}


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


def queued_ms(fn, n: int) -> float:
    """Device time per call of ``n`` calls run back to back on the card,
    from CUDA events and not from the profiler: the calls queue behind a
    spin kernel (``torch.cuda._sleep``) that lasts until the host has
    launched them all, so no host gap falls between them.  Median of 3
    rounds, after a warm-up; a round whose spin ended before the last
    launch is run again with a spin twice as long (``fn`` must not
    synchronise)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    cycles = int(4 * (time.perf_counter() - t0) * 2e9)  # 4x the launches' host time at 2 GHz
    torch.cuda.synchronize()
    rounds = []
    for _ in range(10):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        drained = start.query()
        stop.synchronize()
        if drained:
            cycles *= 2
            continue
        rounds.append(start.elapsed_time(stop) / n)
        if len(rounds) == 3:
            return sorted(rounds)[1]
    fail(f"queued_ms: the spin kernel kept ending before {n} calls were launched")


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


def top_kernels(fn, n: int = 3):
    """The names of the ``n`` CUDA kernels that take most of ``fn``'s device
    time, from torch.profiler."""
    fn()
    _, events = profiled(fn)
    total = {}
    for e in events:
        total[e.name] = total.get(e.name, 0.0) + e.time_range.elapsed_us()
    return sorted(total, key=total.get, reverse=True)[:n]


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


class L2Ring:
    """Copies of an input that a timed function takes in turn, enough that
    each is read again only after twice the card's L2 of other calls'
    traffic; each call's result is held until its copy comes round, so the
    outputs rotate over as many buffers.  A time from it is one against
    device memory, where back-to-back calls on one input would find part of
    it in the L2."""

    def __init__(self, x, call_bytes: int):
        l2 = torch.cuda.get_device_properties(x.device).L2_cache_size
        self.xs = [x.clone() for _ in range(1 + -(-2 * l2 // call_bytes))]
        self.held = [None] * len(self.xs)
        self.i = 0

    def calls(self, fn):
        """A function of no arguments that runs ``fn`` on the next copy."""
        def run():
            i = self.i % len(self.xs)
            self.i += 1
            self.held[i] = fn(self.xs[i])
        return run


class SampledClocks:
    """The card's SM and memory clocks, sampled by nvidia-smi every 100 ms
    while the ``with`` block runs."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,clocks.mem",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        self.samples = [tuple(int(v) for v in line.split(",")) for line in out.splitlines()
                        if re.fullmatch(r"\s*\d+\s*,\s*\d+\s*", line)]
        return False

    def summary(self) -> dict:
        """Sample count and [min, median, max] MHz of each clock."""
        if not self.samples:
            return {"samples": 0}
        spread = lambda v: [min(v), sorted(v)[len(v) // 2], max(v)]  # noqa: E731
        sm, mem = zip(*self.samples)
        return {"samples": len(sm), "sm_mhz": spread(sm), "mem_mhz": spread(mem)}


def under_load(seconds: float = 1.0) -> None:
    """Keep the card busy with f32 GEMMs for ``seconds``, so that timings
    that follow start from its clocks under load."""
    a = torch.randn(4096, 4096, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(8):
            a @ a
        torch.cuda.synchronize()


# -- phase 2 -------------------------------------------------------------------

# gs_rmsnorm's launch plans on the card, beside the (rows, 2048) loop of
# check_kernels: (rows, d, storage offset, a row of zeros) — one row to the
# training batch, d 37 (the one-element instance), 200 (narrow rows,
# several a block), 8192, 16392 past the largest register plan and 4097 past
# the one-element plan (the looping instances), a view one element into its
# storage (not 16-byte aligned), and a row whose ms is 0 (its rsqrt is eps's)
RMSNORM_SHAPES = ((1, 2048, 0, False), (2048, 2048, 0, False), (5, 37, 0, False),
                  (13, 200, 0, False), (3, 8192, 0, False), (3, 16392, 0, False),
                  (2, 4097, 0, False), (33, 2048, 1, False), (6, 2048, 0, True))
# each dtype with the (p, iters, variant) its accuracy budget resolves to
# (tests/test_torch_cuda.py PRECISIONS)
RMSNORM_PRECISIONS = {torch.float32: ((7, 2, "feedback"), (7, 2, "pipelined"),
                                      (12, 1, "pipelined")),
                      torch.bfloat16: ((8, 0, "feedback"), (8, 0, "pipelined"))}


def check_rmsnorm_plans(g) -> float:
    """gs_rmsnorm on ``RMSNORM_SHAPES`` against its plain version: y within
    ERR_BOUNDS, the rsqrt column within 2^-20 relative, one launch a call;
    returns the worst max |error| of y."""
    from repro_torch.kernels import gs_rmsnorm as rms_kernel
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    worst = 0.0
    for dtype, precisions in RMSNORM_PRECISIONS.items():
        name = str(dtype).split(".")[-1]
        bound = ERR_BOUNDS[name]
        for rows, d, offset, zero_row in RMSNORM_SHAPES:
            buf = (3 * torch.randn(rows * d + offset, generator=g, device=dev)).to(dtype)
            x = buf[offset:].view(rows, d)
            if zero_row:
                x[rows // 2] = 0
            gain = 1 + 0.1 * torch.randn(d, generator=g, device=dev)
            plan = rms_kernel.launch_plan(d, x.element_size(),
                                          (x.data_ptr() | gain.data_ptr()) % 16)
            for p, iters, variant in precisions:
                kw = dict(eps=1e-5, p=p, iters=iters, variant=variant, save_inv=True)
                before = rms_kernel.launches
                got, got_inv = rms_kernel.gs_rmsnorm(x, gain, **kw)
                launched = rms_kernel.launches - before
                want, want_inv = ref.rmsnorm(x, gain, **kw)
                err = (got.float() - want.float()).abs().max().item()
                inv_err = ((got_inv - want_inv).abs() / want_inv).max().item()
                print(f"  gs_rmsnorm {name} ({rows}, {d}) offset {offset}"
                      f"{' zero row' if zero_row else ''} {plan} p={p} iters={iters} "
                      f"{variant}: max|err| {err:.3e} (bound {bound:.3e}), rsqrt column "
                      f"max rel err {inv_err:.3e} (bound {2.0**-20:.3e})")
                if not (err <= bound and inv_err <= 2.0**-20 and launched == 1):
                    fail(f"gs_rmsnorm {name} ({rows}, {d}) offset {offset} p={p} {variant}: "
                         f"y {err}, rsqrt column {inv_err}, {launched} launches")
                worst = max(worst, err)
    return worst


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
            got = flash_kernel.flash_attention(q, k, v, **kw)
            want = ref.attention(q, k, v, **kw)
            err = (got.float() - want.float()).abs().max().item()
            print(f"  flash_attention {name} (1, 32, {s}, 64) causal p={p} "
                  f"iters={iters}: max|err| {err:.3e} (bound {bound:.3e})")
            if not err <= bound:
                fail(f"flash_attention {name} S={s}: {err}")
            worst["flash_attention"] = max(worst["flash_attention"], err)
            if dtype == torch.float32 and s in (333, 512):
                # the forward's products are three TF32 passes
                oracle = ref.attention(q.double(), k.double(), v.double(), **kw)
                check_against_f64(f"{tuple(q.shape)} float32", ("out",), (got,), (want,),
                                  (oracle,))
    worst["gs_rmsnorm"] = max(worst["gs_rmsnorm"], check_rmsnorm_plans(g))
    torch.cuda.synchronize()
    return worst


def rel_err(got, want) -> float:
    """Max error over the plain version's largest element."""
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max()).item()


def check_against_f64(label: str, names, got, want, oracle) -> None:
    """Each of the flash kernels' outputs ``got`` and the plain version's
    ``want`` against the plain version run in f64: the kernels' max |error|
    at most ORACLE_FACTOR x the plain version's.  Their products are TF32
    passes split hi/lo; a single pass on f32 data keeps about 11 bits and
    would not be within it."""
    for name, a, b, o in zip(names, got, want, oracle):
        k_err = (a.double() - o).abs().max().item()
        p_err = (b.double() - o).abs().max().item()
        print(f"    f64 oracle {name} {label}: kernel max|err| {k_err:.3e}, plain "
              f"f32 {p_err:.3e} (ratio {k_err / p_err:.2f}, limit {ORACLE_FACTOR})")
        if not k_err <= ORACLE_FACTOR * p_err:
            fail(f"flash {name} {label}: {k_err} against the f64 oracle, "
                 f"plain f32 {p_err}")


def check_bwd_against_f64(q, k, v, do, out, m, l, got, want, kw) -> None:
    """f32 inputs: dq, dk, dv (three TF32 passes in every product)."""
    from repro_torch.kernels import ref

    oracle = ref.attention_bwd(q.double(), k.double(), v.double(), do, out, m, l, **kw)
    check_against_f64(f"{tuple(q.shape)} float32", ("dq", "dk", "dv"), got, want, oracle)


def check_dkv_against_f64(q, k, v, do, out, m, l, kw) -> None:
    """bf16 inputs: the dk/dv kernel's own f32 per-q-head dk, dv, before the
    GQA group-sum and the cast to bf16.  Its products with the f32 p and ds
    are two TF32 passes (the bf16 operand is exact in TF32); k and v are
    repeated per q head so that the plain version's dk, dv are per q head."""
    from repro_torch.kernels import flash_attention_bwd as bwd_kernel
    from repro_torch.kernels import ref

    group = q.shape[1] // k.shape[1]
    ke, ve = (t.repeat_interleave(group, dim=1) for t in (k, v))
    delta = torch.sum(do.float() * out.float(), dim=-1)
    got = bwd_kernel.dkv(q, k, v, do, m, l, delta, sm_scale=1.0 / math.sqrt(q.shape[-1]),
                         **kw)
    want = ref.attention_bwd(q, ke.float(), ve.float(), do, out, m, l, **kw)[1:]
    oracle = ref.attention_bwd(q.double(), ke.double(), ve.double(), do, out, m, l, **kw)[1:]
    check_against_f64(f"{tuple(q.shape)} bfloat16, per q head", ("dk", "dv"), got, want,
                      oracle)


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
            if dtype == torch.float32:
                check_bwd_against_f64(q, k, v, do, out, m, l, got, want, kw)
            else:
                check_dkv_against_f64(q, k, v, do, out, m, l, kw)
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


# C8: the flash kernels' NaN classes.  Each special value sits in the last q
# row of its own head, which every key reaches, so the causal mask and the
# kernels' tile skipping meet the same keys as the plain version; head 3
# stays finite.  (case, column, value): a NaN, a +inf (its TF32 lo part is
# inf - inf = NaN, so its scores are NaN) and a value whose scores overflow
# to +inf and -inf.  Neither mask can leave a row with every score at -inf:
# the causal mask keeps the diagonal, the length mask only keys past S.
FLASH_SPECIAL_ROWS = (("nan", 3, float("nan")), ("+inf", 5, float("inf")),
                      ("overflow", 7, 3e38))


def classes(t) -> tuple:
    """The (NaN, +inf, -inf) masks of ``t``."""
    return torch.isnan(t), torch.isposinf(t), torch.isneginf(t)


def flash_nan_classes(causal: bool, s: int = 70, device: str = "cuda") -> dict:
    """The flash forward (with and without its (m, l) residuals) and the
    backward pair at (1, 4, s, 64) / (1, 2, s, 64) f32 on
    ``FLASH_SPECIAL_ROWS``, each side's backward on its own forward's
    residuals, against the plain versions with the kernels' three TF32
    passes emulated (``ref.split_matmul``).  Returns {tensor: (classes
    equal, the kernel's (NaN, +inf, -inf) counts, the plain version's)}."""
    from repro_torch.kernels import flash_attention as flash_kernel
    from repro_torch.kernels import flash_attention_bwd as bwd_kernel
    from repro_torch.kernels import ref

    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(8)
    q, do = (torch.randn(1, 4, s, 64, generator=g, device=dev) for _ in range(2))
    k, v = (torch.randn(1, 2, s, 64, generator=g, device=dev) for _ in range(2))
    for head, (_, col, val) in enumerate(FLASH_SPECIAL_ROWS):
        q[0, head, s - 1, col] = val
    kw = dict(causal=causal, p=7, iters=2, variant="feedback")

    def split(equation, a, b):
        return ref.split_matmul(a, b, 3, equation)

    out, m, l = flash_kernel.flash_attention(q, k, v, residuals=True, **kw)
    got = {"out": flash_kernel.flash_attention(q, k, v, **kw), "out (residuals)": out,
           "m": m, "l": l}
    got.update(zip(("dq", "dk", "dv"), bwd_kernel.flash_attention_bwd(q, k, v, do, out, m, l,
                                                                      **kw)))
    out, m, l = ref.attention(q, k, v, residuals=True, product=split, **kw)
    want = {"out": out, "out (residuals)": out, "m": m, "l": l}
    want.update(zip(("dq", "dk", "dv"), ref.attention_bwd(q, k, v, do, out, m, l,
                                                          product=split, **kw)))
    result = {}
    for name, a in got.items():
        ca, cb = classes(a), classes(want[name])
        result[name] = (all(bool(torch.equal(x, y)) for x, y in zip(ca, cb)),
                        [int(x.sum()) for x in ca], [int(y.sum()) for y in cb])
    return result


def check_flash_nan_classes() -> None:
    """Phase 2's C8 check: every tensor's NaN, +inf and -inf in the same
    places as the plain version's, causal and not."""
    for causal in (True, False):
        result = flash_nan_classes(causal)
        print(f"  flash NaN classes, causal={causal} (kernel (NaN, +inf, -inf) counts vs "
              f"plain): " + "; ".join(f"{name} {'equal' if ok else 'DIFFER'} {a} / {b}"
                                      for name, (ok, a, b) in result.items()))
        bad = [name for name, (ok, _, _) in result.items() if not ok]
        if bad:
            fail(f"flash kernels, causal={causal}: NaN classes differ from the plain "
                 f"versions' in {bad}")


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


def near_tie_flips(cfg, params, reqs, res, want_tokens, got_name: str, want_name: str):
    """Phase 3's rule: ``res``'s tokens equal ``want_tokens`` (rid -> tokens)
    but where the greedy step that first differs is a near-tie (its top-2
    probability gap below ``NEAR_TIE``); fails otherwise.  Returns the
    excused (rid, step, gap) flips."""
    flips = []
    for r in reqs:
        got, want = res[r.rid].tokens, want_tokens[r.rid]
        if np.array_equal(got, want):
            continue
        n = min(len(got), len(want))
        t = int(np.argmax(got[:n] != want[:n])) if np.any(got[:n] != want[:n]) else n
        gap = top2_gap(cfg, params, r.prompt, want[:t])
        print(f"  req {r.rid}: {got_name} and {want_name} differ from step {t}, top-2 "
              f"probability gap {gap:.3e}")
        if not gap < NEAR_TIE:
            fail(f"req {r.rid}: {got_name} tokens {got.tolist()} != {want_name} "
                 f"{want.tolist()} (gap {gap:.3e} is no near-tie)")
        flips.append((r.rid, t, gap))
    return flips


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
    # prefills run: each admission, a preempted request's replay included,
    # less the exact prefix hits, which skip theirs
    prefills = m.first_tokens + m.preempted - m.prefill_skips
    want = {name: 0 for name in counts}  # the training kernels, the other norm: none
    want.update({norm: (2 * n_layers + 1) * (prefills + m.decode_ticks),
                 "flash_attention": n_layers * prefills})
    print(f"  launches {counts}; expected {want} "
          f"({prefills} prefills, {m.decode_ticks} decode ticks)")
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
    flips = near_tie_flips(cfg, params, reqs, res, seq, "engine", "sequential")
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
    serve_stats["cache_bytes"] = m.cache_bytes
    del engine
    torch.cuda.empty_cache()
    slot_tokens = {r.rid: res[r.rid].tokens for r in reqs}
    return counts, serve_stats, seq, (cfg, params, slot_tokens)


# -- phase 3b ------------------------------------------------------------------

PAGE_SIZE = 16
TIGHT_EXTRA_PAGES = 8  # (b): the arena holds one s_max request and this many pages more
SHARED_COPIES = (3, 5, 7)  # (c): these requests take request 0's prompt
# preempt_after_ticks past any run's length: the engine then preempts only
# when the arena cannot back a decode write.  With the default 3, a head of
# line that waits 3 ticks for a free slot preempts the youngest request too
# (the reference's rule, ROADMAP C10), which changes the schedule
NO_STALL_PREEMPT = 10**9


def paged_run(engine, reqs, n_layers: int, label: str, fixed: bool = False):
    """One counted run through a paged engine (``serve_run``'s launch
    counts), its pool's stats printed; at the end every slot is free, and
    once the prefix index is cleared no page is in use and every refcount
    but the trash page's is 0."""
    pools = []
    make = engine._make_pool

    def kept():
        pools.append(make())
        return pools[-1]

    engine._make_pool = kept
    try:
        res, counts = serve_run(engine, reqs, n_layers, fixed=fixed)
    finally:
        del engine._make_pool
    st = res.metrics.pool
    print(f"  {label}: preempted {res.metrics.preempted}, prefill tokens "
          f"{res.metrics.prefill_tokens}; pool stats {json.dumps(st)}")
    pool = pools[-1]
    pool.clear_prefix()
    if st["free_slots"] != st["n_slots"] or pool.pages_in_use or pool.ref[0] != 1 or \
            pool.ref[1:].any():
        fail(f"{label}: {st['free_slots']} of {st['n_slots']} slots free; with the prefix "
             f"index cleared {pool.pages_in_use} pages in use, refcounts "
             f"{np.flatnonzero(pool.ref).tolist()} nonzero")
    return res, counts


def serve_paged(seed: int, served, seq, slot_stats):
    """Phase 3b: phase 3's parameters and trace through the paged pool (page
    size 16): (a) the default arena, prefix sharing off, against the slot
    engine's and generate_sequential's tokens; (b) an arena of one s_max
    request and ``TIGHT_EXTRA_PAGES`` pages more, where decode-time appends
    run out and the youngest request is preempted and replayed; (c) the
    trace with requests ``SHARED_COPIES`` on request 0's prompt under
    prefix="exact", which skips their prefills and copies the boundary page.
    Every run ends with no page held but by the prefix index
    (``paged_run``)."""
    import dataclasses

    from repro_torch.serving import Engine, EngineConfig, Request

    cfg, params, slot_tokens = served
    reqs = trace(cfg.vocab, seed)
    s_max = max(PROMPTS) + GEN
    base = EngineConfig(n_slots=N_SLOTS, s_max=s_max, pool="paged", page_size=PAGE_SIZE,
                        prefix="off")
    engine = Engine(cfg, params, base)
    engine.run([Request(rid=0, prompt=reqs[0].prompt, max_new_tokens=2)])  # warm-up
    res, counts = paged_run(engine, reqs, cfg.n_layers, "(a) default arena")
    flips = near_tie_flips(cfg, params, reqs, res, slot_tokens, "paged", "slot engine")
    flips += near_tie_flips(cfg, params, reqs, res, seq, "paged", "sequential")
    m = res.metrics
    ttft = float(np.median(list(m.ttft_s.values())) * 1e3)
    print(f"  (a) float32 paged Engine.run == slot engine == generate_sequential on "
          f"{len(reqs)} requests ({len(flips)} near-tie flips); TTFT median {ttft:.1f} ms "
          f"(slot, phase 3: {slot_stats['ttft_ms_median']:.1f}), decode "
          f"{m.decode_tok_per_s:.1f} tok/s (slot: {slot_stats['decode_tok_per_s']:.1f}) over "
          f"{m.decode_ticks} ticks; arena {m.cache_bytes / 1e9:.4f} GB "
          f"({m.pool['n_pages']} pages of {PAGE_SIZE}) against the slot pool's "
          f"{slot_stats['cache_bytes'] / 1e9:.4f} GB; peak {m.pool['peak_pages_in_use']} "
          f"pages in use ({m.pool['peak_pages_in_use'] * m.cache_bytes / m.pool['n_pages'] / 1e9:.4f} GB)")
    stats = {"ttft_ms_median": ttft, "decode_tok_per_s": m.decode_tok_per_s,
             "preempted": m.preempted, "prefill_tokens": m.prefill_tokens,
             "arena_bytes": m.cache_bytes, "slot_cache_bytes": slot_stats["cache_bytes"],
             "flips": flips, "pool": m.pool}
    # the same run with stall preemption off, beside the slot engine run again
    # in the same warm state: the paged indirection alone
    calm = Engine(cfg, params, dataclasses.replace(base, preempt_after_ticks=NO_STALL_PREEMPT))
    res_n, _ = paged_run(calm, reqs, cfg.n_layers, "(a) without stall preemption")
    near_tie_flips(cfg, params, reqs, res_n, slot_tokens, "paged", "slot engine")
    slot_again = Engine(cfg, params, EngineConfig(n_slots=N_SLOTS, s_max=s_max)).run(reqs)
    mn, ms = res_n.metrics, slot_again.metrics
    med = lambda m: float(np.median(list(m.ttft_s.values())) * 1e3)  # noqa: E731
    print(f"  (a) without stall preemption: {mn.preempted} preemptions, TTFT median "
          f"{med(mn):.1f} ms, decode {mn.decode_tok_per_s:.1f} tok/s over {mn.decode_ticks} "
          f"ticks; the slot engine again: TTFT median {med(ms):.1f} ms, decode "
          f"{ms.decode_tok_per_s:.1f} tok/s over {ms.decode_ticks} ticks")
    stats["no_stall_preempt"] = {"ttft_ms_median": med(mn),
                                 "decode_tok_per_s": mn.decode_tok_per_s,
                                 "decode_ticks": mn.decode_ticks, "preempted": mn.preempted,
                                 "slot_ttft_ms_median": med(ms),
                                 "slot_decode_tok_per_s": ms.decode_tok_per_s,
                                 "slot_decode_ticks": ms.decode_ticks}

    pages_per_slot = -(-s_max // PAGE_SIZE)
    tight = Engine(cfg, params, dataclasses.replace(
        base, n_pages=pages_per_slot + 1 + TIGHT_EXTRA_PAGES))
    res_b, _ = paged_run(tight, reqs, cfg.n_layers, "(b) tight arena")
    near_tie_flips(cfg, params, reqs, res_b, seq, "tight-arena paged", "sequential")
    mb = res_b.metrics
    if not (mb.preempted >= 1 and mb.pool["appended_pages"] >= 1):
        fail(f"(b): preempted {mb.preempted}, pool {mb.pool}: the tight arena must preempt "
             f"at least once and append at least one page")
    print(f"  (b) tight arena, {tight.ecfg.n_pages} pages: tokens == generate_sequential, "
          f"{mb.preempted} preemptions, {mb.pool['appended_pages']} pages appended, "
          f"{mb.prefill_tokens} prefill tokens (the trace's {sum(PROMPTS)} plus the replays), "
          f"decode {mb.decode_tok_per_s:.1f} tok/s")
    stats["tight"] = {"n_pages": tight.ecfg.n_pages, "preempted": mb.preempted,
                      "pool": mb.pool, "decode_tok_per_s": mb.decode_tok_per_s}

    shared = [Request(rid=r.rid, prompt=reqs[0].prompt if r.rid in SHARED_COPIES else r.prompt,
                      max_new_tokens=GEN, arrival_time=r.arrival_time) for r in reqs]
    seq_c = {r.rid: seq[0] if r.rid in SHARED_COPIES else seq[r.rid] for r in shared}
    exact = Engine(cfg, params, dataclasses.replace(base, prefix="exact"))
    res_c, _ = paged_run(exact, shared, cfg.n_layers, "(c) shared prompts")
    near_tie_flips(cfg, params, shared, res_c, seq_c, "prefix-sharing paged", "sequential")
    mc = res_c.metrics
    if not (mc.prefill_skips >= 1 and mc.pool["cow_copies"] >= 1):
        fail(f"(c): prefill_skips {mc.prefill_skips}, pool {mc.pool}: the shared prompt "
             f"must skip a prefill and copy its boundary page")
    print(f"  (c) prefix=exact, requests {SHARED_COPIES} on request 0's prompt: tokens == "
          f"generate_sequential, {mc.prefill_skips} prefills skipped, {mc.prefix_hits} hits "
          f"covering {mc.prefix_hit_tokens} tokens, {mc.pool['cow_copies']} pages copied on "
          f"write, TTFT median {np.median(list(mc.ttft_s.values())) * 1e3:.1f} ms")
    stats["shared"] = {"prefill_skips": mc.prefill_skips, "pool": mc.pool}
    del engine, calm, tight, exact
    torch.cuda.empty_cache()
    return counts, stats


# -- phase 4 -------------------------------------------------------------------


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# phase 4's gs_rmsnorm rows: (label, rows, dtype, (p, iters, variant),
# save_inv, on copies cycled past the L2): the decode tick (N_SLOTS rows),
# the longest prefill at f32, bf16 and p 12, and the training step's
# batch 4 x 512 with the rsqrt column, at d 2048
RMSNORM_TIMED = (("decode", N_SLOTS, "float32", (7, 2, "feedback"), False, False),
                 ("prefill", max(PROMPTS), "float32", (7, 2, "feedback"), False, False),
                 ("prefill bf16", max(PROMPTS), "bfloat16", (8, 0, "feedback"), False, False),
                 ("prefill p12", max(PROMPTS), "float32", (12, 1, "pipelined"), False, False),
                 ("train", 2048, "float32", (7, 2, "feedback"), True, True),
                 ("train bf16", 2048, "bfloat16", (8, 0, "feedback"), True, True))


def time_rmsnorm():
    """gs_rmsnorm at the main paths' shapes (``RMSNORM_TIMED``), eps 1e-5,
    after a second of load, beside its plain version and ``F.rms_norm`` x
    gain (gain cast to x's dtype at bf16): per call (``cuda_ms``), and device
    time queued back to back (``queued_ms``) for the kernel and the library
    call; the decode and f32 prefill rows also by the profiler.  The
    training rows take each call on the next of copies cycled past the L2
    (``L2Ring``), so they read device memory; the others run on one input,
    which the L2 holds."""
    import torch.nn.functional as F

    from repro_torch.kernels import gs_rmsnorm as rms_kernel
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    d, eps = 2048, 1e-5
    gain = 1 + 0.1 * torch.randn(d, generator=g, device=dev)
    rows = {}
    under_load()
    for label, n_rows, dtype_name, (p, iters, variant), save_inv, cycled in RMSNORM_TIMED:
        dtype = getattr(torch, dtype_name)
        x = (3 * torch.randn(n_rows, d, generator=g, device=dev)).to(dtype)
        kw = dict(eps=eps, p=p, iters=iters, variant=variant, save_inv=save_inv)
        kern = lambda x, kw=kw: rms_kernel.gs_rmsnorm(x, gain, **kw)  # noqa: E731
        plain = lambda x, kw=kw: ref.rmsnorm(x, gain, **kw)  # noqa: E731
        lib = lambda x, w=gain.to(dtype): F.rms_norm(x, (d,), weight=w, eps=eps)  # noqa: E731
        nbytes = 2 * n_rows * d * x.element_size() + 4 * d + (4 * n_rows if save_inv else 0)
        b, by = bound_ms(nbytes, 4 * n_rows * d, "float32")
        shape = f"({n_rows}, {d}) {dtype_name} p={p} iters={iters} {variant}"
        if save_inv:
            shape += " save_inv"
        if cycled:
            ring = L2Ring(x, nbytes)
            kern, plain, lib = (ring.calls(f) for f in (kern, plain, lib))
            shape += f", {len(ring.xs)} copies cycled"
        else:
            kern, plain, lib = ((lambda f=f: f(x)) for f in (kern, plain, lib))
        profile = label in ("decode", "prefill")
        rows[("gs_rmsnorm", label)] = dict(
            ms=cuda_ms(kern, 200), plain_ms=cuda_ms(plain, 20), library_ms=cuda_ms(lib, 200),
            bound_ms=b, bound_by=by,
            device_ms=[device_ms(f, 50) if profile else None for f in (kern, plain, lib)],
            queued_ms=[queued_ms(f, 50) for f in (kern, lib)], shape=shape)
    us = lambda v: "not measured" if v is None else f"{v * 1e3:.2f} us"  # noqa: E731
    for (_, label), r in rows.items():
        q_kern, q_lib = r["queued_ms"]
        print(f"  gs_rmsnorm {label} {r['shape']}: queued back to back (CUDA events) kernel "
              f"{us(q_kern)}, F.rms_norm {us(q_lib)} ({q_kern / q_lib:.3f}x), "
              f"{r['bound_ms'] / q_kern:.1%} of the bound {r['bound_ms'] * 1e3:.3f} us "
              f"({r['bound_by']}); per call (CUDA events, back to back) kernel "
              f"{us(r['ms'])}, plain {us(r['plain_ms'])}, F.rms_norm {us(r['library_ms'])}; "
              f"device time (profiler) kernel {us(r['device_ms'][0])}, plain "
              f"{us(r['device_ms'][1])}, F.rms_norm {us(r['device_ms'][2])}")
    return rows


def time_kernels():
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as flash_kernel
    from repro_torch.kernels import ref

    with SampledClocks() as clocks:
        rms_rows = time_rmsnorm()
    print(f"  gs_rmsnorm clocks (nvidia-smi every 100 ms): {json.dumps(clocks.summary())}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    rows = {}
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
        nbytes, flops = (2 * h + 2 * kh) * s * hd * q.element_size(), 4 * h * hd * pairs
        # f32: the kernel's products run as three TF32 tensor-core passes
        b, by = bound_ms(nbytes, flops, "tf32x3" if name == "float32" else name)
        rows[("flash_attention", name)] = dict(ms=t, plain_ms=t_plain, library_ms=t_lib,
                                               bound_ms=b, bound_by=by, device_ms=dev_ms,
                                               shape=f"(1, {h}, {s}, {hd}) {name}")
        flash_vs_sdpa(f"(1, {h}, {s}, {hd}) {name}", nbytes, flops, name, dev_ms[0],
                      dev_ms[2])
    us = lambda v: "not measured" if v is None else f"{v * 1e3:.1f} us"  # noqa: E731
    for (kname, label), r in rows.items():
        print(f"  {kname} {label} {r['shape']}: per call (CUDA events, back to back) "
              f"kernel {us(r['ms'])}, plain {us(r['plain_ms'])}, library "
              f"{us(r['library_ms'])}; device time (profiler) kernel "
              f"{us(r['device_ms'][0])}, plain {us(r['device_ms'][1])}, library "
              f"{us(r['device_ms'][2])}; bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")
    return {**rms_rows, **rows}


def flash_vs_sdpa(label: str, nbytes: float, flops: float, dtype: str, kernel_ms,
                  sdpa_ms) -> None:
    """The flash forward's bounds (3xTF32 tensor cores and fp32 FMA pipes at
    f32, the bf16 tensor-core rate at bf16) and its device time over SDPA's."""
    us = lambda x: "not measured" if x is None else f"{x * 1e3:.1f} us"  # noqa: E731
    if dtype == "float32":
        tc, by = bound_ms(nbytes, flops, "tf32x3")
        fma, _ = bound_ms(nbytes, flops, "float32")
        bounds = (f"bound {tc * 1e3:.2f} us ({by}, 3xTF32 tensor cores at 495/3 TFLOP/s), "
                  f"{fma * 1e3:.2f} us on the fp32 FMA pipes (67 TFLOP/s)")
    else:
        tc, by = bound_ms(nbytes, flops, dtype)
        bounds = f"bound {tc * 1e3:.2f} us ({by}, bf16 tensor cores at 989 TFLOP/s)"
    ratio = "not measured" if None in (kernel_ms, sdpa_ms) else f"{kernel_ms / sdpa_ms:.3f}"
    print(f"  flash forward {label}: {bounds}; device time {us(kernel_ms)}, SDPA forward "
          f"{us(sdpa_ms)}, flash / SDPA {ratio}")


def time_training_kernels():
    """The training path's kernels at its full-width shapes: the flash
    backward, and the forward with residuals beside SDPA forward, at
    (4, 32, 512, 64) / (4, 4, 512, 64) f32, causal, and gs_adam on the
    embedding leaf (32000 x 2048)."""
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
    sdpa_fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, ke.detach(), ve.detach(), is_causal=True)
    t = {name: cuda_ms(fn, n) for name, fn, n in (
        ("dq", dq_call, 10), ("dkv", dkv_call, 10), ("plain", plain, 3), ("lib", lib, 10),
        ("fwd", fwd, 10), ("sdpa_fwd", sdpa_fwd, 10))}
    dev_ms = {name: device_ms(fn, 5) for name, fn in (
        ("dq", dq_call), ("dkv", dkv_call), ("plain", plain), ("lib", lib), ("fwd", fwd),
        ("sdpa_fwd", sdpa_fwd))}
    pairs = s * (s + 1) // 2  # causal (query, key) pairs this input needs
    mm = 2 * b * h * hd * pairs  # flops of one S x S x D product over these pairs
    elt = 4
    in_bytes = (2 * b * h + 2 * b * kh) * s * hd * elt + 3 * b * h * s * 4
    us = lambda x: "not measured" if x is None else f"{x * 1e3:.1f} us"  # noqa: E731
    for name, n_mm, out_bytes in (("dq", 3, b * h * s * hd * elt),
                                  ("dkv", 4, 2 * b * h * s * hd * 4)):
        # the kernels' products run as three TF32 tensor-core passes
        bound, by = bound_ms(in_bytes + out_bytes, n_mm * mm, "tf32x3")
        fma_bound, _ = bound_ms(in_bytes + out_bytes, n_mm * mm, "float32")
        rows[("flash_attention_bwd_" + name, "float32")] = dict(
            ms=t[name], plain_ms=t["plain"], library_ms=t["lib"], bound_ms=bound,
            bound_by=by, device_ms=[dev_ms[name], dev_ms["plain"], dev_ms["lib"]],
            shape=f"({b}, {h}, {s}, {hd}) float32 causal")
        print(f"  flash_attention_bwd_{name}: bound {bound * 1e3:.2f} us ({by}, 3xTF32 "
              f"tensor cores at 495/3 TFLOP/s), {fma_bound * 1e3:.2f} us on the fp32 FMA "
              f"pipes (67 TFLOP/s); kernel {us(dev_ms[name])} device time")
    pair_bound, _ = bound_ms(in_bytes + 3 * b * h * s * hd * 4, 5 * mm, "tf32x3")
    print(f"  flash forward with residuals ({b}, {h}, {s}, {hd}) f32: {us(t['fwd'])} per "
          f"call, SDPA forward {us(t['sdpa_fwd'])} per call")
    flash_vs_sdpa(f"with residuals ({b}, {h}, {s}, {hd}) float32",
                  (2 * b * h + 2 * b * kh) * s * hd * elt + 2 * b * h * s * 4, 2 * mm,
                  "float32", dev_ms["fwd"], dev_ms["sdpa_fwd"])
    print(f"  flash backward pair (dq + dk/dv) {(t['dq'] + t['dkv']) * 1e3:.1f} us against "
          f"the backward's 3xTF32 bound {pair_bound * 1e3:.2f} us (2.5x the forward's "
          f"matmul flops); SDPA backward {t['lib'] * 1e3:.1f} us (it computes dq, dk and dv "
          f"in one call)")
    if None not in (dev_ms["dq"], dev_ms["dkv"], dev_ms["lib"]):
        print(f"  flash backward pair / SDPA backward, device time: "
              f"{(dev_ms['dq'] + dev_ms['dkv']) / dev_ms['lib']:.3f} "
              f"({us(dev_ms['dq'] + dev_ms['dkv'])} / {us(dev_ms['lib'])})")
    print(f"  SDPA backward's kernels by device time: {top_kernels(lib)}")

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


def time_flash() -> dict:
    """The three flash kernels queued back to back (``queued_ms``) at the
    main paths' shapes, beside SDPA's forward and backward: the prefill
    forward at (1, 32, 333, 64) / (1, 4, 333, 64) f32 and bf16, and at the
    training shape (4, 32, 512, 64) / (4, 4, 512, 64) f32 the forward with
    residuals, dq and dk/dv, all causal."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as flash_kernel
    from repro_torch.kernels import flash_attention_bwd as bwd_kernel

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    rows = {}
    under_load()
    h, kh, hd = 32, 4, 64
    for b, s, dtype, (p, iters) in ((1, max(PROMPTS), torch.float32, (7, 2)),
                                    (1, max(PROMPTS), torch.bfloat16, (8, 0)),
                                    (4, 512, torch.float32, (7, 2))):
        q, do = (torch.randn(b, h, s, hd, generator=g, device=dev).to(dtype) for _ in range(2))
        k, v = (torch.randn(b, kh, s, hd, generator=g, device=dev).to(dtype)
                for _ in range(2))
        kw = dict(causal=True, sm_scale=hd**-0.5, p=p, iters=iters, variant="feedback")
        ke, ve = k.repeat_interleave(h // kh, dim=1), v.repeat_interleave(h // kh, dim=1)
        name = str(dtype).split(".")[-1]
        shape = f"({b}, {h}, {s}, {hd}) {name}"
        sdpa = lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True)  # noqa: E731
        if b == 1:
            fwd = lambda: flash_kernel.flash_attention(q, k, v, **kw)  # noqa: E731
            rows[("flash_attention", name)] = dict(
                shape=shape, queued_ms=queued_ms(fwd, 50), sdpa_queued_ms=queued_ms(sdpa, 50))
            continue
        out, m, l = flash_kernel.flash_attention(q, k, v, residuals=True, **kw)
        delta = torch.sum(do * out, dim=-1)
        fwd = lambda: flash_kernel.flash_attention(q, k, v, residuals=True, **kw)  # noqa: E731
        rows[("flash_attention", "residuals")] = dict(
            shape=shape, queued_ms=queued_ms(fwd, 20), sdpa_queued_ms=queued_ms(sdpa, 20))
        rows[("flash_attention_bwd_dq", name)] = dict(
            shape=shape, queued_ms=queued_ms(lambda: bwd_kernel.dq(q, k, v, do, m, l, delta,
                                                                   **kw), 20))
        rows[("flash_attention_bwd_dkv", name)] = dict(
            shape=shape, queued_ms=queued_ms(lambda: bwd_kernel.dkv(q, k, v, do, m, l, delta,
                                                                    **kw), 20))
    for (kname, label), r in rows.items():
        lib = (f", SDPA forward {r['sdpa_queued_ms'] * 1e3:.2f} us"
               if "sdpa_queued_ms" in r else "")
        print(f"  {kname} {label} {r['shape']} causal: queued back to back (CUDA events) "
              f"{r['queued_ms'] * 1e3:.2f} us{lib}")
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


def fixed_rmsnorm_oracle_error(x: np.ndarray, scale: float, gain: np.ndarray, out) -> float:
    """bench_kernels.py's rmsnorm error against an f64 oracle (eps 1e-6),
    over the largest element."""
    xf = x.astype(np.float64) * scale
    rn = xf / np.sqrt(np.mean(xf * xf, axis=-1, keepdims=True) + 1e-6) * gain
    return float(np.max(np.abs(out.double().cpu().numpy() - rn)) / np.max(np.abs(rn)))


def fixed_oracle_errors(x: np.ndarray, scale: float, gain: np.ndarray, outs):
    """bench_kernels.py's errors against an f64 oracle: recip relative,
    softmax absolute, rmsnorm over the largest element (eps 1e-6)."""
    xf = x.astype(np.float64) * scale
    e = np.exp(xf - xf.max(-1, keepdims=True))
    recip, softmax = (o.double().cpu().numpy() for o in outs[:2])
    return {"gs_fixed_recip": float(np.max(np.abs(recip - 1.0 / xf) * np.abs(xf))),
            "gs_fixed_softmax": float(np.max(np.abs(softmax - e / e.sum(-1, keepdims=True)))),
            "gs_fixed_rmsnorm": fixed_rmsnorm_oracle_error(x, scale, gain, outs[2])}


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


# gs_fixed_rmsnorm's launch plans on the card, beside check_fixed_kernels'
# shapes: (rows, d, storage offset, special rows) — rows 1 to the 2048-token
# prefill at d 2048 (16-byte vectors, one a thread), d 37 and 200 (single
# codes; narrow rows several a block), 8192 (two vectors a thread), 16400
# and 4097 past the register plans (the looping instances), a view one byte
# into its storage (single codes), and a row of zeros (ss = 0, so ms = eps)
# beside a row of ±127 (the largest ss)
FIXED_RMSNORM_SHAPES = ((1, 2048, 0, False), (4, 2048, 0, True), (333, 2048, 0, False),
                        (2048, 2048, 0, False), (5, 37, 0, False), (13, 200, 0, False),
                        (3, 8192, 0, False), (2, 16400, 0, True), (2, 4097, 0, False),
                        (33, 2048, 1, True))


def check_fixed_rmsnorm_plans() -> float:
    """gs_fixed_rmsnorm on ``FIXED_RMSNORM_SHAPES`` in the three formats of
    ``fixed_formats()`` and at p 12: bit-equal to the plain version, one
    launch a call, and within FIXED_MARGIN x the format's bound of the f64
    oracle; returns the worst |kernel - plain|."""
    from repro_torch.core import formats
    from repro_torch.kernels import gs_fixed as fixed_kernel
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    scale = torch.tensor(0.02, device=dev)
    fmts = fixed_formats() + (("p12", formats.NumericFormat.fixed(24, p=12)),)
    worst = 0.0
    for i, (rows, d, offset, special) in enumerate(FIXED_RMSNORM_SHAPES):
        rng = np.random.RandomState(100 + i)
        buf_np = rng.randint(-127, 128, rows * d + offset).astype(np.int8)
        x_np = buf_np[offset:].reshape(rows, d)
        if special:
            x_np[0] = 0
            x_np[-1] = np.where(np.arange(d) % 3 == 0, -127, 127)
        gain_np = rng.randn(d).astype(np.float32)
        x = torch.from_numpy(buf_np).to(dev)[offset:].view(rows, d)
        gain = torch.from_numpy(gain_np).to(dev)
        plan = fixed_kernel.launch_plan(d, (x.data_ptr() | gain.data_ptr()) % 16)
        for fname, fmt in fmts:
            rkw = dict(eps=1e-6, p=fmt.p, frac_bits=fmt.frac_bits, iters=fmt.iters)
            bound = FIXED_MARGIN * fmt.error_bound()
            before = fixed_kernel.launches_rmsnorm
            got = fixed_kernel.gs_fixed_rmsnorm(x, scale, gain, **rkw)
            launched = fixed_kernel.launches_rmsnorm - before
            want = ref.fixed_rmsnorm(x, scale, gain, **rkw)
            err = (got - want).abs().max().item()
            oracle = fixed_rmsnorm_oracle_error(x_np, 0.02, gain_np, got)
            print(f"  gs_fixed_rmsnorm ({rows}, {d}) offset {offset}"
                  f"{' zero and ±127 rows' if special else ''} {plan} {fname}: "
                  f"max|kernel - plain| {err:.3e}, vs the f64 oracle {oracle:.3e} "
                  f"(bound {bound:.3e})")
            if not (torch.equal(got, want) and launched == 1 and oracle <= bound):
                fail(f"gs_fixed_rmsnorm ({rows}, {d}) offset {offset} {fname}: kernel vs "
                     f"plain {err}, bit-equal {torch.equal(got, want)}, oracle {oracle} "
                     f"(bound {bound}), {launched} launches")
            worst = max(worst, err)
    torch.cuda.synchronize()
    return worst


# gs_fixed_softmax's launch plans on the card: (rows, d, storage offset,
# special rows, packed) — d 128 (a warp a row, a word of four codes a lane)
# at the benchmark's 256 rows and at 4096, the packed plans (eight words in
# each of 4 lanes, eight rows a warp, at d 128; eight words or single codes
# in each of 8 lanes at d 200 and 37), d 64 (half-warp segments, two rows a
# warp), d 1 (a lane a row), 37 (single codes), 200 (two words a lane), 1024
# (eight), 4096 and 4100 (rows of four and five warps), 2049 (single codes,
# nine warps), 16400 and 4097 past the register plans (the looping
# instances), views one byte (single codes) and four bytes (words) into
# their storage, and a row of one repeated code (its e all 1, s = d) beside
# a row holding its max and min twice.  A packed case runs on a grid of one
# block (``one_block_grid``): its rows then fill the wave, so the wrapper
# packs, and the block walks every row.  No case holds thousands of rows
# more: there a one-ulp difference between the kernel's row sum and torch's
# crosses a ROM bucket boundary in some row, and a seed-only format then
# moves that row by ~2^-8, past SOFTMAX_PLAIN_RTOL (on an H100 it did at
# (20000, 37), scale -0.02; PERF.md), while both stay within the oracle's
# gate.
FIXED_SOFTMAX_SHAPES = ((256, 128, 0, True, False), (4096, 128, 0, False, False),
                        (256, 128, 0, True, True), (64, 200, 0, False, True),
                        (333, 37, 0, True, True), (9, 64, 0, True, False),
                        (33, 1, 0, False, False), (7, 37, 0, True, False),
                        (37, 200, 0, False, False), (6, 1024, 0, False, False),
                        (5, 4096, 0, True, False), (3, 4100, 0, False, False),
                        (3, 2049, 0, False, False), (2, 16400, 0, True, False),
                        (2, 4097, 0, False, False), (33, 128, 1, True, False),
                        (33, 128, 4, False, False))


@contextlib.contextmanager
def one_block_grid(fixed_kernel):
    """Within the block, ``gs_fixed`` sees one SM holding one block: a grid
    of one block, and the packed plan for any rows that fill it."""
    saved = fixed_kernel.grid_limits
    fixed_kernel.grid_limits = lambda device, plan, kernel="rmsnorm": (1, 1)
    try:
        yield
    finally:
        fixed_kernel.grid_limits = saved


def special_softmax_rows(x: np.ndarray) -> None:
    """Row 0 one repeated code; the last row holding its max and min twice."""
    x[0] = 77
    last = x[-1]
    if last.size > 3:
        last[1], last[2] = last.max(), last.min()
        last[0], last[3] = last[1], last[2]


def fixed_softmax_oracle_error(x: np.ndarray, scale: float, out) -> float:
    """bench_kernels.py's softmax error against an f64 oracle: absolute."""
    xf = x.astype(np.float64) * scale
    e = np.exp(xf - xf.max(-1, keepdims=True))
    return float(np.max(np.abs(out.double().cpu().numpy() - e / e.sum(-1, keepdims=True))))


def check_fixed_softmax_case(x, x_np: np.ndarray, fmts) -> dict:
    """One FIXED_SOFTMAX_SHAPES case at scales ±0.02, in ``fmts``, both
    variants; fails past a gate, else returns each format's worst (|kernel -
    plain|, relative to plain, vs the f64 oracle)."""
    from repro_torch.kernels import gs_fixed as fixed_kernel
    from repro_torch.kernels import ref

    rows, d = x.shape
    shape_worst = {}
    for scale_f in (0.02, -0.02):
        scale = torch.tensor(scale_f, device=x.device)
        for fname, fmt in fmts:
            bound = FIXED_MARGIN * fmt.error_bound()
            for variant in ("feedback", "pipelined"):
                kw = dict(fmt.precision(), variant=variant)
                before = fixed_kernel.launches_softmax
                got = fixed_kernel.gs_fixed_softmax(x, scale, **kw)
                launched = fixed_kernel.launches_softmax - before
                want = ref.fixed_softmax(x, scale, **kw)
                err = (got - want).abs().max().item()
                rel = ((got - want).abs() / want).max().item()
                oracle = fixed_softmax_oracle_error(x_np, scale_f, got)
                if not (rel <= SOFTMAX_PLAIN_RTOL and launched == 1 and oracle <= bound):
                    fail(f"gs_fixed_softmax ({rows}, {d}) storage offset {x.storage_offset()} "
                         f"scale {scale_f} {fname} {variant}: |kernel - plain| / plain "
                         f"{rel:.3e} (limit {SOFTMAX_PLAIN_RTOL:.3e}), oracle {oracle:.3e} "
                         f"(bound {bound:.3e}), {launched} launches")
                e0, r0, o0 = shape_worst.get(fname, (0.0, 0.0, 0.0))
                shape_worst[fname] = (max(e0, err), max(r0, rel), max(o0, oracle))
    return shape_worst


def check_fixed_softmax_plans() -> float:
    """gs_fixed_softmax on ``FIXED_SOFTMAX_SHAPES`` in the three formats of
    ``fixed_formats()`` and at p 12, both variants, scales 0.02 and -0.02:
    within SOFTMAX_PLAIN_RTOL of the plain version elementwise, one launch a
    call, and within FIXED_MARGIN x the format's bound of the f64 oracle;
    an input with no rows launches nothing.  Returns the worst |kernel -
    plain|."""
    from repro_torch.core import formats
    from repro_torch.kernels import gs_fixed as fixed_kernel

    dev = torch.device("cuda")
    fmts = fixed_formats() + (("p12", formats.NumericFormat.fixed(24, p=12)),)
    worst = 0.0
    for i, (rows, d, offset, special, packed) in enumerate(FIXED_SOFTMAX_SHAPES):
        rng = np.random.RandomState(200 + i)
        buf_np = rng.randint(-127, 128, rows * d + offset).astype(np.int8)
        x_np = buf_np[offset:].reshape(rows, d)
        if special:
            special_softmax_rows(x_np)
        x = torch.from_numpy(buf_np).to(dev)[offset:].view(rows, d)
        grid = one_block_grid(fixed_kernel) if packed else contextlib.nullcontext()
        with grid:
            plan = fixed_kernel.softmax_launch(rows, d, x.data_ptr() % 16, 0, dev)[0]
            if plan != fixed_kernel.softmax_plan(d, x.data_ptr() % 16, 0, packed=packed):
                fail(f"gs_fixed_softmax ({rows}, {d}): plan {plan}, packed case {packed}")
            shape_worst = check_fixed_softmax_case(x, x_np, fmts)
        worst = max([worst] + [w for w, _, _ in shape_worst.values()])
        print(f"  gs_fixed_softmax ({rows}, {d}) offset {offset}"
              f"{' repeated-code and twice-max rows' if special else ''} {plan}: worst "
              f"(relative to plain, vs the f64 oracle) over scales ±0.02 and both variants "
              + ", ".join(f"{k} ({r:.2e}, {o:.2e})" for k, (_, r, o) in shape_worst.items()))
    before = fixed_kernel.launches_softmax
    empty = fixed_kernel.gs_fixed_softmax(torch.empty(0, 128, dtype=torch.int8, device=dev),
                                          torch.tensor(0.02, device=dev),
                                          **fmts[0][1].precision(), variant="feedback")
    if empty.shape != (0, 128) or fixed_kernel.launches_softmax != before:
        fail(f"gs_fixed_softmax on no rows: shape {tuple(empty.shape)}, "
             f"{fixed_kernel.launches_softmax - before} launches")
    torch.cuda.synchronize()
    return worst


# gs_fixed_recip's inputs on the card: (label, length or shape, storage
# offset, one block) — every code -128..127 (aligned, and 1, 2 and 3 bytes
# into their storage: the single-code instance), the benchmark's (256, 128)
# and (65536, 128) with every 17th code 0, lengths 1-7, 9 and 4097 (words
# with an n % 4 tail, and below one word), (256, 128) views 1, 2 and 3 bytes
# in, and on a grid of one block (``one_block_grid``: one SM holding one
# block, so 4 words a lane once their trips fill it twice) 4 words a lane
# over many trips and at the threshold, and 1 word, each with a tail
FIXED_RECIP_CASES = (
    (("codes", 256, 0, False), ("codes", 256, 1, False), ("codes", 256, 2, False),
     ("codes", 256, 3, False), ("bench", (256, 128), 0, False),
     ("hbm", (65536, 128), 0, False))
    + tuple(("tail", n, 0, False) for n in (1, 2, 3, 4, 5, 6, 7, 9, 4097))
    + tuple(("bench", (256, 128), off, False) for off in (1, 2, 3))
    + tuple(("one block", n, 0, True) for n in (32771, 4099, 999)))
# scales of both signs, a scale whose 1/scale rounds (4/127), and powers of
# two far from 1
FIXED_RECIP_SCALES = (0.02, -0.02, 4 / 127, 1.0, 2.0 ** -20, 2.0 ** 20)


def fixed_recip_input(label: str, size, offset: int, seed: int):
    """A FIXED_RECIP_CASES input on the card and its numpy codes: every
    code once, random codes with every 17th 0, or random codes."""
    n = int(np.prod(size))
    if label == "codes":
        codes = np.arange(-128, 128).astype(np.int8)
    else:
        codes = np.random.RandomState(seed).randint(-128, 128, n).astype(np.int8)
        if label in ("bench", "hbm"):
            codes[::17] = 0
    buf = torch.zeros(n + offset, dtype=torch.int8, device="cuda")
    x = buf[offset:].view(size)
    x.view(-1).copy_(torch.from_numpy(codes))
    return x, codes


def fixed_recip_oracle_error(codes: np.ndarray, scale: float, out) -> float:
    """bench_kernels.py's recip error against an f64 oracle, relative, over
    the non-zero codes (a zero's +inf is checked bit for bit)."""
    xf = codes.astype(np.float64).reshape(-1) * scale
    got = out.double().cpu().numpy().reshape(-1)
    live = xf != 0
    return float(np.max(np.abs(got[live] - 1.0 / xf[live]) * np.abs(xf[live]), initial=0.0))


def recip_trace(events, calls: int, case: str) -> int:
    """The gs_fixed_recip kernel events of a trace of ``calls`` calls; fails
    on any other device event, on more kernel events than calls, or on none.
    Late in this script a trace comes back short of events (48 calls traced
    as 32 kernels; one call alone as none), so the launches are counted on
    the wrapper's counter and the trace shows that no other kernel ran."""
    kernels = [e for e in events if "gs_fixed_recip_kernel" in e.name]
    others = sorted({e.name for e in events} - {e.name for e in kernels})
    if others or not 1 <= len(kernels) <= calls:
        fail(f"gs_fixed_recip {case}: {len(kernels)} kernel events for {calls} calls, other "
             f"device events {others}")
    return len(kernels)


def check_fixed_recip_plans() -> float:
    """gs_fixed_recip on ``FIXED_RECIP_CASES`` in the three formats of
    ``fixed_formats()`` and at p 12, both variants, at ``FIXED_RECIP_SCALES``:
    bit-equal to the plain version, one launch a call counted on
    ``launches_recip`` and no other kernel in the profiler's trace of the
    calls (``recip_trace``), within FIXED_MARGIN x the format's bound of the
    f64 oracle; no launch for an empty input.  Returns the worst |kernel -
    plain| (0)."""
    from repro_torch.core import formats
    from repro_torch.kernels import gs_fixed as fixed_kernel
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    fmts = fixed_formats() + (("p12", formats.NumericFormat.fixed(24, p=12)),)
    scales = [(s, torch.tensor(s, device=dev)) for s in FIXED_RECIP_SCALES]
    settings = [(fname, fmt, variant, s, sc) for fname, fmt in fmts
                for variant in ("feedback", "pipelined") for s, sc in scales]
    for i, (label, size, offset, one_block) in enumerate(FIXED_RECIP_CASES):
        x, codes = fixed_recip_input(label, size, offset, 300 + i)
        grid = one_block_grid(fixed_kernel) if one_block else contextlib.nullcontext()
        with grid:
            plan, blocks = fixed_kernel.recip_launch(x.numel(), x.data_ptr() % 16, 0, dev)

            def calls(outs):
                for _, fmt, variant, _, sc in settings:
                    outs.append(fixed_kernel.gs_fixed_recip(x, sc, **fmt.precision(),
                                                            variant=variant))

            calls([])  # the ROM words and grid limits are built outside the trace
            outs = []
            before = fixed_kernel.launches_recip
            _, events = profiled(lambda: (time.sleep(0.1), calls(outs), time.sleep(0.1)))
            launched = fixed_kernel.launches_recip - before
            traced = recip_trace(events, len(settings), f"{label} {size} offset {offset}")
            if launched != len(settings):
                fail(f"gs_fixed_recip {label} {size} offset {offset}: {launched} launches "
                     f"counted for {len(settings)} calls")
        worst_oracle = {}
        for (fname, fmt, variant, s, sc), got in zip(settings, outs):
            kw = dict(fmt.precision(), variant=variant)
            want = ref.fixed_recip(x, sc, **kw)
            oracle = fixed_recip_oracle_error(codes, s, got)
            bound = FIXED_MARGIN * fmt.error_bound()
            if not (bit_equal(got, want) and oracle <= bound):
                fail(f"gs_fixed_recip {label} {size} offset {offset} {plan} {fname} {variant} "
                     f"scale {s}: bit-equal {bit_equal(got, want)}, max|kernel - plain| "
                     f"{(got - want).abs().nan_to_num().max().item()}, oracle {oracle} "
                     f"(bound {bound})")
            worst_oracle[fname] = max(worst_oracle.get(fname, 0.0), oracle)
        print(f"  gs_fixed_recip {label} {size} offset {offset} {plan} grid {blocks}: "
              f"{len(settings)} calls bit-equal, {launched} launches counted, {traced} kernel "
              f"events traced and no other; worst vs the f64 "
              f"oracle over both variants and scales "
              + ", ".join(f"{k} {o:.2e}" for k, o in worst_oracle.items()))
    before = fixed_kernel.launches_recip
    empty = fixed_kernel.gs_fixed_recip(torch.empty(0, 128, dtype=torch.int8, device=dev),
                                        scales[0][1], **fmts[0][1].precision(),
                                        variant="feedback")
    if empty.shape != (0, 128) or fixed_kernel.launches_recip != before:
        fail(f"gs_fixed_recip on no codes: shape {tuple(empty.shape)}, "
             f"{fixed_kernel.launches_recip - before} launches")
    torch.cuda.synchronize()
    return 0.0


# Phase 7b's gates on the card's run against the CPU's.  Each norm of the
# int8 path quantizes its whole input by one amax, so a last-ulp difference
# in the largest element (another summation order, a tensor-core product)
# can move the scale, and every code sitting at a rounding boundary then
# moves by exactly 1: a rounding tie moves few codes by 1, an arithmetic
# fault moves codes by 2 or more, or many of them.
INT8_CODE_STEP = 1  # (a) largest |card code - CPU code| at any norm input
INT8_CODE_SHARE = 0.02  # (b) share of the norm-input codes that differ
INT8_GAP_MARGIN = 4.0  # (c) worst-step logits gap, in units of the format's 2^-8


def int8_cut(seed: int, prompt_len: int = 97):
    """The 2-layer full-width tinyllama-1.1b int8 cut of 7b: (cfg, f32 params
    on the CPU from ``seed``, the prompt)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import api

    cfg = dataclasses.replace(configs.get_config("tinyllama-1.1b", dtype="float32"),
                              n_layers=2, quant="int8")
    host = api.init(cfg, seed=seed, device="cpu")
    return cfg, host, np.random.RandomState(seed).randint(0, cfg.vocab, (prompt_len,))


def int8_trajectory(cfg, host, prompt, steps: int, dev: str, tokens: list):
    """A prefill of ``prompt`` and ``steps`` teacher-forced decode steps of the
    int8 model ``host`` on ``dev``.  ``tokens`` are fed in turn; where it
    runs short, this run's greedy choice is appended and fed.  Returns the
    last position's logits after each step and the int8 codes each norm
    was given, in call order (``ops.gs_fixed_rmsnorm`` wrapped for the run,
    the real function called unchanged)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.layers.quant import quantize_params
    from repro_torch.serving import SlotCachePool
    from repro_torch.serving.sampler import sample_greedy
    from repro_torch.tree import tree_map

    codes, real = [], ops.gs_fixed_rmsnorm

    def recording(x, *a, **kw):
        codes.append(x.cpu())
        return real(x, *a, **kw)

    ops.gs_fixed_rmsnorm = recording
    try:
        params = quantize_params(tree_map(lambda t: t.to(dev), host))
        prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
        lg, states, _ = prefill(params, {"tokens": torch.as_tensor(prompt[None], device=dev)})
        cache = SlotCachePool.grow(cfg, states, len(prompt) + steps, torch.float32, dev)
        logits = [lg[0, -1].cpu()]
        for i in range(steps):
            if len(tokens) <= i:
                tokens.append(int(sample_greedy(logits[i][None], policy=cfg.policy())[0]))
            lg, cache = decode(params, cache, torch.tensor([len(prompt) + i], device=dev),
                               {"token": torch.tensor([[tokens[i]]], device=dev)})
            logits.append(lg[0, -1].cpu())
    finally:
        ops.gs_fixed_rmsnorm = real
    return logits, codes


def int8_gate_stats(logits, codes, ref_logits, ref_codes) -> dict:
    """One run against a reference run of the same cut: each step's logits
    gap (max |diff| over the reference's largest |logit|), and how many of
    the norm-input codes differ and by how much at most."""
    if len(codes) != len(ref_codes) or len(logits) != len(ref_logits):
        fail(f"int8 runs differ in shape: {len(codes)} / {len(ref_codes)} norm calls, "
             f"{len(logits)} / {len(ref_logits)} steps")
    gaps = [((a - b).abs().max() / b.abs().max()).item() for a, b in zip(logits, ref_logits)]
    diffs = [(a.int() - b.int()).abs() for a, b in zip(codes, ref_codes)]
    n_codes = sum(d.numel() for d in diffs)
    n_differ = sum(int((d != 0).sum()) for d in diffs)
    return {"gaps": gaps, "worst_gap": max(gaps), "n_codes": n_codes, "n_differ": n_differ,
            "share": n_differ / n_codes, "max_code_diff": max(int(d.max()) for d in diffs),
            "norm_calls": len(codes)}


def int8_gate(logits, codes, ref_logits, ref_codes, unit: float) -> dict:
    """7b's three gates on ``logits``/``codes`` against the reference run's,
    each fatal: (a) every code within INT8_CODE_STEP of the reference's,
    (b) at most INT8_CODE_SHARE of them differ, (c) the worst-step logits
    gap at most INT8_GAP_MARGIN x ``unit`` (the format's error bound).
    Returns the statistics."""
    st = int8_gate_stats(logits, codes, ref_logits, ref_codes)
    bound = INT8_GAP_MARGIN * unit
    print(f"    logits gap by step: {', '.join(f'{g:.3e}' for g in st['gaps'])}")
    print(f"    norm-input codes: {st['n_differ']} of {st['n_codes']} differ "
          f"({100 * st['share']:.3f}%, gate {100 * INT8_CODE_SHARE:.0f}%) over "
          f"{st['norm_calls']} norm calls, by at most {st['max_code_diff']} "
          f"(gate {INT8_CODE_STEP}); worst-step gap {st['worst_gap']:.3e} (gate "
          f"{INT8_GAP_MARGIN:.0f} x {unit:.3e} = {bound:.3e})")
    if not st["max_code_diff"] <= INT8_CODE_STEP:
        fail(f"int8 card vs CPU: a norm-input code differs by {st['max_code_diff']} "
             f"(gate {INT8_CODE_STEP})")
    if not st["share"] <= INT8_CODE_SHARE:
        fail(f"int8 card vs CPU: {st['n_differ']} of {st['n_codes']} norm-input codes "
             f"differ ({st['share']:.4%}, gate {INT8_CODE_SHARE:.0%})")
    if not st["worst_gap"] <= bound:
        step = int(np.argmax(st["gaps"]))
        fail(f"int8 card vs CPU, step {step}: logits differ by {st['worst_gap']:.3e} of the "
             f"largest (gate {bound:.3e})")
    return st


def int8_card_vs_cpu(seed: int, steps: int = 8, prompt_len: int = 97):
    """(b) a 2-layer full-width int8 cut, teacher-forced: the same prompt and
    the CPU's greedy tokens through both devices, held by ``int8_gate``."""
    cfg, host, prompt = int8_cut(seed, prompt_len)
    tokens = []  # the CPU's greedy choices, fed to both
    cpu = int8_trajectory(cfg, host, prompt, steps, "cpu", tokens)
    card = int8_trajectory(cfg, host, prompt, steps, "cuda", tokens)
    print(f"  2-layer full-width int8, prompt {prompt_len}, prefill + {steps} teacher-forced "
          f"decode steps, card vs CPU:")
    st = int8_gate(*card, *cpu, unit=cfg.policy().fmt.error_bound())
    del host
    return st


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
    # one activation scale over the tick batch couples the rows, so the
    # tokens hold only on the slot engine's schedule: no stall preemption
    paged = Engine(cfg_q, params, EngineConfig(n_slots=N_SLOTS, s_max=s_max, pool="paged",
                                               page_size=PAGE_SIZE, prefix="off",
                                               preempt_after_ticks=NO_STALL_PREEMPT))
    del params  # the engines hold only the int8 trees
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
    # phase 3b (d): the same trace through the int8 paged pool (int8 arena)
    paged.run([Request(rid=0, prompt=reqs[0].prompt, max_new_tokens=2)])  # warm-up
    res_p, counts_paged = paged_run(paged, reqs, cfg.n_layers, "3b (d) int8 paged", fixed=True)
    differ = [r.rid for r in reqs if not np.array_equal(res_p[r.rid].tokens, res[r.rid].tokens)]
    if differ:
        fail(f"3b (d): the int8 paged engine's tokens differ from the int8 slot engine's in "
             f"requests {differ}")
    mp = res_p.metrics
    print(f"  3b (d) int8 paged Engine.run == int8 slot engine on {len(reqs)} requests; int8 "
          f"arena {mp.cache_bytes / 1e9:.4f} GB against the slot pool's "
          f"{res.metrics.cache_bytes / 1e9:.4f} GB; TTFT median "
          f"{np.median(list(mp.ttft_s.values())) * 1e3:.1f} ms, decode "
          f"{mp.decode_tok_per_s:.1f} tok/s")
    del paged
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
             "bytes_vs_bf16": ratio_budget, "f32_prefix_share": share,
             "paged": {"arena_bytes": mp.cache_bytes, "decode_tok_per_s": mp.decode_tok_per_s,
                       "pool": mp.pool}}
    del engine
    torch.cuda.empty_cache()
    return counts, stats, counts_paged


# phase 7d's gs_fixed_rmsnorm rows, int8 format: (label, rows, p, on copies
# cycled past the L2): the decode tick (N_SLOTS rows), the longest prefill
# at p 8 and at p 12 (a 16 KB ROM), and a 2048-token prefill, at d 2048
FIXED_RMSNORM_TIMED = (("decode", N_SLOTS, None, False), ("prefill", max(PROMPTS), None, False),
                       ("prefill p12", max(PROMPTS), 12, False), ("prefill 2048", 2048, None, True))


def time_fixed_rmsnorm():
    """(d) gs_fixed_rmsnorm at ``FIXED_RMSNORM_TIMED``, the int8 format (frac
    24, iters 0), eps 1e-5, after a second of load, beside its plain version
    and two yardsticks the port never calls: dequantize + ``F.rms_norm``
    (three launches) and ``F.rms_norm`` alone on an f32 copy of the
    dequantized input made beforehand (one call, 8 bytes an element against
    the kernel's 5).  Per call (``cuda_ms``) and device time queued back to
    back (``queued_ms``) for the kernel and both yardsticks; the decode and
    prefill rows also by the profiler.  The 2048-row row takes each call on
    the next of copies cycled past the L2 (``L2Ring``), so it reads device
    memory; the others run on one input, which the L2 holds."""
    import torch.nn.functional as F

    from repro_torch.core import formats
    from repro_torch.kernels import gs_fixed as fixed_kernel
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    d, eps = 2048, 1e-5
    fmt = formats.format_for("int8")
    scale = torch.tensor(0.02, device=dev)
    gain = 1 + 0.1 * torch.randn(d, generator=g, device=dev)
    rows = {}
    under_load()
    for label, n_rows, p, cycled in FIXED_RMSNORM_TIMED:
        rkw = dict(eps=eps, p=p or fmt.p, frac_bits=fmt.frac_bits, iters=fmt.iters)
        x = torch.randint(-127, 128, (n_rows, d), generator=g, device=dev, dtype=torch.int8)
        xf = x.float() * scale
        kern = lambda x, rkw=rkw: fixed_kernel.gs_fixed_rmsnorm(x, scale, gain, **rkw)  # noqa: E731
        plain = lambda x, rkw=rkw: ref.fixed_rmsnorm(x, scale, gain, **rkw)  # noqa: E731
        lib = lambda x: F.rms_norm(x.float() * scale, (d,), weight=gain, eps=eps)  # noqa: E731
        lib_f32 = lambda xf: F.rms_norm(xf, (d,), weight=gain, eps=eps)  # noqa: E731
        n = n_rows * d
        nbytes = n * (1 + 4) + 4 * d
        b, by = bound_ms(nbytes, 5 * n, "float32")
        shape = f"({n_rows}, {d}) int8 p={rkw['p']} frac_bits={fmt.frac_bits} iters={fmt.iters}"
        if cycled:
            ring, ring_f32 = L2Ring(x, nbytes), L2Ring(xf, 8 * n)
            kern, plain, lib = (ring.calls(f) for f in (kern, plain, lib))
            lib_f32 = ring_f32.calls(lib_f32)
            shape += f", {len(ring.xs)} copies cycled ({len(ring_f32.xs)} of the f32 copy)"
        else:
            kern, plain, lib = ((lambda f=f: f(x)) for f in (kern, plain, lib))
            lib_f32 = (lambda f=lib_f32: f(xf))
        profile = label in ("decode", "prefill")
        rows[("gs_fixed_rmsnorm", label)] = dict(
            ms=cuda_ms(kern, 200), plain_ms=cuda_ms(plain, 20), library_ms=cuda_ms(lib, 200),
            library_f32_ms=cuda_ms(lib_f32, 200), bound_ms=b, bound_by=by,
            device_ms=[device_ms(f, 50) if profile else None for f in (kern, plain, lib)],
            queued_ms=[queued_ms(f, 50) for f in (kern, lib, lib_f32)], shape=shape)
    us = lambda v: "not measured" if v is None else f"{v * 1e3:.2f} us"  # noqa: E731
    for (_, label), r in rows.items():
        q_kern, q_lib, q_f32 = r["queued_ms"]
        print(f"  gs_fixed_rmsnorm {label} {r['shape']}: queued back to back (CUDA events) "
              f"kernel {us(q_kern)}, dequantize + F.rms_norm {us(q_lib)} "
              f"({q_kern / q_lib:.3f}x), F.rms_norm on the f32 copy {us(q_f32)} "
              f"({q_kern / q_f32:.3f}x), {r['bound_ms'] / q_kern:.1%} of the bound "
              f"{r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}); per call (CUDA events, back "
              f"to back) kernel {us(r['ms'])}, plain {us(r['plain_ms'])}, dequantize + "
              f"F.rms_norm {us(r['library_ms'])}, F.rms_norm on the f32 copy "
              f"{us(r['library_f32_ms'])}; device time (profiler) kernel "
              f"{us(r['device_ms'][0])}, plain {us(r['device_ms'][1])}, dequantize + "
              f"F.rms_norm {us(r['device_ms'][2])}")
    return rows


def time_fixed_recip_softmax():
    """(d) gs_fixed_recip and gs_fixed_softmax, int8 format, feedback, after a
    second of load, beside their plain versions and a dequantize-then-library
    call (``torch.reciprocal`` / ``torch.softmax`` on ``x.float() * scale``):
    at (256, 128) on one input (the L2 holds it; per call, by the profiler
    and queued back to back), both also at p 12, and at
    (65536, 128) on copies cycled past the L2 (``L2Ring``; per call and
    queued)."""
    from repro_torch.core import formats
    from repro_torch.kernels import gs_fixed as fixed_kernel
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    int8 = dict(formats.format_for("int8").precision(), variant="feedback")
    scale = torch.tensor(0.02, device=dev)
    rows = {}
    under_load()
    for name, shape, label in (("gs_fixed_recip", (256, 128), "bench"),
                               ("gs_fixed_recip", (65536, 128), "hbm"),
                               ("gs_fixed_recip", (256, 128), "bench_p12"),
                               ("gs_fixed_softmax", (256, 128), "bench"),
                               ("gs_fixed_softmax", (65536, 128), "hbm"),
                               ("gs_fixed_softmax", (256, 128), "bench_p12")):
        kw = dict(int8, p=12) if label.endswith("p12") else int8
        x = torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
        n = x.numel()
        if name == "gs_fixed_recip":
            kern = lambda x: fixed_kernel.gs_fixed_recip(x, scale, **kw)  # noqa: E731
            plain = lambda x: ref.fixed_recip(x, scale, **kw)  # noqa: E731
            lib = lambda x: torch.reciprocal(x.float() * scale)  # noqa: E731
            flops = 3 * n
        else:
            kern = lambda x: fixed_kernel.gs_fixed_softmax(x, scale, **kw)  # noqa: E731
            plain = lambda x: ref.fixed_softmax(x, scale, **kw)  # noqa: E731
            lib = lambda x: torch.softmax(x.float() * scale, dim=-1)  # noqa: E731
            flops = 6 * n
        nbytes = n * (1 + 4)
        b, by = bound_ms(nbytes, flops, "float32")
        desc = f"{shape} int8 p={kw['p']}"
        cycled = label == "hbm"
        if cycled:
            ring = L2Ring(x, nbytes)
            kern, plain, lib = (ring.calls(f) for f in (kern, plain, lib))
            desc += f", {len(ring.xs)} copies cycled"
        else:
            kern, plain, lib = ((lambda f=f: f(x)) for f in (kern, plain, lib))
        rows[(name, label)] = dict(
            ms=cuda_ms(kern, 200), plain_ms=cuda_ms(plain, 5 if cycled else 20),
            library_ms=cuda_ms(lib, 200), bound_ms=b, bound_by=by,
            device_ms=[None if cycled else device_ms(f, 50) for f in (kern, plain, lib)],
            queued_ms=[queued_ms(f, 50) for f in (kern, lib)], shape=desc)
    us = lambda v: "not measured" if v is None else f"{v * 1e3:.2f} us"  # noqa: E731
    for (kname, label), r in rows.items():
        q_kern, q_lib = r["queued_ms"]
        print(f"  {kname} {label} {r['shape']}: queued back to back (CUDA events) kernel "
              f"{us(q_kern)}, dequantize + library {us(q_lib)} ({q_kern / q_lib:.3f}x), "
              f"{r['bound_ms'] / q_kern:.1%} of the bound {r['bound_ms'] * 1e3:.3f} us "
              f"({r['bound_by']}); per call (CUDA events, back to back) kernel {us(r['ms'])}, "
              f"plain {us(r['plain_ms'])}, dequantize + library {us(r['library_ms'])}; device "
              f"time (profiler) kernel {us(r['device_ms'][0])}, plain {us(r['device_ms'][1])}, "
              f"dequantize + library {us(r['device_ms'][2])}")
    return rows


def time_fixed_kernels():
    """(d) the three kernels at the path's shapes, with the SM and memory
    clocks nvidia-smi samples meanwhile."""
    with SampledClocks() as clocks:
        rows = time_fixed_rmsnorm()
        rows.update(time_fixed_recip_softmax())
    print(f"  7d clocks (nvidia-smi every 100 ms): {json.dumps(clocks.summary())}")
    return rows


# -- phase 8 -------------------------------------------------------------------

# the (dtype, p, iters, variant) grid of tests/test_torch_kernels.py, and two
# f32 points whose Goldschmidt error (2^-9 seed-only, 2^-14 after one pass)
# stands far above f32 roundoff, so that an exact 1/sum in gs_softmax fails
ELEMENTWISE_PRECISIONS = (("float32", 7, 2, "feedback"), ("float32", 12, 1, "pipelined"),
                          ("bfloat16", 8, 0, "feedback"), ("bfloat16", 8, 0, "pipelined"),
                          ("float32", 8, 0, "feedback"), ("float32", 7, 1, "pipelined"))
# ±0, ±the smallest subnormal, ±inf, NaN, -2, ±the largest normal (biased
# exponent 254: a reciprocal of ±0), 2^126 (exponent 253: a reciprocal at
# the subnormal edge) and the smallest normal
SPECIALS = [0.0, -0.0, 1e-45, -1e-45, float("inf"), float("-inf"), float("nan"), -2.0,
            3.4028234663852886e38, -3.4028234663852886e38, 8.507059173023462e37,
            1.1754943508222875e-38]
# gs_softmax vs its plain version, elementwise relative at f32: expf and the
# row sum's order differ by ulps (4.8e-7 at most on the H100, 8 times less
# than this limit); an exact 1/sum instead of the Goldschmidt one moves a
# row by the datapath's error, 2^-9 at (8, 0) and 2^-14 at (7, 1).
SOFTMAX_F32_RTOL = 2.0 ** -18
# gs_softmax's 8a rows (4 x a numpy randn draw), one a launch plan: the
# benchmark's (16, 384) and (37, 200) (block instances: a few warps a row,
# several rows a block), d 517 (single elements), (8, 32000) and (2, 32000)
# (clusters of 8 CTAs a row), (256, 32000) (a decode batch at a 32000-token
# vocabulary), (2, 131072) (8 CTAs of 1024 threads, the widest the cluster
# holds) and a row of vectors past it (the looping instance); then views one
# element into their storage (single elements: (8, 32000)'s takes the
# looping instance) and SOFTMAX_MASKED.  At most 4096 rows (ROADMAP C6).
SOFTMAX_SHAPES = ((16, 384), (37, 200), (33, 517), (8, 32000), (2, 32000), (256, 32000),
                  (2, 131072), (2, 131076))
SOFTMAX_OFFSET_SHAPES = ((16, 384), (8, 32000))
# rows a sampler masks: a leading -inf chunk of half the row (whole CTAs of
# a cluster see only -inf), all -inf, one +inf, one NaN, at these widths
SOFTMAX_MASKED = (384, 32000)
BENCH_KERNELS = ("gs_recip", "gs_rsqrt", "gs_softmax")
# inputs that reach the elementwise kernels' other paths: contiguous views 1,
# 2 and 3 elements into their storage (not 16-byte aligned: the width-1
# instance), and lengths that end in a partial vector of either width
STORAGE_OFFSETS = (1, 2, 3)
TAIL_LENGTHS = (1, 2, 3, 4, 5, 6, 7, 9, 4097)


def bit_equal(a, b) -> bool:
    """Equal dtype, shape and bit patterns, any NaN matching any NaN."""
    ints = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    same = (a.view(ints) == b.view(ints)) | (torch.isnan(a) & torch.isnan(b))
    return a.dtype == b.dtype and a.shape == b.shape and bool(same.all())


def offset_view(x, offset: int):
    """A contiguous copy of ``x`` that starts ``offset`` elements into its
    storage."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    return view


def masked_rows(d: int) -> np.ndarray:
    """Four f32 rows of ``d`` a sampler could mask (``SOFTMAX_MASKED``): the
    first half -inf, all -inf, one +inf, one NaN; the rest 4 x randn."""
    x = (4 * np.random.RandomState(d).randn(4, d)).astype(np.float32)
    x[0, :d // 2] = -np.inf
    x[1] = -np.inf
    x[2, d // 3] = np.inf
    x[3, d // 5] = np.nan
    return x


def softmax_gate(got, want):
    """(ok, error, limit) of gs_softmax against its plain version: NaN in
    the same places, and elsewhere f32 within SOFTMAX_F32_RTOL of the plain
    value (a plain 0 is met by an exact 0) or bf16 within one ulp."""
    nan = torch.isnan(want)
    same_nan = bool(torch.equal(torch.isnan(got), nan))
    fin = ~nan
    if got.dtype == torch.float32:
        diff = (got - want).abs()[fin]
        pos = want[fin] > 0
        err = (diff[pos] / want[fin][pos]).max().item() if pos.any() else 0.0
        ok = bool((diff <= SOFTMAX_F32_RTOL * want[fin]).all())
        limit = f"relative, limit {SOFTMAX_F32_RTOL:.3e}"
    else:
        ulps = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()[fin]
        err = ulps.max().item() if ulps.numel() else 0
        ok = err <= 1
        limit = "ulps, limit 1"
    ok = ok and same_nan and got.dtype == want.dtype
    return ok, err, f"{limit}, NaN classes equal {same_nan}"


def max_abs_diff(a, b) -> float:
    """max |a - b| over the elements where both are finite."""
    fin = torch.isfinite(a) & torch.isfinite(b)
    return (a.float() - b.float()).abs()[fin].max().item() if fin.any() else 0.0


def bench_kernel_inputs():
    """8a's numpy draws: signed magnitudes log-uniform over 2^-60..2^61 at
    (256, 128), (33, 517) and (4096, 128) for the elementwise kernels (f64),
    then 4 x randn at SOFTMAX_SHAPES for gs_softmax (f32)."""
    r = np.random.RandomState(8)
    xs = []
    for shape in ((256, 128), (33, 517), (4096, 128)):
        mag = np.exp2(r.uniform(-60, 60, shape)) * (1 + r.rand(*shape))
        xs.append(mag * np.where(r.rand(*shape) < 0.5, -1, 1))
    return xs, [(4 * r.randn(*shape)).astype(np.float32) for shape in SOFTMAX_SHAPES]


def check_bench_kernels():
    """(a) gs_recip and gs_rsqrt's three modes bit-equal to their plain
    versions, gs_softmax within SOFTMAX_F32_RTOL (f32) or one ulp (bf16);
    returns the worst |kernel - plain| of each."""
    from repro_torch.kernels import gs_elementwise as elementwise_kernel
    from repro_torch.kernels import gs_softmax as softmax_kernel
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    xs_np, rows_np = bench_kernel_inputs()
    xs = [torch.from_numpy(x).float().to(dev) for x in xs_np]
    xs.append(torch.tensor(SPECIALS, device=dev))
    rows = [torch.from_numpy(x).to(dev) for x in rows_np]
    rows += [offset_view(rows[SOFTMAX_SHAPES.index(shape)], 1) for shape in SOFTMAX_OFFSET_SHAPES]
    rows += [torch.from_numpy(masked_rows(d)).to(dev) for d in SOFTMAX_MASKED]
    worst = {name: 0.0 for name in BENCH_KERNELS}
    calls = {name: 0 for name in BENCH_KERNELS}
    ops.reset_launch_counts()
    for dname, p, iters, variant in ELEMENTWISE_PRECISIONS:
        dtype = getattr(torch, dname)
        kw = dict(p=p, iters=iters, variant=variant)
        inputs = [x32.to(dtype) for x32 in xs]
        inputs += [offset_view(inputs[0], off) for off in STORAGE_OFFSETS]
        inputs += [inputs[2].flatten()[:n] for n in TAIL_LENGTHS]
        for x in inputs:
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
                    fail(f"{what} {dname} {tuple(x.shape)} (storage offset "
                         f"{x.storage_offset()}) p={p} iters={iters} {variant}: "
                         f"not bit-equal to the plain version (max |diff| "
                         f"{max_abs_diff(a, b):.3e}, NaN classes equal "
                         f"{bool((torch.isnan(a) == torch.isnan(b)).all())})")
                worst[name] = max(worst[name], max_abs_diff(a, b))
        print(f"  {dname} p={p} iters={iters} {variant}: gs_recip, gs_rsqrt (rsqrt, sqrt, "
              f"sqrt_both) bit-equal to the plain versions at (256, 128), (33, 517), "
              f"(4096, 128), the {len(SPECIALS)} specials, (256, 128) at storage offsets "
              f"{STORAGE_OFFSETS} and lengths {TAIL_LENGTHS}")
        for x32 in rows:
            x = x32.to(dtype) if x32.storage_offset() == 0 else offset_view(x32.to(dtype),
                                                                           x32.storage_offset())
            got = softmax_kernel.gs_softmax(x, **kw)
            want = ref.softmax(x, **kw)
            calls["gs_softmax"] += 1
            ok, err, limit = softmax_gate(got, want)
            d = x.shape[-1]
            plan = softmax_kernel.launch_plan(d, x.element_size(), x.data_ptr() % 16)
            print(f"    gs_softmax {tuple(x.shape)} storage offset {x.storage_offset()}, {plan}: "
                  f"max |kernel - plain| {max_abs_diff(got, want):.3e}, {err:.3e} {limit}")
            if not ok:
                fail(f"gs_softmax {dname} {tuple(x.shape)} storage offset {x.storage_offset()} "
                     f"p={p} {variant}: {err} ({limit})")
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


def time_bench_kernels(kernels=BENCH_KERNELS):
    """(d) the three kernels (those of them named in ``kernels``) on
    positive inputs (the benchmark's draw; 4 x randn for gs_softmax), p 7,
    iters 2, feedback, f32 unless a row says otherwise, after a second of
    load; gs_recip and gs_rsqrt also at (65536, 128) (the "hbm" rows: 67 MB
    of f32 traffic a call, each call on copies cycled by ``L2Ring``, so from
    device memory), gs_recip and gs_rsqrt at bf16 and at p 12 (iters 1,
    pipelined), where the ROM is 16 KB; gs_softmax also at (256, 32000), f32
    and bf16, cycled (a sampler's softmax over a decode batch of 256 at a
    32000-token vocabulary), and (8, 32000) at p 12.  The other rows run
    back to back on one input, which the L2 holds.  Device times twice: the
    profiler's, and the kernel's and library call's queued back to back
    (``queued_ms``)."""
    from repro_torch.kernels import gs_elementwise as elementwise_kernel
    from repro_torch.kernels import gs_softmax as softmax_kernel
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    kw7 = dict(p=7, iters=2, variant="feedback")
    kw12 = dict(p=12, iters=1, variant="pipelined")
    f32, bf16 = torch.float32, torch.bfloat16
    rows = {}
    under_load()
    cases = [("gs_recip", "recip", (256, 128), "bench", f32, kw7),
             ("gs_recip", "recip", (4096, 128), "large", f32, kw7),
             ("gs_recip", "recip", (65536, 128), "hbm", f32, kw7),
             ("gs_recip", "recip", (4096, 128), "large bf16", bf16, kw7),
             ("gs_recip", "recip", (4096, 128), "large p12", f32, kw12),
             ("gs_recip", "recip", (65536, 128), "hbm p12", f32, kw12),
             ("gs_rsqrt", "rsqrt", (256, 128), "bench", f32, kw7),
             ("gs_rsqrt", "rsqrt", (4096, 128), "large", f32, kw7),
             ("gs_rsqrt", "sqrt", (256, 128), "bench sqrt", f32, kw7),
             ("gs_rsqrt", "sqrt", (4096, 128), "large sqrt", f32, kw7),
             ("gs_rsqrt", "rsqrt", (65536, 128), "hbm", f32, kw7),
             ("gs_rsqrt", "sqrt", (65536, 128), "hbm sqrt", f32, kw7),
             ("gs_rsqrt", "sqrt_both", (65536, 128), "hbm sqrt_both", f32, kw7),
             ("gs_rsqrt", "rsqrt", (4096, 128), "large bf16", bf16, kw7),
             ("gs_rsqrt", "sqrt", (4096, 128), "large bf16 sqrt", bf16, kw7),
             ("gs_rsqrt", "rsqrt", (4096, 128), "large p12", f32, kw12),
             ("gs_rsqrt", "rsqrt", (65536, 128), "hbm p12", f32, kw12),
             ("gs_softmax", "softmax", (16, 384), "bench", f32, kw7),
             ("gs_softmax", "softmax", (8, 32000), "large", f32, kw7),
             ("gs_softmax", "softmax", (256, 32000), "hbm", f32, kw7),
             ("gs_softmax", "softmax", (256, 32000), "hbm bf16", bf16, kw7),
             ("gs_softmax", "softmax", (8, 32000), "large p12", f32, kw12)]
    for name, fn, shape, label, dtype, kw in (c for c in cases if c[0] in kernels):
        n = shape[0] * shape[1]
        size = torch.finfo(dtype).bits // 8
        nbytes = 2 * size * n  # read x once, write each output once
        if fn == "softmax":
            x = (4 * torch.randn(shape, generator=g, device=dev)).to(dtype)
            kern = lambda x: softmax_kernel.gs_softmax(x, **kw)  # noqa: E731
            plain = lambda x: ref.softmax(x, **kw)  # noqa: E731
            lib = lambda x: torch.softmax(x, dim=-1)  # noqa: E731
            flops = 5 * n  # a max, a subtract, an exp, an add and a multiply
        else:
            x = (torch.randn(shape, generator=g, device=dev).abs() + 0.1).to(dtype)
            if fn == "recip":
                kern = lambda x: elementwise_kernel.gs_recip(x, **kw)  # noqa: E731
                plain = lambda x: ref.reciprocal(x, **kw)  # noqa: E731
                lib = torch.reciprocal
                flops = (2 + 3 * kw["iters"]) * n
            else:
                kern = lambda x: elementwise_kernel.gs_rsqrt(x, mode=fn, **kw)  # noqa: E731
                plain = lambda x: ref.rsqrt(x, mode=fn, **kw)  # noqa: E731
                lib = {"rsqrt": torch.rsqrt, "sqrt": torch.sqrt,
                       # no one call computes both: the pair of calls
                       "sqrt_both": lambda x: (torch.sqrt(x), torch.rsqrt(x))}[fn]
                flops = (4 + 6 * kw["iters"]) * n
                if fn == "sqrt_both":
                    nbytes = 3 * size * n
        b, by = bound_ms(nbytes, flops, "float32")
        desc = f"{shape} {str(dtype).split('.')[-1]}"
        if fn in ("sqrt", "sqrt_both"):
            desc += f" {fn}"
        if kw is kw12:
            desc += f" p={kw['p']} iters={kw['iters']} {kw['variant']}"
        if label.startswith("hbm"):
            ring = L2Ring(x, nbytes)
            kern, plain, lib = (ring.calls(f) for f in (kern, plain, lib))
            desc += f", {len(ring.xs)} copies cycled"
        else:
            kern, plain, lib = ((lambda f=f: f(x)) for f in (kern, plain, lib))
        rows[(name, label)] = dict(
            ms=cuda_ms(kern, 200), plain_ms=cuda_ms(plain, 20), library_ms=cuda_ms(lib, 200),
            bound_ms=b, bound_by=by, device_ms=[device_ms(f, 50) for f in (kern, plain, lib)],
            queued_ms=[queued_ms(f, 50) for f in (kern, lib)], shape=desc)
    us = lambda v: "not measured" if v is None else f"{v * 1e3:.2f} us"  # noqa: E731
    for (kname, label), r in rows.items():
        library = ("torch.sqrt + torch.rsqrt (two calls)" if label.endswith("sqrt_both")
                   else "library")
        print(f"  {kname} {label} {r['shape']}: per call (CUDA events, back to back) kernel "
              f"{us(r['ms'])}, plain {us(r['plain_ms'])}, {library} {us(r['library_ms'])}; "
              f"device time (profiler) kernel {us(r['device_ms'][0])}, plain "
              f"{us(r['device_ms'][1])}, {library} {us(r['device_ms'][2])}; queued back to "
              f"back (CUDA events) kernel {us(r['queued_ms'][0])}, {library} "
              f"{us(r['queued_ms'][1])}; bound {r['bound_ms'] * 1e3:.3f} us ({r['bound_by']})")
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
    log = build.report_path(lib)
    if not log.exists():
        fail(f"no compiler report {log.name} beside {lib.name}")
    entry, flash_reported = "", set()
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line
        if "registers" in line or "spill" in line:
            print("   ", line.strip())
        if re.search(r"flash_(fwd|bwd)", entry) and "spill" in line:
            flash_reported.add(entry)
            if any(int(n) for n in re.findall(r"(\d+) bytes spill", line)):
                fail(f"the flash kernels spill: {entry.strip()}: {line.strip()}")
    sass_text = sass(lib)
    hmma = hmma_counts(sass_text)
    print(f"  HMMA (tensor-core) instructions per flash kernel: {hmma}; spill "
          f"reports read for {len(flash_reported)} of their instances in {log.name}")
    # the forward, dq and dk/dv, each at f32 and bf16 and D 16, 32, 64
    if len(hmma) != 18 or not all(hmma.values()):
        fail(f"the flash kernels must run on the tensor cores: {hmma}")
    if len(flash_reported) != len(hmma):
        fail(f"{log.name} reports spills for {len(flash_reported)} flash kernel instances, "
             f"not {len(hmma)}")
    check_elementwise_build(lib, log.read_text(), sass_text)
    check_rmsnorm_build(lib, log.read_text(), sass_text)
    check_fixed_rmsnorm_build(lib, log.read_text(), sass_text)
    check_fixed_softmax_build(lib, log.read_text(), sass_text)
    check_fixed_recip_build(lib, log.read_text(), sass_text)
    check_softmax_build(lib, log.read_text(), sass_text)

    print("== 2. kernels vs plain versions")
    worst = check_kernels()
    worst.update(check_training_kernels())
    check_flash_nan_classes()

    print("== 3. serve full-width tinyllama-1.1b")
    counts, stats, seq_f32, served = serve(args.seed)

    print("== 3b. serve full-width tinyllama-1.1b through the paged pool")
    counts_paged, stats["paged"] = serve_paged(args.seed, served, seq_f32, stats)
    del served
    torch.cuda.empty_cache()

    print("== 4. timing at the main paths' shapes")
    timing = time_kernels()
    timing.update(time_training_kernels())
    with SampledClocks() as clocks:
        flash_queued = time_flash()
    print(f"  flash clocks (nvidia-smi every 100 ms): {json.dumps(clocks.summary())}")

    print("== 5. where a serving run's time goes (profiler)")
    profile_serving(args.seed)

    print("== 6. train full-width tinyllama-1.1b")
    check_train_step_against_cpu(args.seed)
    train32 = train_full(args.seed, "float32", steps=10, ckpt_every=5)
    train16 = train_full(args.seed, "bfloat16", steps=3, ckpt_every=5)

    print("== 7. serve full-width tinyllama-1.1b int8")
    worst.update(check_fixed_kernels())
    worst["gs_fixed_rmsnorm"] = max(worst["gs_fixed_rmsnorm"], check_fixed_rmsnorm_plans())
    worst["gs_fixed_softmax"] = max(worst["gs_fixed_softmax"], check_fixed_softmax_plans())
    worst["gs_fixed_recip"] = max(worst["gs_fixed_recip"], check_fixed_recip_plans())
    int8_card_vs_cpu(args.seed)
    counts_int8, stats["int8"], counts_int8_paged = serve_int8(args.seed, seq_f32)
    timing.update(time_fixed_kernels())

    print("== 8. the kernel benchmark's kernels: gs_recip, gs_rsqrt / gs_sqrt, gs_softmax")
    t8 = time.perf_counter()
    worst.update(check_bench_kernels())
    check_bench_vjps()
    for name, err in check_bench_shapes().items():
        worst[name] = max(worst[name], err)
    counts_bench = run_bench()
    with SampledClocks() as clocks:
        timing.update(time_bench_kernels())
    print(f"  8d clocks (nvidia-smi every 100 ms): {json.dumps(clocks.summary())}")
    print(f"  phase 8 took {time.perf_counter() - t8:.1f} s")

    picks = {"gs_rmsnorm": ("decode", "gs_rmsnorm.cu", "gs_rmsnorm.py:64"),
             "flash_attention": ("float32", "flash_attention.cu", "flash_attention.py:142"),
             "flash_attention_bwd_dq": ("float32", "flash_attention_bwd.cu",
                                        "flash_attention.py:311"),
             "flash_attention_bwd_dkv": ("float32", "flash_attention_bwd.cu",
                                         "flash_attention.py:338"),
             "gs_adam": ("float32", "gs_adam.cu", "gs_adam.py:114"),
             "gs_fixed_recip": ("bench", "gs_fixed.cu", "gs_fixed.py:135"),
             "gs_fixed_softmax": ("bench", "gs_fixed_softmax.cu", "gs_fixed.py:205"),
             "gs_fixed_rmsnorm": ("decode", "gs_fixed_rmsnorm.cu", "gs_fixed.py:282"),
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
               "launches_int8_serve": counts_int8[name], "launches_bench": counts_bench[name],
               "launches_serve_paged_f32": counts_paged[name],
               "launches_int8_serve_paged": counts_int8_paged[name]}
        if (name, label) in flash_queued:
            row["queued_ms"] = flash_queued[(name, label)]["queued_ms"]
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
