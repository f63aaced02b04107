#!/usr/bin/env python3
"""Time ``chip_smoke.py``'s phase 8d rows (gs_recip, gs_rsqrt / gs_sqrt,
gs_softmax), its phase 4 gs_rmsnorm rows or its phase 7d int8 rows against
one copy of the port, so that one call on a card can compare two trees with
the same timing code.

    python3 tools/ab_elementwise.py [--src DIR] [--label NAME] [--kernels KIND]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported: this
checkout's by default, or that of another commit's ``git archive`` unpacked
under an ignored directory (its kernels build under that tree's ``build/``).
``--kernels`` picks the rows: ``elementwise`` (phase 8d's, by default),
``rmsnorm`` (phase 4's ``time_rmsnorm``: decode, prefill at f32, bf16 and
p 12, and the training batch with the rsqrt column on copies cycled past
the L2), ``fixed_rmsnorm`` (phase 7d's ``time_fixed_rmsnorm``: the int8
decode tick, prefill at p 8 and p 12, and a 2048-token prefill on copies
cycled past the L2), ``fixed_recip_softmax`` (phase 7d's
``time_fixed_recip_softmax``: (256, 128), both there also at p 12, and
(65536, 128) on copies cycled past the L2) or ``fixed_recip_words``
(gs_fixed_recip's word instances, each forced in turn, and the wrapper's
own choice, at (256, 128) and at (65536, 128) on copies cycled past the
L2; a tree whose wrapper has ``recip_launch`` only), ``softmax`` (phase
8d's gs_softmax rows alone: (16, 384), (8, 32000) at p 7 and p 12, and
(256, 32000) f32 and bf16 on copies cycled past the L2) or
``softmax_clusters`` (gs_softmax on the wrapper's own plan, a cluster of 8
CTAs a row, and forced onto clusters of 2 and 4, at (8, 32000), and at
(256, 32000) f32 and bf16 on copies cycled past the L2; a tree whose
wrapper has ``cluster_plan`` only), or ``flash`` (phase 4's
``time_flash``: the flash forward at (1, 32, 333, 64) f32 and bf16 and,
at (4, 32, 512, 64) f32, the forward with residuals, dq and dk/dv, beside
SDPA; the line also carries phase 2's NaN classes, causal and not,
``chip_smoke.flash_nan_classes``).
Both trees' wrappers take the same arguments.  Run the sides in turns (A, B,
B, A) in one call.  Prints the card's name and power limit, then one JSON
line ``{"label", "src", "clocks", "rows": [...]}`` with each row's times in
ms and the SM and memory clocks nvidia-smi sampled while they were taken;
for the int8 kinds also ``"sass"``, the SASS instruction counts and digests
of the gs_fixed_softmax and gs_fixed_rmsnorm instances in the library that
side built (``chip_smoke.FIXED_OTHERS``), for the softmax kinds those of
the gs_recip, gs_rsqrt and gs_rmsnorm instances (``chip_smoke.FLOAT_OTHERS``).
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def time_fixed_recip_words() -> dict:
    """gs_fixed_recip queued (``queued_ms``; int8 format, feedback, scale
    0.02) with each word instance forced in turn on a grid of at most one
    wave of resident blocks, and with the wrapper's own plan, at (256, 128)
    and at (65536, 128) on copies cycled past the L2."""
    import torch

    import chip_smoke
    from repro_torch.core import formats
    from repro_torch.kernels import gs_fixed, gs_rmsnorm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    kw = dict(formats.format_for("int8").precision(), variant="feedback")
    scale = torch.tensor(0.02, device=dev)
    chosen = gs_fixed.recip_launch

    def forced(words):
        def launch(n, x_bits, out_bits, device):
            plan = gs_fixed.recip_plan(gs_fixed.recip_width(n, x_bits, out_bits), words)
            return plan, gs_rmsnorm.grid_size(n // plan.width, gs_fixed.RECIP_THREADS * words,
                                              *gs_fixed.grid_limits(device, plan, "recip"))
        return launch

    rows = {}
    chip_smoke.under_load()
    for shape, label in (((256, 128), "bench"), ((65536, 128), "hbm")):
        x = torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
        kern = lambda x: gs_fixed.gs_fixed_recip(x, scale, **kw)  # noqa: E731
        if label == "hbm":
            fn = chip_smoke.L2Ring(x, 5 * x.numel()).calls(kern)
        else:
            fn = lambda: kern(x)  # noqa: E731
        for words in gs_fixed.RECIP_WORDS + (None,):
            gs_fixed.recip_launch = chosen if words is None else forced(words)
            try:
                plan, grid = gs_fixed.recip_launch(x.numel(), 0, 0, dev)
                name = f"words {words}" if words else "chosen"
                rows[(f"gs_fixed_recip {name}", label)] = dict(
                    queued_ms=[chip_smoke.queued_ms(fn, 50)], plan=list(plan), grid=grid,
                    shape=f"{shape} int8 p={kw['p']}")
            finally:
                gs_fixed.recip_launch = chosen
    return rows


def time_softmax_clusters() -> dict:
    """gs_softmax queued (``queued_ms``; p 7, iters 2, feedback) on the
    wrapper's own plan (a cluster of ``gs_softmax.CLUSTER`` CTAs a row) and
    forced onto clusters of 2 and 4 CTAs (``cluster_plan``), at (8, 32000),
    and at (256, 32000) f32 and bf16 on copies cycled past the L2; each
    plan's output first held to the card gate of the plain version."""
    import torch

    import chip_smoke
    from repro_torch.kernels import gs_softmax, ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    kw = dict(p=7, iters=2, variant="feedback")
    chosen = gs_softmax.launch_plan

    def forced(size):
        def launch_plan(d, itemsize, ptr_bits):
            width = gs_softmax.gs_rmsnorm.vector_width(itemsize, d, ptr_bits)
            return gs_softmax.cluster_plan(width, d // width, size)
        return launch_plan

    rows = {}
    chip_smoke.under_load()
    for shape, dtype, label in (((8, 32000), torch.float32, "large"),
                                ((256, 32000), torch.float32, "hbm"),
                                ((256, 32000), torch.bfloat16, "hbm bf16")):
        x = (4 * torch.randn(shape, generator=g, device=dev)).to(dtype)
        kern = lambda x: gs_softmax.gs_softmax(x, **kw)  # noqa: E731
        if label.startswith("hbm"):
            fn = chip_smoke.L2Ring(x, 2 * x.numel() * x.element_size()).calls(kern)
        else:
            fn = lambda: kern(x)  # noqa: E731
        for name, plan_of in (("chosen", chosen), ("cluster 2", forced(2)),
                              ("cluster 4", forced(4))):
            gs_softmax.launch_plan = plan_of
            try:
                ok, err, limit = chip_smoke.softmax_gate(kern(x), ref.softmax(x, **kw))
                if not ok:
                    sys.exit(f"ab_elementwise: gs_softmax {name} {shape} {dtype}: {err} "
                             f"({limit})")
                plan = plan_of(shape[1], x.element_size(), 0)
                rows[(f"gs_softmax {name}", label)] = dict(
                    queued_ms=[chip_smoke.queued_ms(fn, 50)], plan=list(plan),
                    grid=gs_softmax.grid_size(shape[0], plan, *gs_softmax.grid_limits(
                        dev, dtype == torch.bfloat16, plan)),
                    shape=f"{shape} {str(dtype).split('.')[-1]} p=7", max_err=err)
            finally:
                gs_softmax.launch_plan = chosen
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--kernels", default="elementwise",
                    choices=("elementwise", "rmsnorm", "fixed_rmsnorm", "fixed_recip_softmax",
                             "fixed_recip_words", "softmax", "softmax_clusters", "flash"))
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        sys.exit("ab_elementwise: torch finds no CUDA device")
    from repro_torch.kernels import build, gs_elementwise, gs_fixed, gs_rmsnorm, gs_softmax

    for module in (gs_elementwise, gs_rmsnorm, gs_fixed, gs_softmax):
        if Path(module.__file__).resolve().parents[2] != src:
            sys.exit(f"ab_elementwise: imported {module.__file__}, not the one under {src}")
    print(chip_smoke.nvidia_smi_line())
    timed = {"elementwise": chip_smoke.time_bench_kernels, "rmsnorm": chip_smoke.time_rmsnorm,
             "fixed_rmsnorm": chip_smoke.time_fixed_rmsnorm,
             "fixed_recip_softmax": chip_smoke.time_fixed_recip_softmax,
             "fixed_recip_words": time_fixed_recip_words,
             "softmax": lambda: chip_smoke.time_bench_kernels(("gs_softmax",)),
             "softmax_clusters": time_softmax_clusters,
             "flash": chip_smoke.time_flash}[args.kernels]
    with chip_smoke.SampledClocks() as clocks:
        rows = timed()
    line = {"label": args.label, "src": str(src), "kernels": args.kernels,
            "clocks": clocks.summary(),
            "rows": [{"kernel": k, "label": label, **r} for (k, label), r in rows.items()]}
    if args.kernels.startswith("fixed"):
        line["sass"] = chip_smoke.sass_digests(chip_smoke.FIXED_OTHERS,
                                               chip_smoke.sass(build.library_path()))
    elif args.kernels == "flash":
        line["nan_classes"] = {f"causal={causal}": chip_smoke.flash_nan_classes(causal)
                               for causal in (True, False)}
    elif args.kernels.startswith("softmax"):
        line["sass"] = chip_smoke.sass_digests(chip_smoke.FLOAT_OTHERS,
                                               chip_smoke.sass(build.library_path()))
    print(json.dumps(line))


if __name__ == "__main__":
    main()
