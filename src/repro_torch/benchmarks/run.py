"""Benchmark entry point of the port (counterpart of ``benchmarks/run.py``).

    python -m repro_torch.benchmarks.run [--only kernels] [--device cuda|cpu]
    python -m repro_torch.benchmarks.run --smoke --check [--json PATH]

Prints ``name,us_per_call,derived`` CSV.  Without ``--smoke``, ``--json``
or ``--check`` it runs one call per kernel against its exact oracle.  With
any of them it runs the kernel sweep (:func:`bench_kernels.records`; one
timing repeat with ``--smoke``, smaller inputs), writes its rows to
``BENCH_kernels_torch.json`` at the repository root (or ``--json PATH``),
and with ``--check`` exits 1 if any row's max error exceeds its bound.

It runs on the card unless ``--device cpu`` asks for the plain PyTorch
versions; ``cuda`` on a host without a GPU raises.  Only the kernels
section is ported: the reference's cycles, accuracy, divider and roofline
sections, its ``--serve`` benchmark and its tuned-vs-default rows wait for
the port's tuning and serving benchmark.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from repro_torch.benchmarks import bench_kernels
from repro_torch.device import DEFAULT_DEVICE, resolve_device

SECTIONS = ("kernels",)
DEFAULT_JSON = Path(__file__).resolve().parents[3] / "BENCH_kernels_torch.json"


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _kernel_records(smoke: bool, json_path, device: torch.device) -> list:
    recs = bench_kernels.records(smoke=smoke, device=device)
    with open(json_path, "w") as f:
        json.dump({"smoke": smoke, "device": device_name(device), "rows": recs}, f, indent=2)
    for r in recs:
        cfg = r["config"]
        pi = f"p={cfg['p']}/i={cfg['iters']}" if cfg else "-"
        print(f"{r['kernel']},{r['us_per_call']},"
              f"\"{r['dtype']} {r['impl']} {r['policy']} {pi} "
              f"err={r['max_err']:.2e} bound={r['err_bound']:.2e} "
              f"ok={r['ok']}\"")
        sys.stdout.flush()
    print(f"# wrote {len(recs)} records to {json_path} ({device_name(device)})",
          file=sys.stderr)
    return recs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=SECTIONS, default=None,
                    help="the section to run; only kernels is ported (the "
                         "reference's cycles, accuracy, divider and roofline "
                         "sections are not yet)")
    ap.add_argument("--smoke", action="store_true",
                    help="kernel records, 1 timing repeat, smaller inputs, write JSON")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help=f"write kernel records here (default {DEFAULT_JSON.name} at "
                         "the repository root when --smoke/--check)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if any kernel max-err exceeds its bound")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (the kernels, the default) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print("name,us_per_call,derived")
    if args.smoke or args.json or args.check:
        recs = _kernel_records(args.smoke, args.json or DEFAULT_JSON, device)
        if args.check:
            bad = [r for r in recs if not r["ok"]]
            for r in bad:
                print(f"# REGRESSION {r['kernel']} {r['dtype']} {r['impl']}/{r['policy']}: "
                      f"max_err={r['max_err']:.2e} > bound={r['err_bound']:.2e}",
                      file=sys.stderr)
            if bad:
                sys.exit(1)
        return
    for r in bench_kernels.rows(device):
        print(f"{r['name']},{r['us_per_call']},\"{r['derived']}\"")
        sys.stdout.flush()


if __name__ == "__main__":
    main()
