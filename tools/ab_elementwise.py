#!/usr/bin/env python3
"""Time ``chip_smoke.py``'s phase 8d rows (gs_recip, gs_rsqrt / gs_sqrt,
gs_softmax) against one copy of the port, so that one call on a card can
compare two trees with the same timing code.

    python3 tools/ab_elementwise.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported: this
checkout's by default, or that of another commit's ``git archive`` unpacked
under an ignored directory (its kernels build under that tree's ``build/``).
Run the sides in turns (A, B, B, A) in one call.  Prints the card's name and
power limit, then one JSON line ``{"label", "src", "clocks", "rows": [...]}``
with each row's times in ms and the SM and memory clocks nvidia-smi sampled
while they were taken.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        sys.exit("ab_elementwise: torch finds no CUDA device")
    from repro_torch.kernels import gs_elementwise

    if Path(gs_elementwise.__file__).resolve().parents[2] != src:
        sys.exit(f"ab_elementwise: imported {gs_elementwise.__file__}, not the one under {src}")
    print(chip_smoke.nvidia_smi_line())
    with chip_smoke.SampledClocks() as clocks:
        rows = chip_smoke.time_bench_kernels()
    print(json.dumps({"label": args.label, "src": str(src), "clocks": clocks.summary(),
                      "rows": [{"kernel": k, "label": label, **r}
                               for (k, label), r in rows.items()]}))


if __name__ == "__main__":
    main()
