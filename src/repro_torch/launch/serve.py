"""Serving launcher: a thin CLI over the port's continuous-batching engine.

  # 4 identical requests through 4 slots on the card:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --batch 4 --prompt-len 97 --gen 32

  # a Poisson-arrival trace of 12 requests, smoke config, on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --smoke --trace 12 --rate 40 --batch 4 --dtype float32 --device cpu

  # int8 weights and KV through the fixed-point datapath, on the card:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --dtype float32 --quant int8 --batch 4 --prompt-len 97 --gen 32

Parameters are random, drawn from ``--seed``.  Requests are greedy.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch import configs
from repro_torch.layers.quant import tree_bytes
from repro_torch.models import api
from repro_torch.serving import Engine, EngineConfig, Request


def build_requests(args, cfg, rng: np.random.RandomState):
    """Either --batch identical requests at t=0, or a Poisson trace with
    prompt and generation lengths drawn from [len/2, len]."""
    if args.prompt_len < 1 or args.gen < 1:
        raise SystemExit("--prompt-len and --gen must be >= 1")
    if args.trace and args.rate <= 0:
        raise SystemExit("--rate must be > 0 (requests/second)")
    if not args.trace:
        prompt = rng.randint(0, cfg.vocab, (args.prompt_len,))
        return [Request(rid=i, prompt=prompt, max_new_tokens=args.gen)
                for i in range(args.batch)]
    t, reqs = 0.0, []
    for i in range(args.trace):
        t += float(rng.exponential(1.0 / args.rate))
        plen = int(rng.randint(max(1, args.prompt_len // 2), args.prompt_len + 1))
        reqs.append(Request(
            rid=i, prompt=rng.randint(0, cfg.vocab, (plen,)),
            max_new_tokens=int(rng.randint(max(1, args.gen // 2), args.gen + 1)),
            arrival_time=t))
    return reqs


def report(res) -> None:
    m = res.metrics
    ttft = np.asarray(sorted(m.ttft_s.values())) * 1e3
    print(f"{m.n_requests} requests through {m.n_slots} slots: prefill "
          f"{m.prefill_tokens} prompt tokens in {m.prefill_time_s * 1e3:.1f} ms; "
          f"decode {m.decode_tokens} tokens in {m.decode_ticks} ticks / "
          f"{m.decode_time_s * 1e3:.1f} ms ({m.decode_tok_per_s:.1f} tok/s, "
          f"occupancy {m.occupancy:.2f}); KV cache {m.cache_bytes / 1e6:.1f} MB")
    if ttft.size:
        print(f"  TTFT ms: min {ttft.min():.1f} / p50 {np.median(ttft):.1f} / "
              f"max {ttft.max():.1f}; failed {m.failed}")
    if m.itl_samples:
        print(f"  ITL ms ({len(m.itl_samples)} samples): p50 "
              f"{np.median(m.itl_samples) * 1e3:.1f} / max {max(m.itl_samples) * 1e3:.1f}")
    for rid in sorted(res.results)[:4]:
        print(f"  req {rid}:", res[rid].tokens[:24].tolist())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="slot-pool width; without --trace, also the number of requests")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--trace", type=int, default=0, metavar="N",
                    help="serve N Poisson-arrival requests of varied lengths")
    ap.add_argument("--rate", type=float, default=50.0,
                    help="--trace arrival rate, requests/second")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default=None, choices=("float32", "bfloat16"),
                    help="activation dtype (default: the config's)")
    ap.add_argument("--quant", choices=("none", "int8"), default="none",
                    help="int8: per-tensor int8 weights and an int8 KV cache on "
                         "the static KV scale; every division site runs the "
                         "fixed-point Goldschmidt datapath")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get_config(args.arch)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    cfg = dataclasses.replace(cfg, quant=args.quant)
    s_max = args.prompt_len + args.gen
    if s_max > cfg.max_seq:
        raise SystemExit(f"--prompt-len + --gen = {s_max} exceeds max_seq {cfg.max_seq}")
    rng = np.random.RandomState(args.seed)
    t0 = time.perf_counter()
    params = api.init(cfg, seed=args.seed, device=args.device)
    engine = Engine(cfg, params, EngineConfig(n_slots=args.batch, s_max=s_max),
                    device=args.device)
    reqs = build_requests(args, cfg, rng)
    # warm-up: builds the kernels and the libraries' handles before timing
    engine.run([Request(rid=0, prompt=reqs[0].prompt, max_new_tokens=2)])
    print(f"set-up {time.perf_counter() - t0:.1f} s ({cfg.name}, {cfg.dtype}, "
          f"quant {cfg.quant}, {args.device}); resident params "
          f"{tree_bytes(engine.params) / 1e6:.1f} MB")
    report(engine.run(reqs))


if __name__ == "__main__":
    main()
