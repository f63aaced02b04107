"""Training launcher: the fault-tolerant driver around the port's train step.

  # full-width tinyllama-1.1b on the card, a few steps:
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --steps 10 --batch 4 --seq 512

  # the smoke config on the CPU (plain versions of the kernels):
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --smoke --steps 8 --batch 2 --seq 32 --device cpu

Each step takes a synthetic step-addressed batch, the loss and its
gradients through the kernels' backward rules, global-norm clipping and one
fused Goldschmidt AdamW step under a cosine (or WSD) schedule; checkpoints
are written every ``--ckpt-every`` steps and at the end, in the reference's
layout.  ``--fail-at`` injects simulated chip losses that the driver
recovers from its last checkpoint.  Parameters are random, drawn from
``--seed``.  The reference's mesh and error-feedback compression flags are
not ported yet (ROADMAP A13).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

import numpy as np

from repro_torch import bridge, configs
from repro_torch.checkpoint import config_fingerprint
from repro_torch.data.synthetic import SyntheticLM, make_batch
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.launch.steps import TrainHParams, make_train_step
from repro_torch.models import api
from repro_torch.optim import adamw_init
from repro_torch.runtime.driver import (DEFAULT_CHECKPOINT_DIR, DriverConfig,
                                        TrainState, run_training)
from repro_torch.runtime.failures import FailureInjector


def build(args):
    """(cfg, run_training keyword arguments) for parsed CLI arguments."""
    cfg = (configs.get_smoke(args.arch) if args.smoke else configs.get_config(args.arch))
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    device = resolve_device(args.device)
    hp = TrainHParams(peak_lr=args.lr, warmup=min(20, args.steps // 4), total=args.steps,
                      schedule="wsd" if cfg.name.startswith("minicpm") else "cosine")
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
                     seed=args.seed)

    def init_state() -> TrainState:
        params = api.init(cfg, seed=args.seed, device=device)
        return TrainState(params, adamw_init(params), 0)

    return cfg, dict(
        cfg=DriverConfig(total_steps=args.steps, checkpoint_every=args.ckpt_every,
                         checkpoint_dir=args.ckpt_dir),
        init_state=init_state,
        make_step_fn=lambda: make_train_step(cfg, hp),
        make_batch=lambda step: make_batch(ds, step, device),
        to_saved=lambda s: bridge.state_to_numpy(s.params, s.opt_state),
        from_saved=lambda tree: bridge.state_from_numpy(tree, cfg, device),
        fingerprint=config_fingerprint(cfg),
        injector=FailureInjector(fail_at_steps=tuple(args.fail_at)),
        log_every=args.log_every)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", help="the reduced config")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CHECKPOINT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject simulated chip failures at these steps")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default=None, choices=("float32", "bfloat16"),
                    help="activation dtype (default: the config's)")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--log-every", type=int, default=10)
    return ap


def main() -> None:
    args = parser().parse_args()
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    _, kw = build(args)
    stats = run_training(**kw)
    losses = [stats["losses"][s] for s in sorted(stats["losses"])]
    trend = (f"loss {np.mean(losses[:5]):.4f} -> {np.mean(losses[-5:]):.4f}" if losses
             else f"no step left to run after the checkpoint in {args.ckpt_dir}")
    print(f"done: steps={stats['state'].step} restarts={stats['restarts']} "
          f"remeshes={stats['remeshes']} {trend}")


if __name__ == "__main__":
    main()
