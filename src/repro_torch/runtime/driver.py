"""Fault-tolerant training driver (counterpart of ``repro.runtime.driver``).

    restore-or-init -> [step; observe clock; periodic async checkpoint]
    on ChipFailure      -> restore the latest checkpoint, rebuild the step
                           function, resume
    on straggler alarm  -> checkpoint, rebuild the step function (on one
                           card the reference's elastic re-mesh is just
                           that), continue

The data are addressed by global step (:mod:`repro_torch.data.synthetic`)
and a checkpoint holds the whole state, so a restart resumes bit-exactly on
the step after the last checkpoint.  Checkpoints are written in the
reference's layout: ``to_saved`` turns a state into that tree and
``from_saved`` turns it back (:func:`repro_torch.bridge.state_to_numpy`
and :func:`~repro_torch.bridge.state_from_numpy`).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.checkpoint import CheckpointManager
from repro_torch.runtime.failures import (ChipFailure, FailureInjector,
                                          StragglerClock, StragglerDetector)
from repro_torch.tree import tree_leaves

log = logging.getLogger("repro_torch.driver")

# inside the repository's ignored build/ directory
DEFAULT_CHECKPOINT_DIR = str(Path(__file__).resolve().parents[3] / "build" / "checkpoints")
KEEP_CHECKPOINTS = 2  # the newest checkpoints kept on disk
MAX_RESTARTS = 8  # restarts after ChipFailure before the failure is raised


@dataclasses.dataclass
class DriverConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    checkpoint_dir: str = DEFAULT_CHECKPOINT_DIR


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0


def _restore(mgr: CheckpointManager, fresh: TrainState,
             from_saved: Callable[[Dict], Tuple[Any, Any]]) -> TrainState:
    """The latest checkpoint as a state shaped like ``fresh``, or ``fresh``."""
    tree, manifest = mgr.restore_latest()
    if tree is None:
        return fresh
    params, opt_state = from_saved(tree)
    got = [tuple(t.shape) for t in tree_leaves((params, opt_state))]
    want = [tuple(t.shape) for t in tree_leaves((fresh.params, fresh.opt_state))]
    if got != want:
        raise ValueError(f"checkpoint in {mgr.directory} does not match the "
                         "model's state tree")
    log.info("restored checkpoint at step %d", manifest["step"])
    return TrainState(params, opt_state, int(manifest["step"]))


def run_training(
    *,
    cfg: DriverConfig,
    init_state: Callable[[], TrainState],
    make_step_fn: Callable[[], Callable],  # rebuilt after failures
    make_batch: Callable[[int], Any],
    to_saved: Callable[[TrainState], Dict],
    from_saved: Callable[[Dict], Tuple[Any, Any]],
    fingerprint: str = "",
    injector: Optional[FailureInjector] = None,
    clock: Optional[StragglerClock] = None,
    log_every: int = 10,
) -> Dict[str, Any]:
    """Run to ``total_steps`` surviving injected failures.  Returns stats:
    the final state, the loss of every step, restarts and re-meshes."""
    mgr = CheckpointManager(cfg.checkpoint_dir, keep=KEEP_CHECKPOINTS, fingerprint=fingerprint)
    detector = StragglerDetector()
    restarts = 0
    remeshes = 0
    losses: Dict[int, float] = {}

    state = _restore(mgr, init_state(), from_saved)
    step_fn = make_step_fn()
    while state.step < cfg.total_steps:
        try:
            step = state.step
            t0 = time.monotonic()
            if injector is not None:
                injector.check(step)
            batch = make_batch(step)
            params, opt_state, metrics = step_fn(state.params, state.opt_state, batch)
            state = TrainState(params, opt_state, step + 1)
            losses[step] = float(metrics["loss"])  # waits for the step
            dt = clock.sample(step) if clock is not None else time.monotonic() - t0
            if log_every and step % log_every == 0:
                log.info("step %d loss %.4f (%.3fs)", step, losses[step], dt)
            if detector.observe(dt):
                log.warning("straggler detected at step %d -> re-mesh", step)
                remeshes += 1
                detector = StragglerDetector()
                if clock is not None:
                    clock.slow_from = None  # the slow host left the job
                mgr.save(state.step, to_saved(state), blocking=True)
                step_fn = make_step_fn()
            elif state.step % cfg.checkpoint_every == 0:
                mgr.save(state.step, to_saved(state))
        except ChipFailure as e:
            restarts += 1
            log.warning("%s -> restart %d", e, restarts)
            if restarts > MAX_RESTARTS:
                raise
            state = _restore(mgr, init_state(), from_saved)
            step_fn = make_step_fn()

    mgr.save(state.step, to_saved(state), blocking=True)
    mgr.wait()
    return {"state": state, "losses": losses, "restarts": restarts,
            "remeshes": remeshes}
