"""Simulated failure and straggler injection for the training driver.

Counterpart of the training half of ``repro.runtime.failures``: a
``ChipFailure`` aborts the step loop the way a device error surfaces (an
exception out of the host loop), and ``StragglerClock`` skews per-step wall
times so the EWMA detector has something to find.  The reference's random
failure rate and its serving injectors are not ported (ROADMAP A10).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


class ChipFailure(RuntimeError):
    """Stands in for a device/host loss surfaced to the host loop."""


@dataclasses.dataclass
class FailureInjector:
    """Deterministic scripted failures: fail at the given steps (once each)."""

    fail_at_steps: tuple = ()

    def __post_init__(self):
        self._fired = set()

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise ChipFailure(f"simulated chip loss at step {step}")


@dataclasses.dataclass
class StragglerClock:
    """Synthetic per-step durations with a persistent slow host.

    ``sample(step)`` returns the simulated step time: baseline noise, plus
    a multiplicative slowdown when the scripted straggler is active.
    """

    base: float = 1.0
    jitter: float = 0.05
    slow_from: Optional[int] = None
    slow_factor: float = 3.0
    seed: int = 1

    def __post_init__(self):
        self._rng = np.random.Generator(np.random.Philox(self.seed))

    def sample(self, step: int) -> float:
        t = self.base * (1.0 + self.jitter * self._rng.standard_normal())
        if self.slow_from is not None and step >= self.slow_from:
            t *= self.slow_factor
        return max(t, 1e-6)


@dataclasses.dataclass
class StragglerDetector:
    """EWMA step-time monitor: flags a persistent outlier host/step stream.

    Mirrors production practice: alert when the instantaneous step time
    exceeds ``threshold`` x the EWMA for ``patience`` consecutive steps —
    the driver then triggers the elastic re-mesh path.
    """

    alpha: float = 0.1
    threshold: float = 2.0
    patience: int = 3

    ewma: Optional[float] = None
    strikes: int = 0

    def observe(self, dt: float) -> bool:
        if self.ewma is None:
            self.ewma = dt
            return False
        is_slow = dt > self.threshold * self.ewma
        self.strikes = self.strikes + 1 if is_slow else 0
        # EWMA tracks only non-outlier samples so a straggler can't hide
        # by dragging the baseline up.
        if not is_slow:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return self.strikes >= self.patience
