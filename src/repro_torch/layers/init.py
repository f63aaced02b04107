"""Parameter initialization from an explicit ``torch.Generator``.

The numbers differ from the reference's ``jax.random`` draws for the same
seed; tests that compare the two packages hand the reference's parameters
to the port through :mod:`repro_torch.bridge`.
"""

from __future__ import annotations

import math

import torch


def trunc_normal(shape, stddev: float, generator: torch.Generator,
                 device) -> torch.Tensor:
    """f32 normal of ``stddev`` truncated to ±2·stddev (inverse-CDF draw)."""
    lim = math.erf(2.0 / math.sqrt(2.0))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.uniform_(-lim, lim, generator=generator).erfinv_()
    return t.mul_(stddev * math.sqrt(2.0)).clamp_(-2.0 * stddev, 2.0 * stddev)


def dense_init(fan_in: int, shape, generator: torch.Generator, device) -> torch.Tensor:
    """Variance-scaling init (stddev = 1/sqrt(fan_in))."""
    return trunc_normal(shape, fan_in ** -0.5, generator, device)
