"""Prefill and decode step functions (counterpart of ``repro.launch.steps``).

PyTorch runs eagerly, so there is no jit and no mesh here: a step is the
model call under ``torch.no_grad``.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import api


def make_prefill_step(cfg: ArchConfig) -> Callable:
    @torch.no_grad()
    def prefill_step(params, batch):
        return api.prefill(cfg, params, batch)

    return prefill_step


def make_decode_step(cfg: ArchConfig) -> Callable:
    @torch.no_grad()
    def decode_step(params, states, cur_index, batch):
        return api.decode_step(cfg, params, states, cur_index, batch)

    return decode_step
