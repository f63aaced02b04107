"""LR schedules: cosine and WSD (warmup-stable-decay, MiniCPM).

Counterpart of ``repro.optim.schedules``, on tensors: ``step`` may be an
int or a tensor on the device (the optimizer's step counter), and the
result is an f32 tensor on the same device, so no step reads the host.
"""

from __future__ import annotations

import math

import torch


def _as_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine(step, *, peak_lr: float, warmup: int, total: int,
           min_ratio: float = 0.1) -> torch.Tensor:
    s = _as_f32(step)
    warm = s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return peak_lr * torch.where(s < warmup, warm, cos)


def wsd(step, *, peak_lr: float, warmup: int, stable: int, decay: int,
        min_ratio: float = 0.01) -> torch.Tensor:
    """Warmup -> stable plateau -> (exponential-ish) decay.  MiniCPM §4."""
    s = _as_f32(step)
    warm = s / max(warmup, 1)
    in_decay = torch.clamp((s - warmup - stable) / max(decay, 1), 0.0, 1.0)
    dec = min_ratio ** in_decay  # exp decay from 1 -> min_ratio
    one = torch.ones_like(s)
    lr = torch.where(s < warmup, warm, torch.where(s < warmup + stable, one, dec))
    return peak_lr * lr
