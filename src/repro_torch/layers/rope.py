"""Rotary position embeddings (rotate-half convention)."""

from __future__ import annotations

import torch


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (b, s) -> cos/sin (b, s, head_dim//2), f32."""
    half = head_dim // 2
    inv_freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                       device=positions.device) / half)
    ang = positions[..., None].to(torch.float32) * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (b, s, h, d); cos/sin (b, s, d//2)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
