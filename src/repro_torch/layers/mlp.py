"""Gated MLP (SwiGLU)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.layers.init import dense_init


def mlp_init(generator: torch.Generator, d_model: int, d_ff: int, device) -> dict:
    return {
        "w_in": dense_init(d_model, (d_model, d_ff), generator, device),
        "w_out": dense_init(d_ff, (d_ff, d_model), generator, device),
        "w_gate": dense_init(d_model, (d_model, d_ff), generator, device),
    }


def mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = x @ params["w_in"].to(dt)
    h = F.silu(x @ params["w_gate"].to(dt)) * h
    return h @ params["w_out"].to(dt)
