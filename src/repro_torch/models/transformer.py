"""Decoder-only LM, dense family (counterpart of ``repro.models.transformer``).

The reference scans a stacked layer axis; here ``_stack`` is a Python loop
over a list of per-layer parameter dicts, and decode states are a list of
per-layer ``{"k", "v"}`` caches of shape (b, S, KH, hd).  The reference
wraps the scanned body in ``jax.checkpoint`` for training (remat); that
changes no number and is not ported yet (ROADMAP A7).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.layers.init import dense_init, trunc_normal
from repro_torch.layers.norms import rmsnorm, rmsnorm_init
from repro_torch.layers.rope import rope_cos_sin
from repro_torch.models import blocks

Params = Dict[str, Any]
States = List[Dict[str, torch.Tensor]]


def init(cfg: ArchConfig, generator: torch.Generator, device) -> Params:
    return {
        "embed": trunc_normal((cfg.vocab, cfg.d_model), 0.02, generator, device),
        "layers": [blocks.block_init(generator, cfg, device)
                   for _ in range(cfg.n_layers)],
        "final_norm": rmsnorm_init(cfg.d_model, device),
        "lm_head": dense_init(cfg.d_model, (cfg.d_model, cfg.vocab), generator, device),
    }


def embed_tokens(cfg: ArchConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens].to(cfg.compute_dtype)


def unembed(cfg: ArchConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(params["final_norm"], x, eps=cfg.norm_eps, policy=cfg.policy())
    return h @ params["lm_head"].to(h.dtype)


def _stack(cfg: ArchConfig, params: Params, x: torch.Tensor, *, mode: str,
           rope_cs, states: Optional[States] = None,
           cur_index: Optional[torch.Tensor] = None):
    new_states = []
    for i, layer in enumerate(params["layers"]):
        x, st = blocks.block_apply(
            cfg, layer, x, mode=mode, rope_cs=rope_cs,
            state=states[i] if states is not None else None, cur_index=cur_index)
        new_states.append(st)
    return x, new_states


def _positions_rope(cfg: ArchConfig, tokens: torch.Tensor):
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    return rope_cos_sin(positions, cfg.head_dim_, cfg.rope_theta)


def forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Training forward: tokens (b, s) -> logits (b, s, vocab)."""
    x, _ = _stack(cfg, params, embed_tokens(cfg, params, tokens), mode="train",
                  rope_cs=_positions_rope(cfg, tokens))
    return unembed(cfg, params, x)


def loss_fn(cfg: ArchConfig, params: Params, batch) -> torch.Tensor:
    """Mean next-token cross-entropy (log-domain: division-free)."""
    return cross_entropy(forward(cfg, params, batch["tokens"]), batch["labels"])


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``mean(log Σ exp(l - m) + m - l[label])`` with the max ``m`` held
    constant under differentiation, as in the reference."""
    lf = logits.to(torch.float32)
    m = torch.amax(lf, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
    gold = torch.gather(lf, -1, labels[..., None].to(torch.int64))[..., 0]
    return torch.mean(lse - gold)


def prefill(cfg: ArchConfig, params: Params, tokens: torch.Tensor):
    """tokens (b, s) -> (last-position logits (b, 1, V), prefill-length
    states, next index s)."""
    x, states = _stack(cfg, params, embed_tokens(cfg, params, tokens),
                       mode="prefill", rope_cs=_positions_rope(cfg, tokens))
    return unembed(cfg, params, x[:, -1:, :]), states, tokens.shape[1]


def decode_step(cfg: ArchConfig, params: Params, states: States,
                cur_index: torch.Tensor, token: torch.Tensor):
    """token (b, 1) at per-row positions ``cur_index`` (b,) -> (logits
    (b, 1, V), states updated in place)."""
    rope_cs = rope_cos_sin(cur_index[:, None], cfg.head_dim_, cfg.rope_theta)
    x, states = _stack(cfg, params, embed_tokens(cfg, params, token),
                       mode="decode", rope_cs=rope_cs, states=states,
                       cur_index=cur_index)
    return unembed(cfg, params, x), states


def make_cache(cfg: ArchConfig, batch: int, s_max: int, dtype,
               device) -> States:
    """Zeroed decode state: one (batch, s_max, KH, hd) K and V per layer, in
    int8 under ``cfg.quant="int8"`` (the static-scale KV cache), else ``dtype``."""
    shape = (batch, s_max, cfg.n_kv_heads, cfg.head_dim_)
    dt = torch.int8 if cfg.quant != "none" else dtype
    return [{"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
            for _ in range(cfg.n_layers)]
