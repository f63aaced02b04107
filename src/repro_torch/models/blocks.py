"""One residual block: norm -> attention -> +res -> norm -> MLP -> +res.

Counterpart of ``repro.models.blocks`` for the dense attention block, in
three modes: ``train`` (full sequence, no state; differentiable end to
end), ``prefill`` (full sequence, emits the layer's K/V) and ``decode``
(one token per row against the layer's cache, updated in place).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.layers import attention as attn
from repro_torch.layers import mlp as mlp_mod
from repro_torch.layers.norms import rmsnorm, rmsnorm_init
from repro_torch.layers.rope import apply_rope


def block_init(generator: torch.Generator, cfg: ArchConfig, device) -> Dict:
    return {
        "norm1": rmsnorm_init(cfg.d_model, device),
        "attn": attn.attn_init(generator, cfg.d_model, cfg.n_heads,
                               cfg.n_kv_heads, cfg.head_dim_, device),
        "norm2": rmsnorm_init(cfg.d_model, device),
        "mlp": mlp_mod.mlp_init(generator, cfg.d_model, cfg.d_ff, device),
    }


def block_apply(cfg: ArchConfig, params: Dict, x: torch.Tensor, *, mode: str,
                rope_cs: Tuple[torch.Tensor, torch.Tensor],
                state: Optional[Dict[str, torch.Tensor]] = None,
                cur_index: Optional[torch.Tensor] = None):
    """x (b, s, d) -> (x, state).  ``train`` returns no state;
    ``prefill`` returns this layer's K/V (b, s, KH, hd); ``decode`` writes
    them into ``state`` at ``cur_index`` and returns ``state``."""
    policy = cfg.policy()
    h = rmsnorm(params["norm1"], x, eps=cfg.norm_eps, policy=policy)
    q, k, v = attn.qkv(params["attn"], h)
    cos, sin = rope_cs
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    if mode == "decode":
        kc, vc = attn.cache_update(state["k"], state["v"], k, v, cur_index)
        o = attn.decode_attention(q, kc, vc, cur_index, policy=policy)
        new_state = state
    elif mode in ("train", "prefill"):
        o = attn.flash(q, k, v, policy=policy, causal=True)
        new_state = {"k": k, "v": v} if mode == "prefill" else None
    else:
        raise ValueError(f"unknown mode {mode!r}")
    x = x + attn.out_proj(params["attn"], o).to(x.dtype)
    h = rmsnorm(params["norm2"], x, eps=cfg.norm_eps, policy=policy)
    x = x + mlp_mod.mlp_apply(params["mlp"], h).to(x.dtype)
    return x, new_state
