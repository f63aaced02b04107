"""GQA attention with a Goldschmidt softmax (counterpart of
``repro.layers.attention``).

Layouts follow the reference: ``(b, s, H, hd)`` at this layer's functions,
``(B, H, S, D)`` at the kernel's.  Prefill attention runs the flash kernel
front-end; decode attention is tensor ops around ``policy.softmax`` over
the masked cache; ``flash_chunked`` is the reference's chunked
online-softmax in tensor ops (the kernel benchmark's baseline for the
flash rows).  An int8 cache (the quantized serving path) is written
through ``kv_cast``, which quantizes on the static KV scale, and read
through ``kv_dequantize``; a float cache just casts.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core.formats import kv_cast, kv_dequantize
from repro_torch.core.policy import NumericsPolicy
from repro_torch.kernels import ops
from repro_torch.kernels.common import NEG_INF
from repro_torch.layers.init import dense_init


def attn_init(generator: torch.Generator, d_model: int, n_heads: int,
              n_kv_heads: int, head_dim: int, device) -> dict:
    return {
        "wq": dense_init(d_model, (d_model, n_heads, head_dim), generator, device),
        "wk": dense_init(d_model, (d_model, n_kv_heads, head_dim), generator, device),
        "wv": dense_init(d_model, (d_model, n_kv_heads, head_dim), generator, device),
        "wo": dense_init(n_heads * head_dim, (n_heads, head_dim, d_model),
                         generator, device),
    }


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (b, s, d) @ w (d, h, k) -> (b, s, h, k) in x's dtype."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k).to(x.dtype)).reshape(*x.shape[:2], h, k)


def qkv(params, x: torch.Tensor):
    """x (b,s,d) -> q (b,s,H,hd), k/v (b,s,KH,hd) in x.dtype."""
    return (_project(x, params["wq"]), _project(x, params["wk"]),
            _project(x, params["wv"]))


def out_proj(params, o: torch.Tensor) -> torch.Tensor:
    """o (b,s,H,hd) -> (b,s,d)."""
    h, k, d = params["wo"].shape
    return o.reshape(*o.shape[:2], h * k) @ params["wo"].reshape(h * k, d).to(o.dtype)


def expand_kv_heads(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(b, s, KH, hd) -> (b, s, H, hd): head h reads KV head h // group."""
    group = n_heads // k.shape[2]
    idx = torch.arange(n_heads, device=k.device) // group
    return k.index_select(2, idx)


def flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          policy: NumericsPolicy, causal: bool = True,
          sm_scale: Optional[float] = None) -> torch.Tensor:
    """Prefill attention through the flash kernel front-end.
    q (b, s, H, hd), k/v (b, s, KH, hd) -> (b, s, H, hd)."""
    def heads_major(t):
        return t.transpose(1, 2).contiguous()

    o = ops.flash_attention(heads_major(q), heads_major(k), heads_major(v),
                            causal=causal, sm_scale=sm_scale,
                            variant=policy.variant,
                            **policy.kernel_precision(q.dtype))
    return o.transpose(1, 2)


def fit_block(s: int, target: int) -> int:
    """Largest divisor of ``s`` that is <= ``target``."""
    blk = min(max(int(target), 1), int(s))
    while s % blk:
        blk -= 1
    return blk


def flash_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  policy: NumericsPolicy, causal: bool = True, q_block: int = 512,
                  kv_block: int = 1024, sm_scale: Optional[float] = None) -> torch.Tensor:
    """Double-chunked online-softmax attention in tensor ops (the
    reference's ``flash_chunked`` with its default serial q blocks).

    q (b, sq, H, hd), k/v (b, sk, KH, hd) -> (b, sq, H, hd) in q's dtype.
    Each q block runs over every kv block with a running max and an
    unnormalized sum in f32; the one normalization is
    ``acc · policy.reciprocal(max(l, 1e-30))`` at the block's end.  Masked
    logits take ``NEG_INF``.  Blocks are the largest divisors of the lengths
    that fit ``q_block`` / ``kv_block``.
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    if causal and sq != sk:
        raise ValueError(f"causal flash_chunked needs aligned self-attention, got {sq} vs {sk}")
    q_block, kv_block = fit_block(sq, q_block), fit_block(sk, kv_block)
    # scaled in q's dtype, as the reference scales before the f32 products
    qg = (q.permute(0, 2, 3, 1) * sm_scale).to(torch.float32)  # (b, H, hd, sq)
    kT = expand_kv_heads(k, h).permute(0, 2, 3, 1).to(torch.float32)  # (b, H, hd, sk)
    vT = expand_kv_heads(v, h).transpose(1, 2).to(torch.float32)  # (b, H, sk, hd)
    outs = []
    for row0 in range(0, sq, q_block):
        qb = qg[..., row0:row0 + q_block]
        acc = torch.zeros(b, h, q_block, hd, dtype=torch.float32, device=q.device)
        m = torch.full((b, h, q_block, 1), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros(b, h, q_block, 1, dtype=torch.float32, device=q.device)
        for col0 in range(0, sk, kv_block):
            sblk = torch.einsum("bhdq,bhdt->bhqt", qb, kT[..., col0:col0 + kv_block])
            if causal:
                rows = row0 + torch.arange(q_block, device=q.device)[:, None]
                cols = col0 + torch.arange(kv_block, device=q.device)[None, :]
                sblk = torch.where(rows >= cols, sblk, NEG_INF)
            m_new = torch.maximum(m, torch.amax(sblk, dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            e = torch.exp(sblk - m_new)
            l = l * alpha + torch.sum(e, dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhqt,bhtd->bhqd", e,
                                             vT[:, :, col0:col0 + kv_block])
            m = m_new
        outs.append((acc * policy.reciprocal(torch.clamp_min(l, 1e-30))).to(q.dtype))
    return torch.cat(outs, dim=2).transpose(1, 2)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_index: torch.Tensor, *,
                     policy: NumericsPolicy,
                     sm_scale: Optional[float] = None) -> torch.Tensor:
    """One new token per row against a (b, S, KH, hd) cache.

    ``cur_index`` (b,) holds each row's last valid cache position.  Masked
    logits take ``NEG_INF``; masked V rows are zeroed before the V product,
    because their probability is an exact 0 but 0·NaN is NaN: a stale NaN
    row beyond ``cur`` (left by a quarantined request) can then never reach
    the next occupant of the slot.
    """
    b, _, h, hd = q.shape
    S, kh = k_cache.shape[1], k_cache.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, kh, h // kh, hd).to(torch.float32)
    logits = torch.einsum("bkgd,btkd->bkgt", qg, kv_dequantize(k_cache)) * sm_scale
    valid = torch.arange(S, device=q.device)[None, :] <= cur_index[:, None]  # (b, S)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    probs = policy.softmax(logits, dim=-1)
    v = torch.where(valid[:, :, None, None], kv_dequantize(v_cache), 0.0)
    o = torch.einsum("bkgt,btkd->bkgd", probs, v)
    return o.reshape(b, 1, h, hd).to(q.dtype)


def cache_update(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor,
                 cur_index: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write (b, 1, KH, hd) new K/V at each row's ``cur_index`` (b,).

    Updates the caches in place (the reference returns new arrays from a
    donated buffer) and returns them.
    """
    rows = torch.arange(k_cache.shape[0], device=k_cache.device)
    k_cache[rows, cur_index] = kv_cast(k_new[:, 0], k_cache.dtype)
    v_cache[rows, cur_index] = kv_cast(v_new[:, 0], v_cache.dtype)
    return k_cache, v_cache
