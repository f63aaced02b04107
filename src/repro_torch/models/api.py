"""Model facade (counterpart of ``repro.models.api``) for the dense family."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import transformer


def init(cfg: ArchConfig, seed: int = 0, device=DEFAULT_DEVICE):
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (``cuda`` unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    return transformer.init(cfg, generator, dev)


def forward(cfg: ArchConfig, params, batch):
    """Training forward: ``batch["tokens"]`` (b, s) -> logits (b, s, vocab)."""
    return transformer.forward(cfg, params, batch["tokens"])


def loss_fn(cfg: ArchConfig, params, batch):
    """Mean next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]``."""
    return transformer.loss_fn(cfg, params, batch)


def prefill(cfg: ArchConfig, params, batch):
    return transformer.prefill(cfg, params, batch["tokens"])


def decode_step(cfg: ArchConfig, params, states, cur_index, batch,
                page_table=None, page_size: int = 0, kv_len: int = 0):
    """One decode step at per-row positions ``cur_index`` (b,).
    ``page_table``/``page_size`` switch ``states`` to the paged pool's arena
    layout (serving/cache.py ``PagedCachePool``); ``kv_len`` cuts each row's
    dense view of its pages to the slot pool's row length."""
    return transformer.decode_step(cfg, params, states, cur_index, batch["token"],
                                   page_table=page_table, page_size=page_size,
                                   kv_len=kv_len)


def make_cache(cfg: ArchConfig, batch: int, s_max: int, dtype, device):
    return transformer.make_cache(cfg, batch, s_max, dtype, device)
