"""Train, prefill and decode step functions (counterpart of
``repro.launch.steps``).

PyTorch runs eagerly, so there is no jit and no mesh here.  A serving step
is the model call under ``torch.no_grad``; a train step takes the loss and
its gradients with autograd (through the kernels' backward rules), then one
fused AdamW step, and returns new parameters and state as the reference's
does.  The serving steps take a float or an int8-quantized parameter tree;
an int8 tree stays int8 on the card and each weight is dequantized as the
model reads it (:func:`~repro_torch.layers.quant.maybe_dequantize`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.layers.quant import maybe_dequantize
from repro_torch.models import api
from repro_torch.optim import adamw_update, cosine, wsd
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    peak_lr: float = 3e-4
    warmup: int = 100
    total: int = 10_000
    schedule: str = "cosine"  # cosine | wsd (minicpm)
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    beta1: float = 0.9
    beta2: float = 0.95


def lr_at(hp: TrainHParams, step) -> torch.Tensor:
    if hp.schedule == "wsd":
        return wsd(step, peak_lr=hp.peak_lr, warmup=hp.warmup,
                   stable=int(hp.total * 0.8), decay=int(hp.total * 0.1))
    return cosine(step, peak_lr=hp.peak_lr, warmup=hp.warmup, total=hp.total)


def make_train_step(cfg: ArchConfig, hp: TrainHParams) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``.  The learning rate is the schedule at the
    state's step before the update, as in the reference; the optimizer's
    Goldschmidt budget is the param dtype's (``cfg.optimizer_policy()``)."""
    opt_policy = cfg.optimizer_policy()

    def train_step(params, opt_state, batch):
        # leaves that autograd tracks, sharing storage with ``params``
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss = api.loss_fn(cfg, live, batch)
            grads = torch.autograd.grad(loss, tree_leaves(live))
        new_params, new_opt, metrics = adamw_update(
            params, tree_unflatten(params, list(grads)), opt_state,
            lr=lr_at(hp, opt_state["step"]), policy=opt_policy, beta1=hp.beta1,
            beta2=hp.beta2, weight_decay=hp.weight_decay, clip_norm=hp.clip_norm)
        return new_params, new_opt, {"loss": loss.detach(), **metrics}

    return train_step


def make_prefill_step(cfg: ArchConfig) -> Callable:
    @torch.no_grad()
    def prefill_step(params, batch):
        return api.prefill(cfg, maybe_dequantize(params), batch)

    return prefill_step


def make_decode_step(cfg: ArchConfig) -> Callable:
    @torch.no_grad()
    def decode_step(params, states, cur_index, batch):
        return api.decode_step(cfg, maybe_dequantize(params), states, cur_index, batch)

    return decode_step
