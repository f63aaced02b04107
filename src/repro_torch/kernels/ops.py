"""Front-end over the kernels (counterpart of ``repro.kernels.ops``).

Each op resolves its Goldschmidt settings, then routes by where its input
lies:

* a CUDA tensor launches the hand-written kernel, or the call raises —
  there is no fallback route and no switch for one;
* a CPU tensor runs the plain PyTorch version (:mod:`kernels.ref`).

Settings are the registry defaults of the reference (``variant`` =
``feedback``, ``p``/``iters`` from the operand dtype's
:func:`~repro_torch.core.goldschmidt.precision_policy` pair unless the
caller pins them, as ``NumericsPolicy.kernel_precision`` does); there is no
autotuning.

``gs_rmsnorm`` and ``flash_attention`` are differentiable where the
reference has a ``custom_vjp``: when autograd records the call, the forward
saves its residuals (the rsqrt column; the row statistics m, l) and the
backward is the reference's rule — a torch expression for the norm, the two
backward kernels for attention.  :func:`launch_counts` reads each kernel's
launch counter.

The fixed-point ops (``gs_fixed_recip``, ``gs_fixed_softmax``,
``gs_fixed_rmsnorm``) take int8 operands and a per-tensor scale (a Python
float or a one-element f32 tensor) and take their settings from a
:class:`~repro_torch.core.formats.NumericFormat`'s ``precision()``; their
defaults are the int8 format's (frac_bits 24, p 8, no passes).  They have
no gradient: the int8 route serves.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.core.goldschmidt import resolve_precision
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import flash_attention_bwd as _flash_bwd
from repro_torch.kernels import gs_adam as _adam
from repro_torch.kernels import gs_fixed as _fixed
from repro_torch.kernels import gs_rmsnorm as _rmsnorm
from repro_torch.kernels import ref

__all__ = ["gs_rmsnorm", "flash_attention", "gs_adam_update", "adam_scalars",
           "gs_fixed_recip", "gs_fixed_softmax", "gs_fixed_rmsnorm",
           "launch_counts", "reset_launch_counts"]

# kernel name -> (wrapper module, its counter attribute)
_COUNTERS = {
    "gs_rmsnorm": (_rmsnorm, "launches"),
    "flash_attention": (_flash, "launches"),
    "flash_attention_bwd_dq": (_flash_bwd, "launches_dq"),
    "flash_attention_bwd_dkv": (_flash_bwd, "launches_dkv"),
    "gs_adam": (_adam, "launches"),
    "gs_fixed_recip": (_fixed, "launches_recip"),
    "gs_fixed_softmax": (_fixed, "launches_softmax"),
    "gs_fixed_rmsnorm": (_fixed, "launches_rmsnorm"),
}


def launch_counts() -> Dict[str, int]:
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)


def _on_cpu(x: torch.Tensor, op: str) -> bool:
    if x.is_cuda:
        return False
    if x.device.type == "cpu":
        return True
    raise ValueError(f"{op}: no kernel or plain version for device {x.device}")


def _records(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on these inputs."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _RMSNorm(torch.autograd.Function):
    """The reference's ``_rmsnorm`` custom_vjp: the forward keeps the kernel's
    rsqrt column; the backward is its torch expression (no kernel there)."""

    @staticmethod
    def forward(ctx, x, gain, kw):
        run = ref.rmsnorm if _on_cpu(x, "gs_rmsnorm") else _rmsnorm.gs_rmsnorm
        y, inv = run(x, gain, save_inv=True, **kw)
        ctx.save_for_backward(x, gain, inv)
        return y

    @staticmethod
    def backward(ctx, g):
        x, gain, r = ctx.saved_tensors
        d = x.shape[-1]
        x2 = x.to(torch.float32).reshape(-1, d)
        g2 = g.to(torch.float32).reshape(-1, d)
        t = g2 * gain.to(torch.float32)[None, :]
        proj = torch.sum(t * x2, dim=-1, keepdim=True)
        dx = t * r - x2 * ((r * r * r) * (proj * (1.0 / d)))
        dgain = torch.sum(g2 * x2 * r, dim=0)
        return dx.reshape(x.shape).to(x.dtype), dgain.to(gain.dtype), None


def gs_rmsnorm(x: torch.Tensor, gain: torch.Tensor, *, eps: float = 1e-6,
               p: Optional[int] = None, iters: Optional[int] = None,
               variant: str = "feedback", save_inv: bool = False):
    p, iters = resolve_precision(x.dtype, p, iters)
    kw = dict(eps=eps, p=p, iters=iters, variant=variant)
    if _records(x, gain) and not save_inv:
        return _RMSNorm.apply(x, gain, kw)
    run = ref.rmsnorm if _on_cpu(x, "gs_rmsnorm") else _rmsnorm.gs_rmsnorm
    return run(x, gain, save_inv=save_inv, **kw)


class _Flash(torch.autograd.Function):
    """The reference's ``_flash`` custom_vjp: the forward kernel with its
    (m, l) residuals, then the dq and dk/dv kernels."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        cpu = _on_cpu(q, "flash_attention")
        out, m, l = (ref.attention if cpu else _flash.flash_attention)(
            q, k, v, residuals=True, **kw)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, m, l = ctx.saved_tensors
        cpu = _on_cpu(q, "flash_attention")
        dq, dk, dv = (ref.attention_bwd if cpu else _flash_bwd.flash_attention_bwd)(q, k, v, do.contiguous(), out, m, l, **ctx.kw)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    p: Optional[int] = None, iters: Optional[int] = None,
                    variant: str = "feedback") -> torch.Tensor:
    p, iters = resolve_precision(q.dtype, p, iters)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    kw = dict(causal=causal, sm_scale=sm_scale, p=p, iters=iters, variant=variant)
    if _records(q, k, v):
        return _Flash.apply(q, k, v, kw)
    if _on_cpu(q, "flash_attention"):
        return ref.attention(q, k, v, **kw)
    return _flash.flash_attention(q, k, v, **kw)


def adam_scalars(step, lr, *, beta1: float, beta2: float,
                 device) -> torch.Tensor:
    """``(bc1, bc2, lr)`` as a (3,) f32 tensor on ``device`` for the 1-based
    ``step`` (int or integer tensor): ``bc = 1 / (1 - beta^step)`` by an f32
    division, as the reference's kernel route computes them."""
    stepf = torch.as_tensor(step, device=device).to(torch.float32)
    return torch.stack([1.0 / (1.0 - beta1 ** stepf), 1.0 / (1.0 - beta2 ** stepf),
                        torch.as_tensor(lr, dtype=torch.float32, device=device)])


def gs_adam_update(param: torch.Tensor, grad: torch.Tensor, m: torch.Tensor,
                   v: torch.Tensor, bc: torch.Tensor, *, beta1: float = 0.9,
                   beta2: float = 0.999, eps: float = 1e-8,
                   weight_decay: float = 0.0, p: Optional[int] = None,
                   iters: Optional[int] = None, variant: str = "feedback"):
    """One fused AdamW step on one leaf; ``bc`` from :func:`adam_scalars`.
    Returns new (param, m, v)."""
    p, iters = resolve_precision(param.dtype, p, iters)
    kw = dict(beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay, p=p,
              iters=iters, variant=variant)
    if _on_cpu(param, "gs_adam"):
        return ref.adam_update(param, grad, m, v, bc, **kw)
    return _adam.gs_adam_update(param, grad, m, v, bc, **kw)


def gs_fixed_recip(x: torch.Tensor, scale, *, p: int, frac_bits: int, iters: int,
                   variant: str = "feedback", mitchell_iters: int = 0) -> torch.Tensor:
    """1/(x·scale) elementwise for int8 ``x``; f32 out."""
    kw = dict(p=p, frac_bits=frac_bits, iters=iters, variant=variant,
              mitchell_iters=mitchell_iters)
    if _on_cpu(x, "gs_fixed_recip"):
        return ref.fixed_recip(x, scale, **kw)
    return _fixed.gs_fixed_recip(x.contiguous(), scale, **kw)


def gs_fixed_softmax(x: torch.Tensor, scale, *, p: int, frac_bits: int, iters: int,
                     variant: str = "feedback", mitchell_iters: int = 0) -> torch.Tensor:
    """softmax(x·scale) over the last axis of int8 ``x``; f32 out."""
    kw = dict(p=p, frac_bits=frac_bits, iters=iters, variant=variant,
              mitchell_iters=mitchell_iters)
    if _on_cpu(x, "gs_fixed_softmax"):
        return ref.fixed_softmax(x, scale, **kw)
    return _fixed.gs_fixed_softmax(x.contiguous(), scale, **kw)


def gs_fixed_rmsnorm(x: torch.Tensor, scale, gain: torch.Tensor, *, eps: float, p: int,
                     frac_bits: int, iters: int, variant: str = "feedback",
                     mitchell_iters: int = 0) -> torch.Tensor:
    """RMSNorm of (x·scale) over the last axis of int8 ``x``; f32 out.
    ``variant`` and ``mitchell_iters`` are accepted and dropped, as the
    reference drops them: the rsqrt core is one loop of exact multiplies."""
    del variant, mitchell_iters
    kw = dict(eps=eps, p=p, frac_bits=frac_bits, iters=iters)
    if _on_cpu(x, "gs_fixed_rmsnorm"):
        return ref.fixed_rmsnorm(x, scale, gain, **kw)
    return _fixed.gs_fixed_rmsnorm(x.contiguous(), scale, gain, **kw)
