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
autotuning.  :func:`launch_counts` reads each kernel's launch counter.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.goldschmidt import resolve_precision
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import gs_rmsnorm as _rmsnorm
from repro_torch.kernels import ref

__all__ = ["gs_rmsnorm", "flash_attention", "launch_counts", "reset_launch_counts"]

_KERNELS = {"gs_rmsnorm": _rmsnorm, "flash_attention": _flash}


def launch_counts() -> Dict[str, int]:
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0


def _on_cpu(x: torch.Tensor, op: str) -> bool:
    if x.is_cuda:
        return False
    if x.device.type == "cpu":
        return True
    raise ValueError(f"{op}: no kernel or plain version for device {x.device}")


def gs_rmsnorm(x: torch.Tensor, gain: torch.Tensor, *, eps: float = 1e-6,
               p: Optional[int] = None, iters: Optional[int] = None,
               variant: str = "feedback", save_inv: bool = False):
    p, iters = resolve_precision(x.dtype, p, iters)
    kw = dict(eps=eps, p=p, iters=iters, variant=variant, save_inv=save_inv)
    if _on_cpu(x, "gs_rmsnorm"):
        return ref.rmsnorm(x, gain, **kw)
    return _rmsnorm.gs_rmsnorm(x, gain, **kw)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    p: Optional[int] = None, iters: Optional[int] = None,
                    variant: str = "feedback") -> torch.Tensor:
    p, iters = resolve_precision(q.dtype, p, iters)
    kw = dict(causal=causal, sm_scale=sm_scale, p=p, iters=iters, variant=variant)
    if _on_cpu(q, "flash_attention"):
        return ref.attention(q, k, v, **kw)
    return _flash.flash_attention(q, k, v, **kw)
