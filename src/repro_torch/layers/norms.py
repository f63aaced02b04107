"""RMSNorm with a Goldschmidt rsqrt (counterpart of ``repro.layers.norms``,
``kernel_impl='pallas'`` route): every norm runs the fused kernel front-end,
which differentiates through the reference's rule when autograd records it.
"""

from __future__ import annotations

import torch

from repro_torch.core.policy import NumericsPolicy
from repro_torch.kernels import ops


def rmsnorm_init(d: int, device) -> dict:
    return {"scale": torch.ones(d, dtype=torch.float32, device=device)}


def rmsnorm(params, x: torch.Tensor, *, eps: float,
            policy: NumericsPolicy) -> torch.Tensor:
    """The policy pins the variant, and the (ROM width, pass count) pair when
    its budget differs from x's dtype; otherwise x's dtype derives it."""
    return ops.gs_rmsnorm(x.contiguous(), params["scale"], eps=eps,
                          variant=policy.variant,
                          **policy.kernel_precision(x.dtype))
