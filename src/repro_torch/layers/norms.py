"""RMSNorm with a Goldschmidt rsqrt (counterpart of ``repro.layers.norms``,
``kernel_impl='pallas'`` route): every norm runs the fused kernel front-end,
which differentiates through the reference's rule when autograd records it.

Under a fixed-point policy (``quant="int8"``) the norm quantizes its input
per tensor, over the whole tensor (so over every row of a decode tick, idle
slots included, as the reference does): ``amax = max(max|x|, 1e-6)``, its
reciprocal through the policy's fixed datapath, ``xq = clip(round(x · 127 ·
(1/amax)), ±127)`` as int8; then the fused ``gs_fixed_rmsnorm`` on ``xq``
with the scale ``amax · (1/127)``.
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
    if policy.is_fixed:
        x32 = x.to(torch.float32)
        amax = torch.clamp(torch.amax(torch.abs(x32)), min=1e-6)
        inv_amax = policy.reciprocal(amax)
        xq = torch.clamp(torch.round(x32 * (127.0 * inv_amax)), -127.0, 127.0)
        out = ops.gs_fixed_rmsnorm(xq.to(torch.int8), amax * (1.0 / 127.0),
                                   params["scale"], eps=eps, variant=policy.variant,
                                   **policy.fmt.precision())
        return out.to(x.dtype)
    return ops.gs_rmsnorm(x.contiguous(), params["scale"], eps=eps,
                          variant=policy.variant,
                          **policy.kernel_precision(x.dtype))
