"""AdamW with the paper's Goldschmidt denominator (counterpart of
``repro.optim.adamw``, ``kernel_impl='pallas'`` route).

The update ``m̂ / (sqrt(v̂) + eps)`` is division site #5: every parameter
leaf goes through one launch of the fused ``gs_adam`` kernel front-end
(:func:`repro_torch.kernels.ops.gs_adam_update`), whose GS sqrt and GS
reciprocal replace the sqrt and the divide.  Its bias corrections and the
learning rate reach it as one device operand, computed as the reference's
kernel route computes them (an f32 ``1/(1 - β^t)``).  The reference's jnp
route, which takes the bias corrections through the policy's reciprocal,
is not ported: the port follows the kernel route.

Parameters are a tree of dicts and lists of tensors (the model's); the
optimizer state is f32 ``m``, ``v`` of the same tree and an int32 step
counter on the device.  Global-norm clipping runs its sqrt and reciprocal
through the policy.  The update returns new tensors, as the reference does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.policy import NumericsPolicy
from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

OptState = Dict[str, Any]


def adamw_init(params) -> OptState:
    """f32 zeros for m and v beside every leaf, and step 0."""
    some = tree_leaves(params)[0]
    zeros = lambda t: torch.zeros(t.shape, dtype=torch.float32, device=t.device)  # noqa: E731
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=some.device)}


def global_norm(tree, policy: NumericsPolicy) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(g.to(torch.float32))) for g in tree_leaves(tree))
    return policy.sqrt(sq)


def clip_by_global_norm(grads, max_norm: float, policy: NumericsPolicy):
    norm = global_norm(grads, policy)
    scale = torch.clamp_max(max_norm * policy.reciprocal(norm + 1e-12), 1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(params, grads, state: OptState, *, lr, policy: NumericsPolicy,
                 beta1: float = 0.9, beta2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: Optional[float] = 1.0,
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step: (new params, new state, {"grad_norm"}).  ``lr`` is a
    float or a scalar tensor (a schedule's output)."""
    step = state["step"] + 1
    if clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, clip_norm, policy)
    else:
        gnorm = global_norm(grads, policy)
    leaves = tree_leaves(params)
    bc = ops.adam_scalars(step, lr, beta1=beta1, beta2=beta2, device=leaves[0].device)
    out = [ops.gs_adam_update(p, g, m, v, bc, beta1=beta1, beta2=beta2, eps=eps,
                              weight_decay=weight_decay, variant=policy.variant,
                              **policy.kernel_precision(p.dtype))
           for p, g, m, v in zip(leaves, tree_leaves(grads), tree_leaves(state["m"]),
                                 tree_leaves(state["v"]))]
    new_state = {"m": tree_unflatten(params, [o[1] for o in out]),
                 "v": tree_unflatten(params, [o[2] for o in out]), "step": step}
    return tree_unflatten(params, [o[0] for o in out]), new_state, {"grad_norm": gnorm}
