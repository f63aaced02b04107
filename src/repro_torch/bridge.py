"""The reference's parameters as the port's.

``params_from_numpy`` takes the JAX package's parameter tree as nested dicts
of numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the
port's tree on ``device``: same leaf names, with the scanned
``layers/pos{j}/...`` leaves (leading axis ``n_groups``) unstacked into one
dict per layer, layer ``g * period + j`` from group ``g``, position ``j``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


def _to_torch(tree, device, index=None):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, index) for k, v in tree.items()}
    arr = np.asarray(tree) if index is None else np.asarray(tree)[index]
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(device)


def params_from_numpy(tree: Dict[str, Any], cfg: ArchConfig, device) -> Dict[str, Any]:
    stacked = tree["layers"]
    period = len(stacked)
    n_groups = cfg.n_layers // period
    for j in range(period):
        lead = {np.asarray(a).shape[0] for a in _leaves(stacked[f"pos{j}"])}
        if lead != {n_groups}:
            raise ValueError(f"layers/pos{j}: leading axes {sorted(lead)}, "
                             f"expected n_groups={n_groups}")
    out = {k: _to_torch(v, device) for k, v in tree.items() if k != "layers"}
    out["layers"] = [_to_torch(stacked[f"pos{j}"], device, index=g)
                     for g in range(n_groups) for j in range(period)]
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
