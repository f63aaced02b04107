"""The reference's parameter and optimizer trees as the port's, and back.

``params_from_numpy`` takes the JAX package's parameter tree as nested dicts
of numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the
port's tree on ``device``: same leaf names, with the scanned
``layers/pos{j}/...`` leaves (leading axis ``n_groups``) unstacked into one
dict per layer, layer ``g * period + j`` from group ``g``, position ``j``.
``params_to_numpy`` is its inverse for the port's dense family (one block
kind, so period 1: ``layers/pos0`` stacks every layer).
``opt_state_from_numpy`` / ``opt_state_to_numpy`` carry AdamW's state (m and
v shaped as the params, the int32 step), and ``state_to_numpy`` /
``state_from_numpy`` the trainer's ``{"params", "opt_state"}`` checkpoint
tree, so a checkpoint crosses between the two packages.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.tree import tree_leaves, tree_map


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
        lead = {np.asarray(a).shape[0] for a in tree_leaves(stacked[f"pos{j}"])}
        if lead != {n_groups}:
            raise ValueError(f"layers/pos{j}: leading axes {sorted(lead)}, "
                             f"expected n_groups={n_groups}")
    out = {k: _to_torch(v, device) for k, v in tree.items() if k != "layers"}
    out["layers"] = [_to_torch(stacked[f"pos{j}"], device, index=g)
                     for g in range(n_groups) for j in range(period)]
    return out


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's parameter tree in the reference's layout, as numpy."""
    out = {k: tree_map(_host, v) for k, v in params.items() if k != "layers"}
    out["layers"] = {"pos0": tree_map(lambda *ls: np.stack([_host(t) for t in ls]),
                                      *params["layers"])}
    return out


def opt_state_from_numpy(tree: Dict[str, Any], cfg: ArchConfig, device) -> Dict[str, Any]:
    """The reference's AdamW state ``{"m", "v", "step"}`` as the port's."""
    return {"m": params_from_numpy(tree["m"], cfg, device),
            "v": params_from_numpy(tree["v"], cfg, device),
            "step": torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32,
                                 device=device)}


def opt_state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    return {"m": params_to_numpy(state["m"]), "v": params_to_numpy(state["v"]),
            "step": np.asarray(_host(state["step"]), dtype=np.int32)}


def state_to_numpy(params, opt_state) -> Dict[str, Any]:
    """The trainer's checkpoint tree in the reference's layout."""
    return {"params": params_to_numpy(params), "opt_state": opt_state_to_numpy(opt_state)}


def state_from_numpy(tree: Dict[str, Any], cfg: ArchConfig, device) -> Tuple[Any, Any]:
    """(params, opt_state) on ``device`` from a checkpoint tree."""
    return (params_from_numpy(tree["params"], cfg, device),
            opt_state_from_numpy(tree["opt_state"], cfg, device))
