"""Per-tensor int8 weight quantization for the serving path (counterpart of
``repro.layers.quant``).

``quantize_params`` maps a float parameter tree to ``{"q": ..., "s": ...}``:
two trees of the same structure, symmetric per-tensor int8 data and f32
scales.  The reference quantizes its **stacked** tree, where each leaf of
``layers/pos0`` carries a leading ``n_layers`` axis; so here a leaf of the
per-layer list takes one scale over all layers, and the per-layer norm
gains, 2-D once stacked, are quantized too.  Only the top-level 1-D leaf
(``final_norm/scale``) passes through, with a unit scale.

The quantized tree is what the engine keeps on the card.
:func:`maybe_dequantize` returns a read-only view that dequantizes a leaf
(``q.float() * s``, one exact f32 multiply per element) when the model
reads it, so the float weights exist one leaf at a time, just before their
matmul, and give the same numbers as dequantizing the whole tree up front.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence
from typing import Any, Dict

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["quantize_params", "dequantize_params", "maybe_dequantize",
           "is_quantized", "tree_bytes"]

_QKEYS = frozenset({"q", "s"})


def is_quantized(params: Any) -> bool:
    return isinstance(params, Mapping) and set(params.keys()) == _QKEYS


def _scale(leaves) -> torch.Tensor:
    """``max(amax, 1e-12) / 127`` over the leaves, an f32 0-dim tensor; the
    divisor is a tensor, so the card divides too."""
    amax = torch.stack([leaf.detach().abs().amax().to(torch.float32) for leaf in leaves]).amax()
    return torch.clamp(amax, min=1e-12) / torch.full_like(amax, 127.0)


def _quantize(leaf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(leaf.detach().to(torch.float32) / scale),
                       -127.0, 127.0).to(torch.int8)


def _unit(leaf: torch.Tensor) -> torch.Tensor:
    return torch.ones((), dtype=torch.float32, device=leaf.device)


def _quantize_slices(slices, extra_dims: int, min_ndim: int):
    """Quantize one reference subtree given as its slices along the stacked
    axis (``extra_dims`` 1) or whole (``[tree]``, ``extra_dims`` 0): one
    scale per leaf over all slices.  Returns (q slices, scale tree)."""
    def quantizable(leaf):
        return leaf.is_floating_point() and leaf.ndim + extra_dims >= min_ndim

    scales = tree_map(lambda *ls: _scale(ls) if quantizable(ls[0]) else _unit(ls[0]),
                      *slices)
    qs = [tree_map(lambda leaf, sc: _quantize(leaf, sc) if quantizable(leaf) else leaf,
                   tree, scales) for tree in slices]
    return qs, scales


def quantize_params(params: Dict[str, Any], *, min_ndim: int = 2) -> Dict[str, Any]:
    """Float tree → ``{"q": int8 / pass-through tree, "s": f32 scale tree}``."""
    if is_quantized(params):
        return params
    q, s = {}, {}
    for key, sub in params.items():
        if key == "layers":  # one dict per layer: the reference's stacked axis
            q[key], scales = _quantize_slices(list(sub), 1, min_ndim)
            s[key] = [scales] * len(sub)
        else:
            (q[key],), s[key] = _quantize_slices([sub], 0, min_ndim)
    return {"q": q, "s": s}


def _dequantize_leaf(q: torch.Tensor, s: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    if q.dtype == torch.int8:
        return q.to(dtype) * s.to(dtype)
    return q


def dequantize_params(params: Dict[str, Any], dtype=torch.float32) -> Any:
    """The whole float tree back (int8 leaves scale up, the rest pass)."""
    return tree_map(lambda q, s: _dequantize_leaf(q, s, dtype), params["q"], params["s"])


class _DequantizedView(Mapping):
    """A quantized (sub)tree read as a float one: a leaf is dequantized
    each time it is read."""

    def __init__(self, q, s):
        self._q, self._s = q, s

    def __getitem__(self, key):
        return _view(self._q[key], self._s[key])

    def __iter__(self):
        return iter(self._q)

    def __len__(self):
        return len(self._q)


class _DequantizedList(Sequence):
    def __init__(self, q, s):
        self._q, self._s = q, s

    def __getitem__(self, i):
        return _view(self._q[i], self._s[i])

    def __len__(self):
        return len(self._q)


def _view(q, s):
    if isinstance(q, Mapping):
        return _DequantizedView(q, s)
    if isinstance(q, (list, tuple)):
        return _DequantizedList(q, s)
    return _dequantize_leaf(q, s)


def maybe_dequantize(params: Any) -> Any:
    """A float view of a quantized tree (leaves dequantized as they are
    read), or ``params`` itself when it is not quantized."""
    return _DequantizedView(params["q"], params["s"]) if is_quantized(params) else params


def tree_bytes(tree: Any) -> int:
    """Bytes of the tensors of a tree; a tensor shared by several leaves (a
    stacked leaf's scale) counts once."""
    seen = {id(t): t for t in tree_leaves(tree) if torch.is_tensor(t)}
    return int(sum(t.numel() * t.element_size() for t in seen.values()))
