"""Checkpoints in the layout of ``repro.checkpoint.store``, without JAX.

Layout (one directory per step)::

    <dir>/step_00000100/
        manifest.json     leaf keys, shapes, dtypes, crc32, step, fingerprint
        <leaf-key>.npy    one file per leaf (a logical, unsharded array)

A tree is nested dicts (and lists) of tensors or numpy arrays; a leaf's key
joins its path with ``__``, dict keys in sorted order, as the reference
names ``jax.tree`` paths.  So a checkpoint crosses between the two packages
as long as both write the same tree: the port's trainer writes its state in
the reference's layout (stacked layers, :mod:`repro_torch.bridge`).

* **atomic** — written to ``.tmp-step_N`` and renamed; a crash mid-write
  never corrupts the latest checkpoint.
* **async** — ``CheckpointManager.save`` copies the tree to host memory
  synchronously, then writes the files on a background thread.
* **verified** — every leaf's shape, dtype and crc32 is in the manifest;
  the crc32 is checked on load.
* bf16 leaves, which numpy cannot hold, are stored as the reference stores
  its ml_dtypes leaves: raw uint8 bytes with a trailing itemsize axis,
  ``"encoded": true`` and the logical dtype in the manifest.

``load_checkpoint`` returns CPU tensors; the caller moves them.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_MANIFEST = "manifest.json"
_ENCODED = {"bfloat16": torch.bfloat16}  # logical dtypes numpy cannot hold


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree) for kv in _flatten(t, prefix + (str(i),))]
    return [("__".join(prefix) or "leaf", tree)]


def _to_storable(leaf) -> Tuple[np.ndarray, str, bool]:
    """(array to write, logical dtype name, encoded?) for one leaf."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            raw = t.contiguous().view(torch.uint8).reshape(tuple(t.shape) + (2,))
            return raw.numpy(), "bfloat16", True
        leaf = t.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype), False


def _from_storable(raw: np.ndarray, logical: str, encoded: bool) -> torch.Tensor:
    if not encoded:
        return torch.from_numpy(raw)
    if logical not in _ENCODED:
        raise ValueError(f"cannot decode a leaf of logical dtype {logical!r}")
    return torch.from_numpy(raw).view(_ENCODED[logical]).reshape(raw.shape[:-1])


def _host_copy(tree) -> List[Tuple[str, np.ndarray, str, bool]]:
    return [(key, *_to_storable(leaf)) for key, leaf in _flatten(tree)]


def _write(directory: str, step: int, leaves, fingerprint: str) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = os.path.join(directory, f".tmp-step_{step:08d}")
    os.makedirs(tmp, exist_ok=True)
    manifest: Dict[str, Any] = {"step": int(step), "fingerprint": fingerprint,
                                "leaves": {}, "extra": {}}
    for key, arr, logical, encoded in leaves:
        manifest["leaves"][key] = {"shape": list(arr.shape[:-1] if encoded else arr.shape),
                                   "dtype": logical, "encoded": encoded,
                                   "crc32": int(zlib.crc32(arr.tobytes()))}
        np.save(os.path.join(tmp, key + ".npy"), arr)
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_checkpoint(directory: str, step: int, tree, *, fingerprint: str = "") -> str:
    """Write one checkpoint (blocking); returns its final path."""
    return _write(directory, step, _host_copy(tree), fingerprint)


def load_checkpoint(path: str):
    """Restore a tree saved by either package: (tree, manifest).

    The tree is nested dicts of CPU tensors keyed by the manifest's leaf
    keys split at ``__``; every leaf's crc32 is checked.  The caller checks
    the tree against the state it expects.
    """
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    tree: Dict[str, Any] = {}
    for key, meta in manifest["leaves"].items():
        raw = np.load(os.path.join(path, key + ".npy"))
        if int(zlib.crc32(raw.tobytes())) != meta["crc32"]:
            raise IOError(f"crc mismatch for {key} in {path}")
        node = tree
        *parents, name = key.split("__")
        for part in parents:
            node = node.setdefault(part, {})
        node[name] = _from_storable(raw, meta["dtype"], meta.get("encoded", False))
    return tree, manifest


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for name in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", name))]
    return max(steps) if steps else None


class CheckpointManager:
    """Rolling async checkpoints with retention and restore-latest."""

    def __init__(self, directory: str, *, keep: int = 2, fingerprint: str = ""):
        self.directory = directory
        self.keep = keep
        self.fingerprint = fingerprint
        self._pending: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree, *, blocking: bool = False) -> None:
        self.wait()  # one in flight at a time (double buffering)
        leaves = _host_copy(tree)  # the snapshot: later updates cannot reach it
        if blocking:
            _write(self.directory, step, leaves, self.fingerprint)
        else:
            self._pending = threading.Thread(
                target=_write, args=(self.directory, step, leaves, self.fingerprint),
                daemon=True)
            self._pending.start()
        self._gc()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self) -> None:
        steps = sorted(int(m.group(1)) for name in os.listdir(self.directory)
                       if (m := re.fullmatch(r"step_(\d+)", name)))
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self):
        """(tree, manifest) of the newest checkpoint, or (None, None)."""
        self.wait()
        step = latest_step(self.directory)
        if step is None:
            return None, None
        tree, manifest = load_checkpoint(os.path.join(self.directory, f"step_{step:08d}"))
        if (self.fingerprint and manifest["fingerprint"]
                and manifest["fingerprint"] != self.fingerprint):
            raise ValueError(f"checkpoint fingerprint {manifest['fingerprint']} != "
                             f"job fingerprint {self.fingerprint}")
        return tree, manifest


def config_fingerprint(cfg) -> str:
    return hashlib.sha1(repr(cfg).encode()).hexdigest()[:16]
