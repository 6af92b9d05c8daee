"""Atomic checkpoints with a manifest of content hashes: the counterpart
of ``repro.checkpoint.manager``, on the same on-disk layout, so either
package restores what the other saved.

Layout:
  <dir>/step_<N:08d>.tmp/...     (write)
  <dir>/step_<N:08d>/manifest.json, arrays.npz, extras.json  (after rename)
  <dir>/LATEST                   (atomic pointer file)

A tree is nested dicts, lists and tuples whose leaves are tensors, numpy
arrays or numbers. Its keys are the reference's: dict keys and list
indices joined by ``/``, dicts walked in sorted key order (as JAX flattens
them), so ``{"params": {"trunk": {"conv1": w}}}`` saves ``w`` under
``params/trunk/conv1``. Leaves numpy cannot hold (bfloat16) are upcast to
float32 on save; ``restore`` casts back to the dtype of the ``like`` tree
(round to nearest even, as ``jnp.astype`` does).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common import resolve_device

__all__ = ["save", "latest_step", "restore", "prune_old"]


def _items(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) pairs in JAX's flattening order; None is an empty
    subtree, as in JAX."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _items(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in _items(v, prefix + (i,))]
    return [(prefix, tree)]


def _key(path: Tuple) -> str:
    return "/".join(str(p) for p in path)


def _flatten_with_paths(tree) -> Dict[str, Any]:
    return {_key(path): leaf for path, leaf in _items(tree)}


def _map_with_paths(fn: Callable[[str, Any], Any], tree, prefix=()):
    """``tree`` with every leaf replaced by ``fn(key, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_with_paths(fn, v, prefix + (i,))
               for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, list) else tuple(out)
    return fn(_key(prefix), tree)


def _to_numpy(v) -> np.ndarray:
    """A C-contiguous host copy of a leaf's logical contents; dtypes numpy
    lacks (bfloat16, float8) become float32, as the reference upcasts."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        try:
            a = t.numpy()
        except TypeError:
            a = t.float().numpy()
    else:
        a = np.asarray(v)
        if a.dtype.kind not in "biufc":
            a = a.astype(np.float32)
    # np.ascontiguousarray would lift a 0-d array to shape (1,)
    return a if a.flags.c_contiguous else np.ascontiguousarray(a)


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


def save(ckpt_dir: str, step: int, tree: Any, extras: Optional[Dict] = None):
    """Atomic checkpoint save. tree: nested dicts/lists of tensors, arrays
    or numbers; extras: JSON-able. Returns the step's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays = {k: _to_numpy(v) for k, v in _flatten_with_paths(tree).items()}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "keys": sorted(arrays),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
        "hashes": {k: _digest(v) for k, v in arrays.items()},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "extras.json"), "w") as f:
        json.dump(extras or {}, f)

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                     # atomic on same filesystem
    latest_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(final))
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[1])


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None,
            device="cuda"):
    """Restore into the structure of ``like`` (a tree of tensors, or of
    meta tensors such as ``torch.empty(shape, dtype=..., device="meta")``):
    each leaf comes back as a tensor of the like leaf's dtype on
    ``device`` (the card unless the caller asks for the CPU). Verifies the
    content hashes first and raises on a key ``like`` has and the
    checkpoint lacks. Returns (tree, extras)."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(final, "arrays.npz"))

    for k in manifest["keys"]:
        if _digest(data[k]) != manifest["hashes"][k]:
            raise IOError(f"checkpoint corruption detected in {k}")

    missing = set(_flatten_with_paths(like)) - set(manifest["keys"])
    if missing:
        raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")

    def load(key, leaf):
        val = torch.from_numpy(np.array(data[key]))
        if val.dtype != leaf.dtype:
            val = val.to(leaf.dtype)
        return val.to(dev)

    tree = _map_with_paths(load, like)
    with open(os.path.join(final, "extras.json")) as f:
        extras = json.load(f)
    return tree, extras


def prune_old(ckpt_dir: str, keep: int = 3, pinned=()):
    """Delete all but the newest ``keep`` checkpoints. Steps in
    ``pinned`` are never deleted (the model registry pins versions that
    serving may still hot-swap back to) and do not count against
    ``keep``. Returns the steps actually removed."""
    pinned = set(int(p) for p in pinned)
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    kept = set(s for s in steps if s not in pinned)
    kept = set(sorted(kept)[-keep:] if keep > 0 else ())
    removed = []
    for s in steps:
        if s in pinned or s in kept:
            continue
        path = os.path.join(ckpt_dir, f"step_{s:08d}")
        shutil.rmtree(path, ignore_errors=True)
        # only report steps that are actually gone: a failed delete
        # (EBUSY/EACCES) must not make the registry drop a version whose
        # checkpoint still occupies disk
        if not os.path.isdir(path):
            removed.append(s)
    return removed
