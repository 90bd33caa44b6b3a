"""Pytree checkpointing: npz arrays + json tree structure, with rotation.

The counterpart of `repro.ckpt.checkpoint`, on the same layout, so that
each package restores the other's files:

  <dir>/step_<k>/arrays.npz     flattened leaves, keys = tree paths joined by "|"
  <dir>/step_<k>/meta.json      tree structure, keys, encoded dtypes, user metadata

Atomic via tmp-dir rename; `save` keeps the newest ``keep`` steps.  A tree
is nested dicts, lists and tuples whose leaves are tensors (on any device;
copied to the host), numpy arrays or scalars; dict keys are visited
sorted and None is an empty subtree, as in `jax.tree_util`, so the keys
are the reference's.  numpy has no bfloat16: such a leaf is stored as its
uint16 bits and meta.json's ``encoded_dtypes`` records "bfloat16", which
`restore` views back, so the round trip is bitwise.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "available_steps", "load_metadata"]

_SEP = "|"


def _paths(tree, prefix: tuple = ()) -> list:
    """``[(key, leaf)]`` in JAX's leaf order; None is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _paths(v, prefix + (str(i),))]
    return [(_SEP.join(prefix), tree)]


def _rebuild(like, leaves):
    """``like``'s structure with its leaves taken in order from ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        items = [_rebuild(v, leaves) for v in like]
        return type(like)(*items) if hasattr(like, "_fields") else type(like)(items)
    return next(leaves)


def _structure(tree) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_structure(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def _encode(leaf) -> tuple[np.ndarray, str | None]:
    """A leaf as an `np.load`-able array, and the dtype name it was encoded
    from (None when stored as itself)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), None
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V":  # an ml_dtypes array (bfloat16 & friends)
        return arr.view(np.dtype(f"u{arr.dtype.itemsize}")), arr.dtype.name
    return arr, None


def _decode(arr: np.ndarray, encoded: str | None, like):
    """A stored array as a leaf like ``like`` (its type, dtype and device)."""
    if isinstance(like, torch.Tensor):
        if encoded == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        elif encoded is not None:
            raise ValueError(f"no torch dtype for the encoded dtype {encoded!r}")
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.to(device=like.device, dtype=like.dtype)
    if encoded is not None:
        try:
            arr = arr.view(np.dtype(encoded))
        except TypeError:
            raise ValueError(f"numpy has no dtype {encoded!r}; restore it into a tensor") from None
    return arr.astype(np.asarray(like).dtype)


def save(
    directory: str,
    step: int,
    tree: Any,
    metadata: dict | None = None,
    keep: int = 3,
) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        stored, encoded = {}, {}
        for key, leaf in _paths(tree):
            stored[key], enc = _encode(leaf)
            if enc is not None:
                encoded[key] = enc
        np.savez(os.path.join(tmp, "arrays.npz"), **stored)
        meta = {
            "step": step,
            "treedef": _structure(tree),
            "keys": sorted(stored),
            "encoded_dtypes": encoded,
            "metadata": metadata or {},
        }
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # rotate
    for s in available_steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:010d}"), ignore_errors=True)
    return final


def available_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(directory: str) -> int | None:
    steps = available_steps(directory)
    return steps[-1] if steps else None


def load_metadata(directory: str, step: int) -> dict:
    """The user ``metadata`` dict a checkpoint was saved with."""
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f).get("metadata", {})


def restore(directory: str, step: int, like: Any) -> Any:
    """Restore into the structure of ``like`` (shapes validated; each leaf
    takes the type, dtype and device of ``like``'s)."""
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "meta.json")) as f:
        encoded = json.load(f).get("encoded_dtypes", {})
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    pairs = _paths(like)
    keys = [k for k, _ in pairs]
    if sorted(keys) != sorted(flat):
        missing = set(keys) - set(flat)
        extra = set(flat) - set(keys)
        raise ValueError(f"checkpoint tree mismatch: missing={missing} extra={extra}")
    leaves = []
    for key, leaf in pairs:
        arr = flat[key]
        if tuple(arr.shape) != tuple(np.shape(leaf)):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(np.shape(leaf))}")
        leaves.append(_decode(arr, encoded.get(key), leaf))
    return _rebuild(like, iter(leaves))
