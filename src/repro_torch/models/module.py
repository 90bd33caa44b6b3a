"""Parameter metadata as the single source of truth (`repro.models.module`).

A model definition is a nested dict of `ParamMeta` leaves.  From that one
tree we derive:
  * `init_params`      — materialized tensors (one generator per leaf),
  * `abstract_params`  — meta-device tensors (shape and dtype, no storage),
  * `logical_specs`    — the tree of logical-axis names,
  * `param_count`.

The reference draws each leaf from ``jax.random.fold_in(key, crc32(path))``;
Threefry streams cannot be reproduced in torch, so `init_params` follows
the same per-leaf rule with its own `torch.Generator` per leaf and the same
laws (each ``init`` kind's distribution and scale).  Parity tests convert
the reference's parameters instead.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, NamedTuple

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["CacheSpec", "ParamMeta", "init_params", "abstract_params", "logical_specs",
           "param_count"]


class CacheSpec(NamedTuple):
    """Shape and dtype of one decode-cache entry: what `init_cache` returns
    in place of the reference's ``jax.ShapeDtypeStruct`` (materialize with
    `launch.serve.materialize_cache`)."""

    shape: tuple[int, ...]
    dtype: torch.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)


@dataclasses.dataclass(frozen=True)
class ParamMeta:
    """Declares one parameter: shape, dtype, logical axes, initializer.

    axes entries are logical names ('embed', 'mlp', 'heads', 'kv_heads',
    'head_dim', 'vocab', 'experts', 'layers', 'state', None...) — one per dim.
    init: 'normal' (fan-in scaled), 'zeros', 'ones', 'embed' (unit normal
    scaled by 1/sqrt(d)), 'small' (0.006 std, router-style), 'ssm_a',
    'ssm_dt' (Mamba2's A_log and dt_bias, kept fp32).
    """

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"
    fan_in_axes: tuple[int, ...] | None = None  # dims reduced by the matmul

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")


def _map_with_path(f, tree, path: tuple = ()):
    """``f(path_str, meta)`` over every `ParamMeta` leaf, keeping the nesting
    (dicts in sorted-key order, as `jax.tree_util` visits them)."""
    if isinstance(tree, ParamMeta):
        return f("/".join(path), tree)
    if isinstance(tree, dict):
        return {k: _map_with_path(f, tree[k], path + (str(k),)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(f, x, path + (str(i),)) for i, x in enumerate(tree))
    raise TypeError(f"not a ParamMeta tree leaf: {type(tree).__name__}")


def _leaf_seed(seed: int, path: str) -> int:
    """Deterministic per-leaf generator seed: crc32 of the tree path started
    from ``seed`` (not Python's salted hash()), so initialization is
    identical across processes, as in the reference's ``_leaf_rng``.  It
    stays within 32 bits, all that the CPU generator keeps of a seed."""
    return zlib.crc32(path.encode(), int(seed) & 0xFFFFFFFF)


def _stored_dtype(meta: ParamMeta, dtype_override) -> torch.dtype:
    if meta.init in ("ssm_a", "ssm_dt"):
        return torch.float32  # stability-critical params stay fp32
    return meta.dtype if dtype_override is None else dtype_override


def init_params(meta_tree: Any, seed: int, device: str | torch.device = "cuda",
                dtype_override: torch.dtype | None = None) -> Any:
    """Materialize parameters on ``device``.  Deterministic given ``seed``
    and the device type (each leaf draws from its own generator there)."""
    dev = resolve_device(device)

    def make(path, meta: ParamMeta):
        dt = _stored_dtype(meta, dtype_override)
        if meta.init == "zeros":
            return torch.zeros(meta.shape, dtype=dt, device=dev)
        if meta.init == "ones":
            return torch.ones(meta.shape, dtype=dt, device=dev)
        gen = torch.Generator(device=dev).manual_seed(_leaf_seed(seed, path))

        def normal():
            return torch.randn(meta.shape, generator=gen, dtype=torch.float32, device=dev)

        def uniform(lo, hi):
            u = torch.rand(meta.shape, generator=gen, dtype=torch.float32, device=dev)
            return u * (hi - lo) + lo

        if meta.init == "small":
            return (0.006 * normal()).to(dt)
        if meta.init == "embed":
            return (normal() / float(np.sqrt(meta.shape[-1]))).to(dt)
        if meta.init == "normal":
            fan_axes = meta.fan_in_axes if meta.fan_in_axes is not None else (0,)
            fan_in = int(np.prod([meta.shape[a] for a in fan_axes]))
            return (float(1.0 / np.sqrt(max(fan_in, 1))) * normal()).to(dt)
        if meta.init == "ssm_a":  # mamba2 A_log init: log(uniform[1,16])
            return torch.log(uniform(1.0, 16.0))
        if meta.init == "ssm_dt":  # dt_bias: softplus^-1 of uniform[1e-3, 1e-1]
            return torch.log(torch.expm1(uniform(1e-3, 1e-1)))
        raise ValueError(f"unknown init {meta.init}")

    return _map_with_path(make, meta_tree)


def abstract_params(meta_tree: Any, dtype_override: torch.dtype | None = None) -> Any:
    """Meta-device tensor tree (shapes and dtypes, no allocation)."""
    return _map_with_path(
        lambda _, m: torch.empty(m.shape, dtype=_stored_dtype(m, dtype_override), device="meta"),
        meta_tree,
    )


def logical_specs(meta_tree: Any) -> Any:
    """Tree of logical-axis tuples, mirroring the parameter tree."""
    return _map_with_path(lambda _, m: m.axes, meta_tree)


def param_count(meta_tree: Any) -> int:
    counts = []
    _map_with_path(lambda _, m: counts.append(int(np.prod(m.shape))), meta_tree)
    return int(sum(counts))
