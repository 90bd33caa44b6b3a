"""Logical-axis sharding rules (MaxText-style) as DTensor placements.

The counterpart of `repro.launch.shardings`.  Parameters and activations
carry *logical* axis names (`ParamMeta.axes`, `configs.batch_logical_axes`,
each family's ``cache_logical_axes``); a rule table maps each name to mesh
axes.  A spec is mesh-independent, one entry per tensor dimension: a mesh
axis name, a tuple of them, or None (replicated), as the reference's
``PartitionSpec``.  `placements` turns a spec into the DTensor placements of
a `torch.distributed.device_mesh.DeviceMesh` (`launch.mesh`): a dimension on
two mesh axes, such as ``batch -> ("pod", "data")``, is ``Shard(d)`` on each
of those mesh dimensions, in mesh order.

`shard_activation` is the identity unless a rule context is active
(`activate_rules`), so model code stays runnable on one device.  Under a
context it redistributes a DTensor to the rule's placements; the reference
emits ``with_sharding_constraint``.  Two differences follow from DTensor:

* GSPMD pads a dimension that its mesh axes do not divide; DTensor refuses
  it.  So `shard_activation` applies the shape-aware fallback of
  `logical_to_pspec` to activations too (the reference only to arguments):
  two kv heads on a model axis of four are replicated, not padded.
* a plain tensor made inside the model (positions, masks, the rope table)
  meets DTensors: `activate_rules` enters DTensor's ``implicit_replication``,
  which treats such a tensor as replicated (each rank builds the same one).

`gather_weights` is the FSDP step GSPMD takes on its own: before the
weights are used, their shards on the batch's mesh axes (``pod``, ``data``)
are gathered; the tensor-parallel shards stay.  Its backward is the
reduce-scatter of the gradient back onto the parameter's placements.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any

import torch

__all__ = [
    "DEFAULT_RULES",
    "DECODE_RULES",
    "RULE_SETS",
    "filter_rules",
    "activate_rules",
    "active",
    "logical_to_pspec",
    "placements",
    "local_shape",
    "shard_index",
    "axis_placements",
    "local",
    "shard_activation",
    "keep_grad_placements",
    "gather_weights",
    "param_shardings",
    "distribute_params",
    "distribute_like",
]

# Baseline (paper-faithful FSDP+TP) rule set for the (pod, data, model) mesh.
# Values may be a single mesh axis, a tuple of axes, or None (replicate).
DEFAULT_RULES: dict[str, Any] = {
    # parameters
    "embed": "data",            # FSDP: shard the d_model dim of weights on data
    "mlp": "model",             # TP: FFN hidden
    "mlp_expert": "model",      # expert FFN hidden (experts may not divide mesh)
    "heads_x_dim": "model",     # fused (heads*head_dim) projection output
    "kv_x_dim": "model",        # fused (kv_heads*head_dim) — GSPMD pads if uneven
    "vocab": "model",
    "experts": "model",         # expert parallelism
    "layers": None,
    "state": None,
    "conv": None,
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "heads": "model",
    "kv_heads": "model",
    "cache_seq": None,
    "cache_kv_heads": "model",
    "cache_head_dim": "model",  # fallback when kv_heads doesn't divide the axis
    "experts_act": "model",
}

# Decode: batch is small per-chip; keep FSDP off the fly-weight path.
DECODE_RULES = dict(DEFAULT_RULES)
DECODE_RULES.update({"embed": None})

# Named rule variants for the §Perf hillclimb (selected via dryrun --rules).
RULE_SETS: dict[str, dict] = {
    "default": DEFAULT_RULES,
    # no FSDP: pure tensor-parallel params (replicated over data)
    "tp_only": {**DEFAULT_RULES, "embed": None},
    # sequence-sharded activations (context parallelism on long sequences)
    "seq_data": {**DEFAULT_RULES, "seq": "data", "batch": ("pod",)},
    # shard the KV cache along sequence instead of kv-heads (flash-decode style)
    "kv_seq": {**DEFAULT_RULES, "cache_seq": "model", "cache_kv_heads": None},
    # expert-major: experts across the whole mesh
    "expert_wide": {**DEFAULT_RULES, "experts": ("data", "model"), "mlp_expert": None},
    # replicate KV heads over the model axis (GQA K < model-axis size causes
    # involuntary full rematerialization otherwise)
    "kv_rep": {**DEFAULT_RULES, "kv_heads": None, "kv_x_dim": None},
}

BATCH_AXES = ("pod", "data")


def _axis_names(mesh) -> tuple:
    """A `DeviceMesh`'s ``mesh_dim_names``, or a stand-in's ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def _axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a `DeviceMesh` or of a stand-in whose
    ``shape`` is that dict already (as the reference's ``Mesh.shape``)."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(_axis_names(mesh), mesh.shape))


def filter_rules(rules: dict, mesh) -> dict:
    """Drop mesh axes not present in `mesh` (e.g. 'pod' on single-pod)."""
    avail = set(_axis_names(mesh))

    def filt(v):
        if v is None:
            return None
        if isinstance(v, (tuple, list)):
            kept = tuple(a for a in v if a in avail)
            return kept if kept else None
        return v if v in avail else None

    return {k: filt(v) for k, v in rules.items()}


_active_rules: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "repro_torch_sharding_rules", default=None
)
_active_mesh: contextvars.ContextVar[Any] = contextvars.ContextVar(
    "repro_torch_sharding_mesh", default=None
)


@contextlib.contextmanager
def activate_rules(rules: dict, mesh):
    """Enable logical-axis constraints inside model code.

    Mesh axes missing from `mesh` (e.g. 'pod' on the single-pod mesh) are
    silently dropped from the rules.  Plain tensors that meet DTensors
    inside the context count as replicated (DTensor's
    ``implicit_replication``)."""
    from torch.distributed.tensor.experimental import implicit_replication

    tok_r = _active_rules.set(filter_rules(rules, mesh))
    tok_m = _active_mesh.set(mesh)
    try:
        with implicit_replication():
            yield
    finally:
        _active_rules.reset(tok_r)
        _active_mesh.reset(tok_m)


def active() -> tuple[dict, Any] | None:
    """``(rules, mesh)`` of the active context, else None."""
    rules, mesh = _active_rules.get(), _active_mesh.get()
    return None if rules is None or mesh is None else (rules, mesh)


def logical_to_pspec(axes: tuple, rules: dict, shape: tuple | None = None,
                     mesh=None) -> tuple:
    """Translate logical axis names into a spec (a tuple, one entry a
    dimension: a mesh axis, a tuple of them, or None).

    If `shape` and `mesh` are given, any assignment whose mesh-axis product
    does not divide the dimension falls back to the largest divisible subset
    (the largest divisible prefix, then single axes in order).  A mesh axis
    is used at most once per tensor.
    """
    sizes = _axis_sizes(mesh) if mesh is not None else {}
    out: list = []
    used: set[str] = set()
    for i, name in enumerate(axes):
        if name is None:
            out.append(None)
            continue
        v = rules.get(name)
        if v is None:
            out.append(None)
            continue
        vv = tuple(v) if isinstance(v, (tuple, list)) else (v,)
        vv = tuple(a for a in vv if a not in used)
        if shape is not None and mesh is not None and vv:
            dim = shape[i]

            def divisible(cand: tuple) -> bool:
                n = 1
                for a in cand:
                    n *= sizes[a]
                return dim % n == 0

            if not divisible(vv):
                # largest divisible prefix, then single axes in order
                cand: tuple = ()
                for j in range(len(vv) - 1, 0, -1):
                    if divisible(vv[:j]):
                        cand = vv[:j]
                        break
                if not cand:
                    for a in vv:
                        if divisible((a,)):
                            cand = (a,)
                            break
                vv = cand
        used.update(vv)
        if not vv:
            out.append(None)
        elif len(vv) == 1:
            out.append(vv[0])
        else:
            out.append(vv)
    return tuple(out)


def placements(spec: tuple, mesh) -> tuple:
    """A spec's DTensor placements on ``mesh``: ``Shard(d)`` on every mesh
    dimension that shards tensor dimension d, ``Replicate()`` elsewhere.  A
    dimension on several mesh axes takes them in mesh order (DTensor splits
    a dimension by its mesh dimensions left to right), as every rule set's
    tuples list them."""
    from torch.distributed.tensor import Replicate, Shard

    names = _axis_names(mesh)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dimension {d} lists mesh axes {axes} out of the "
                             f"mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def local_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    """A rank's shard of ``shape`` under ``spec`` (the spec divides it)."""
    sizes = _axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in (() if entry is None else entry if isinstance(entry, tuple) else (entry,)):
            if out[d] % sizes[a]:
                raise ValueError(f"dimension {d} of {tuple(shape)} is not divisible by mesh "
                                 f"axis {a!r} ({sizes[a]})")
            out[d] //= sizes[a]
    return tuple(out)


def shard_index(mesh, dims: list) -> int:
    """This rank's shard of a dimension split over the mesh dimensions
    ``dims`` (major first, as DTensor splits it)."""
    coord = mesh.get_coordinate()
    idx = 0
    for i in dims:
        idx = idx * mesh.size(i) + coord[i]
    return idx


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def axis_placements(axes: tuple, shape: tuple) -> tuple:
    """The placements that a tensor of ``shape`` whose dimensions carry the
    logical ``axes`` takes under the active rules (the shape-aware
    fallback)."""
    rules, mesh = active()
    return placements(logical_to_pspec(axes, rules, shape, mesh), mesh)


def local(fn, in_placements: tuple, out_placements: tuple, grad_placements: tuple | None = None):
    """``fn`` on each rank's shards under the active rule context
    (`torch.distributed.tensor.experimental.local_map`): the inputs are
    redistributed to ``in_placements`` (a plain tensor is first taken as
    replicated: each rank holds the same one), the outputs leave at
    ``out_placements`` and the inputs' gradients come back at
    ``grad_placements`` (default: ``in_placements``).  A DTensor cannot
    enter a kernel called through ``ctypes``; its local shard can."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    _, mesh = active()
    rep = (Replicate(),) * mesh.ndim
    mapped = local_map(fn, out_placements=out_placements, in_placements=in_placements,
                       in_grad_placements=grad_placements, redistribute_inputs=True,
                       device_mesh=mesh)

    def call(*args):
        return mapped(*(DTensor.from_local(a, mesh, rep, run_check=False)
                        if isinstance(a, torch.Tensor) and not _is_dtensor(a) else a
                        for a in args))

    return call


def shard_activation(x: torch.Tensor, axes: tuple, shape: tuple | None = None) -> torch.Tensor:
    """Redistribute ``x`` to the placements its logical ``axes`` get under
    the active rules; the identity without a context, for a plain tensor,
    or when ``axes`` does not match its rank.

    The spec takes the shape-aware fallback on ``x``'s shape, or on
    ``shape`` where given: a flat (B, S, H * Dh) projection is split by its
    H heads, ``shape=(B, S, H)``, so that it reshapes to (B, S, H, Dh)."""
    ctx = active()
    if ctx is None or not _is_dtensor(x) or x.ndim != len(axes):
        return x
    rules, mesh = ctx
    spec = logical_to_pspec(axes, rules, tuple(x.shape) if shape is None else shape, mesh)
    pl = placements(spec, mesh)
    return x if tuple(x.placements) == pl else x.redistribute(mesh, pl)


class _GradPlacements(torch.autograd.Function):
    """Identity whose backward redistributes the cotangent to the forward
    value's placements (a DTensor backward leaves a gradient wherever the
    operations put it)."""

    @staticmethod
    def forward(ctx, x, pl):
        ctx.pl = pl
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.pl:
            g = g.redistribute(g.device_mesh, ctx.pl)
        return g, None


def keep_grad_placements(x: torch.Tensor) -> torch.Tensor:
    """Under a context, ``x`` whose gradient comes back at ``x``'s own
    placements; the identity otherwise.  Put after a reshape that merged a
    dimension the mesh does not divide (heads x head_dim): the reshape's
    backward splits the gradient's dimension again, which DTensor refuses
    where the gradient arrives sharded."""
    if active() is None or not _is_dtensor(x):
        return x
    return _GradPlacements.apply(x, tuple(x.placements))


def gather_weights(tree: Any) -> Any:
    """Under a context, each DTensor leaf with its shards on the batch's
    mesh axes gathered (FSDP's all-gather before use); the identity
    otherwise."""
    ctx = active()
    if ctx is None:
        return tree
    from torch.distributed.tensor import Replicate

    from ..tree import tree_map

    _, mesh = ctx
    names = _axis_names(mesh)
    fsdp = [i for i, a in enumerate(names) if a in BATCH_AXES]

    def one(w):
        if not _is_dtensor(w):
            return w
        pl = list(w.placements)
        for i in fsdp:
            if not pl[i].is_replicate():
                pl[i] = Replicate()
        return w if tuple(pl) == tuple(w.placements) else w.redistribute(mesh, tuple(pl))

    return tree_map(one, tree)


def param_shardings(meta_tree: Any, mesh, rules: dict) -> Any:
    """Tree of placements from a ParamMeta tree (shape-aware fallback)."""
    from ..models.module import _map_with_path

    frules = filter_rules(rules, mesh)
    return _map_with_path(
        lambda _, m: placements(logical_to_pspec(m.axes, frules, m.shape, mesh), mesh),
        meta_tree)


def distribute_like(t: torch.Tensor, mesh, spec: tuple) -> torch.Tensor:
    """``t`` (the whole tensor, the same on every rank) as a DTensor at
    ``spec``: each rank keeps its shard, nothing is sent.  A meta tensor
    becomes a meta DTensor of the same global shape."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    pl = placements(spec, mesh)
    if t.device.type == "meta":
        local = torch.empty(local_shape(tuple(t.shape), spec, mesh), dtype=t.dtype,
                            device="meta")
        return DTensor.from_local(local, mesh, pl, run_check=False, shape=t.shape,
                                  stride=t.stride())
    return distribute_tensor(t, mesh, pl, src_data_rank=None)


def distribute_params(params: Any, mesh, rules: dict, meta_tree: Any) -> Any:
    """The parameter tree as DTensors at `param_shardings`' placements;
    ``meta_tree`` is its ParamMeta tree (`api.model_meta`)."""
    from ..models.module import _map_with_path
    from ..tree import tree_map

    frules = filter_rules(rules, mesh)
    specs = _map_with_path(lambda _, m: logical_to_pspec(m.axes, frules, m.shape, mesh),
                           meta_tree)
    # a spec is a tuple: map over the parameter leaves, not the specs' entries
    leaves = iter(_flat_specs(specs))
    return tree_map(lambda t: distribute_like(t, mesh, next(leaves)), params)


def _flat_specs(tree) -> list:
    """The specs of a tree of specs in `tree.tree_leaves`' order (dicts by
    sorted key)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _flat_specs(tree[k])]
    return [tree]
