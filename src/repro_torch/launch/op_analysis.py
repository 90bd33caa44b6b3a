"""Operation-level cost model of one step: FLOPs and bytes at aten boundaries.

The counterpart of `repro.launch.hlo_analysis.analyze_hlo`, which walks the
compiled HLO text.  Here `OpCounter`, a `TorchDispatchMode`, sees every aten
operation the step runs (after `torch.func`'s transforms, so the backward's
operations too) and counts:

  * FLOPs, from `torch.utils.flop_counter`'s per-operation formulas (matmuls,
    batched matmuls, convolutions, attention: 2 FLOPs a multiply-add);
    operations without a formula count none;
  * bytes: every tensor input's and output's bytes, once per operation: the
    analogue of the reference's "operand + result bytes at instruction
    boundaries".  A view (`OpOverload.is_view`) moves nothing and counts no
    bytes.

On a device mesh (the parameters and activations DTensors, the step under
`launch.shardings.activate_rules`) it counts one rank's work:

  * an operation on DTensors is handed on to DTensor's own dispatch (the
    counter returns ``NotImplemented`` for it), which runs the rank's local
    operations on its shards and the collectives between them; those come
    back through the counter as plain tensors and are counted at their
    local shapes.  The global-shape operations DTensor runs on fake tensors
    to propagate shapes are not counted;
  * collective bytes: the result bytes of every functional collective
    (``_c10d_functional``: all-gather, all-reduce, reduce-scatter,
    all-to-all), as the reference sums result-shape bytes of the HLO's
    collectives, by kind and by the process group they ran on
    (``collectives_by_group``).  They count neither as FLOPs nor as HBM
    bytes.

What it does not count, and why:

  * there is no fusion: eager PyTorch materialises every intermediate that
    XLA would keep inside a fusion, so the byte count is an upper bound on
    the traffic of a fused program (and of the hand kernels, which read
    each operand once);
  * hand-kernel launches cannot be counted on the meta device, where the dry
    run traces: every kernel takes its plain route there (the dry run
    clears ``use_pallas``; `device.on_cuda` admits only CUDA and CPU
    tensors), so a kernel's FLOPs are counted as its plain version's.
"""
from __future__ import annotations

from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _leaves

__all__ = ["DTYPE_BYTES", "COLLECTIVES", "OpCounter", "analyze", "nbytes"]

# element sizes, the port's own copy of the reference's table (hlo_analysis:1-18)
DTYPE_BYTES = {
    torch.float64: 8, torch.float32: 4, torch.float16: 2, torch.bfloat16: 2,
    torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
    torch.int64: 8, torch.uint64: 8, torch.int32: 4, torch.uint32: 4,
    torch.int16: 2, torch.uint16: 2, torch.int8: 1, torch.uint8: 1, torch.bool: 1,
    torch.complex64: 8, torch.complex128: 16,
}


# the reference's collective kinds (hlo_analysis:22), by functional collective
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def nbytes(t: torch.Tensor) -> int:
    """The bytes a tensor holds on this rank (a DTensor's local shard)."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.to_local()
    return t.numel() * DTYPE_BYTES[t.dtype]


def _group_name(args, kwargs) -> str:
    """The process group a functional collective names (its last string)."""
    names = [a for a in (*args, *kwargs.values()) if isinstance(a, str)]
    return names[-1] if names else "?"


class OpCounter(TorchDispatchMode):
    """Counts FLOPs and bytes of every aten operation run under it; also the
    devices its outputs live on (``devices``) and the bytes of the outputs
    off the meta device (``off_meta_bytes``), so a dry run can show what it
    allocated: on meta, only host constants (rope's frequency table, made
    from numpy)."""

    def __init__(self):
        super().__init__()
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        self._formulas = flop_registry
        self._dtensor, self._fake = DTensor, FakeTensor
        self.flops = 0
        self.bytes = 0
        self.by_op: dict = defaultdict(lambda: {"calls": 0, "flops": 0, "bytes": 0})
        self.devices: set = set()
        self.off_meta_bytes = 0
        self.collectives: dict = {c: 0.0 for c in COLLECTIVES}
        self.collective_count = 0
        self.collectives_by_group: dict = defaultdict(float)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented  # DTensor runs the local operations, counted below
        out = func(*args, **kwargs)
        outs = [t for t in _leaves(out) if isinstance(t, torch.Tensor)]
        if any(isinstance(t, self._fake) for t in outs):
            return out  # DTensor's shape propagation at global shapes
        if func.namespace == "_c10d_functional":
            kind = _KIND.get(func._opname)
            if kind is not None:
                nb = float(sum(nbytes(t) for t in outs))
                self.collectives[kind] += nb
                self.collective_count += 1
                self.collectives_by_group[_group_name(args, kwargs)] += nb
            return out
        self.devices.update(t.device.type for t in outs)
        self.off_meta_bytes += sum(nbytes(t) for t in outs if t.device.type != "meta")
        formula = self._formulas.get(func._overloadpacket)
        flops = int(formula(*args, **kwargs, out_val=out)) if formula is not None else 0
        nb = 0
        if not func.is_view:
            ins = [t for t in _leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            nb = sum(nbytes(t) for t in ins) + sum(nbytes(t) for t in outs)
        row = self.by_op[str(func._overloadpacket)]
        row["calls"] += 1
        row["flops"] += flops
        row["bytes"] += nb
        self.flops += flops
        self.bytes += nb
        return out

    def result(self) -> dict:
        coll = {**self.collectives, "count": self.collective_count,
                "total": float(sum(self.collectives.values()))}
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "collectives": coll, "collectives_by_group": dict(self.collectives_by_group),
                "by_op": {k: dict(v) for k, v in sorted(self.by_op.items())}}


def analyze(fn, *args, **kwargs) -> tuple:
    """``(fn(*args, **kwargs), {"flops", "bytes", "collectives",
    "collectives_by_group", "by_op"})`` with the operations of the call
    counted."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.result()
