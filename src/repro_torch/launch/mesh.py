"""Production mesh construction (`repro.launch.mesh`) as a `DeviceMesh`.

A function (not a module-level constant) so importing never touches
`torch.distributed`.  Single pod: (data=16, model=16) = 256 ranks.
Multi-pod: (pod=2, data=16, model=16) = 512 ranks.  The mesh spans the
first N ranks of the current process group, as the reference's takes the
first N devices.  `fake_world` gives a process group of any size in one
process (`torch.distributed`'s fake backend: every collective returns at
once, nothing is sent), for a trace on the meta device such as the dry run.
"""
from __future__ import annotations

import contextlib

__all__ = ["make_production_mesh", "make_debug_mesh", "fake_world",
           "gloo_cuda_all_gather"]

_GLOO_CUDA_LIB: list = []  # the library object that keeps the registration alive


def _device_type() -> str:
    """"cuda" when this rank has a card (the lanes' placement sets it), else
    "cpu" (a CPU rank, or a fake world tracing on meta)."""
    import torch
    import torch.distributed as dist

    if dist.get_backend() == "fake" or not torch.cuda.is_available():
        return "cpu"
    return "cuda"


def gloo_cuda_all_gather() -> None:
    """Route the functional all-gather (``_c10d_functional.
    all_gather_into_tensor``, what DTensor issues for ``Shard -> Replicate``)
    of CUDA tensors through c10d's ``all_gather_into_tensor`` on the same
    process group.  On the card, torch 2.11's functional all-gather of CUDA
    tensors over gloo crashes the process (SIGSEGV), while c10d's
    all-gather, and the functional all-reduce, reduce-scatter and
    all-to-all, run; the ranks of one card share it over gloo
    (`lanes.placement`).  The backend stays gloo.  Registered once a
    process, for the CUDA dispatch key only."""
    if _GLOO_CUDA_LIB:
        return
    import torch
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    def all_gather_into_tensor(inp, group_size, group_name):
        out = inp.new_empty((inp.shape[0] * group_size, *inp.shape[1:]))
        dist.all_gather_into_tensor(out, inp.contiguous(),
                                    group=_resolve_process_group(group_name))
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", all_gather_into_tensor, "CUDA")
    _GLOO_CUDA_LIB.append(lib)


def _mesh(shape: tuple, axes: tuple):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh needs a process group of "
                           f"{n} ranks; none is initialised (see launch.mesh.fake_world and "
                           "launch.lanes.run_lanes)")
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(f"need {n} ranks, found {world}: start {n} ranks (launch.lanes."
                           f"run_lanes), or trace on meta in fake_world({n})")
    import torch

    ranks = torch.arange(n).reshape(shape)
    dev = _device_type()
    if dev == "cuda" and dist.get_backend() == "gloo":
        gloo_cuda_all_gather()
    return DeviceMesh(dev, ranks, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_debug_mesh(data: int = 2, model: int = 2):
    """Small (data, model) mesh for tests and the card's sharded step."""
    return _mesh((data, model), ("data", "model"))


@contextlib.contextmanager
def fake_world(n: int, rank: int = 0):
    """A fake process group of ``n`` ranks in this process (this one rank
    ``rank``), destroyed on exit.  Raises if a group is initialised already."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is initialised already")
    dist.init_process_group("fake", world_size=n, rank=rank, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()
