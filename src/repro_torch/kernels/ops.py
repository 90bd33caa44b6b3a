"""Public kernel entry points, dispatched on the tensor's device.

A CUDA tensor launches the hand-written kernel (`kernels.weighted_update`,
`kernels.flash_attention`, `kernels.ssd_scan`, `kernels.moe_gmm`) or raises;
there is no fallback.  A CPU tensor — which exists only because the caller asked for
``device="cpu"`` — takes
the plain version in `kernels.ref`.  Any other device raises.  The column-block width is fixed
(no autotune table yet).
"""
from __future__ import annotations

import torch

from ..device import on_cuda
from ..tree import tree_flatten, tree_leaves, tree_map
from ..unported import unported
from . import ref
from . import weighted_update as _cuda
from .flash_attention import FlashAttention
from .moe_gmm import MoeGMM
from .ssd_scan import SSDScan

__all__ = ["weighted_update", "weighted_update_tree", "tree_weighted_update",
           "block_prefix_update", "flash_attention", "ssd_scan", "moe_gmm"]


def weighted_update(w, g, scale, m=None, momentum=0.0):
    """K1: ``(w', m')`` with w' = w - scale*(momentum*m + g)."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=w.device)
    if on_cuda(w):
        return _cuda.weighted_update(w, g, scale, m=m, momentum=momentum)
    return ref.weighted_update_ref(w, g, scale, m=m, momentum=momentum)


def block_prefix_update(snaps, w, D, slots):
    """K2: ``(snaps', w')`` — the blocked update, ``snaps`` written in place."""
    if on_cuda(snaps):
        return _cuda.block_prefix_update(snaps, w, D, slots)
    return ref.block_prefix_update_ref(snaps, w, D, slots)


def flash_attention(q, k, v, causal=True, window=0, q_offset=0, bq=128, bk=128):
    """K3: differentiable GQA flash attention, q (B,S,H,D), k/v (B,T,K,D).

    ``bq`` / ``bk`` are the TPU kernel's VMEM tile and are accepted and
    ignored: the CUDA kernel has its own tile.  `FlashAttention`'s forward
    dispatches on the tensor's device with `device.on_cuda`, as the
    functions above do."""
    return FlashAttention.apply(q, k, v, causal, window, q_offset)


def ssd_scan(x, dt, A, Bm, Cm, chunk=64, init_state=None):
    """K4: differentiable Mamba2 chunked SSD from a zero state.

    x (B,S,H,P), dt (B,S,H) fp32, A (H,) (or per row (B,H)) fp32, Bm/Cm
    (B,S,N) -> ``(y (B,S,H,P), state (B,H,N,P) fp32)``.  ``A`` goes to
    `SSDScan` per row, so a `vmap` over snapshots folds into one launch.
    The kernel starts from a zero state: with ``init_state`` a CUDA tensor
    raises (prefill with a state is the serving plane's), a CPU tensor
    takes the plain version."""
    if init_state is not None:
        if on_cuda(x):
            raise unported("ssd_scan with init_state", 11)
        return ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk, init_state)
    if A.ndim == 1:
        A = A.expand(x.shape[0], A.shape[0])
    return SSDScan.apply(x, dt, A, Bm, Cm, chunk)


def moe_gmm(x, w, bc=128, bf=128, bd=128):
    """K5: differentiable grouped matmul y[e] = x[e] @ w[e], x (E,C,D),
    w (E,D,F) -> (E,C,F) in x's dtype, fp32 accumulation.

    ``bc`` / ``bf`` / ``bd`` are the TPU kernel's VMEM tiles and are
    accepted and ignored: the CUDA kernel has its own tile and takes any C,
    D and F.  `MoeGMM`'s forward dispatches on the tensor's device with
    `device.on_cuda`, as the functions above do."""
    return MoeGMM.apply(x, w)


def weighted_update_tree(params, grads, scale, momenta=None, momentum=0.0):
    """K1 across a parameter pytree, one launch per leaf.

    Returns ``(params', momenta')`` (``momenta'`` None without momentum).
    """
    if momenta is None:
        return tree_map(lambda w, g: weighted_update(w, g, scale)[0], params, grads), None
    leaves, unflatten = tree_flatten(params)
    pairs = [
        weighted_update(w, g, scale, m=m, momentum=momentum)
        for w, g, m in zip(leaves, tree_leaves(grads), tree_leaves(momenta))
    ]
    return unflatten([p[0] for p in pairs]), unflatten([p[1] for p in pairs])


def tree_weighted_update(w, g, scale):
    """The engine's ``update="pallas"`` path: K1 per leaf, no momentum."""
    return weighted_update_tree(w, g, scale)[0]
