"""Public kernel entry points, dispatched on the tensor's device.

A CUDA tensor launches the hand-written kernel (`kernels.weighted_update`,
`kernels.flash_attention`, `kernels.ssd_scan`, `kernels.moe_gmm`) or raises;
there is no fallback.  A CPU tensor — which exists only because the caller asked for
``device="cpu"`` — takes
the plain version in `kernels.ref`.  Any other device raises.  The column-block width is fixed
(no autotune table yet).
"""
from __future__ import annotations

from ..device import on_cuda
from ..tree import tree_flatten, tree_leaves
from . import ref
from . import weighted_update as _cuda
from .flash_attention import FlashAttention
from .moe_gmm import MoeGMM
from .ssd_scan import SSDScan

__all__ = ["weighted_update", "weighted_update_tree", "tree_weighted_update",
           "block_prefix_update", "block_scatter_rows", "flash_attention", "ssd_scan",
           "moe_gmm"]


def weighted_update(w, g, scale, m=None, momentum=0.0):
    """K1 on one leaf: ``(w', m')`` with w' = w - scale*(momentum*m + g)."""
    if on_cuda(w):
        return _cuda.weighted_update(w, g, scale, m=m, momentum=momentum)
    return ref.weighted_update_ref(w, g, scale, m=m, momentum=momentum)


def block_prefix_update(snaps, w, D, slots):
    """K2: ``(snaps', w')`` — the blocked update, ``snaps`` written in place;
    with a leading cell axis on every operand, one launch for all cells."""
    if on_cuda(snaps):
        return _cuda.block_prefix_update(snaps, w, D, slots)
    return ref.block_prefix_update_ref(snaps, w, D, slots)


def block_scatter_rows(snaps, w, W, slots):
    """K6: ``(snaps', w')`` — the lane-sharded scatter of precomputed iterates,
    ``snaps`` written in place; with a leading cell axis on every operand,
    one launch for all cells."""
    if on_cuda(snaps):
        return _cuda.block_scatter_rows(snaps, w, W, slots)
    return ref.block_scatter_rows_ref(snaps, w, W, slots)


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
    The kernel, like the TPU kernel it replaces, starts from a zero state:
    a call with ``init_state`` takes the plain version on every device, as
    the reference's dispatch does (`repro/kernels/ops.py:ssd_scan`).  The
    argument chooses that route, never a failure of the kernel."""
    if init_state is not None:
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
    """K1 across a parameter pytree: one launch over all its leaves on the
    card (`weighted_update.weighted_update_leaves`), the plain version leaf
    by leaf on the CPU.  A (B,) ``scale`` updates B cells at once: every
    leaf has a leading axis of B cells and cell c takes scale[c].

    Returns ``(params', momenta')`` (``momenta'`` None without momentum).
    """
    leaves, unflatten = tree_flatten(params)
    grads = tree_leaves(grads)
    ms = None if momenta is None else tree_leaves(momenta)
    if leaves and on_cuda(leaves[0]):
        new, new_ms = _cuda.weighted_update_leaves(leaves, grads, scale, ms, momentum)
    else:
        pairs = [ref.weighted_update_ref(w, g, scale, m=None if ms is None else ms[i],
                                         momentum=momentum)
                 for i, (w, g) in enumerate(zip(leaves, grads))]
        new = [p[0] for p in pairs]
        new_ms = None if ms is None else [p[1] for p in pairs]
    return unflatten(new), (None if new_ms is None else unflatten(new_ms))


def tree_weighted_update(w, g, scale):
    """The engine's ``update="pallas"`` path: K1, no momentum, one launch
    an event on the card (across cells, one for each `MAX_LEAVES` cell
    leaves)."""
    return weighted_update_tree(w, g, scale)[0]
