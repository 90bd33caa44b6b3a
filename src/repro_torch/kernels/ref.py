"""Plain PyTorch versions of the hand-written kernels (the correctness ground truth).

The CPU path of `kernels.ops` runs these, and the GPU checks hold each CUDA
kernel against them on the same inputs.  They mirror `repro.kernels.ref`.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["weighted_update_ref", "block_prefix_update_ref", "block_scatter_rows_ref",
           "flash_attention_ref", "ssd_scan_ref", "moe_gmm_ref"]


def weighted_update_ref(
    w: torch.Tensor, g: torch.Tensor, scale, m: torch.Tensor | None = None,
    momentum: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Generalized-AsyncSGD server update (Alg. 1 line 10):
        m' = momentum*m + g          (if momentum buffer provided)
        w' = w - scale * (m' or g)   scale = eta/(n p_j)
    fp32 math, params cast back to their storage dtype.

    ``g`` is cast to ``w.dtype`` before the fp32 math — the dtype rule of the
    TPU kernel (`repro/kernels/weighted_update.py:weighted_update`) and of the
    CUDA kernel; the JAX reference skips that cast.  The two agree whenever
    ``g`` already has ``w``'s dtype, as on the fp32 main path.

    Across cells ``scale`` is (B,) and the leaves have a leading axis of B
    cells: cell c takes scale[c].
    """
    gf = g.to(w.dtype).float()
    s = torch.as_tensor(scale, dtype=torch.float32, device=w.device)
    if s.ndim:  # one scale a cell, broadcast down the cell's values
        s = s.reshape(s.shape + (1,) * (w.ndim - s.ndim))
    if m is not None:
        mf = momentum * m.float() + gf
        step = mf
    else:
        mf = None
        step = gf
    wf = w.float() - s * step
    return wf.to(w.dtype), (None if mf is None else mf.to(m.dtype))


def block_prefix_update_ref(
    snaps: torch.Tensor,   # (R, P) flat-packed snapshot ring buffer, updated in place
    w: torch.Tensor,       # (P,) current server weights
    D: torch.Tensor,       # (E, P) per-event scaled update deltas (0 on padding)
    slots: torch.Tensor,   # (E,) int64 ring slot per event (trash row on padding)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocked server update (the engine's plain path / kernel oracle):

        W_i = w - sum_{j<=i} D_j,   snaps[slot_i] = W_i,   w' = W_{E-1}

    fp32 prefix accumulation, rows cast to the ring-buffer storage dtype.
    ``snaps`` is written in place, one row at a time in event order, so
    duplicate (padded, trash-row) slots resolve last-writer-wins as in the
    kernels; a batched ``index_put_`` with duplicates is nondeterministic on
    CUDA.  Returns ``(snaps, w')``.

    Across cells every operand has a leading axis of B cells — ``snaps``
    (B, R, P), ``w`` (B, P), ``D`` (B, E, P), ``slots`` (B, E) in [0, R) —
    and lane i writes ``snaps[arange(B), slots[:, i]] = W[:, i]``, lane by
    lane in event order; one cell is the case B = 1.
    """
    if snaps.ndim == 2:
        _, w1 = block_prefix_update_ref(snaps[None], w[None], D[None], slots[None])
        return snaps, w1[0]
    W = w.float()[:, None, :] - torch.cumsum(D.float(), dim=1)
    rows = W.to(snaps.dtype)
    cells = torch.arange(snaps.shape[0], device=slots.device)
    idx = slots.to(torch.int64)
    for i in range(rows.shape[1]):  # E <= 16; distinct cells, so no duplicate in a lane
        snaps[cells, idx[:, i]] = rows[:, i]
    return snaps, W[:, -1].to(w.dtype)


def block_scatter_rows_ref(
    snaps: torch.Tensor,   # (R, P) flat-packed snapshot ring buffer, updated in place
    w: torch.Tensor,       # (P,) current server weights (dtype reference only)
    W: torch.Tensor,       # (E, P) precomputed intermediate weight rows (fp32)
    slots: torch.Tensor,   # (E,) int64 ring slot per event (trash row on padding)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter-only half of the blocked update (the lane-sharded path):

        snaps[slot_i] = W_i,   w' = W_{E-1}

    The iterates W arrive precomputed (each rank builds them from its local
    lane prefix plus the all-gathered offsets of the other ranks).  Rows are
    cast to the ring's dtype and written in place one at a time in event
    order, so duplicate (padded, trash-row) slots resolve last-writer-wins
    as in the kernels.  Returns ``(snaps, w')``.

    Across cells every operand has a leading axis of B cells — ``snaps``
    (B, R, P), ``w`` (B, P), ``W`` (B, E, P), ``slots`` (B, E) — and lane i
    writes ``snaps[arange(B), slots[:, i]] = W[:, i]``, lane by lane in
    event order; one cell is the case B = 1.
    """
    if snaps.ndim == 2:
        _, w1 = block_scatter_rows_ref(snaps[None], w[None], W[None], slots[None])
        return snaps, w1[0]
    rows = W.to(snaps.dtype)
    cells = torch.arange(snaps.shape[0], device=slots.device)
    idx = slots.to(torch.int64)
    for i in range(rows.shape[1]):  # E <= 16; distinct cells, so no duplicate in a lane
        snaps[cells, idx[:, i]] = rows[:, i]
    return snaps, W[:, -1].to(w.dtype)


def flash_attention_ref(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, K, D)
    v: torch.Tensor,  # (B, T, K, D)
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    """Causal / sliding-window GQA attention, as `repro.kernels.ref` writes it.

    Scores are q·k in the input dtype, cast to fp32 and divided by sqrt(D)
    (the kernel instead scales q by 1/sqrt(D) before the product); masked
    scores are -1e30, so a fully masked row averages v over all T keys; the
    softmax weights are cast to ``v.dtype`` before P·V (the kernel keeps
    them fp32 — the source of the bf16 gap between the two).
    """
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() / float(np.sqrt(D))
    rel = (torch.arange(S, device=q.device) + q_offset)[:, None] - torch.arange(T, device=q.device)
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (rel >= 0)
    if window:
        mask = mask & (rel < window)
    scores = torch.where(mask, scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(B, S, H, D)


def ssd_scan_ref(x, dt, A, Bm, Cm, chunk: int = 64, init_state=None):
    """The chunked SSD of `models.mamba2.ssd_chunked` (one copy of the
    algorithm), as `repro.kernels.ref.ssd_scan_ref` delegates to the
    reference's.  ``A`` is (H,) or per row (B, H); ``init_state`` (B, H, N, P)
    or None.  Returns ``(y (B,S,H,P) in x's dtype, state (B,H,N,P) fp32)``."""
    from ..models.mamba2 import ssd_chunked

    return ssd_chunked(x, dt, A, Bm, Cm, chunk, init_state)


def moe_gmm_ref(xin: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped (per-expert) matmul on dispatch-form tensors.

    xin: (E, C, D), w: (E, D, F) -> (E, C, F) in xin's dtype, fp32
    accumulation (products of two bf16 values are exact in fp32).
    """
    return torch.einsum("ecd,edf->ecf", xin.float(), w.float()).to(xin.dtype)
