"""Device-resident Generalized-AsyncSGD scan engine.

The PyTorch counterpart of `repro.core.engine_scan`.  The event stream
(J_k, K_{k+1}, t_k) of the closed Jackson network does not depend on the
gradient values, so it is simulated first — on the host
(`queue_sim.export_stream`), or on the device a chunk at a time by the
fused runner (`make_fused_runner`, ``stream="device"``, with adaptive
sampling between chunks) — and Algorithm 1 replays it on the device:

  * the C in-flight dispatch snapshots live in ONE flat-packed (C, P) ring
    buffer (optionally stored in a narrower ``snapshot_dtype``);
  * `update_step` gathers the completing task's snapshot from its slot,
    computes the client gradient with ``grad_fn(j, w, k)``, applies the
    importance-weighted update and writes the updated parameters back into
    the same slot (one task completes and one departs per step, Lemma 9);
  * with ``block_size=E > 1`` the engine replays conflict-free event
    micro-blocks instead: one batched snapshot gather, one vmapped gradient
    call, then the exact sequential iterates by a prefix sum over the scaled
    updates, written back in one pass (``kernel="pallas"``: the CUDA kernel
    `kernels.weighted_update.block_prefix_update`; the blocked ring has a
    trash row C that padded lanes write);
  * ``guard=GuardConfig(...)`` rejects non-finite or norm-exploding
    gradients (the update is suppressed, the re-dispatch still happens)
    and counts them in a (2,) ``[guard_rejects, stale_drops]`` counter the
    guarded runners return beside the weights;
  * ``fedbuff_Z > 0`` replays FedBuff instead: the gradients accumulate in
    a buffer that is flushed (averaged and applied) every Z-th server step;
    the blocked engine decomposes the flushes into the same prefix form
    (`_fedbuff_block_deltas`);
  * ``lane_devices=D > 1`` shards the E gradient lanes of every micro-block
    over the D ranks of a `torch.distributed` process group: each rank
    differentiates its E/D lanes and one ``all_gather`` per block
    recombines them, the guard's reject flags riding along
    (``kernel="pallas"``: the CUDA kernel
    `kernels.weighted_update.block_scatter_rows` writes the iterates); the
    fused runner shards its blocks the same way, and with a cell axis the
    ranks of a ``shard × lane`` group split the cells as well
    (`jit_fused_runner(shard_devices=, lane_devices=)`);
  * evaluation runs every ``eval_every`` events (per event) or after each
    eval-interval group of blocks (blocked), on micro-block boundaries by
    construction (`segment_blocks(cut_every=)`);
  * ``vmap_streams=True`` replays B streams (the scenario matrix's cells)
    in lockstep along an explicit cell axis: a (B, C, P) ring, one gather,
    one vmapped gradient call, one update and one scatter per event or
    block for all cells, FedBuff with one buffer and the guard with one
    counter a cell (`_make_host_cells_runner`, `_make_block_step(cells=
    True)`).

Where JAX runs one `lax.scan`, this engine runs a Python loop over events
whose arrays already live on the device: the loop indexes them with Python
ints, which gives 0-d device tensors, and every gather and scatter takes
them through `index_select` / `index_copy_` — no `.item()`, so the host
never waits for the device inside a run (the guard's verdict and counter
stay device tensors too).  The ring buffer is updated in place (JAX
donates it).  Both rings have a trash row C: on a fault or scenario
stream a flip or stage event carries slot C and scale 0, so it reads and
writes that row and changes nothing (JAX clamps the gather and drops the
scatter instead).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial, reduce
from typing import Any, Callable

import numpy as np
import torch

from ..tree import tree_flatten, tree_leaves, tree_map
from .queue_sim import KIND_COMPLETE, EventBlocks, EventStream

__all__ = [
    "GuardConfig",
    "blocked_inputs",
    "blocked_inputs_batch",
    "jit_fused_runner",
    "jit_runner",
    "make_fused_runner",
    "make_runner",
    "step_scales",
    "stream_arrays",
    "world_size",
]

Pytree = Any


def step_scales(
    stream: EventStream, eta: float, p: np.ndarray, weighting: str
) -> np.ndarray:
    """Per-step update scale as a (T,) array: eta/(n p_{J_k}) or plain eta.

    On fault-injected streams (``stream.kind`` set) non-completion events
    carry scale 0.
    """
    if weighting == "importance":
        sc = (eta / (stream.n * np.asarray(p, float)))[stream.J]
    elif weighting == "plain":
        sc = np.full(stream.T, eta)
    else:
        raise ValueError(weighting)
    if stream.kind is not None:
        sc = np.where(stream.kind == KIND_COMPLETE, sc, 0.0)
    return sc


def stream_arrays(stream: EventStream, device):
    """Device copies of the replay inputs (J, slot) for one stream (int64,
    torch's index dtype)."""
    return (
        torch.as_tensor(stream.J, dtype=torch.int64, device=device),
        torch.as_tensor(stream.slot, dtype=torch.int64, device=device),
    )


# ------------------------------------------------------------------ #
# blocked input layout (host-side numpy prep)
# ------------------------------------------------------------------ #
def _blocked_layout(
    blocks: EventBlocks,
    scale: np.ndarray,
    eval_every: int,
    chunk_blocks: int | None = None,
    tail_blocks: int | None = None,
) -> tuple:
    """(J, slot, scale, k, mask) rows + (chunk_blocks, n_chunks) layout.

    With ``eval_every`` the blocks are grouped per eval interval and each
    group is padded with all-masked rows to a common ``chunk_blocks`` width,
    so evaluation falls after exactly `eval_every` events; trailing blocks
    past the last eval point are appended flat.  Padded rows are no-ops:
    mask False, trash slot C, zero scale.
    """
    E = blocks.block_size
    sc_all = blocks.blocked_scales(scale).astype(np.float32)
    if not eval_every:
        n_tail = blocks.B if tail_blocks is None else tail_blocks
        if n_tail < blocks.B:
            raise ValueError("tail_blocks smaller than block count")
        pad = n_tail - blocks.B
        def padded(a, fill):
            return np.concatenate(
                [a, np.full((pad, E), fill, a.dtype)]) if pad else a
        return (
            padded(blocks.J, 0),
            padded(blocks.slot, blocks.C),
            padded(sc_all, 0.0),
            padded(blocks.idx, 0),
            padded(blocks.mask, False),
            0,
            0,
        )
    if blocks.cut_every != eval_every:
        raise ValueError(
            f"blocks were cut every {blocks.cut_every} events; eval_every="
            f"{eval_every} requires segment_blocks(cut_every={eval_every})"
        )
    n_chunks = blocks.T // eval_every
    group = np.minimum(blocks.idx[:, 0] // eval_every, n_chunks)
    counts = np.bincount(group, minlength=n_chunks + 1)
    G = int(counts[:n_chunks].max()) if n_chunks else 0
    if chunk_blocks is not None:
        if chunk_blocks < G:
            raise ValueError("chunk_blocks smaller than densest eval interval")
        G = chunk_blocks
    n_tail = int(counts[n_chunks])
    if tail_blocks is not None:
        if tail_blocks < n_tail:
            raise ValueError("tail_blocks smaller than tail block count")
        n_tail = tail_blocks
    rows = n_chunks * G + n_tail
    J = np.zeros((rows, E), np.int32)
    slot = np.full((rows, E), blocks.C, np.int32)
    sc = np.zeros((rows, E), np.float32)
    kb = np.zeros((rows, E), np.int32)
    mask = np.zeros((rows, E), bool)
    pos = 0
    for g in range(n_chunks + 1):
        cnt = int(counts[g])
        r0 = g * G if g < n_chunks else n_chunks * G
        src = slice(pos, pos + cnt)
        dst = slice(r0, r0 + cnt)
        J[dst], slot[dst], sc[dst] = blocks.J[src], blocks.slot[src], sc_all[src]
        kb[dst], mask[dst] = blocks.idx[src], blocks.mask[src]
        pos += cnt
    return J, slot, sc, kb, mask, G, n_chunks


def blocked_inputs(blocks: EventBlocks, scale: np.ndarray, eval_every: int = 0):
    """Host-side blocked replay inputs for one stream.

    Returns ``(J, slot, scale, k, mask, chunk_blocks, n_chunks)`` — the
    numpy arrays plus the two layout ints of the blocked runner.
    """
    return _blocked_layout(blocks, scale, eval_every)


def blocked_inputs_batch(
    blocks_list: list[EventBlocks],
    scales_list: list[np.ndarray],
    eval_every: int = 0,
):
    """Stacked blocked inputs over cells, padded to one common layout.

    The per-cell cuts give different block counts; every cell is padded
    (all-masked no-op rows) to the batch-wide maximum, so the cells replay
    in lockstep as (S, B, E) arrays with shared ``(chunk_blocks, n_chunks)``
    (`jit_runner(..., vmap_streams=True)`).
    """
    layouts = [_blocked_layout(b, s, eval_every) for b, s in zip(blocks_list, scales_list)]
    if eval_every:
        G = max(lay[5] for lay in layouts)
        n_chunks = layouts[0][6]
        tail = max(lay[0].shape[0] - n_chunks * lay[5] for lay in layouts)
        layouts = [_blocked_layout(b, s, eval_every, chunk_blocks=G, tail_blocks=tail)
                   for b, s in zip(blocks_list, scales_list)]
    else:
        rows = max(lay[0].shape[0] for lay in layouts)
        layouts = [_blocked_layout(b, s, 0, tail_blocks=rows)
                   for b, s in zip(blocks_list, scales_list)]
    stacked = tuple(np.stack([lay[i] for lay in layouts]) for i in range(5))
    return stacked + (layouts[0][5], layouts[0][6])


# ------------------------------------------------------------------ #
# shared pieces: snapshot codec + the algorithm step
# ------------------------------------------------------------------ #
def _as_dtype(d) -> torch.dtype:
    return d if isinstance(d, torch.dtype) else getattr(torch, str(d))


def _snapshot_codec(w0, snapshot_dtype=None, pad_to: int = 1):
    """Flat-packed snapshot storage for an all-float parameter pytree.

    The ring buffer is ONE (C, P) tensor — a single gather and scatter per
    step.  Mixed float trees pack into the promoted dtype and ``unpack``
    casts each leaf back.  Returns ``(pack, unpack, enc)``: ``pack``
    flattens a pytree to the padded compute-dtype vector (leaves in JAX's
    order, `tree.tree_flatten`), ``unpack`` restores the pytree from a
    stored row, ``enc`` casts a compute-dtype vector to the storage dtype.
    ``pad_to`` rounds the packed length up once, at init.  Trees with
    non-float leaves return ``(None, None, None)``.
    """
    leaves, unflatten = tree_flatten(w0)
    leaf_dtypes = [leaf.dtype for leaf in leaves]
    if not all(d.is_floating_point for d in leaf_dtypes):
        if snapshot_dtype is not None:
            raise ValueError(
                "snapshot_dtype requires all-float parameters "
                "(flat-packed snapshot storage)"
            )
        return None, None, None
    compute_dtype = reduce(torch.promote_types, leaf_dtypes)
    store_dtype = compute_dtype if snapshot_dtype is None else _as_dtype(snapshot_dtype)
    shapes = [tuple(leaf.shape) for leaf in leaves]
    sizes = [int(np.prod(s)) if s else 1 for s in shapes]
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(int).tolist()
    P = offs[-1]
    P_pad = ((P + pad_to - 1) // pad_to) * pad_to

    # a mixed tree's unpacked leaves own their storage: a leaf already in the
    # compute dtype would otherwise be a view that keeps the whole packed row
    # alive (at Zamba2-2.7B's width a 9.69 GB fp32 row for its two small fp32
    # leaves)
    mixed = len(set(leaf_dtypes)) > 1

    def pack(w):
        # `cat` promotes the leaves to the compute dtype itself: no cast copy
        # of each leaf beside the packed vector
        flat = torch.cat([x.reshape(-1) for x in tree_flatten(w)[0]]).to(compute_dtype)
        if P_pad != P:
            flat = torch.nn.functional.pad(flat, (0, P_pad - P))
        return flat

    def unpack(flat):
        return unflatten([
            flat[offs[i] : offs[i + 1]].reshape(shapes[i]).to(leaf_dtypes[i], copy=mixed)
            for i in range(len(shapes))
        ])

    if store_dtype == compute_dtype:
        enc = lambda x: x
    else:
        enc = lambda x: x.to(store_dtype)
    return pack, unpack, enc


_AXPY_CHUNK = 1 << 27  # elements per fp32 pass of a narrow-dtype axpy (512 MB)


def _flat_axpy(w: torch.Tensor, g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``w - scale * g`` cast to ``w.dtype``, with JAX's type promotion.

    JAX promotes a bf16 vector times a float32 scale to float32 and rounds
    once at the end; torch would keep bf16 and round twice.  So a narrow
    dtype goes through float32, a chunk at a time: at 2.5 G parameters one
    unchunked pass would hold ~30 GB of float32 temporaries.  With a cell
    axis ``w`` and ``g`` are (B, P) and ``scale`` is (B, 1); the chunks then
    cut the columns."""
    if w.dtype == torch.float32 and g.dtype == torch.float32:
        return w - scale * g
    out = torch.empty_like(w)
    P = w.shape[-1]
    step = max(1, _AXPY_CHUNK * P // max(w.numel(), 1))
    for i in range(0, P, step):
        sl = slice(i, i + step)
        out[..., sl] = w[..., sl].float() - scale * g[..., sl].float()
    return out


@dataclass(frozen=True)
class GuardConfig:
    """Divergence guard on the server update (`repro`'s, same fields).

    Guard order per event, after fault-kind masking (a crash, timeout,
    flip or stage event already carries scale 0 and is never counted):

      1. staleness cutoff: an update whose task has been in flight for more
         than ``stale_cutoff`` server steps is dropped (scale -> 0) and
         counted in ``stale_drops`` (the host stream applies it to the step
         scales before the replay, `async_sgd._run_scan`);
      2. divergence: a gradient that is non-finite, or whose l2 norm
         exceeds ``max_grad_norm`` (0 disables the cap; non-finite
         rejection is always on), is suppressed and counted in
         ``guard_rejects``; the re-dispatch scatter still happens, so the
         queue dynamics are untouched.

    Guarded runners return the (2,) int32 counter ``[guard_rejects,
    stale_drops]`` beside the final iterate.  Requires the flat-packed
    snapshot codec (all-float parameters, default linear update).
    """

    max_grad_norm: float = 0.0
    stale_cutoff: int = 0

    @property
    def enabled(self) -> bool:
        return True  # non-finite rejection is unconditional

    def cache_key(self):
        return (float(self.max_grad_norm), int(self.stale_cutoff))


def _guard_bad(g, max_sq: float):
    """The guard's verdict on packed gradients: the fp32 squared norm over
    the last dim is non-finite, or above ``max_sq`` when the cap is on (> 0).
    A (P,) vector gives a 0-d verdict, (E, P) rows an (E,) one."""
    sq = torch.sum(torch.square(g.to(torch.float32)), dim=-1)
    bad = ~torch.isfinite(sq)
    return bad | (sq > max_sq) if max_sq > 0.0 else bad


def _make_flat_guard(guard: GuardConfig):
    """``check(g, scale, gcnt, stale) -> (bad, scale, gcnt)`` on one packed
    gradient: the one place the per-event guard's order and counting live
    (the verdict itself is `_guard_bad`'s, shared with the blocked rows).

    ``bad`` is returned rather than a zeroed gradient, so the caller
    computes the candidate update and then selects (``where(bad, w,
    w_new)``).  Every value stays a device tensor: a ``bool(bad)`` per
    event would stall the replay.  The counter is added to in place.
    """
    max_sq = float(guard.max_grad_norm) ** 2
    cutoff = int(guard.stale_cutoff)

    def check(g, scale, gcnt, stale=None):
        live = scale != 0
        if cutoff > 0 and stale is not None:
            st = live & (stale > cutoff)
            gcnt[1] += st.to(torch.int32)
            scale = torch.where(st, 0.0, scale)
            live = live & ~st
        bad = _guard_bad(g, max_sq)
        gcnt[0] += (bad & live).to(torch.int32)
        return bad, scale, gcnt

    return check


def _make_update_step(grad_fn, update_fn, pack, unpack, flat_mode, enc, fedbuff_Z=0,
                      guard=None):
    """The algorithm half of a CS step, independent of the event source.

    ``update_step((w, snaps, acc, gcnt), j, s, scale, k[, stale])`` consumes
    one event (completing client j, ring slot s, update scale, server step
    k — all 0-d device tensors) exactly as Algorithm 1 lines 9-11 and
    returns the new carry.  In flat mode ``w`` (and the FedBuff buffer
    ``acc``) is the packed vector and the update is one axpy; otherwise (a
    given ``update_fn``, e.g. K1 over the leaves) ``w`` and ``acc`` are
    pytrees.  With ``fedbuff_Z > 0`` the gradient joins the buffer, which
    is applied with scale ``scale / Z`` and emptied on every Z-th server
    step.  ``guard`` (flat mode only) checks the gradient first
    (`_make_flat_guard`; ``stale``, the steps the task spent in flight,
    feeds its staleness cutoff) and counts in ``gcnt``; under FedBuff a bad
    gradient is zeroed before the buffer takes it.  ``snaps`` is written in
    place.
    """
    if unpack is None:
        raise ValueError(
            "the torch engine needs all-float parameters (flat-packed "
            "snapshot storage)"
        )
    if guard is not None and not flat_mode:
        raise ValueError(
            "the divergence guard requires the flat-packed snapshot codec "
            "(uniform-dtype parameters, default linear update)"
        )
    check = _make_flat_guard(guard) if guard is not None else None

    def update_step(ucarry, j, s, scale, k, stale=None):
        w, snaps, acc, gcnt = ucarry
        s1 = s.reshape(1)
        # gather the completing task's dispatch-time snapshot (Alg. 1 line 9);
        # no name holds it past the gradient
        g = grad_fn(j, unpack(snaps.index_select(0, s1)[0]), k)
        if flat_mode:
            g = pack(g)
        bad = None
        if check is not None:
            bad, scale, gcnt = check(g, scale, gcnt, stale)
        if fedbuff_Z > 0:
            fire = ((k + 1) % fedbuff_Z) == 0
            eff = torch.where(fire, scale / fedbuff_Z, 0.0)
            keep = lambda a: a * (~fire).to(a.dtype)  # noqa: E731
            if flat_mode:
                if bad is not None:  # the buffer consumes g beyond this event
                    g = torch.where(bad, 0.0, g)
                acc = acc + g
                # JAX promotes the narrow buffer times the fp32 scale and
                # rounds once: `_flat_axpy`'s fp32 path
                w = _flat_axpy(w, acc, eff)
                acc = keep(acc)
            else:
                acc = tree_map(lambda a, y: a + y, acc, g)
                w = update_fn(w, acc, eff)
                acc = tree_map(keep, acc)
        elif flat_mode:
            w_new = _flat_axpy(w, g, scale)
            # the candidate axpy, then a select: no host sync on the verdict
            w = torch.where(bad, w, w_new) if bad is not None else w_new
        else:
            w = update_fn(w, g, scale)
        del g  # before the new row is packed: at full width each is GBs
        row = enc(w) if flat_mode else enc(pack(w))
        # the freed slot hosts the new dispatch with the updated params
        snaps.index_copy_(0, s1, row[None])
        return w, snaps, acc, gcnt

    return update_step


def _make_batched_grads(grad_fn, pack, unpack):
    """Batched gradient call over one micro-block: (E,) client ids, (E, P)
    stored snapshot rows, (E,) server steps -> (E, P) packed gradients.

    `torch.func.vmap` over the whole gradient source — its minibatch gather
    included (`fl.engine.DeviceTaskClients.client_batch` gathers with
    `index_select`, which has a batching rule)."""
    return torch.func.vmap(lambda j, wi, k: pack(grad_fn(j, unpack(wi), k)))


def _fedbuff_block_deltas(Gm, scm, k, m, acc, Z):
    """Closed-form FedBuff per-event deltas over one (full) micro-block.

    Gradient g_j is applied exactly once — at the first buffer flush at or
    after its arrival — so D_i = 1{flush at i} * (scale_i/Z) * (carried
    buffer + gradients since the previous flush), computed from the in-block
    flush positions.  Returns ``(D, acc')``: the (E, P) scaled update deltas
    (prefix-summable like the gen_async path) and the buffer carried out of
    the block.  With a leading cell axis — ``Gm`` (B, E, P), ``scm`` / ``k``
    / ``m`` (B, E), ``acc`` (B, P) — each cell keeps its own buffer and its
    own flush positions.  The flush positions are device tensors throughout
    (gathers by `torch.gather`, selections by `torch.where`): no host sync.
    """
    cum = torch.cumsum(Gm, dim=-2)
    fire = m & (((k + 1) % Z) == 0)
    E = m.shape[-1]
    fi = torch.where(fire, torch.arange(E, dtype=torch.int64, device=m.device), -1)
    last_incl = torch.cummax(fi, dim=-1).values  # last flush at or before i
    prev = torch.cat([fi.new_full(fi.shape[:-1] + (1,), -1), last_incl[..., :-1]], dim=-1)

    def rows(i):  # the rows i of cum, (..., len(i), P)
        return torch.gather(cum, -2, i.clamp(min=0)[..., None].expand(*i.shape, cum.shape[-1]))

    prevcum = torch.where((prev >= 0)[..., None], rows(prev), 0.0)
    first = torch.where(prev < 0, 1.0, 0.0)[..., None]
    acc_at = cum - prevcum + first * acc.float()[..., None, :]
    D = torch.where(fire, scm / Z, 0.0)[..., None] * acc_at
    lastf = last_incl[..., -1:]  # (..., 1): the block's last flush, -1 if none
    flushed = torch.where(lastf >= 0, rows(lastf)[..., 0, :], 0.0)
    carried = torch.where(lastf >= 0, 0.0, 1.0) * acc.float()
    return D, (carried + (cum[..., -1, :] - flushed)).to(acc.dtype)


def _all_gather_lanes(group, *ts, cells: bool = False):
    """All-gather per-lane tensors over the lane ranks in ONE collective.

    Each (El, ...) tensor is viewed as bytes and the byte rows are packed
    side by side into one (El, nbytes) uint8 tensor, so the lane prefixes,
    gradients, slot ids and reject flags of one block ride in a single
    ``all_gather`` (the list form, which every backend takes).  Returns the
    (E, ...) tensors, rank r's lanes at rows [r*El, (r+1)*El) — the
    contiguous lane split.  With ``cells`` every tensor is (B, El, ...), the
    cell axis leading, and comes back (B, E, ...).  Under NCCL the gather
    stays on the device; `ProcessGroupGloo` stages CUDA tensors through host
    memory itself.
    """
    import torch.distributed as dist

    lead = tuple(ts[0].shape[:2 if cells else 1])
    parts = [t.contiguous().reshape(*lead, -1).view(torch.uint8) for t in ts]
    buf = torch.cat(parts, dim=-1)
    out = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, buf, group=group)
    full = torch.cat(out, dim=len(lead) - 1)  # along the lanes
    res, o = [], 0
    for t, part in zip(ts, parts):
        nb = part.shape[-1]
        res.append(full[..., o : o + nb].contiguous().view(t.dtype)
                   .reshape(full.shape[:-1] + t.shape[len(lead):]))
        o += nb
    return res


def _make_block_step(grad_fn, pack, unpack, kernel, fedbuff_Z=0, lane_group=None, guard=None,
                     cells: bool = False):
    """One event micro-block of the blocked engine (flat-packed mode).

    ``block_step((w, snaps, acc, gcnt), j, s, scale, k, mask) -> (w, snaps,
    acc, gcnt)`` consumes up to E conflict-free events: one batched snapshot
    gather, one vmapped gradient call, then the exact sequential iterates
    w_i = w_0 - sum_{j<=i} D_j written back in one pass.  Padded lanes (mask
    False) carry zero scale and the trash ring row, so they are arithmetic
    no-ops.  FedBuff decomposes into the same prefix form
    (`_fedbuff_block_deltas`).

    ``cells=True`` steps B cells in lockstep: (B, P) weights, the (B, C+1,
    P) ring, (B, E) block columns, a (B, P) FedBuff buffer and a (B, 2)
    counter.  The B·E snapshot rows are gathered at once and differentiated
    in one vmapped call (cells and lanes flattened into one vmap level), and
    one K2 (or K6) launch updates every cell.  The step is written once for
    both shapes: only the snapshot gather knows the cell axis.

    With ``lane_group`` (a `torch.distributed` process group of D ranks)
    the step runs in every rank on its own E/D lanes (of every cell): it
    gathers the snapshots of — and differentiates — only those, and ONE
    all-gather per block recombines them (`_all_gather_lanes`, the cell
    axis leading).  gen_async gathers the local inclusive lane prefixes and
    slot ids; the exclusive offsets of the ranks before it fall out of the
    gathered lane totals, and the iterates are scattered into the replicated
    ring identically on every rank (K6, `kernels.ops.block_scatter_rows`, or
    its plain version; across cells one launch).  FedBuff gathers the masked
    lane gradients instead — its flush positions couple all lanes — and runs
    the closed form on the full block, replicated (K2 or its plain version).

    ``guard`` checks each lane's gradient row before the deltas: a
    non-finite or over-norm row is zeroed (an exact no-op through the
    prefix sum and K2) and counted in ``gcnt`` if its scale is live.  Under
    lanes each rank's reject flags ride in the block's one all-gather, so
    every rank adds the sum over all ranks.  The staleness cutoff is the
    caller's (the scales arrive already zeroed).
    """
    if kernel == "pallas":
        # the hand-written CUDA kernels on a CUDA ring, the plain versions
        # on a CPU ring (dispatch by the tensor's device)
        from ..kernels.ops import block_prefix_update as apply_block
        from ..kernels.ops import block_scatter_rows as scatter_rows
    elif kernel == "jnp":
        from ..kernels.ref import block_prefix_update_ref as apply_block
        from ..kernels.ref import block_scatter_rows_ref as scatter_rows
    else:
        raise ValueError(kernel)
    grads = _make_batched_grads(grad_fn, pack, unpack)
    max_sq = float(guard.max_grad_norm) ** 2 if guard is not None else 0.0

    def gather(*ts):
        return _all_gather_lanes(lane_group, *(t for t in ts if t is not None), cells=cells)

    def snapshot_rows(snaps, s):
        if not cells:
            return snaps.index_select(0, s)
        B, R, P = snaps.shape
        base = torch.arange(B, dtype=torch.int64, device=s.device)[:, None] * R
        return snaps.view(B * R, P).index_select(0, (base + s).reshape(-1))

    def block_step(ucarry, j, s, sc, k, m):
        w, snaps, acc, gcnt = ucarry
        lead, P = tuple(j.shape[:-1]), snaps.shape[-1]  # lead: () or (B,)
        El = j.shape[-1]
        G = grads(j.reshape(-1), snapshot_rows(snaps, s), k.reshape(-1)).view(*lead, El, -1)
        scm = torch.where(m, sc, 0.0).to(torch.float32)
        rej = None
        if guard is not None:
            bad = _guard_bad(G, max_sq)
            rej = (bad & (scm != 0)).to(torch.int32)
            G = torch.where(bad[..., None], 0.0, G)
        if fedbuff_Z > 0:
            Gm = torch.where(m[..., None], G, 0.0).to(torch.float32)
            if lane_group is not None:
                Gm, s, scm, k, m, *r = gather(Gm, s, scm, k, m, rej)
                rej = r[0] if r else None
            D, acc = _fedbuff_block_deltas(Gm, scm, k, m, acc, fedbuff_Z)
            snaps, w = apply_block(snaps, w, D, s)
        elif lane_group is None:
            snaps, w = apply_block(snaps, w, scm[..., None] * G.to(torch.float32), s)
        else:
            # gen_async, sharded: local lane prefix + one collective, then the
            # global iterates W_i = w - (S_all + exclusive rank offset), replicated
            S = torch.cumsum(scm[..., None] * G.to(torch.float32), dim=-2)
            S_all, s_all, *r = gather(S, s, rej)  # (..., E, P), (..., E)
            rej = r[0] if r else None
            S_all = S_all.view(*lead, -1, El, P)  # (..., D, E/D, P)
            totals = S_all[..., -1, :]
            off = torch.cumsum(totals, dim=-2) - totals
            W = w.float()[..., None, None, :] - (S_all + off[..., None, :])
            snaps, w = scatter_rows(snaps, w, W.view(*lead, -1, P), s_all)
        if rej is not None:
            gcnt[..., 0] += torch.sum(rej, dim=-1).to(torch.int32)
        return w, snaps, acc, gcnt

    return block_step


def _init_update_carry(w0, rows, pack, unpack, flat_mode, enc, fedbuff_Z=0, cells=None):
    """``(w, snaps, acc, gcnt)`` initial carry + the carry->pytree decoder.

    ``rows`` is the ring height: C+1 for the blocked engine, whose trash
    row C absorbs padded lanes and slot-C events; for the per-event engine
    C, plus that trash row only when the stream has slot-C events (a fault
    or scenario stream's flip and stage events, `_ring_rows`).  ``acc`` is the FedBuff buffer, zeros
    like ``w`` (flat or tree), or None.  ``gcnt`` is the (2,) int32
    ``[guard_rejects, stale_drops]`` counter, carried whether or not a
    guard is on.
    ``cells=B`` starts B cells from the one w0: every part gains a leading
    axis of B (the ring (B, rows, P), the counter (B, 2)) and the decoder
    maps (B, P) packed weights to a tree of (B, ...) leaves.
    """
    flat0 = pack(w0)
    lead = () if cells is None else (cells,)
    snaps0 = enc(flat0).expand(*lead, rows, -1).clone()
    w_init = flat0 if flat_mode else w0
    if cells is not None:
        w_init = tree_map(lambda x: x.expand(cells, *x.shape).clone(), w_init)
    acc0 = tree_map(torch.zeros_like, w_init) if fedbuff_Z > 0 else None
    gcnt0 = torch.zeros(*lead, 2, dtype=torch.int32, device=flat0.device)
    if not flat_mode:
        to_tree = lambda w: w  # noqa: E731
    else:
        to_tree = unpack if cells is None else torch.func.vmap(unpack)
    return (w_init, snaps0, acc0, gcnt0), to_tree


def _ring_rows(C: int, slot) -> int:
    """The per-event ring's height: C, plus the trash row C when the stream
    sends an event there (one host sync a run).  A clean stream keeps C
    rows: at full width a ring row is the whole parameter vector."""
    return C + int(bool((slot == C).any()))


def _stack_evals(evals: list, device, cells=None) -> torch.Tensor:
    """The eval curve, (n_evals,), or (B, n_evals) with ``cells=B`` (each
    eval point then a (B,) tensor)."""
    lead = () if cells is None else (cells,)
    return torch.stack(evals, dim=len(lead)) if evals else torch.zeros((*lead, 0), device=device)


# ------------------------------------------------------------------ #
# host stream: replay a pre-simulated EventStream
# ------------------------------------------------------------------ #
def _make_host_runner(
    grad_fn: Callable[[Any, Pytree, Any], Pytree],
    C: int,
    *,
    fedbuff_Z: int = 0,
    eval_fn: Callable[[Pytree], Any] | None = None,
    eval_every: int = 0,
    update_fn: Callable[[Pytree, Pytree, Any], Pytree] | None = None,
    snapshot_dtype=None,
    vmap_streams: bool = False,
    guard: GuardConfig | None = None,
):
    """Build the per-event replay engine.

    Returns ``run(w0, J, slot, scale, eval_every=..., ckpt=None) ->
    (w_final, evals)`` over (T,) device tensors (J, slot int64; scale
    float32) — with ``guard``, ``(w_final, evals, gcnt)``, the (2,)
    ``[guard_rejects, stale_drops]`` counter (the host stream drops stale
    updates in the scales before the call, so only the first slot counts
    here).  ``evals`` is the eval_fn curve sampled every `eval_every` steps
    (an empty tensor when evaluation is off); events past the last eval
    point still replay.  ``ckpt`` (`engine_ckpt._Checkpoints`) gives the
    carry, curve and event to start from and saves the carry after the
    events it names and after the last.

    grad_fn(j, w, k): stochastic gradient of client j at params w, server
    step k (0-d device tensors).  update_fn(w, g, scale) defaults to
    w - scale*g.  ``fedbuff_Z > 0`` replays FedBuff.  ``vmap_streams=True``
    replays B streams in lockstep (`_make_host_cells_runner`).
    """
    if vmap_streams:
        return _make_host_cells_runner(grad_fn, C, fedbuff_Z=fedbuff_Z, eval_fn=eval_fn,
                                       eval_every=eval_every, update_fn=update_fn,
                                       snapshot_dtype=snapshot_dtype, guard=guard)
    eval_every_default = eval_every

    def run(w0, J, slot, scale, eval_every=eval_every_default, ckpt=None):
        pack, unpack, enc = _snapshot_codec(w0, snapshot_dtype)
        flat_mode = update_fn is None  # the default update is one flat axpy
        update_step = _make_update_step(grad_fn, update_fn, pack, unpack, flat_mode, enc,
                                        fedbuff_Z, guard)
        carry, to_tree = _init_update_carry(w0, _ring_rows(C, slot), pack, unpack, flat_mode,
                                            enc, fedbuff_Z)
        T = int(J.shape[0])
        ks = torch.arange(T, dtype=torch.int64, device=J.device)
        every = eval_every if (eval_fn is not None and eval_every and T >= eval_every) else 0
        evals, k0 = [], 0
        if ckpt is not None:
            carry, evals, k0 = ckpt.start(carry)
        for k in range(k0, T):
            carry = update_step(carry, J[k], slot[k], scale[k], ks[k])
            if every and (k + 1) % every == 0:
                evals.append(eval_fn(to_tree(carry[0])))
            if ckpt is not None:
                ckpt.after(k + 1, carry, evals)
        if ckpt is not None:
            ckpt.end(carry, evals)
        out = to_tree(carry[0]), _stack_evals(evals, J.device)
        return out + (carry[3],) if guard is not None else out

    return run


# ------------------------------------------------------------------ #
# the cell axis: B streams replayed in lockstep (run_matrix)
# ------------------------------------------------------------------ #
def _cells_eval_fn(eval_fn, unpack, flat_mode: bool):
    """``eval_fn`` vmapped over the cells' weights ((B, P) packed rows in
    flat mode, else a tree of (B, ...) leaves), as the reference vmaps it."""
    if eval_fn is None:
        return None
    return torch.func.vmap(lambda v: eval_fn(unpack(v)) if flat_mode else eval_fn(v))


def _make_host_cells_runner(grad_fn, C: int, *, fedbuff_Z: int = 0, eval_fn=None,
                            eval_every: int = 0, update_fn=None, snapshot_dtype=None,
                            guard: GuardConfig | None = None):
    """The per-event engine over B streams in lockstep, with an explicit
    cell axis: the ring is (B, C, P) (each cell's trash row C added when a
    stream sends an event there, `_ring_rows`), the weights (B, P) in flat
    mode (else a tree of (B, ...) leaves).

    ``run(w0, J, slot, scale, eval_every=...) -> (w_final, evals)`` over
    (B, T) device tensors; ``w_final`` has a leading B axis on every leaf and
    ``evals`` is (B, n_evals); with ``guard`` a third output, the (B, 2)
    ``[guard_rejects, stale_drops]`` counters, one row a cell (the
    reference's vmapped runner's shape).  Each event makes, for all cells at
    once, one gather of the B snapshot rows, one gradient call
    (`torch.func.vmap` of ``grad_fn`` over (j, w, k)), one update (a (B,)
    scale broadcast down P; ``update_fn`` takes the (B, ...) leaves and the
    (B,) scale, e.g. `kernels.ops.tree_weighted_update`, K1 across cells)
    and one scatter of the B new rows; FedBuff keeps one buffer a cell
    (`_make_cells_event_step`).  An eval point runs ``eval_fn`` once,
    vmapped over the cells.  The ring is written in place, so the loop
    itself is not vmapped.
    """
    eval_every_default = eval_every

    def run(w0, J, slot, scale, eval_every=eval_every_default):
        pack, unpack, enc = _snapshot_codec(w0, snapshot_dtype)
        _require_flat_codec(unpack)
        flat_mode = update_fn is None
        B, T = (int(d) for d in J.shape)
        dev = J.device
        R = _ring_rows(C, slot)
        (w, snaps, acc, gcnt), to_tree = _init_update_carry(w0, R, pack, unpack, flat_mode, enc,
                                                            fedbuff_Z, cells=B)
        ring = snaps.view(B * R, -1)
        step = _make_cells_event_step(grad_fn, update_fn, pack, unpack, enc, flat_mode,
                                      fedbuff_Z, guard)
        base = torch.arange(B, dtype=torch.int64, device=dev) * R
        # event-major copies: row k of each is one contiguous (B,) column
        Jt, rows_t = J.t().contiguous(), (slot.t() + base).contiguous()
        sct = scale.t().contiguous()
        ks = torch.arange(T, dtype=torch.int64, device=dev)[:, None].expand(T, B)
        every = eval_every if (eval_fn is not None and eval_every and T >= eval_every) else 0
        evaluate = _cells_eval_fn(eval_fn, unpack, flat_mode)
        evals, carry = [], (w, acc, gcnt)
        for k in range(T):
            carry = step(carry, ring, Jt[k], rows_t[k], sct[k], ks[k])
            if every and (k + 1) % every == 0:
                evals.append(evaluate(carry[0]))
        out = to_tree(carry[0]), _stack_evals(evals, dev, cells=B)
        return out + (carry[2],) if guard is not None else out

    return run


def _require_flat_codec(unpack) -> None:
    if unpack is None:
        raise ValueError("the torch engine needs all-float parameters (flat-packed "
                         "snapshot storage)")


def _make_cells_event_step(grad_fn, update_fn, pack, unpack, enc, flat_mode: bool,
                           fedbuff_Z: int = 0, guard: GuardConfig | None = None):
    """One event of B cells in lockstep: ``step((w, acc, gcnt), ring, j, rows,
    scale, k[, stale]) -> (w, acc, gcnt)`` over the (B*R, P) ring view, the
    (B,) columns of clients, ring rows (slot + cell offset), scales and
    server steps.  One gather of the B snapshot rows, one `torch.func.vmap`
    gradient call, one update and one scatter of the B new rows (the ring in
    place).  Each cell runs `_make_update_step`'s algorithm: FedBuff with
    its own (B, ...) buffer row, flushed at the same server steps; the guard
    (flat mode) with its own row of the (B, 2) counter, ``stale`` the (B,)
    steps its task spent in flight."""
    if guard is not None and not flat_mode:
        raise ValueError(
            "the divergence guard requires the flat-packed snapshot codec "
            "(uniform-dtype parameters, default linear update)"
        )
    grads = torch.func.vmap(lambda j, wi, k: grad_fn(j, unpack(wi), k))
    pack_cells = torch.func.vmap(pack)
    max_sq = float(guard.max_grad_norm) ** 2 if guard is not None else 0.0
    cutoff = int(guard.stale_cutoff) if guard is not None else 0

    def step(carry, ring, j, rows, sc, k, stale=None):
        w, acc, gcnt = carry
        g = grads(j, ring.index_select(0, rows), k)
        if flat_mode:
            g = pack_cells(g)
        bad = None
        if guard is not None:
            live = sc != 0
            if cutoff > 0 and stale is not None:
                st = live & (stale > cutoff)
                gcnt[:, 1] += st.to(torch.int32)
                sc = torch.where(st, 0.0, sc)
                live = live & ~st
            bad = _guard_bad(g, max_sq)
            gcnt[:, 0] += (bad & live).to(torch.int32)
        if fedbuff_Z > 0:
            fire = ((k + 1) % fedbuff_Z) == 0
            eff = torch.where(fire, sc / fedbuff_Z, 0.0)
            keep = lambda a: a * (~fire).to(a.dtype).view(-1, *([1] * (a.ndim - 1)))  # noqa: E731
            if flat_mode:
                if bad is not None:  # the buffer consumes g beyond this event
                    g = torch.where(bad[:, None], 0.0, g)
                acc = acc + g
                w = _flat_axpy(w, acc, eff[:, None])
                acc = keep(acc)
            else:
                acc = tree_map(lambda a, y: a + y, acc, g)
                w = update_fn(w, acc, eff)
                acc = tree_map(keep, acc)
        elif flat_mode:
            w_new = _flat_axpy(w, g, sc[:, None])
            w = torch.where(bad[:, None], w, w_new) if bad is not None else w_new
        else:
            w = update_fn(w, g, sc)
        ring.index_copy_(0, rows, enc(w) if flat_mode else enc(pack_cells(w)))
        return w, acc, gcnt

    return step


def world_size() -> int:
    """The ranks a lane or scenario shard can use: the world size of the
    default `torch.distributed` process group, 1 without one (the port's
    counterpart of ``jax.device_count()``)."""
    import torch.distributed as dist

    return dist.get_world_size() if _world_group() is not None else 1


def _world_group():
    """The default process group, or None without one."""
    import torch.distributed as dist

    return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None


def _require_world(ranks: int, what: str, spare: bool = False):
    """The default process group, which must hold exactly ``ranks`` ranks
    (with ``spare``, at least ``ranks``: the ranks above take no part);
    never falls back to an unsharded run when it is missing."""
    import torch.distributed as dist

    start = (
        f"start {ranks} ranks (torchrun --nproc-per-node {ranks}, or "
        "torch.multiprocessing.spawn + init_process_group in each; "
        "repro_torch.launch.lanes.run_lanes does both) and make the same run in every rank"
    )
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"{what} needs a torch.distributed process group of {ranks} ranks, "
                         f"but none is initialised: {start}")
    world = dist.get_world_size()
    if world < ranks or (world > ranks and not spare):
        raise ValueError(f"{what} but the torch.distributed process group has world size "
                         f"{world}: {start}")
    return dist.group.WORLD


def _check_lane_blocks(lane_devices: int, block_size: int) -> None:
    if lane_devices < 1:
        raise ValueError("lane_devices >= 1 required")
    if lane_devices == 1:
        return
    if block_size < 2:
        raise ValueError(
            "lane_devices > 1 shards the E-lane micro-block gradient batch "
            "across ranks and requires block_size > 1"
        )
    if block_size % lane_devices:
        raise ValueError(
            f"block_size={block_size} must be a multiple of "
            f"lane_devices={lane_devices} (each rank owns E/D lanes)"
        )


def _check_lane_devices(lane_devices: int, block_size: int):
    """Validate the lane-shard request of one run against the block shape
    and the process group; return the lanes' ``(group, rank)``, or None at
    D = 1.

    ``lane_devices=D > 1`` runs the blocked replay as D ranks of the
    default `torch.distributed` process group (world size D), one lane
    shard each.  The scenario × lane layout of the cells takes a world of
    shard × lane instead (`_scenario_mesh`).
    """
    _check_lane_blocks(lane_devices, block_size)
    if lane_devices == 1:
        return None
    import torch.distributed as dist

    group = _require_world(lane_devices, f"lane_devices={lane_devices}")
    return group, dist.get_rank(group)


@dataclass(frozen=True)
class _Mesh:
    """This rank's place in a ``shard × lane`` group of ranks: rank r =
    s·L + l takes the cells of shard s and the lanes of lane l; its lanes
    are sharded over the ranks {s·L + l'} (``lane_group``) and its cells
    gathered over {s'·L + l} (``shard_group``).  In a world of more than
    S·L ranks (``spare``) the ranks from S·L up take no part (``shard`` is
    None there) and receive the results from rank 0 (`_from_rank0`)."""

    shard: int | None
    lane: int | None
    shard_group: Any
    lane_group: Any
    spare: bool = False


_MESHES: dict = {}


def _scenario_mesh(shard_devices: int, lane_devices: int, block_size: int) -> _Mesh:
    """The scenario × lane layout (`jit_fused_runner(vmap_scenarios=True,
    shard_devices=S, lane_devices=L)`) on ranks 0 … S·L−1 of a world of at
    least S·L ranks, as the reference's mesh takes its first S·L devices:
    its subgroups, made once per world with `dist.new_group` in the same
    order in every rank (each rank calls it for every group, as the call
    requires)."""
    import torch.distributed as dist

    _check_lane_blocks(lane_devices, block_size)
    S, L = int(shard_devices), int(lane_devices)
    world = _require_world(S * L, f"shard_devices={S} x lane_devices={L} "
                                  f"needs {S * L} ranks", spare=True)
    key = (world, S, L)
    if key not in _MESHES:
        lane_groups = ([dist.new_group([s * L + l for l in range(L)]) for s in range(S)]
                       if L > 1 else [None] * S)
        shard_groups = [dist.new_group([s * L + l for s in range(S)]) for l in range(L)]
        rank, spare = dist.get_rank(), dist.get_world_size() > S * L
        if rank >= S * L:
            _MESHES[key] = _Mesh(None, None, None, None, spare)
        else:
            s, l = divmod(rank, L)
            _MESHES[key] = _Mesh(s, l, shard_groups[l], lane_groups[s], spare)
    return _MESHES[key]


def _from_rank0(out, mesh: _Mesh, device):
    """``out`` (a rank's ``(w, evals, extras)``, None on a rank that took no
    part) as every rank returns it: with spare ranks, rank 0's results sent
    to the world in one `broadcast_object_list` (as CPU tensors, moved to
    ``device``), so every rank holds the same grid bitwise."""
    if not mesh.spare:
        return out
    import torch.distributed as dist

    box = [tree_map(lambda t: t.detach().cpu() if torch.is_tensor(t) else t, out)
           if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box)
    if mesh.shard is not None:
        return out
    return tree_map(lambda t: t.to(device) if torch.is_tensor(t) else t, box[0])


def _make_host_block_runner(
    grad_fn: Callable[[Any, Pytree, Any], Pytree],
    C: int,
    block_size: int,
    *,
    fedbuff_Z: int = 0,
    eval_fn: Callable[[Pytree], Any] | None = None,
    update_fn: Callable[[Pytree, Pytree, Any], Pytree] | None = None,
    kernel: str = "jnp",
    snapshot_dtype=None,
    lanes=None,
    vmap_streams: bool = False,
    guard: GuardConfig | None = None,
):
    """Build the blocked replay engine over `queue_sim.EventBlocks` arrays.

    Returns ``run(w0, J, slot, scale, k, mask, chunk_blocks=0, n_chunks=0,
    ckpt=None) -> (w_final, evals)`` over (B, E) device tensors (see
    `blocked_inputs`) — with ``guard``, ``(w_final, evals, gcnt)``
    (`_make_block_step`).  The first ``n_chunks * chunk_blocks`` rows are
    eval-interval groups (eval fires after each group); trailing rows
    replay without eval.  ``ckpt`` (`engine_ckpt._Checkpoints`, unsharded
    only) gives the carry, curve and row to start from and saves the carry
    after the rows it names and after the last.

    The blocked engine needs the flat-packed codec and the default linear
    update; ``kernel`` picks the plain path ("jnp") or the CUDA kernels
    ("pallas": K2, and K6 when lane-sharded), for which the packed vector
    is padded to a multiple of `kernels.weighted_update.BLOCK_TILE` once at
    init.

    ``lanes=(group, rank)`` (from `_check_lane_devices`) shards the E
    lanes of every block over the D ranks of ``group``: every rank calls
    ``run`` with the same full (B, E) arrays and w0, takes its contiguous
    E/D lanes, and returns the same replicated ``(w_final, evals[,
    gcnt])`` (see `_make_block_step`).  Sharded and unsharded replay agree
    to the re-association of the fp32 lane prefix (<= 1e-5 on the
    Quadratic).

    ``vmap_streams=True`` replays B cells in lockstep over (B, nb, E)
    arrays (`blocked_inputs_batch`) with a (B, C+1, P) ring, returning the
    final weights with a leading B axis, (B, n_evals) evals and, guarded,
    (B, 2) counters (`_make_block_step(cells=True)`); with ``lanes`` each
    rank takes its E/D lanes of every cell — the reference's cell × lane
    layout.
    """
    if update_fn is not None:
        raise ValueError(
            "block_size > 1 requires the default update w - scale*g "
            "(the blocked replay reconstructs iterates via a prefix sum)"
        )
    if block_size < 2:
        raise ValueError("use _make_host_runner for block_size <= 1")
    lane_group = None
    if lanes is not None:
        lane_group, rank = lanes
        El = block_size // lane_group.size()
        lo = rank * El
    pad_to = 1
    if kernel == "pallas":
        from ..kernels.weighted_update import BLOCK_TILE

        pad_to = BLOCK_TILE

    def run(w0, J, slot, scale, k, mask, chunk_blocks=0, n_chunks=0, ckpt=None):
        pack, unpack, enc = _snapshot_codec(w0, snapshot_dtype, pad_to=pad_to)
        if unpack is None:
            raise ValueError(
                "block_size > 1 requires all-float parameters "
                "(flat-packed snapshot storage)"
            )
        if ckpt is not None and (vmap_streams or lane_group is not None):
            raise ValueError("checkpointing replays one unsharded stream")
        arrs = (J, slot, scale, k, mask)
        if lane_group is not None:  # this rank's contiguous E/D lanes (of every cell)
            arrs = tuple(a[..., lo : lo + El] for a in arrs)
        cells = int(J.shape[0]) if vmap_streams else None
        if vmap_streams:  # block-major: row b of each is one contiguous (B, E) block
            arrs = tuple(a.transpose(0, 1) for a in arrs)
        J, slot, scale, k, mask = (a.contiguous() for a in arrs)
        block_step = _make_block_step(grad_fn, pack, unpack, kernel, fedbuff_Z, lane_group,
                                      guard, cells=vmap_streams)
        carry, to_tree = _init_update_carry(w0, C + 1, pack, unpack, True, enc, fedbuff_Z,
                                            cells=cells)
        if vmap_streams:
            evaluate = _cells_eval_fn(eval_fn, unpack, True)
        else:
            evaluate = lambda w: eval_fn(to_tree(w))  # noqa: E731
        nb = int(J.shape[0])
        every = chunk_blocks if (eval_fn is not None and n_chunks and chunk_blocks) else 0
        Bm = n_chunks * chunk_blocks
        evals, b0 = [], 0
        if ckpt is not None:
            carry, evals, b0 = ckpt.start(carry)
        for b in range(b0, nb):
            carry = block_step(carry, J[b], slot[b], scale[b], k[b], mask[b])
            if every and b < Bm and (b + 1) % every == 0:
                evals.append(evaluate(carry[0]))
            if ckpt is not None:
                ckpt.after(b + 1, carry, evals)
        if ckpt is not None:
            ckpt.end(carry, evals)
        out = to_tree(carry[0]), _stack_evals(evals, J.device, cells=cells)
        return out + (carry[3],) if guard is not None else out

    return run


# ------------------------------------------------------------------ #
# device stream: the fused runner (the closed network and Algorithm 1)
# ------------------------------------------------------------------ #
def _check_fused_options(*, faulty: bool, scen_on: bool, guard, fedbuff_Z: int, E: int,
                         serving, classes, n: int = 0, lane_devices: int = 1,
                         update_fn=None) -> None:
    """The reference's `ValueError`s for fused options that do not compose
    (`repro.core.engine_scan.make_fused_runner`), with its messages and in
    its order."""
    if scen_on:
        if faulty:
            raise ValueError("scenario= and fault= are separate injection paths; model "
                             "suspension via ScenarioConfig modulation (rate_scale)")
        if classes is not None:
            raise ValueError("the fused engine's scenario path is dense-only; use "
                             "sparse_stats_stream_fn(scenario=True) for class-level laws")
        if E > 1:
            raise ValueError("scenario= requires block_size=1")
        if fedbuff_Z:
            raise ValueError("scenario= composes with Algorithm 1, not FedBuff")
        if serving is not None and serving.enabled:
            raise ValueError("scenario= does not compose with serving=")
    if classes is not None:
        if E > 1:
            raise ValueError("classes= (sparse stream) requires block_size=1")
        if lane_devices > 1:
            raise ValueError("classes= (sparse stream) requires lane_devices=1")
        if classes.n != n:
            raise ValueError(f"ClassSpec covers n={classes.n} clients, runner built for n={n}")
    if faulty and fedbuff_Z:
        raise ValueError("fault injection composes with Algorithm 1, not FedBuff "
                         "(a crash/timeout at a flush step has no masking semantics)")
    if guard is not None and int(guard.stale_cutoff) > 0 and fedbuff_Z:
        raise ValueError("the staleness cutoff requires the per-event update (fedbuff_Z=0)")
    if serving is not None and serving.enabled:
        serving.validate()
        if E > 1:
            raise ValueError("serving= requires block_size=1")
        if fedbuff_Z:
            raise ValueError("serving= composes with Algorithm 1, not FedBuff")
        if classes is not None:
            raise ValueError("serving= requires the dense stream (classes=None)")
        if lane_devices > 1:
            raise ValueError("serving= requires lane_devices=1")
        if update_fn is not None:
            raise ValueError("serving= requires the default update w - scale*g")


def _fused_lanes(lane_devices: int, lane_axis, E: int):
    """The fused runner's lanes: ``(group, rank)`` or None.  ``lane_axis``
    names an existing group of ``lane_devices`` ranks (the reference's
    ``lane_axis`` inside its scenario × lane mesh); else the lanes take the
    whole world (`_check_lane_devices`)."""
    if lane_axis is None:
        return _check_lane_devices(lane_devices, E)
    if lane_devices <= 1:
        raise ValueError("lane_axis requires lane_devices > 1")
    if E < 2 or E % lane_devices:
        raise ValueError(f"block_size={E} must be a >1 multiple of lane_devices={lane_devices}")
    import torch.distributed as dist

    if dist.get_world_size(lane_axis) != lane_devices:
        raise ValueError(f"lane_axis holds {dist.get_world_size(lane_axis)} ranks, "
                         f"lane_devices={lane_devices}")
    return lane_axis, dist.get_rank(lane_axis)


def _fused_chunking(T: int, eval_on: bool, eval_every: int, adaptive: bool,
                    refresh_every: int) -> tuple[int, int, int]:
    """``(L, n_chunks, eval_stride)``: the chunk length (refresh and eval
    both happen at chunk ends), the number of whole chunks, and the eval
    cadence in chunks (0 without eval); events past ``n_chunks * L`` run as
    a tail with no refresh and no eval, as in the reference."""
    if adaptive:
        L = min(refresh_every, T)
    elif eval_on:
        L = min(eval_every, T)
    else:
        L = T
    return L, T // L, (max(eval_every // L, 1) if eval_on else 0)


def make_fused_runner(
    grad_fn: Callable[[Any, Pytree, Any], Pytree],
    n: int,
    C: int,
    T: int,
    *,
    weighting: str = "importance",
    fedbuff_Z: int = 0,
    eval_fn: Callable[[Pytree], Any] | None = None,
    eval_every: int = 0,
    adaptive: bool = False,
    refresh_every: int = 0,
    bound=None,
    ctrl_lr: float = 0.3,
    ctrl_iters: int = 4,
    update_fn: Callable[[Pytree, Pytree, Any], Pytree] | None = None,
    init: str = "distinct",
    block_size: int = 1,
    collect_extras: bool = True,
    snapshot_dtype=None,
    lane_devices: int = 1,
    lane_axis: str | None = None,
    fault=None,
    guard: GuardConfig | None = None,
    classes=None,
    serving=None,
    scenario=None,
    vmap_scenarios: bool = False,
):
    """Build the fused engine: the device stream (`stream_device`) feeding
    the replay's own steps.  ``run(w0, mu, p0, key, eta) -> (w_final,
    evals, extras)``; ``key`` is a seed or a `torch.Generator` on the
    run's device (with ``vmap_scenarios``, a sequence of B of them).

    Inside a chunk the stream never reads the weights: the dispatch targets
    K of a chunk are drawn at its start from the current p, and p changes
    only at chunk ends.  So each chunk (1) advances the closed network L
    events on the device, emitting (J, slot, scale, t) tensors, (2) replays
    them with the host runners' steps (`_make_update_step`, or
    `_make_block_step` over the chunk cut into conflict-free blocks by
    `queue_sim.segment_blocks`: one host copy of the chunk's slots), and
    (3) refreshes p (``adaptive``, `stream_device.ctrl_refresh`) and
    evaluates.  The carry runs across chunks; per event this is the
    reference's fused computation, operation for operation.  The blocked
    layout differs from the reference's E-event windows only in how the
    fp32 update sums associate.

    Each in-flight task keeps the importance scale of its dispatch-time p,
    so the weighted update stays unbiased under the time-varying policy.
    ``extras`` carries the per-step event times, the final and per-chunk
    sampling vectors and the on-device occupancy, busy-time, delay and
    completion statistics (``collect_extras=False``: ``p_final`` only).
    ``vmap_scenarios=True`` runs B cells in lockstep along an explicit cell
    axis: (B, n) ``mu`` / ``p0``, one stream state with a leading B, one
    gather, one vmapped gradient call, one update and one scatter per event
    (or block) for all cells.

    ``fault`` (a `FaultConfig`) races the fault clocks in the stream
    (`stream_device.fault_stream_step`): a crash, timeout or flip event
    carries scale 0, so its work is discarded and its slot re-dispatched
    with the current weights; a flip carries the trash slot C, which the
    ring's row C and the slot scales' entry C absorb.  ``scenario`` (a
    `ScenarioConfig`, per event only, exclusive with ``fault`` and FedBuff)
    swaps in `stream_device.scenario_stream_step` the same way; a disabled
    scenario runs the plain stream, bitwise.  ``guard`` (`GuardConfig`)
    checks each event's gradient (`_make_flat_guard`; per event the
    staleness is the stream's own ``k - slot_step[slot]``, blocked it zeroes
    the chunk's scales before the cut).  ``extras`` then gains
    ``guard_rejects`` / ``stale_drops``, and with a fault or scenario the
    kind counts ``kind_count`` and the availability integral
    ``avail_time``.  ``classes`` (a `ClassSpec` of the n clients, from
    `build_class_spec`) runs the sparse O(C) stream
    (`stream_device.sparse_stream_step`, per event only): ``mu`` / ``p0``
    are then the (m,) class-level values, each chunk's K comes from
    `stream_device.sample_dispatch_classes` at the chunk's p, the
    importance scale of a dispatch to K is ``eta / (n p[class of K])``, the
    statistics extras are per class, ``extras["class_counts"]`` holds the
    class sizes and the adaptive refresh runs on the class simplex
    (`stream_device.ctrl_refresh(counts=)`).  The events still carry global
    client ids and slots, so the replay, K1, the guard and FedBuff are the
    dense stream's.  ``serving`` (a `serving.ServingConfig`; per event, the
    dense stream, no FedBuff, the default update) merges an open Poisson
    inference stream into the race (`stream_device.merged_stream_step`): a
    serve event carries client n, slot C and scale 0, so its gradient is
    discarded and the trash row and entry C take its writes; the request
    table advances with the stream, a chunk ahead of the replay (its law
    does not depend on training), while the known-good pointer, the read
    of its ring row and the staleness run in event order in the replay,
    after each event's update (`serving.ServeLoop`).  ``extras`` then gains
    the reference's ``serve_*`` counters, histograms and final serve state.
    The options that do not compose raise the reference's `ValueError`s.

    ``lane_devices=D > 1`` (``block_size`` a >1 multiple of D) runs in
    every rank of a process group of D ranks: each rank generates every
    chunk's stream itself (the same draws everywhere, as every reference
    device does), cuts it into the same conflict-free blocks, and
    differentiates its contiguous E/D lanes of each block; one all-gather a
    block recombines them (`_make_block_step`), so every rank returns the
    same result.  ``lane_axis`` — a `torch.distributed` process group, the
    port's counterpart of the reference's mesh axis name — shards over that
    group instead of the whole world (the scenario × lane layout of
    `jit_fused_runner`).  With ``vmap_scenarios`` FedBuff keeps one buffer
    and the guard one counter a cell (``guard_rejects`` / ``stale_drops``
    then (B,)).

    ``run.from_draws(w0, mu, p0, eta, nodes, u_race, u_exp, u_disp[, u_ph,
    u_phase0], u_mem=, u_bit=)`` takes given draws (the scenario stream's
    dispatch-phase and initial-phase uniforms last; the sparse stream's
    member uniforms ``u_mem`` and, under faults, availability-bit uniforms
    ``u_bit`` by keyword), so parity tests pass the reference's.
    """
    from . import stream_device as sd
    from .theory import BoundConstants

    if weighting not in ("importance", "plain"):
        raise ValueError(weighting)
    if adaptive:
        if fedbuff_Z:
            raise ValueError("adaptive sampling applies to Algorithm 1, not FedBuff")
        if refresh_every <= 0:
            raise ValueError("adaptive=True requires refresh_every > 0")
        if eval_fn is not None and eval_every and eval_every % refresh_every:
            raise ValueError("eval_every must be a multiple of refresh_every")
    if block_size > 1 and update_fn is not None:
        raise ValueError("block_size > 1 requires the default update w - scale*g")
    E = max(int(block_size), 1)
    faulty, scen_on = sd._enabled(fault), sd._enabled(scenario)
    _check_fused_options(faulty=faulty, scen_on=scen_on, guard=guard, fedbuff_Z=fedbuff_Z, E=E,
                         serving=serving, classes=classes, n=n, lane_devices=lane_devices,
                         update_fn=update_fn)
    lanes = _fused_lanes(lane_devices, lane_axis, E)
    sparse = classes is not None
    counts = tuple(int(c) for c in np.asarray(classes.counts)) if sparse else None
    bound = bound if bound is not None else BoundConstants(C=C, T=T)
    importance = weighting == "importance"
    serving_on = serving is not None and serving.enabled
    # flip, stage and serve events carry the trash slot C
    tagged = faulty or scen_on or serving_on
    guard_stale = guard is not None and int(guard.stale_cutoff) > 0
    # the staleness cutoff reads the stream's slot_step, so stats must run
    need_stats = collect_extras or adaptive or guard_stale
    eval_on = eval_fn is not None and eval_every > 0
    L, n_chunks, eval_stride = _fused_chunking(T, eval_on, eval_every, adaptive, refresh_every)
    flat_mode = update_fn is None

    def run_draws(w0, mu, p0, eta, nodes, u_race, u_exp, u_disp, u_ph=None, u_phase0=None, *,
                  u_mem=None, u_bit=None):
        """The run on given draws: ``nodes`` (C,), ``u_race`` / ``u_exp`` /
        ``u_disp`` (T,) (a leading B with ``vmap_scenarios``), for a
        scenario ``u_ph`` (T,) and ``u_phase0`` (C,), and for the sparse
        stream ``u_mem`` (T,) and under faults ``u_bit`` (T,): the port's
        generator's (`run`) or the reference's (parity tests)."""
        dev = u_race.device
        lead = u_race.shape[:-1]
        B = lead[0] if vmap_scenarios else 1
        as2 = lambda a, dt: torch.as_tensor(a).to(device=dev, dtype=dt).reshape(B, -1)  # noqa: E731
        mu, p = as2(mu, torch.float32), as2(p0, torch.float32)
        nodes = as2(nodes, torch.int64)
        u_race, u_disp = as2(u_race, torch.float32), as2(u_disp, torch.float32)
        e_hold = -torch.log1p(-as2(u_exp, torch.float32))
        eta_t = torch.full((), float(eta), dtype=torch.float32, device=dev)
        if sparse:
            spec = sd._spec_on(classes, dev)
            fr, sr = sd._resolve_class_modes(fault, None, classes, dev)
            u_mem = as2(u_mem, torch.float32)
            u_bit = as2(u_bit, torch.float32) if faulty else None
        else:
            spec = None
            fr, sr = sd._resolve_modes(fault, scenario, n, dev)
        width = spec.m if sparse else n  # of the stream's mu, p and statistics
        pack, unpack, enc = _snapshot_codec(w0, snapshot_dtype)
        if serving_on and unpack is None:
            raise ValueError("serving= requires all-float parameters (the serving read path "
                             "gathers flat-packed snapshot rows)")
        _require_flat_codec(unpack)
        # flip, stage and serve events carry slot C: the ring's trash row takes them
        rows = C + 1 if (E > 1 or tagged) else C
        replay = (_FusedCellsReplay if vmap_scenarios else _FusedReplay)(
            grad_fn, w0, rows, pack, unpack, enc, flat_mode, update_fn, fedbuff_Z, E, n, C, B,
            dev, guard, lanes=lanes)

        if sparse:
            sstate, _ = sd.sparse_stream_init(nodes, spec, C, fault=faulty)
        elif sr is not None:
            u_ph = as2(u_ph, torch.float32)
            sstate, _ = sd.scenario_stream_init(nodes, n, C, sr, as2(u_phase0, torch.float32))
        else:
            sstate, _ = sd.stream_init(nodes, n, C, fault=fr is not None)
        stats = (sd.stats_init(width, C, fault=fr is not None, scenario=sr is not None, cells=B,
                               device=dev) if need_stats else None)
        cls_of = spec.inv_cls if sparse else None
        slot_scale = (_slot_scales(eta_t, n, p, nodes, tagged, cls_of=cls_of) if importance
                      else None)
        cst = sd._Consts((B,), C, dev, n=None if sparse else n)
        serve = None
        if serving_on:
            from .serving import ServeLoop, serve_init, serve_stats_init

            serve = ServeLoop(serving, serve_init(serving, cells=B, device=dev),
                              serve_stats_init(cells=B, device=dev))
        evals, p_traj, ts = [], [], []
        for c in range(n_chunks + (T > n_chunks * L)):
            a, b = c * L, min((c + 1) * L, T)
            if sparse:
                K = sd.sample_dispatch_classes(p, spec, u_disp[:, a:b], u_mem[:, a:b])
            else:
                K = sd.tree_sample(sd.tree_build(p), u_disp[:, a:b])
            sstate, stats, slot_scale, t = _advance_chunk(
                replay, sstate, stats, slot_scale if importance else None, p, mu,
                e_hold[:, a:b], u_race[:, a:b], K, a, cst, eta_t=eta_t, n=n,
                need_stats=need_stats, fr=fr, sr=sr,
                u_ph=None if sr is None else u_ph[:, a:b], guard_stale=guard_stale, spec=spec,
                u_bit=None if u_bit is None else u_bit[:, a:b], serve=serve)
            if collect_extras:
                ts.append(t)
            if c < n_chunks:
                if adaptive:
                    p = sd.ctrl_refresh(p, stats.comp, stats.busy_t, bound, lr=ctrl_lr,
                                        iters=ctrl_iters, counts=counts)
                if eval_on and (c + 1) % eval_stride == 0:
                    evals.append(replay.evaluate(eval_fn))
                if collect_extras:
                    p_traj.append(p)
        w = replay.weights()
        evals = _stack_evals(evals, dev, cells=B if vmap_scenarios else None)
        one = (lambda x: x) if vmap_scenarios else (lambda x: x[0])  # noqa: E731
        extras = {"p_final": one(p)}
        if guard is not None:
            extras["guard_rejects"], extras["stale_drops"] = replay.gcnt()
        if serve is not None:
            extras.update({k: one(v) for k, v in serve.extras(sstate.t).items()})
        if collect_extras:
            t_all = torch.cat(ts, dim=-1)
            extras.update(
                t=one(t_all),
                p_traj=one(torch.stack(p_traj, dim=1)),
                occ_mean=one(stats.occ_sum.to(torch.float32) / T),
                occ_time_avg=one(stats.occ_tw / t_all[:, -1:]),
                busy_time=one(stats.busy_t),
                delay_sum=one(stats.delay_sum),
                comp=one(stats.comp),
            )
            if faulty or scen_on:
                extras.update(kind_count=one(stats.kind_count), avail_time=one(stats.avail_tw))
            if sparse:  # the statistics are per class: consumers expand by the sizes
                extras["class_counts"] = sd._table(classes.counts, torch.int32, dev)
        return w, evals, extras

    def run(w0, mu, p0, key, eta):
        dev = tree_leaves(w0)[0].device
        keys = list(key) if vmap_scenarios else [key]
        ps = torch.as_tensor(np.asarray(p0) if not isinstance(p0, torch.Tensor) else p0)
        ps = ps.to(device=dev, dtype=torch.float32).reshape(len(keys), -1)
        if sparse:
            draws = [sd.draw_sparse_uniforms(k, classes, C, T, ps[i], init, dev, fault=faulty)
                     for i, k in enumerate(keys)]
        else:
            draws = [sd.draw_uniforms(k, n, C, T, ps[i], init, dev, scenario=scen_on)
                     for i, k in enumerate(keys)]
        stacked = [torch.stack(d) for d in zip(*draws)]
        if not vmap_scenarios:
            stacked = [d[0] for d in stacked]
        if sparse:
            nodes, ur, ue, ud, um, *ub = stacked
            return run_draws(w0, mu, p0, eta, nodes, ur, ue, ud, u_mem=um,
                             u_bit=ub[0] if ub else None)
        return run_draws(w0, mu, p0, eta, *stacked)

    run.from_draws = run_draws
    return run


def _slot_scales(eta_t, n: int, p, nodes, tagged: bool, cls_of=None):
    """The (B, C) dispatch-time importance scales of the initial tasks; on
    a fault or scenario stream with an entry C for the trash slot (read
    only by flip and stage events, whose scale is masked to 0).  On the
    sparse stream ``p`` is per class and ``cls_of`` maps a client to its
    class (`ClassSpec.inv_cls`)."""
    scale = eta_t / (n * p.gather(-1, nodes if cls_of is None else torch.take(cls_of, nodes)))
    return torch.cat([scale, scale.new_zeros(scale.shape[0], 1)], dim=-1) if tagged else scale


def _advance_chunk(replay, sstate, stats, slot_scale, p, mu, e_hold, u_race, K, k0: int, cst, *,
                   eta_t, n: int, need_stats: bool, fr=None, sr=None, u_ph=None,
                   guard_stale: bool = False, spec=None, u_bit=None, serve=None):
    """One chunk of fused events, shared by the fused runner and the
    checkpointed driver (`engine_ckpt.run_checkpointed`): the stream
    advanced over the chunk's (B, L) draws (`stream_device._advance`; the
    sparse stream with ``spec``), each event's scale (the completing task's
    dispatch-time importance scale from ``slot_scale``, or plain ``eta_t``
    when ``slot_scale`` is None; 0 for a crash, timeout, flip, stage or
    serve event), then ``replay``'s steps over the chunk.  ``serve`` (a
    `serving.ServeLoop`) merges the serving plane: its table runs with the
    stream, its read path in the replay; a serve event's client n is
    clamped to n - 1 for the gradient call the replay discards, as the
    reference's gather clamps it.  Returns ``(sstate, stats, slot_scale,
    t)``."""
    from . import stream_device as sd

    scales = []
    on_event = None
    if slot_scale is not None:
        psc = eta_t / (n * p.gather(-1, K if spec is None else torch.take(spec.inv_cls, K)))
        box = [slot_scale]

        def on_event(i, ev):
            # the completing task's dispatch-time scale; the freed slot
            # takes the new dispatch's
            scales.append(sd._take(box[0], ev.slot))
            box[0] = box[0].scatter(-1, ev.slot[:, None], psc[:, i : i + 1])

    sstate, stats, (J, t, slot, delay, kind) = sd._advance(
        sstate, stats, mu, e_hold, u_race, K, k0, cst, need_stats, on_event, fr=fr, sr=sr,
        u_ph=u_ph, spec=spec, u_bit=u_bit, serve=serve)
    if slot_scale is not None:
        slot_scale = box[0]
        scale = torch.stack(scales, dim=-1)
    else:
        scale = eta_t.expand(*K.shape)
    if kind is not None:  # crash, timeout, flip, stage and serve events apply nothing
        scale = torch.where(kind == KIND_COMPLETE, scale, 0.0)
    if serve is not None:
        J = torch.clamp_max(J, n - 1)
    replay.events(J, slot, scale, k0, delay if guard_stale else None,
                  serve=None if serve is None else (serve, serve.chunk_served()))
    return sstate, stats, slot_scale, t


def _lane_cols(lanes, E: int):
    """This rank's contiguous lanes of a block, as a slice (all of them
    without lanes)."""
    if lanes is None:
        return slice(None)
    group, rank = lanes
    El = E // group.size()
    return slice(rank * El, (rank + 1) * El)


class _FusedReplay:
    """The replay half of one fused run: the host runners' carry and steps,
    fed a chunk of device-generated events at a time; with ``lanes``, this
    rank's lanes of each block (`_make_block_step`)."""

    def __init__(self, grad_fn, w0, rows, pack, unpack, enc, flat_mode, update_fn, fedbuff_Z,
                 E, n, C, B, dev, guard=None, lanes=None):
        self.E, self.n, self.C, self.dev = E, n, C, dev
        self.guarded = guard is not None
        self.cutoff = int(guard.stale_cutoff) if guard is not None else 0
        self.cols = _lane_cols(lanes, E)
        if E > 1:
            self.step = _make_block_step(grad_fn, pack, unpack, "jnp", fedbuff_Z,
                                         None if lanes is None else lanes[0], guard)
        else:
            self.step = _make_update_step(grad_fn, update_fn, pack, unpack, flat_mode, enc,
                                          fedbuff_Z, guard)
        self.carry, self.to_tree = _init_update_carry(w0, rows, pack, unpack, flat_mode, enc,
                                                      fedbuff_Z)

    def events(self, J, slot, scale, k0: int, stale=None, serve=None):
        """One chunk's (1, L) events; ``stale`` (the stream's per-event
        delays) feeds the guard's staleness cutoff.  ``serve = (loop,
        served)`` runs the serving read path after each event's update
        (`serving.ServeLoop.read`): the pointer moves on an accepted update,
        one whose scale is nonzero and that left the guard's counters as
        they were."""
        J, slot, scale = J[0], slot[0], scale[0]
        Lc = int(J.shape[0])
        if self.E == 1:
            ks = torch.arange(k0, k0 + Lc, dtype=torch.int64, device=self.dev)
            if serve is not None:
                loop, served = serve
                row_mean = lambda r: _row_means(self.carry[1][None], r)  # noqa: E731
            for i in range(Lc):
                if serve is not None:
                    gcnt_pre = self.carry[3].clone() if self.guarded else None
                self.carry = self.step(self.carry, J[i], slot[i], scale[i], ks[i],
                                       None if stale is None else stale[0, i])
                if serve is not None:
                    accepted = scale[i] != 0
                    if gcnt_pre is not None:
                        accepted = accepted & (self.carry[3] == gcnt_pre).all()
                    loop.read(slot[i:i + 1], accepted[None], ks[i], row_mean, served[:, i])
            return
        if stale is not None and self.cutoff > 0:
            # the cutoff needs no gradient: drop stale updates before the cut
            st = (scale != 0) & (stale[0] > self.cutoff)
            self.carry[3][1] += torch.sum(st).to(torch.int32)
            scale = torch.where(st, 0.0, scale)
        blocks = _chunk_blocks(J[None], slot[None], scale[None], k0, self.E, self.n, self.C,
                               self.cols)
        for r in range(blocks[0].shape[1]):
            self.carry = self.step(self.carry, *(a[0, r] for a in blocks))

    def evaluate(self, eval_fn):
        return eval_fn(self.to_tree(self.carry[0]))

    def weights(self):
        return self.to_tree(self.carry[0])

    def gcnt(self):
        """``(guard_rejects, stale_drops)``, 0-d device tensors."""
        return self.carry[3][0], self.carry[3][1]


class _FusedCellsReplay:
    """The replay half of B fused runs in lockstep (`vmap_scenarios`): the
    cell-axis steps of the host matrix (`_make_cells_event_step`,
    `_make_block_step(cells=True)`), FedBuff with one buffer and the guard
    with one counter a cell, and with ``lanes`` this rank's lanes of every
    cell's blocks."""

    def __init__(self, grad_fn, w0, rows, pack, unpack, enc, flat_mode, update_fn, fedbuff_Z,
                 E, n, C, B, dev, guard=None, lanes=None):
        self.E, self.n, self.C, self.B, self.R, self.dev = E, n, C, B, rows, dev
        self.guarded = guard is not None
        self.cutoff = int(guard.stale_cutoff) if guard is not None else 0
        self.cols = _lane_cols(lanes, E)
        self.carry, self.to_tree = _init_update_carry(w0, rows, pack, unpack, flat_mode, enc,
                                                      fedbuff_Z, cells=B)
        self.flat_mode, self.unpack = flat_mode, unpack
        if E > 1:
            self.step = _make_block_step(grad_fn, pack, unpack, "jnp", fedbuff_Z,
                                         None if lanes is None else lanes[0], guard, cells=True)
        else:
            self.step = _make_cells_event_step(grad_fn, update_fn, pack, unpack, enc, flat_mode,
                                               fedbuff_Z, guard)
            self.ring = self.carry[1].view(B * rows, -1)
            self.base = torch.arange(B, dtype=torch.int64, device=dev) * rows

    def events(self, J, slot, scale, k0: int, stale=None, serve=None):
        B, Lc = (int(d) for d in J.shape)
        if self.E == 1:
            Jt, rows_t = J.t().contiguous(), (slot.t() + self.base).contiguous()
            sct = scale.t().contiguous()
            st_t = None if stale is None else stale.t().contiguous()
            ks = torch.arange(k0, k0 + Lc, dtype=torch.int64, device=self.dev)[:, None].expand(Lc, B)
            if serve is not None:  # accepted: a nonzero scale the guard let through
                loop, served = serve
                slot_t = slot.t().contiguous()
                row_mean = lambda r: _row_means(self.carry[1], r)  # noqa: E731
            w, snaps, acc, gcnt = self.carry
            c = (w, acc, gcnt)
            for i in range(Lc):
                if serve is not None and self.guarded:
                    gcnt_pre = gcnt.clone()
                c = self.step(c, self.ring, Jt[i], rows_t[i], sct[i], ks[i],
                              None if st_t is None else st_t[i])
                if serve is not None:
                    accepted = sct[i] != 0
                    if self.guarded:
                        accepted = accepted & (gcnt == gcnt_pre).all(-1)
                    loop.read(slot_t[i], accepted, ks[i], row_mean, served[:, i])
            self.carry = (c[0], snaps, c[1], c[2])
            return
        if stale is not None and self.cutoff > 0:
            st = (scale != 0) & (stale > self.cutoff)
            self.carry[3][:, 1] += torch.sum(st, dim=-1).to(torch.int32)
            scale = torch.where(st, 0.0, scale)
        blocks = _chunk_blocks(J, slot, scale, k0, self.E, self.n, self.C, self.cols)
        for r in range(blocks[0].shape[1]):
            self.carry = self.step(self.carry, *(a[:, r] for a in blocks))

    def evaluate(self, eval_fn):
        return _cells_eval_fn(eval_fn, self.unpack, self.flat_mode)(self.carry[0])

    def weights(self):
        return self.to_tree(self.carry[0])

    def gcnt(self):
        """``(guard_rejects, stale_drops)``, (B,) device tensors."""
        return self.carry[3][:, 0], self.carry[3][:, 1]


def _row_means(snaps: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """The fp32 mean of each cell's ring row ``slot``: (B,) from the
    (B, rows, P) ring and (B,) rows (the serving read path)."""
    B, R, P = snaps.shape
    base = torch.arange(B, dtype=torch.int64, device=snaps.device) * R
    return snaps.reshape(B * R, P).index_select(0, base + slot).float().mean(-1)


def _chunk_blocks(J, slot, scale, k0: int, E: int, n: int, C: int, cols=slice(None)):
    """One chunk of B cells' device events as (B, rows, E) blocked columns.

    The chunk comes to the host (one copy a chunk); each cell's run is cut
    into conflict-free blocks (`EventBlocks.from_columns`) and the cells are
    laid out and padded as `blocked_inputs_batch` lays out host streams.
    ``cols`` keeps a rank's lanes of every block (`_lane_cols`)."""
    Jh, sh = torch.stack((J, slot)).cpu().numpy()
    blocks = [EventBlocks.from_columns(j, s, n, C, E) for j, s in zip(Jh, sh)]
    Jb, sb, scb, kb, mb, _, _ = (a[..., cols] if isinstance(a, np.ndarray) else a
                                 for a in blocked_inputs_batch(blocks, list(scale.cpu().numpy())))
    dev = J.device
    idx = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)  # noqa: E731
    m = torch.as_tensor(mb, device=dev)
    return (idx(Jb), idx(sb), torch.as_tensor(scb, dtype=scale.dtype, device=dev),
            torch.where(m, idx(kb) + k0, 0), m)


_EVAL_CADENCE_MSG = (
    "block_size > 1: the eval cadence is encoded in the blocked "
    "layout — pass chunk_blocks/n_chunks from blocked_inputs(..., "
    "eval_every=...) at call time instead of eval_every"
)


def make_runner(
    grad_fn: Callable[[Any, Pytree, Any], Pytree],
    C: int,
    *,
    stream: str = "host",
    fedbuff_Z: int = 0,
    eval_fn: Callable[[Pytree], Any] | None = None,
    eval_every: int = 0,
    update_fn: Callable[[Pytree, Pytree, Any], Pytree] | None = None,
    block_size: int = 1,
    kernel: str = "jnp",
    snapshot_dtype=None,
    lane_devices: int = 1,
    vmap_streams: bool = False,
    guard: GuardConfig | None = None,
    **device_kw,
):
    """Build the scan engine; ``stream`` selects the event source.

    ``stream="host"`` (default) replays a pre-simulated event stream:
    ``run(w0, J, slot, scale[, eval_every])`` per event; with
    ``block_size=E > 1`` ``run(w0, J, slot, scale, k, mask[, chunk_blocks,
    n_chunks])`` over `blocked_inputs` arrays.  ``fedbuff_Z > 0`` replays
    FedBuff, ``kernel`` picks the plain path or the CUDA kernels,
    ``snapshot_dtype`` an optional narrower ring storage dtype and
    ``lane_devices`` the number of ranks the blocked lanes are sharded over.
    ``vmap_streams=True`` takes the same arrays with a leading cell axis
    (stacked streams, `blocked_inputs_batch`) and replays the cells in
    lockstep (with ``lane_devices``, each rank's lanes of every cell).
    ``guard`` adds the divergence guard and returns its counter third
    (`GuardConfig`; (B, 2) across cells).

    ``stream="device"`` generates the events next to the replay
    (`make_fused_runner`): ``run(w0, mu, p0, key, eta)``.  It requires
    ``n=`` and ``T=`` and takes `make_fused_runner`'s other keywords.
    """
    if stream == "device":
        try:
            n, T = device_kw.pop("n"), device_kw.pop("T")
        except KeyError as e:
            raise TypeError(f"stream='device' requires {e.args[0]}=") from None
        if vmap_streams:
            raise ValueError("stream='device' runs cells with vmap_scenarios=True")
        return make_fused_runner(
            grad_fn, n, C, T, fedbuff_Z=fedbuff_Z, eval_fn=eval_fn, eval_every=eval_every,
            update_fn=update_fn, block_size=block_size, snapshot_dtype=snapshot_dtype,
            lane_devices=lane_devices, guard=guard, **device_kw,
        )
    if stream != "host":
        raise ValueError(stream)
    if device_kw:
        raise TypeError(f"host stream does not accept {sorted(device_kw)}")
    lanes = _check_lane_devices(lane_devices, block_size)  # rejects D > 1 at E = 1
    if block_size > 1:
        if eval_every:
            raise ValueError(_EVAL_CADENCE_MSG)
        return _make_host_block_runner(
            grad_fn, C, block_size, fedbuff_Z=fedbuff_Z, eval_fn=eval_fn,
            update_fn=update_fn, kernel=kernel, snapshot_dtype=snapshot_dtype,
            lanes=lanes, vmap_streams=vmap_streams, guard=guard,
        )
    return _make_host_runner(
        grad_fn, C, fedbuff_Z=fedbuff_Z, eval_fn=eval_fn, eval_every=eval_every,
        update_fn=update_fn, snapshot_dtype=snapshot_dtype, vmap_streams=vmap_streams,
        guard=guard,
    )


def _runner_cache(grad_fn):
    """Per-owner memo for runners: on the object owning `grad_fn` (its
    `__self__` for bound methods, else the function's own `__dict__`), so
    the memo dies with the gradient source."""
    owner = getattr(grad_fn, "__self__", grad_fn)
    func = getattr(grad_fn, "__func__", grad_fn)
    try:
        cache = owner.__dict__.setdefault("_scan_runner_cache", {})
    except AttributeError:  # no instance dict (slots/builtin): skip memoization
        cache = {}
    return cache, func


def jit_runner(
    grad_fn,
    C: int,
    fedbuff_Z: int = 0,
    eval_fn=None,
    eval_every: int = 0,
    update_fn=None,
    block_size: int = 1,
    kernel: str = "jnp",
    snapshot_dtype=None,
    lane_devices: int = 1,
    vmap_streams: bool = False,
    guard: GuardConfig | None = None,
):
    """Memoized `make_runner` (host stream).

    PyTorch runs eagerly, so there is nothing to compile: this keeps
    `repro`'s entry point and memo (one runner per gradient source and
    algorithm shape; the per-event eval cadence stays a call-time argument).
    ``vmap_streams=True`` returns the runner over stacked streams (a
    leading cell axis on every array, the cells replayed in lockstep);
    with ``lane_devices=D`` and ``block_size=E`` each of the D ranks takes
    its E/D lanes of every cell (the reference's shard_map over a vmapped
    runner).
    """
    if block_size > 1 and eval_every:
        raise ValueError(_EVAL_CADENCE_MSG)
    cache, func = _runner_cache(grad_fn)
    # the lanes' (group, rank) is in the key: a runner holds the group it was built for
    key = ("host", func, C, fedbuff_Z, eval_fn, update_fn, vmap_streams, block_size, kernel,
           snapshot_dtype, _check_lane_devices(lane_devices, block_size),
           None if guard is None else guard.cache_key())
    if key not in cache:
        cache[key] = make_runner(
            grad_fn, C, fedbuff_Z=fedbuff_Z, eval_fn=eval_fn, update_fn=update_fn,
            block_size=block_size, kernel=kernel, snapshot_dtype=snapshot_dtype,
            lane_devices=lane_devices, vmap_streams=vmap_streams, guard=guard,
        )
    run = cache[key]
    return run if block_size > 1 else partial(run, eval_every=eval_every)


def jit_fused_runner(grad_fn, n: int, C: int, T: int, *, vmap_scenarios: bool = False,
                     shard_devices: int = 1, lane_devices: int = 1, **kw):
    """Memoized fused (device-stream) runner, `repro`'s entry point.

    Memoized on the gradient source like `jit_runner`; ``vmap_scenarios``
    runs stacked (mu, p0, key) cells with shared (w0, eta) in lockstep, the
    cells' streams generated together.  Extra keywords forward to
    `make_fused_runner` and take part in the memo key.

    ``shard_devices=S > 1`` (with ``vmap_scenarios``) splits the cells over
    ranks 0 … S·L−1 of a process group of at least S·L ranks, L =
    ``lane_devices``: rank r = s·L + l runs cells [s·B/S, (s+1)·B/S), shards
    their blocks' lanes over the ranks {s·L + l'} and gathers the cells'
    results over the ranks {s'·L + l}, so every rank returns all B cells
    (`_scenario_mesh`); ranks from S·L up take no part and receive the grid
    from rank 0 (lanes alone, S = 1, in a world of more than L ranks, take
    this layout too).  As in the reference, with lanes the inputs and
    outputs are flat (B, ...) (its 2-D ``("scen", "lanes")`` mesh); without,
    they carry a leading (S, B/S) (its ``pmap``): ``mu[s]``, ``p0[s]`` and
    ``key[s]`` are shard s's cells.  Without ``vmap_scenarios`` the
    reference ignores ``shard_devices``, and so does this: the unsharded
    runner, or the lane runner with ``lane_devices > 1``.
    """
    if shard_devices < 1:
        raise ValueError("shard_devices >= 1 required")
    if not vmap_scenarios:
        shard_devices = 1
    layout = vmap_scenarios and (shard_devices > 1
                                 or (lane_devices > 1 and world_size() > lane_devices))
    mesh = (_scenario_mesh(shard_devices, lane_devices, max(int(kw.get("block_size", 1)), 1))
            if layout else None)
    cache, func = _runner_cache(grad_fn)

    def entry(k, v):
        if k == "bound":
            return (k, None if v is None else (v.A, v.L, v.B, v.C, v.T, v.rho))
        if k in ("fault", "guard", "serving", "scenario", "classes"):
            return (k, None if v is None else v.cache_key())
        return (k, v)

    # a runner holds the process groups it was built for
    key = ("device", func, n, C, T, vmap_scenarios, shard_devices, lane_devices, _world_group(),
           tuple(entry(k, v) for k, v in sorted(kw.items())))
    if key not in cache:
        if mesh is None:
            cache[key] = make_fused_runner(grad_fn, n, C, T, vmap_scenarios=vmap_scenarios,
                                           lane_devices=lane_devices, **kw)
        else:
            run = (None if mesh.shard is None else
                   make_fused_runner(grad_fn, n, C, T, vmap_scenarios=True,
                                     lane_devices=lane_devices, lane_axis=mesh.lane_group, **kw))
            cache[key] = _shard_cells(run, mesh, shard_devices, flat=lane_devices > 1)
    return cache[key]


def _shard_cells(run, mesh: _Mesh, S: int, flat: bool):
    """``run`` (a cell-axis fused runner) over this rank's shard of the
    cells, its results gathered over ``mesh.shard_group`` in one collective
    (`_all_gather_lanes`, the cells in the place of the lanes).  ``flat``:
    the cells arrive as (B, ...) and shard s takes rows [s·B/S, (s+1)·B/S);
    else they arrive as (S, B/S, ...) and shard s takes row s, and every
    output gets the leading (S, B/S) back.  The sampling-class sizes
    (``class_counts``) are the same in every shard and stay as they are.
    A rank outside the layout (``run`` None) only receives the results
    (`_from_rank0`)."""

    def take(a):
        if a is None:
            return None
        if not flat:
            return a[mesh.shard]
        if len(a) % S:
            raise ValueError(f"{len(a)} cells do not split over shard_devices={S}")
        per = len(a) // S
        return a[mesh.shard * per : (mesh.shard + 1) * per]

    def gather(w, evals, extras):
        if S == 1:
            return w, evals, extras
        leaves, unflatten = tree_flatten(w)
        names = [k for k in extras if k != "class_counts"]
        ts = [*leaves, evals, *(extras[k] for k in names)]
        live = [t for t in ts if t.numel()]
        full = iter(_all_gather_lanes(mesh.shard_group, *live))
        out = [next(full) if t.numel() else t.new_zeros((S * t.shape[0],) + t.shape[1:])
               for t in ts]
        if not flat:
            out = [t.reshape((S, t.shape[0] // S) + t.shape[1:]) for t in out]
        extras = dict(extras, **dict(zip(names, out[len(leaves) + 1:])))
        return unflatten(out[: len(leaves)]), out[len(leaves)], extras

    def sharded(w0, mu, p0, key, eta):
        out = None if run is None else gather(*run(w0, take(mu), take(p0), take(key), eta))
        return _from_rank0(out, mesh, tree_leaves(w0)[0].device)

    def from_draws(w0, mu, p0, eta, *draws, **kw_draws):
        out = None if run is None else gather(*run.from_draws(
            w0, take(mu), take(p0), eta, *map(take, draws),
            **{k: take(v) for k, v in kw_draws.items()}))
        return _from_rank0(out, mesh, tree_leaves(w0)[0].device)

    sharded.from_draws = from_draws
    return sharded
