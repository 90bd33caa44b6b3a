"""Device-resident Generalized-AsyncSGD replay engine (host event stream).

The PyTorch counterpart of `repro.core.engine_scan`'s host stream.  The
event stream (J_k, K_{k+1}, t_k) of the closed Jackson network does not
depend on the gradient values, so it is simulated on the host first
(`queue_sim.export_stream`) and Algorithm 1 replays it on the device:

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
  * evaluation runs every ``eval_every`` events (per event) or after each
    eval-interval group of blocks (blocked), on micro-block boundaries by
    construction (`segment_blocks(cut_every=)`).

Where JAX runs one `lax.scan`, this engine runs a Python loop over events
whose arrays already live on the device: the loop indexes them with Python
ints, which gives 0-d device tensors, and every gather and scatter takes
them through `index_select` / `index_copy_` — no `.item()`, so the host
never waits for the device inside a run.  The ring buffer is updated in
place (JAX donates it).
"""
from __future__ import annotations

from functools import partial, reduce
from typing import Any, Callable

import numpy as np
import torch

from ..tree import tree_flatten
from ..unported import unported
from .queue_sim import KIND_COMPLETE, EventBlocks, EventStream

__all__ = [
    "blocked_inputs",
    "jit_runner",
    "make_runner",
    "step_scales",
    "stream_arrays",
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

    def pack(w):
        flat = torch.cat([x.reshape(-1).to(compute_dtype) for x in tree_flatten(w)[0]])
        if P_pad != P:
            flat = torch.nn.functional.pad(flat, (0, P_pad - P))
        return flat

    def unpack(flat):
        return unflatten([
            flat[offs[i] : offs[i + 1]].reshape(shapes[i]).to(leaf_dtypes[i])
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
    unchunked pass would hold ~30 GB of float32 temporaries."""
    if w.dtype == torch.float32 and g.dtype == torch.float32:
        return w - scale * g
    out = torch.empty_like(w)
    for i in range(0, w.numel(), _AXPY_CHUNK):
        sl = slice(i, i + _AXPY_CHUNK)
        out[sl] = w[sl].float() - scale * g[sl].float()
    return out


def _make_update_step(grad_fn, update_fn, pack, unpack, flat_mode, enc):
    """The algorithm half of a CS step, independent of the event source.

    ``update_step((w, snaps), j, s, scale, k) -> (w, snaps)`` consumes one
    event (completing client j, ring slot s, update scale, server step k —
    all 0-d device tensors) exactly as Algorithm 1 lines 9-11.  In flat
    mode ``w`` is the packed vector and the update is one axpy; otherwise
    (a given ``update_fn``, e.g. the per-leaf K1 kernel) ``w`` is the
    pytree.  ``snaps`` is written in place.
    """
    if unpack is None:
        raise ValueError(
            "the torch engine needs all-float parameters (flat-packed "
            "snapshot storage)"
        )

    def update_step(ucarry, j, s, scale, k):
        w, snaps = ucarry
        s1 = s.reshape(1)
        # gather the completing task's dispatch-time snapshot (Alg. 1 line 9)
        w_disp = unpack(snaps.index_select(0, s1)[0])
        g = grad_fn(j, w_disp, k)
        if flat_mode:
            w = _flat_axpy(w, pack(g), scale)
            row = enc(w)
        else:
            w = update_fn(w, g, scale)
            row = enc(pack(w))
        # the freed slot hosts the new dispatch with the updated params
        snaps.index_copy_(0, s1, row[None])
        return w, snaps

    return update_step


def _make_batched_grads(grad_fn, pack, unpack):
    """Batched gradient call over one micro-block: (E,) client ids, (E, P)
    stored snapshot rows, (E,) server steps -> (E, P) packed gradients.

    `torch.func.vmap` over the whole gradient source — its minibatch gather
    included (`fl.engine.DeviceTaskClients.client_batch` gathers with
    `index_select`, which has a batching rule)."""
    return torch.func.vmap(lambda j, wi, k: pack(grad_fn(j, unpack(wi), k)))


def _make_block_step(grad_fn, pack, unpack, kernel):
    """One event micro-block of the blocked engine (flat-packed mode).

    ``block_step((w, snaps), j, s, scale, k, mask) -> (w, snaps)`` consumes
    up to E conflict-free events: one batched snapshot gather, one vmapped
    gradient call, then the exact sequential iterates w_i = w_0 -
    sum_{j<=i} D_j written back in one pass.  Padded lanes (mask False)
    carry zero scale and the trash ring row, so they are arithmetic no-ops.
    """
    if kernel == "pallas":
        # the hand-written CUDA kernel on a CUDA ring, the plain version on
        # a CPU ring (dispatch by the tensor's device)
        from ..kernels.ops import block_prefix_update as apply_block
    elif kernel == "jnp":
        from ..kernels.ref import block_prefix_update_ref as apply_block
    else:
        raise ValueError(kernel)
    grads = _make_batched_grads(grad_fn, pack, unpack)

    def block_step(ucarry, j, s, sc, k, m):
        w, snaps = ucarry
        G = grads(j, snaps.index_select(0, s), k)  # (E, P)
        scm = torch.where(m, sc, 0.0).to(torch.float32)
        D = scm[:, None] * G.to(torch.float32)
        snaps, w = apply_block(snaps, w, D, s)
        return w, snaps

    return block_step


def _init_update_carry(w0, rows, pack, unpack, flat_mode, enc):
    """``(w, snaps)`` initial carry + the carry->pytree decoder.

    ``rows`` is the ring height — C for the per-event engine, C+1 for the
    blocked engine (the extra trash row absorbs padded scatters).
    """
    flat0 = pack(w0)
    snaps0 = enc(flat0)[None].expand(rows, -1).clone()
    w_init = flat0 if flat_mode else w0
    to_tree = unpack if flat_mode else (lambda w: w)
    return (w_init, snaps0), to_tree


def _stack_evals(evals: list, device) -> torch.Tensor:
    return torch.stack(evals) if evals else torch.zeros((0,), device=device)


# ------------------------------------------------------------------ #
# host stream: replay a pre-simulated EventStream
# ------------------------------------------------------------------ #
def _make_host_runner(
    grad_fn: Callable[[Any, Pytree, Any], Pytree],
    C: int,
    *,
    eval_fn: Callable[[Pytree], Any] | None = None,
    eval_every: int = 0,
    update_fn: Callable[[Pytree, Pytree, Any], Pytree] | None = None,
    snapshot_dtype=None,
):
    """Build the per-event replay engine.

    Returns ``run(w0, J, slot, scale, eval_every=...) -> (w_final, evals)``
    over (T,) device tensors (J, slot int64; scale float32).  ``evals`` is
    the eval_fn curve sampled every `eval_every` steps (an empty tensor
    when evaluation is off); events past the last eval point still replay.

    grad_fn(j, w, k): stochastic gradient of client j at params w, server
    step k (0-d device tensors).  update_fn(w, g, scale) defaults to
    w - scale*g.
    """
    eval_every_default = eval_every

    def run(w0, J, slot, scale, eval_every=eval_every_default):
        pack, unpack, enc = _snapshot_codec(w0, snapshot_dtype)
        flat_mode = update_fn is None  # the default update is one flat axpy
        update_step = _make_update_step(grad_fn, update_fn, pack, unpack, flat_mode, enc)
        carry, to_tree = _init_update_carry(w0, C, pack, unpack, flat_mode, enc)
        T = int(J.shape[0])
        ks = torch.arange(T, dtype=torch.int64, device=J.device)
        every = eval_every if (eval_fn is not None and eval_every and T >= eval_every) else 0
        evals = []
        for k in range(T):
            carry = update_step(carry, J[k], slot[k], scale[k], ks[k])
            if every and (k + 1) % every == 0:
                evals.append(eval_fn(to_tree(carry[0])))
        return to_tree(carry[0]), _stack_evals(evals, J.device)

    return run


def _make_host_block_runner(
    grad_fn: Callable[[Any, Pytree, Any], Pytree],
    C: int,
    block_size: int,
    *,
    eval_fn: Callable[[Pytree], Any] | None = None,
    update_fn: Callable[[Pytree, Pytree, Any], Pytree] | None = None,
    kernel: str = "jnp",
    snapshot_dtype=None,
):
    """Build the blocked replay engine over `queue_sim.EventBlocks` arrays.

    Returns ``run(w0, J, slot, scale, k, mask, chunk_blocks=0, n_chunks=0)
    -> (w_final, evals)`` over (B, E) device tensors (see `blocked_inputs`).
    The first ``n_chunks * chunk_blocks`` rows are eval-interval groups
    (eval fires after each group); trailing rows replay without eval.

    The blocked engine needs the flat-packed codec and the default linear
    update; ``kernel`` picks the plain path ("jnp") or the fused prefix-scan
    kernel ("pallas"), for which the packed vector is padded to a multiple
    of `kernels.weighted_update.BLOCK_TILE` once at init.
    """
    if update_fn is not None:
        raise ValueError(
            "block_size > 1 requires the default update w - scale*g "
            "(the blocked replay reconstructs iterates via a prefix sum)"
        )
    if block_size < 2:
        raise ValueError("use _make_host_runner for block_size <= 1")
    pad_to = 1
    if kernel == "pallas":
        from ..kernels.weighted_update import BLOCK_TILE

        pad_to = BLOCK_TILE

    def run(w0, J, slot, scale, k, mask, chunk_blocks=0, n_chunks=0):
        pack, unpack, enc = _snapshot_codec(w0, snapshot_dtype, pad_to=pad_to)
        if unpack is None:
            raise ValueError(
                "block_size > 1 requires all-float parameters "
                "(flat-packed snapshot storage)"
            )
        block_step = _make_block_step(grad_fn, pack, unpack, kernel)
        carry, to_tree = _init_update_carry(w0, C + 1, pack, unpack, True, enc)
        B = int(J.shape[0])
        every = chunk_blocks if (eval_fn is not None and n_chunks and chunk_blocks) else 0
        Bm = n_chunks * chunk_blocks
        evals = []
        for b in range(B):
            carry = block_step(carry, J[b], slot[b], scale[b], k[b], mask[b])
            if every and b < Bm and (b + 1) % every == 0:
                evals.append(eval_fn(to_tree(carry[0])))
        return to_tree(carry[0]), _stack_evals(evals, J.device)

    return run


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
):
    """Build the replay engine for a pre-simulated event stream.

    ``run(w0, J, slot, scale[, eval_every])`` per event; with
    ``block_size=E > 1`` ``run(w0, J, slot, scale, k, mask[, chunk_blocks,
    n_chunks])`` over `blocked_inputs` arrays.  ``kernel`` picks the plain
    path or the fused prefix-scan kernel, ``snapshot_dtype`` an optional
    narrower ring storage dtype.
    """
    if stream != "host":
        if stream == "device":
            raise unported("stream='device'", 6)
        raise ValueError(stream)
    if fedbuff_Z > 0:
        raise unported("fedbuff_Z > 0", 4)
    if block_size > 1:
        if eval_every:
            raise ValueError(
                "block_size > 1: the eval cadence is encoded in the blocked "
                "layout — pass chunk_blocks/n_chunks from blocked_inputs(..., "
                "eval_every=...) at call time instead of eval_every"
            )
        return _make_host_block_runner(
            grad_fn, C, block_size, eval_fn=eval_fn, update_fn=update_fn,
            kernel=kernel, snapshot_dtype=snapshot_dtype,
        )
    return _make_host_runner(
        grad_fn, C, eval_fn=eval_fn, eval_every=eval_every,
        update_fn=update_fn, snapshot_dtype=snapshot_dtype,
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
):
    """Memoized `make_runner` (host stream).

    PyTorch runs eagerly, so there is nothing to compile: this keeps
    `repro`'s entry point and memo (one runner per gradient source and
    algorithm shape; the per-event eval cadence stays a call-time argument).
    """
    if fedbuff_Z > 0:
        raise unported("fedbuff_Z > 0", 4)
    cache, func = _runner_cache(grad_fn)
    key = ("host", func, C, eval_fn, update_fn, block_size, kernel, snapshot_dtype)
    if block_size > 1 and eval_every:
        raise ValueError(
            "block_size > 1: the eval cadence is encoded in the blocked "
            "layout — pass chunk_blocks/n_chunks from blocked_inputs(..., "
            "eval_every=...) at call time instead of eval_every"
        )
    if key not in cache:
        cache[key] = make_runner(
            grad_fn, C, eval_fn=eval_fn, update_fn=update_fn,
            block_size=block_size, kernel=kernel, snapshot_dtype=snapshot_dtype,
        )
    run = cache[key]
    return run if block_size > 1 else partial(run, eval_every=eval_every)
