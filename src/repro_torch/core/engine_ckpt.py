"""Checkpointed engine drivers: kill-and-resume with a bitwise guarantee.

The counterpart of `repro.core.engine_ckpt`.  The replay runners of
`engine_scan` keep their whole state in memory — a SIGKILL loses
everything.  The host drivers run the same runners' loops with a checkpoint
hook (`_Checkpoints`), which saves the complete carry at the checkpoint
cadence through `repro_torch.ckpt` and restores it on resume:

  * the parameter vector, the snapshot ring (fp32, or bf16 stored as its
    uint16 bits), the FedBuff buffer and the guard counter,
  * the eval curve so far and the event cursor.

The event arrays are deterministic host data (re-exported from the same
`SimConfig` on resume), so restoring the latest checkpoint and continuing
reproduces the uninterrupted run bit for bit — and the uninterrupted run
is bitwise the un-checkpointed runner's, since it is that runner's loop.  A config fingerprint is stored in every
checkpoint and checked on ``resume=True``: resuming under another
configuration is an error, not a silent divergence.

Tensors are mutable, unlike JAX arrays: the next chunk writes the ring in
place (K2, ``index_copy_``).  So a save first copies the carry to pinned
host memory and waits for that copy, once per save, before the chunk loop
goes on; the background writer then works on the host copy.  `saves`
records each save's bytes and how long it held the loop.

The fused device-stream driver (`run_checkpointed`) runs the fused
runner's chunks (`engine_scan._advance_chunk`) from a host loop and saves,
besides the replay's carry, the closed network's `StreamState` and
`StatsState`, the per-slot dispatch-time scales, p and its dispatch CDF,
and under ``serving=`` the serving plane's `ServeState` and `ServeStats`.
Chunk c's uniforms come from a generator seeded by a fixed function of
(seed, c) (`chunk_seed`), as the reference folds the chunk index into its
key: nothing depends on when a chunk runs, so a resume needs no generator
state.  That is a different draw order than `make_fused_runner`'s single
upfront draw, so the checkpointed fused run is its own deterministic
trajectory, with the same law.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any

import numpy as np
import torch

from ..tree import tree_flatten
from .engine_scan import (
    GuardConfig,
    _advance_chunk,
    _FusedReplay,
    _make_host_block_runner,
    _make_host_runner,
    _require_flat_codec,
    _slot_scales,
    _snapshot_codec,
)

__all__ = [
    "chunk_seed",
    "run_checkpointed",
    "run_checkpointed_host",
    "run_checkpointed_host_blocked",
    "saves",
    "reset_saves",
]

#: one dict per save of the chunked drivers, in order: the event cursor
#: (``step``), the bytes copied to the host (``bytes``), the seconds the
#: loop waited for the previous save's write (``wait_s``) and for the
#: device-to-host copy of the carry (``copy_s``), and, once written, the
#: size of its ``arrays.npz`` (``file_bytes``)
saves: list[dict] = []


def reset_saves() -> None:
    saves.clear()


# ------------------------------------------------------------------ #
# shared checkpoint plumbing
# ------------------------------------------------------------------ #
def _fingerprint(kind: str, fields: dict) -> str:
    """Stable config fingerprint for resume validation."""
    blob = json.dumps({"kind": kind, **fields}, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()


def _array_digest(*arrays) -> str:
    h = hashlib.sha1()
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a))
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _resume_state(ckpt_dir: str, like, fingerprint: str):
    """Latest checkpoint tree (validated against ``fingerprint``) and its step."""
    from ..ckpt import checkpoint as ck

    step = ck.latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"resume=True but no checkpoint found under {ckpt_dir!r}")
    meta = ck.load_metadata(ckpt_dir, step)
    if meta.get("fingerprint") != fingerprint:
        raise ValueError(
            "checkpoint/config mismatch: the run under "
            f"{ckpt_dir!r} was written by a different engine configuration "
            "(fingerprint differs; refusing to resume into a divergent trajectory)"
        )
    return ck.restore(ckpt_dir, step, like), step


def _save_state(ckpt_dir: str, step: int, tree, fingerprint: str, keep: int) -> str:
    from ..ckpt import checkpoint as ck

    return ck.save(
        ckpt_dir, step, tree,
        metadata={"fingerprint": fingerprint, "events_done": step},
        keep=keep,
    )


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else np.asarray(x).nbytes


class _AsyncSaver:
    """Background checkpoint writer for the chunked drivers.

    `put` copies the carry to host memory (pinned, for a CUDA carry) and
    waits for that copy, so the chunk loop may go on writing the ring in
    place; the worker thread then runs the atomic `checkpoint.save` (tmp
    dir + rename) on the copy while the loop computes.  One set of host
    buffers is reused: `put` first waits until the previous save is
    written.  Saves stay strictly ordered (one worker, FIFO queue); a
    SIGKILL mid-write leaves only an ignored ``.tmp_ckpt_*`` directory, so
    resume falls back to the last completed step.  ``close()`` drains the
    queue and re-raises the first worker failure; the drivers call it
    before returning, so the final checkpoint is on disk when the run
    completes.
    """

    def __init__(self, ckpt_dir: str, fingerprint: str, keep: int):
        import queue
        import threading

        self._dir, self._fp, self._keep = ckpt_dir, fingerprint, keep
        self._q: Any = queue.Queue(maxsize=2)
        self._err: BaseException | None = None
        self._bufs: list | None = None
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                step, tree, stat = item
                if self._err is None:
                    npz = os.path.join(_save_state(self._dir, step, tree, self._fp, self._keep),
                                       "arrays.npz")
                    # rotation keeps the highest steps: a fresh run into a
                    # directory holding later ones rotates its own save away
                    if os.path.exists(npz):
                        stat["file_bytes"] = os.path.getsize(npz)
            except BaseException as exc:  # surfaced at put()/close()
                self._err = exc
            finally:
                self._q.task_done()

    def _host_copy(self, carry):
        """The carry's leaves copied into the reused host buffers: one
        asynchronous copy per CUDA tensor, then one wait for all of them."""
        leaves, unflatten = tree_flatten(carry)
        sig = [(type(x), tuple(np.shape(x)), getattr(x, "dtype", None),
                x.is_cuda if isinstance(x, torch.Tensor) else False) for x in leaves]
        if self._bufs is None or self._bufs[0] != sig:
            bufs = [torch.empty(x.shape, dtype=x.dtype, pin_memory=x.is_cuda)
                    if isinstance(x, torch.Tensor) else None for x in leaves]
            self._bufs = (sig, bufs)
        out, cuda = [], False
        for x, buf in zip(leaves, self._bufs[1]):
            if isinstance(x, torch.Tensor):
                buf.copy_(x.detach(), non_blocking=x.is_cuda)
                cuda = cuda or x.is_cuda
                out.append(buf)
            else:
                out.append(None if x is None else np.array(x))
        if cuda:
            torch.cuda.synchronize()
        return unflatten(out)

    def put(self, step: int, carry, evals_buf: np.ndarray) -> None:
        if self._err is not None:
            # fail loudly at the next save after a write error (full disk,
            # permissions): reap the worker first so the failure doesn't
            # leak a thread blocked on the queue
            self.abort()
            raise self._err
        t0 = time.perf_counter()
        self._q.join()  # the previous save is written: its host buffers are free
        t1 = time.perf_counter()
        host = self._host_copy(carry)
        t2 = time.perf_counter()
        evals = np.array(evals_buf, np.float32)
        stat = dict(step=int(step), wait_s=t1 - t0, copy_s=t2 - t1,
                    bytes=sum(_nbytes(x) for x in tree_flatten(host)[0] if x is not None)
                    + evals.nbytes)
        saves.append(stat)
        self._q.put((step, {"carry": host, "evals": evals, "cursor": np.int64(step)}, stat))

    def abort(self) -> None:
        """Reap the worker without raising — error-path cleanup.  Safe to
        call repeatedly and after `close` (a no-op once the worker exited);
        the drivers call it in a ``finally`` so an exception anywhere in
        the chunk loop never leaks the writer thread."""
        if self._worker.is_alive():
            self._q.put(None)
            self._worker.join()

    def close(self) -> None:
        self.abort()
        if self._err is not None:
            raise self._err


def _chunk_layout(T: int, ckpt_every: int, eval_every: int, refresh_every: int = 0) -> int:
    """Chunk length L: refresh, eval and checkpoint all land on chunk
    boundaries, so L divides every active cadence."""
    if ckpt_every <= 0:
        raise ValueError("ckpt_every > 0 required")
    L = min(ckpt_every, T)
    if refresh_every:
        L = min(L, refresh_every)
    if eval_every:
        L = min(L, eval_every)
    for name, every in (("refresh_every", refresh_every), ("eval_every", eval_every),
                        ("ckpt_every", ckpt_every)):
        if every and every % L:
            raise ValueError(
                f"{name}={every} must be a multiple of the chunk length {L} "
                "(refresh/eval/checkpoint cadences must nest)"
            )
    return L


class _EvalBuffer:
    """NaN-padded fixed-size eval curve that rides inside the checkpoint."""

    def __init__(self, n_evals: int, restored: np.ndarray | None = None):
        if restored is not None:
            self.buf = np.array(restored, np.float32)
        else:
            self.buf = np.full(n_evals, np.nan, np.float32)
        self.n = n_evals

    def put(self, idx: int, value) -> None:
        if 0 <= idx < self.n:
            self.buf[idx] = np.float32(float(value))

    def curve(self) -> np.ndarray:
        return self.buf[~np.isnan(self.buf)]


def _host_array(a, dtype) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def _cache_key(guard: GuardConfig | None):
    return None if guard is None else guard.cache_key()


def chunk_seed(seed: int, c: int) -> int:
    """The generator seed of the checkpointed fused driver's chunk ``c``
    (``c = -1``: the initial placement), a fixed function of (seed, c)."""
    return int(np.random.SeedSequence([int(seed), c + 1]).generate_state(1)[0])


def _port_draws(seed: int, n: int, C: int, p, init: str, dev):
    """``(nodes, chunk_draws)`` from the port's generators: the initial
    placement, and ``chunk_draws(c, Lc) -> (u_race, u_exp, u_disp)`` of
    chunk c, each from a generator seeded by `chunk_seed`."""
    from .stream_device import _generator, _init_nodes

    nodes = _init_nodes(_generator(chunk_seed(seed, -1), dev), n, C, p, init)

    def chunk_draws(c: int, Lc: int):
        gen = _generator(chunk_seed(seed, c), dev)
        return tuple(torch.rand(Lc, generator=gen, device=dev) for _ in range(3))

    return nodes, chunk_draws


def run_checkpointed(
    grad_fn,
    n: int,
    C: int,
    T: int,
    *,
    w0,
    mu,
    p0,
    key,
    eta,
    ckpt_dir: str,
    ckpt_every: int,
    weighting: str = "importance",
    eval_fn=None,
    eval_every: int = 0,
    adaptive: bool = False,
    refresh_every: int = 0,
    bound=None,
    ctrl_lr: float = 0.3,
    ctrl_iters: int = 4,
    init: str = "distinct",
    block_size: int = 1,
    snapshot_dtype=None,
    fault=None,
    guard: GuardConfig | None = None,
    serving=None,
    resume: bool = False,
    keep: int = 3,
    draws=None,
):
    """Checkpointed fused engine: host-driven chunks of the device stream.

    The fused runner's event semantics (`engine_scan._advance_chunk`:
    faults, the guard, adaptive refresh and the blocked replay compose) in
    a host loop over L-event chunks, with a full-carry checkpoint every
    ``ckpt_every`` events through `_AsyncSaver`: the replay's carry (the
    weights, the ring, the guard counter), the stream state and statistics,
    the per-slot dispatch-time scales, p and ``cumsum(p)``, the dispatch
    CDF the chunk's K are drawn from.  ``key`` is an int seed: chunk c's
    uniforms come from a generator seeded by ``chunk_seed(key, c)`` on w0's
    device.  ``draws = (nodes, chunk_draws)`` replaces them (the initial
    placement and ``chunk_draws(c, Lc) -> (u_race, u_exp, u_disp)``), so a
    parity test can pass the reference's ``fold_in`` draws.  Returns
    ``(w_final, evals, extras)``.  ``resume=True`` restores the latest
    checkpoint under ``ckpt_dir`` (config-fingerprint validated) and goes
    on; kill-and-resume is bitwise the uninterrupted call.  ``serving`` (a
    `serving.ServingConfig`, per event) merges the serving plane as the
    fused runner does; its `ServeState` and `ServeStats` ride in the
    checkpointed carry, its configuration in the fingerprint, and
    ``extras`` gains the ``serve_*`` counters.  Lanes and the cell axis are
    not taken (checkpoint each cell's run alone), nor the reference's
    ``unroll`` (`make_fused_runner` has none either).
    """
    from . import stream_device as sd
    from .theory import BoundConstants

    if weighting not in ("importance", "plain"):
        raise ValueError(weighting)
    if adaptive and refresh_every <= 0:
        raise ValueError("adaptive=True requires refresh_every > 0")
    E = max(int(block_size), 1)
    serving_on = serving is not None and serving.enabled
    if serving_on:
        serving.validate()
        if E > 1:
            raise ValueError("serving= requires block_size=1")
    faulty = sd._enabled(fault)
    guard_stale = guard is not None and int(guard.stale_cutoff) > 0
    importance = weighting == "importance"
    eval_on = eval_fn is not None and eval_every > 0
    L = _chunk_layout(T, ckpt_every, eval_every if eval_on else 0,
                      refresh_every if adaptive else 0)
    n_chunks, tail = T // L, T % L
    eval_stride = max(eval_every // L, 1) if eval_on else 0
    bound = bound if bound is not None else BoundConstants(C=C, T=T)

    dev = _tree_device(w0)
    pack, unpack, enc = _snapshot_codec(w0, snapshot_dtype)
    _require_flat_codec(unpack)
    tagged = faulty or serving_on  # flip and serve events carry the trash slot C
    replay = _FusedReplay(grad_fn, w0, C + 1 if (E > 1 or tagged) else C, pack, unpack, enc,
                          True, None, 0, E, n, C, 1, dev, guard)
    f32 = lambda a: torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a  # noqa: E731
                                    ).to(device=dev, dtype=torch.float32).reshape(1, -1)
    mu_t, p_t = f32(mu), f32(p0)
    eta_t = torch.full((), float(eta), dtype=torch.float32, device=dev)
    fr = sd.resolve_fault_rates(fault, n, dev) if faulty else None
    if draws is None:
        nodes, chunk_draws = _port_draws(key, n, C, p_t[0], init, dev)
    else:
        nodes, chunk_draws = draws
    nodes = torch.as_tensor(nodes).to(device=dev, dtype=torch.int64).reshape(1, C)
    sstate0, _ = sd.stream_init(nodes, n, C, fault=faulty)
    stats0 = sd.stats_init(n, C, fault=faulty, cells=1, device=dev)
    slot_scale0 = (_slot_scales(eta_t, n, p_t, nodes, tagged) if importance
                   else eta_t.expand(1, C + tagged).clone())
    carry0 = (replay.carry, sstate0, stats0, slot_scale0, p_t, torch.cumsum(p_t, dim=-1))
    if serving_on:
        from .serving import ServeLoop, serve_init, serve_stats_init

        # the serving state and counters ride in the checkpointed carry
        carry0 = carry0 + (serve_init(serving, cells=1, device=dev),
                           serve_stats_init(cells=1, device=dev))
    cst = sd._Consts((1,), C, dev, n=n)

    fingerprint = _fingerprint("fused", dict(
        n=n, C=C, T=T, L=L, ckpt_every=ckpt_every, weighting=weighting,
        eval_every=eval_every if eval_on else 0, adaptive=adaptive,
        refresh_every=refresh_every, init=init, block_size=E,
        snapshot_dtype=str(snapshot_dtype),
        fault=fault.cache_key() if faulty else None, guard=_cache_key(guard),
        serving=serving.cache_key() if serving_on else None,
        key=None if draws is not None else int(key), given_draws=draws is not None,
        eta=float(eta), mu=_array_digest(mu_t.cpu().numpy()),
        p0=_array_digest(p_t.cpu().numpy()), ctrl=(float(ctrl_lr), int(ctrl_iters)),
    ))
    n_evals = T // eval_every if eval_on else 0
    carry, evals, cursor0 = carry0, _EvalBuffer(n_evals), 0
    if resume:
        like = {"carry": carry0, "evals": np.full(n_evals, np.nan, np.float32),
                "cursor": np.int64(0)}
        state, _ = _resume_state(ckpt_dir, like, fingerprint)
        carry = state["carry"]
        evals = _EvalBuffer(n_evals, restored=state["evals"])
        cursor0 = int(state["cursor"])

    def chunk(carry, c: int, Lc: int):
        ucarry, sstate, stats, slot_scale, p, cdf = carry[:6]
        serve = ServeLoop(serving, *carry[6:]) if serving_on else None
        replay.carry = ucarry
        ur, ue, ud = (torch.as_tensor(x).to(device=dev, dtype=torch.float32).reshape(1, Lc)
                      for x in chunk_draws(c, Lc))
        K = torch.clamp_max(torch.searchsorted(cdf, ud, right=True), n - 1)
        sstate, stats, slot_scale, _ = _advance_chunk(
            replay, sstate, stats, slot_scale if importance else None, p, mu_t,
            -torch.log1p(-ue), ur, K, c * L, cst, eta_t=eta_t, n=n, need_stats=True, fr=fr,
            guard_stale=guard_stale, serve=serve)
        if not importance:
            slot_scale = carry[3]
        if adaptive:
            p = sd.ctrl_refresh(p, stats.comp, stats.busy_t, bound, lr=ctrl_lr, iters=ctrl_iters)
            cdf = torch.cumsum(p, dim=-1)
        out = (replay.carry, sstate, stats, slot_scale, p, cdf)
        return out + (serve.sv, serve.stats) if serving_on else out

    saver = _AsyncSaver(ckpt_dir, fingerprint, keep)
    try:
        for c in range(cursor0 // L, n_chunks):
            carry = chunk(carry, c, L)
            if eval_on and (c + 1) % eval_stride == 0:
                evals.put((c + 1) // eval_stride - 1, eval_fn(replay.to_tree(carry[0][0])))
            done = (c + 1) * L
            if done % ckpt_every == 0 and done < T:
                saver.put(done, carry, evals.buf)
        if tail and cursor0 < T:  # cursor0 == T: resumed from the final save
            carry = chunk(carry, n_chunks, tail)
        saver.put(T, carry, evals.buf)  # a later resume returns from here
        saver.close()
    finally:
        saver.abort()

    ucarry, sstate, stats, _, p, _ = carry[:6]
    extras = {"p_final": p[0], "comp": stats.comp[0], "busy_time": stats.busy_t[0],
              "delay_sum": stats.delay_sum[0], "t_final": sstate.t[0]}
    if guard is not None:
        extras["guard_rejects"], extras["stale_drops"] = ucarry[3][0], ucarry[3][1]
    if faulty:
        extras.update(kind_count=stats.kind_count[0], avail_time=stats.avail_tw[0])
    if serving_on:
        extras.update({k: v[0] for k, v in ServeLoop(serving, *carry[6:]).extras(sstate.t).items()})
    return (replay.to_tree(ucarry[0]), torch.as_tensor(evals.curve(), device=dev), extras)


class _Checkpoints:
    """The checkpoint hook a runner's loop calls (``run(..., ckpt=)``).

    ``start(carry0)`` returns the carry, eval curve (a list of 0-d
    tensors) and loop position to start from: ``carry0``, [] and 0, or on
    ``resume`` the latest checkpoint's.  ``after(pos, carry, evals)`` runs
    after each loop position (an event per event, a block row blocked) and
    saves at the positions ``saves_at`` maps to their event cursors;
    ``end(carry, evals)`` saves the final carry at ``end_cursor``.
    ``pos_of`` maps a restored event cursor back to its loop position.
    """

    def __init__(self, saver: _AsyncSaver, ckpt_dir: str, fingerprint: str, n_evals: int,
                 saves_at: dict, end_cursor: int, pos_of, resume: bool):
        self.saver, self.dir, self.fp, self.n_evals = saver, ckpt_dir, fingerprint, n_evals
        self.saves_at, self.end_cursor, self.pos_of, self.resume = (saves_at, end_cursor,
                                                                    pos_of, resume)

    def start(self, carry0):
        if not self.resume:
            return carry0, [], 0
        like = {"carry": carry0, "evals": np.full(self.n_evals, np.nan, np.float32),
                "cursor": np.int64(0)}
        state, _ = _resume_state(self.dir, like, self.fp)
        dev = carry0[1].device
        done = _EvalBuffer(self.n_evals, restored=state["evals"]).curve()
        return (state["carry"], [torch.tensor(v, device=dev) for v in done],
                self.pos_of(int(state["cursor"])))

    def _curve(self, evals) -> np.ndarray:
        buf = _EvalBuffer(self.n_evals)
        for i, v in enumerate(evals):
            buf.put(i, v)
        return buf.buf

    def after(self, pos: int, carry, evals) -> None:
        cursor = self.saves_at.get(pos)
        if cursor is not None:
            self.saver.put(cursor, carry, self._curve(evals))

    def end(self, carry, evals) -> None:
        self.saver.put(self.end_cursor, carry, self._curve(evals))


def _run_with_checkpoints(run, args: tuple, kwargs: dict, ckpt_dir: str, fingerprint: str,
                          keep: int, **hook):
    """``run(*args, ckpt=_Checkpoints(...), **kwargs)`` with one background
    writer, closed (final checkpoint on disk, write errors raised) before
    returning and reaped on any error.  The curve comes back in float32,
    the dtype a checkpoint stores it in, whether resumed or not."""
    saver = _AsyncSaver(ckpt_dir, fingerprint, keep)
    try:
        out = run(*args, ckpt=_Checkpoints(saver, ckpt_dir, fingerprint, **hook), **kwargs)
        saver.close()
    finally:
        saver.abort()
    return (out[0], out[1].to(torch.float32)) + tuple(out[2:])


def _tree_device(w0) -> torch.device:
    x = tree_flatten(w0)[0][0]
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


# ------------------------------------------------------------------ #
# host-replay checkpointed drivers
# ------------------------------------------------------------------ #
def run_checkpointed_host(
    grad_fn,
    C: int,
    w0,
    J,
    slot,
    scale,
    *,
    ckpt_dir: str,
    ckpt_every: int,
    eval_fn=None,
    eval_every: int = 0,
    fedbuff_Z: int = 0,
    update_fn=None,
    snapshot_dtype=None,
    guard: GuardConfig | None = None,
    resume: bool = False,
    keep: int = 3,
):
    """Checkpointed per-event host replay: `engine_scan._make_host_runner`'s
    loop on w0's device, with a full-carry checkpoint every ``ckpt_every``
    events.

    Takes the pre-simulated ``(J, slot, scale)`` event arrays (numpy or
    tensors).  Returns ``(w_final, evals)`` (+ the guard counter when
    ``guard``), bitwise the un-checkpointed runner's (the curve in
    float32).
    """
    J_h = _host_array(J, np.int32)
    slot_h = _host_array(slot, np.int32)
    scale_h = _host_array(scale, np.float32)
    T = int(J_h.shape[0])
    eval_on = eval_fn is not None and eval_every > 0
    L = _chunk_layout(T, ckpt_every, eval_every if eval_on else 0)
    fingerprint = _fingerprint("host", dict(
        C=C, T=T, L=L, ckpt_every=ckpt_every, fedbuff_Z=fedbuff_Z,
        eval_every=eval_every if eval_on else 0, snapshot_dtype=str(snapshot_dtype),
        guard=_cache_key(guard), stream=_array_digest(J_h, slot_h, scale_h),
    ))
    dev = _tree_device(w0)
    idx = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)  # noqa: E731
    run = _make_host_runner(grad_fn, C, fedbuff_Z=fedbuff_Z, eval_fn=eval_fn,
                            eval_every=eval_every if eval_on else 0, update_fn=update_fn,
                            snapshot_dtype=snapshot_dtype, guard=guard)
    return _run_with_checkpoints(
        run, (w0, idx(J_h), idx(slot_h), torch.as_tensor(scale_h, device=dev)), {},
        ckpt_dir, fingerprint, keep, n_evals=T // eval_every if eval_on else 0,
        saves_at={c: c for c in range(ckpt_every, T, ckpt_every)}, end_cursor=T,
        pos_of=lambda cursor: cursor, resume=resume)


def run_checkpointed_host_blocked(
    grad_fn,
    C: int,
    block_size: int,
    w0,
    J,
    slot,
    scale,
    k,
    mask,
    *,
    group_events: int,
    chunk_blocks: int,
    n_chunks: int,
    ckpt_dir: str,
    ckpt_every: int,
    eval_fn=None,
    kernel: str = "jnp",
    snapshot_dtype=None,
    fedbuff_Z: int = 0,
    guard: GuardConfig | None = None,
    resume: bool = False,
    keep: int = 3,
):
    """Checkpointed blocked host replay: `engine_scan._make_host_block_runner`'s
    loop (unsharded) on w0's device.

    Consumes the grouped blocked layout of `engine_scan.blocked_inputs`
    (``eval_every=group_events``): each group of ``chunk_blocks`` rows
    covers exactly ``group_events`` events (the conflict-free cut
    guarantees it), giving exact event cursors for the checkpoint cadence,
    so ``ckpt_every`` must be a multiple of ``group_events``.  Trailing
    rows past the last group replay before the final save.  With
    ``eval_fn`` the eval fires at every group boundary.  Returns
    ``(w_final, evals)`` (+ the guard counter when ``guard``), bitwise the
    un-checkpointed runner's (the curve in float32).
    """
    if block_size < 2:
        raise ValueError("use run_checkpointed_host for block_size <= 1")
    if n_chunks < 1 or chunk_blocks < 1:
        raise ValueError(
            "the blocked checkpoint driver needs the grouped layout: pass "
            "blocked_inputs(blocks, scale, eval_every=group_events) arrays"
        )
    if ckpt_every <= 0 or ckpt_every % group_events:
        raise ValueError("ckpt_every must be a positive multiple of group_events")
    J_h = _host_array(J, np.int32)
    slot_h = _host_array(slot, np.int32)
    scale_h = _host_array(scale, np.float32)
    k_h = _host_array(k, np.int32)
    mask_h = _host_array(mask, bool)
    fingerprint = _fingerprint("host_blocked", dict(
        C=C, E=block_size, group_events=group_events, ckpt_every=ckpt_every,
        chunk_blocks=chunk_blocks, n_chunks=n_chunks, kernel=kernel,
        fedbuff_Z=fedbuff_Z, snapshot_dtype=str(snapshot_dtype), guard=_cache_key(guard),
        stream=_array_digest(J_h, slot_h, scale_h, k_h, mask_h),
    ))
    # the grouped layout's tail rows sit past the last exact event cursor;
    # count their real (unmasked) events so the final cursor is unambiguous
    rows = int(J_h.shape[0])
    Bm = n_chunks * chunk_blocks
    total = n_chunks * group_events
    total_all = total + (int(mask_h[Bm:].sum()) if Bm < rows else 0)
    saves_at = {(g + 1) * chunk_blocks: (g + 1) * group_events for g in range(n_chunks)
                if (g + 1) * group_events % ckpt_every == 0 and (g + 1) * group_events < total_all}

    def pos_of(cursor: int) -> int:
        if cursor >= total_all:  # resumed from the final checkpoint
            return rows
        return min(cursor, total) // group_events * chunk_blocks

    dev = _tree_device(w0)
    idx = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)  # noqa: E731
    run = _make_host_block_runner(grad_fn, C, block_size, fedbuff_Z=fedbuff_Z, eval_fn=eval_fn,
                                  kernel=kernel, snapshot_dtype=snapshot_dtype, guard=guard)
    return _run_with_checkpoints(
        run, (w0, idx(J_h), idx(slot_h), torch.as_tensor(scale_h, device=dev), idx(k_h),
              torch.as_tensor(mask_h, device=dev)),
        dict(chunk_blocks=chunk_blocks, n_chunks=n_chunks), ckpt_dir, fingerprint, keep,
        n_evals=n_chunks if eval_fn is not None else 0, saves_at=saves_at,
        end_cursor=total_all, pos_of=pos_of, resume=resume)
