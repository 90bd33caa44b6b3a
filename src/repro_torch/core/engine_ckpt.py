"""Checkpointed host-replay drivers: kill-and-resume with a bitwise guarantee.

The counterpart of `repro.core.engine_ckpt`'s host half.  The replay
runners of `engine_scan` keep their whole state in memory — a SIGKILL loses
everything.  These drivers run the same runners' loops with a checkpoint
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

The fused device-stream driver (`run_checkpointed`) waits for checkpoints
on the device event stream (ROADMAP item 8).
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
from ..unported import unported
from .engine_scan import GuardConfig, _make_host_block_runner, _make_host_runner

__all__ = [
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


def _chunk_layout(T: int, ckpt_every: int, eval_every: int) -> int:
    """Chunk length L: eval and checkpoint both land on chunk boundaries,
    so L divides both cadences."""
    if ckpt_every <= 0:
        raise ValueError("ckpt_every > 0 required")
    L = min(ckpt_every, T)
    if eval_every:
        L = min(L, eval_every)
    for name, every in (("eval_every", eval_every), ("ckpt_every", ckpt_every)):
        if every and every % L:
            raise ValueError(
                f"{name}={every} must be a multiple of the chunk length {L} "
                "(eval/checkpoint cadences must nest)"
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


def run_checkpointed(*args, **kwargs):
    """The checkpointed fused (device-stream) engine: not ported yet."""
    raise unported("run_checkpointed (the checkpointed device-stream engine)", 8)


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
