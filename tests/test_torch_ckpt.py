"""PyTorch port, checkpointing: `repro_torch.ckpt` and the checkpointed
host-replay drivers of `repro_torch.core.engine_ckpt`, against the JAX
package.

Two layers, as `tests/test_ckpt.py`:

1. the codec: round trips of mixed-dtype tensor trees (bf16 as its uint16
   bits, bitwise on adversarial patterns), rotation and metadata, and files
   that cross over: a tree saved by either package is restored bitwise by
   the other;
2. resume: truncating the checkpoint directory to an intermediate step
   and re-running with ``resume=True`` reproduces the uninterrupted run
   bitwise (per event fp32 and bf16 ring, blocked), the uninterrupted run
   is bitwise the un-checkpointed runner's, a SIGKILLed child process
   resumes the same way, and the background writer copes with failures.
   The port's drivers are held to the JAX drivers on the same event
   arrays (<= 1e-5).
"""
import os
import shutil
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ckpt import checkpoint as j_ck  # noqa: E402
from repro.core import GuardConfig as JGuardConfig  # noqa: E402
from repro.core import run_checkpointed_host as j_run_host  # noqa: E402
from repro.core import run_checkpointed_host_blocked as j_run_host_blocked  # noqa: E402
from repro_torch.ckpt import checkpoint as ck  # noqa: E402
from repro_torch.core import (  # noqa: E402
    EventBlocks,
    FaultConfig,
    GuardConfig,
    SimConfig,
    blocked_inputs,
    export_stream,
    jit_runner,
    run_checkpointed,
    run_checkpointed_host,
    run_checkpointed_host_blocked,
    step_scales,
)
from repro_torch.core import engine_ckpt as ec  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def _bits(tree) -> np.ndarray:
    """Every leaf as raw bytes, concatenated (the bitwise comparison)."""
    out = []
    for _, x in ck._paths(tree):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
            x = x.numpy()
        out.append(np.ascontiguousarray(np.asarray(x)).ravel().view(np.uint8))
    return np.concatenate(out)


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------


def test_roundtrip_mixed_dtypes(tmp_path):
    tree = {
        "f32": torch.linspace(-3.0, 7.0, 11),
        "bf16": torch.linspace(-2.0, 2.0, 9).to(torch.bfloat16),
        "i32": torch.arange(-4, 4, dtype=torch.int32),
        "nested": (torch.ones((2, 3)), {"u": torch.zeros(5, dtype=torch.int64)}, None),
        "np": np.arange(4, dtype=np.int64),
    }
    ck.save(str(tmp_path), 7, tree)
    like = {"f32": torch.zeros(11), "bf16": torch.zeros(9, dtype=torch.bfloat16),
            "i32": torch.zeros(8, dtype=torch.int32),
            "nested": (torch.zeros((2, 3)), {"u": torch.zeros(5, dtype=torch.int64)}, None),
            "np": np.zeros(4, np.int64)}
    back = ck.restore(str(tmp_path), 7, like)
    assert back["nested"][2] is None and isinstance(back["np"], np.ndarray)
    for (_, a), (_, b) in zip(ck._paths(tree), ck._paths(back)):
        assert type(a) is type(b) and a.dtype == b.dtype
    assert (_bits(tree) == _bits(back)).all()


def test_bf16_codec_is_bitwise_exact(tmp_path):
    # every exponent, NaN payloads, signed zeros: a float32 round trip would
    # normalize some of these; the uint16 view keeps them verbatim
    bits = np.arange(0, 1 << 16, 7, dtype=np.uint16)
    arr = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    ck.save(str(tmp_path), 1, {"x": arr})
    with open(tmp_path / "step_0000000001" / "meta.json") as f:
        assert '"x": "bfloat16"' in f.read()
    back = ck.restore(str(tmp_path), 1, {"x": torch.zeros_like(arr)})
    assert back["x"].dtype == torch.bfloat16
    assert (back["x"].view(torch.int16).numpy().view(np.uint16) == bits).all()


def test_rotation_latest_and_metadata(tmp_path):
    tree = {"x": torch.arange(3, dtype=torch.float32)}
    for s in (10, 20, 30, 40):
        ck.save(str(tmp_path), s, tree, metadata={"step": s, "tag": "t"}, keep=3)
    assert ck.available_steps(str(tmp_path)) == [20, 30, 40]
    assert ck.latest_step(str(tmp_path)) == 40
    meta = ck.load_metadata(str(tmp_path), 30)
    assert meta["step"] == 30 and meta["tag"] == "t"
    with pytest.raises(ValueError, match="tree mismatch"):
        ck.restore(str(tmp_path), 40, {"y": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore(str(tmp_path), 40, {"x": torch.zeros(4)})


_CROSS = dict(f32=np.linspace(-1.0, 3.0, 7, dtype=np.float32),
              i64=np.arange(-3, 5, dtype=np.int64),
              bf16=np.arange(0, 1 << 16, 331, dtype=np.uint16))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_files_cross_over_between_packages(tmp_path, writer):
    """A tree of fp32, int64 and bf16 leaves (nested under a tuple) saved by
    either package is restored bitwise by the other: same keys, same npz
    layout, bf16 as uint16 bits with "bfloat16" recorded."""
    f32, i64, b16 = _CROSS["f32"], _CROSS["i64"], _CROSS["bf16"]
    t_tree = {"w": (torch.tensor(f32), torch.tensor(i64)),
              "ring": torch.from_numpy(b16.view(np.int16).copy()).view(torch.bfloat16)}
    j_tree = {"w": (jnp.asarray(f32), np.asarray(i64)),
              "ring": jnp.asarray(b16).view(jnp.bfloat16)}
    d = str(tmp_path)
    if writer == "jax":
        j_ck.save(d, 3, j_tree, metadata={"by": "jax"})
        back = ck.restore(d, 3, {"w": (torch.zeros(7), torch.zeros(8, dtype=torch.int64)),
                                 "ring": torch.zeros(b16.size, dtype=torch.bfloat16)})
        assert ck.load_metadata(d, 3) == {"by": "jax"}
        assert (_bits(back) == _bits(t_tree)).all()
    else:
        ck.save(d, 3, t_tree, metadata={"by": "torch"})
        back = j_ck.restore(d, 3, {"w": (jnp.zeros(7, jnp.float32), np.zeros(8, np.int64)),
                                   "ring": jnp.zeros(b16.size, jnp.bfloat16)})
        assert j_ck.load_metadata(d, 3) == {"by": "torch"}
        assert np.asarray(back["ring"]).dtype == np.asarray(j_tree["ring"]).dtype
        np.testing.assert_array_equal(np.asarray(back["ring"]).view(np.uint16), b16)
        np.testing.assert_array_equal(np.asarray(back["w"][0]), f32)
        np.testing.assert_array_equal(np.asarray(back["w"][1]), i64)
        assert np.asarray(back["w"][1]).dtype == np.int64


# ---------------------------------------------------------------------------
# truncate-and-resume bitwise across the host paths
# ---------------------------------------------------------------------------

_N, _C, _T = 8, 4, 200
_MU = np.linspace(0.5, 2.0, _N).astype(np.float32)
_P = np.full(_N, 1 / _N, np.float32)
_TARG = torch.arange(_N, dtype=torch.float32)
_FAULT = dict(off_rate=0.3, on_rate=1.0, crash_rate=0.1, timeout_rate=0.2)
_GUARD = dict(max_grad_norm=100.0)


def _w0():
    return {"a": torch.zeros(6), "b": torch.ones(3)}


def _grad(j, w, k):
    t = _TARG.index_select(0, j.reshape(1))[0]
    return {key: x - t for key, x in w.items()}


def _loss(w):
    return sum(torch.sum(x ** 2) for x in w.values())


def _j_grad(j, w, k):
    return jax.tree_util.tree_map(lambda x: x - jnp.arange(_N, dtype=jnp.float32)[j], w)


def _j_loss(w):
    return sum(jnp.sum(x ** 2) for x in jax.tree_util.tree_leaves(w))


def _truncate(d, keep_step):
    for s in ck.available_steps(d):
        if s > keep_step:
            shutil.rmtree(os.path.join(d, f"step_{s:010d}"))


def _host_arrays():
    cfg = SimConfig(mu=_MU, p=_P, C=_C, T=_T, seed=5, fault=FaultConfig(**_FAULT))
    stream = export_stream(cfg)
    return stream, step_scales(stream, 0.05, _P, "importance")


def _blocked_arrays(E=8, every=50):
    stream, scale = _host_arrays()
    blocks = EventBlocks.from_stream(stream, E, cut_every=every)
    return blocked_inputs(blocks, scale, eval_every=every)


def _run_host(d, resume, snapshot_dtype=None, **kw):
    stream, scale = _host_arrays()
    return run_checkpointed_host(
        _grad, _C, _w0(), stream.J, stream.slot, scale, ckpt_dir=d, ckpt_every=50,
        eval_fn=_loss, eval_every=25, guard=GuardConfig(**_GUARD),
        snapshot_dtype=snapshot_dtype, resume=resume, **kw)


def _run_host_blocked(d, resume, kernel="jnp"):
    J, slot, sc, k, mask, cb, nc = _blocked_arrays()
    return run_checkpointed_host_blocked(
        _grad, _C, 8, _w0(), J, slot, sc, k, mask, group_events=50, chunk_blocks=cb,
        n_chunks=nc, ckpt_dir=d, ckpt_every=50, eval_fn=_loss, kernel=kernel,
        guard=GuardConfig(**_GUARD), resume=resume)


_PATHS = {
    "host_f32": lambda d, r: _run_host(d, r),
    "host_bf16": lambda d, r: _run_host(d, r, snapshot_dtype="bfloat16"),
    "host_blocked": _run_host_blocked,
    "host_blocked_pallas": lambda d, r: _run_host_blocked(d, r, kernel="pallas"),
}


@pytest.mark.parametrize("path", sorted(_PATHS))
def test_truncate_and_resume_bitwise(tmp_path, path):
    run = _PATHS[path]
    d = str(tmp_path / path)
    full = run(d, False)
    assert ck.available_steps(d) == [100, 150, 200]  # keep=3 of 50, ..., 200
    _truncate(d, 100)
    res = run(d, True)
    assert (_bits(full[0]) == _bits(res[0])).all()
    n_evals = 4 if "blocked" in path else 8  # every group of 50 / every 25 events
    assert full[1].shape == res[1].shape == (n_evals,) and torch.equal(full[1], res[1])
    assert torch.equal(full[2], res[2])


def test_checkpointed_runs_equal_the_runners_bitwise(tmp_path):
    """The uninterrupted checkpointed run is bitwise the un-checkpointed
    runner's on the same arrays (per event; blocked on the grouped layout),
    weights, eval curve and guard counter."""
    stream, scale = _host_arrays()
    guard = GuardConfig(**_GUARD)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    i64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64)  # noqa: E731
    w, ev, g = jit_runner(_grad, _C, eval_fn=_loss, eval_every=25, guard=guard)(
        _w0(), i64(stream.J), i64(stream.slot), f32(scale))
    wc, evc, gc = _run_host(str(tmp_path / "pe"), False)
    assert (_bits(w) == _bits(wc)).all() and torch.equal(ev, evc) and torch.equal(g, gc)
    J, slot, sc, k, mask, cb, nc = _blocked_arrays()
    w, ev, g = jit_runner(_grad, _C, eval_fn=_loss, block_size=8, guard=guard)(
        _w0(), i64(J), i64(slot), f32(sc), i64(k), torch.as_tensor(mask),
        chunk_blocks=cb, n_chunks=nc)
    wc, evc, gc = _run_host_blocked(str(tmp_path / "bl"), False)
    assert (_bits(w) == _bits(wc)).all() and torch.equal(ev, evc) and torch.equal(g, gc)


@pytest.mark.parametrize("blocked", [False, True])
def test_checkpointed_drivers_match_jax(tmp_path, blocked):
    """The port's checkpointed drivers against the JAX drivers on the same
    event arrays: weights and curve within 1e-5, equal guard counters."""
    guard = JGuardConfig(**_GUARD)
    w0 = {"a": jnp.zeros(6, jnp.float32), "b": jnp.ones(3, jnp.float32)}
    if blocked:
        out = _run_host_blocked(str(tmp_path / "t"), False)
        J, slot, sc, k, mask, cb, nc = _blocked_arrays()
        jout = j_run_host_blocked(_j_grad, _C, 8, w0, J, slot, sc, k, mask, group_events=50,
                                  chunk_blocks=cb, n_chunks=nc, ckpt_dir=str(tmp_path / "j"),
                                  ckpt_every=50, eval_fn=_j_loss, guard=guard)
    else:
        out = _run_host(str(tmp_path / "t"), False)
        stream, scale = _host_arrays()
        jout = j_run_host(_j_grad, _C, w0, stream.J, stream.slot, scale,
                          ckpt_dir=str(tmp_path / "j"), ckpt_every=50, eval_fn=_j_loss,
                          eval_every=25, guard=guard)
    for key in ("a", "b"):
        np.testing.assert_allclose(out[0][key].numpy(), np.asarray(jout[0][key]), atol=1e-5)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(jout[1]), rtol=1e-5)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(jout[2]))


def test_resume_from_final_checkpoint_is_noop(tmp_path):
    d = str(tmp_path / "final")
    full = _run_host(d, False, snapshot_dtype="bfloat16")
    res = _run_host(d, True, snapshot_dtype="bfloat16")
    assert (_bits(full[0]) == _bits(res[0])).all() and torch.equal(full[1], res[1])


def test_resume_fingerprint_mismatch_raises(tmp_path):
    d = str(tmp_path / "fp")
    stream, scale = _host_arrays()
    kwargs = dict(ckpt_dir=d, ckpt_every=50, eval_fn=_loss, eval_every=25,
                  snapshot_dtype="bfloat16")
    run_checkpointed_host(_grad, _C, _w0(), stream.J, stream.slot, scale,
                          guard=GuardConfig(max_grad_norm=100.0), **kwargs)
    with pytest.raises(ValueError, match="fingerprint"):
        run_checkpointed_host(_grad, _C, _w0(), stream.J, stream.slot, scale,
                              guard=GuardConfig(max_grad_norm=99.0), resume=True, **kwargs)
    with pytest.raises(FileNotFoundError):
        run_checkpointed_host(_grad, _C, _w0(), stream.J, stream.slot, scale,
                              guard=GuardConfig(max_grad_norm=100.0), resume=True,
                              **dict(kwargs, ckpt_dir=str(tmp_path / "empty")))


def test_layout_errors_and_the_fused_driver():
    stream, scale = _host_arrays()
    with pytest.raises(ValueError, match="multiple of the chunk length"):
        run_checkpointed_host(_grad, _C, _w0(), stream.J, stream.slot, scale,
                              ckpt_dir="unused", ckpt_every=50, eval_fn=_loss, eval_every=30)
    J, slot, sc, k, mask, cb, nc = _blocked_arrays()
    with pytest.raises(ValueError, match="multiple of group_events"):
        run_checkpointed_host_blocked(_grad, _C, 8, _w0(), J, slot, sc, k, mask,
                                      group_events=50, chunk_blocks=cb, n_chunks=nc,
                                      ckpt_dir="unused", ckpt_every=75)
    with pytest.raises(ValueError, match="multiple of the chunk length"):
        run_checkpointed(_grad, _N, _C, _T, w0=_w0(), mu=np.ones(_N), p0=np.full(_N, 1 / _N),
                         key=0, eta=0.05, ckpt_dir="unused", ckpt_every=50, eval_fn=_loss,
                         eval_every=30)


def test_run_experiment_resume_bitwise(tmp_path):
    """The entry point: a checkpointed MLP run with faults and the guard,
    truncated and resumed, gives the same final weights and curve."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.fl.engine import run_experiment

    flc = FLConfig(n_clients=8, concurrency=4, server_steps=120, seed=1, engine="scan",
                   device="cpu")
    kw = dict(eval_every=60, faults=FaultConfig(off_rate=0.2, on_rate=1.0, crash_rate=0.05,
                                                timeout_rate=0.1),
              guard=GuardConfig(max_grad_norm=1e3, stale_cutoff=80),
              ckpt_dir=str(tmp_path / "fl"), ckpt_every=60)
    r1 = run_experiment(flc, "gen_async", **kw)
    r0 = run_experiment(flc, "gen_async", **dict(kw, ckpt_dir=None, ckpt_every=0))
    assert (_bits(r1.final_params) == _bits(r0.final_params)).all()
    assert r1.extras["kind_count"].sum() == 120
    _truncate(kw["ckpt_dir"], 60)
    r2 = run_experiment(flc, "gen_async", resume=True, **kw)
    assert (_bits(r1.final_params) == _bits(r2.final_params)).all()
    np.testing.assert_array_equal(r1.eval_acc, r2.eval_acc)
    assert r1.extras["guard_rejects"] == r2.extras["guard_rejects"]


@pytest.mark.parametrize("ckpt", [False, True])
def test_per_event_snapshot_dtype_same_with_and_without_checkpoints(tmp_path, ckpt):
    """``snapshot_dtype="bfloat16"`` on the per-event host replay follows
    the reference path by path.  Without checkpoints `repro`'s `_run_scan`
    does not pass it to the runner, so the ring stays in the weights'
    dtype: the port's run equals the reference's (<= 1e-5) and is bitwise
    its own fp32-ring run.  With checkpoints both packages store a bf16 ring
    (`run_checkpointed_host`): the port's run equals the reference driver's
    on the same stream (<= 1e-5)."""
    from types import SimpleNamespace

    from repro.core import FaultConfig as JFaultConfig
    from repro.core import ServerConfig as JServerConfig
    from repro.core import run_generalized_async_sgd as j_run
    from repro_torch.core import ServerConfig, run_generalized_async_sgd

    cfg = ServerConfig(n=_N, C=_C, T=_T, eta=0.05, mu=_MU, p=_P, seed=5, eval_every=50,
                       engine="scan", faults=FaultConfig(**_FAULT), snapshot_dtype="bfloat16",
                       device="cpu")
    src = SimpleNamespace(device_grad=_grad)
    run = lambda c: run_generalized_async_sgd(_w0(), src, c, eval_fn=_loss)  # noqa: E731
    jw0 = {"a": jnp.zeros(6), "b": jnp.ones(3)}
    if not ckpt:
        w, tr = run(cfg)
        jcfg = JServerConfig(n=_N, C=_C, T=_T, eta=0.05, mu=_MU, p=_P, seed=5, eval_every=50,
                             engine="scan", faults=JFaultConfig(**_FAULT),
                             snapshot_dtype="bfloat16")
        wj, trj = j_run(jw0, SimpleNamespace(device_grad=_j_grad), jcfg, eval_fn=_j_loss)
        w32, _ = run(ServerConfig(**{**cfg.__dict__, "snapshot_dtype": None}))
        assert (_bits(w) == _bits(w32)).all()
    else:
        w, tr = run(ServerConfig(**{**cfg.__dict__, "ckpt_dir": str(tmp_path / "pe"),
                                    "ckpt_every": 50}))
        stream, scale = _host_arrays()
        wj, ej = j_run_host(_j_grad, _C, jw0, stream.J, stream.slot, scale,
                            ckpt_dir=str(tmp_path / "j"), ckpt_every=50, eval_fn=_j_loss,
                            eval_every=50, snapshot_dtype="bfloat16")
        trj = SimpleNamespace(eval_values=[float(v) for v in np.asarray(ej)])
    for key in ("a", "b"):
        np.testing.assert_allclose(w[key].numpy(), np.asarray(wj[key]), atol=1e-5)
    np.testing.assert_allclose(tr.eval_values, trj.eval_values, rtol=1e-5)


# ---------------------------------------------------------------------------
# the background writer (_AsyncSaver)
# ---------------------------------------------------------------------------


def test_async_saver_unwritable_dir_raises_and_reaps(tmp_path, monkeypatch):
    """A write failure (injected at the save layer: the suite may run as
    root, which chmod does not stop) surfaces at the next put or at close,
    and the driver reaps the writer thread."""
    import threading

    def boom(*a, **k):
        raise OSError(30, "Read-only file system")

    monkeypatch.setattr(ec, "_save_state", boom)
    before = threading.active_count()
    with pytest.raises(OSError, match="Read-only file system"):
        _run_host(str(tmp_path / "ro"), False)
    assert threading.active_count() == before  # no leaked writer thread


def test_async_saver_abort_idempotent(tmp_path, monkeypatch):
    import time

    def boom(*a, **k):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(ec, "_save_state", boom)
    saver = ec._AsyncSaver(str(tmp_path), "fp", keep=2)
    saver.put(1, {"x": np.zeros(2)}, np.zeros(1))
    for _ in range(200):  # wait for the worker to capture the failure
        if saver._err is not None:
            break
        time.sleep(0.01)
    assert saver._err is not None
    with pytest.raises(OSError, match="No space left"):
        saver.put(2, {"x": np.zeros(2)}, np.zeros(1))
    assert not saver._worker.is_alive()  # put() reaped it before raising
    saver.abort()  # idempotent after the reap
    saver.abort()
    with pytest.raises(OSError, match="No space left"):
        saver.close()  # close still surfaces the captured error


def test_saved_carry_is_a_copy_taken_at_put(tmp_path, monkeypatch):
    """Tensors are mutable: a ring written in place right after `put` (as
    the next chunk's K2 or ``index_copy_`` does) leaves the checkpoint with
    the values it had at `put`."""
    import threading

    gate = threading.Event()
    real = ec._save_state

    def slow_save(*a, **k):
        gate.wait(5.0)  # the write starts only after the ring has changed
        return real(*a, **k)

    monkeypatch.setattr(ec, "_save_state", slow_save)
    ring = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    w = torch.ones(4)
    ec.reset_saves()
    saver = ec._AsyncSaver(str(tmp_path), "fp", keep=2)
    saver.put(5, (w, ring, None, torch.zeros(2, dtype=torch.int32)), np.zeros(1, np.float32))
    ring.index_copy_(0, torch.tensor([1]), torch.full((1, 4), -7.0))
    w.mul_(3.0)
    gate.set()
    saver.close()
    like = {"carry": (torch.zeros(4), torch.zeros(3, 4), None, torch.zeros(2, dtype=torch.int32)),
            "evals": np.zeros(1, np.float32), "cursor": np.int64(0)}
    back = ck.restore(str(tmp_path), 5, like)
    assert torch.equal(back["carry"][1], torch.arange(12, dtype=torch.float32).reshape(3, 4))
    assert torch.equal(back["carry"][0], torch.ones(4)) and int(back["cursor"]) == 5
    (stat,) = ec.saves
    assert stat["step"] == 5 and stat["bytes"] == 16 + 48 + 8 + 4
    assert stat["file_bytes"] > stat["bytes"]


# ---------------------------------------------------------------------------
# kill and resume: a child process SIGKILLs itself after its second save
# ---------------------------------------------------------------------------

_CHILD = textwrap.dedent("""
    import os, signal, sys
    sys.path.insert(0, {src!r})
    import numpy as np, torch
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.core import (FaultConfig, GuardConfig, SimConfig, export_stream,
                                  run_checkpointed_host, step_scales)

    n_saves = [0]
    _orig_save = ck.save

    def killing_save(*args, **kwargs):
        out = _orig_save(*args, **kwargs)
        n_saves[0] += 1
        if n_saves[0] == 2:
            os.kill(os.getpid(), signal.SIGKILL)
        return out

    ck.save = killing_save
    targ = torch.arange(8, dtype=torch.float32)

    def grad(j, w, k):
        t = targ.index_select(0, j.reshape(1))[0]
        return {{key: x - t for key, x in w.items()}}

    p = np.full(8, 1 / 8, np.float32)
    stream = export_stream(SimConfig(
        mu=np.linspace(0.5, 2.0, 8).astype(np.float32), p=p, C=4, T=200, seed=5,
        fault=FaultConfig(off_rate=0.3, on_rate=1.0, crash_rate=0.1, timeout_rate=0.2)))
    run_checkpointed_host(
        grad, 4, {{"a": torch.zeros(6), "b": torch.ones(3)}}, stream.J, stream.slot,
        step_scales(stream, 0.05, p, "importance"), ckpt_dir=sys.argv[1], ckpt_every=50,
        guard=GuardConfig(max_grad_norm=100.0))
    raise SystemExit("child survived past the kill point")
""")


def test_sigkill_mid_run_then_resume_bitwise(tmp_path):
    d_kill = str(tmp_path / "killed")
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD.format(src=SRC), d_kill],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == -signal.SIGKILL, (proc.returncode, proc.stderr)
    steps = ck.available_steps(d_kill)
    assert steps and max(steps) < _T, steps  # died mid-run with real checkpoints

    def run(d, resume):
        stream, scale = _host_arrays()
        return run_checkpointed_host(_grad, _C, _w0(), stream.J, stream.slot, scale,
                                     ckpt_dir=d, ckpt_every=50, guard=GuardConfig(**_GUARD),
                                     resume=resume)

    resumed = run(d_kill, True)
    reference = run(str(tmp_path / "reference"), False)
    assert (_bits(resumed[0]) == _bits(reference[0])).all()
    assert torch.equal(resumed[2], reference[2])
