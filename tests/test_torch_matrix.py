"""PyTorch port, the scenario matrix on the host stream: `run_matrix`,
`MatrixResult`, `blocked_inputs_batch` and the replay engine's cell axis
(``jit_runner(..., vmap_streams=True)``), against the JAX package at MLP
hidden 32, n=16, C=4, T <= 200, and a Mamba2 smoke-config `LMTask` matrix.

Weights and minibatch window offsets are the JAX package's (`_pair` in
`tests/test_torch_fl.py`, `_tasks` in `tests/test_torch_lm.py`), so both
packages replay identical minibatches on identical event streams.  The JAX
kernels run in interpret mode.  Tolerances: eval accuracies within 2 of the
2048 eval samples, weights within 1e-4 of JAX (fp32 rounding of two
frameworks), a cell of the batched replay within 1e-6 of the port's own
single run of it (batched against unbatched matrix products), the Mamba2
matrix within `tests/test_torch_ssm.py`'s 1e-4.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs.base import FLConfig as JFLConfig  # noqa: E402
from repro.core import EventBlocks as JEventBlocks  # noqa: E402
from repro.core import blocked_inputs_batch as j_blocked_inputs_batch  # noqa: E402
from repro.core import export_stream as j_export_stream  # noqa: E402
from repro.core import jit_runner as j_jit_runner  # noqa: E402
from repro.core.queue_sim import SimConfig as JSimConfig  # noqa: E402
from repro.fl import engine as j_fl  # noqa: E402
from repro.kernels.weighted_update import tree_weighted_update as j_tree_update  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.core import (  # noqa: E402
    EventBlocks,
    SimConfig,
    blocked_inputs,
    blocked_inputs_batch,
    export_stream,
    jit_runner,
    step_scales,
)
from repro_torch.fl import MatrixResult  # noqa: E402
from repro_torch.fl import engine as t_fl  # noqa: E402
from repro_torch.kernels import weighted_update as wu  # noqa: E402
from repro_torch.kernels.ops import tree_weighted_update  # noqa: E402
from test_torch_fl import C, N, _pair  # noqa: E402

T, EVAL, ETA = 200, 50, 0.08
GRID = dict(seeds=(0, 1), policies=("uniform", "optimal"), speed_ratios=(1.0, 8.0))


def _cells():
    """Four cells (seeds 0, 1 x speed ratios 1, 8; "optimal" sampling) as
    `run_matrix` draws them: ``(mu, p, seed)`` each."""
    out = []
    for seed in (0, 1):
        for ratio in (1.0, 8.0):
            mu = t_fl.make_client_speeds(N, 0.5, ratio, seed=0)
            p = t_fl.sampling_for(FLConfig(n_clients=N, concurrency=C, server_steps=T), mu)
            out.append((mu, p, seed))
    return out


def _streams():
    """The four cells' event streams and step scales (the port's simulator,
    bitwise the reference's)."""
    out = []
    for mu, p, seed in _cells():
        es = export_stream(SimConfig(mu=mu, p=p, C=C, T=T, seed=seed))
        out.append((es, step_scales(es, ETA, p, "importance")))
    return out


@pytest.mark.parametrize("eval_every", [0, EVAL])
@pytest.mark.parametrize("E", [4, 8])
def test_blocked_inputs_batch_equals_jax(E, eval_every):
    streams = _streams()
    blocks = [EventBlocks.from_stream(es, E, cut_every=eval_every) for es, _ in streams]
    j_blocks = [JEventBlocks.from_stream(j_export_stream(JSimConfig(mu=mu, p=p, C=C, T=T,
                                                                    seed=seed)),
                                         E, cut_every=eval_every)
                for mu, p, seed in _cells()]
    scales = [s for _, s in streams]
    got = blocked_inputs_batch(blocks, scales, eval_every)
    want = j_blocked_inputs_batch(j_blocks, scales, eval_every)
    assert len(got) == len(want) == 7
    for a, b in zip(got[:5], want[:5]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got[5:] == want[5:]
    # the common layout holds each cell's T events; the rest is all-masked
    # no-op padding
    assert [int(m.sum()) for m in got[4]] == [T] * 4
    assert {int(blocked_inputs(b, s, eval_every)[4].sum()) for b, s in zip(blocks, scales)} == {T}


@pytest.mark.parametrize("block_size", [1, 4, "auto"])
def test_run_matrix_matches_jax(block_size):
    (j_data, j_task, _), (t_data, t_task, _) = _pair()
    kw = dict(n_clients=N, concurrency=C, server_steps=T)
    mk = dict(GRID, eta=ETA, eval_every=EVAL, block_size=block_size)
    mj = j_fl.run_matrix(JFLConfig(**kw), data=j_data, task=j_task, **mk)
    mt = t_fl.run_matrix(FLConfig(device="cpu", **kw), data=t_data, task=t_task, **mk)
    assert isinstance(mt, MatrixResult) and mt.extras == {"stream": "host"}
    assert (mt.seeds, mt.policies, mt.speed_ratios) == (mj.seeds, mj.policies, mj.speed_ratios)
    np.testing.assert_array_equal(mt.eval_steps, mj.eval_steps)
    np.testing.assert_array_equal(mt.eval_times, mj.eval_times)
    np.testing.assert_array_equal(mt.p_vectors, mj.p_vectors)
    assert mt.eval_acc.shape == mj.eval_acc.shape == (2, 2, 2, T // EVAL)
    assert mt.final_acc.shape == mj.final_acc.shape == (2, 2, 2)
    np.testing.assert_allclose(mt.eval_acc, mj.eval_acc, atol=2 / 2048)  # measured 0
    np.testing.assert_allclose(mt.final_acc, mj.final_acc, atol=2 / 2048)  # measured 0
    assert np.all(np.diff(mt.eval_times, axis=-1) >= 0)


def _stacked(E=1):
    """The four cells' replay inputs, stacked: per event (J, slot, scale),
    blocked (J, slot, scale, k, mask, chunk_blocks, n_chunks)."""
    streams = _streams()
    if E == 1:
        return (np.stack([es.J for es, _ in streams]), np.stack([es.slot for es, _ in streams]),
                np.stack([s for _, s in streams]).astype(np.float32))
    return blocked_inputs_batch([EventBlocks.from_stream(es, E, cut_every=EVAL)
                                 for es, _ in streams], [s for _, s in streams], EVAL)


def _t_args(arrays):
    idx = lambda a: torch.as_tensor(a, dtype=torch.int64)  # noqa: E731
    if len(arrays) == 3:
        J, slot, sc = arrays
        return (idx(J), idx(slot), torch.as_tensor(sc)), {}
    J, slot, sc, kb, mask, G, nc = arrays
    return ((idx(J), idx(slot), torch.as_tensor(sc), idx(kb), torch.as_tensor(mask)),
            dict(chunk_blocks=G, n_chunks=nc))


def _j_args(arrays):
    if len(arrays) == 3:
        return tuple(jnp.asarray(a) for a in arrays), {}
    *a, G, nc = arrays
    return tuple(jnp.asarray(x) for x in a), dict(chunk_blocks=G, n_chunks=nc)


def _gap(t_tree, j_tree):
    return max(float(np.abs(t_tree[k].numpy() - np.asarray(j_tree[k])).max()) for k in j_tree)


# (per-event update: None | "k1", blocked E, kernel)
RUNNERS = {
    "per_event": (None, 1, "jnp"),
    "per_event_k1": ("k1", 1, "jnp"),
    "blocked_jnp": (None, 4, "jnp"),
    "blocked_k2": (None, 4, "pallas"),
}


@pytest.mark.parametrize("case", sorted(RUNNERS))
def test_cell_axis_runner_matches_jax_vmap(case):
    """The port's lockstep replay against JAX's `jax.vmap`-ed runner on the
    same stacked arrays: per event (the flat update, and K1's path
    ``update_fn=tree_weighted_update`` with one scale a cell), blocked E=4
    with the plain update and with K2's path (``kernel="pallas"``: the plain
    version with a cell axis on the CPU; JAX's Pallas kernel batched by its
    vmap rule, interpret mode)."""
    update, E, kernel = RUNNERS[case]
    (_, _, j_setup), (_, _, setup) = _pair()
    arrays = _stacked(E)
    j_update = None if update is None else j_tree_update
    t_update = None if update is None else tree_weighted_update
    if E == 1:
        jr = j_jit_runner(j_setup.clients.device_grad, C, eval_fn=j_setup.eval_fn,
                          eval_every=EVAL, update_fn=j_update, vmap_streams=True)
        tr = jit_runner(setup.clients.device_grad, C, eval_fn=setup.eval_fn, eval_every=EVAL,
                        update_fn=t_update, vmap_streams=True)
    else:
        jr = j_jit_runner(j_setup.clients.device_grad, C, eval_fn=j_setup.eval_fn,
                          block_size=E, kernel=kernel, vmap_streams=True)
        tr = jit_runner(setup.clients.device_grad, C, eval_fn=setup.eval_fn, block_size=E,
                        kernel=kernel, vmap_streams=True)
    ja, jk = _j_args(arrays)
    ta, tk = _t_args(arrays)
    wu.reset_launches()
    w_t, ev_t = tr(setup.params, *ta, **tk)
    assert all(v == 0 for v in wu.launches.values())  # CPU tensors: the plain versions
    w_j, ev_j = jr(j_setup.params, *ja, **jk)
    assert ev_t.shape == ev_j.shape == (4, T // EVAL)
    assert all(w_t[k].shape == (4,) + tuple(setup.params[k].shape) for k in w_t)
    assert _gap(w_t, w_j) <= 1e-4  # measured <= 1.2e-7 in every case
    np.testing.assert_allclose(ev_t.numpy(), np.asarray(ev_j), atol=2 / 2048)  # measured 0


@pytest.mark.parametrize("E", [1, 4])
def test_each_cell_equals_its_single_run(E):
    """Each cell of the lockstep replay against the port's own single-stream
    replay of that cell (same runner factory, no cell axis)."""
    _, (_, _, setup) = _pair()
    arrays = _stacked(E)
    ta, tk = _t_args(arrays)
    kw = dict(eval_fn=setup.eval_fn, block_size=E)
    if E == 1:
        kw["eval_every"] = EVAL
    w_b, ev_b = jit_runner(setup.clients.device_grad, C, vmap_streams=True, **kw)(
        setup.params, *ta, **tk)
    single = jit_runner(setup.clients.device_grad, C, **kw)
    for i in range(4):
        w_i, ev_i = single(setup.params, *(a[i] for a in ta), **tk)
        assert max(float((w_b[k][i] - w_i[k]).abs().max()) for k in w_i) <= 1e-6  # measured 0
        assert torch.equal(ev_b[i], ev_i)


def test_one_runner_across_eval_cadences():
    """`tests/test_engine.py`'s memo test: sweeping the eval cadence over one
    dataset keeps one cached gradient source and one per-event runner."""
    flc = FLConfig(n_clients=8, concurrency=3, server_steps=60, device="cpu")
    data = t_fl.FederatedClassification(n_clients=8, seed=0)
    task = t_fl.ClassificationTask(hidden=16)
    for ev in (30, 20):
        m = t_fl.run_matrix(flc, seeds=(0,), policies=("uniform",), speed_ratios=(1.0,),
                            eval_every=ev, data=data, task=task)
        assert m.eval_acc.shape == (1, 1, 1, 60 // ev)
    (setup,) = data.__dict__["_fl_setup_cache"].values()
    host_keys = [k for k in setup.clients.__dict__["_scan_runner_cache"] if k[0] == "host"]
    assert len(host_keys) == 1


@pytest.mark.parametrize("kw,item", [
    (dict(stream="device"), None),
    (dict(flc=dict(adaptive=True)), None),
    (dict(scenario="erlang2", stream="device"), None),
    (dict(devices=2, block_size=4), "process group"),
])
def test_run_matrix_unported_raise(kw, item):
    """What the reference does with each: the device stream runs (its
    parity is in `tests/test_torch_fused.py`), and so does ``adaptive`` on
    the host stream, which the reference's host matrix ignores; a scenario
    runs on the host stream (`tests/test_torch_scenarios.py`) and on the
    device stream, per event (`tests/test_torch_stream_robust.py` holds it
    against the reference's); lanes run in a process group of their ranks
    (`tests/test_torch_shards.py`) and without one raise, never running
    unsharded."""
    kw = dict(kw)
    flc = FLConfig(n_clients=4, concurrency=2, server_steps=10, device="cpu",
                   **kw.pop("flc", {}))
    if item is None:
        m = t_fl.run_matrix(flc, seeds=(0,), policies=("uniform",), eval_every=5, **kw)
        assert m.eval_acc.shape == (1, 1, 1, 2) and np.isfinite(m.final_acc).all()
        assert m.extras["stream"] == kw.get("stream", "host")
        if kw.get("scenario") and kw.get("stream") == "device":
            assert m.extras["kind_count"].shape == (1, 1, 1, 6)
            assert int(m.extras["kind_count"].sum()) == 10
        return
    for stream in ("host", "device"):
        with pytest.raises(ValueError, match=item):
            t_fl.run_matrix(flc, seeds=(0,), policies=("uniform",), stream=stream, **kw)


def test_cell_axis_runner_guard_rails():
    """The cell axis's lanes need a process group of their ranks and
    raise the reference's `ValueError`s for a block they cannot split;
    FedBuff runs across cells (`tests/test_torch_cells_guard.py`), the
    blocked replay with the default update only."""
    _, (_, _, setup) = _pair()
    with pytest.raises(ValueError, match="process group"):
        jit_runner(setup.clients.device_grad, C, block_size=4, lane_devices=2, vmap_streams=True)
    for E, msg in ((1, "block_size > 1"), (3, "multiple of")):
        with pytest.raises(ValueError, match=msg):
            jit_runner(setup.clients.device_grad, C, fedbuff_Z=5, block_size=E, lane_devices=2,
                       vmap_streams=True)
    with pytest.raises(ValueError, match="default update"):
        jit_runner(setup.clients.device_grad, C, fedbuff_Z=5, block_size=4, vmap_streams=True,
                   update_fn=lambda w, g, s: w)


@pytest.mark.parametrize("block_size", [1, 4])
def test_mamba2_lm_matrix_matches_jax(block_size):
    """A two-cell `LMTask` matrix over the Mamba2 smoke config (K4's wrapper
    under ``use_pallas``: on the CPU its vmap rule folds the cells, and the
    cells x lanes when blocked, into one call of the plain version) against
    JAX's, eval loss carried in ``eval_acc``."""
    from test_torch_lm import N as LM_N
    from test_torch_lm import _tasks

    (j_task, _), (t_task, _) = _tasks(arch="mamba2-130m")
    kw = dict(n_clients=LM_N, concurrency=2, server_steps=8)
    mk = dict(seeds=(0,), policies=("uniform", "optimal"), speed_ratios=(4.0,), eval_every=4,
              block_size=block_size)
    mj = j_fl.run_matrix(JFLConfig(**kw), task=j_task, **mk)
    mt = t_fl.run_matrix(FLConfig(device="cpu", **kw), task=t_task, **mk)
    np.testing.assert_array_equal(mt.eval_times, mj.eval_times)
    assert mt.eval_acc.shape == mj.eval_acc.shape == (1, 2, 1, 2)
    np.testing.assert_allclose(mt.eval_acc, mj.eval_acc, atol=1e-4)  # measured <= 1.4e-6
    np.testing.assert_allclose(mt.final_acc, mj.final_acc, atol=1e-4)  # measured <= 9.5e-7
    assert np.all(np.isfinite(mt.eval_acc))


_FIRST_GRAD = """
import gc, torch
from repro_torch.data.pipeline import FederatedClassification
from repro_torch.fl.engine import _cached_fl_setup
setup = _cached_fl_setup(FederatedClassification(n_clients=4, seed=0), 0, None, device="cpu")
gc.collect()
gc.disable()
g = setup.clients.{call}
del g
gc.set_debug(gc.DEBUG_SAVEALL)
gc.collect()
print(sum(isinstance(o, torch.Tensor) for o in gc.garbage))
"""


@pytest.mark.parametrize("call", ["grad(1, setup.params, 0)",
                                  "device_grad(torch.tensor(1), setup.params, torch.tensor(0))"])
def test_first_gradient_leaves_no_tensor_in_a_cycle(call):
    """The first gradient of a fresh process frees its tensors by reference
    counting: none waits in a cycle for the collector (the lazy
    `torch._dynamo` import of the first `torch.func.grad` call made one
    that held the calling frames' tensors)."""
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", _FIRST_GRAD.format(call=call)],
                         capture_output=True, text=True, timeout=300, check=True,
                         env={"PYTHONPATH": str(src), "PATH": "/usr/bin:/bin"})
    assert out.stdout.strip().splitlines()[-1] == "0", out.stdout
