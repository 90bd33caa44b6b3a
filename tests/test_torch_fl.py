"""PyTorch port, the MLP slice: `run_experiment` and the kernel path against
the JAX package at hidden 32, n=16, C=4, T=300.

The JAX package draws its initial weights and minibatch window offsets
from `jax.random`; the port takes the same arrays (`params_from_numpy`,
``DeviceFLClients(starts=...)``), so both replay identical minibatches on
identical event streams.
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import FLConfig as JFLConfig  # noqa: E402
from repro.core import ServerConfig as JServerConfig  # noqa: E402
from repro.core import run_generalized_async_sgd as j_run  # noqa: E402
from repro.data.pipeline import FederatedClassification as JData  # noqa: E402
from repro.fl import engine as j_fl  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.core import ServerConfig, run_generalized_async_sgd  # noqa: E402
from repro_torch.data.pipeline import FederatedClassification  # noqa: E402
from repro_torch.fl import engine as t_fl  # noqa: E402

N, C, T, HIDDEN, EVAL = 16, 4, 300, 32, 100


def _pair():
    """The JAX run's cached setup and the port's setup built from its
    weights and window offsets, placed in the port's setup cache."""
    j_task, t_task = j_fl.ClassificationTask(hidden=HIDDEN), t_fl.ClassificationTask(hidden=HIDDEN)
    j_data = JData(n_clients=N, seed=0)
    j_setup = j_fl._cached_fl_setup(j_data, 0, j_task)
    t_data = FederatedClassification(n_clients=N, seed=0)
    model = t_fl.MLPClassifier(t_data.dim, t_data.num_classes, hidden=HIDDEN, device="cpu")
    setup = t_fl.TaskSetup(
        params=t_fl.params_from_numpy({k: np.asarray(v) for k, v in j_setup.params.items()},
                                      "cpu"),
        clients=t_fl.DeviceFLClients(t_data, model, starts=np.asarray(j_setup.clients._starts),
                                     device="cpu"),
        eval_fn=t_fl._accuracy_fn(model, t_data, device="cpu"),
        model=model,
    )
    t_data.__dict__.setdefault("_fl_setup_cache", {})[(0, t_task.cache_key())] = setup
    return (j_data, j_task, j_setup), (t_data, t_task, setup)


def _gap(t_params, j_params):
    return max(float(np.abs(t_params[k].numpy() - np.asarray(j_params[k])).max())
               for k in j_params)


@pytest.mark.parametrize("method", ["gen_async", "async_sgd"])
@pytest.mark.parametrize("block_size", [1, 4])
def test_run_experiment_matches_jax(method, block_size):
    (j_data, j_task, _), (t_data, t_task, _) = _pair()
    kw = dict(n_clients=N, concurrency=C, server_steps=T, engine="scan", block_size=block_size)
    rj = j_fl.run_experiment(JFLConfig(**kw), method, eval_every=EVAL, data=j_data, task=j_task)
    rt = t_fl.run_experiment(FLConfig(device="cpu", **kw), method, eval_every=EVAL,
                             data=t_data, task=t_task)
    assert _gap(rt.final_params, rj.final_params) <= 1e-4  # measured <= 1.2e-7
    np.testing.assert_array_equal(rt.eval_steps, rj.eval_steps)
    np.testing.assert_allclose(rt.eval_acc, rj.eval_acc, atol=2 / 2048)  # measured 0
    np.testing.assert_array_equal(rt.eval_times, rj.eval_times)
    assert rt.extras["engine"] == "scan"


def test_kernel_path_matches_jax_pallas():
    """``update="pallas", block_size=4`` through `run_generalized_async_sgd`
    against the JAX Pallas kernels in interpret mode."""
    (_, _, j_setup), (_, _, setup) = _pair()
    flc = JFLConfig(n_clients=N, concurrency=C, server_steps=T)
    mu = j_fl.make_client_speeds(N, flc.frac_fast, flc.speed_ratio, seed=0)
    p = j_fl.sampling_for(flc, mu)
    kw = dict(n=N, C=C, T=T, eta=0.05, mu=mu, p=p, eval_every=EVAL, engine="scan",
              update="pallas", block_size=4)
    w_j, tr_j = j_run(j_setup.params, j_setup.clients, JServerConfig(pallas_interpret=True, **kw),
                      eval_fn=j_setup.eval_fn)
    w_t, tr_t = run_generalized_async_sgd(setup.params, setup.clients,
                                          ServerConfig(device="cpu", **kw), eval_fn=setup.eval_fn)
    assert _gap(w_t, w_j) <= 1e-4  # measured 9e-8
    np.testing.assert_allclose(tr_t.eval_values, tr_j.eval_values, atol=2 / 2048)
    # the per-event kernel path reaches the same weights as the plain path
    w_pe, _ = run_generalized_async_sgd(setup.params, setup.clients,
                                        ServerConfig(device="cpu", **dict(kw, block_size=1)))
    w_pj, _ = run_generalized_async_sgd(
        setup.params, setup.clients, ServerConfig(device="cpu", **dict(kw, block_size=1, update="jnp")))
    assert max(float((w_pe[k] - w_pj[k]).abs().max()) for k in w_pe) <= 1e-5


def test_scan_matches_python_oracle():
    """The replay engine against the port's per-event Python loop on the same
    device gradient source (identical minibatches)."""
    _, (_, _, setup) = _pair()
    cfg = ServerConfig(n=N, C=C, T=150, eta=0.05, seed=0, device="cpu")
    w_py, _ = run_generalized_async_sgd(setup.params, setup.clients, cfg)
    w_sc, _ = run_generalized_async_sgd(setup.params, setup.clients, replace(cfg, engine="scan"))
    assert max(float((w_py[k] - w_sc[k]).abs().max()) for k in w_py) <= 1e-5


def test_python_engine_learns():
    flc = FLConfig(n_clients=N, concurrency=C, server_steps=200, device="cpu")
    r = t_fl.run_experiment(flc, "gen_async", eta=0.08, eval_every=100)
    assert r.extras["engine"] == "python" and r.extras["grad_calls"] == 200
    assert np.all(np.isfinite(r.eval_acc)) and r.eval_acc[-1] > 0.1


def test_pack_order_is_jax_leaf_order():
    from repro_torch.core.engine_scan import _snapshot_codec

    model = t_fl.MLPClassifier(8, 3, hidden=4, device="cpu")
    pack, unpack, _ = _snapshot_codec(model.init_params, pad_to=1024)
    flat = pack(model.init_params)
    assert flat.shape == (1024,)
    order = ["b1", "b2", "b3", "w1", "w2", "w3"]
    expect = torch.cat([model.init_params[k].reshape(-1) for k in order])
    np.testing.assert_array_equal(flat[: expect.numel()].numpy(), expect.numpy())
    back = unpack(flat)
    assert all(torch.equal(back[k], model.init_params[k]) for k in order)


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="cuda"):
        t_fl.run_experiment(FLConfig(n_clients=4, concurrency=2, server_steps=10), "gen_async")
    with pytest.raises(RuntimeError, match="cuda"):
        run_generalized_async_sgd(np.zeros(2, np.float32), None,
                                  ServerConfig(n=4, C=2, T=10, eta=0.1))
    with pytest.raises(RuntimeError, match="cuda"):
        t_fl.MLPClassifier(8, 3)


class _Duck:
    """A task that is neither `ClassificationTask` nor `LMTask`: what the
    reference's duck typing asks (``cache_key()``, ``build(data, seed,
    n_clients)``), its build wrapping another task's; keyword arguments
    (the port's ``device``) pass through."""

    def __init__(self, inner):
        self.inner = inner

    def cache_key(self):
        return ("duck",) + tuple(self.inner.cache_key())

    def build(self, data, seed, n_clients, **kw):
        return self.inner.build(data, seed, n_clients, **kw)


def _duck_runs_match_jax():
    """A duck-typed task through `run_experiment` (scan, per event and
    blocked) and `run_matrix` against the reference's with its own duck,
    the JAX weights carried into the port's setup under the duck's key;
    then a fresh duck on a fresh dataset, built through ``device=``."""
    (_, j_task, _), (t_data, t_task, setup) = _pair()
    jd, td = _Duck(j_task), _Duck(t_task)
    t_data.__dict__["_fl_setup_cache"][(0, td.cache_key())] = setup
    # a fresh dataset, so the duck's setup takes its first eval batch, as
    # the carried setup did (each `eval_batch` call draws the next one)
    j_data = JData(n_clients=N, seed=0)
    for E_ in (1, 4):
        fkw = dict(n_clients=N, concurrency=C, server_steps=T, engine="scan", block_size=E_)
        rj = j_fl.run_experiment(JFLConfig(**fkw), "gen_async", eval_every=EVAL, data=j_data,
                                 task=jd)
        rt = t_fl.run_experiment(FLConfig(device="cpu", **fkw), "gen_async", eval_every=EVAL,
                                 data=t_data, task=td)
        assert _gap(rt.final_params, rj.final_params) <= 1e-4
        np.testing.assert_allclose(rt.eval_acc, rj.eval_acc, atol=2 / 2048)
    grid = dict(seeds=(0,), policies=("uniform", "optimal"), eval_every=EVAL)
    fkw = dict(n_clients=N, concurrency=C, server_steps=T)
    mj = j_fl.run_matrix(JFLConfig(**fkw), data=j_data, task=jd, **grid)
    mt = t_fl.run_matrix(FLConfig(device="cpu", **fkw), data=t_data, task=td, **grid)
    np.testing.assert_allclose(mt.eval_acc, mj.eval_acc, atol=2 / 2048)
    np.testing.assert_array_equal(mt.eval_times, mj.eval_times)
    fresh = _Duck(t_fl.ClassificationTask(hidden=HIDDEN))
    r = t_fl.run_experiment(FLConfig(n_clients=4, concurrency=2, server_steps=10, engine="scan",
                                     device="cpu"), "gen_async", eval_every=5,
                            data=FederatedClassification(n_clients=4, seed=0), task=fresh)
    assert r.eval_steps.tolist() == [5, 10] and np.isfinite(r.eval_acc).all()


@pytest.mark.parametrize("kw", [
    dict(task="duck"),
    dict(faults="crash", flc=dict(stream="device")),
    dict(ckpt_dir="ckpt", ckpt_every=5, flc=dict(stream="device")),
    dict(serving="overload", flc=dict(stream="device")),
])
def test_run_experiment_options_run_like_jax(kw, tmp_path):
    """Duck-typed tasks run as the reference's do (`_duck_runs_match_jax`).
    Faults, checkpoints and serving run
    on the device stream (under ``tmp_path``) as the reference's do:
    finite curves of the same eval points, the reference's extras (the
    kinds of all T events under faults; the ``serve_*`` counters, their
    requests conserved, under serving), NaN event times under
    checkpoints.  ``run_matrix(stream="device",
    scenario="erlang2")`` runs per event in every cell, as the reference's
    does, with each cell's kinds over 6 tags."""
    from repro.core import FaultConfig as JFaultConfig
    from repro.core import ServingConfig as JServingConfig
    from repro_torch.core import FaultConfig, ServingConfig

    serve_kw = dict(arrival_rate=4.0, serve_rate=2.0, queue_cap=3, deadline=1.0)
    kw = dict(kw)
    if kw.get("faults") == "crash":
        kw["faults"] = FaultConfig(crash_rate=0.1)
    if kw.get("serving") == "overload":
        kw["serving"] = ServingConfig(**serve_kw)
    if "ckpt_dir" in kw:
        kw["ckpt_dir"] = str(tmp_path / "ckpt")
    method = kw.pop("method", "gen_async")
    fkw = kw.pop("flc", {})
    flc = FLConfig(n_clients=4, concurrency=2, server_steps=10, device="cpu", **fkw)
    if kw.get("task") == "duck":
        _duck_runs_match_jax()
    else:
        r = t_fl.run_experiment(flc, method, eval_every=5, **kw)
        jkw = dict(kw)
        if "faults" in jkw:
            jkw["faults"] = JFaultConfig(crash_rate=0.1)
        if "ckpt_dir" in jkw:
            jkw["ckpt_dir"] = str(tmp_path / "jax_ckpt")
        if "serving" in jkw:
            jkw["serving"] = JServingConfig(**serve_kw)
        rj = j_fl.run_experiment(JFLConfig(n_clients=4, concurrency=2, server_steps=10, **fkw),
                                 method, eval_every=5, **jkw)
        assert r.eval_steps.tolist() == rj.eval_steps.tolist() == [5, 10]
        assert np.isfinite(r.eval_acc).all() and np.isfinite(rj.eval_acc).all()
        assert set(rj.extras) <= set(r.extras)
        if "faults" in kw:
            assert int(r.extras["kind_count"].sum()) == int(np.sum(rj.extras["kind_count"])) == 10
        elif "serving" in kw:
            x = r.extras
            assert sum(k.startswith("serve_") for k in rj.extras) == 16
            assert int(x["serve_arrivals"]) == sum(int(x[f"serve_{k}"]) for k in (
                "served", "shed", "timed_out", "pending"))
            assert np.isfinite(r.eval_times).all()
        else:
            assert np.isnan(r.eval_times).all() and np.isnan(rj.eval_times).all()
    m = t_fl.run_matrix(flc, seeds=(0,), stream="device", scenario="erlang2", eval_every=5)
    assert m.eval_acc.shape == (1, 3, 1, 2) and np.isfinite(m.eval_acc).all()
    assert m.extras["kind_count"].shape == (1, 3, 1, 6)
    assert (m.extras["kind_count"].sum(-1) == 10).all()


@pytest.mark.parametrize("method", ["fedbuff", "fedavg", "favano"])
def test_run_experiment_baselines_run(method):
    """FedBuff, FedAvg and FAVANO are ported (ROADMAP Queue 1 item 4): each
    runs through `run_experiment` on the CPU (their parity with the JAX
    package is in `tests/test_torch_fedbuff.py`)."""
    flc = FLConfig(n_clients=12, concurrency=2, server_steps=10, fedbuff_Z=3,  # FedAvg samples 10
                   device="cpu")
    r = t_fl.run_experiment(flc, method, eval_every=5)
    assert r.name == method and r.extras["engine"] == "python"
    assert r.eval_steps.tolist() == [5, 10] and np.all(np.isfinite(r.eval_acc))
    assert all(bool(torch.isfinite(v).all()) for v in r.final_params.values())
