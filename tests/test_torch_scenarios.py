"""PyTorch port, scenarios on the host stream (phase-type service and
Markov-modulated availability), against the JAX package.

  * `export_stream` under each enabled registry scenario is bitwise the
    reference's (J, K, t, slot, kind, delay_steps);
  * the disabled default ("exponential") takes the unmodified path, bitwise;
  * the port's Python loop, its replay (per event and blocked) and JAX's
    scan on the same stream agree (<= 1e-5 on a quadratic, 1e-5 on the
    MLP of `tests/test_torch_fl.py`'s `_pair`), with equal ``kind_count``
    (minlength 6); stage and flip events carry the trash slot C;
  * `run_matrix(scenario=...)` per event and blocked against JAX's;
  * the compositions that raise (faults, FedBuff, a non-exponential
    service law; the device stream raises item 6 elsewhere).
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import FLConfig as JFLConfig  # noqa: E402
from repro.core import ServerConfig as JServerConfig  # noqa: E402
from repro.core import SimConfig as JSimConfig  # noqa: E402
from repro.core import export_stream as j_export_stream  # noqa: E402
from repro.core import run_generalized_async_sgd as j_run  # noqa: E402
from repro.fl import engine as j_fl  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.core import (  # noqa: E402
    KIND_COMPLETE,
    SCENARIOS,
    FaultConfig,
    ServerConfig,
    SimConfig,
    export_stream,
    get_scenario,
    list_scenarios,
    run_fedbuff,
    run_generalized_async_sgd,
)
from repro_torch.fl import engine as t_fl  # noqa: E402
from test_torch_faults import _JQuad, _leaves, _Quad  # noqa: E402
from test_torch_fl import C, N, _gap, _pair  # noqa: E402

ENABLED = [name for name in list_scenarios() if SCENARIOS[name].enabled]


def test_registry_is_the_reference_s():
    from repro.core.scenario import SCENARIOS as J_SCENARIOS

    assert sorted(SCENARIOS) == sorted(J_SCENARIOS)
    for name in SCENARIOS:
        assert SCENARIOS[name].to_dict() == J_SCENARIOS[name].to_dict(), name
    assert len(ENABLED) == 6 and get_scenario("exponential").enabled is False


@pytest.mark.parametrize("name", ENABLED)
def test_export_stream_is_bitwise_jax(name):
    n, C_, T = 5, 3, 1500
    rng = np.random.default_rng(1)
    p = rng.uniform(0.5, 2.0, n)
    kw = dict(mu=np.linspace(0.5, 2.0, n), p=p / p.sum(), C=C_, T=T, seed=4, scenario=name)
    a = export_stream(SimConfig(**dict(kw, scenario=get_scenario(name))))
    from repro.core.scenario import get_scenario as j_get_scenario

    b = j_export_stream(JSimConfig(**dict(kw, scenario=j_get_scenario(name))))
    for field in ("J", "K", "t", "slot", "kind", "delay_steps", "queue_len_sum"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
    moved = a.kind != KIND_COMPLETE
    assert (a.slot[moved] == C_).all()  # stage advances and flips: the trash slot


@pytest.mark.parametrize("engine", ["python", "scan"])
def test_default_scenario_is_bitwise_no_scenario(engine):
    n = 4
    outs = []
    for scenario in (None, "exponential"):
        cfg = ServerConfig(n=n, C=3, T=300, eta=0.05, p=np.full(n, 1 / n),
                           mu=np.linspace(0.5, 2.0, n), seed=7, engine=engine,
                           scenario=scenario, device="cpu")
        w, tr = run_generalized_async_sgd({"a": np.zeros(3, np.float32)}, _Quad(n), cfg)
        assert "kind_count" not in tr.extras or tr.extras["kind_count"] is None
        outs.append(w["a"])
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("name", ["erlang2", "hyperexp2", "erlang2_onoff"])
@pytest.mark.parametrize("block_size", [1, 6])
def test_python_scan_scenario_parity(name, block_size):
    """Python loop == replay (per event, blocked) == JAX's scan on the same
    exported stream; kind counts over 6 kinds, equal."""
    n = 5
    base = dict(n=n, C=3, T=400, eta=0.05, p=np.full(n, 1 / n), mu=np.linspace(0.5, 2.0, n),
                seed=2, scenario=name)
    w0 = {"a": np.zeros(4, np.float32)}
    w_py, tr_py = run_generalized_async_sgd(w0, _Quad(n), ServerConfig(device="cpu", **base))
    w_sc, tr_sc = run_generalized_async_sgd(
        w0, _Quad(n), ServerConfig(device="cpu", engine="scan", block_size=block_size, **base))
    w_j, tr_j = j_run({"a": jnp.zeros(4, jnp.float32)}, _JQuad(n),
                      JServerConfig(engine="scan", block_size=block_size, sparse=False, **base))
    np.testing.assert_allclose(_leaves(w_py), _leaves(w_sc), rtol=1e-5, atol=1e-6)
    assert np.max(np.abs(_leaves(w_sc) - _leaves(w_j))) < 1e-5
    assert tr_sc.extras["kind_count"].shape == (6,)
    np.testing.assert_array_equal(tr_py.extras["kind_count"], tr_sc.extras["kind_count"])
    np.testing.assert_array_equal(tr_sc.extras["kind_count"], tr_j.extras["kind_count"])


@pytest.mark.parametrize("name,block_size,update", [
    ("erlang2_onoff", 1, "jnp"),
    ("hyperexp2", 4, "pallas"),
])
def test_mlp_scenario_replay_matches_jax(name, block_size, update):
    (_, _, j_setup), (_, _, setup) = _pair()
    flc = FLConfig(n_clients=N, concurrency=C, server_steps=300)
    mu = t_fl.make_client_speeds(N, flc.frac_fast, flc.speed_ratio, seed=0)
    kw = dict(n=N, C=C, T=300, eta=0.05, mu=mu, p=t_fl.sampling_for(flc, mu), eval_every=100,
              engine="scan", block_size=block_size, update=update, scenario=name)
    w_t, tr_t = run_generalized_async_sgd(setup.params, setup.clients,
                                          ServerConfig(device="cpu", **kw),
                                          eval_fn=setup.eval_fn)
    w_j, tr_j = j_run(j_setup.params, j_setup.clients,
                      JServerConfig(pallas_interpret=True, **kw), eval_fn=j_setup.eval_fn)
    assert _gap(w_t, w_j) <= 1e-5
    np.testing.assert_allclose(tr_t.eval_values, tr_j.eval_values, atol=2 / 2048)
    np.testing.assert_array_equal(tr_t.extras["kind_count"], tr_j.extras["kind_count"])
    np.testing.assert_array_equal(tr_t.times, tr_j.times)


@pytest.mark.parametrize("block_size", [1, 4])
def test_run_matrix_scenario_matches_jax(block_size):
    """Every cell's stream under the scenario, replayed along the cell axis
    (each cell's trash ring row takes its stage and flip events)."""
    (j_data, j_task, _), (t_data, t_task, _) = _pair()
    kw = dict(n_clients=N, concurrency=C, server_steps=150)
    mk = dict(seeds=(0, 1), policies=("uniform", "optimal"), speed_ratios=(4.0,), eta=0.08,
              eval_every=50, block_size=block_size, scenario="erlang2_onoff")
    mj = j_fl.run_matrix(JFLConfig(**kw), data=j_data, task=j_task, **mk)
    mt = t_fl.run_matrix(FLConfig(device="cpu", **kw), data=t_data, task=t_task, **mk)
    np.testing.assert_array_equal(mt.eval_times, mj.eval_times)
    assert mt.eval_acc.shape == mj.eval_acc.shape == (2, 2, 1, 3)
    np.testing.assert_allclose(mt.eval_acc, mj.eval_acc, atol=2 / 2048)
    np.testing.assert_allclose(mt.final_acc, mj.final_acc, atol=2 / 2048)
    # a cell of the matrix against the port's run of it alone
    r = t_fl.run_experiment(replace(FLConfig(device="cpu", **kw), sampling="optimal",
                                    speed_ratio=4.0, engine="scan", block_size=block_size,
                                    scenario="erlang2_onoff"),
                            "gen_async", eta=0.08, eval_every=50, data=t_data, task=t_task)
    np.testing.assert_array_equal(r.eval_times, mt.eval_times[0, 1, 0])
    np.testing.assert_allclose(r.eval_acc, mt.eval_acc[0, 1, 0], atol=2 / 2048)


@pytest.mark.parametrize("kw,fn,match", [
    (dict(scenario="erlang2", faults=FaultConfig(off_rate=0.5, on_rate=1.0)),
     run_generalized_async_sgd, "separate injection paths"),
    (dict(scenario="erlang2"), run_fedbuff, "not FedBuff"),
    (dict(scenario="hyperexp2", service="det"), run_generalized_async_sgd, "service law"),
])
def test_scenario_compositions_raise(kw, fn, match):
    cfg = ServerConfig(n=4, C=2, T=50, eta=0.1, engine="scan", device="cpu", **kw)
    with pytest.raises(ValueError, match=match):
        fn({"a": np.zeros(2, np.float32)}, _Quad(4), cfg)
