"""PyTorch port, replay engine: the `Quadratic` ladder of `tests/test_engine.py`.

Port scan == port python (<= 1e-5), and port == JAX
`run_generalized_async_sgd(engine="scan")` (<= 1e-5), per event and blocked
(E=4), with the plain update and the kernel path (the JAX side runs its
Pallas kernels in interpret mode; the port's kernel path takes the plain
versions on the CPU).  Also the eval-curve and trace-metadata parity, and
the options the port does not run yet.
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import ServerConfig as JServerConfig  # noqa: E402
from repro.core import run_generalized_async_sgd as j_run  # noqa: E402
from repro_torch.core import ServerConfig, run_generalized_async_sgd  # noqa: E402
from repro_torch.core import engine_scan, queue_sim  # noqa: E402
from repro_torch.core.async_sgd import run_favano, run_fedavg, run_fedbuff  # noqa: E402


class Quadratic:
    """Clients hold quadratics f_i(w) = 0.5 ||w - c_i||^2: host `grad` for
    the Python loop, `device_grad` (0-d tensor client id, also under vmap)
    for the replay engine."""

    def __init__(self, n, d=4, seed=0):
        rng = np.random.default_rng(seed)
        self.c = rng.normal(size=(n, d)).astype(np.float32)
        self.c_t = torch.tensor(self.c)
        self.d = d

    def grad(self, i, w, k):
        return w - self.c_t[i]

    def device_grad(self, j, w, k):
        return w - self.c_t.index_select(0, j.reshape(1))[0]


class JQuadratic:
    def __init__(self, c):
        self.c, self.c_dev = c, jnp.asarray(c)

    def grad(self, i, w, k):
        return w - self.c[i]

    def device_grad(self, j, w, k):
        return w - self.c_dev[j]


def _nonuniform_p(n, seed=1):
    p = np.random.default_rng(seed).uniform(0.5, 1.5, n)
    return p / p.sum()


N, T = 8, 300


@pytest.mark.parametrize("C", [1, 4, 8])  # C == n at 8
@pytest.mark.parametrize("weighting", ["importance", "plain"])
@pytest.mark.parametrize("block_size", [1, 4])
@pytest.mark.parametrize("update", ["jnp", "pallas"])
def test_scan_matches_python_and_jax(C, weighting, block_size, update):
    prob = Quadratic(N)
    cfg = ServerConfig(n=N, C=C, T=T, eta=0.02, p=_nonuniform_p(N), seed=3,
                       weighting=weighting, device="cpu")
    w_py, _ = run_generalized_async_sgd(np.zeros(prob.d, np.float32), prob, cfg)
    cfg_sc = replace(cfg, engine="scan", block_size=block_size, update=update)
    w_sc, _ = run_generalized_async_sgd(np.zeros(prob.d, np.float32), prob, cfg_sc)
    np.testing.assert_allclose(w_sc.numpy(), w_py.numpy(), atol=1e-5)  # measured <= 8e-8
    jcfg = JServerConfig(n=N, C=C, T=T, eta=0.02, p=_nonuniform_p(N), seed=3,
                         weighting=weighting, engine="scan", block_size=block_size,
                         update=update, pallas_interpret=True)
    w_j, _ = j_run(jnp.zeros(prob.d, jnp.float32), JQuadratic(prob.c), jcfg)
    np.testing.assert_allclose(w_sc.numpy(), np.asarray(w_j), atol=1e-5)  # measured <= 6e-8


@pytest.mark.parametrize("block_size", [1, 4])
def test_eval_curve_parity(block_size):
    """Evaluation falls on the same steps as in the Python loop and in the
    JAX engine, and sees the same iterates."""
    prob = Quadratic(N)
    cfg = ServerConfig(n=N, C=4, T=500, eta=0.02, seed=7, eval_every=100, device="cpu")
    _, tr_py = run_generalized_async_sgd(
        np.zeros(prob.d, np.float32), prob, cfg, eval_fn=lambda w: float(torch.sum(w ** 2)))
    _, tr_sc = run_generalized_async_sgd(
        np.zeros(prob.d, np.float32), prob, replace(cfg, engine="scan", block_size=block_size),
        eval_fn=lambda w: torch.sum(w ** 2))
    jcfg = JServerConfig(n=N, C=4, T=500, eta=0.02, seed=7, eval_every=100, engine="scan",
                         block_size=block_size)
    _, tr_j = j_run(jnp.zeros(prob.d, jnp.float32), JQuadratic(prob.c), jcfg,
                    eval_fn=lambda w: jnp.sum(w ** 2))
    assert tr_sc.eval_steps == tr_py.eval_steps == tr_j.eval_steps == [100, 200, 300, 400, 500]
    np.testing.assert_allclose(tr_sc.eval_values, tr_py.eval_values, atol=1e-5)
    np.testing.assert_allclose(tr_sc.eval_values, tr_j.eval_values, atol=1e-5)


def test_trace_metadata_parity():
    """times / delays / mean queue lengths come from the same stream."""
    prob = Quadratic(N)
    cfg = ServerConfig(n=N, C=4, T=400, eta=0.02, seed=5, device="cpu")
    _, tr_py = run_generalized_async_sgd(np.zeros(prob.d, np.float32), prob, cfg)
    _, tr_sc = run_generalized_async_sgd(np.zeros(prob.d, np.float32), prob,
                                         replace(cfg, engine="scan"))
    jcfg = JServerConfig(n=N, C=4, T=400, eta=0.02, seed=5, engine="scan")
    _, tr_j = j_run(jnp.zeros(prob.d, jnp.float32), JQuadratic(prob.c), jcfg)
    np.testing.assert_allclose(tr_sc.times, tr_py.times)
    np.testing.assert_allclose(tr_sc.mean_queue_lengths, tr_py.mean_queue_lengths)
    assert tr_sc.delays == tr_py.delays == tr_j.delays
    np.testing.assert_array_equal(tr_sc.times, tr_j.times)


def test_bf16_ring_matches_jax():
    """``snapshot_dtype="bfloat16"`` on the blocked engine: the ring stores
    bf16 rows, the server weights stay fp32."""
    prob = Quadratic(N, d=37)
    cfg = ServerConfig(n=N, C=4, T=200, eta=0.02, seed=2, engine="scan", block_size=4,
                       snapshot_dtype="bfloat16", device="cpu")
    w, _ = run_generalized_async_sgd(np.zeros(prob.d, np.float32), prob, cfg)
    jcfg = JServerConfig(n=N, C=4, T=200, eta=0.02, seed=2, engine="scan", block_size=4,
                         snapshot_dtype="bfloat16")
    w_j, _ = j_run(jnp.zeros(prob.d, jnp.float32), JQuadratic(prob.c), jcfg)
    assert w.dtype == torch.float32
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=1e-5)


def test_runner_memo_and_blocked_eval_layout():
    prob = Quadratic(6)
    r1 = engine_scan.jit_runner(prob.device_grad, 3, eval_every=0)
    r2 = engine_scan.jit_runner(prob.device_grad, 3, eval_every=50)
    assert r1.func is r2.func
    assert len(prob.__dict__["_scan_runner_cache"]) == 1
    with pytest.raises(ValueError, match="eval cadence"):
        engine_scan.make_runner(prob.device_grad, 3, block_size=4, eval_every=10)


def test_scan_rejects_host_only_source():
    class HostOnly:
        def grad(self, i, w, k):
            return w

    cfg = ServerConfig(n=4, C=2, T=10, eta=0.1, engine="scan", device="cpu")
    with pytest.raises(TypeError):
        run_generalized_async_sgd(np.zeros(2, np.float32), HostOnly(), cfg)


_OPTIONS = {
    "faults": dict(faults=queue_sim.FaultConfig(crash_rate=0.1), stream="device"),
    "guard": dict(guard=engine_scan.GuardConfig(max_grad_norm=10.0), stream="device"),
    "ckpt": dict(ckpt_dir="ckpt", ckpt_every=5, stream="device"),
    "device": dict(stream="device"),
    "adaptive": dict(adaptive=True),
    "scenario": dict(scenario="erlang2", stream="device"),
}
# what the port does with each option on the scan engine: the reference's
# ValueError, or a run like the reference's (None); on the Python engine
# every option raises the reference's ValueError ("stream='device' /
# adaptive require engine='scan'")
_ON_SCAN = {"faults": None, "guard": None, "ckpt": None, "device": None,
            "adaptive": "requires stream='device'", "scenario": None}


def _jax_option(option):
    from repro.core import FaultConfig as JFaultConfig
    from repro.core import GuardConfig as JGuardConfig

    conv = {"faults": lambda f: JFaultConfig(crash_rate=f.crash_rate),
            "guard": lambda g: JGuardConfig(max_grad_norm=g.max_grad_norm)}
    return {k: conv[k](v) if k in conv else v for k, v in option.items()}


@pytest.mark.parametrize("option", sorted(_OPTIONS))
@pytest.mark.parametrize("engine", ["python", "scan"])
def test_unported_options_raise(option, engine, tmp_path):
    """Each option of the device stream does what the reference does with
    it: the Python engine raises the reference's ValueError for all of
    them, as does adaptive sampling on the host stream; on the scan engine
    the device stream runs bare and with faults, the guard, checkpoints
    (under ``tmp_path``) or a scenario, as the reference's does: finite
    weights, the reference's trace extras (the realizations differ:
    `tests/test_torch_stream_robust.py` holds them on the same draws), the
    kinds and the guard's counters of all T events, and the event clock,
    NaN under checkpoints in both packages."""
    prob = Quadratic(4)
    opt = dict(_OPTIONS[option])
    if "ckpt_dir" in opt:
        opt["ckpt_dir"] = str(tmp_path / "ckpt")
    cfg = ServerConfig(n=4, C=2, T=10, eta=0.1, engine=engine, device="cpu", **opt)
    jcfg = JServerConfig(n=4, C=2, T=10, eta=0.1, engine=engine, **_jax_option(opt))
    expect = _ON_SCAN[option] if engine == "scan" else "require engine='scan'"
    if isinstance(expect, str):
        with pytest.raises(ValueError, match=expect):
            run_generalized_async_sgd(np.zeros(prob.d, np.float32), prob, cfg)
        with pytest.raises(ValueError, match=expect):
            j_run(jnp.zeros(prob.d, jnp.float32), JQuadratic(prob.c), jcfg)
        return
    w, tr = run_generalized_async_sgd(np.zeros(prob.d, np.float32), prob, cfg)
    if option == "ckpt":
        jcfg = replace(jcfg, ckpt_dir=str(tmp_path / "jax_ckpt"))
    wj, trj = j_run(jnp.zeros(prob.d, jnp.float32), JQuadratic(prob.c), jcfg)
    assert bool(torch.isfinite(w).all()) and bool(np.isfinite(np.asarray(wj)).all())
    assert tr.times.shape == trj.times.shape == (10,)
    if option == "ckpt":
        assert np.isnan(tr.times).all() and np.isnan(trj.times).all()
    else:
        assert np.all(np.diff(tr.times) >= 0)
    assert set(trj.extras) <= set(tr.extras)
    assert tr.extras["p_final"].shape == np.asarray(trj.extras["p_final"]).shape == (4,)
    if "kind_count" in trj.extras:
        assert tr.extras["kind_count"].shape == np.asarray(trj.extras["kind_count"]).shape
        assert int(tr.extras["kind_count"].sum()) == int(np.sum(trj.extras["kind_count"])) == 10
    if "guard_rejects" in trj.extras:
        for x in (tr.extras, trj.extras):
            assert 0 <= int(x["guard_rejects"]) <= 10 and int(x["stale_drops"]) == 0


@pytest.mark.parametrize("engine", ["python", "scan"])
def test_devices_option_is_ported(engine):
    """``devices=2`` (lane sharding, ROADMAP Queue 1 item 12) is ported: the
    Python loop ignores it, as `repro`'s does, and the replay engine needs a
    process group of 2 ranks, which this process does not have
    (`tests/test_torch_lanes.py` runs one)."""
    prob = Quadratic(4)
    cfg = ServerConfig(n=4, C=2, T=10, eta=0.1, engine=engine, device="cpu",
                       devices=2, block_size=2)
    if engine == "python":
        w, _ = run_generalized_async_sgd(np.zeros(prob.d, np.float32), prob, cfg)
        w1, _ = run_generalized_async_sgd(np.zeros(prob.d, np.float32), prob,
                                          replace(cfg, devices=1))
        assert torch.equal(w, w1)
    else:
        with pytest.raises(ValueError, match="process group"):
            run_generalized_async_sgd(np.zeros(prob.d, np.float32), prob, cfg)


@pytest.mark.parametrize("fn", [run_fedbuff, run_fedavg, run_favano])
def test_unported_baselines_raise(fn):
    """The baselines are ported (ROADMAP Queue 1 item 4): each runs on the
    CPU and returns finite weights (their parity with the JAX package is in
    `tests/test_torch_fedbuff.py`).  FedBuff also runs on the device event
    stream (ROADMAP item 2 asked for it; its parity with the reference's
    fused runner is in `tests/test_torch_fused.py`)."""
    cfg = ServerConfig(n=12, C=2, T=10, eta=0.1, device="cpu")  # FedAvg samples 10 a round
    w, tr = fn(np.zeros(4, np.float32), Quadratic(12), cfg)
    assert bool(torch.isfinite(w).all()) and len(tr.times) == 10
    run = engine_scan.make_runner(Quadratic(4).device_grad, 2, fedbuff_Z=5, stream="device",
                                  n=4, T=20, weighting="plain")
    w_dev, _, extras = run(torch.zeros(4), np.ones(4), np.full(4, 0.25), 0, 0.1)
    assert bool(torch.isfinite(w_dev).all()) and extras["t"].shape == (20,)
    assert callable(engine_scan.make_runner(Quadratic(4).device_grad, 2, fedbuff_Z=5))


def test_serving_raises():
    """The serving plane (ROADMAP item 11) is ported and does what the
    reference's does: the Python loop ignores it (bitwise the run without
    it), the scan engine's host stream raises the reference's ValueError
    (the open stream merges only into the device event race), and the
    device stream runs it with the reference's ``serve_*`` extras
    (`tests/test_torch_serving.py` holds them on the same draws)."""
    from repro.core import ServingConfig as JServingConfig
    from repro_torch.core import ServingConfig

    kw = dict(arrival_rate=4.0, serve_rate=2.0, queue_cap=3, deadline=1.0)
    prob = Quadratic(4)
    cfg = ServerConfig(n=4, C=2, T=10, eta=0.1, serving=ServingConfig(**kw), device="cpu")
    w, _ = run_generalized_async_sgd(np.zeros(4, np.float32), prob, cfg)
    w0, _ = run_generalized_async_sgd(np.zeros(4, np.float32), prob, replace(cfg, serving=None))
    assert torch.equal(w, w0)
    jcfg = JServerConfig(n=4, C=2, T=10, eta=0.1, serving=JServingConfig(**kw), engine="scan")
    with pytest.raises(ValueError, match="serving requires stream='device'"):
        j_run(jnp.zeros(4, jnp.float32), JQuadratic(prob.c), jcfg)
    with pytest.raises(ValueError, match="serving requires stream='device'"):
        run_generalized_async_sgd(np.zeros(4, np.float32), prob, replace(cfg, engine="scan"))
    dcfg = replace(cfg, engine="scan", stream="device", T=200)
    w, tr = run_generalized_async_sgd(np.zeros(4, np.float32), prob, dcfg)
    _, trj = j_run(jnp.zeros(4, jnp.float32), JQuadratic(prob.c),
                   replace(jcfg, stream="device", T=200))
    names = sorted(k for k in trj.extras if k.startswith("serve_"))
    assert names == sorted(k for k in tr.extras if k.startswith("serve_")) and len(names) == 16
    x = tr.extras
    assert int(x["serve_arrivals"]) == (int(x["serve_served"]) + int(x["serve_shed"])
                                        + int(x["serve_timed_out"]) + int(x["serve_pending"]))
    assert int(x["serve_arrivals"]) > 0 and bool(torch.isfinite(w).all())
