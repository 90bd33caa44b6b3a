"""PyTorch port, the fused runner (`engine_scan.make_fused_runner`): the
device event stream feeding the replay, against the JAX package.

On the reference's own draws (its initial placement and uniform blocks,
`test_torch_stream._ref_draws`) the port's fused run is the reference's
``make_fused_runner`` run: per event, FedBuff and adaptive sampling, on the
Quadratic and the MLP (`test_torch_fl._pair`), weights and ``p_traj``
<= 1e-5.  The fused run is bitwise the port's host replay of the stream it
generated; blocked runs agree with per-event runs to the re-association of
the fp32 sums (<= 1e-4 at T=200); the cell axis is bitwise each cell alone.
The port's own generator is held in law with the reference's bars
(`tests/test_stream_device.py`): against the Python engine, the extras'
invariants, the adaptive controller within 5% of the static optimum,
dispatch-time importance scales, and `run_matrix(stream="device")` with no
host pre-simulation.
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine_scan as jes  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.core import ServerConfig, jit_runner, run_fedbuff, run_generalized_async_sgd  # noqa: E402
from repro_torch.core import engine_scan, stream_device as sd  # noqa: E402
from repro_torch.core.sampling import bound_for_p, optimize_general  # noqa: E402
from repro_torch.core.theory import BoundConstants  # noqa: E402
from repro_torch.fl import engine as t_fl  # noqa: E402
from test_stream_device import _nonuniform_p  # noqa: E402
from test_torch_engine import JQuadratic, Quadratic  # noqa: E402
from test_torch_stream import _ref_draws  # noqa: E402

N, C = 8, 4


def _draws(key, n, C, T, p):
    """The reference's draws as the port's `run.from_draws` takes them."""
    nodes, ur, ue, ud, _ = _ref_draws(key, n, C, T, p)
    return [torch.tensor(a) for a in (nodes, ur, ue, ud)]


def _mu_p(n=N, seed=0):
    mu = np.random.default_rng(seed).uniform(0.5, 4.0, n)
    return mu, _nonuniform_p(n, seed=seed + 1)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(weighting="plain"),
    dict(fedbuff_Z=5, weighting="plain"),
    dict(eval_every=150),
    dict(adaptive=True, refresh_every=100, eval_every=200),
    dict(block_size=4, eval_every=150),
    dict(block_size=4, fedbuff_Z=5, weighting="plain"),
], ids=["importance", "plain", "fedbuff", "eval", "adaptive", "blocked", "blocked_fedbuff"])
def test_quadratic_matches_reference_fused_runner(kw):
    """Blocked, the reference replays E-event windows with an in-window
    fix-up and the port conflict-free blocks: the same per-event
    Algorithm 1, the fp32 sums associated differently."""
    T = 600
    prob = Quadratic(N)
    mu, p = _mu_p()
    key = jax.random.PRNGKey(1)
    ev = kw.get("eval_every")
    jr = jes.make_fused_runner(JQuadratic(prob.c).device_grad, N, C, T,
                               eval_fn=(lambda w: jnp.sum(w ** 2)) if ev else None, **kw)
    wj, ej, xj = jax.jit(jr)(jnp.zeros(prob.d), jnp.asarray(mu), jnp.asarray(p), key, 0.05)
    tr = engine_scan.make_fused_runner(prob.device_grad, N, C, T,
                                       eval_fn=(lambda w: torch.sum(w ** 2)) if ev else None, **kw)
    wt, et, xt = tr.from_draws(torch.zeros(prob.d), mu, p, 0.05, *_draws(key, N, C, T, p))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-5)  # measured <= 1.5e-6
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=1e-5)
    np.testing.assert_allclose(xt["p_traj"].numpy(), np.asarray(xj["p_traj"]), atol=1e-5)
    np.testing.assert_allclose(xt["p_final"].numpy(), np.asarray(xj["p_final"]), atol=1e-5)
    np.testing.assert_allclose(xt["t"].numpy(), np.asarray(xj["t"]), rtol=1e-6)
    for f in ("comp", "delay_sum"):
        np.testing.assert_array_equal(xt[f].numpy(), np.asarray(xj[f]))
    for f in ("occ_mean", "occ_time_avg", "busy_time"):
        np.testing.assert_allclose(xt[f].numpy(), np.asarray(xj[f]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kw", [dict(), dict(fedbuff_Z=10, weighting="plain"),
                                dict(adaptive=True, refresh_every=40, eval_every=80)],
                         ids=["gen_async", "fedbuff", "adaptive"])
def test_mlp_matches_reference_fused_runner(kw):
    from test_torch_fl import _pair

    (_, _, j_setup), (_, _, setup) = _pair()
    n, T = 16, 160
    mu, p = _mu_p(n, seed=3)
    key = jax.random.PRNGKey(4)
    kw = dict(kw)
    ev = kw.pop("eval_every", 80)
    jr = jes.make_fused_runner(j_setup.clients.device_grad, n, C, T, eval_fn=j_setup.eval_fn,
                               eval_every=ev, **kw)
    wj, ej, xj = jax.jit(jr)(j_setup.params, jnp.asarray(mu), jnp.asarray(p), key, 0.05)
    tr = engine_scan.make_fused_runner(setup.clients.device_grad, n, C, T,
                                       eval_fn=setup.eval_fn, eval_every=ev, **kw)
    wt, et, xt = tr.from_draws(setup.params, mu, p, 0.05, *_draws(key, n, C, T, p))
    gap = max(float(np.abs(wt[k].numpy() - np.asarray(wj[k])).max()) for k in wj)
    assert gap <= 1e-5  # measured <= 3e-7
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=2 / 2048)
    np.testing.assert_allclose(xt["p_traj"].numpy(), np.asarray(xj["p_traj"]), atol=1e-5)


def test_k1_update_equals_the_flat_update():
    """``update_fn`` = K1 over the leaves (its plain version on the CPU),
    per event, plain and FedBuff, against the flat axpy."""
    from test_torch_fl import _pair

    from repro_torch.kernels.ops import tree_weighted_update

    _, (_, _, setup) = _pair()
    n, T = 16, 120
    mu, p = _mu_p(n, seed=3)
    d = _draws(jax.random.PRNGKey(5), n, C, T, p)
    for kw in (dict(), dict(fedbuff_Z=10, weighting="plain")):
        w1, _, _ = engine_scan.make_fused_runner(setup.clients.device_grad, n, C, T, **kw
                                                 ).from_draws(setup.params, mu, p, 0.05, *d)
        w2, _, _ = engine_scan.make_fused_runner(setup.clients.device_grad, n, C, T,
                                                 update_fn=tree_weighted_update, **kw
                                                 ).from_draws(setup.params, mu, p, 0.05, *d)
        for k in w1:
            np.testing.assert_allclose(w2[k].numpy(), w1[k].numpy(), atol=1e-6)


@pytest.mark.parametrize("fedbuff_Z", [0, 5])
def test_fused_run_is_the_host_replay_of_its_stream(fedbuff_Z):
    """The fused run replays, bitwise, the events its stream generated
    (J, slot and the dispatch-time scales from the same draws)."""
    T = 400
    prob = Quadratic(N)
    mu, p = _mu_p()
    d = _draws(jax.random.PRNGKey(6), N, C, T, p)
    kw = dict(fedbuff_Z=fedbuff_Z, weighting="plain") if fedbuff_Z else {}
    w, _, x = engine_scan.make_fused_runner(prob.device_grad, N, C, T, **kw).from_draws(
        torch.zeros(prob.d), mu, p, 0.05, *d)
    p_t = torch.tensor(p, dtype=torch.float32)
    K = sd.tree_sample(sd.tree_build(p_t), d[3])
    _, (J, _, t, slot, _), _ = sd.scan_draws(torch.tensor(mu, dtype=torch.float32), d[0], d[1],
                                             d[2], K)
    eta = torch.tensor(0.05, dtype=torch.float32)
    scale = eta.expand(T) if fedbuff_Z else eta / (N * p_t[J])
    w_host, _ = jit_runner(prob.device_grad, C, fedbuff_Z=fedbuff_Z)(torch.zeros(prob.d), J, slot,
                                                                    scale.contiguous())
    assert torch.equal(w, w_host)
    assert torch.equal(x["t"], t)


@pytest.mark.parametrize("fedbuff_Z", [0, 5])
def test_blocked_matches_per_event(fedbuff_Z):
    T = 200
    prob = Quadratic(N)
    mu, p = _mu_p()
    d = _draws(jax.random.PRNGKey(7), N, C, T, p)
    kw = dict(fedbuff_Z=fedbuff_Z, weighting="plain") if fedbuff_Z else {}
    w1, _, x1 = engine_scan.make_fused_runner(prob.device_grad, N, C, T, **kw).from_draws(
        torch.zeros(prob.d), mu, p, 0.05, *d)
    for E in (4, 8):
        wE, _, xE = engine_scan.make_fused_runner(prob.device_grad, N, C, T, block_size=E,
                                                  **kw).from_draws(torch.zeros(prob.d), mu, p,
                                                                   0.05, *d)
        np.testing.assert_allclose(wE.numpy(), w1.numpy(), atol=1e-4)
        assert torch.equal(xE["t"], x1["t"]) and torch.equal(xE["comp"], x1["comp"])


def test_eval_curve_and_tail():
    """Chunked eval and the events past the last chunk both run."""
    prob = Quadratic(N)
    run = engine_scan.make_runner(prob.device_grad, C, stream="device", n=N, T=1150,
                                  eval_fn=lambda w: torch.sum(w ** 2), eval_every=300)
    w, evals, ex = run(torch.zeros(prob.d), np.ones(N), np.full(N, 1 / N), 0, 0.05)
    assert evals.shape == (3,)  # evals at 300/600/900; tail 901..1150
    assert ex["t"].shape == (1150,) and ex["p_traj"].shape == (3, N)
    assert bool(torch.isfinite(evals).all()) and bool(torch.isfinite(w).all())
    # the reference's layout on the same draws: the same three points
    jr = jes.make_fused_runner(JQuadratic(prob.c).device_grad, N, C, 1150,
                               eval_fn=lambda w: jnp.sum(w ** 2), eval_every=300)
    key = jax.random.PRNGKey(0)
    wj, ej, _ = jax.jit(jr)(jnp.zeros(prob.d), jnp.ones(N), jnp.full(N, 1 / N), key, 0.05)
    wt, et, _ = run.from_draws(torch.zeros(prob.d), np.ones(N), np.full(N, 1 / N), 0.05,
                               *_draws(key, N, C, 1150, np.full(N, 1 / N)))
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-5)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-5)


def test_cell_axis_equals_each_cell_alone():
    """``vmap_scenarios``: B cells in lockstep, each bitwise its own run,
    per event (flat and K1's plain version) and blocked."""
    from repro_torch.kernels.ops import tree_weighted_update

    T, B = 150, 3
    prob = Quadratic(N)
    mus = np.stack([_mu_p(seed=b)[0] for b in range(B)])
    ps = np.stack([_mu_p(seed=b)[1] for b in range(B)])
    ds = [_draws(jax.random.PRNGKey(10 + b), N, C, T, ps[b]) for b in range(B)]
    st = [torch.stack(x) for x in zip(*ds)]
    for kw in (dict(), dict(update_fn=tree_weighted_update), dict(block_size=4),
               dict(adaptive=True, refresh_every=50)):
        wc, _, xc = engine_scan.make_fused_runner(prob.device_grad, N, C, T, vmap_scenarios=True,
                                                  **kw).from_draws(torch.zeros(prob.d), mus, ps,
                                                                   0.05, *st)
        one = engine_scan.make_fused_runner(prob.device_grad, N, C, T, **kw)
        for b in range(B):
            w1, _, x1 = one.from_draws(torch.zeros(prob.d), mus[b], ps[b], 0.05, *ds[b])
            atol = 1e-6 if kw.get("block_size") else 0.0
            np.testing.assert_allclose(wc[b].numpy(), w1.numpy(), atol=atol, rtol=0)
            assert torch.equal(xc["t"][b], x1["t"])
            np.testing.assert_allclose(xc["p_final"][b].numpy(), x1["p_final"].numpy(), atol=1e-7)


# ------------------------------------------------------------------ #
# the reference's bars, on the port's own generator
# ------------------------------------------------------------------ #
def test_matches_python_engine_in_law():
    """Same fixed point (the mean of the client optima) and a comparable
    residual spread: the realizations differ, the laws must not."""
    T = 3000
    prob = Quadratic(N)
    mu, p = _mu_p(seed=2)
    run = engine_scan.make_runner(prob.device_grad, C, stream="device", n=N, T=T)
    target = prob.c.mean(0)
    resid = [np.linalg.norm(run(torch.zeros(prob.d), mu, p, s, 0.05)[0].numpy() - target)
             for s in (0, 1, 2)]
    cfg = ServerConfig(n=N, C=C, T=T, eta=0.05, p=p, mu=mu, seed=0, device="cpu")
    w_py, _ = run_generalized_async_sgd(np.zeros(prob.d, np.float32), prob, cfg)
    resid_py = np.linalg.norm(w_py.numpy() - target)
    assert np.mean(resid) < 5 * max(resid_py, 0.05)
    assert resid_py < 5 * max(np.mean(resid), 0.05)


def test_extras_invariants():
    T = 3000
    prob = Quadratic(N)
    mu, p = _mu_p(seed=3)
    run = engine_scan.make_runner(prob.device_grad, C, stream="device", n=N, T=T)
    _, _, ex = run(torch.zeros(prob.d), mu, p, 0, 0.05)
    t = ex["t"].numpy()
    assert t.shape == (T,) and np.all(np.diff(t) >= 0)
    assert int(ex["comp"].sum()) == T
    assert float(ex["delay_sum"].sum()) / T == pytest.approx(C - 1, rel=0.05)
    assert float(ex["occ_mean"].sum()) == pytest.approx(C, abs=1e-3)


def test_fedbuff_on_the_device_stream():
    """FedBuff through `run_fedbuff(stream="device")`: finite, the event
    clock of T steps, and the host stream's noise-ball scale."""
    prob = Quadratic(N)
    cfg = ServerConfig(n=N, C=C, T=800, eta=0.05, seed=0, weighting="plain", engine="scan",
                       stream="device", device="cpu")
    w_dev, tr = run_fedbuff(np.zeros(prob.d, np.float32), prob, cfg, Z=5)
    assert bool(torch.isfinite(w_dev).all()) and tr.times.shape == (800,)
    w_host, _ = run_fedbuff(np.zeros(prob.d, np.float32), prob, replace(cfg, stream="host"), Z=5)
    assert np.linalg.norm(w_dev.numpy() - w_host.numpy()) < 1.0


def test_adaptive_converges_to_static_optimum_two_cluster():
    """Adaptive p (from measured rates) reaches the `optimize_general` bound
    within 5% on a two-cluster network, starting from uniform."""
    n, C_, T = 16, 4, 6000
    mu = np.array([8.0] * 8 + [1.0] * 8)
    k = BoundConstants(C=C_, T=T)
    run = engine_scan.make_runner(lambda j, w, kk: w * 0.0, C_, stream="device", n=n, T=T,
                                  adaptive=True, refresh_every=200, bound=k)
    _, _, ex = run(torch.zeros(2), mu, np.full(n, 1.0 / n), 1, 0.0)
    p_fin = ex["p_final"].numpy().astype(np.float64)
    p_fin /= p_fin.sum()
    opt = optimize_general(mu, k, iters=300)
    b_ad = bound_for_p(mu, p_fin, k)[0]
    assert b_ad <= 1.05 * opt.bound
    assert b_ad < 0.99 * opt.uniform_bound
    assert p_fin[0] < p_fin[-1]  # fast nodes under-sampled, like the static optimum
    traj = ex["p_traj"].numpy().astype(np.float64)
    assert b_ad <= bound_for_p(mu, traj[0] / traj[0].sum(), k)[0] + 1e-12


def test_importance_scale_uses_dispatch_time_p():
    """Under a changing p each task keeps its dispatch-time probability:
    with eta != 0 and adaptive on, the run stays unbiased toward the
    quadratic's fixed point."""
    n, C_, T = 8, 3, 4000
    prob = Quadratic(n)
    run = engine_scan.make_runner(prob.device_grad, C_, stream="device", n=n, T=T,
                                  adaptive=True, refresh_every=250, bound=BoundConstants(C=C_, T=T))
    w, _, _ = run(torch.zeros(prob.d), np.ones(n), np.full(n, 1.0 / n), 0, 0.05)
    assert np.linalg.norm(w.numpy() - prob.c.mean(0)) < 0.6


def test_validation_errors():
    from repro.core.stream_device import build_class_spec

    prob = Quadratic(N)
    mk = lambda **kw: engine_scan.make_runner(prob.device_grad, C, stream="device",  # noqa: E731
                                              **kw)
    with pytest.raises(ValueError, match="refresh_every"):
        mk(n=N, T=100, adaptive=True)
    with pytest.raises(ValueError, match="not FedBuff"):
        mk(n=N, T=100, adaptive=True, refresh_every=10, fedbuff_Z=5)
    with pytest.raises(ValueError, match="multiple of refresh_every"):
        mk(n=N, T=100, adaptive=True, refresh_every=30, eval_fn=lambda w: w, eval_every=50)
    with pytest.raises(TypeError, match="requires n="):
        mk()
    with pytest.raises(ValueError, match="default update"):
        mk(n=N, T=100, block_size=4, update_fn=lambda w, g, s: w)
    with pytest.raises(ValueError, match="exponential service only"):
        run_generalized_async_sgd(np.zeros(2, np.float32), prob,
                                  ServerConfig(n=N, C=2, T=10, eta=0.1, engine="scan",
                                               stream="device", service="det", device="cpu"))
    with pytest.raises(ValueError, match="default update"):
        run_generalized_async_sgd(np.zeros(4, np.float32), prob,
                                  ServerConfig(n=N, C=2, T=10, eta=0.1, engine="scan",
                                               stream="device", update="pallas", block_size=4,
                                               device="cpu"))
    # the guard runs on the device stream; with a staleness cutoff under
    # FedBuff it raises the reference's ValueError (as `jes.make_fused_runner`)
    from repro.core.engine_scan import GuardConfig as JGuardConfig

    with pytest.raises(ValueError, match="per-event update"):
        mk(n=N, T=100, guard=engine_scan.GuardConfig(stale_cutoff=5), fedbuff_Z=5,
           weighting="plain")
    with pytest.raises(ValueError, match="per-event update"):
        jes.make_fused_runner(JQuadratic(prob.c).device_grad, N, C, 100, fedbuff_Z=5,
                              weighting="plain", guard=JGuardConfig(stale_cutoff=5))
    # lanes (`tests/test_torch_shards.py` runs them): the reference's
    # ValueErrors for what does not compose, then a process group of the
    # ranks, never an unsharded run
    for kw, msg in ((dict(lane_devices=2), "block_size > 1"),
                    (dict(lane_devices=2, block_size=3), "multiple of"),
                    (dict(lane_devices=2, block_size=4), "process group"),
                    (dict(lane_devices=2, classes=build_class_spec(np.ones(N))[0]),
                     "requires lane_devices=1")):
        with pytest.raises(ValueError, match=msg):
            mk(n=N, T=100, **kw)
    with pytest.raises(ValueError, match="process group"):
        engine_scan.jit_fused_runner(prob.device_grad, N, C, 100, vmap_scenarios=True,
                                     shard_devices=2)
    # without the cell axis the reference ignores shard_devices: the unsharded runner
    assert (engine_scan.jit_fused_runner(prob.device_grad, N, C, 100, shard_devices=2)
            is engine_scan.jit_fused_runner(prob.device_grad, N, C, 100))
    # the sparse stream's ClassSpec must cover the runner's n (the reference's ValueError)
    other = build_class_spec(np.ones(N + 1))[0]
    with pytest.raises(ValueError, match="ClassSpec covers"):
        mk(n=N, T=100, classes=other)
    with pytest.raises(ValueError, match="ClassSpec covers"):
        jes.make_fused_runner(JQuadratic(prob.c).device_grad, N, C, 100, classes=other)
    # sparse=True, and "auto" at n >= SPARSE_AUTO_N (one speed class), run the
    # sparse stream, as the reference's do: every client's expanded mean
    # queue length is its class's share (the dense stream leaves idle
    # clients at 0), summing to C, and the weights approach the clients' mean
    from repro.core.async_sgd import ServerConfig as JServerConfig
    from repro.core.async_sgd import run_generalized_async_sgd as j_run

    for n_, T_, sparse in ((N, 400, True), (60_000, 200, "auto")):
        pr = prob if n_ == N else Quadratic(n_, d=2)
        kw = dict(n=n_, C=2, T=T_, eta=0.1, engine="scan", stream="device", sparse=sparse)
        w, tr = run_generalized_async_sgd(np.zeros(pr.d, np.float32), pr,
                                          ServerConfig(device="cpu", **kw))
        wj, trj = j_run(jnp.zeros(pr.d), JQuadratic(pr.c), JServerConfig(**kw))
        for t_ in (tr, trj):
            mql = np.asarray(t_.mean_queue_lengths)
            assert mql.shape == (n_,) and bool(np.all(mql > 0))
            np.testing.assert_allclose(mql.sum(), 2, rtol=1e-3)
            assert np.asarray(t_.extras["comp"]).sum() == pytest.approx(T_)
        target = pr.c.mean(0)
        gap_t, gap_j = np.linalg.norm(w.numpy() - target), np.linalg.norm(np.asarray(wj) - target)
        assert gap_t < 5 * max(gap_j, 0.05) and gap_j < 5 * max(gap_t, 0.05)
    r1 = engine_scan.jit_fused_runner(prob.device_grad, N, C, 100, adaptive=True,
                                      refresh_every=50)
    assert r1 is engine_scan.jit_fused_runner(prob.device_grad, N, C, 100, refresh_every=50,
                                              adaptive=True)


def test_block_size_auto_on_the_device_stream():
    prob = Quadratic(N)
    cfg = ServerConfig(n=N, C=C, T=300, eta=0.05, seed=1, engine="scan", stream="device",
                       block_size="auto", device="cpu")
    w, tr = run_generalized_async_sgd(np.zeros(prob.d, np.float32), prob, cfg)
    assert bool(torch.isfinite(w).all()) and tr.extras["comp"].sum() == 300


# ------------------------------------------------------------------ #
# the entry points
# ------------------------------------------------------------------ #
def test_run_experiment_device_stream_and_adaptive():
    flc = FLConfig(n_clients=16, concurrency=4, server_steps=200, stream="device", device="cpu")
    r = t_fl.run_experiment(flc, "gen_async", eval_every=50)
    assert r.extras["engine"] == "scan" and r.eval_acc.shape == (4,)
    assert np.isfinite(r.eval_acc).all() and r.mean_delays.shape == (16,)
    assert np.all(np.diff(r.eval_times) > 0)
    ra = t_fl.run_experiment(replace(flc, adaptive=True, refresh_every=50), "gen_async",
                             eval_every=100)
    assert ra.extras["p_traj"].shape == (4, 16)
    assert ra.extras["p_final"].sum() == pytest.approx(1.0, abs=1e-5)
    with pytest.raises(ValueError, match="scan engine"):
        t_fl.run_experiment(flc, "gen_async", engine="python")
    with pytest.raises(ValueError, match="adaptive"):
        t_fl.run_experiment(replace(flc, stream="host", adaptive=True), "gen_async")
    rb = t_fl.run_experiment(replace(flc, block_size=4), "fedbuff", eval_every=50)
    assert np.isfinite(rb.eval_acc).all()


def test_run_matrix_device_zero_host_presimulation(monkeypatch):
    """``stream="device"`` never touches the host simulator."""
    from repro_torch.core import queue_sim
    from repro_torch.data.pipeline import FederatedClassification

    def _boom(*a, **kw):
        raise AssertionError("host pre-simulation on the device path")

    monkeypatch.setattr(queue_sim, "export_stream", _boom)
    monkeypatch.setattr(t_fl, "matrix_streams", _boom)
    flc = FLConfig(n_clients=8, concurrency=3, server_steps=90, device="cpu")
    data = FederatedClassification(n_clients=8, seed=0)
    for E in (1, 4):
        m = t_fl.run_matrix(flc, seeds=(0, 1), policies=("uniform", "optimal"),
                            speed_ratios=(1.0, 4.0), eval_every=45, data=data, stream="device",
                            block_size=E)
        assert m.final_acc.shape == (2, 2, 2) and m.eval_acc.shape == (2, 2, 2, 2)
        assert np.all(np.diff(m.eval_times, axis=-1) >= 0)
        assert m.extras["stream"] == "device"
        assert m.extras["mean_delays"].shape == (2, 2, 2, 8)
        np.testing.assert_allclose(m.extras["p_final"].sum(-1), 1.0, atol=1e-5)
        np.testing.assert_allclose(m.extras["occ_mean"].sum(-1), 3.0, atol=1e-3)


def test_run_matrix_adaptive_beats_uniform():
    """Adaptive rows end with a better bound than their uniform start."""
    from repro_torch.data.pipeline import FederatedClassification, make_client_speeds

    n, C_, T = 12, 4, 2000
    flc = FLConfig(n_clients=n, concurrency=C_, server_steps=T, speed_ratio=8.0, stream="device",
                   adaptive=True, refresh_every=200, device="cpu")
    data = FederatedClassification(n_clients=n, seed=0)
    m = t_fl.run_matrix(flc, seeds=(0,), policies=("uniform",), speed_ratios=(8.0,),
                        eval_every=T, data=data)
    mu = make_client_speeds(n, flc.frac_fast, 8.0, seed=flc.seed)
    k = BoundConstants(C=C_, T=T)
    p_fin = m.extras["p_final"][0, 0, 0]
    p_fin = np.maximum(p_fin, 1e-12) / p_fin.sum()
    assert bound_for_p(mu, p_fin, k)[0] < bound_for_p(mu, np.full(n, 1 / n), k)[0]


def test_cli_lm_fused_runs_on_cpu(capsys):
    from repro_torch.launch import train as t_train

    t_train.main(["--mode", "lm", "--engine", "fused", "--preset", "small", "--device", "cpu",
                  "--steps", "8", "--clients", "4", "--concurrency", "2", "--batch", "2",
                  "--seq", "16", "--shard-size", "32", "--eval-every", "4"])
    out = capsys.readouterr().out
    losses = [float(line.split()[-1]) for line in out.splitlines() if "eval_loss" in line]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "mean delay overall" in out
