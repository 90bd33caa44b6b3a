"""PyTorch port, the device event stream and its control plane
(`repro_torch.core.stream_device`), held against the JAX package.

Three strengths, as ROADMAP's ground rules set them:

1. bitwise on identical inputs: the tree primitives and `kahan_add`; one
   `stream_step` / `stats_step` from the reference's state; the whole scan
   on the reference's own draws (`jax.random.split(key, 4)`, its
   ``stream_init`` placement and uniform blocks): J, K, slot, delays and the
   integer statistics bitwise, the times and float statistics <= 1e-6
   relative (XLA's and torch's ``log1p`` may differ by an ulp);
2. the control plane to the reference's numbers on the same inputs: MVA
   <= 1e-6, the bound <= 1e-6 and its gradient <= 1e-5, ``optimal_eta``
   <= 1e-5 (also where the Theorem-1 cap is active), ``estimate_mu`` and
   one ``ctrl_refresh`` <= 1e-5;
3. in law for the port's own generator, with the reference's bars
   (`tests/test_stream_device.py`) through `tests/stat_utils.py`: the
   40,000-event checks run as 8 cells x 5,000 events on the cell axis.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import stream_device as jsd  # noqa: E402
from repro.core.theory import BoundConstants as JBound  # noqa: E402
from repro_torch.core import JacksonNetwork, SimConfig, jit_runner, simulate, step_scales  # noqa: E402
from repro_torch.core import stream_device as sd  # noqa: E402
from repro_torch.core.theory import BoundConstants  # noqa: E402
from stat_utils import assert_frequencies, assert_little  # noqa: E402
from test_stream_device import _check_stream, _nonuniform_p  # noqa: E402

F32 = torch.float32


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


# ------------------------------------------------------------------ #
# primitives, bitwise
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("n", [1, 2, 5, 8, 13, 64, 100])
def test_tree_primitives_bitwise(n):
    rng = np.random.default_rng(n)
    w = rng.uniform(0.0, 3.0, n).astype(np.float32)
    w[rng.random(n) < 0.3] = 0.0  # zero-weight leaves are never drawn
    w[0] = max(w[0], 0.5)
    tj, tt = jsd.tree_build(jnp.asarray(w)), sd.tree_build(_t(w))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    u = np.concatenate([rng.random(500), [0.0, 1.0 - 2**-24, 0.5]]).astype(np.float32)
    dj = np.asarray(jax.vmap(lambda x: jsd.tree_sample(tj, x))(jnp.asarray(u)))
    dt = sd.tree_sample(tt, _t(u)).numpy()
    np.testing.assert_array_equal(dt, dj)
    assert np.all(w[dt] > 0)
    idx, val = int(rng.integers(n)), np.float32(rng.uniform(0, 2))
    np.testing.assert_array_equal(
        sd.tree_update(tt, torch.tensor(idx), torch.tensor(val)).numpy(),
        np.asarray(jsd.tree_update(tj, idx, jnp.float32(val))))
    # B trees at once, one draw each and several each
    W = rng.uniform(0.1, 2.0, (3, n)).astype(np.float32)
    TB = sd.tree_build(_t(W))
    for b in range(3):
        np.testing.assert_array_equal(TB[b].numpy(), np.asarray(jsd.tree_build(jnp.asarray(W[b]))))
    ub = rng.random((3, 7)).astype(np.float32)
    got = sd.tree_sample(TB, _t(ub))
    for b in range(3):
        np.testing.assert_array_equal(got[b].numpy(), sd.tree_sample(TB[b], _t(ub[b])).numpy())
    np.testing.assert_array_equal(sd.tree_sample(TB, _t(ub[:, 0])).numpy(), got[:, 0].numpy())


def test_kahan_bitwise_and_stall_free():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1e-3, 4000).astype(np.float32)
    sj = cj = jnp.float32(2.0**24)
    cj = jnp.float32(0.0)
    st, ct = torch.tensor(2.0**24, dtype=F32), torch.tensor(0.0, dtype=F32)
    for v in x:
        sj, cj = jsd.kahan_add(sj, cj, jnp.float32(v))
        st, ct = sd.kahan_add(st, ct, torch.tensor(v))
    assert st.item() == float(sj) and ct.item() == float(cj)
    total = sd.kahan_value(st, ct)
    assert total == pytest.approx(2.0**24 + x.astype(np.float64).sum(), rel=1e-7)
    s, c = sd._kahan_scatter_add(torch.zeros(4), torch.zeros(4), torch.tensor(2), torch.tensor(1.5))
    assert s.tolist() == [0, 0, 1.5, 0] and c.tolist() == [0, 0, 0, 0]


def _ref_draws(key, n, C, T, p, init="distinct"):
    """The reference's draws of one stream (`stream_device._network_scan`):
    its initial placement and the three uniform blocks, plus K from the
    dispatch uniforms through its segment tree."""
    k_init, k_race, k_exp, k_disp = jax.random.split(key, 4)
    _, nodes = jsd.stream_init(k_init, n, C, jnp.asarray(p, jnp.float32), init=init)
    u_disp = jax.random.uniform(k_disp, (T,))
    ptree = jsd.tree_build(jnp.asarray(p, jnp.float32))
    K = jax.vmap(lambda u: jsd.tree_sample(ptree, u))(u_disp)
    return [np.asarray(a) for a in (nodes, jax.random.uniform(k_race, (T,)),
                                    jax.random.uniform(k_exp, (T,)), u_disp, K)]


def test_one_step_bitwise_from_the_reference_state():
    n, C = 7, 5
    rng = np.random.default_rng(1)
    mu = rng.uniform(0.5, 4.0, n).astype(np.float32)
    p = _nonuniform_p(n)
    js, nodes = jsd.stream_init(jax.random.PRNGKey(2), n, C, jnp.asarray(p, jnp.float32))
    jstats = jsd.stats_init(n, C)
    ts, _ = sd.stream_init(_t(nodes), n, C)
    tstats = sd.stats_init(n, C, device="cpu")
    for k, (ur, ue, kn) in enumerate([(0.3, 0.7, 2), (0.9, 0.1, 0), (0.5, 0.5, 6), (0.01, 0.99, 2)]):
        occ_j, occ_t = js.occ, ts.occ
        js, ev_j = jsd.stream_step(js, jnp.asarray(mu), (jnp.float32(ur), jnp.float32(ue),
                                                         jnp.int32(kn)))
        ts, ev_t = sd.stream_step(ts, _t(mu), (torch.tensor(ur, dtype=F32),
                                               torch.tensor(ue, dtype=F32), torch.tensor(kn)))
        jstats = jsd.stats_step(jstats, ev_j, occ_j, js.occ, k)
        tstats = sd.stats_step(tstats, ev_t, occ_t, ts.occ, k)
        for f in ("occ", "ring", "head", "tail"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)))
        assert int(ev_t.j) == int(ev_j.j) and int(ev_t.slot) == int(ev_j.slot)
        assert float(ev_t.t) == pytest.approx(float(ev_j.t), rel=1e-6)
        for f in ("occ_sum", "comp", "slot_step"):
            np.testing.assert_array_equal(getattr(tstats, f).numpy(), np.asarray(getattr(jstats, f)))
        for f in ("occ_tw", "busy_t", "delay_sum"):
            np.testing.assert_allclose(getattr(tstats, f).numpy(), np.asarray(getattr(jstats, f)),
                                       rtol=1e-6)


@pytest.mark.parametrize("C,init", [(1, "distinct"), (4, "distinct"), (12, "distinct"),
                                    (4, "sampled")])
def test_scan_on_the_reference_draws_bitwise(C, init):
    n, T = 9, 600
    rng = np.random.default_rng(C)
    mu = rng.uniform(0.3, 4.0, n)
    p = _nonuniform_p(n, seed=C + 2)
    key = jax.random.PRNGKey(C)
    gen = jax.jit(jsd._network_scan(n, C, T, init, emit_events=True))
    nj, (J, K, t, slot, delay), stats = gen(key, jnp.asarray(mu, jnp.float32),
                                            jnp.asarray(p, jnp.float32))
    nodes, u_race, u_exp, _, Kd = _ref_draws(key, n, C, T, p, init)
    np.testing.assert_array_equal(Kd, np.asarray(K))
    nt, ev, st = sd.scan_draws(_t(mu, F32), _t(nodes), _t(u_race), _t(u_exp), _t(Kd))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    for got, want in zip((ev[0], ev[1], ev[3], ev[4]), (J, K, slot, delay)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _rel(ev[2].numpy(), t) <= 1e-6
    for f in ("occ_sum", "comp", "slot_step"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(stats, f)))
    for f in ("occ_tw", "busy_t", "delay_sum"):
        np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(stats, f)),
                                   rtol=1e-6, atol=1e-6)


def test_cell_axis_equals_each_cell_alone():
    """B networks in lockstep along the leading axis give each network's
    own run, bitwise."""
    n, C, T, B = 6, 3, 300, 3
    mu = np.stack([np.linspace(0.5, 2.0 + b, n) for b in range(B)]).astype(np.float32)
    p = _nonuniform_p(n)
    draws = [_ref_draws(jax.random.PRNGKey(b), n, C, T, p) for b in range(B)]
    nodes, ur, ue, _, K = (np.stack(a) for a in zip(*draws))
    _, ev, st = sd.scan_draws(_t(mu), _t(nodes), _t(ur), _t(ue), _t(K))
    for b in range(B):
        _, ev1, st1 = sd.scan_draws(_t(mu[b]), _t(nodes[b]), _t(ur[b]), _t(ue[b]), _t(K[b]))
        for x, y in zip(ev, ev1):
            assert torch.equal(x[b], y)
        for x, y in zip(st, st1):
            if isinstance(x, torch.Tensor):
                assert torch.equal(x[b], y)


# ------------------------------------------------------------------ #
# the port's own generator, in law (the reference's bars)
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("C,init", [(1, "distinct"), (3, "distinct"), (12, "distinct"),
                                    (4, "sampled"), (9, "distinct")])  # 9 > n: round-robin
def test_invariants(C, init):
    n = 5
    p = _nonuniform_p(n, seed=C + 2)
    mu = np.random.default_rng(C).uniform(0.3, 4.0, n)
    _check_stream(sd.generate_stream(mu, p, C, T=400, seed=C, init=init, device="cpu"))


def test_deterministic_given_seed_and_generator():
    mu, p = np.array([1.0, 2.0]), np.array([0.5, 0.5])
    s1 = sd.generate_stream(mu, p, C=3, T=500, seed=7, device="cpu")
    s2 = sd.generate_stream(mu, p, C=3, T=500, seed=7, device="cpu")
    s3 = sd.generate_stream(mu, p, C=3, T=500, seed=torch.Generator().manual_seed(7),
                            device="cpu")
    for s in (s2, s3):
        np.testing.assert_array_equal(s1.J, s.J)
        np.testing.assert_array_equal(s1.slot, s.slot)
        np.testing.assert_array_equal(s1.t, s.t)
    assert not np.array_equal(s1.J, sd.generate_stream(mu, p, C=3, T=500, seed=8,
                                                       device="cpu").J)


def _cells_stream(mu, p, C, T, seed, cells=8):
    """``cells`` independent streams of T events from the port's generator
    (seeds ``seed * 100 + b``), advanced together on the cell axis."""
    n = len(mu)
    draws = [sd.draw_uniforms(seed * 100 + b, n, C, T, p, device="cpu") for b in range(cells)]
    nodes, ur, ue, ud = (torch.stack(a) for a in zip(*draws))
    K = sd.tree_sample(sd.tree_build(_t(p, F32).expand(cells, n)), ud)
    _, (J, K, t, slot, delay), st = sd.scan_draws(_t(np.broadcast_to(mu, (cells, n)), F32),
                                                  nodes, ur, ue, K)
    return J.numpy(), K.numpy(), t.numpy().astype(np.float64), delay.numpy(), st


def test_chi_square_completions_and_dispatches():
    """J and K frequencies match T p (flow balance on the complete graph)."""
    n = 6
    p = np.array([0.3, 0.25, 0.2, 0.1, 0.1, 0.05])
    mu = np.random.default_rng(2).uniform(0.5, 4.0, n)
    J, K, _, _, _ = _cells_stream(mu, p, 4, 5000, seed=0)
    assert_frequencies(K.ravel(), p, label="dispatch")
    assert_frequencies(J.ravel(), p, label="completion")


def test_littles_law_and_occupancy():
    """sum_i p_i m_i = C-1 and the running occupancy against product form
    (time-weighted) and the host oracle (event-sampled)."""
    n, C, T, cells = 6, 4, 5000, 8
    p = _nonuniform_p(n, seed=3)
    mu = np.random.default_rng(4).uniform(0.5, 4.0, n)
    _, _, t, delay, st = _cells_stream(mu, p, C, T, seed=1, cells=cells)
    assert_little(delay.ravel(), C)
    tw = sd.kahan_value(st.occ_tw, st.occ_tw_c).sum(0) / t[:, -1].sum()
    np.testing.assert_allclose(tw, JacksonNetwork(mu=mu, p=p, C=C).mean_queue_lengths(),
                               rtol=0.12, atol=0.06)
    host = simulate(SimConfig(mu=mu, p=p, C=C, T=cells * T, seed=1))
    np.testing.assert_allclose(st.occ_sum.numpy().sum(0) / (cells * T),
                               host.queue_len_sum / (cells * T), rtol=0.1, atol=0.05)
    assert int(st.occ_sum.sum()) == cells * C * T


def test_delay_means_match_host_sim():
    n, C, T, cells = 6, 4, 5000, 8
    p = _nonuniform_p(n, seed=1)
    mu = np.random.default_rng(0).uniform(0.5, 4.0, n)
    J, _, t, delay, _ = _cells_stream(mu, p, C, T, seed=2, cells=cells)
    host = simulate(SimConfig(mu=mu, p=p, C=C, T=cells * T, seed=0, record_delays=True))
    d_dev = np.array([delay[J == i].mean() for i in range(n)])
    np.testing.assert_allclose(d_dev, host.mean_delay_per_node(), rtol=0.2, atol=0.2)
    # the time axis: throughput agrees between the two simulators
    assert t[:, -1].sum() == pytest.approx(host.t[-1], rel=0.05)


def test_replayable_through_host_engine():
    """A device-generated stream drives the host-replay engine like a
    host-simulated one (and its blocks, the blocked engine)."""
    from test_torch_engine import Quadratic

    n, C, T = 6, 3, 300
    prob = Quadratic(n)
    p = _nonuniform_p(n)
    stream = sd.generate_stream(np.ones(n), p, C, T=T, seed=5, device="cpu")
    scale = torch.tensor(step_scales(stream, 0.05, p, "importance"), dtype=F32)
    run = jit_runner(prob.device_grad, C)
    w, _ = run(torch.zeros(prob.d), torch.tensor(stream.J).long(), torch.tensor(stream.slot).long(),
               scale)
    assert bool(torch.isfinite(w).all())
    blocks = sd.generate_blocks(np.ones(n), p, C, T, 4, seed=5, device="cpu")
    assert blocks.T == T and (blocks.J[blocks.mask] == stream.J[blocks.idx[blocks.mask]]).all()


def test_generators_reject_unported_options():
    """Faults and scenarios run in the generators (held against the
    reference in `tests/test_torch_stream_robust.py`): the kind column of T
    merged events; the two exclude each other with the reference's
    ValueError, and the class-collapsed control plane (``counts=``) gives
    the reference's numbers."""
    from repro_torch.core import FaultConfig, get_scenario

    es = sd.generate_stream(np.ones(3), np.full(3, 1 / 3), 2, 10, fault=FaultConfig(crash_rate=0.1),
                            device="cpu")
    assert es.kind.shape == (10,) and set(es.kind.tolist()) <= {0, 1}
    es = sd.generate_stream(np.ones(3), np.full(3, 1 / 3), 2, 10,
                            scenario=get_scenario("erlang2"), device="cpu")
    assert es.kind.shape == (10,) and set(es.kind.tolist()) <= {0, 5}
    with pytest.raises(ValueError, match="mutually exclusive"):
        sd.generate_stream(np.ones(3), np.full(3, 1 / 3), 2, 10, fault=FaultConfig(crash_rate=0.1),
                           scenario=get_scenario("erlang2"), device="cpu")
    md, lam = sd.mva_throughput_delays(_t([1.0, 2.5]), _t([0.25, 0.125]), 3, counts=(2, 4))
    mdj, lamj = jsd.mva_throughput_delays(jnp.asarray([1.0, 2.5]), jnp.asarray([0.25, 0.125]), 3,
                                          counts=(2, 4))
    np.testing.assert_allclose(md.numpy(), np.asarray(mdj), rtol=1e-6)
    assert float(lam) == pytest.approx(float(lamj), rel=1e-6)
    with pytest.raises(ValueError, match="sum to 1"):
        sd.generate_stream(np.ones(3), np.full(3, 0.3), 2, 10, device="cpu")
    stats = sd.stats_stream_fn(4, 2, 50)(0, np.ones(4), np.full(4, 0.25), device="cpu")
    assert int(stats.comp.sum()) == 50 and int(stats.occ_sum.sum()) == 2 * 50


@pytest.mark.parametrize("init", ["stats_init", "sparse_stats_init"])
def test_stats_constructors_default_to_the_card(init):
    """The statistics' constructors take the card unless asked for the CPU,
    as the stream's other state constructors do."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="cuda"):
        getattr(sd, init)(4, 2, fault=True)
    stats = getattr(sd, init)(4, 2, fault=True, device="cpu")
    assert stats.occ_sum.device.type == "cpu" and stats.kind_count.shape == (4,)


# ------------------------------------------------------------------ #
# the control plane against the reference
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("C", [1, 4, 64])
def test_mva_matches_reference_and_buzen(C):
    n = 16
    rng = np.random.default_rng(C)
    mu = rng.uniform(0.5, 8.0, n).astype(np.float32)
    p = _nonuniform_p(n, seed=C + 1).astype(np.float32)
    m, lam = sd.mva_throughput_delays(_t(mu), _t(p), C)
    mj, lamj = jsd.mva_throughput_delays(jnp.asarray(mu), jnp.asarray(p), C)
    np.testing.assert_allclose(m.numpy(), np.asarray(mj), rtol=1e-6, atol=1e-7)
    assert float(lam) == pytest.approx(float(lamj), rel=1e-6)
    p64 = p.astype(np.float64)
    net = JacksonNetwork(mu=mu.astype(np.float64), p=p64 / p64.sum(), C=C)
    np.testing.assert_allclose(m.numpy(), net.expected_delays(), rtol=1e-5, atol=1e-6)
    assert float(lam) == pytest.approx(net.throughput(), rel=1e-5)
    # a cell axis: each row its own network
    m2, lam2 = sd.mva_throughput_delays(_t(np.stack([mu, mu[::-1]])), _t(np.stack([p, p])), C)
    np.testing.assert_allclose(m2[0].numpy(), m.numpy(), rtol=1e-6)
    assert lam2.shape == (2,)


def _points(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 6.0, n).astype(np.float32),
            _nonuniform_p(n, seed=seed + 6).astype(np.float32))


@pytest.mark.parametrize("T,active", [(3000, False), (8, True)])
def test_bound_value_and_grad_match_reference(T, active):
    """At a generic point and where the Theorem-1 cap is the minimizer."""
    n, C = 12, 6
    mu, p = _points(n, 5)
    kt, kj = BoundConstants(C=C, T=T), JBound(C=C, T=T)
    v, g = sd.make_bound_value_and_grad(kt)(_t(p), _t(mu))
    vj, gj = jsd.make_bound_value_and_grad(kj)(jnp.asarray(p), jnp.asarray(mu))
    assert float(v) == pytest.approx(float(vj), rel=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), atol=1e-5 * np.abs(np.asarray(gj)).max())
    m, _ = sd.mva_throughput_delays(_t(mu), _t(p), C)
    eta = sd.optimal_eta_jnp(_t(p), m, kt)
    etaj = jsd.optimal_eta_jnp(jnp.asarray(p), jnp.asarray(m.numpy()), kj)
    assert float(eta) == pytest.approx(float(etaj), rel=1e-5)
    from repro_torch.core.theory import eta_max_components

    cap = min(eta_max_components(p.astype(np.float64), m.numpy().astype(np.float64), kt))
    assert (abs(float(eta) - cap) <= 1e-6 * cap) == active


def test_optimal_eta_newton_matches_roots():
    from repro_torch.core.theory import optimal_eta

    n = 8
    for seed in (0, 1, 2):
        mu, p = _points(n, seed)
        k = BoundConstants(C=4, T=1000 * (seed + 1))
        m, _ = sd.mva_throughput_delays(_t(mu), _t(p), k.C)
        eta = sd.optimal_eta_jnp(_t(p), m, k)
        assert float(eta) == pytest.approx(optimal_eta(p.astype(np.float64),
                                                       m.numpy().astype(np.float64), k), rel=1e-5)


def test_estimate_mu_and_ctrl_refresh_match_reference():
    n, C = 10, 4
    rng = np.random.default_rng(3)
    comp = rng.integers(0, 400, n)
    comp[2] = 0
    busy = rng.uniform(0.0, 300.0, n).astype(np.float32)
    busy[2] = 0.0  # a dark node: floored, finite
    est = sd.estimate_mu(_t(comp), _t(busy))
    estj = jsd.estimate_mu(jnp.asarray(comp), jnp.asarray(busy))
    np.testing.assert_allclose(est.numpy(), np.asarray(estj), rtol=1e-6)
    assert bool(torch.isfinite(est).all()) and float(est[2]) > 0
    p = _nonuniform_p(n, seed=9).astype(np.float32)
    k, kj = BoundConstants(C=C, T=2000), JBound(C=C, T=2000)
    p1 = sd.ctrl_refresh(_t(p), _t(comp), _t(busy), k)
    p1j = jsd.ctrl_refresh(jnp.asarray(p), jnp.asarray(comp), jnp.asarray(busy), kj)
    np.testing.assert_allclose(p1.numpy(), np.asarray(p1j), atol=1e-5)
    assert float(p1.sum()) == pytest.approx(1.0, abs=1e-6)
    # a cell axis: each row refreshed on its own
    pb = sd.ctrl_refresh(_t(np.stack([p, p])), _t(np.stack([comp, comp])),
                         _t(np.stack([busy, busy])), k)
    np.testing.assert_allclose(pb[1].numpy(), p1.numpy(), atol=1e-7)
