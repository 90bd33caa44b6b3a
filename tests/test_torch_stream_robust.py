"""PyTorch port, faults, the divergence guard, scenarios and the
checkpointed fused driver on the device event stream, held against the JAX
package (`repro.core.stream_device`, `engine_scan.make_fused_runner`,
`engine_ckpt.run_checkpointed`).

Three strengths, as ROADMAP's ground rules set them:

1. on the reference's own draws: `fault_stream_step` and
   `scenario_stream_step` from the reference's state bitwise (the float
   state <= 1e-6); the fault
   and scenario streams through `scan_draws` with J, K, slot, kind, delays
   and the integer statistics exact, times and float statistics <= 1e-6
   relative; the fused runner under faults and the guard, and under a
   scenario, with weights and ``p_traj`` <= 1e-5 of the reference's,
   ``guard_rejects``, ``stale_drops`` and ``kind_count`` exact and
   ``avail_time`` <= 1e-6 relative; the checkpointed fused driver on the
   reference's per-chunk ``fold_in`` draws <= 1e-5;
2. the port against itself: blocked against per event under faults
   (<= 1e-5, counters exact), truncate-and-resume and resume-from-final
   bitwise, a disabled scenario bitwise ``scenario=None``;
3. in law on the port's own generator, with the reference's bars
   (`tests/test_faults.py`, `tests/test_scenarios.py`) through
   `tests/stat_utils.py`, on the cell axis to keep the CPU run short:
   conservation, Little's law, the kind mix against the host stream,
   availability stationarity.
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine_ckpt as jck  # noqa: E402
from repro.core import engine_scan as jes  # noqa: E402
from repro.core import stream_device as jsd  # noqa: E402
from repro.core.engine_scan import GuardConfig as JGuardConfig  # noqa: E402
from repro.core.queue_sim import FaultConfig as JFaultConfig  # noqa: E402
from repro.core.scenario import get_scenario as j_get_scenario  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.core import ServerConfig, run_generalized_async_sgd  # noqa: E402
from repro_torch.core import engine_ckpt as ck  # noqa: E402
from repro_torch.core import engine_scan  # noqa: E402
from repro_torch.core import stream_device as sd  # noqa: E402
from repro_torch.core.engine_scan import GuardConfig  # noqa: E402
from repro_torch.core.queue_sim import KIND_COMPLETE, FaultConfig, SimConfig, export_stream  # noqa: E402
from repro_torch.core.scenario import SCENARIOS, get_scenario  # noqa: E402
from repro_torch.fl import engine as t_fl  # noqa: E402
from stat_utils import assert_little, assert_onoff_stationary  # noqa: E402
from test_stream_device import _nonuniform_p  # noqa: E402
from test_torch_engine import JQuadratic, Quadratic  # noqa: E402

F32 = torch.float32
N, C = 8, 4
FAULT = dict(off_rate=0.2, on_rate=1.0, crash_rate=0.05, timeout_rate=0.1)
FAULTS = {
    "bench": FAULT,
    "crash": dict(crash_rate=0.3),
    "churn_per_node": dict(off_rate=tuple(np.linspace(0.1, 0.6, N)), on_rate=0.8,
                           timeout_rate=0.05),
}
ENABLED = sorted(k for k, v in SCENARIOS.items() if v.enabled)
MODULATED = [k for k in ENABLED if SCENARIOS[k].modulation is not None]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def _mu_p(n=N, seed=0):
    return np.random.default_rng(seed).uniform(0.5, 4.0, n), _nonuniform_p(n, seed=seed + 1)


def _ref_draws(key, n, C, T, p, scenario=False):
    """The reference's draws of one stream: ``(nodes, u_race, u_exp,
    u_disp[, u_ph, u_phase0])`` as numpy arrays, and K from ``u_disp``
    through its segment tree.  A fault stream splits the key as the plain
    one (`stream_device._network_scan`); a scenario stream splits it in 5
    and its ``scenario_stream_init`` splits ``k_init`` into the placement
    key and the initial-phase key."""
    pj = jnp.asarray(p, jnp.float32)
    if scenario:
        k_init, k_race, k_exp, k_disp, k_ph = jax.random.split(key, 5)
        k_place, k_ph0 = jax.random.split(k_init)
    else:
        k_place, k_race, k_exp, k_disp = jax.random.split(key, 4)
    _, nodes = jsd.stream_init(k_place, n, C, pj)
    u_disp = jax.random.uniform(k_disp, (T,))
    ptree = jsd.tree_build(pj)
    K = jax.vmap(lambda u: jsd.tree_sample(ptree, u))(u_disp)
    draws = [nodes, jax.random.uniform(k_race, (T,)), jax.random.uniform(k_exp, (T,)), u_disp]
    if scenario:
        draws += [jax.random.uniform(k_ph, (T,)), jax.random.uniform(k_ph0, (C,))]
    return [np.asarray(a) for a in draws], np.asarray(K)


def _t_draws(key, n, C, T, p, scenario=False):
    """The reference's draws as the port's `run.from_draws` takes them."""
    return [torch.tensor(a) for a in _ref_draws(key, n, C, T, p, scenario)[0]]


def _same_stream(tev, tst, jev, jst, tagged_stats=True):
    J, K, t, slot, delay, kind = (np.asarray(a) for a in jev)
    for got, want in zip((tev[0], tev[1], tev[3], tev[4], tev[5]), (J, K, slot, delay, kind)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert _rel(tev[2].numpy(), t) <= 1e-6
    for f in ("occ_sum", "comp", "slot_step") + (("kind_count",) if tagged_stats else ()):
        np.testing.assert_array_equal(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)))
    for f in ("occ_tw", "busy_t", "delay_sum") + (("avail_tw",) if tagged_stats else ()):
        assert _rel(getattr(tst, f).numpy(), getattr(jst, f)) <= 1e-6


# ------------------------------------------------------------------ #
# one step from the reference's state, bitwise
# ------------------------------------------------------------------ #
def _state_t(js):
    return sd.StreamState(*(None if x is None else torch.tensor(np.asarray(x)).to(
        torch.int64 if np.asarray(x).dtype.kind == "i" else F32) for x in js))


def _stats_t(jst):
    return sd.StatsState(*(None if x is None else torch.tensor(np.asarray(x)).to(
        torch.int64 if np.asarray(x).dtype.kind == "i" else F32) for x in jst))


def _assert_state(ts, js):
    """Integer state bitwise; the float state (times, integrals and their
    Kahan compensations) within 1e-6, as XLA's and torch's ``log1p`` may
    differ by an ulp (`tests/test_torch_stream.py`)."""
    for a, b in zip(ts, js):
        if b is None:
            assert a is None
        elif np.asarray(b).dtype.kind == "f":
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fault_step_bitwise_from_the_reference_state():
    """A run of `fault_stream_step` + `fault_stats_step` from the reference's
    state (flips, crashes and timeouts included): the integer state, the
    event and the integer statistics bitwise after every step."""
    n, C_ = 6, 4
    mu = np.random.default_rng(1).uniform(0.5, 4.0, n).astype(np.float32)
    fc = dict(off_rate=0.8, on_rate=0.5, crash_rate=0.6, timeout_rate=0.7)
    jfr, tfr = jsd.resolve_fault_rates(JFaultConfig(**fc), n), sd.resolve_fault_rates(
        FaultConfig(**fc), n, "cpu")
    js, nodes = jsd.stream_init(jax.random.PRNGKey(2), n, C_, jnp.full(n, 1 / n), fault=True)
    jst = jsd.stats_init(n, C_, fault=True)
    ts, _ = sd.stream_init(torch.tensor(np.asarray(nodes)), n, C_, fault=True)
    tst = sd.stats_init(n, C_, fault=True, device="cpu")
    rng = np.random.default_rng(3)
    kinds = set()
    for k in range(60):
        ur, ue, kn = np.float32(rng.random()), np.float32(rng.random()), int(rng.integers(n))
        occ_j, av_j, occ_t, av_t = js.occ, js.avail, ts.occ, ts.avail
        js, jev = jsd.fault_stream_step(js, jnp.asarray(mu), jfr, (ur, ue, jnp.int32(kn)))
        jst = jsd.fault_stats_step(jst, jev, occ_j, av_j, js.occ, k)
        ts, tev = sd.fault_stream_step(ts, mu, tfr, (ur, ue, kn))
        tst = sd.fault_stats_step(tst, tev, occ_t, av_t, ts.occ, k)
        _assert_state(ts, js)
        _assert_state(tst, jst)
        for f in ("j", "k", "slot", "kind"):
            assert int(getattr(tev, f)) == int(getattr(jev, f))
        assert float(tev.t) == float(jev.t) or _rel(float(tev.t), float(jev.t)) <= 1e-6
        kinds.add(int(jev.kind))
    assert kinds == {0, 1, 2, 3}


@pytest.mark.parametrize("name", ["erlang2_onoff", "hyperexp2", "onoff"])
def test_scenario_step_bitwise_from_the_reference_state(name):
    """A run of `scenario_stream_step` + `scenario_stats_step` from the
    reference's state: the integer state (phases included), the event and
    the integer statistics bitwise after every step."""
    n, C_ = 5, 3
    mu = np.random.default_rng(1).uniform(0.5, 4.0, n).astype(np.float32)
    jsr, tsr = jsd.resolve_scenario(j_get_scenario(name), n), sd.resolve_scenario(
        get_scenario(name), n, "cpu")
    js, nodes = jsd.scenario_stream_init(jax.random.PRNGKey(4), n, C_, jnp.full(n, 1 / n), jsr)
    jst = jsd.stats_init(n, C_, scenario=True)
    ts = _state_t(js)
    tst = sd.stats_init(n, C_, scenario=True, device="cpu")
    rng = np.random.default_rng(5)
    for k in range(60):
        ur, ue, up = (np.float32(rng.random()) for _ in range(3))
        kn = int(rng.integers(n))
        pre_j = (js.occ, js.avail, js.avail + (1.0 - js.avail) * jsr.rate_scale)
        pre_t = (ts.occ, ts.avail, ts.avail + (1.0 - ts.avail) * tsr.rate_scale)
        js, jev = jsd.scenario_stream_step(js, jnp.asarray(mu), jsr, (ur, ue, jnp.int32(kn), up))
        jst = jsd.scenario_stats_step(jst, jev, *pre_j, js.occ, k)
        ts, tev = sd.scenario_stream_step(ts, mu, tsr, (ur, ue, kn, up))
        tst = sd.scenario_stats_step(tst, tev, *pre_t, ts.occ, k)
        _assert_state(ts, js)
        _assert_state(tst, jst)
        for f in ("j", "k", "slot", "kind"):
            assert int(getattr(tev, f)) == int(getattr(jev, f))


# ------------------------------------------------------------------ #
# the whole stream on the reference's draws
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_stream_on_the_reference_draws(fault):
    n, T = N, 500
    mu, p = _mu_p(n, seed=2)
    gen = jsd._network_scan(n, C, T, "distinct", True, fault=True)
    key = jax.random.PRNGKey(7)
    jnodes, jev, jst = gen(key, jnp.asarray(mu, jnp.float32), jnp.asarray(p, jnp.float32),
                           jsd.resolve_fault_rates(JFaultConfig(**FAULTS[fault]), n))
    (nodes, ur, ue, _), K = _ref_draws(key, n, C, T, p)
    tn, tev, tst = sd.scan_draws(torch.tensor(mu, dtype=F32), torch.tensor(nodes),
                                 torch.tensor(ur), torch.tensor(ue), torch.tensor(K),
                                 fault=FaultConfig(**FAULTS[fault]))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jnodes))
    _same_stream(tev, tst, jev, jst)
    kinds = np.bincount(tev[5].numpy(), minlength=4)
    assert kinds.sum() == T and (tev[3].numpy()[tev[5].numpy() == 3] == C).all()


@pytest.mark.parametrize("name", ENABLED)
def test_scenario_stream_on_the_reference_draws(name):
    n, T = 6, 500
    mu, p = _mu_p(n, seed=3)
    gen = jsd._network_scan(n, C, T, "distinct", True, scenario=True)
    key = jax.random.PRNGKey(8)
    jnodes, jev, jst = gen(key, jnp.asarray(mu, jnp.float32), jnp.asarray(p, jnp.float32),
                           jsd.resolve_scenario(j_get_scenario(name), n))
    (nodes, ur, ue, _, uph, u0), K = _ref_draws(key, n, C, T, p, scenario=True)
    tn, tev, tst = sd.scan_draws(torch.tensor(mu, dtype=F32), torch.tensor(nodes),
                                 torch.tensor(ur), torch.tensor(ue), torch.tensor(K),
                                 scenario=get_scenario(name), u_ph=torch.tensor(uph),
                                 u_phase0=torch.tensor(u0))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jnodes))
    _same_stream(tev, tst, jev, jst)
    assert tst.kind_count.shape == (6,) and int(tst.kind_count.sum()) == T


def test_fault_stream_cell_axis_equals_each_cell():
    """B fault streams on the cell axis: each cell bitwise its own run."""
    n, T, B = N, 200, 3
    fault = FaultConfig(**FAULT)
    mus = np.stack([_mu_p(n, seed=b)[0] for b in range(B)]).astype(np.float32)
    ds = [_ref_draws(jax.random.PRNGKey(20 + b), n, C, T, _mu_p(n, seed=b)[1]) for b in range(B)]
    st = [torch.tensor(np.stack(x)) for x in zip(*[d[0][:3] + [d[1]] for d in ds])]
    _, evc, stc = sd.scan_draws(torch.tensor(mus), st[0], st[1], st[2], st[3], fault=fault)
    for b in range(B):
        _, ev1, st1 = sd.scan_draws(torch.tensor(mus[b]), st[0][b], st[1][b], st[2][b], st[3][b],
                                    fault=fault)
        for x, y in zip(evc, ev1):
            assert torch.equal(x[b], y)
        for f in ("occ_tw", "busy_t", "avail_tw", "kind_count", "slot_step"):
            assert torch.equal(getattr(stc, f)[b], getattr(st1, f))


# ------------------------------------------------------------------ #
# the fused runner against the reference's
# ------------------------------------------------------------------ #
_GUARD = dict(max_grad_norm=1.0, stale_cutoff=6)
_FUSED_FAULT_CASES = {
    "faults_guard": dict(fault=FAULT, guard=_GUARD),
    "faults_guard_plain": dict(fault=FAULT, guard=_GUARD, weighting="plain"),
    "faults_eval": dict(fault=FAULTS["churn_per_node"], guard=dict(max_grad_norm=0.0),
                        eval_every=150),
    "faults_adaptive": dict(fault=FAULT, adaptive=True, refresh_every=200, eval_every=200),
    "guard_only": dict(guard=_GUARD),
    "faults_guard_blocked": dict(fault=FAULT, guard=_GUARD, block_size=4, eval_every=150),
}


def _kw_pair(kw):
    """One case's keywords for the reference's runner and for the port's."""
    j, t = dict(kw), dict(kw)
    if "fault" in kw:
        j["fault"], t["fault"] = JFaultConfig(**kw["fault"]), FaultConfig(**kw["fault"])
    if "guard" in kw:
        j["guard"], t["guard"] = JGuardConfig(**kw["guard"]), GuardConfig(**kw["guard"])
    if "scenario" in kw:
        j["scenario"], t["scenario"] = j_get_scenario(kw["scenario"]), get_scenario(kw["scenario"])
    return j, t


def _fused_pair(kw, T, key, mu, p, scen=False, prob=None):
    prob = prob or Quadratic(N)
    jkw, tkw = _kw_pair(kw)
    ev = kw.get("eval_every")
    jr = jes.make_fused_runner(JQuadratic(prob.c).device_grad, N, C, T,
                               eval_fn=(lambda w: jnp.sum(w ** 2)) if ev else None, **jkw)
    out_j = jax.jit(jr)(jnp.zeros(prob.d), jnp.asarray(mu), jnp.asarray(p), key, 0.05)
    tr = engine_scan.make_fused_runner(prob.device_grad, N, C, T,
                                       eval_fn=(lambda w: torch.sum(w ** 2)) if ev else None,
                                       **tkw)
    out_t = tr.from_draws(torch.zeros(prob.d), mu, p, 0.05, *_t_draws(key, N, C, T, p, scen))
    return out_j, out_t


def _same_extras(xt, xj, counters=("guard_rejects", "stale_drops", "kind_count", "comp")):
    for f in counters:
        if f in xj:
            np.testing.assert_array_equal(np.asarray(xt[f]), np.asarray(xj[f]))
    if "avail_time" in xj:
        assert _rel(xt["avail_time"].numpy(), xj["avail_time"]) <= 1e-6
    np.testing.assert_allclose(xt["p_traj"].numpy(), np.asarray(xj["p_traj"]), atol=1e-5)
    np.testing.assert_allclose(xt["t"].numpy(), np.asarray(xj["t"]), rtol=1e-6)
    assert set(xj) == set(xt)


@pytest.mark.parametrize("case", sorted(_FUSED_FAULT_CASES))
def test_fused_faults_and_guard_match_the_reference(case):
    """Weights and ``p_traj`` <= 1e-5 (blocked: the reference's in-window
    fix-up against the port's conflict-free cut, the same per-event
    Algorithm 1), the counters exact."""
    kw = _FUSED_FAULT_CASES[case]
    mu, p = _mu_p()
    (wj, ej, xj), (wt, et, xt) = _fused_pair(kw, 600, jax.random.PRNGKey(1), mu, p)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-5)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=1e-5)
    _same_extras(xt, xj)
    if kw.get("guard", {}).get("max_grad_norm"):
        assert int(xt["guard_rejects"]) > 0  # the cap bites on these quadratics
    if "fault" in kw:
        assert int(xt["kind_count"].sum()) == 600


@pytest.mark.parametrize("kw", [
    dict(scenario="erlang2_onoff"),
    dict(scenario="hyperexp2", guard=_GUARD),
    dict(scenario="onoff", weighting="plain", eval_every=200),
    dict(scenario="erlang4", adaptive=True, refresh_every=200, eval_every=200),
], ids=["erlang2_onoff", "hyperexp2_guard", "onoff_plain", "erlang4_adaptive"])
def test_fused_scenario_matches_the_reference(kw):
    mu, p = _mu_p(seed=4)
    (wj, ej, xj), (wt, et, xt) = _fused_pair(kw, 400, jax.random.PRNGKey(3), mu, p, scen=True)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-5)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=1e-5)
    _same_extras(xt, xj)
    assert xt["kind_count"].shape == (6,) and int(xt["kind_count"].sum()) == 400


@pytest.mark.parametrize("kw", [dict(fault=FAULT, guard=dict(max_grad_norm=1e3, stale_cutoff=8)),
                                dict(scenario="erlang2_onoff")], ids=["faults_guard", "scenario"])
def test_mlp_matches_the_reference_fused_runner(kw):
    """The small MLP via `test_torch_fl._pair` (the reference's weights and
    window offsets), with evaluation."""
    from test_torch_fl import _pair

    (_, _, j_setup), (_, _, setup) = _pair()
    n, T = 16, 160
    mu, p = _mu_p(n, seed=3)
    key = jax.random.PRNGKey(4)
    jkw, tkw = _kw_pair(kw)
    jr = jes.make_fused_runner(j_setup.clients.device_grad, n, C, T, eval_fn=j_setup.eval_fn,
                               eval_every=80, **jkw)
    wj, ej, xj = jax.jit(jr)(j_setup.params, jnp.asarray(mu), jnp.asarray(p), key, 0.05)
    tr = engine_scan.make_fused_runner(setup.clients.device_grad, n, C, T, eval_fn=setup.eval_fn,
                                       eval_every=80, **tkw)
    wt, et, xt = tr.from_draws(setup.params, mu, p, 0.05,
                               *_t_draws(key, n, C, T, p, "scenario" in kw))
    gap = max(float(np.abs(wt[k].numpy() - np.asarray(wj[k])).max()) for k in wj)
    assert gap <= 1e-5
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=2 / 2048)
    _same_extras(xt, xj)


@pytest.mark.parametrize("E", [4, 8])
def test_blocked_matches_per_event_under_faults(E):
    """The port's blocked replay cuts each chunk into conflict-free blocks
    (every flip ends one): <= 1e-5 of per event, the counters exact."""
    T = 300
    prob = Quadratic(N)
    mu, p = _mu_p(seed=5)
    d = _t_draws(jax.random.PRNGKey(9), N, C, T, p)
    kw = dict(fault=FaultConfig(**FAULT), guard=GuardConfig(**_GUARD), eval_every=100)
    ev = lambda w: torch.sum(w ** 2)  # noqa: E731
    w1, e1, x1 = engine_scan.make_fused_runner(prob.device_grad, N, C, T, eval_fn=ev, **kw
                                               ).from_draws(torch.zeros(prob.d), mu, p, 0.05, *d)
    wE, eE, xE = engine_scan.make_fused_runner(prob.device_grad, N, C, T, eval_fn=ev,
                                               block_size=E, **kw
                                               ).from_draws(torch.zeros(prob.d), mu, p, 0.05, *d)
    np.testing.assert_allclose(wE.numpy(), w1.numpy(), atol=1e-5)
    np.testing.assert_allclose(eE.numpy(), e1.numpy(), rtol=1e-5)
    for f in ("guard_rejects", "stale_drops", "kind_count", "comp"):
        assert torch.equal(xE[f], x1[f])
    assert torch.equal(xE["t"], x1["t"])


def test_stale_drops_are_the_stream_delays():
    """The fused guard's ``stale_drops`` are the completions whose stream
    delay (`scan_draws`, the same draws) exceeds the cutoff, and it never
    rejects a flip."""
    T, cutoff = 400, 5
    prob = Quadratic(N)
    mu, p = _mu_p(seed=6)
    (nodes, ur, ue, ud), K = _ref_draws(jax.random.PRNGKey(10), N, C, T, p)
    fault = FaultConfig(**FAULT)
    _, x = engine_scan.make_fused_runner(
        prob.device_grad, N, C, T, fault=fault, guard=GuardConfig(stale_cutoff=cutoff)
    ).from_draws(torch.zeros(prob.d), mu, p, 0.05,
                 *(torch.tensor(a) for a in (nodes, ur, ue, ud)))[::2]
    _, ev, _ = sd.scan_draws(torch.tensor(mu, dtype=F32), torch.tensor(nodes), torch.tensor(ur),
                             torch.tensor(ue), torch.tensor(K), fault=fault)
    want = int(((ev[4] > cutoff) & (ev[5] == KIND_COMPLETE)).sum())
    assert int(x["stale_drops"]) == want > 0 and int(x["guard_rejects"]) == 0


def test_cell_axis_scenario_matches_the_reference():
    """``vmap_scenarios`` under a scenario (what `run_matrix(stream=
    "device", scenario=)` runs): the port's cells on the reference's
    per-cell draws against the reference's runner vmapped over the cells
    (<= 1e-5), and each cell bitwise the port's run of it alone."""
    T, B = 200, 3
    prob = Quadratic(N)
    mus = np.stack([_mu_p(seed=b)[0] for b in range(B)])
    ps = np.stack([_mu_p(seed=b)[1] for b in range(B)])
    keys = jnp.stack([jax.random.PRNGKey(30 + b) for b in range(B)])
    sc = "erlang2_onoff"
    jr = jes.make_fused_runner(JQuadratic(prob.c).device_grad, N, C, T,
                               scenario=j_get_scenario(sc))
    wj, _, xj = jax.jit(jax.vmap(jr, in_axes=(None, 0, 0, 0, None)))(
        jnp.zeros(prob.d), jnp.asarray(mus), jnp.asarray(ps), keys, 0.05)
    ds = [_t_draws(keys[b], N, C, T, ps[b], scenario=True) for b in range(B)]
    st = [torch.stack(x) for x in zip(*ds)]
    cells = engine_scan.make_fused_runner(prob.device_grad, N, C, T, vmap_scenarios=True,
                                          scenario=get_scenario(sc))
    wc, _, xc = cells.from_draws(torch.zeros(prob.d), mus, ps, 0.05, *st)
    np.testing.assert_allclose(wc.numpy(), np.asarray(wj), atol=1e-5)
    np.testing.assert_array_equal(xc["kind_count"].numpy(), np.asarray(xj["kind_count"]))
    one = engine_scan.make_fused_runner(prob.device_grad, N, C, T, scenario=get_scenario(sc))
    for b in range(B):
        w1, _, x1 = one.from_draws(torch.zeros(prob.d), mus[b], ps[b], 0.05, *ds[b])
        assert torch.equal(wc[b], w1) and torch.equal(xc["kind_count"][b], x1["kind_count"])


def test_k1_update_under_faults_equals_the_flat_update():
    """``update_fn`` = K1 over the leaves (its plain version on the CPU)
    under faults: every event launches it (flips with scale 0), and the
    weights are within 1e-6 of the flat axpy."""
    from test_torch_fl import _pair

    from repro_torch.kernels.ops import tree_weighted_update

    _, (_, _, setup) = _pair()
    n, T = 16, 120
    mu, p = _mu_p(n, seed=3)
    d = _t_draws(jax.random.PRNGKey(5), n, C, T, p)
    kw = dict(fault=FaultConfig(**FAULT))
    w1, _, x1 = engine_scan.make_fused_runner(setup.clients.device_grad, n, C, T, **kw
                                              ).from_draws(setup.params, mu, p, 0.05, *d)
    w2, _, x2 = engine_scan.make_fused_runner(setup.clients.device_grad, n, C, T,
                                              update_fn=tree_weighted_update, **kw
                                              ).from_draws(setup.params, mu, p, 0.05, *d)
    for k in w1:
        np.testing.assert_allclose(w2[k].numpy(), w1[k].numpy(), atol=1e-6)
    assert torch.equal(x1["kind_count"], x2["kind_count"]) and int(x1["kind_count"][3]) > 0


# ------------------------------------------------------------------ #
# the checkpointed fused driver
# ------------------------------------------------------------------ #
def _ref_chunk_draws(key, n, C, p, faulty):
    """The reference's `run_checkpointed` draws: the placement from
    ``split(key, 4)[0]`` and chunk c's uniforms from ``fold_in(k, c)``."""
    k_init, k_race, k_exp, k_disp = jax.random.split(key, 4)
    _, nodes = jsd.stream_init(k_init, n, C, jnp.asarray(p, jnp.float32), fault=faulty)

    def chunk_draws(c, Lc):
        return tuple(torch.tensor(np.asarray(jax.random.uniform(jax.random.fold_in(k, c), (Lc,))))
                     for k in (k_race, k_exp, k_disp))

    return torch.tensor(np.asarray(nodes)), chunk_draws


_CKPT_CASES = {
    "faults_guard": dict(fault=FAULT, guard=_GUARD, eval_every=100),
    "adaptive": dict(adaptive=True, refresh_every=100, eval_every=200),
    "faults_blocked": dict(fault=FAULT, guard=_GUARD, block_size=4, eval_every=100),
    "faults_bf16_ring": dict(fault=FAULT, snapshot_dtype="bfloat16"),
}


def _ckpt_run(kw, tmp, T=430, resume=False, key=1, draws=True, **extra):
    prob = Quadratic(N)
    mu, p = _mu_p()
    _, tkw = _kw_pair(kw)
    dr = _ref_chunk_draws(jax.random.PRNGKey(key), N, C, p, "fault" in kw) if draws else None
    return ck.run_checkpointed(prob.device_grad, N, C, T, w0=torch.zeros(prob.d), mu=mu, p0=p,
                               key=key, eta=0.05, ckpt_dir=str(tmp), ckpt_every=100, keep=10,
                               eval_fn=lambda w: torch.sum(w ** 2), draws=dr, resume=resume,
                               **tkw, **extra)


@pytest.mark.parametrize("case", sorted(_CKPT_CASES))
def test_run_checkpointed_matches_the_reference(case, tmp_path):
    """On the reference's per-chunk draws: weights <= 1e-5, the curve, the
    counters exact."""
    kw = _CKPT_CASES[case]
    prob = Quadratic(N)
    mu, p = _mu_p()
    jkw, _ = _kw_pair(kw)
    wj, ej, xj = jck.run_checkpointed(JQuadratic(prob.c).device_grad, N, C, 430,
                                      w0=jnp.zeros(prob.d), mu=mu, p0=p,
                                      key=jax.random.PRNGKey(1), eta=0.05,
                                      ckpt_dir=str(tmp_path / "jax"), ckpt_every=100,
                                      eval_fn=lambda w: jnp.sum(w ** 2), **jkw)
    wt, et, xt = _ckpt_run(kw, tmp_path / "port")
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-5)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-5)
    assert set(xt) == set(xj)
    for f in ("comp", "guard_rejects", "stale_drops", "kind_count"):
        if f in xj:
            np.testing.assert_array_equal(xt[f].numpy(), np.asarray(xj[f]))
    np.testing.assert_allclose(xt["p_final"].numpy(), np.asarray(xj["p_final"]), atol=1e-5)
    assert _rel(float(xt["t_final"]), float(xj["t_final"])) <= 1e-6


def _truncate(d, keep_step):
    from repro_torch.ckpt import checkpoint as ckp

    for s in ckp.available_steps(str(d)):
        if s > keep_step:
            shutil.rmtree(os.path.join(str(d), f"step_{s:010d}"))
    return ckp.available_steps(str(d))


@pytest.mark.parametrize("case", ["faults_guard", "faults_blocked", "adaptive"])
def test_truncate_and_resume_is_bitwise(case, tmp_path):
    """Truncated to its second save and resumed in process: weights, curve
    and extras bitwise the uninterrupted run; a second resume, from the
    final save, returns the same again without replaying."""
    kw = _CKPT_CASES[case]
    w, e, x = _ckpt_run(kw, tmp_path, draws=False)
    assert _truncate(tmp_path, 200) == [100, 200]
    w2, e2, x2 = _ckpt_run(kw, tmp_path, resume=True, draws=False)
    assert torch.equal(w2, w) and torch.equal(e2, e)
    assert all(torch.equal(x2[k], x[k]) for k in x)
    w3, e3, x3 = _ckpt_run(kw, tmp_path, resume=True, draws=False)
    assert torch.equal(w3, w) and torch.equal(e3, e) and all(torch.equal(x3[k], x[k]) for k in x)


def test_checkpointed_seed_draws_and_fingerprint(tmp_path):
    """The port's own draws depend on the seed and not on when a chunk
    runs; a resume under another configuration raises the reference's
    mismatch ValueError, with no checkpoint FileNotFoundError."""
    kw = _CKPT_CASES["faults_guard"]
    w0, _, _ = _ckpt_run(kw, tmp_path / "a", draws=False, key=1)
    w1, _, _ = _ckpt_run(kw, tmp_path / "b", draws=False, key=2)
    assert not torch.equal(w0, w1)
    with pytest.raises(ValueError, match="mismatch"):
        _ckpt_run(dict(kw, guard=dict(max_grad_norm=2.0, stale_cutoff=6)), tmp_path / "a",
                  resume=True, draws=False, key=1)
    with pytest.raises(ValueError, match="mismatch"):
        _ckpt_run(kw, tmp_path / "a", resume=True, draws=False, key=3)
    with pytest.raises(FileNotFoundError):
        _ckpt_run(kw, tmp_path / "empty", resume=True, draws=False)


def test_run_experiment_device_stream_checkpointed_resume(tmp_path):
    """The entry point: the MLP on the device stream with faults, the guard
    and checkpoints, truncated and resumed: weights, curve and counters
    bitwise; the trace's times NaN, as the reference's."""
    flc = FLConfig(n_clients=8, concurrency=4, server_steps=120, seed=1, stream="device",
                   device="cpu")
    kw = dict(eval_every=60, faults=FaultConfig(**FAULT),
              guard=GuardConfig(max_grad_norm=1e3, stale_cutoff=16),
              ckpt_dir=str(tmp_path / "fl"), ckpt_every=30)
    r1 = t_fl.run_experiment(flc, "gen_async", **kw)
    assert np.isnan(r1.eval_times).all() and r1.eval_acc.shape == (2,)
    assert int(r1.extras["kind_count"].sum()) == 120
    _truncate(tmp_path / "fl", 60)
    r2 = t_fl.run_experiment(flc, "gen_async", resume=True, **kw)
    for k in r1.final_params:
        assert torch.equal(r1.final_params[k], r2.final_params[k])
    assert r1.eval_acc.tolist() == r2.eval_acc.tolist()
    for f in ("guard_rejects", "stale_drops", "kind_count", "comp"):
        np.testing.assert_array_equal(r1.extras[f], r2.extras[f])


# ------------------------------------------------------------------ #
# laws, on the port's own generator (cells of the cell axis)
# ------------------------------------------------------------------ #
def _cells_stream(n, C_, T, B, mu, p, seed, fault=None, scenario=None):
    """B cells of the port's own stream (`draw_uniforms` per cell) on the
    cell axis: ``(events, stats)``."""
    scen = scenario is not None
    draws = [sd.draw_uniforms(seed * 100 + b, n, C_, T, p, device="cpu", scenario=scen)
             for b in range(B)]
    st = [torch.stack(x) for x in zip(*draws)]
    K = sd.tree_sample(sd.tree_build(torch.tensor(p, dtype=F32).expand(B, n)), st[3])
    _, ev, stats = sd.scan_draws(torch.tensor(mu, dtype=F32).expand(B, n), st[0], st[1], st[2],
                                 K, fault=fault, scenario=scenario,
                                 u_ph=st[4] if scen else None, u_phase0=st[5] if scen else None)
    return ev, stats


def test_fault_conservation_and_kind_mix_in_law():
    """Crashes and timeouts re-dispatch at once, so the closed network keeps
    C tasks: the event-sampled occupancy is C T exactly and the
    time-averaged one C; every kind occurs, and the kind mix is the host
    stream's (`test_faults.py`'s bars)."""
    n, C_, T, B = 6, 4, 2500, 8
    mu, p = np.linspace(0.5, 2.0, n), np.full(n, 1 / n)
    fault = FaultConfig(off_rate=0.3, on_rate=1.0, crash_rate=0.1, timeout_rate=0.2)
    ev, stats = _cells_stream(n, C_, T, B, mu, p, 1, fault=fault)
    assert (stats.occ_sum.sum(-1) == C_ * T).all()
    tw = sd.kahan_value(stats.occ_tw, stats.occ_tw_c).sum(-1) / ev[2][:, -1].double().numpy()
    np.testing.assert_allclose(tw, C_, rtol=1e-5)
    kinds = stats.kind_count.sum(0).numpy()
    assert (kinds > 0).all() and kinds.sum() == B * T
    host = export_stream(SimConfig(mu=mu, p=p, C=C_, T=B * T, seed=3, fault=fault))
    np.testing.assert_allclose(kinds / (B * T), np.bincount(host.kind, minlength=4) / (B * T),
                               atol=0.02)
    # flips carry the trash slot, task movements a real one
    flips = ev[5] == 3
    assert (ev[3][flips] == C_).all() and (ev[3][~flips] < C_).all()


def test_fault_availability_stationarity_in_law():
    """Per node and cell, the time-averaged availability matches the on/off
    chain's stationary share (Markov-chain CLT, `assert_onoff_stationary`)."""
    q_off, q_on = 0.4, 1.2
    n, C_, T, B = 5, 3, 5000, 8
    ev, stats = _cells_stream(n, C_, T, B, np.full(n, 1.0), np.full(n, 1 / n), 2,
                              fault=FaultConfig(off_rate=q_off, on_rate=q_on))
    horizon = ev[2][:, -1].double().numpy()
    frac = sd.kahan_value(stats.avail_tw, stats.avail_tw_c) / horizon[:, None]
    for b in range(B):
        assert_onoff_stationary(frac[b], q_off, q_on, horizon[b])


def _completion_counted_delays(slot, kind, C_):
    """Per completion, the completions since its task's dispatch (stage
    and flip rows skipped): Little's law pins its mean at C - 1."""
    disp = np.zeros(C_ + 1, np.int64)
    comp, out = 0, []
    for s, k in zip(slot, kind):
        if k != KIND_COMPLETE:
            continue
        out.append(comp - disp[s])
        comp += 1
        disp[s] = comp
    return np.asarray(out)


@pytest.mark.parametrize("name", ["erlang2", "hyperexp2", "erlang2_onoff", "onoff_slow"])
def test_scenario_little_and_conservation_in_law(name):
    """Time-averaged total occupancy C and completion-counted delay C - 1
    (`test_scenarios.py`'s bars) on the port's scenario stream."""
    n, C_, T, B = 5, 4, 4000, 6
    mu = np.random.default_rng(1).uniform(0.6, 2.5, n)
    p = _nonuniform_p(n, seed=2)
    ev, stats = _cells_stream(n, C_, T, B, mu, p, 3, scenario=get_scenario(name))
    assert (stats.occ_sum.sum(-1) == C_ * T).all()
    tw = sd.kahan_value(stats.occ_tw, stats.occ_tw_c).sum(-1) / ev[2][:, -1].double().numpy()
    np.testing.assert_allclose(tw, C_, rtol=1e-5)
    delays = np.concatenate([_completion_counted_delays(ev[3][b].numpy(), ev[5][b].numpy(), C_)
                             for b in range(B)])
    assert_little(delays, C_, rel=0.03)


@pytest.mark.parametrize("name", MODULATED)
def test_scenario_availability_stationarity_in_law(name):
    sc = get_scenario(name)
    n, C_, T, B = 5, 3, 5000, 8
    ev, stats = _cells_stream(n, C_, T, B, np.full(n, 1.0), np.full(n, 1 / n), 4, scenario=sc)
    horizon = ev[2][:, -1].double().numpy()
    frac = sd.kahan_value(stats.avail_tw, stats.avail_tw_c) / horizon[:, None]
    q_off, q_on = sc.modulation.resolve(n)
    for b in range(B):
        assert_onoff_stationary(frac[b], q_off[0], q_on[0], horizon[b])


# ------------------------------------------------------------------ #
# a disabled scenario, the composition errors, the entry points
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("where", ["generate_stream", "fused", "run_generalized_async_sgd"])
def test_disabled_scenario_is_bitwise_none(where):
    """``exponential`` (always on) takes the unmodified stream: bitwise
    ``scenario=None`` (`tests/test_scenarios.py:260-296`)."""
    mu, p = np.array([2.0, 1.0, 0.5]), np.full(3, 1 / 3)
    off = get_scenario("exponential")
    assert not off.enabled
    if where == "generate_stream":
        a, b = (sd.generate_stream(mu, p, 2, 300, seed=3, scenario=s, device="cpu")
                for s in (None, off))
        for f in ("J", "K", "slot", "t", "delay_steps"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.kind is None and b.kind is None
        return
    prob = Quadratic(3)
    if where == "fused":
        outs = [engine_scan.make_fused_runner(prob.device_grad, 3, 2, 300, scenario=s)(
            torch.zeros(prob.d), mu, p, 7, 0.05) for s in (None, off)]
        assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][2]["t"], outs[1][2]["t"])
        assert "kind_count" not in outs[1][2]
        return
    outs = [run_generalized_async_sgd(
        np.zeros(prob.d, np.float32), prob,
        ServerConfig(n=3, C=2, T=300, eta=0.05, p=p, mu=mu, seed=7, engine="scan",
                     stream="device", scenario=s, device="cpu"))[0] for s in (None, "exponential")]
    assert torch.equal(outs[0], outs[1])


_COMPOSE = {
    "scenario_fault": (dict(scenario="erlang2", fault=FAULT), "separate injection paths"),
    "scenario_blocked": (dict(scenario="erlang2", block_size=4), "requires block_size=1"),
    "scenario_fedbuff": (dict(scenario="erlang2", fedbuff_Z=5, weighting="plain"),
                         "not FedBuff"),
    "fault_fedbuff": (dict(fault=FAULT, fedbuff_Z=5, weighting="plain"), "not FedBuff"),
    "stale_fedbuff": (dict(guard=dict(stale_cutoff=4), fedbuff_Z=5, weighting="plain"),
                      "per-event update"),
}


@pytest.mark.parametrize("case", sorted(_COMPOSE))
def test_composition_errors_are_the_reference(case):
    kw, msg = _COMPOSE[case]
    prob = Quadratic(N)
    jkw, tkw = _kw_pair(kw)
    with pytest.raises(ValueError, match=msg):
        jes.make_fused_runner(JQuadratic(prob.c).device_grad, N, C, 100, **jkw)
    with pytest.raises(ValueError, match=msg):
        engine_scan.make_fused_runner(prob.device_grad, N, C, 100, **tkw)


@pytest.mark.parametrize("kw,msg", [
    (dict(scenario="erlang2", ckpt_dir="x", ckpt_every=5), "checkpointing yet"),
    (dict(scenario="erlang2", block_size=4), "requires block_size=1"),
    (dict(scenario="erlang2", faults=FaultConfig(crash_rate=0.1)), "separate injection"),
], ids=["scenario_ckpt", "scenario_blocked", "scenario_faults"])
def test_server_config_composition_errors(kw, msg):
    """The entry point raises the reference's `ValueError`s
    (`src/repro/core/async_sgd.py:394-464`)."""
    from repro.core import ServerConfig as JServerConfig
    from repro.core import run_generalized_async_sgd as j_run

    prob = Quadratic(4)
    with pytest.raises(ValueError, match=msg):
        run_generalized_async_sgd(np.zeros(prob.d, np.float32), prob,
                                  ServerConfig(n=4, C=2, T=10, eta=0.1, engine="scan",
                                               stream="device", device="cpu", **kw))
    jkw = dict(kw)
    if "faults" in jkw:
        jkw["faults"] = JFaultConfig(crash_rate=0.1)
    with pytest.raises(ValueError, match=msg):
        j_run(jnp.zeros(prob.d, jnp.float32), JQuadratic(prob.c),
              JServerConfig(n=4, C=2, T=10, eta=0.1, engine="scan", stream="device", **jkw))


def test_block_size_auto_probes_the_configured_stream():
    """``block_size="auto"`` under faults probes the faulted stream, and a
    scenario forces ``block_size=1``; the run's kinds count all T events."""
    from repro_torch.core.async_sgd import _probe_stream_slots

    mu, p = _mu_p()
    fault = FaultConfig(**FAULT)
    slots = _probe_stream_slots(mu, p, C, 300, 2, "cpu", fault=fault)
    np.testing.assert_array_equal(
        slots, sd.generate_stream(mu, p, C, 300, seed=2, fault=fault, device="cpu").slot)
    assert (slots == C).any()
    prob = Quadratic(N)
    for kw in (dict(faults=fault), dict(scenario="erlang2_onoff")):
        w, tr = run_generalized_async_sgd(
            np.zeros(prob.d, np.float32), prob,
            ServerConfig(n=N, C=C, T=300, eta=0.05, p=p, mu=mu, seed=2, engine="scan",
                         stream="device", block_size="auto", device="cpu", **kw))
        assert bool(torch.isfinite(w).all()) and int(tr.extras["kind_count"].sum()) == 300


def test_run_matrix_device_scenario_against_the_reference():
    """`run_matrix(stream="device", scenario="erlang2")`: the reference's
    layout (curves, eval steps, extras; per event), finite curves, every
    cell's kinds over 6 tags summing to T."""
    from repro.configs.base import FLConfig as JFLConfig
    from repro.fl import engine as j_fl

    flc = FLConfig(n_clients=8, concurrency=3, server_steps=200, device="cpu")
    grid = dict(seeds=(0, 1), policies=("uniform", "optimal"), speed_ratios=(1.0, 4.0))
    m = t_fl.run_matrix(flc, stream="device", scenario="erlang2", eval_every=100, **grid)
    mj = j_fl.run_matrix(JFLConfig(n_clients=8, concurrency=3, server_steps=200), stream="device",
                         scenario="erlang2", eval_every=100, **grid)
    assert m.eval_acc.shape == np.asarray(mj.eval_acc).shape == (2, 2, 2, 2)
    assert m.eval_steps.tolist() == np.asarray(mj.eval_steps).tolist()
    assert set(mj.extras) <= set(m.extras)
    assert np.isfinite(m.eval_acc).all() and np.isfinite(m.final_acc).all()
    assert m.extras["kind_count"].shape == (2, 2, 2, 6)
    assert (m.extras["kind_count"].sum(-1) == 200).all()
    assert (m.extras["kind_count"][..., 5] > 0).all()  # Erlang-2 stage advances
    np.testing.assert_allclose(m.extras["p_final"], mj.extras["p_final"], atol=1e-6)
