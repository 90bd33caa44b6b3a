"""PyTorch port, the sparse O(C) million-client stream and the
class-collapsed control plane (`repro_torch.core.stream_device`'s sparse
section, `make_fused_runner(classes=)`, ``ServerConfig.sparse``), held
against the JAX package; it mirrors `tests/test_scale.py`.

Three strengths, as ROADMAP's ground rules set them:

1. on the reference's own draws: `sample_dispatch_classes` and the
   rank-bump placement bitwise; one `sparse_stream_step` /
   `sparse_fault_stream_step` / `sparse_scenario_stream_step` from the
   reference's state, with the integer statistics after each step; the
   whole stream through `sparse_scan_draws` (`jax.random.split(key, 6)`, 7
   with a scenario, as `stream_device._sparse_network_scan` splits it): J,
   K, slot, kind, delays and the integer statistics exact, times and float
   statistics <= 1e-6 relative; the fused runner with ``classes=`` (clean,
   faulted with the guard, adaptive, with K1's tree update, and the MLP)
   with weights and ``p_traj`` <= 1e-5 of the reference's;
2. the control plane with ``counts=`` to the reference's numbers: MVA, the
   bound, its gradient and one ``ctrl_refresh`` <= 1e-5;
3. sparse against dense in law on the port's own generator, under
   `tests/test_scale.py`'s tolerances.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine_scan as jes  # noqa: E402
from repro.core import stream_device as jsd  # noqa: E402
from repro.core.async_sgd import _expand_class_extras as j_expand  # noqa: E402
from repro.core.engine_scan import GuardConfig as JGuardConfig  # noqa: E402
from repro.core.queue_sim import FaultConfig as JFaultConfig  # noqa: E402
from repro.core.scenario import get_scenario as j_get_scenario  # noqa: E402
from repro.core.theory import BoundConstants as JBound  # noqa: E402
from repro_torch.core import ServerConfig, run_generalized_async_sgd  # noqa: E402
from repro_torch.core import engine_scan  # noqa: E402
from repro_torch.core import stream_device as sd  # noqa: E402
from repro_torch.core.async_sgd import _expand_class_extras  # noqa: E402
from repro_torch.core.engine_scan import GuardConfig  # noqa: E402
from repro_torch.core.queue_sim import FaultConfig  # noqa: E402
from repro_torch.core.sampling import _mva_delays_f64  # noqa: E402
from repro_torch.core.scenario import get_scenario  # noqa: E402
from repro_torch.core.theory import BoundConstants  # noqa: E402
from test_torch_engine import JQuadratic, Quadratic  # noqa: E402

F32 = torch.float32
FAULT = dict(off_rate=0.2, on_rate=1.0, crash_rate=0.05, timeout_rate=0.1)
SCENARIOS = ("erlang2_onoff", "hyperexp2")


def _two_class_mu(n, seed=7, frac=0.3, ratio=2.5):
    rng = np.random.default_rng(seed)
    return np.where(rng.random(n) < frac, ratio, 1.0)


def _three_class_mu(n, seed=8):
    return np.random.default_rng(seed).choice([1.0, 2.5, 6.0], size=n, p=[0.5, 0.3, 0.2])


def _class_p(mu):
    """A per-node p constant within each speed class, not uniform."""
    p = np.where(mu > 1.0, 2.0, 1.0) * (1.0 + 0.5 * (mu > 3.0))
    return p / p.sum()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _spec(n, mu=None, p=None):
    mu = _two_class_mu(n) if mu is None else mu
    p = np.full(n, 1.0 / n) if p is None else p
    spec, mu_m, p_m = jsd.build_class_spec(mu, p)
    return spec, mu_m.astype(np.float32), p_m.astype(np.float32)


# ------------------------------------------------------------------ #
# draws: the class-tree dispatch and the rank-bump placement, bitwise
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("classes", [2, 3])
def test_sample_dispatch_classes_bitwise(classes):
    n = 100_000
    mu = _two_class_mu(n) if classes == 2 else _three_class_mu(n)
    spec, _, p_m = _spec(n, mu, _class_p(mu))
    assert spec.m == classes
    rng = np.random.default_rng(classes)
    u_cls, u_mem = rng.random((2, 20_000)).astype(np.float32)
    u_mem[:3] = [0.0, 1.0 - 2**-24, 0.999999]
    want = jsd.sample_dispatch_classes(jnp.asarray(p_m), spec.device(), jnp.asarray(u_cls),
                                       jnp.asarray(u_mem))
    got = sd.sample_dispatch_classes(_t(p_m), spec, _t(u_cls), _t(u_mem))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # B rows of p at once: each row alone
    pb = np.stack([p_m, p_m[::-1] / p_m[::-1].sum() * p_m.sum()])
    ub = np.stack([u_cls[:50], u_cls[50:100]])
    got_b = sd.sample_dispatch_classes(_t(pb), spec, _t(ub), _t(np.stack([u_mem[:50]] * 2)))
    for b in range(2):
        np.testing.assert_array_equal(
            got_b[b].numpy(), sd.sample_dispatch_classes(_t(pb[b]), spec, _t(ub[b]),
                                                         _t(u_mem[:50])).numpy())


@pytest.mark.parametrize("n,C", [(10, 10), (1_000, 1), (1_000, 64), (1_000_000, 64)])
def test_rank_bump_placement_is_the_reference(n, C):
    """The reference's ranks (one ``randint`` a slot) through the port's
    rank-bump give the reference's ``sparse_stream_init`` nodes."""
    key = jax.random.PRNGKey(n + C)
    spec = jsd.ClassSpec(counts=np.array([n], np.int32), offsets=np.array([0], np.int32),
                         perm=np.arange(n, dtype=np.int32), inv_cls=np.zeros(n, np.int32))
    _, nodes = jsd.sparse_stream_init(key, spec.device(), C, jnp.ones(1, jnp.float32))
    ranks = jax.vmap(lambda k, hi: jax.random.randint(k, (), 0, hi))(
        jax.random.split(key, C), jnp.arange(n, n - C, -1))
    got = sd._rank_bump(_t(ranks).to(torch.int64), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(nodes))
    # the port's own draw: C distinct ids in range
    own = sd._init_sparse_nodes(torch.Generator().manual_seed(0), spec, C,
                                torch.ones(1), "distinct")
    assert len(set(own.tolist())) == C and 0 <= int(own.min()) and int(own.max()) < n


def test_rank_bump_is_uniform_in_law():
    """Each id equally likely to be placed: chi-square over 4,000 draws of
    a 3-subset of 8 ids."""
    from stat_utils import assert_frequencies

    spec, _, p_m = _spec(8, np.ones(8))
    gen = torch.Generator().manual_seed(1)
    placed = np.concatenate([sd._init_sparse_nodes(gen, spec, 3, _t(p_m), "distinct").numpy()
                             for _ in range(4000)])
    assert_frequencies(placed, np.full(8, 1 / 8))


# ------------------------------------------------------------------ #
# one step from the reference's state, bitwise
# ------------------------------------------------------------------ #
def _state_t(js):
    return sd.SparseStreamState(*(None if x is None else torch.tensor(np.asarray(x)).to(
        {"i": torch.int64, "b": torch.bool}.get(np.asarray(x).dtype.kind, F32)) for x in js))


def _assert_tree(ts, js):
    """Integer and boolean fields bitwise, float fields within 1e-6 (XLA's
    and torch's ``log1p`` may differ by an ulp)."""
    for a, b in zip(ts, js):
        if b is None:
            assert a is None
        elif np.asarray(b).dtype.kind == "f":
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _assert_stats(tst, jst):
    """The integer statistics bitwise, the float integrals within 1e-6
    relative (their Kahan compensations carry the ulp of log1p)."""
    for f in ("occ_sum", "comp", "slot_step", "kind_count"):
        if getattr(jst, f) is not None:
            np.testing.assert_array_equal(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)))
    for f in ("occ_tw", "busy_t", "delay_sum", "avail_tw"):
        if getattr(jst, f) is not None:
            np.testing.assert_allclose(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)),
                                       rtol=1e-6)


@pytest.mark.parametrize("mode", ["plain", "fault", "erlang2_onoff"])
def test_one_step_bitwise_from_the_reference_state(mode):
    n, C = 40, 6
    spec, mu_m, p_m = _spec(n)
    sdev = spec.device()
    m = spec.m
    fault, scen = mode == "fault", mode not in ("plain", "fault")
    key = jax.random.PRNGKey(2)
    if scen:
        jsr = jsd.resolve_scenario_classes(j_get_scenario(mode), spec)
        tsr = sd.resolve_scenario_classes(get_scenario(mode), spec, "cpu")
        js, _ = jsd.sparse_scenario_stream_init(key, sdev, C, jnp.asarray(p_m), jsr)
    else:
        js, _ = jsd.sparse_stream_init(key, sdev, C, jnp.asarray(p_m), init="sampled",
                                       fault=fault)
    if fault:
        jfr = jsd.resolve_fault_rates_classes(JFaultConfig(**FAULT), spec)
        tfr = sd.resolve_fault_rates_classes(FaultConfig(**FAULT), spec, "cpu")
    jst = jsd.sparse_stats_init(m, C, fault=fault, scenario=scen)
    tst = sd.sparse_stats_init(m, C, fault=fault, scenario=scen, device="cpu")
    rng = np.random.default_rng(5)
    kinds = set()
    for k in range(40):
        ur, ue, ub, uph = (np.float32(v) for v in rng.random(4))
        kn = int(rng.integers(n))
        ts = _state_t(js)  # the reference's state, step by step
        xs_j = (jnp.float32(ur), jnp.float32(ue), jnp.int32(kn))
        xs_t = (torch.tensor(ur), torch.tensor(ue), torch.tensor(kn))
        if scen:
            pre_j = jsd.sparse_scenario_class_stats(js, m, jsr.rate_scale)
            pre_t = sd.sparse_scenario_class_stats(ts, m, tsr.rate_scale)
            js, ev_j = jsd.sparse_scenario_stream_step(js, jnp.asarray(mu_m), sdev, jsr,
                                                       xs_j + (jnp.float32(ub), jnp.float32(uph)))
            ts, ev_t = sd.sparse_scenario_stream_step(ts, _t(mu_m), spec, tsr,
                                                      xs_t + (torch.tensor(ub), torch.tensor(uph)))
        elif fault:
            pre_j = jsd.sparse_class_stats(js, m, fault=True)
            pre_t = sd.sparse_class_stats(ts, m, fault=True)
            js, ev_j = jsd.sparse_fault_stream_step(js, jnp.asarray(mu_m), sdev, jfr,
                                                    xs_j + (jnp.float32(ub),))
            ts, ev_t = sd.sparse_fault_stream_step(ts, _t(mu_m), spec, tfr,
                                                   xs_t + (torch.tensor(ub),))
        else:
            pre_j = jsd.sparse_class_stats(js, m)
            pre_t = sd.sparse_class_stats(ts, m)
            js, ev_j = jsd.sparse_stream_step(js, jnp.asarray(mu_m), sdev, xs_j)
            ts, ev_t = sd.sparse_stream_step(ts, _t(mu_m), spec, xs_t)
        _assert_tree(pre_t, pre_j)
        _assert_tree(ts, js)
        _assert_tree(ev_t, ev_j)
        cj, ct = sdev.inv_cls[ev_j.j], torch.tensor(int(spec.inv_cls[int(ev_t.j)]))
        if fault or scen:
            jst = jsd.sparse_fault_stats_step(jst, ev_j, cj, *pre_j,
                                              jsd.class_occupancy(js.cls, m), k)
            tst = sd.sparse_fault_stats_step(tst, ev_t, ct, *pre_t,
                                             sd.class_occupancy(ts.cls, m), k)
            kinds.add(int(ev_t.kind))
        else:
            jst = jsd.sparse_stats_step(jst, ev_j, cj, *pre_j[:2],
                                        jsd.class_occupancy(js.cls, m), k)
            tst = sd.sparse_stats_step(tst, ev_t, ct, *pre_t[:2],
                                       sd.class_occupancy(ts.cls, m), k)
        _assert_stats(tst, jst)
    if fault or scen:
        assert len(kinds) >= 2  # the steps above saw more than completions


# ------------------------------------------------------------------ #
# the whole stream on the reference's draws
# ------------------------------------------------------------------ #
def _ref_draws(key, spec, C, T, p_m, init="distinct", tagged=False, scenario=None):
    """The reference's draws of one sparse stream, split as
    `stream_device._sparse_network_scan` splits them: ``(nodes, u_race,
    u_exp, K[, u_bit][, u_ph, u_phase0])`` as numpy arrays."""
    sdev = spec.device()
    pj = jnp.asarray(p_m, jnp.float32)
    keys = jax.random.split(key, 7 if scenario is not None else 6)
    if scenario is not None:
        k_place, k_ph = jax.random.split(keys[0])
        _, nodes = jsd.sparse_stream_init(k_place, sdev, C, pj, init=init, fault=True)
    else:
        _, nodes = jsd.sparse_stream_init(keys[0], sdev, C, pj, init=init, fault=tagged)
    K = jsd.sample_dispatch_classes(pj, sdev, jax.random.uniform(keys[3], (T,)),
                                    jax.random.uniform(keys[4], (T,)))
    out = [nodes, jax.random.uniform(keys[1], (T,)), jax.random.uniform(keys[2], (T,)), K]
    if tagged or scenario is not None:
        out.append(jax.random.uniform(keys[5], (T,)))
    if scenario is not None:
        out += [jax.random.uniform(keys[6], (T,)), jax.random.uniform(k_ph, (C,))]
    return [np.asarray(a) for a in out]


def _ref_events(spec, mu_m, draws, fault=None, scenario=None):
    """The reference's steps over ``draws`` in one `jax.lax.scan`: the
    per-event ``(J, slot, kind, delay)`` (`_sparse_network_scan` emits
    none)."""
    sdev = spec.device()
    m = spec.m
    C = draws[0].shape[0]
    tagged = fault is not None or scenario is not None
    nodes = jnp.asarray(draws[0])
    if scenario is not None:
        st = jsd.sparse_stream_init(jax.random.PRNGKey(0), sdev, C, None, fault=True)[0]
        st = st._replace(phase=jsd._phase_draw(scenario.acdf, jnp.asarray(draws[6])))
    else:
        st = jsd.sparse_stream_init(jax.random.PRNGKey(0), sdev, C, None, fault=tagged)[0]
    # the placement above is replaced by the given nodes
    eq = nodes[None, :] == nodes[:, None]
    head = jnp.sum(jnp.tril(eq, -1), axis=1) == 0
    cls = sdev.inv_cls[nodes]
    st = st._replace(node=nodes, cls=cls, head=head)
    if tagged:
        busy = jnp.zeros(m, jnp.int32).at[cls].add(head.astype(jnp.int32))
        st = st._replace(idle_on=sdev.counts - busy)
    stats = jsd.sparse_stats_init(m, C, fault=tagged, scenario=scenario is not None)
    mu = jnp.asarray(mu_m)

    def body(carry, x):
        st, stats, k = carry
        if scenario is not None:
            pre = jsd.sparse_scenario_class_stats(st, m, scenario.rate_scale)
            st, ev = jsd.sparse_scenario_stream_step(st, mu, sdev, scenario, x)
        elif fault is not None:
            pre = jsd.sparse_class_stats(st, m, fault=True)
            st, ev = jsd.sparse_fault_stream_step(st, mu, sdev, fault, x)
        else:
            pre = jsd.sparse_class_stats(st, m)
            st, ev = jsd.sparse_stream_step(st, mu, sdev, x)
        delay = k - stats.slot_step[ev.slot]
        occ_post = jsd.class_occupancy(st.cls, m)
        if tagged:
            stats = jsd.sparse_fault_stats_step(stats, ev, sdev.inv_cls[ev.j], *pre, occ_post, k)
        else:
            stats = jsd.sparse_stats_step(stats, ev, sdev.inv_cls[ev.j], *pre[:2], occ_post, k)
        return (st, stats, k + 1), (ev.j, ev.slot, jnp.asarray(ev.kind, jnp.int32), delay, ev.t)

    xs = tuple(jnp.asarray(a) for a in draws[1:4])
    if tagged:
        xs = xs + (jnp.asarray(draws[4]),)
    if scenario is not None:
        xs = xs + (jnp.asarray(draws[5]),)
    (st, stats, _), ys = jax.jit(lambda c, xs: jax.lax.scan(body, c, xs))(
        (st, stats, jnp.int32(0)), xs)
    return [np.asarray(y) for y in ys], stats, st


def _same_stream(tev, tst, ys, jst, tagged):
    J, slot, kind, delay, t = ys
    np.testing.assert_array_equal(tev[0].numpy(), J)
    np.testing.assert_array_equal(tev[3].numpy(), slot)
    np.testing.assert_array_equal(tev[4].numpy(), delay)
    assert tev[4].dtype == torch.int64
    if tagged:
        np.testing.assert_array_equal(tev[5].numpy(), kind)
    assert _rel(tev[2].numpy(), t) <= 1e-6
    for f in ("occ_sum", "comp", "slot_step") + (("kind_count",) if tagged else ()):
        np.testing.assert_array_equal(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)))
    for f in ("occ_tw", "busy_t", "delay_sum") + (("avail_tw",) if tagged else ()):
        assert _rel(getattr(tst, f).numpy(), getattr(jst, f)) <= 1e-6


@pytest.mark.parametrize("mode,init", [("plain", "distinct"), ("plain", "sampled"),
                                       ("fault", "distinct"), ("erlang2_onoff", "distinct"),
                                       ("hyperexp2", "sampled")])
def test_scan_on_the_reference_draws_bitwise(mode, init):
    """J, K, slot, kind, delays and the integer statistics exact against the
    reference's steps; the statistics and the final state also against the
    reference's own `sparse_stats_stream_fn` on the same key."""
    n, C, T = 2_000, 16, 600
    mu = _two_class_mu(n)
    spec, mu_m, p_m = _spec(n, mu, _class_p(mu))
    fault, scen = mode == "fault", mode not in ("plain", "fault")
    key = jax.random.PRNGKey(11)
    jfr = tfr = None
    if fault:
        jfr = jsd.resolve_fault_rates_classes(JFaultConfig(**FAULT), spec)
        tfr = FaultConfig(**FAULT)
    if scen:
        jfr = jsd.resolve_scenario_classes(j_get_scenario(mode), spec)
        tfr = get_scenario(mode)
    draws = _ref_draws(key, spec, C, T, p_m, init, tagged=fault, scenario=mode if scen else None)
    ys, jst_steps, _ = _ref_events(spec, mu_m, draws, fault=jfr if fault else None,
                                   scenario=jfr if scen else None)
    gen = jsd.sparse_stats_stream_fn(spec.m, C, T, init=init, fault=fault, scenario=scen)
    args = (key, jnp.asarray(mu_m), jnp.asarray(p_m), spec.device()) + ((jfr,) if jfr else ())
    jst, jstate = jax.jit(gen)(*args)
    nodes, tev, tst, tstate = sd.sparse_scan_draws(
        _t(mu_m), spec, *(_t(a) for a in draws[:4]), *(_t(a) for a in draws[4:]),
        fault=tfr if fault else None, scenario=tfr if scen else None)
    np.testing.assert_array_equal(tev[1].numpy(), draws[3])
    _same_stream(tev, tst, ys, jst_steps, fault or scen)
    _same_stream(tev, tst, ys, jst, fault or scen)
    _assert_tree(tstate, jstate)
    if mode in ("fault", "erlang2_onoff"):
        assert int(tst.kind_count[0]) < T  # the run saw more than completions


def test_scan_cell_axis_equals_each_cell_alone():
    n, C, T, B = 500, 8, 150, 3
    spec, mu_m, p_m = _spec(n)
    draws = [sd.draw_sparse_uniforms(s, spec, C, T, p_m, device="cpu", fault=True)
             for s in range(B)]
    stacked = [torch.stack(d) for d in zip(*draws)]
    nodes, ur, ue, ud, um, ub = stacked
    K = sd.sample_dispatch_classes(_t(p_m).expand(B, -1), spec, ud, um)
    fault = FaultConfig(**FAULT)
    _, ev, st, _ = sd.sparse_scan_draws(_t(mu_m), spec, nodes, ur, ue, K, ub, fault=fault)
    for b in range(B):
        _, ev1, st1, _ = sd.sparse_scan_draws(_t(mu_m), spec, nodes[b], ur[b], ue[b], K[b],
                                              ub[b], fault=fault)
        for x, y in zip(ev, ev1):
            assert torch.equal(x[b], y)
        for f in ("occ_sum", "comp", "kind_count", "occ_tw", "delay_sum"):
            assert torch.equal(getattr(st, f)[b], getattr(st1, f))


# ------------------------------------------------------------------ #
# sparse against dense in law (`tests/test_scale.py`'s bars)
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("n,T", [(1_000, 20_000), (10_000, 8_000)])
def test_sparse_equals_dense_in_law(n, T):
    """Per-class time-averaged occupancy and completion shares within
    sampling noise, total occupancy C, mean delay at C-1, and the sparse
    occupancy at the class-collapsed MVA's (the port's own generator, T
    events each as 4 cells of T/4 on the cell axis)."""
    C, B = 64, 4
    mu = _two_class_mu(n)
    p = np.full(n, 1.0 / n)
    spec, mu_m, p_m = _spec(n, mu, p)
    m = spec.m
    L = T // B
    draws = [sd.draw_sparse_uniforms(100 + b, spec, C, L, p_m, device="cpu") for b in range(B)]
    nodes, ur, ue, ud, um = (torch.stack(a) for a in zip(*draws))
    K = sd.sample_dispatch_classes(_t(p_m).expand(B, m), spec, ud, um)
    _, _, st_s, state = sd.sparse_scan_draws(_t(mu_m), spec, nodes, ur, ue, K, emit_events=False)
    dd = [sd.draw_uniforms(200 + b, n, C, L, _t(p, F32), device="cpu") for b in range(B)]
    nd, urd, ued, udd = (torch.stack(a) for a in zip(*dd))
    Kd = sd.tree_sample(sd.tree_build(_t(p, F32).expand(B, n)), udd)
    _, _, st_d = sd.scan_draws(_t(mu, F32).expand(B, n), nd, urd, ued, Kd, emit_events=False)
    inv = np.asarray(spec.inv_cls)

    def agg(x):  # (B, n) per node -> (m,) per class, summed over cells
        return np.bincount(np.tile(inv, B), weights=np.asarray(x, np.float64).ravel(),
                           minlength=m)

    t_s = sd.kahan_value(state.t, state.t_c)  # (B,)
    occ_s = (sd.kahan_value(st_s.occ_tw, st_s.occ_tw_c) / t_s[:, None]).mean(0)
    occ_d = agg(sd.kahan_value(st_d.occ_tw, st_d.occ_tw_c))
    occ_d /= occ_d.sum() / C
    np.testing.assert_allclose(occ_s.sum(), C, rtol=1e-5)
    np.testing.assert_allclose(occ_s / C, occ_d / C, atol=0.05)
    comp_s = np.asarray(st_s.comp, np.float64).sum(0)
    comp_d = agg(st_d.comp)
    assert comp_s.sum() == B * L and comp_d.sum() == B * L
    np.testing.assert_allclose(comp_s / (B * L), comp_d / (B * L), atol=0.03)
    delay_s = float(sd.kahan_value(st_s.delay_sum, st_s.delay_sum_c).sum()) / (B * L)
    delay_d = float(sd.kahan_value(st_d.delay_sum, st_d.delay_sum_c).sum()) / (B * L)
    assert abs(delay_s - (C - 1)) < 0.5 * np.sqrt(C)
    assert abs(delay_s - delay_d) < 0.5 * np.sqrt(C)
    md, _ = sd.mva_throughput_delays(_t(mu_m, torch.float64), _t(p_m, torch.float64), C,
                                     counts=tuple(int(c) for c in spec.counts))
    occ_mva = np.asarray(spec.counts) * p_m * md.numpy() * C / (C - 1.0)
    np.testing.assert_allclose(occ_s, occ_mva, rtol=0.05)


def test_fault_kind_mix_sparse_equals_dense():
    """The sparse and dense fault streams see the same event mix (within
    0.04): 2 runs of 4,000 events each on the cell axis (the fused runner's
    kinds are its stream's, `test_fused_classes_matches_the_reference`)."""
    n, C, T, B = 1_000, 8, 4_000, 2
    mu = _two_class_mu(n)
    p = np.full(n, 1.0 / n)
    spec, mu_m, p_m = _spec(n, mu, p)
    fc = FaultConfig(crash_rate=0.02, timeout_rate=0.05, off_rate=0.01, on_rate=0.3)
    draws = [sd.draw_sparse_uniforms(s, spec, C, T, p_m, device="cpu", fault=True)
             for s in range(B)]
    nodes, ur, ue, ud, um, ub = (torch.stack(a) for a in zip(*draws))
    K = sd.sample_dispatch_classes(_t(p_m).expand(B, -1), spec, ud, um)
    _, _, st_s, _ = sd.sparse_scan_draws(_t(mu_m), spec, nodes, ur, ue, K, ub, fault=fc,
                                         emit_events=False)
    dd = [sd.draw_uniforms(10 + s, n, C, T, _t(p, F32), device="cpu") for s in range(B)]
    nd, urd, ued, udd = (torch.stack(a) for a in zip(*dd))
    Kd = sd.tree_sample(sd.tree_build(_t(p, F32).expand(B, n)), udd)
    _, _, st_d = sd.scan_draws(_t(mu, F32).expand(B, n), nd, urd, ued, Kd, fault=fc,
                               emit_events=False)
    kc_s = st_s.kind_count.sum(0).numpy().astype(np.float64)
    kc_d = st_d.kind_count.sum(0).numpy().astype(np.float64)
    assert kc_s.sum() == kc_d.sum() == B * T and kc_s[3] > 0
    np.testing.assert_allclose(kc_d / kc_d.sum(), kc_s / kc_s.sum(), atol=0.04)


@pytest.mark.parametrize("what", ["fault", "modulation"])
def test_sparse_requires_class_constant_rates(what):
    n = 100
    spec, _, _ = _spec(n)
    if what == "fault":
        for pkg, cfg, dev in ((jsd, JFaultConfig, {}), (sd, FaultConfig, {"device": "cpu"})):
            with pytest.raises(ValueError, match="varies within speed class"):
                pkg.resolve_fault_rates_classes(cfg(crash_rate=np.linspace(0.01, 0.2, n)), spec,
                                                **dev)
        return
    from dataclasses import replace

    from repro.core.scenario import ModulationConfig as JMod
    from repro_torch.core.scenario import ModulationConfig

    for pkg, get, mod, dev in ((jsd, j_get_scenario, JMod, {}),
                               (sd, get_scenario, ModulationConfig, {"device": "cpu"})):
        sc = replace(get("onoff"), modulation=mod(off_rate=np.linspace(0.1, 0.5, n), on_rate=1.0))
        with pytest.raises(ValueError, match="varies within speed class"):
            pkg.resolve_scenario_classes(sc, spec, **dev)


# ------------------------------------------------------------------ #
# the class-collapsed control plane against the reference
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("n", [1_000, 10_000, 1_000_000])
def test_mva_counts_matches_reference(n):
    C = 32
    spec, mu_m, p_m = _spec(n)
    counts = tuple(int(c) for c in spec.counts)
    md, lam = sd.mva_throughput_delays(_t(mu_m), _t(p_m), C, counts=counts)
    mdj, lamj = jsd.mva_throughput_delays(jnp.asarray(mu_m), jnp.asarray(p_m), C, counts=counts)
    md64, lam64 = _mva_delays_f64(mu_m.astype(np.float64), p_m.astype(np.float64),
                                  np.asarray(spec.counts), C)
    assert _rel(md.numpy(), mdj) <= 1e-5 and _rel(float(lam), float(lamj)) <= 1e-5
    assert _rel(md.numpy(), md64) <= 1e-5 and _rel(float(lam), lam64) <= 1e-5
    if n <= 10_000:  # the dense recurrence on the expanded vectors
        mdd, _ = sd.mva_throughput_delays(_t(_two_class_mu(n), F32), _t(np.full(n, 1.0 / n), F32),
                                          C)
        np.testing.assert_allclose(md.numpy()[np.asarray(spec.inv_cls)], mdd.numpy(), rtol=1e-4)


@pytest.mark.parametrize("active", [False, True], ids=["interior", "cap"])
def test_bound_and_gradient_counts_match_reference(active):
    n = 50_000
    mu = _three_class_mu(n)
    spec, mu_m, p_m = _spec(n, mu, _class_p(mu))
    counts = tuple(int(c) for c in spec.counts)
    T = 2_000 if not active else 10**9
    k, kj = BoundConstants(C=16, T=T), JBound(C=16, T=T)
    val, g = sd.make_bound_value_and_grad(k, counts=counts)(_t(p_m), _t(mu_m))
    valj, gj = jsd.make_bound_value_and_grad(kj, counts=counts)(jnp.asarray(p_m),
                                                                jnp.asarray(mu_m))
    assert _rel(float(val), float(valj)) <= 1e-5
    assert _rel(g.numpy(), gj) <= 1e-5
    m, _ = sd.mva_throughput_delays(_t(mu_m), _t(p_m), 16, counts=counts)
    eta = sd.optimal_eta_jnp(_t(p_m), m, k, counts=counts)
    etaj = jsd.optimal_eta_jnp(jnp.asarray(p_m), jnp.asarray(m.numpy()), kj, counts=counts)
    assert _rel(float(eta), float(etaj)) <= 1e-5
    G = sd.generalized_bound_jnp(eta, _t(p_m), m, k, counts=counts)
    Gj = jsd.generalized_bound_jnp(etaj, jnp.asarray(p_m), jnp.asarray(m.numpy()), kj,
                                   counts=counts)
    assert _rel(float(G), float(Gj)) <= 1e-5


def test_ctrl_refresh_counts_matches_reference():
    n = 1_000_000
    spec, mu_m, p_m = _spec(n)
    counts = tuple(int(c) for c in spec.counts)
    comp = np.array([4_000, 9_000])
    busy = np.array([3_900.0, 3_700.0], np.float32)
    k, kj = BoundConstants(C=64, T=2_000), JBound(C=64, T=2_000)
    p1 = sd.ctrl_refresh(_t(p_m), _t(comp), _t(busy), k, counts=counts)
    p1j = jsd.ctrl_refresh(jnp.asarray(p_m), jnp.asarray(comp), jnp.asarray(busy), kj,
                           counts=counts)
    assert _rel(p1.numpy(), p1j) <= 1e-5
    assert float((p1.double() * torch.tensor(counts, dtype=torch.float64)).sum()) == \
        pytest.approx(1.0, abs=1e-5)
    # a cell axis: each row refreshed on its own
    pb = sd.ctrl_refresh(_t(np.stack([p_m, p_m])), _t(np.stack([comp, comp])),
                         _t(np.stack([busy, busy])), k, counts=counts)
    assert torch.equal(pb[0], p1) and torch.equal(pb[1], p1)


def test_two_cluster_optimizer_collapsed_matches_reference():
    """From 1024 clients on, the port's `optimize_two_cluster` takes its
    delays from the two-class MVA (O(C)) instead of the dense Buzen pass:
    the optimum within 1e-7 of the reference's dense one at n = 2,000, and
    `sampling_for` at n = 50,000 in well under a second."""
    import time

    from repro.core.sampling import optimize_two_cluster as j_opt
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.sampling import optimize_two_cluster
    from repro_torch.data.pipeline import make_client_speeds
    from repro_torch.fl.engine import sampling_for

    a = j_opt(10.0, 1.0, 2_000, 1_000, JBound(C=64, T=1000))
    b = optimize_two_cluster(10.0, 1.0, 2_000, 1_000, BoundConstants(C=64, T=1000))
    assert _rel(b.p, a.p) <= 1e-7 and _rel(b.m, a.m) <= 1e-7
    assert _rel(b.bound, a.bound) <= 1e-9 and _rel(b.uniform_bound, a.uniform_bound) <= 1e-9
    assert _rel(b.eta, a.eta) <= 1e-7
    flc = FLConfig(n_clients=50_000, concurrency=64, server_steps=1000, device="cpu")
    mu = make_client_speeds(50_000, 0.5, 10.0, seed=0)
    t0 = time.perf_counter()
    p = sampling_for(flc, mu)
    assert time.perf_counter() - t0 < 5.0 and abs(p.sum() - 1.0) < 1e-12
    assert len(np.unique(p)) == 2 and sd.build_class_spec(mu, p)[0].m == 2


# ------------------------------------------------------------------ #
# the fused runner with classes= against the reference's
# ------------------------------------------------------------------ #
_GUARD = dict(max_grad_norm=3.0, stale_cutoff=12)
_FUSED_CASES = {
    "importance": dict(),
    "plain_eval": dict(weighting="plain", eval_every=150),
    "faults_guard": dict(fault=FAULT, guard=_GUARD, eval_every=150),
    "adaptive": dict(adaptive=True, refresh_every=100, eval_every=200),
    "faults_adaptive": dict(fault=FAULT, adaptive=True, refresh_every=200),
    "fedbuff": dict(fedbuff_Z=5, weighting="plain"),
    "k1_tree_update": dict(k1=True, fault=FAULT),
}


def _kw_pair(kw):
    j, t = dict(kw), dict(kw)
    for d in (j, t):
        d.pop("k1", None)
    if "fault" in kw:
        j["fault"], t["fault"] = JFaultConfig(**kw["fault"]), FaultConfig(**kw["fault"])
    if "guard" in kw:
        j["guard"], t["guard"] = JGuardConfig(**kw["guard"]), GuardConfig(**kw["guard"])
    if kw.get("k1"):
        from repro_torch.kernels.ops import tree_weighted_update

        t["update_fn"] = tree_weighted_update
    return j, t


def _fused_draws(key, spec, C, T, p_m, faulty):
    """The reference's fused sparse draws (`make_fused_runner`'s key split
    ``(init, race, exp, disp, mem, bit)``) as `run.from_draws` takes them."""
    k_init, k_race, k_exp, k_disp, k_mem, k_bit = jax.random.split(key, 6)
    _, nodes = jsd.sparse_stream_init(k_init, spec.device(), C, jnp.asarray(p_m), fault=faulty)
    pos = [nodes] + [jax.random.uniform(k, (T,)) for k in (k_race, k_exp, k_disp)]
    kw = dict(u_mem=_t(jax.random.uniform(k_mem, (T,))))
    if faulty:
        kw["u_bit"] = _t(jax.random.uniform(k_bit, (T,)))
    return [_t(a) for a in pos], kw


@pytest.mark.parametrize("case", sorted(_FUSED_CASES))
def test_fused_classes_matches_the_reference(case):
    kw = _FUSED_CASES[case]
    n, C, T = 300, 8, 600
    mu = _two_class_mu(n)
    spec, mu_m, p_m = _spec(n, mu, _class_p(mu))
    prob = Quadratic(n)
    key = jax.random.PRNGKey(1)
    jkw, tkw = _kw_pair(kw)
    ev = kw.get("eval_every")
    jr = jes.make_fused_runner(JQuadratic(prob.c).device_grad, n, C, T, classes=spec,
                               eval_fn=(lambda w: jnp.sum(w ** 2)) if ev else None, **jkw)
    wj, ej, xj = jax.jit(jr)(jnp.zeros(prob.d), jnp.asarray(mu_m), jnp.asarray(p_m), key, 0.05)
    tr = engine_scan.make_fused_runner(prob.device_grad, n, C, T, classes=spec,
                                       eval_fn=(lambda w: torch.sum(w ** 2)) if ev else None,
                                       **tkw)
    pos, dkw = _fused_draws(key, spec, C, T, p_m, "fault" in kw)
    wt, et, xt = tr.from_draws(torch.zeros(prob.d), mu_m, p_m, 0.05, *pos, **dkw)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-5)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=1e-5)
    np.testing.assert_allclose(xt["p_traj"].numpy(), np.asarray(xj["p_traj"]), atol=1e-5)
    np.testing.assert_allclose(xt["p_final"].numpy(), np.asarray(xj["p_final"]), atol=1e-5)
    np.testing.assert_allclose(xt["t"].numpy(), np.asarray(xj["t"]), rtol=1e-6)
    for f in ("guard_rejects", "stale_drops", "kind_count", "comp", "class_counts"):
        if f in xj:
            np.testing.assert_array_equal(np.asarray(xt[f]), np.asarray(xj[f]))
    for f in ("occ_mean", "busy_time", "delay_sum") + (("avail_time",) if "fault" in kw else ()):
        assert _rel(xt[f].numpy(), xj[f]) <= 1e-6
    assert set(xj) == set(xt) and xt["comp"].shape == (spec.m,)
    if "guard" in kw:
        assert int(xt["guard_rejects"]) > 0 or int(xt["stale_drops"]) > 0
    if "fault" in kw:
        assert int(xt["kind_count"].sum()) == T and int(xt["kind_count"][3]) > 0


def test_fused_classes_mlp_matches_the_reference():
    """The small MLP via `test_torch_fl._pair` (the reference's weights and
    window offsets) on two speed classes, with evaluation, under faults and
    the guard."""
    from test_torch_fl import _pair

    (_, _, j_setup), (_, _, setup) = _pair()
    n, C, T = 16, 4, 160
    mu = _two_class_mu(n, frac=0.5)
    spec, mu_m, p_m = _spec(n, mu, _class_p(mu))
    key = jax.random.PRNGKey(4)
    jkw, tkw = _kw_pair(dict(fault=FAULT, guard=dict(max_grad_norm=1e3, stale_cutoff=8)))
    jr = jes.make_fused_runner(j_setup.clients.device_grad, n, C, T, eval_fn=j_setup.eval_fn,
                               eval_every=80, classes=spec, **jkw)
    wj, ej, xj = jax.jit(jr)(j_setup.params, jnp.asarray(mu_m), jnp.asarray(p_m), key, 0.05)
    tr = engine_scan.make_fused_runner(setup.clients.device_grad, n, C, T, eval_fn=setup.eval_fn,
                                       eval_every=80, classes=spec, **tkw)
    pos, dkw = _fused_draws(key, spec, C, T, p_m, True)
    wt, et, xt = tr.from_draws(setup.params, mu_m, p_m, 0.05, *pos, **dkw)
    gap = max(float(np.abs(wt[k].numpy() - np.asarray(wj[k])).max()) for k in wj)
    assert gap <= 1e-5
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=2 / 2048)
    np.testing.assert_array_equal(xt["kind_count"].numpy(), np.asarray(xj["kind_count"]))


def test_fused_classes_own_draws_and_cache():
    """``run(w0, mu, p0, seed, eta)`` draws from the port's generator:
    deterministic per seed, T events, and the memo keys on the spec."""
    n, C, T = 200, 8, 300
    spec, mu_m, p_m = _spec(n)
    prob = Quadratic(n)
    r = engine_scan.jit_fused_runner(prob.device_grad, n, C, T, classes=spec)
    w1, _, x1 = r(torch.zeros(prob.d), mu_m, p_m, 3, 0.05)
    w2, _, x2 = r(torch.zeros(prob.d), mu_m, p_m, 3, 0.05)
    assert torch.equal(w1, w2) and int(x1["comp"].sum()) == T
    assert r is engine_scan.jit_fused_runner(prob.device_grad, n, C, T, classes=spec)
    other, _, _ = _spec(n, _two_class_mu(n, seed=9))
    assert r is not engine_scan.jit_fused_runner(prob.device_grad, n, C, T, classes=other)


def test_fused_classes_cell_axis_equals_each_cell():
    """``vmap_scenarios=True`` with ``classes=``: B sparse streams and
    replays in lockstep, each cell bitwise its run alone."""
    n, C, T, B = 200, 8, 200, 3
    spec, mu_m, p_m = _spec(n)
    prob = Quadratic(n)
    kw = dict(classes=spec, fault=FaultConfig(**FAULT), eval_fn=lambda w: torch.sum(w ** 2),
              eval_every=100)
    cells = engine_scan.make_fused_runner(prob.device_grad, n, C, T, vmap_scenarios=True, **kw)
    one = engine_scan.make_fused_runner(prob.device_grad, n, C, T, **kw)
    pb = np.stack([p_m, p_m[::-1] * (p_m.sum() / p_m[::-1].sum()), p_m])
    wc, ec, xc = cells(torch.zeros(prob.d), np.stack([mu_m] * B), pb, [4, 5, 6], 0.05)
    for b in range(B):
        w1, e1, x1 = one(torch.zeros(prob.d), mu_m, pb[b], 4 + b, 0.05)
        assert torch.equal(wc[b], w1) and torch.equal(ec[b], e1)
        for f in ("kind_count", "comp", "p_final"):
            assert torch.equal(xc[f][b], x1[f])


def test_expand_class_extras_is_the_reference():
    n = 500
    spec, _, _ = _spec(n)
    rng = np.random.default_rng(0)
    m = spec.m
    extras = {"p_final": rng.random(m).astype(np.float32),
              "p_traj": rng.random((3, m)).astype(np.float32),
              "occ_mean": rng.random(m).astype(np.float32), "comp": rng.integers(1, 99, m),
              "delay_sum": rng.random(m).astype(np.float32) * 50,
              "busy_time": rng.random(m).astype(np.float32),
              "occ_time_avg": rng.random(m).astype(np.float32),
              "avail_time": rng.random(m).astype(np.float32),
              "kind_count": rng.integers(0, 9, 4), "t": rng.random(7).astype(np.float32)}
    got, want = _expand_class_extras(extras, spec), j_expand(extras, spec)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


# ------------------------------------------------------------------ #
# ServerConfig wiring and the reference's refusals
# ------------------------------------------------------------------ #
class TestServerConfigSparse:
    def test_sparse_true_matches_dense_in_law(self):
        n, C, T = 300, 8, 2_000
        mu = _two_class_mu(n)
        prob = Quadratic(n)
        target = prob.c.mean(0)
        outs = {}
        for sparse in (False, True):
            cfg = ServerConfig(n=n, C=C, T=T, eta=0.05, mu=mu, seed=0, engine="scan",
                               stream="device", sparse=sparse, device="cpu")
            w, trace = run_generalized_async_sgd(np.zeros(prob.d, np.float32), prob, cfg)
            mql = np.asarray(trace.mean_queue_lengths, np.float64)
            assert mql.shape == (n,)
            np.testing.assert_allclose(mql.sum(), C, rtol=1e-3)
            assert trace.extras["p_final"].shape == (n,)
            assert trace.extras["mean_delays"].shape == (n,)
            outs[sparse] = np.linalg.norm(w.numpy() - target)
        assert outs[True] < 5 * max(outs[False], 0.05)
        assert outs[False] < 5 * max(outs[True], 0.05)


@pytest.mark.parametrize("case", ["block_size", "scenario", "other_n", "lane_devices"])
def test_composition_errors_are_the_reference(case):
    n = 40
    spec, _, _ = _spec(n)
    prob = Quadratic(n)
    kw = {"block_size": dict(block_size=4), "scenario": dict(scenario="erlang2"),
          "other_n": dict(), "lane_devices": dict(lane_devices=2)}[case]
    msg = {"block_size": "requires block_size=1", "scenario": "dense-only",
           "other_n": "ClassSpec covers", "lane_devices": "requires lane_devices=1"}[case]
    N = n + 1 if case == "other_n" else n
    tkw, jkw = dict(kw), dict(kw)
    if case == "scenario":
        tkw["scenario"], jkw["scenario"] = get_scenario("erlang2"), j_get_scenario("erlang2")
    with pytest.raises(ValueError, match=msg):
        engine_scan.make_fused_runner(prob.device_grad, N, 4, 100, classes=spec, **tkw)
    if case != "lane_devices":  # the reference checks the JAX devices first there
        with pytest.raises(ValueError, match=msg):
            jes.make_fused_runner(JQuadratic(prob.c).device_grad, N, 4, 100, classes=spec, **jkw)


@pytest.mark.parametrize("kw,msg", [
    (dict(block_size=4), "does not compose with block_size > 1"),
    (dict(ckpt_dir="unused", ckpt_every=10), "does not compose with checkpointing"),
    (dict(mu=np.arange(1.0, 101.0)), "exceed max_classes"),
    (dict(faults=FaultConfig(crash_rate=tuple(np.linspace(0.01, 0.2, 100)))),
     "varies within speed class"),
], ids=["blocked", "checkpointed", "classes", "fault_rates"])
def test_server_config_sparse_true_refusals(kw, msg):
    """``sparse=True`` raises the reference's ValueError where the sparse
    stream does not compose; ``"auto"`` falls back to the dense stream."""
    prob = Quadratic(100)
    base = dict(n=100, C=4, T=40, eta=0.05, engine="scan", stream="device", device="cpu")
    with pytest.raises(ValueError, match=msg):
        run_generalized_async_sgd(np.zeros(prob.d, np.float32), prob,
                                  ServerConfig(sparse=True, **base, **kw))
