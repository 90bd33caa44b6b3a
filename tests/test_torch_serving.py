"""PyTorch port, the serving plane (`core.serving`,
`stream_device.merged_stream_step`, the fused runner and the checkpointed
driver with ``serving=``): against the JAX package on the same inputs.

1. The pieces: `ServingConfig` validation with the reference's errors;
   `backoff_delay`, `hist_bucket` and `hist_quantile` bitwise;
   `serve_apply` (after `serve_time_step`) over 2000 numpy uniforms from
   the reference's state: the table, its cached ``cdf`` and every counter
   and histogram bitwise, the read path's checksum <= 1e-5 relative;
   `simulate_serving_host` bitwise for the same seed.
2. The merged race: `merged_stream_step` + `merged_stats_step` from the
   reference's state, clean and faulty, and `scan_draws(serving=)` on the
   reference's draws against a `lax.scan` of the reference's functions:
   integers exact, floats <= 1e-6.
3. The fused runner with ``serving=`` on the reference's draws against
   `repro`'s `make_fused_runner(serving=)`: weights <= 1e-5, every
   ``serve_*`` counter and histogram exact, also under faults, under the
   guard with poisoned gradients, adaptive, with a bf16 ring and on the
   MLP; the cell axis bitwise each cell; `run_checkpointed` on the
   reference's ``fold_in`` draws against the reference's, truncate-and-
   resume bitwise; the reference's properties (exact conservation under a
   2x overload, the token bucket shedding more, a guard-rejected update
   never served) and its law against the host oracle; every reference
   `ValueError` of the serving combinations.
"""
import os
import re
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine_ckpt as jck  # noqa: E402
from repro.core import engine_scan as jes  # noqa: E402
from repro.core import serving as jsv  # noqa: E402
from repro.core import stream_device as jsd  # noqa: E402
from repro.core.async_sgd import ServerConfig as JServerConfig  # noqa: E402
from repro.core.async_sgd import run_generalized_async_sgd as j_run  # noqa: E402
from repro.core.engine_scan import GuardConfig as JGuardConfig  # noqa: E402
from repro.core.queue_sim import FaultConfig as JFaultConfig  # noqa: E402
from repro_torch.core import ServerConfig, run_generalized_async_sgd  # noqa: E402
from repro_torch.core import engine_ckpt as ck  # noqa: E402
from repro_torch.core import engine_scan  # noqa: E402
from repro_torch.core import serving as sv  # noqa: E402
from repro_torch.core import stream_device as sd  # noqa: E402
from repro_torch.core.engine_scan import GuardConfig  # noqa: E402
from repro_torch.core.queue_sim import FaultConfig  # noqa: E402
from repro_torch.core.serving import ServingConfig  # noqa: E402
from test_torch_stream import _ref_draws  # noqa: E402

N, C = 8, 4
MU = np.linspace(0.5, 2.0, N).astype(np.float32)
P = np.full(N, 1 / N, np.float32)
TARG = np.arange(N, dtype=np.float32)
FAULT = dict(off_rate=0.2, on_rate=1.0, crash_rate=0.05, timeout_rate=0.1)

# tests/test_serving.py's 2x overload: lambda = 2 nu, timeouts and retries on
OVERLOAD = dict(arrival_rate=6.0, serve_rate=3.0, queue_cap=5, deadline=1.0, max_retries=2,
                backoff_base=0.1, backoff_cap=0.4)
BUCKET = dict(arrival_rate=3.0, serve_rate=2.0, queue_cap=4, bucket_rate=1.5, bucket_cap=3.0,
              deadline=0.7, max_retries=2, backoff_base=0.1, backoff_cap=0.3)
CLI = dict(arrival_rate=2.0, serve_rate=4.0, queue_cap=8, deadline=2.0, max_retries=2)
CONFIGS = {"overload": OVERLOAD, "bucket": BUCKET, "cli": CLI}


def _pair(kw):
    return jsv.ServingConfig(**kw), ServingConfig(**kw)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30))) if b.size else 0.0


def _same(t_nt, j_nt, skip=(), float_tol=0.0):
    """Every field of a port NamedTuple against the reference's: integers
    exact, floats bitwise (``float_tol`` 0) or within a relative tolerance."""
    for name in j_nt._fields:
        if name in skip:
            continue
        a = getattr(t_nt, name).detach().cpu().numpy()
        b = np.asarray(getattr(j_nt, name))
        if b.dtype.kind == "f":
            if float_tol:
                assert _rel(a, b) <= float_tol, name
            else:
                np.testing.assert_array_equal(a.view(np.uint32), b.astype(np.float32).view(
                    np.uint32), err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


# ------------------------------------------------------------------ #
# 1. the pieces
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("kw", [
    dict(arrival_rate=1.0, serve_rate=0.0),
    dict(arrival_rate=1.0, queue_cap=0),
    dict(arrival_rate=1.0, queue_cap=8, table_cap=3),
    dict(arrival_rate=1.0, backoff_base=0.0),
    dict(arrival_rate=1.0, backoff_cap=-1.0),
], ids=["serve_rate", "queue_cap", "table_cap", "backoff_base", "backoff_cap"])
def test_config_validation_raises_the_reference_errors(kw):
    jc, tc = _pair(kw)
    with pytest.raises(ValueError) as je:
        jc.validate()
    with pytest.raises(ValueError, match=re.escape(str(je.value))):
        tc.validate()
    # disabled (no arrivals): nothing is checked, in either package
    off = dict(kw, arrival_rate=0.0)
    assert not ServingConfig(**off).enabled and ServingConfig(**off).validate()
    jsv.ServingConfig(**off).validate()


def test_config_fields_table_size_and_cache_key():
    for kw in list(CONFIGS.values()) + [dict(queue_cap=8, table_cap=20), {}]:
        jc, tc = _pair(kw)
        assert tc.R == jc.R and tc.enabled == jc.enabled
        assert tc.cache_key() == jc.cache_key()
    assert ServingConfig(queue_cap=8, max_retries=2).R == 11
    import dataclasses
    assert ([f.name for f in dataclasses.fields(ServingConfig)]
            == [f.name for f in dataclasses.fields(jsv.ServingConfig)])


def test_backoff_hist_bucket_and_quantile_bitwise():
    for base, cap in [(0.1, 0.4), (0.25, 2.0), (1.0, 1.0), (0.5, 64.0)]:
        jc, tc = _pair(dict(backoff_base=base, backoff_cap=cap))
        att = np.arange(0, 40)
        d = sv.backoff_delay(tc, torch.tensor(att)).numpy()
        np.testing.assert_array_equal(d, np.asarray(jsv.backoff_delay(jc, jnp.asarray(att))))
        assert (d <= cap + 1e-6).all() and (d > 0).all()
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(0, 5, 4000), 10.0 ** rng.uniform(-12, 6, 4000),
                        2.0 ** np.arange(-12, 12), [0.0, -1.0, 1e-31, 1.0, 3.0]]).astype(np.float32)
    for lo in (sv.HIST_LO, 0):
        np.testing.assert_array_equal(sv.hist_bucket(torch.from_numpy(x), lo=lo).numpy(),
                                      np.asarray(jsv.hist_bucket(jnp.asarray(x), lo=lo)))
    for h in (rng.integers(0, 9, sv.HIST_BUCKETS), np.eye(sv.HIST_BUCKETS)[3] * 100,
              np.zeros(sv.HIST_BUCKETS)):
        for q, lo in ((0.5, 0), (0.99, sv.HIST_LO), (0.01, 0)):
            a, b = sv.hist_quantile(torch.tensor(h), q, lo=lo), jsv.hist_quantile(h, q, lo=lo)
            assert (np.isnan(a) and np.isnan(b)) or a == b


def test_hist_bucket_matches_reference_off_powers_of_two():
    """``floor(log2(x))`` in float32 differs between XLA's CPU ``log2`` and
    torch's only where log2 rounds across an integer: x within two ulps of a
    power of two (ROADMAP Queue 3).  Around each power 2^k (k in -40 .. 63,
    the bucket window centred on it) and over random values the buckets
    agree but there; the port's bucket of 2^k itself is k, exactly."""
    rng = np.random.default_rng(0)
    for k in range(-40, 64):
        p = np.float32(2.0 ** k)
        near = [p, np.nextafter(p, np.float32(np.inf)), np.nextafter(p, np.float32(0))]
        x = np.concatenate([near, p * rng.uniform(0.5, 2.0, 64)]).astype(np.float32)
        t = sv.hist_bucket(torch.from_numpy(x), lo=k - 12).numpy()
        j = np.asarray(jsv.hist_bucket(jnp.asarray(x), lo=k - 12))
        assert t[0] == 12
        bad = np.flatnonzero(t != j)
        m, e = np.frexp(x[bad].astype(np.float64))
        assert (np.minimum(np.abs(m - 0.5), np.abs(m - 1.0)) <= 2.0 ** -23).all(), x[bad]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_serve_apply_bitwise_over_reference_uniforms(name):
    """2000 events from the empty table (70% live; the known-good pointer
    moved every 50 events): after every event the table, ``cdf``, depth,
    tokens and every counter and histogram bitwise; the checksum of the
    served rows' means <= 1e-5 relative."""
    jc, tc = _pair(CONFIGS[name])
    rng = np.random.default_rng(1)
    T = 2000
    u = rng.uniform(0.0, 1.0 - 1e-7, T).astype(np.float32)
    dts = rng.exponential(0.2, T).astype(np.float32)
    live = rng.random(T) < 0.7
    snaps = rng.normal(size=(C, 33)).astype(np.float32)
    j_sv, j_st = jsv.serve_init(jc), jsv.serve_stats_init()
    t_sv, t_st = sv.serve_init(tc, device="cpu"), sv.serve_stats_init(device="cpu")

    @jax.jit
    def j_step(s, st, u_, t_, dt, k, lv):
        st = jsv.serve_time_step(st, s, dt)
        return jsv.serve_apply(jc, s, st, u_, t_, k, jnp.asarray(snaps), live=lv)

    t_clock = np.float32(0.0)
    ts = torch.from_numpy(snaps)
    for k in range(T):
        t_clock = np.float32(t_clock + dts[k])
        if k % 50 == 25:  # the engine moves the pointer on accepted updates
            slot, step = k % C, k - 3
            j_sv = j_sv._replace(kg_slot=jnp.int32(slot), kg_step=jnp.int32(step))
            t_sv = t_sv._replace(kg_slot=torch.tensor(slot), kg_step=torch.tensor(step))
        j_sv, j_st = j_step(j_sv, j_st, jnp.float32(u[k]), jnp.float32(t_clock),
                            jnp.float32(dts[k]), jnp.int32(k), jnp.bool_(live[k]))
        t_st = sv.serve_time_step(t_st, t_sv, torch.tensor(dts[k]))
        t_sv, t_st = sv.serve_apply(tc, t_sv, t_st, torch.tensor(u[k]), torch.tensor(t_clock),
                                    k, ts, live=torch.tensor(bool(live[k])))
        if k % 97 == 0 or k == T - 1:
            _same(t_sv, j_sv)
            _same(t_st, j_st, skip=("checksum", "checksum_c"))
    assert _rel(float(t_st.checksum - t_st.checksum_c),
                float(j_st.checksum - j_st.checksum_c)) <= 1e-5
    assert int(j_st.served) > 50 and int(j_st.arrivals) > 200  # the plane was busy
    assert int(j_st.retried) > 0 and (name != "bucket" or int(j_st.shed) > 0)
    # a masked call leaves the table as it was
    t_sv2, _ = sv.serve_apply(tc, t_sv, t_st, torch.tensor(0.1), torch.tensor(t_clock), T, ts,
                              live=False)
    for a, b in zip(t_sv2, t_sv):
        assert torch.equal(a, b)
    d = sv.drain_counters(t_sv, t_st)
    assert d == jsv.drain_counters(j_sv, j_st)
    assert d["served"] + d["shed"] + d["timed_out"] == d["arrivals"]


@pytest.mark.parametrize("name,seed,horizon", [("overload", 0, 60.0), ("bucket", 3, 80.0),
                                               ("cli", 7, 50.0)])
def test_simulate_serving_host_bitwise(name, seed, horizon):
    jc, tc = _pair(CONFIGS[name])
    a, b = sv.simulate_serving_host(tc, horizon, seed), jsv.simulate_serving_host(jc, horizon, seed)
    assert a == b
    assert a["arrivals"] == a["served"] + a["shed"] + a["timed_out"]


# ------------------------------------------------------------------ #
# 2. the merged race
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("faulty", [False, True], ids=["clean", "faulty"])
def test_merged_step_from_the_reference_state(faulty):
    """300 events with an external rate redrawn each event (0 included):
    the event, the state and the statistics as the reference's; the
    external side's conditional uniform to 1e-6 of the race's total rate
    (it is a difference of two numbers of that size over ``ext``)."""
    n = 6
    mu = np.random.default_rng(1).uniform(0.5, 4.0, n).astype(np.float32)
    js, nodes = jsd.stream_init(jax.random.PRNGKey(2), n, C, jnp.full(n, 1 / n), fault=faulty)
    jst = jsd.stats_init(n, C, fault=faulty)
    ts, _ = sd.stream_init(torch.tensor(np.asarray(nodes)), n, C, fault=faulty)
    tst = sd.stats_init(n, C, fault=faulty, device="cpu")
    jfr = tfr = None
    if faulty:
        jfr = jsd.resolve_fault_rates(JFaultConfig(**FAULT), n)
        tfr = sd.resolve_fault_rates(FaultConfig(**FAULT), n, "cpu")
    rng = np.random.default_rng(3)
    j_step = jax.jit(lambda s, e, x: jsd.merged_stream_step(s, jnp.asarray(mu), e, x, jfr))
    n_ext = 0
    for k in range(300):
        ur, ue = rng.random(2).astype(np.float32)
        kn = int(rng.integers(n))
        ext = np.float32(0.0 if k % 11 == 0 else rng.uniform(0.1, 8.0))
        occ_j, av_j, occ_t, av_t = js.occ, js.avail, ts.occ, ts.avail
        js, jev, jx, ju = j_step(js, jnp.float32(ext), (jnp.float32(ur), jnp.float32(ue),
                                                         jnp.int32(kn)))
        ts, tev, tx, tu = sd.merged_stream_step(ts, mu, ext, (ur, ue, kn), tfr)
        if faulty:
            jst = jsd.fault_stats_step(jst, jev, occ_j, av_j, js.occ, k)
        else:
            jst = jsd.stats_step(jst, jev, occ_j, js.occ, k)
        tst = sd.merged_stats_step(tst, tev, occ_t, av_t, ts.occ, k)
        assert bool(tx) == bool(jx)
        n_ext += bool(jx)
        for f in ("j", "k", "slot", "kind"):
            assert int(getattr(tev, f)) == int(getattr(jev, f)), (k, f)
        if bool(jx):  # u_ext = (x - r_train) / ext: its error is that of x, ~ulp(tot)
            tot = -np.log1p(-np.float64(ue)) / float(jev.dt)
            assert abs(float(tu) - float(ju)) * ext <= 1e-6 * tot
        for f in ("t", "dt"):
            assert _rel(float(getattr(tev, f)), float(getattr(jev, f))) <= 1e-6
        for f in ("occ", "ring", "head", "tail") + (("avail",) if faulty else ()):
            np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)))
    for f in ("occ_sum", "comp", "slot_step") + (("kind_count",) if faulty else ()):
        np.testing.assert_array_equal(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)))
    for f in ("occ_tw", "busy_t", "delay_sum") + (("avail_tw",) if faulty else ()):
        assert _rel(getattr(tst, f).numpy(), getattr(jst, f)) <= 1e-6
    assert 30 < n_ext < 270


def _ref_merged_scan(jc, mu, nodes, ur, ue, K, jfr, faulty):
    """The reference's merged race over given draws, the fused runner's
    event body without the training half (its `lax.scan`)."""
    n = mu.shape[0]
    s0, _ = jsd.stream_init(jax.random.PRNGKey(0), n, C, jnp.full(n, 1 / n), fault=faulty)
    ring = jnp.zeros((n, C), jnp.int32)
    nodes = jnp.asarray(nodes, jnp.int32)
    pos = jnp.sum(jnp.tril(nodes[None, :] == nodes[:, None], -1), axis=1)
    ring = ring.at[nodes, pos].set(jnp.arange(C, dtype=jnp.int32))
    occ = jnp.zeros(n, jnp.int32).at[nodes].add(1)
    s0 = s0._replace(occ=occ, ring=ring, head=jnp.zeros(n, jnp.int32), tail=occ)
    st0 = jsd.stats_init(n, C, fault=faulty)
    snaps = jnp.zeros((C, 3), jnp.float32)

    def body(c, x):
        s, st, v, vs = c
        urk, uek, kn, k = x
        occ_pre, av_pre = s.occ, s.avail
        s, ev, is_ext, u_ext = jsd.merged_stream_step(s, jnp.asarray(mu), v.cdf[-1],
                                                      (urk, uek, kn), jfr)
        st = (jsd.fault_stats_step(st, ev, occ_pre, av_pre, s.occ, k) if faulty
              else jsd.stats_step(st, ev, occ_pre, s.occ, k))
        vs = jsv.serve_time_step(vs, v, ev.dt)
        v, vs = jsv.serve_apply(jc, v, vs, u_ext, ev.t, k, snaps, live=is_ext)
        return (s, st, v, vs), (ev.j, ev.slot, ev.kind, ev.t)

    T = len(ur)
    (_, st, v, vs), evs = jax.lax.scan(
        body, (s0, st0, jsv.serve_init(jc), jsv.serve_stats_init()),
        (jnp.asarray(ur), jnp.asarray(ue), jnp.asarray(K, jnp.int32), jnp.arange(T)))
    return st, v, vs, [np.asarray(e) for e in evs]


@pytest.mark.parametrize("faulty", [False, True], ids=["clean", "faulty"])
@pytest.mark.parametrize("name", ["overload", "cli"])
def test_scan_draws_serving_on_the_reference_draws(name, faulty):
    """T = 1000 merged events on the reference's draws: J, slot and kind
    exact, t <= 1e-6; the network's statistics; the serving table and
    counters (the read path aside: no replay, no pointer)."""
    jc, tc = _pair(CONFIGS[name])
    T, n = 1000, N
    key = jax.random.PRNGKey(5)
    nodes, ur, ue, ud, K = _ref_draws(key, n, C, T, P)
    jfr = jsd.resolve_fault_rates(JFaultConfig(**FAULT), n) if faulty else None
    jst, jv, jvs, (jJ, jslot, jkind, jt) = _ref_merged_scan(jc, MU, nodes, ur, ue, K, jfr, faulty)
    _, (J, Kt, t, slot, delay, kind), tst, (tv, tvs) = sd.scan_draws(
        torch.tensor(MU), torch.tensor(nodes), torch.tensor(ur), torch.tensor(ue),
        torch.tensor(K), fault=FaultConfig(**FAULT) if faulty else None, serving=tc)
    np.testing.assert_array_equal(J.numpy(), jJ)
    np.testing.assert_array_equal(slot.numpy(), jslot)
    np.testing.assert_array_equal(kind.numpy(), jkind)
    assert _rel(t.numpy(), jt) <= 1e-6
    for f in ("occ_sum", "comp", "slot_step") + (("kind_count",) if faulty else ()):
        np.testing.assert_array_equal(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)))
    for f in ("occ_tw", "busy_t", "delay_sum"):
        assert _rel(getattr(tst, f).numpy(), getattr(jst, f)) <= 1e-6
    _same(tv, jv, skip=("t_arr", "tokens", "t_tok", "kg_slot", "kg_step"))
    _same(tv, jv, skip=("attempt", "stt", "seq", "next_seq", "depth", "cdf", "kg_slot",
                        "kg_step"), float_tol=1e-6)
    _same(tvs, jvs, skip=("sojourn", "sojourn_c", "qdepth_tw", "qdepth_tw_c", "checksum",
                          "checksum_c", "stale_hist"))
    assert _rel(float(tvs.sojourn - tvs.sojourn_c), float(jvs.sojourn - jvs.sojourn_c)) <= 1e-6
    assert _rel(float(tvs.qdepth_tw - tvs.qdepth_tw_c),
                float(jvs.qdepth_tw - jvs.qdepth_tw_c)) <= 1e-6
    assert int(jvs.served) > 0
    assert int((jkind == 4).sum()) >= int(jvs.arrivals + jvs.served + jvs.retried)


# ------------------------------------------------------------------ #
# 3. the fused runner and the checkpointed driver
# ------------------------------------------------------------------ #
def _j_grad(j, w, k):
    return {"a": w["a"] - jnp.asarray(TARG)[j]}


def _t_grad(j, w, k):
    return {"a": w["a"] - torch.from_numpy(TARG)[j]}


def _j_poison(j, w, k):
    bad = (j == 3) & (k >= 100) & (k < 400)
    return {"a": jnp.where(bad, jnp.float32(jnp.inf), w["a"] - jnp.asarray(TARG)[j])}


def _t_poison(j, w, k):
    bad = (j == 3) & (k >= 100) & (k < 400)
    return {"a": torch.where(bad, torch.inf, w["a"] - torch.from_numpy(TARG)[j])}


_FUSED = {
    "overload": dict(serving=OVERLOAD),
    "plain": dict(serving=OVERLOAD, weighting="plain"),
    "bucket": dict(serving=BUCKET),
    "faults": dict(serving=CLI, fault=FAULT),
    "guard_poison": dict(serving=OVERLOAD, guard=dict(max_grad_norm=1e3), poison=True),
    "faults_guard_stale": dict(serving=OVERLOAD, fault=FAULT,
                               guard=dict(max_grad_norm=1e3, stale_cutoff=6), poison=True),
    "adaptive": dict(serving=CLI, adaptive=True, refresh_every=100, eval_every=200),
    "bf16_ring": dict(serving=OVERLOAD, snapshot_dtype="bfloat16"),
}


def _kw(case):
    """``(jax kwargs, port kwargs, jax grad, port grad)`` of a case."""
    kw = dict(_FUSED[case])
    poison = kw.pop("poison", False)
    jkw, tkw = dict(kw), dict(kw)
    jkw["serving"], tkw["serving"] = _pair(kw["serving"])
    if "fault" in kw:
        jkw["fault"], tkw["fault"] = JFaultConfig(**kw["fault"]), FaultConfig(**kw["fault"])
    if "guard" in kw:
        jkw["guard"], tkw["guard"] = JGuardConfig(**kw["guard"]), GuardConfig(**kw["guard"])
    if kw.get("eval_every"):
        jkw["eval_fn"] = lambda w: jnp.sum(w["a"] ** 2)
        tkw["eval_fn"] = lambda w: torch.sum(w["a"] ** 2)
    return jkw, tkw, (_j_poison if poison else _j_grad), (_t_poison if poison else _t_grad)


def _same_serve_extras(xt, xj):
    names = sorted(k for k in xj if k.startswith("serve_"))
    assert names and names == sorted(k for k in xt if k.startswith("serve_"))
    for k in names:
        a, b = np.asarray(xt[k]), np.asarray(xj[k])
        if k in ("serve_checksum",):
            assert (not np.isfinite(b) and not np.isfinite(a)) or _rel(a, b) <= 1e-5, k
        elif b.dtype.kind == "f":
            assert _rel(a, b) <= 1e-6, k
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("case", sorted(_FUSED))
def test_fused_runner_matches_reference(case):
    T = 600
    jkw, tkw, jg, tg = _kw(case)
    key = jax.random.PRNGKey(0)
    jr = jes.make_fused_runner(jg, N, C, T, **jkw)
    wj, ej, xj = jax.jit(jr)({"a": jnp.zeros(6)}, jnp.asarray(MU), jnp.asarray(P), key, 0.05)
    nodes, ur, ue, ud, _ = _ref_draws(key, N, C, T, P)
    tr = engine_scan.make_fused_runner(tg, N, C, T, **tkw)
    wt, et, xt = tr.from_draws({"a": torch.zeros(6)}, MU, P, 0.05,
                               *[torch.tensor(a) for a in (nodes, ur, ue, ud)])
    np.testing.assert_allclose(wt["a"].numpy(), np.asarray(wj["a"]), atol=1e-5)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-5, atol=1e-6)
    _same_serve_extras(xt, xj)
    for f in ("comp", "guard_rejects", "stale_drops", "kind_count"):
        if f in xj:
            np.testing.assert_array_equal(xt[f].numpy(), np.asarray(xj[f]), err_msg=f)
    for f in ("p_final", "p_traj"):
        np.testing.assert_allclose(xt[f].numpy(), np.asarray(xj[f]), atol=1e-5)
    assert _rel(xt["t"].numpy(), xj["t"]) <= 1e-6
    if "guard" in jkw:
        assert int(xj["guard_rejects"]) > 0 and np.isfinite(float(xj["serve_checksum"]))


def test_mlp_fused_runner_matches_reference():
    """The classification MLP (`test_torch_fl._pair`) under the 2x overload."""
    from test_torch_fl import _pair as _mlp_pair

    (_, _, j_setup), (_, _, setup) = _mlp_pair()
    n, T = 16, 200
    mu = np.random.default_rng(3).uniform(0.5, 4.0, n)
    p = np.full(n, 1 / n)
    key = jax.random.PRNGKey(4)
    jc, tc = _pair(OVERLOAD)
    jr = jes.make_fused_runner(j_setup.clients.device_grad, n, C, T, eval_fn=j_setup.eval_fn,
                               eval_every=100, serving=jc)
    wj, ej, xj = jax.jit(jr)(j_setup.params, jnp.asarray(mu), jnp.asarray(p), key, 0.05)
    tr = engine_scan.make_fused_runner(setup.clients.device_grad, n, C, T,
                                       eval_fn=setup.eval_fn, eval_every=100, serving=tc)
    nodes, ur, ue, ud, _ = _ref_draws(key, n, C, T, p)
    wt, et, xt = tr.from_draws(setup.params, mu, p, 0.05,
                               *[torch.tensor(a) for a in (nodes, ur, ue, ud)])
    assert max(float(np.abs(wt[k].numpy() - np.asarray(wj[k])).max()) for k in wj) <= 1e-5
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=2 / 2048)
    _same_serve_extras(xt, xj)


def test_cell_axis_is_each_cell_alone():
    """Three cells on the cell axis under serving: each cell's weights and
    ``serve_*`` extras bitwise its run alone."""
    T = 300
    tc = ServingConfig(**OVERLOAD)
    draws = [_ref_draws(jax.random.PRNGKey(s), N, C, T, P)[:4] for s in range(3)]
    stacked = [torch.tensor(np.stack(d)) for d in zip(*draws)]
    mus = np.stack([MU * (1 + 0.1 * s) for s in range(3)])
    cells = engine_scan.make_fused_runner(_t_grad, N, C, T, serving=tc, vmap_scenarios=True)
    wc, _, xc = cells.from_draws({"a": torch.zeros(6)}, mus, np.stack([P] * 3), 0.05, *stacked)
    one = engine_scan.make_fused_runner(_t_grad, N, C, T, serving=tc)
    for s in range(3):
        w1, _, x1 = one.from_draws({"a": torch.zeros(6)}, mus[s], P, 0.05,
                                   *[torch.tensor(a) for a in draws[s]])
        assert torch.equal(wc["a"][s], w1["a"])
        for k in x1:
            if k.startswith("serve_"):
                assert torch.equal(xc[k][s], x1[k]), k


def _ref_chunk_draws(key, n, p):
    k_init, k_race, k_exp, k_disp = jax.random.split(key, 4)
    _, nodes = jsd.stream_init(k_init, n, C, jnp.asarray(p, jnp.float32))

    def chunk_draws(c, Lc):
        return tuple(torch.tensor(np.asarray(jax.random.uniform(jax.random.fold_in(k, c), (Lc,))))
                     for k in (k_race, k_exp, k_disp))

    return torch.tensor(np.asarray(nodes)), chunk_draws


@pytest.mark.parametrize("case", ["overload", "guard_poison"])
def test_run_checkpointed_matches_reference(case, tmp_path):
    """On the reference's per-chunk ``fold_in`` draws: weights <= 1e-5,
    the counters and the ``serve_*`` extras as the reference's."""
    jkw, tkw, jg, tg = _kw(case)
    T = 430
    wj, _, xj = jck.run_checkpointed(jg, N, C, T, w0={"a": jnp.zeros(6)}, mu=MU, p0=P,
                                     key=jax.random.PRNGKey(1), eta=0.05,
                                     ckpt_dir=str(tmp_path / "jax"), ckpt_every=100, **jkw)
    wt, _, xt = ck.run_checkpointed(tg, N, C, T, w0={"a": torch.zeros(6)}, mu=MU, p0=P, key=1,
                                    eta=0.05, ckpt_dir=str(tmp_path / "port"), ckpt_every=100,
                                    draws=_ref_chunk_draws(jax.random.PRNGKey(1), N, P), **tkw)
    np.testing.assert_allclose(wt["a"].numpy(), np.asarray(wj["a"]), atol=1e-5)
    assert set(xt) == set(xj)
    _same_serve_extras(xt, xj)
    for f in ("comp", "guard_rejects", "stale_drops"):
        if f in xj:
            np.testing.assert_array_equal(xt[f].numpy(), np.asarray(xj[f]))


class _Src:
    def device_grad(self, j, w, k):
        return {"a": w["a"] - torch.from_numpy(np.linspace(-1, 1, N).astype(np.float32))[j]}


def _ckpt_cfg(d, resume, guard=None):
    return ServerConfig(n=N, C=C, T=400, eta=0.05, seed=3, engine="scan", stream="device",
                        sparse=False, serving=ServingConfig(**OVERLOAD), ckpt_dir=d,
                        ckpt_every=100, resume=resume, guard=guard, device="cpu")


@pytest.mark.parametrize("guard", [None, GuardConfig(max_grad_norm=1e3)], ids=["plain", "guard"])
def test_ckpt_truncate_and_resume_bitwise(guard, tmp_path):
    """Killed after its second save (the later checkpoints deleted) and
    resumed: weights and every ``serve_*`` extra bitwise the uninterrupted
    run; the fingerprint holds the serving configuration."""
    from repro_torch.ckpt import checkpoint as ckp

    d = str(tmp_path / "serve_ckpt")
    w_full, tr_full = run_generalized_async_sgd({"a": torch.zeros(6)}, _Src(),
                                                _ckpt_cfg(d, False, guard))
    for s in ckp.available_steps(d):
        if s > 200:
            shutil.rmtree(os.path.join(d, f"step_{s:010d}"))
    assert ckp.available_steps(d) == [200]  # the run keeps its newest 3 saves
    w_res, tr_res = run_generalized_async_sgd({"a": torch.zeros(6)}, _Src(),
                                              _ckpt_cfg(d, True, guard))
    assert torch.equal(w_full["a"], w_res["a"])
    names = [k for k in tr_full.extras if k.startswith("serve_")]
    assert len(names) == 16
    for k in names:
        assert np.array_equal(tr_full.extras[k], tr_res.extras[k]), k
    other = ServerConfig(**{**_ckpt_cfg(d, True, guard).__dict__,
                            "serving": ServingConfig(**dict(OVERLOAD, queue_cap=4))})
    with pytest.raises(ValueError, match="mismatch"):
        run_generalized_async_sgd({"a": torch.zeros(6)}, _Src(), other)


# ------------------------------------------------------------------ #
# the reference's properties, on the port's own generator
# ------------------------------------------------------------------ #
def _run(kw, T, seed=0, guard=None, grad=_t_grad):
    runner = engine_scan.jit_fused_runner(grad, N, C, T, serving=ServingConfig(**kw), guard=guard)
    w, _, x = runner({"a": torch.zeros(6)}, MU, P, seed, 0.05)
    return w, {k: v.numpy() for k, v in x.items()}


def _conserved(x) -> bool:
    return int(x["serve_arrivals"]) == (int(x["serve_served"]) + int(x["serve_shed"])
                                        + int(x["serve_timed_out"]) + int(x["serve_pending"]))


def test_overload_conservation_exact_and_depth_bounded():
    w, x = _run(OVERLOAD, T=2000)
    assert _conserved(x) and int(x["serve_arrivals"]) > 100 and int(x["serve_shed"]) > 0
    assert int(x["serve_qdepth_max"]) <= OVERLOAD["queue_cap"]
    assert int(x["serve_kg_step"]) > 0 and bool(torch.isfinite(w["a"]).all())


def test_token_bucket_admission_sheds_more():
    base = dict(arrival_rate=4.0, serve_rate=4.0, queue_cap=8)
    bucket = dict(base, bucket_rate=0.5, bucket_cap=2.0)
    _, x0 = _run(base, T=1500, seed=7)
    _, x1 = _run(bucket, T=1500, seed=7)
    assert int(x1["serve_shed"]) > int(x0["serve_shed"])
    assert _conserved(x0) and _conserved(x1)


@pytest.mark.parametrize("guarded", [True, False], ids=["guard", "no_guard"])
def test_guard_rejected_update_never_served(guarded):
    """Client 3 emits +inf gradients over events 100..399 while traffic is
    live: with the guard the pointer stays on the last accepted row and the
    checksum of the served rows stays finite; without it the poison reaches
    the served rows (the control)."""
    guard = GuardConfig(max_grad_norm=1e3) if guarded else None
    w, x = _run(OVERLOAD, T=2000, guard=guard, grad=_t_poison)
    if guarded:
        assert int(x["guard_rejects"]) > 0 and int(x["serve_served"]) > 50
        assert np.isfinite(float(x["serve_checksum"]))
        assert bool(torch.isfinite(w["a"]).all())
        assert int(x["serve_stale_hist"].sum()) == int(x["serve_served"])
    else:
        assert not np.isfinite(float(x["serve_checksum"]))


def test_port_generator_matches_host_oracle_law():
    """`tests/test_serving.py`'s law bars on the port's own generator:
    outcome fractions within 0.06 and the mean sojourn within 25% of the
    host oracle's, the arrival rate within 15%."""
    cfg = dict(arrival_rate=2.5, serve_rate=3.0, queue_cap=5, deadline=0.8, max_retries=1,
               backoff_base=0.2, backoff_cap=0.8)
    dev = dict(arrivals=0, served=0, shed=0, timed_out=0, sojourn=0.0, t=0.0)
    for seed in range(3):
        _, x = _run(cfg, T=4000, seed=seed)
        for k in ("arrivals", "served", "shed"):
            dev[k] += int(x[f"serve_{k}"])
        dev["timed_out"] += int(x["serve_timed_out"]) + int(x["serve_pending"])
        dev["sojourn"] += float(x["serve_sojourn_sum"])
        dev["t"] += float(x["serve_t_final"])
    horizon = dev["t"] / 3
    host = dict(arrivals=0, served=0, shed=0, timed_out=0)
    sjs = []
    for seed in range(20):
        h = sv.simulate_serving_host(ServingConfig(**cfg), horizon, seed=seed)
        for k in host:
            host[k] += h[k]
        sjs += h["sojourns"]
    assert dev["arrivals"] / dev["t"] == pytest.approx(cfg["arrival_rate"], rel=0.15)
    for k in ("served", "shed", "timed_out"):
        assert abs(dev[k] / dev["arrivals"] - host[k] / host["arrivals"]) < 0.06, k
    assert dev["sojourn"] / dev["served"] == pytest.approx(float(np.mean(sjs)), rel=0.25)


# ------------------------------------------------------------------ #
# the reference's ValueErrors
# ------------------------------------------------------------------ #
def _runner_case(name):
    """``(call the reference, call the port)`` of one refused combination."""
    jc, tc = _pair(OVERLOAD)
    w_j, w_t = {"a": jnp.zeros(6)}, {"a": torch.zeros(6)}
    if name == "non_float":
        def j():
            r = jes.make_fused_runner(_j_grad, N, C, 50, serving=jc)
            r({"a": jnp.zeros(6), "i": jnp.zeros(2, jnp.int32)}, jnp.asarray(MU), jnp.asarray(P),
              jax.random.PRNGKey(0), 0.05)

        def t():
            r = engine_scan.make_fused_runner(_t_grad, N, C, 50, serving=tc)
            r({"a": torch.zeros(6), "i": torch.zeros(2, dtype=torch.int32)}, MU, P, 0, 0.05)
        return j, t
    if name == "checkpointed_blocked":
        return (lambda: jck.run_checkpointed(_j_grad, N, C, 50, w0=w_j, mu=MU, p0=P,
                                             key=jax.random.PRNGKey(0), eta=0.05, ckpt_dir="x",
                                             ckpt_every=10, block_size=2, serving=jc),
                lambda: ck.run_checkpointed(_t_grad, N, C, 50, w0=w_t, mu=MU, p0=P, key=0,
                                            eta=0.05, ckpt_dir="x", ckpt_every=10, block_size=2,
                                            serving=tc))
    if name == "invalid_config":
        jbad, tbad = _pair(dict(OVERLOAD, serve_rate=0.0))
        return (lambda: jes.make_fused_runner(_j_grad, N, C, 50, serving=jbad),
                lambda: engine_scan.make_fused_runner(_t_grad, N, C, 50, serving=tbad))
    kw = {
        "blocked": dict(block_size=2),
        "fedbuff": dict(fedbuff_Z=5, weighting="plain"),
        "update_fn": dict(update_fn="K1"),
        "scenario": dict(scenario="erlang2"),
        "lanes": dict(lane_devices=2),
    }[name]
    jkw, tkw = dict(kw), dict(kw)
    if "update_fn" in kw:
        from repro_torch.kernels.ops import tree_weighted_update

        jkw["update_fn"] = lambda w, g, s: jax.tree_util.tree_map(lambda a, b: a - s * b, w, g)
        tkw["update_fn"] = tree_weighted_update
    if "scenario" in kw:
        from repro.core.scenario import get_scenario as jget
        from repro_torch.core.scenario import get_scenario as tget

        jkw["scenario"], tkw["scenario"] = jget("erlang2"), tget("erlang2")
    return (lambda: jes.make_fused_runner(_j_grad, N, C, 50, serving=jc, **jkw),
            lambda: engine_scan.make_fused_runner(_t_grad, N, C, 50, serving=tc, **tkw))


def _sparse_case():
    from repro.core.stream_device import build_class_spec as jbuild
    from repro_torch.core.stream_device import build_class_spec as tbuild

    jc, tc = _pair(OVERLOAD)
    mu2 = np.repeat([1.0, 3.0], N // 2)
    return (lambda: jes.make_fused_runner(_j_grad, N, C, 50, serving=jc,
                                          classes=jbuild(mu2, P)[0]),
            lambda: engine_scan.make_fused_runner(_t_grad, N, C, 50, serving=tc,
                                                  classes=tbuild(mu2, P)[0]))


def _server_case(name):
    jc, tc = _pair(OVERLOAD)
    kw = {
        "host_stream": dict(engine="scan", stream="host"),
        "sparse_true": dict(engine="scan", stream="device", sparse=True),
        "server_scenario": dict(engine="scan", stream="device", scenario="erlang2"),
        "server_pallas": dict(engine="scan", stream="device", update="pallas"),
        "server_fedbuff": dict(engine="scan", stream="device"),
    }[name]
    base = dict(n=N, C=C, T=50, eta=0.05, **kw)

    def j():
        from repro.core.async_sgd import run_fedbuff as j_fedbuff
        cfg = JServerConfig(serving=jc, **base)
        fn = j_fedbuff if name == "server_fedbuff" else j_run
        fn({"a": jnp.zeros(6)}, _JSrc(), cfg)

    def t():
        from repro_torch.core import run_fedbuff
        cfg = ServerConfig(serving=tc, device="cpu", **base)
        fn = run_fedbuff if name == "server_fedbuff" else run_generalized_async_sgd
        fn({"a": torch.zeros(6)}, _Src(), cfg)
    return j, t


class _JSrc:
    def device_grad(self, j, w, k):
        return {"a": w["a"] - jnp.asarray(TARG)[j]}


_REFUSED = ["blocked", "fedbuff", "update_fn", "scenario", "lanes", "non_float",
            "checkpointed_blocked", "invalid_config", "sparse", "host_stream", "sparse_true",
            "server_scenario", "server_pallas", "server_fedbuff"]


@pytest.mark.parametrize("name", _REFUSED)
def test_serving_combinations_raise_the_reference_errors(name):
    """Each combination the reference refuses with serving raises its
    `ValueError` in the port, with its message (lanes: the reference's
    device check fires first, the port's serving check; both ValueError)."""
    if name == "sparse":
        j, t = _sparse_case()
    elif name in ("host_stream", "sparse_true", "server_scenario", "server_pallas",
                  "server_fedbuff"):
        j, t = _server_case(name)
    else:
        j, t = _runner_case(name)
    with pytest.raises(ValueError) as je:
        j()
    match = None if name == "lanes" else re.escape(str(je.value))
    with pytest.raises(ValueError, match=match):
        t()
