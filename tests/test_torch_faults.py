"""PyTorch port, fault injection and the divergence guard on the host
stream, against the JAX package.

  * `export_stream` with faults is bitwise the reference's (J, K, t, slot,
    kind, delay_steps);
  * the replay per event and blocked (K2's plain version on the CPU) against
    JAX's scan on the same inputs: weights within 1e-5, equal
    ``guard_rejects``, ``stale_drops`` and ``kind_count`` — on a quadratic
    and on the paper's MLP (`_pair` from `tests/test_torch_fl.py`: the JAX
    run's weights and minibatch offsets);
  * the port's `_python_fault_loop` against JAX's and against the port's
    scan (<= 1e-5, as `tests/test_faults.py::test_python_scan_fault_parity`);
  * the guard on a source that spikes and emits NaN (`tests/test_faults.py`'s
    `_SpikeSource`): rejects counted as in JAX, finite weights, and the same
    run unguarded destroyed;
  * the compositions that raise: the guard with K1 per event, faults or
    the staleness cutoff with FedBuff, the guard under lanes without a
    process group of its ranks.
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import FaultConfig as JFaultConfig  # noqa: E402
from repro.core import GuardConfig as JGuardConfig  # noqa: E402
from repro.core import ServerConfig as JServerConfig  # noqa: E402
from repro.core import SimConfig as JSimConfig  # noqa: E402
from repro.core import export_stream as j_export_stream  # noqa: E402
from repro.core import run_fedbuff as j_run_fedbuff  # noqa: E402
from repro.core import run_generalized_async_sgd as j_run  # noqa: E402
from repro.fl import engine as j_fl  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.core import (  # noqa: E402
    KIND_COMPLETE,
    KIND_FLIP,
    FaultConfig,
    GuardConfig,
    ServerConfig,
    SimConfig,
    export_stream,
    run_fedbuff,
    run_generalized_async_sgd,
    step_scales,
)
from repro_torch.core import engine_scan  # noqa: E402
from repro_torch.fl import engine as t_fl  # noqa: E402
from test_torch_fl import C, N, _gap, _pair  # noqa: E402

FAULT = dict(off_rate=0.3, on_rate=1.0, crash_rate=0.1, timeout_rate=0.2)
BENCH_FAULT = dict(off_rate=0.2, on_rate=1.0, crash_rate=0.05, timeout_rate=0.1)


def _leaves(w) -> np.ndarray:
    return np.concatenate([np.asarray(w[k], np.float64).ravel() for k in sorted(w)])


class _Quad:
    """grad = w - target_j: host ``grad`` (Python ints) and ``device_grad``
    (0-d tensors, also under vmap)."""

    def __init__(self, n):
        self.targ = torch.arange(n, dtype=torch.float32)

    def _g(self, j, w, k):
        return w["a"] - self.targ.index_select(0, torch.as_tensor(j).reshape(1))[0]

    def grad(self, j, w, k):
        return {"a": self._g(j, w, k)}

    def device_grad(self, j, w, k):
        return {"a": self._g(j, w, k)}


class _Spike(_Quad):
    """A norm-exploding gradient every ``spike_every``-th server step and a
    NaN gradient at ``nan_step`` (`tests/test_faults.py`'s source)."""

    def __init__(self, n, spike_every=50, nan_step=125):
        super().__init__(n)
        self.spike_every, self.nan_step = spike_every, nan_step

    def device_grad(self, j, w, k):
        g = self._g(j, w, k)
        g = torch.where((k % self.spike_every) == (self.spike_every - 1), g + 1e6, g)
        return {"a": torch.where(k == self.nan_step, torch.full_like(g, float("nan")), g)}

    def grad(self, j, w, k):
        return self.device_grad(torch.tensor(j), w, torch.tensor(k))


class _JQuad:
    def __init__(self, n):
        self.targ = np.arange(n, dtype=np.float32)

    def grad(self, j, w, k):
        return {"a": np.asarray(w["a"]) - self.targ[j]}

    def device_grad(self, j, w, k):
        return {"a": w["a"] - jnp.asarray(self.targ)[j]}


class _JSpike(_JQuad):
    def __init__(self, n, spike_every=50, nan_step=125):
        super().__init__(n)
        self.spike_every, self.nan_step = spike_every, nan_step

    def device_grad(self, j, w, k):
        g = w["a"] - jnp.asarray(self.targ)[j]
        g = jnp.where((k % self.spike_every) == (self.spike_every - 1), g + 1e6, g)
        return {"a": jnp.where(k == self.nan_step, jnp.full_like(g, jnp.nan), g)}

    def grad(self, j, w, k):
        g = np.asarray(w["a"]) - self.targ[j]
        if (k % self.spike_every) == (self.spike_every - 1):
            g = g + 1e6
        if k == self.nan_step:
            g = np.full_like(g, np.nan)
        return {"a": g}


def _pair_cfgs(fault=None, guard=None, **kw):
    """One run's ServerConfig in each package: (port, JAX)."""
    t = ServerConfig(device="cpu", faults=None if fault is None else FaultConfig(**fault),
                     guard=None if guard is None else GuardConfig(**guard), **kw)
    j = JServerConfig(faults=None if fault is None else JFaultConfig(**fault),
                      guard=None if guard is None else JGuardConfig(**guard),
                      pallas_interpret=True, **kw)
    return t, j


def _same_extras(t_extras, j_extras):
    for name in ("guard_rejects", "stale_drops"):
        assert t_extras.get(name) == j_extras.get(name), name
    np.testing.assert_array_equal(t_extras["kind_count"], j_extras["kind_count"])


# ------------------------------------------------------------------ #
# the host event stream
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("seed,fault", [
    (3, FAULT),
    (11, BENCH_FAULT),
    (5, dict(off_rate=np.linspace(0.0, 0.6, 6), on_rate=1.5, crash_rate=np.full(6, 0.05),
             timeout_rate=0.3)),
])
def test_export_stream_with_faults_is_bitwise_jax(seed, fault):
    n, C_, T = 6, 3, 2000
    kw = dict(mu=np.linspace(0.5, 2.0, n), p=np.full(n, 1 / n), C=C_, T=T, seed=seed)
    a = export_stream(SimConfig(fault=FaultConfig(**fault), **kw))
    b = j_export_stream(JSimConfig(fault=JFaultConfig(**fault), **kw))
    for name in ("J", "K", "t", "slot", "kind", "delay_steps", "queue_len_sum"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    assert (a.slot[a.kind == KIND_FLIP] == C_).all()  # flips carry the trash slot
    scale = step_scales(a, 0.1, kw["p"], "importance")
    assert (scale[a.kind != KIND_COMPLETE] == 0).all() and (scale[a.kind == KIND_COMPLETE] > 0).all()


# ------------------------------------------------------------------ #
# replay parity on a quadratic: port python == port scan == JAX scan
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("block_size", [1, 6])
def test_python_scan_fault_parity(block_size):
    n = 6
    base = dict(n=n, C=3, T=400, eta=0.05, mu=np.linspace(0.5, 2.0, n), seed=7)
    guard = dict(max_grad_norm=50.0, stale_cutoff=60)
    t_cfg, j_cfg = _pair_cfgs(FAULT, guard, **base)
    w0 = {"a": np.zeros(5, np.float32)}
    w_py, tr_py = run_generalized_async_sgd(w0, _Quad(n), t_cfg)
    w_sc, tr_sc = run_generalized_async_sgd(
        w0, _Quad(n), replace(t_cfg, engine="scan", block_size=block_size))
    w_jpy, tr_jpy = j_run({"a": jnp.zeros(5, jnp.float32)}, _JQuad(n), j_cfg)
    w_j, tr_j = j_run({"a": jnp.zeros(5, jnp.float32)}, _JQuad(n),
                      replace(j_cfg, engine="scan", block_size=block_size))
    assert np.max(np.abs(_leaves(w_py) - _leaves(w_sc))) < 1e-5
    assert np.max(np.abs(_leaves(w_py) - _leaves(w_jpy))) < 1e-5
    assert np.max(np.abs(_leaves(w_sc) - _leaves(w_j))) < 1e-5
    for tr in (tr_sc, tr_jpy, tr_j):
        _same_extras(tr_py.extras, tr.extras)
    assert tr_py.extras["kind_count"].sum() == 400


@pytest.mark.parametrize("engine,block_size,update", [
    ("python", 1, "jnp"),
    ("scan", 1, "jnp"),
    ("scan", 6, "jnp"),
    ("scan", 6, "pallas"),
])
def test_guard_rejects_divergent_updates(engine, block_size, update):
    """The spiking source against JAX's: the same rejects (> 0), finite
    weights within 1e-5, and without the guard the iterate is destroyed."""
    n = 6
    base = dict(n=n, C=3, T=300, eta=0.05, mu=np.linspace(0.5, 2.0, n), seed=7,
                engine=engine, block_size=block_size, update=update)
    t_cfg, j_cfg = _pair_cfgs(None, dict(max_grad_norm=100.0), **base)
    w, tr = run_generalized_async_sgd({"a": np.zeros(5, np.float32)}, _Spike(n), t_cfg)
    w_j, tr_j = j_run({"a": jnp.zeros(5, jnp.float32)}, _JSpike(n), j_cfg)
    assert np.isfinite(_leaves(w)).all()
    assert tr.extras["guard_rejects"] == tr_j.extras["guard_rejects"] > 0
    assert tr.extras["stale_drops"] == tr_j.extras["stale_drops"] == 0
    assert np.max(np.abs(_leaves(w) - _leaves(w_j))) < 1e-5
    w_open, _ = run_generalized_async_sgd({"a": np.zeros(5, np.float32)}, _Spike(n),
                                          replace(t_cfg, guard=None))
    assert not np.isfinite(_leaves(w_open)).all() or np.abs(_leaves(w_open)).max() > 1e4


def test_stale_cutoff_drops_old_updates():
    """A tiny cutoff under heavy churn drops completions (host-side, in the
    scales), the same number as JAX and the Python loop, and changes the
    result."""
    n = 6
    base = dict(n=n, C=3, T=500, eta=0.05, mu=np.linspace(0.2, 1.0, n), seed=3)
    t_cfg, j_cfg = _pair_cfgs(FAULT, dict(stale_cutoff=10), engine="scan", **base)
    w0 = {"a": np.zeros(5, np.float32)}
    w_g, tr_g = run_generalized_async_sgd(w0, _Quad(n), t_cfg)
    _, tr_j = j_run({"a": jnp.zeros(5, jnp.float32)}, _JQuad(n), j_cfg)
    assert tr_g.extras["stale_drops"] == tr_j.extras["stale_drops"] > 0
    w_u, _ = run_generalized_async_sgd(w0, _Quad(n), replace(t_cfg, guard=None))
    assert np.abs(_leaves(w_g) - _leaves(w_u)).max() > 0
    w_p, tr_p = run_generalized_async_sgd(w0, _Quad(n), replace(t_cfg, engine="python"))
    assert tr_p.extras["stale_drops"] == tr_g.extras["stale_drops"]
    assert np.max(np.abs(_leaves(w_p) - _leaves(w_g))) < 1e-5


def test_per_event_fault_stream_uses_the_trash_row():
    """Flip events carry slot C; the per-event ring then gains the trash row
    C, so they read and write row C and change nothing (JAX clamps and drops
    instead): the runner's weights equal JAX's on a stream full of them."""
    n, C_, T = 6, 3, 300
    stream = export_stream(SimConfig(mu=np.linspace(0.5, 2.0, n), p=np.full(n, 1 / n), C=C_,
                                     T=T, seed=4, fault=FaultConfig(**FAULT)))
    assert int((stream.slot == C_).sum()) > 50
    scale = step_scales(stream, 0.05, np.full(n, 1 / n), "importance")
    w, _ = engine_scan.jit_runner(_Quad(n).device_grad, C_)(
        {"a": torch.zeros(5)}, *engine_scan.stream_arrays(stream, "cpu"),
        torch.as_tensor(scale, dtype=torch.float32))
    from repro.core import jit_runner as j_jit_runner

    w_j, _ = j_jit_runner(_JQuad(n).device_grad, C_)(
        {"a": jnp.zeros(5, jnp.float32)}, jnp.asarray(stream.J), jnp.asarray(stream.slot),
        jnp.asarray(scale))
    assert np.max(np.abs(w["a"].numpy() - np.asarray(w_j["a"]))) < 1e-5


class _RingProbe:
    """A stand-in for the checkpoint hook (``run(..., ckpt=)``) that records
    the height of the ring the runner built and starts from it."""

    def start(self, carry):
        self.rows = int(carry[1].shape[0])
        return carry, [], 0

    def after(self, pos, carry, evals):
        pass

    def end(self, carry, evals):
        pass


@pytest.mark.parametrize("faulty", [False, True])
def test_per_event_ring_has_the_trash_row_only_for_slot_c_events(faulty):
    """A clean stream keeps the per-event ring at C rows (at full width a
    row is the whole parameter vector); a fault stream's flip and stage
    events (slot C) add the trash row C.  The cells runner sizes its ring
    by the same rule over all its streams."""
    n, C_, T = 6, 3, 200
    mk = lambda fault: export_stream(SimConfig(  # noqa: E731
        mu=np.linspace(0.5, 2.0, n), p=np.full(n, 1 / n), C=C_, T=T, seed=4,
        fault=FaultConfig(**FAULT) if fault else None))
    stream, clean = mk(faulty), mk(False)
    assert bool((stream.slot == C_).any()) == faulty
    scale = step_scales(stream, 0.05, np.full(n, 1 / n), "importance")
    probe = _RingProbe()
    engine_scan.make_runner(_Quad(n).device_grad, C_)(
        {"a": torch.zeros(5)}, *engine_scan.stream_arrays(stream, "cpu"),
        torch.as_tensor(scale, dtype=torch.float32), ckpt=probe)
    assert probe.rows == C_ + faulty
    cells = torch.as_tensor(np.stack([clean.slot, stream.slot]))
    assert engine_scan._ring_rows(C_, cells) == C_ + faulty


@pytest.mark.parametrize("max_norm", [0.0, 1e3])
def test_guard_verdict_on_rows_is_each_vectors(max_norm):
    """`_guard_bad` on (E, P) rows (the blocked guard) gives each row the
    verdict of its own (P,) vector (the per-event guard): non-finite always,
    over the cap only when the cap is on, a norm at the cap passes."""
    rows = torch.tensor([[1.0, 2.0], [3e3, 0.0], [float("nan"), 1.0], [float("inf"), 1.0],
                         [1e3, 0.0], [0.0, 0.0]])
    max_sq = max_norm ** 2
    got = engine_scan._guard_bad(rows, max_sq)
    assert torch.equal(got, torch.stack([engine_scan._guard_bad(r, max_sq) for r in rows]))
    assert got.tolist() == [False, max_norm > 0, True, True, False, False]


# ------------------------------------------------------------------ #
# the MLP: faults and the guard through both packages
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("block_size,update,guarded", [
    (1, "jnp", True),
    (1, "pallas", False),  # K1 per event runs under faults, without a guard
    (4, "jnp", True),
    (4, "pallas", True),   # K2 (its plain version here) under the guard
])
def test_mlp_fault_guard_replay_matches_jax(block_size, update, guarded):
    (_, _, j_setup), (_, _, setup) = _pair()
    flc = FLConfig(n_clients=N, concurrency=C, server_steps=300)
    mu = t_fl.make_client_speeds(N, flc.frac_fast, flc.speed_ratio, seed=0)
    p = t_fl.sampling_for(flc, mu)
    guard = dict(max_grad_norm=1e3, stale_cutoff=4 * C) if guarded else None
    t_cfg, j_cfg = _pair_cfgs(BENCH_FAULT, guard, n=N, C=C, T=300, eta=0.05, mu=mu, p=p,
                              eval_every=100, engine="scan", block_size=block_size,
                              update=update)
    w_t, tr_t = run_generalized_async_sgd(setup.params, setup.clients, t_cfg,
                                          eval_fn=setup.eval_fn)
    w_j, tr_j = j_run(j_setup.params, j_setup.clients, j_cfg, eval_fn=j_setup.eval_fn)
    assert _gap(w_t, w_j) <= 1e-5
    np.testing.assert_allclose(tr_t.eval_values, tr_j.eval_values, atol=2 / 2048)
    _same_extras(tr_t.extras, tr_j.extras)
    if guarded:
        assert tr_t.extras["guard_rejects"] == 0 and tr_t.extras["stale_drops"] > 0


def test_run_experiment_faults_match_jax():
    """`run_experiment` passes faults and the guard through: the extras and
    the final weights agree with the JAX package's entry point."""
    (j_data, j_task, _), (t_data, t_task, _) = _pair()
    kw = dict(n_clients=N, concurrency=C, server_steps=200, engine="scan")
    rj = j_fl.run_experiment(j_fl.FLConfig(**kw), "gen_async", eval_every=100, data=j_data,
                             task=j_task, faults=JFaultConfig(**BENCH_FAULT),
                             guard=JGuardConfig(1e3, 4 * C))
    rt = t_fl.run_experiment(FLConfig(device="cpu", **kw), "gen_async", eval_every=100,
                             data=t_data, task=t_task, faults=FaultConfig(**BENCH_FAULT),
                             guard=GuardConfig(1e3, 4 * C))
    assert _gap(rt.final_params, rj.final_params) <= 1e-5
    _same_extras(rt.extras, rj.extras)
    np.testing.assert_array_equal(rt.eval_times, rj.eval_times)


# ------------------------------------------------------------------ #
# compositions
# ------------------------------------------------------------------ #
def test_guard_needs_the_flat_update():
    """The guard needs flat mode: with K1 per event it raises the
    reference's ValueError; blocked K2 composes (above)."""
    cfg = ServerConfig(n=4, C=2, T=20, eta=0.1, engine="scan", update="pallas",
                       guard=GuardConfig(max_grad_norm=10.0), device="cpu")
    with pytest.raises(ValueError, match="flat-packed snapshot codec"):
        run_generalized_async_sgd({"a": np.zeros(3, np.float32)}, _Quad(4), cfg)


@pytest.mark.parametrize("block_size", [1, 6])
def test_fedbuff_guard_matches_jax(block_size):
    """FedBuff composes with the divergence guard (a bad gradient is zeroed
    before the buffer takes it): rejects and weights as in JAX."""
    n = 6
    t_cfg, j_cfg = _pair_cfgs(None, dict(max_grad_norm=100.0), n=n, C=3, T=300, eta=0.05,
                              mu=np.linspace(0.5, 2.0, n), seed=7, engine="scan",
                              block_size=block_size)
    w, tr = run_fedbuff({"a": np.zeros(5, np.float32)}, _Spike(n), t_cfg, Z=5)
    w_j, tr_j = j_run_fedbuff({"a": jnp.zeros(5, jnp.float32)}, _JSpike(n), j_cfg, Z=5)
    assert tr.extras["guard_rejects"] == tr_j.extras["guard_rejects"] > 0
    assert np.isfinite(_leaves(w)).all()
    assert np.max(np.abs(_leaves(w) - _leaves(w_j))) < 1e-5


@pytest.mark.parametrize("engine,kw", [
    ("scan", dict(faults=FaultConfig(**FAULT))),
    ("scan", dict(guard=GuardConfig(stale_cutoff=5))),
    ("python", dict(guard=GuardConfig(max_grad_norm=10.0))),
    ("python", dict(faults=FaultConfig(**FAULT))),
    ("python", dict(ckpt_dir="ckpt", ckpt_every=5)),
])
def test_fedbuff_rejects_faults_and_staleness(engine, kw):
    cfg = ServerConfig(n=4, C=2, T=20, eta=0.1, engine=engine, device="cpu", **kw)
    with pytest.raises(ValueError):
        run_fedbuff({"a": np.zeros(3, np.float32)}, _Quad(4), cfg, Z=5)


def test_guard_under_lanes_and_cells_raise():
    """A guard on lane-sharded replay sums its rejects over the ranks
    (`tests/test_torch_shards.py` runs it on 2 ranks): without a
    process group of those ranks it raises, and never runs unsharded.  The
    cell axis runs the guard with one counter a cell."""
    with pytest.raises(ValueError, match="process group"):
        engine_scan.jit_runner(_Quad(4).device_grad, 2, block_size=4, lane_devices=2,
                               guard=GuardConfig())
    with pytest.raises(ValueError, match="process group"):
        run_generalized_async_sgd({"a": np.zeros(3, np.float32)}, _Quad(4), ServerConfig(
            n=4, C=2, T=20, eta=0.1, engine="scan", block_size=4, devices=2,
            guard=GuardConfig(max_grad_norm=10.0), device="cpu"))
    run = engine_scan.jit_runner(_Quad(4).device_grad, 2, vmap_streams=True, guard=GuardConfig())
    z = torch.zeros((3, 8), dtype=torch.int64)
    w, _, gcnt = run({"a": torch.zeros(3)}, z, z % 2, torch.full((3, 8), 0.1))
    assert w["a"].shape == (3, 3) and gcnt.shape == (3, 2) and gcnt.dtype == torch.int32
    with pytest.raises(ValueError, match="ckpt_every > 0"):
        run_generalized_async_sgd({"a": np.zeros(3, np.float32)}, _Quad(4), ServerConfig(
            n=4, C=2, T=20, eta=0.1, engine="scan", ckpt_dir="ckpt", device="cpu"))


@pytest.mark.parametrize("case", [
    dict(g=[1.0, 2.0], scale=0.5, stale=3),                 # live, fresh, small
    dict(g=[1.0, 2.0], scale=0.5, stale=40),                # live and stale: dropped
    dict(g=[3e3, 0.0], scale=0.5, stale=3),                 # over the norm cap
    dict(g=[float("nan"), 1.0], scale=0.5, stale=None),     # non-finite, no staleness
    dict(g=[float("inf"), 1.0], scale=0.0, stale=3),        # a scale-0 fault event
    dict(g=[3e3, 1.0], scale=0.5, stale=40),                # stale first: not a reject
])
def test_flat_guard_matches_jax(case):
    """`_make_flat_guard`'s verdict, scale and counter against JAX's on one
    gradient, with and without the in-replay staleness (the argument the
    device stream will feed)."""
    from repro.core.engine_scan import _make_flat_guard as j_guard

    g = np.asarray(case["g"], np.float32)
    stale = case["stale"]
    check = engine_scan._make_flat_guard(GuardConfig(max_grad_norm=1e3, stale_cutoff=16))
    bad, scale, gcnt = check(torch.tensor(g), torch.tensor(case["scale"]),
                             torch.zeros(2, dtype=torch.int32),
                             None if stale is None else torch.tensor(stale))
    jbad, jscale, jgcnt = j_guard(JGuardConfig(max_grad_norm=1e3, stale_cutoff=16))(
        jnp.asarray(g), jnp.float32(case["scale"]), jnp.zeros((2,), jnp.int32),
        None if stale is None else jnp.int32(stale))
    assert bool(bad) == bool(jbad) and float(scale) == float(jscale)
    np.testing.assert_array_equal(gcnt.numpy(), np.asarray(jgcnt))
