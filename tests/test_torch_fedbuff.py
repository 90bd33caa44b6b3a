"""PyTorch port, FedBuff and the synchronous baselines against the JAX package.

`run_fedbuff` on the replay engine (per event, blocked, kernel path) against
the port's own Python loop and `repro.core.run_fedbuff` (the
`tests/test_engine.py` / `tests/test_block_engine.py` grids, <= 1e-5 on the
Quadratic); `run_fedavg` and `run_favano` against the reference (their
client choices and local step counts come from numpy's generator, so both
packages draw the same); the MLP `run_experiment` of each method against
the reference on shared weights and minibatches (<= 1e-4, identical eval
steps); and the bf16 buffer flush, which must round once as JAX does.
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import FLConfig as JFLConfig  # noqa: E402
from repro.core import ServerConfig as JServerConfig  # noqa: E402
from repro.core import async_sgd as j_sgd  # noqa: E402
from repro.data.pipeline import FederatedClassification as JData  # noqa: E402
from repro.fl import engine as j_fl  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.core import ServerConfig  # noqa: E402
from repro_torch.core import async_sgd as t_sgd  # noqa: E402
from repro_torch.core import engine_scan  # noqa: E402
from repro_torch.data.pipeline import FederatedClassification  # noqa: E402
from repro_torch.fl import engine as t_fl  # noqa: E402
from test_torch_engine import JQuadratic, Quadratic  # noqa: E402
from test_torch_fl import _gap, _pair  # noqa: E402

N, T = 8, 300


def _both(fn_name, cfg_kw, prob, w0=None, **kw):
    """Run one algorithm in the port and in the JAX package on the same
    Quadratic; returns (port weights, JAX weights, port trace, JAX trace)."""
    w0 = np.zeros(prob.d, np.float32) if w0 is None else w0
    jkw = {k: v for k, v in cfg_kw.items() if k != "device"}
    w_t, tr_t = getattr(t_sgd, fn_name)(w0, prob, ServerConfig(device="cpu", **cfg_kw), **kw)
    w_j, tr_j = getattr(j_sgd, fn_name)(jnp.asarray(w0), JQuadratic(prob.c), JServerConfig(**jkw),
                                        **kw)
    return w_t, np.asarray(w_j), tr_t, tr_j


@pytest.mark.parametrize("Z", [1, 5])
@pytest.mark.parametrize("C", [1, 4])
def test_fedbuff_scan_matches_python_and_jax(Z, C):
    prob = Quadratic(N)
    kw = dict(n=N, C=C, T=T, eta=0.05, seed=0, weighting="plain")
    w_py, _ = t_sgd.run_fedbuff(np.zeros(prob.d, np.float32), prob,
                                ServerConfig(device="cpu", **kw), Z=Z)
    w_sc, w_j, _, _ = _both("run_fedbuff", dict(kw, engine="scan"), prob, Z=Z)
    np.testing.assert_allclose(w_sc.numpy(), w_py.numpy(), atol=1e-5)
    np.testing.assert_allclose(w_sc.numpy(), w_j, atol=1e-5)
    # the port's Python loop against the reference's
    _, w_jpy, _, _ = _both("run_fedbuff", kw, prob, Z=Z)
    np.testing.assert_allclose(w_py.numpy(), w_jpy, atol=1e-5)


@pytest.mark.parametrize("Z", [1, 5])
@pytest.mark.parametrize("update", ["jnp", "pallas"])
def test_fedbuff_blocked_matches_per_event(Z, update):
    """E=6 (`tests/test_block_engine.py`), the plain path and the kernel
    path (K1 per leaf per event, K2 blocked; their plain versions here),
    against the per-event replay and the JAX package's blocked run."""
    prob = Quadratic(N)
    kw = dict(n=N, C=4, T=T, eta=0.05, seed=0, weighting="plain", engine="scan", update=update)
    w1, _, _, _ = _both("run_fedbuff", kw, prob, Z=Z)
    wb, wb_j, _, _ = _both("run_fedbuff", dict(kw, block_size=6), prob, Z=Z)
    np.testing.assert_allclose(wb.numpy(), w1.numpy(), atol=1e-5)
    np.testing.assert_allclose(wb.numpy(), wb_j, atol=1e-5)


def test_fedbuff_eval_curve_matches_jax():
    """Evaluation falls on the same steps per event and blocked, and sees the
    same iterates as the JAX engine."""
    prob = Quadratic(N)
    kw = dict(n=N, C=4, T=500, eta=0.05, seed=7, eval_every=100, engine="scan")
    for block_size in (1, 4):
        cfg_kw = dict(kw, block_size=block_size)
        _, tr_t = t_sgd.run_fedbuff(np.zeros(prob.d, np.float32), prob,
                                    ServerConfig(device="cpu", **cfg_kw), Z=5,
                                    eval_fn=lambda w: torch.sum(w ** 2))
        _, tr_j = j_sgd.run_fedbuff(jnp.zeros(prob.d, jnp.float32), JQuadratic(prob.c),
                                    JServerConfig(**cfg_kw), Z=5,
                                    eval_fn=lambda w: jnp.sum(w ** 2))
        assert tr_t.eval_steps == tr_j.eval_steps == [100, 200, 300, 400, 500]
        np.testing.assert_allclose(tr_t.eval_values, tr_j.eval_values, atol=1e-5)
        np.testing.assert_array_equal(tr_t.times, tr_j.times)


def test_fedbuff_block_deltas_match_jax():
    """`_fedbuff_block_deltas` on one block with flushes at lanes 1 and 4,
    a padded lane and a carried buffer, against the reference's."""
    from repro.core.engine_scan import _fedbuff_block_deltas as j_deltas

    rng = np.random.default_rng(3)
    E, P, Z = 6, 40, 3
    G = rng.normal(size=(E, P)).astype(np.float32)
    scm = rng.uniform(0.01, 0.1, E).astype(np.float32)
    k = np.array([4, 5, 6, 7, 8, 0], np.int64)
    m = np.array([True] * 5 + [False])
    G[~m] = 0.0
    scm[~m] = 0.0
    acc = rng.normal(size=P).astype(np.float32)
    D_t, acc_t = engine_scan._fedbuff_block_deltas(
        torch.tensor(G), torch.tensor(scm), torch.tensor(k), torch.tensor(m), torch.tensor(acc), Z)
    D_j, acc_j = j_deltas(jnp.asarray(G), jnp.asarray(scm), jnp.asarray(k), jnp.asarray(m),
                          jnp.asarray(acc), Z)
    np.testing.assert_allclose(D_t.numpy(), np.asarray(D_j), atol=1e-6)
    np.testing.assert_allclose(acc_t.numpy(), np.asarray(acc_j), atol=1e-6)
    assert np.count_nonzero(np.abs(D_t.numpy()).sum(1)) == 2  # flushes at k+1 = 6 and 9


@pytest.mark.parametrize("local_steps", [1, 2])
def test_fedavg_matches_jax(local_steps):
    prob = Quadratic(N)
    mu = np.linspace(0.5, 3.0, N)
    w_t, w_j, tr_t, tr_j = _both(
        "run_fedavg", dict(n=N, C=4, T=40, eta=0.1, mu=mu, seed=2, eval_every=10), prob,
        clients_per_round=3, local_steps=local_steps)
    np.testing.assert_allclose(w_t.numpy(), w_j, atol=1e-5)
    np.testing.assert_array_equal(tr_t.times, tr_j.times)


@pytest.mark.parametrize("max_local_steps", [2, 8])
def test_favano_matches_jax(max_local_steps):
    prob = Quadratic(N)
    mu = np.linspace(0.5, 3.0, N)
    w_t, w_j, tr_t, tr_j = _both(
        "run_favano", dict(n=N, C=4, T=30, eta=0.05, mu=mu, seed=4), prob,
        period=1.0 / float(np.median(mu)), max_local_steps=max_local_steps)
    np.testing.assert_allclose(w_t.numpy(), w_j, atol=1e-5)
    np.testing.assert_array_equal(tr_t.times, tr_j.times)


@pytest.mark.parametrize("Z", [3, 5])
def test_bf16_fedbuff_flush_rounds_once_like_jax(Z):
    """A bf16 parameter vector: the buffer flush ``w - (scale/Z) * acc``
    promotes to fp32 and rounds once, as `repro.core.engine_scan.
    _make_apply_event` does; torch alone (bf16 times a 0-d fp32 tensor stays
    bf16) would round twice.  Bitwise, event by event, against the JAX step
    run op by op (a jitted JAX scan may keep excess fp32 precision between
    bf16 ops, which XLA allows by default)."""
    from repro.core.engine_scan import _make_apply_event

    rng = np.random.default_rng(Z)
    P, C, steps = 3000, 4, 4 * Z
    w0 = rng.normal(size=P).astype(np.float32)
    gs = rng.normal(size=(steps, P)).astype(np.float32)
    slots = rng.integers(0, C, steps)
    scale = np.float32(0.0371)

    jw = jnp.asarray(w0, jnp.bfloat16)
    jcarry = (jw, jnp.broadcast_to(jw, (C, P)), jnp.zeros_like(jw), jnp.zeros((2,), jnp.int32))
    j_apply = _make_apply_event(Z, lambda x: x)

    tw = torch.tensor(w0).to(torch.bfloat16)
    pack = unpack = lambda x: x  # noqa: E731
    grads = [torch.tensor(g).to(torch.bfloat16) for g in gs]
    step = engine_scan._make_update_step(lambda j, w, k: grads[int(k)], None, pack, unpack,
                                         True, lambda x: x, Z)
    tcarry = (tw, tw[None].expand(C, P).clone(), torch.zeros_like(tw),
              torch.zeros(2, dtype=torch.int32))
    for k in range(steps):
        jcarry = j_apply(jcarry, jnp.asarray(gs[k], jnp.bfloat16), int(slots[k]),
                         jnp.asarray(scale), jnp.int32(k))
        tcarry = step(tcarry, torch.tensor(0), torch.tensor(int(slots[k])),
                      torch.tensor(scale), torch.tensor(k))
        assert tcarry[0].dtype == torch.bfloat16
        np.testing.assert_array_equal(tcarry[0].float().numpy(),
                                      np.asarray(jcarry[0].astype(jnp.float32)))
        np.testing.assert_array_equal(tcarry[2].float().numpy(),
                                      np.asarray(jcarry[2].astype(jnp.float32)))
    np.testing.assert_array_equal(tcarry[1].float().numpy(), np.asarray(jcarry[1].astype(jnp.float32)))
    # the test can see the fault it guards: bf16 math would round differently
    acc, eff = tcarry[2] + grads[0], torch.tensor(scale / Z)
    assert not torch.equal(tw - eff * acc, engine_scan._flat_axpy(tw, acc, eff))


class _JaxInitMLP(t_fl.MLPClassifier):
    """The port's MLP with the JAX package's initial weights (`jax.random`
    draws them there), so the per-event Python baselines of both packages
    start from the same point."""

    def __init__(self, dim, num_classes, hidden=128, seed=0, device="cuda"):
        super().__init__(dim, num_classes, hidden=hidden, seed=seed, device=device)
        jm = j_fl.MLPClassifier(dim, num_classes, hidden=hidden, seed=seed)
        self.init_params = t_fl.params_from_numpy(
            {k: np.asarray(v) for k, v in jm.init_params.items()}, device)


@pytest.mark.parametrize("method", ["fedbuff", "fedavg", "favano"])
def test_run_experiment_host_loop_matches_jax(method, monkeypatch):
    """The MLP through `run_experiment` on the Python engine: streaming host
    minibatches (numpy, the same in both packages) and the JAX package's
    initial weights."""
    monkeypatch.setattr(t_fl, "MLPClassifier", _JaxInitMLP)
    n, T = 16, dict(fedbuff=60, fedavg=6, favano=3)[method]
    every = dict(fedbuff=20, fedavg=2, favano=1)[method]
    kw = dict(n_clients=n, concurrency=4, server_steps=T, fedbuff_Z=5)
    rj = j_fl.run_experiment(JFLConfig(**kw), method, eval_every=every,
                             data=JData(n_clients=n, seed=0))
    rt = t_fl.run_experiment(FLConfig(device="cpu", **kw), method, eval_every=every,
                             data=FederatedClassification(n_clients=n, seed=0))
    assert rt.extras["engine"] == rj.extras["engine"] == "python"
    assert rt.extras["grad_calls"] == rj.extras["grad_calls"]
    assert _gap(rt.final_params, rj.final_params) <= 1e-4
    np.testing.assert_array_equal(rt.eval_steps, rj.eval_steps)
    assert len(rt.eval_steps) == T // every
    np.testing.assert_allclose(rt.eval_acc, rj.eval_acc, atol=2 / 2048)
    np.testing.assert_array_equal(rt.eval_times, rj.eval_times)


@pytest.mark.parametrize("block_size", [1, 4])
def test_run_experiment_fedbuff_scan_matches_jax(block_size):
    """FedBuff on the replay engine through `run_experiment`, on the shared
    weights and minibatch offsets of `test_torch_fl._pair`."""
    (j_data, j_task, _), (t_data, t_task, _) = _pair()
    kw = dict(n_clients=16, concurrency=4, server_steps=300, engine="scan",
              block_size=block_size, fedbuff_Z=5)
    rj = j_fl.run_experiment(JFLConfig(**kw), "fedbuff", eval_every=100, data=j_data, task=j_task)
    rt = t_fl.run_experiment(FLConfig(device="cpu", **kw), "fedbuff", eval_every=100,
                             data=t_data, task=t_task)
    assert rt.extras["engine"] == "scan"
    assert _gap(rt.final_params, rj.final_params) <= 1e-4
    np.testing.assert_array_equal(rt.eval_steps, rj.eval_steps)
    np.testing.assert_allclose(rt.eval_acc, rj.eval_acc, atol=2 / 2048)


def test_fedbuff_scan_matches_python_on_mlp():
    """The replay engine's FedBuff against the port's Python loop on the same
    device gradient source (identical minibatches), per event and blocked."""
    _, (_, _, setup) = _pair()
    cfg = ServerConfig(n=16, C=4, T=120, eta=0.05, seed=0, device="cpu")
    w_py, _ = t_sgd.run_fedbuff(setup.params, setup.clients, cfg, Z=5)
    for kw in (dict(engine="scan"), dict(engine="scan", block_size=4, update="pallas")):
        w_sc, _ = t_sgd.run_fedbuff(setup.params, setup.clients, replace(cfg, **kw), Z=5)
        assert max(float((w_py[k] - w_sc[k]).abs().max()) for k in w_py) <= 1e-5
