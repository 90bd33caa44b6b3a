"""PyTorch port, lanes and scenario shards for every runner, on gloo CPU ranks.

ONE subprocess starts the ranks (`repro_torch.launch.lanes.run_lanes`), a
group of 2, then of 3, then of 4, and each runs all of its cases; every
case is held against the JAX package's UNSHARDED run on the same inputs —
the reference's own sharded == unsharded contract
(`tests/test_sharded_block.py`): the Quadratic within 1e-5, the MLP within
1e-4 (its accuracies within 2/2048), counters exact, and the ranks bitwise
equal to each other.  The cases:

  (i)   the guard under lanes, its rejects summed over the ranks in the
        block's one all-gather: the host stream (gen_async with the
        staleness cutoff, FedBuff) and the fused device stream (with the
        cutoff on the stream's own delays);
  (ii)  the fused runner's lanes at C in {1, 4}, E=4, D=2 (gen_async and
        FedBuff) on the reference's draws, the MLP too, and
        `run_experiment(FLConfig(stream="device", devices=2))` against the
        port's unsharded run of the same seed (the port's own generator);
  (iii) `jit_runner(vmap_streams=True, lane_devices=2)`: 4 cells × 2 lane
        ranks, plain, K6's path (``kernel="pallas"``, its plain version on
        the CPU), FedBuff and the guard;
  (iv)  the fused cell axis as a ``shard × lane`` layout: 1×2 and 2×2 (flat
        (B, ...) inputs, plain, guarded, FedBuff) and ``shard_devices=2``
        alone (a leading (2, B/2));
  (v)   `run_matrix(devices=2)` on the host stream (against JAX's
        `run_matrix`) and on the device stream in a group of 2 (1 × 2) and
        of 4 (2 × 2), and the lane-free shards (a group of 2, devices=1),
        against the port's unsharded device matrix (the port's generator);
  (vi)  a world larger than the layout, 3 ranks: the fused cell axis at
        1 × 2 and 2 × 1 against JAX's vmap on the reference's draws, and
        `run_matrix(stream="device", devices=2)` over 4 cells against the
        port's unsharded device matrix; rank 2 takes no part and returns
        rank 0's grid, bitwise.  And `jit_fused_runner(shard_devices=2)`
        without the cell axis is the unsharded runner, as the reference's
        ignores ``shard_devices`` there.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import FLConfig as JFLConfig  # noqa: E402
from repro.core import ServerConfig as JServerConfig  # noqa: E402
from repro.core import engine_scan as jes  # noqa: E402
from repro.core import run_fedbuff as j_run_fedbuff  # noqa: E402
from repro.core import run_generalized_async_sgd as j_run  # noqa: E402
from repro.core.engine_scan import GuardConfig as JGuardConfig  # noqa: E402
from repro.data.pipeline import FederatedClassification as JData  # noqa: E402
from repro.fl import engine as j_fl  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.fl import engine as t_fl  # noqa: E402
from test_stream_device import _nonuniform_p  # noqa: E402
from test_torch_cells_guard import JSpiky, _host_arrays  # noqa: E402
from test_torch_stream import _ref_draws  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
N, C, T, E, B, ETA = 8, 4, 300, 4, 4, 0.05
MLP_N, MLP_C, MLP_T, MLP_E, MLP_EVAL = 16, 4, 160, 8, 80
MATRIX = dict(seeds=(0, 1), policies=("uniform", "optimal"), eval_every=100)
MATRIX_FLC = dict(n_clients=MLP_N, concurrency=MLP_C, server_steps=200)

_RANKS_SCRIPT = textwrap.dedent(
    """
    import sys
    import numpy as np
    import torch

    from repro_torch.configs.base import FLConfig
    from repro_torch.core import ServerConfig, run_fedbuff, run_generalized_async_sgd
    from repro_torch.core.engine_scan import (GuardConfig, jit_fused_runner, jit_runner,
                                              make_fused_runner)
    from repro_torch.data.pipeline import FederatedClassification
    from repro_torch.fl import engine as fl
    from repro_torch.launch.lanes import run_lanes

    N, C, T, E, B, ETA = 8, 4, 300, 4, 4, 0.05
    MLP_N, MLP_C, MLP_T, MLP_E, MLP_EVAL = 16, 4, 160, 8, 80
    MATRIX = dict(seeds=(0, 1), policies=("uniform", "optimal"), eval_every=100)
    MATRIX_FLC = dict(n_clients=MLP_N, concurrency=MLP_C, server_steps=200, device="cpu")

    class Spiky:
        def __init__(self, c, spikes=True):
            self.c_t, self.spikes = torch.tensor(c), spikes
        def device_grad(self, j, w, k):
            g = w - self.c_t.index_select(0, j.reshape(1))[0]
            if not self.spikes:
                return g
            g = torch.where(((k % 7) == 6) & ((j % 2) == 1), g + 1e6, g)
            return torch.where(k == 40, torch.full_like(g, float("nan")), g)

    def guard(cut=0):
        return GuardConfig(max_grad_norm=100.0, stale_cutoff=cut)

    def draws(inputs, pre):
        return [torch.as_tensor(inputs[f"{pre}/{k}"]) for k in ("nodes", "ur", "ue", "ud")]

    def mlp(inputs):
        task = fl.ClassificationTask(hidden=32)
        data = FederatedClassification(n_clients=MLP_N, seed=0)
        model = fl.MLPClassifier(data.dim, data.num_classes, hidden=32, device="cpu")
        params = {k[len("w0/"):]: inputs[k] for k in inputs if k.startswith("w0/")}
        setup = fl.TaskSetup(
            params=fl.params_from_numpy(params, "cpu"),
            clients=fl.DeviceFLClients(data, model, starts=inputs["starts"], device="cpu"),
            eval_fn=fl._accuracy_fn(model, data, device="cpu"), model=model)
        data.__dict__.setdefault("_fl_setup_cache", {})[(0, task.cache_key())] = setup
        return data, task, setup

    def put(out, pre, w, extras=None, **more):
        out[f"{pre}/w"] = np.concatenate([v.numpy().ravel() for k, v in sorted(w.items())]) \\
            if isinstance(w, dict) else w.numpy()
        for k in ("guard_rejects", "stale_drops"):
            if extras is not None and k in extras:
                out[f"{pre}/{k}"] = np.asarray(extras[k])
        for k, v in more.items():
            out[f"{pre}/{k}"] = np.asarray(v)

    def matrix(out, pre, data, task, **kw):
        m = fl.run_matrix(FLConfig(**MATRIX_FLC), data=data, task=task, **MATRIX, **kw)
        put(out, pre, torch.as_tensor(m.final_acc), acc=m.eval_acc, times=m.eval_times,
            **{k: v for k, v in m.extras.items() if k != "stream"})

    def cells_fused(out, inputs, layouts):
        c, mus, ps = inputs["c"], inputs["mus"], inputs["ps"]
        cd = draws(inputs, "cells")
        for name, shard, lane, kw, spikes in layouts:
            run = jit_fused_runner(Spiky(c, spikes).device_grad, N, C, T, vmap_scenarios=True,
                                   shard_devices=shard, lane_devices=lane, block_size=E, **kw)
            args = [mus, ps, *cd]
            if lane == 1:  # the lane-free shards: a leading (shard, B / shard)
                args = [a.reshape(shard, B // shard, *a.shape[1:]) for a in args]
            w, _, x = run.from_draws(torch.zeros(4), args[0], args[1], ETA, *args[2:])
            if lane == 1:
                w = w.reshape(B, -1)
                x = {k: v.reshape(B, *v.shape[2:]) for k, v in x.items()}
            put(out, f"cells_fused/{name}", w, x)

    def rank2(rank, world, inputs):
        torch.set_num_threads(1)
        out = {}
        c, mu, p = inputs["c"], inputs["mus"][0], inputs["ps"][0]
        # (i) the guard under lanes: host stream, gen_async and FedBuff, then fused
        base = dict(n=N, C=C, T=T, eta=ETA, mu=mu, p=p, seed=7, engine="scan", block_size=E,
                    devices=world, device="cpu")
        w, tr = run_generalized_async_sgd(torch.zeros(4), Spiky(c),
                                          ServerConfig(guard=guard(6), **base))
        put(out, "guard_host", w, tr.extras)
        w, tr = run_fedbuff(torch.zeros(4), Spiky(c), ServerConfig(guard=guard(), **base), Z=5)
        put(out, "guard_host_fedbuff", w, tr.extras)
        w, _, x = make_fused_runner(Spiky(c).device_grad, N, C, T, block_size=E,
                                    lane_devices=world, guard=guard(3)).from_draws(
            torch.zeros(4), mu, p, ETA, *draws(inputs, "dC4"))
        put(out, "guard_fused", w, x)
        # (ii) fused lanes, C in {1, 4}, gen_async and FedBuff; the MLP
        for C_ in (1, 4):
            for Z in (0, 5):
                w, _, _ = make_fused_runner(
                    Spiky(c, False).device_grad, N, C_, T, block_size=E, lane_devices=world,
                    fedbuff_Z=Z, weighting="plain" if Z else "importance").from_draws(
                    torch.zeros(4), mu, p, ETA, *draws(inputs, f"dC{C_}"))
                put(out, f"fused_C{C_}_Z{Z}", w)
        data, task, setup = mlp(inputs)
        w, ev, _ = make_fused_runner(setup.clients.device_grad, MLP_N, MLP_C, MLP_T,
                                     block_size=MLP_E, lane_devices=world, eval_fn=setup.eval_fn,
                                     eval_every=MLP_EVAL).from_draws(
            setup.params, inputs["mlp_mu"], inputs["mlp_p"], ETA, *draws(inputs, "mlp"))
        put(out, "fused_mlp", w, acc=ev)
        flc = FLConfig(n_clients=MLP_N, concurrency=MLP_C, server_steps=MLP_T, engine="scan",
                       stream="device", block_size=MLP_E, devices=world, device="cpu")
        r = fl.run_experiment(flc, "gen_async", eval_every=MLP_EVAL, data=data, task=task)
        put(out, "run_experiment_device", r.final_params, acc=r.eval_acc)
        if rank == 0:  # the port's unsharded run of the same seed
            r = fl.run_experiment(flc.replace(devices=1), "gen_async", eval_every=MLP_EVAL,
                                  data=data, task=task)
            put(out, "run_experiment_device_unsharded", r.final_params, acc=r.eval_acc)
        # (iii) the host cell axis x lanes
        arrs = [torch.as_tensor(inputs[f"hb/{k}"]) for k in ("J", "slot", "sc", "kb", "mask")]
        for i in (0, 1, 3):
            arrs[i] = arrs[i].long()
        G, nc = int(inputs["hb/G"]), int(inputs["hb/nc"])
        for name, kw, spikes in (("plain", {}, False), ("pallas", dict(kernel="pallas"), False),
                                 ("fedbuff", dict(fedbuff_Z=5), False),
                                 ("guard", dict(guard=guard()), True)):
            res = jit_runner(Spiky(c, spikes).device_grad, C, block_size=E, vmap_streams=True,
                             lane_devices=world, **kw)(torch.zeros(4), *arrs, chunk_blocks=G,
                                                       n_chunks=nc)
            put(out, f"cells_host/{name}", res[0], gcnt=res[2] if len(res) > 2 else 0)
        # (iv) the fused cell axis: 1 x 2 and the lane-free shards
        cells_fused(out, inputs, [("1x2", 1, 2, {}, False), ("1x2_guard", 1, 2, dict(guard=guard(3)), True),
                                  ("2x1", 2, 1, {}, False)])
        # (v) run_matrix with lanes, host stream (plain and K6's path) and device stream
        for kernel in ("jnp", "pallas"):
            matrix(out, f"matrix_host_{kernel}", data, task, block_size=E, devices=world,
                   kernel=kernel)
        matrix(out, "matrix_device_1x2", data, task, stream="device", block_size=E, devices=world)
        matrix(out, "matrix_device_2x1", data, task, stream="device", block_size=1, devices=1)
        return out

    def rank3(rank, world, inputs):
        # a world larger than the layout: ranks 0 .. S*L-1 run it, the rest
        # take no part and receive the grid from rank 0
        torch.set_num_threads(1)
        out = {}
        cells_fused(out, inputs, [("1x2", 1, 2, {}, False), ("2x1", 2, 1, {}, False)])
        data, task, _ = mlp(inputs)
        matrix(out, "matrix_device_1x2", data, task, stream="device", block_size=E, devices=2)
        return out

    def rank4(rank, world, inputs):
        torch.set_num_threads(1)
        out = {}
        cells_fused(out, inputs, [("2x2", 2, 2, {}, False), ("2x2_guard", 2, 2, dict(guard=guard(3)), True),
                                  ("2x2_fedbuff", 2, 2, dict(fedbuff_Z=5, weighting="plain"), False)])
        data, task, _ = mlp(inputs)
        matrix(out, "matrix_device_2x2", data, task, stream="device", block_size=E, devices=2)
        return out

    if __name__ == "__main__":
        inputs_path, out_path = sys.argv[1], sys.argv[2]
        inputs = np.load(inputs_path)
        res = {}
        for world, fn in ((2, rank2), (3, rank3), (4, rank4)):
            for r, d in enumerate(run_lanes(fn, world, (dict(inputs),), timeout=420.0)):
                res.update({f"w{world}/r{r}/{k}": np.asarray(v) for k, v in d.items()})
        np.savez(out_path, **res)
    """
)


def _key_draws(key, n, C_, T_, p, prefix):
    nodes, ur, ue, ud, _ = _ref_draws(key, n, C_, T_, p)
    return {f"{prefix}/nodes": nodes, f"{prefix}/ur": ur, f"{prefix}/ue": ue,
            f"{prefix}/ud": ud}


def _inputs():
    """The ranks' inputs: the Quadratic's centres, B cells' speeds and
    sampling vectors, the reference's draws (one run at C = 1 and 4, the
    MLP, B cells), the host cells' blocked arrays, the JAX MLP's weights
    and window offsets."""
    c = np.random.default_rng(0).normal(size=(N, 4)).astype(np.float32)
    mus = np.stack([np.random.default_rng(b).uniform(0.5, 4.0, N) for b in range(B)])
    ps = np.stack([_nonuniform_p(N, seed=b + 1) for b in range(B)])
    mlp_mu = np.random.default_rng(3).uniform(0.5, 4.0, MLP_N)
    mlp_p = _nonuniform_p(MLP_N, seed=4)
    inputs = dict(c=c, mus=mus, ps=ps, mlp_mu=mlp_mu, mlp_p=mlp_p)
    for C_ in (1, 4):
        inputs.update(_key_draws(jax.random.PRNGKey(5), N, C_, T, ps[0], f"dC{C_}"))
    inputs.update(_key_draws(jax.random.PRNGKey(6), MLP_N, MLP_C, MLP_T, mlp_p, "mlp"))
    cells = [_key_draws(jax.random.PRNGKey(20 + b), N, C, T, ps[b], "cells") for b in range(B)]
    inputs.update({k: np.stack([d[k] for d in cells]) for k in cells[0]})
    J, slot, sc, kb, mask, G, nc = _host_arrays(E)
    inputs.update({"hb/J": J, "hb/slot": slot, "hb/sc": sc, "hb/kb": kb, "hb/mask": mask,
                   "hb/G": G, "hb/nc": nc})
    j_setup = j_fl._cached_fl_setup(JData(n_clients=MLP_N, seed=0), 0,
                                    j_fl.ClassificationTask(hidden=32))
    inputs["starts"] = np.asarray(j_setup.clients._starts)
    inputs.update({f"w0/{k}": np.asarray(v) for k, v in j_setup.params.items()})
    return inputs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the ranks once (2, then 4), every case of this file in them."""
    tmp = tmp_path_factory.mktemp("shards")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    (tmp / "ranks.py").write_text(_RANKS_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, str(tmp / "ranks.py"), str(tmp / "inputs.npz"),
                          str(tmp / "out.npz")],
                         capture_output=True, text=True, timeout=900, env=env, cwd=tmp)
    assert res.returncode == 0, res.stderr[-6000:]
    out = np.load(tmp / "out.npz")
    return {k: out[k] for k in out.files}, inputs


def _get(out, world, name):
    """A case's outputs, after checking that every rank holds them bitwise."""
    pre = f"w{world}/r0/{name}/"
    keys = [k[len(pre):] for k in out if k.startswith(pre)]
    assert keys, name
    for r in range(1, world):
        for k in keys:
            np.testing.assert_array_equal(out[f"w{world}/r{r}/{name}/{k}"], out[pre + k],
                                          err_msg=f"rank {r} of {world}, {name}/{k}")
    return {k: out[pre + k] for k in keys}


def _flat(w):
    return np.concatenate([np.asarray(v).ravel() for k, v in sorted(w.items())])


def _jspiky(c, spikes=True):
    return JSpiky(c, spikes)


# ---------------------------------------------------------------------------
# (i) the guard under lanes
# ---------------------------------------------------------------------------
def test_guard_under_lanes_host_matches_jax_unsharded(ranks):
    out, inp = ranks
    base = dict(n=N, C=C, T=T, eta=ETA, mu=inp["mus"][0], p=inp["ps"][0], seed=7,
                engine="scan", block_size=E)
    for name, fn, kw in (("guard_host", j_run, dict(guard=JGuardConfig(100.0, 6))),
                         ("guard_host_fedbuff", j_run_fedbuff, dict(guard=JGuardConfig(100.0)))):
        got = _get(out, 2, name)
        extra = dict(Z=5) if fn is j_run_fedbuff else {}
        wj, trj = fn(jnp.zeros(4), _jspiky(inp["c"]), JServerConfig(**base, **kw), **extra)
        np.testing.assert_allclose(got["w"], np.asarray(wj), atol=1e-5)
        assert int(got["guard_rejects"]) == int(trj.extras["guard_rejects"]) > 0
        assert int(got["stale_drops"]) == int(trj.extras["stale_drops"])
    assert int(_get(out, 2, "guard_host")["stale_drops"]) > 0


def test_guard_under_lanes_fused_matches_jax_unsharded(ranks):
    out, inp = ranks
    got = _get(out, 2, "guard_fused")
    jr = jes.make_fused_runner(_jspiky(inp["c"]).device_grad, N, C, T, block_size=E,
                               guard=JGuardConfig(100.0, 3))
    wj, _, xj = jax.jit(jr)(jnp.zeros(4), jnp.asarray(inp["mus"][0]), jnp.asarray(inp["ps"][0]),
                            jax.random.PRNGKey(5), ETA)
    np.testing.assert_allclose(got["w"], np.asarray(wj), atol=1e-5)
    for k in ("guard_rejects", "stale_drops"):
        assert int(got[k]) == int(xj[k]) > 0


# ---------------------------------------------------------------------------
# (ii) lanes on the fused device stream
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("C_", [1, 4])
@pytest.mark.parametrize("Z", [0, 5])
def test_fused_lanes_match_jax_unsharded(ranks, C_, Z):
    out, inp = ranks
    got = _get(out, 2, f"fused_C{C_}_Z{Z}")
    jr = jes.make_fused_runner(_jspiky(inp["c"], False).device_grad, N, C_, T, block_size=E,
                               fedbuff_Z=Z, weighting="plain" if Z else "importance")
    wj, _, _ = jax.jit(jr)(jnp.zeros(4), jnp.asarray(inp["mus"][0]), jnp.asarray(inp["ps"][0]),
                           jax.random.PRNGKey(5), ETA)
    np.testing.assert_allclose(got["w"], np.asarray(wj), atol=1e-5)


def test_fused_lanes_mlp_matches_jax_unsharded(ranks):
    out, inp = ranks
    got = _get(out, 2, "fused_mlp")
    j_setup = j_fl._cached_fl_setup(JData(n_clients=MLP_N, seed=0), 0,
                                    j_fl.ClassificationTask(hidden=32))
    jr = jes.make_fused_runner(j_setup.clients.device_grad, MLP_N, MLP_C, MLP_T,
                               block_size=MLP_E, eval_fn=j_setup.eval_fn, eval_every=MLP_EVAL)
    wj, ej, _ = jax.jit(jr)(j_setup.params, jnp.asarray(inp["mlp_mu"]),
                            jnp.asarray(inp["mlp_p"]), jax.random.PRNGKey(6), ETA)
    np.testing.assert_allclose(got["w"], _flat(wj), atol=1e-4)
    np.testing.assert_allclose(got["acc"], np.asarray(ej), atol=2 / 2048)


def test_run_experiment_device_stream_lanes(ranks):
    """`run_experiment(FLConfig(stream="device", block_size=8, devices=2))`
    against the port's unsharded run of the same seed (the port's own
    generator draws the same stream in every rank)."""
    out, _ = ranks
    got = _get(out, 2, "run_experiment_device")
    ref = {k[len("w2/r0/run_experiment_device_unsharded/"):]: v for k, v in out.items()
           if k.startswith("w2/r0/run_experiment_device_unsharded/")}
    np.testing.assert_allclose(got["w"], ref["w"], atol=1e-4)
    np.testing.assert_allclose(got["acc"], ref["acc"], atol=2 / 2048)
    assert got["acc"].shape == (MLP_T // MLP_EVAL,) and np.isfinite(got["w"]).all()


# ---------------------------------------------------------------------------
# (iii) the host cell axis x lanes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["plain", "pallas", "fedbuff", "guard"])
def test_cells_x_lanes_host_matches_jax_vmap(ranks, name):
    out, inp = ranks
    got = _get(out, 2, f"cells_host/{name}")
    kw = dict(plain={}, pallas=dict(kernel="pallas", interpret=True), fedbuff=dict(fedbuff_Z=5),
              guard=dict(guard=JGuardConfig(100.0)))[name]
    J, slot, sc, kb, mask, G, nc = _host_arrays(E)
    jr = jes.jit_runner(_jspiky(inp["c"], name == "guard").device_grad, C, block_size=E,
                        vmap_streams=True, **kw)
    res = jr(jnp.zeros(4), *map(jnp.asarray, (J, slot, sc, kb, mask)), chunk_blocks=G,
             n_chunks=nc)
    assert got["w"].shape == (B, 4)
    np.testing.assert_allclose(got["w"], np.asarray(res[0]), atol=1e-5)
    if name == "guard":
        np.testing.assert_array_equal(got["gcnt"], np.asarray(res[2]))
        assert got["gcnt"][:, 0].min() > 0


# ---------------------------------------------------------------------------
# (iv) the fused cell axis as a shard x lane layout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world,name", [(2, "1x2"), (2, "1x2_guard"), (2, "2x1"), (4, "2x2"),
                                        (4, "2x2_guard"), (4, "2x2_fedbuff"), (3, "1x2"),
                                        (3, "2x1")])
def test_fused_shards_match_jax_vmap(ranks, world, name):
    out, inp = ranks
    got = _get(out, world, f"cells_fused/{name}")
    guarded, fedbuff = name.endswith("guard"), name.endswith("fedbuff")
    kw = (dict(guard=JGuardConfig(100.0, 3)) if guarded
          else dict(fedbuff_Z=5, weighting="plain") if fedbuff else {})
    jr = jes.make_fused_runner(_jspiky(inp["c"], guarded).device_grad, N, C, T, block_size=E,
                               **kw)
    keys = jnp.stack([jax.random.PRNGKey(20 + b) for b in range(B)])
    wj, _, xj = jax.jit(jax.vmap(jr, in_axes=(None, 0, 0, 0, None)))(
        jnp.zeros(4), jnp.asarray(inp["mus"]), jnp.asarray(inp["ps"]), keys, ETA)
    assert got["w"].shape == (B, 4)
    np.testing.assert_allclose(got["w"], np.asarray(wj), atol=1e-5)
    if guarded:
        for k in ("guard_rejects", "stale_drops"):
            np.testing.assert_array_equal(got[k], np.asarray(xj[k]))
        assert got["guard_rejects"].min() > 0


# ---------------------------------------------------------------------------
# (v) run_matrix(devices=2)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel", ["jnp", "pallas"])
def test_run_matrix_host_lanes_match_jax(ranks, kernel):
    out, _ = ranks
    got = _get(out, 2, f"matrix_host_{kernel}")
    m = j_fl.run_matrix(JFLConfig(block_size=E, **MATRIX_FLC), data=JData(n_clients=MLP_N, seed=0),
                        task=j_fl.ClassificationTask(hidden=32), **MATRIX)
    np.testing.assert_allclose(got["acc"], m.eval_acc, atol=2 / 2048)
    np.testing.assert_allclose(got["w"], m.final_acc, atol=2 / 2048)
    np.testing.assert_array_equal(got["times"], m.eval_times)


@pytest.fixture(scope="module")
def device_matrices():
    """The port's unsharded device-stream matrices, per event and E=4."""
    from test_torch_fl import _pair

    _, (t_data, t_task, _) = _pair()
    return {E_: t_fl.run_matrix(FLConfig(device="cpu", **MATRIX_FLC), data=t_data, task=t_task,
                                stream="device", block_size=E_, **MATRIX) for E_ in (1, E)}


@pytest.mark.parametrize("world,name,E_", [(2, "1x2", E), (4, "2x2", E), (2, "2x1", 1),
                                           (3, "1x2", E)])
def test_run_matrix_device_shards_match_unsharded(ranks, device_matrices, world, name, E_):
    out, _ = ranks
    got = _get(out, world, f"matrix_device_{name}")
    m = device_matrices[E_]
    np.testing.assert_allclose(got["acc"], m.eval_acc, atol=2 / 2048)
    np.testing.assert_allclose(got["w"], m.final_acc, atol=2 / 2048)
    np.testing.assert_array_equal(got["times"], m.eval_times)
    for k in ("p_final", "mean_delays", "comp", "occ_mean"):
        np.testing.assert_array_equal(got[k], m.extras[k])


# ---------------------------------------------------------------------------
# (vi) shard_devices without the cell axis
# ---------------------------------------------------------------------------
def test_shard_devices_without_cells_is_the_unsharded_runner():
    """`jit_fused_runner(shard_devices=2)` without ``vmap_scenarios`` runs
    the unsharded runner, as the reference's jits it and drops
    ``shard_devices``: the same memoized runner, bitwise the same run as a
    fresh unsharded one on the reference's draws; no process group needed."""
    from repro_torch.core import engine_scan as tes

    c = np.random.default_rng(0).normal(size=(N, 4)).astype(np.float32)
    c_t = torch.as_tensor(c)

    def grad(j, w, k):
        return w - c_t.index_select(0, j.reshape(1))[0]

    p = _nonuniform_p(N, seed=1)
    mu = np.random.default_rng(2).uniform(0.5, 4.0, N)
    d = [torch.as_tensor(x) for x in _ref_draws(jax.random.PRNGKey(5), N, C, T, p)[:4]]
    sharded = tes.jit_fused_runner(grad, N, C, T, shard_devices=2, block_size=E)
    assert sharded is tes.jit_fused_runner(grad, N, C, T, block_size=E)
    w, ev, x = sharded.from_draws(torch.zeros(4), mu, p, ETA, *d)
    w1, ev1, x1 = tes.make_fused_runner(grad, N, C, T, block_size=E).from_draws(
        torch.zeros(4), mu, p, ETA, *d)
    assert torch.equal(w, w1) and torch.equal(ev, ev1)
    assert all(torch.equal(x[k], x1[k]) for k in x1)
