"""PyTorch port, lane-sharded blocked replay: K6 and 2 gloo ranks.

K6's plain version (and `kernels.ops` on a CPU tensor) against the JAX
`block_scatter_rows` (Pallas, interpret mode) and its jnp reference, bitwise.
Then the lane-sharded replay: ONE subprocess starts 2 gloo ranks on the CPU
(`repro_torch.launch.lanes.run_lanes`) that replay gen_async (C in {1, 4},
E=4, plain and kernel path) and FedBuff (Z=5) on the reference's Quadratic,
and the MLP through `run_experiment(devices=2, block_size=8)`; each is held
against the JAX package's UNSHARDED blocked run — the reference's own
sharded == unsharded contract (`tests/test_sharded_block.py`, <= 1e-5 on
the Quadratic; the MLP, whose ReLU kinks amplify re-association, <= 1e-4)
— and the two ranks must agree bitwise.  Last, the guard rails of
`tests/test_sharded_block.py` as `ValueError`s.
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

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import FLConfig as JFLConfig  # noqa: E402
from repro.core import EventBlocks as JEventBlocks  # noqa: E402
from repro.core import SimConfig as JSimConfig  # noqa: E402
from repro.core import blocked_inputs as j_blocked_inputs  # noqa: E402
from repro.core import export_stream as j_export_stream  # noqa: E402
from repro.core import jit_runner as j_jit_runner  # noqa: E402
from repro.core import step_scales as j_step_scales  # noqa: E402
from repro.data.pipeline import FederatedClassification as JData  # noqa: E402
from repro.fl import engine as j_fl  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.weighted_update import block_scatter_rows as j_scatter  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.core import ServerConfig, run_generalized_async_sgd  # noqa: E402
from repro_torch.core import engine_scan  # noqa: E402
from repro_torch.fl import engine as t_fl  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import weighted_update as cuda_kernels  # noqa: E402
from test_torch_engine import Quadratic  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# K6's plain version against the JAX kernel and reference
# ---------------------------------------------------------------------------
def _scatter_inputs(dtype, E, pad, C=8, P=2048, seed=0):
    """A (C+1, P) ring, fp32 w, (E, P) fp32 iterates and E slots: E - pad
    distinct real rows, then ``pad`` padded lanes on the trash row C."""
    rng = np.random.default_rng(seed + E)
    snaps = rng.normal(size=(C + 1, P)).astype(np.float32)
    w = rng.normal(size=P).astype(np.float32)
    W = rng.normal(size=(E, P)).astype(np.float32)
    slots = np.concatenate([rng.choice(C, size=E - pad, replace=False),
                            np.full(pad, C)]).astype(np.int64)
    t_snaps = torch.tensor(snaps).to(dtype)
    j_snaps = jnp.asarray(snaps, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    return (t_snaps, torch.tensor(w), torch.tensor(W), torch.tensor(slots)), \
        (j_snaps, jnp.asarray(w), jnp.asarray(W), jnp.asarray(slots, jnp.int32)), C


def _f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,pad", [(2, 0), (4, 1), (8, 3)])
def test_block_scatter_rows_matches_jax(dtype, E, pad):
    t_in, j_in, C = _scatter_inputs(dtype, E, pad)
    cuda_kernels.reset_launches()
    got_s, got_w = ops.block_scatter_rows(t_in[0].clone(), *t_in[1:])
    ref_s, ref_w = ref.block_scatter_rows_ref(t_in[0].clone(), *t_in[1:])
    assert cuda_kernels.launches["block_scatter_rows"] == 0  # a CPU tensor: no launch
    assert got_s.dtype == dtype and got_w.dtype == torch.float32
    jk_s, jk_w = j_scatter(*j_in, interpret=True)
    jr_s, jr_w = j_ref.block_scatter_rows_ref(*j_in)
    for s, w_ in ((got_s, got_w), (ref_s, ref_w)):
        # every real row and w' bitwise; the trash row C (written by every
        # padded lane) holds the last writer's row, as in the Pallas kernel
        np.testing.assert_array_equal(_f32(s), _f32(jk_s))
        np.testing.assert_array_equal(_f32(s)[:C], _f32(jr_s)[:C])
        np.testing.assert_array_equal(w_.numpy(), np.asarray(jk_w))
        np.testing.assert_array_equal(w_.numpy(), np.asarray(jr_w))


# slot patterns of one block on a ring of C + 1 = 9 rows (trash row 8):
# padded lanes on the trash row, a real row targeted twice, every lane on
# the trash row, and E in {1, 8, 16}
LIVE_PATTERNS = [
    [3],
    [8],
    [3, 1, 6, 5, 0, 8, 8, 8],
    [3, 1, 3, 5, 8, 2, 8, 1],
    [8] * 8,
    [8] * 16,
    [0, 8, 1, 8, 2, 8, 3, 8, 4, 8, 5, 8, 6, 8, 7, 8],
    [5, 5, 5, 5, 2, 2, 8, 8, 8, 8, 7, 6, 5, 4, 3, 8],
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("slots", LIVE_PATTERNS)
def test_live_lanes_alone_give_the_ring(dtype, slots):
    """K6's live-lane rule (`live_lanes`, mirrored by the CUDA kernel): a
    lane writes only when no later lane has its slot.  Writing the live
    lanes alone, in reverse order (the kernel's threads keep no order),
    gives bitwise the ring and w' of the plain version and of the JAX
    kernel in interpret mode, which write every lane in event order."""
    C, E = 8, len(slots)
    t_in, j_in, _ = _scatter_inputs(dtype, E, E, C=C)  # its slots are replaced below
    slots_t = torch.tensor(slots, dtype=torch.int64)
    t_in = (*t_in[:3], slots_t)
    j_in = (*j_in[:3], jnp.asarray(slots, jnp.int32))
    live = cuda_kernels.live_lanes(slots, C + 1)
    assert live[-1] and sum(live) == len(set(slots))  # one writer per distinct row
    got = t_in[0].clone()
    for i in reversed(range(E)):
        if live[i]:
            got[slots[i]] = t_in[2][i].to(dtype)
    got_w = t_in[2][-1].to(t_in[1].dtype)
    ref_s, ref_w = ref.block_scatter_rows_ref(t_in[0].clone(), *t_in[1:])
    jk_s, jk_w = j_scatter(*j_in, interpret=True)
    jr_s, _ = j_ref.block_scatter_rows_ref(*j_in)
    assert torch.equal(got, ref_s) and torch.equal(got_w, ref_w)
    np.testing.assert_array_equal(_f32(got), _f32(jk_s))
    np.testing.assert_array_equal(_f32(got)[:C], _f32(jr_s)[:C])
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(jk_w))


def test_live_lanes_drop_slots_outside_the_ring():
    assert cuda_kernels.live_lanes([-1, 9, 3, 9], 9) == [False, False, True, False]
    assert cuda_kernels.live_lanes([], 9) == []


def test_block_scatter_rows_cuda_wrapper_rejects_cpu_operands():
    """The CUDA wrapper takes CUDA tensors only (it raises before building);
    `kernels.ops` routes a CPU tensor to the plain version."""
    t_in, _, _ = _scatter_inputs(torch.float32, 4, 1)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.block_scatter_rows(*t_in)
    with pytest.raises(TypeError, match="float32"):
        cuda_kernels.block_scatter_rows(t_in[0], t_in[1], t_in[2].double(), t_in[3])
    with pytest.raises(ValueError, match="do not agree"):
        cuda_kernels.block_scatter_rows(t_in[0], t_in[1][:-1], t_in[2], t_in[3])


# ---------------------------------------------------------------------------
# the lane-sharded replay on 2 gloo CPU ranks, held against JAX unsharded
# ---------------------------------------------------------------------------
_RANKS_SCRIPT = textwrap.dedent(
    """
    import sys
    import numpy as np
    import torch

    from repro_torch.configs.base import FLConfig
    from repro_torch.core.engine_scan import blocked_inputs, jit_runner, step_scales
    from repro_torch.core.queue_sim import EventBlocks, SimConfig, export_stream
    from repro_torch.data.pipeline import FederatedClassification
    from repro_torch.fl import engine as fl
    from repro_torch.launch.lanes import run_lanes

    N, T, E = 8, 500, 4

    class Quadratic:
        def __init__(self, c):
            self.c_t = torch.tensor(c)
        def device_grad(self, j, w, k):
            return w - self.c_t.index_select(0, j.reshape(1))[0]

    def quadratic(world, C, kernel, Z, c, p):
        st = export_stream(SimConfig(mu=np.ones(N), p=p, C=C, T=T, seed=0 if Z else 3))
        blocks = EventBlocks.from_stream(st, E)
        args = blocked_inputs(blocks, step_scales(st, 0.05 if Z else 0.02, p,
                                                  "plain" if Z else "importance"))
        arrs = [torch.as_tensor(a) for a in args[:5]]
        arrs = [a.long() if not (a.is_floating_point() or a.dtype == torch.bool) else a
                for a in arrs]
        run = jit_runner(Quadratic(c).device_grad, C, fedbuff_Z=Z, block_size=E,
                         kernel=kernel, lane_devices=world)
        return run(torch.zeros(4), *arrs, chunk_blocks=args[5], n_chunks=args[6])[0].numpy()

    def mlp(world, method, inputs):
        n, hidden = 16, 32
        task = fl.ClassificationTask(hidden=hidden)
        data = FederatedClassification(n_clients=n, seed=0)
        model = fl.MLPClassifier(data.dim, data.num_classes, hidden=hidden, device="cpu")
        params = {k[len("w0/"):]: inputs[k] for k in inputs.files if k.startswith("w0/")}
        setup = fl.TaskSetup(
            params=fl.params_from_numpy(params, "cpu"),
            clients=fl.DeviceFLClients(data, model, starts=inputs["starts"], device="cpu"),
            eval_fn=fl._accuracy_fn(model, data, device="cpu"), model=model)
        data.__dict__.setdefault("_fl_setup_cache", {})[(0, task.cache_key())] = setup
        flc = FLConfig(n_clients=n, concurrency=4, server_steps=300, engine="scan",
                       block_size=8, devices=world, fedbuff_Z=5, device="cpu")
        r = fl.run_experiment(flc, method, eval_every=100, data=data, task=task)
        out = {f"w/{k}": v.numpy() for k, v in r.final_params.items()}
        out["acc"] = np.asarray(r.eval_acc)
        out["steps"] = np.asarray(r.eval_steps)
        return out

    def rank(rank, world, inputs_path):
        torch.set_num_threads(1)
        inputs = np.load(inputs_path)
        c, p = inputs["c"], inputs["p"]
        out = {}
        for C in (1, 4):
            for kernel in ("jnp", "pallas"):
                out[f"gen_async_C{C}_{kernel}"] = quadratic(world, C, kernel, 0, c, p)
        for kernel in ("jnp", "pallas"):
            out[f"fedbuff_Z5_{kernel}"] = quadratic(world, 4, kernel, 5, c, np.full(N, 1 / N))
        for method in ("gen_async", "fedbuff"):
            for k, v in mlp(world, method, inputs).items():
                out[f"mlp_{method}/{k}"] = v
        try:
            jit_runner(Quadratic(c).device_grad, 4, block_size=4, lane_devices=2 * world)
            out["wrong_world_size"] = ""
        except ValueError as e:
            out["wrong_world_size"] = str(e)
        return out

    if __name__ == "__main__":
        inputs_path, out_path = sys.argv[1], sys.argv[2]
        res = run_lanes(rank, 2, (inputs_path,), timeout=280.0)
        np.savez(out_path, **{f"r{r}/{k}": np.asarray(v)
                              for r, d in enumerate(res) for k, v in d.items()})
    """
)

_N, _E = 8, 4


def _quad_case(name):
    """(C, kernel, Z) of a Quadratic case name."""
    if name.startswith("fedbuff"):
        return 4, name.rsplit("_", 1)[1], 5
    C, kernel = name[len("gen_async_C"):].split("_")
    return int(C), kernel, 0


QUAD_CASES = ["gen_async_C1_jnp", "gen_async_C1_pallas", "gen_async_C4_jnp",
              "gen_async_C4_pallas", "fedbuff_Z5_jnp", "fedbuff_Z5_pallas"]
_MLP_KW = dict(n_clients=16, concurrency=4, server_steps=300, engine="scan", block_size=8,
               fedbuff_Z=5)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the 2-rank script once: its inputs are the Quadratic's centres and
    sampling vector and the JAX MLP's initial weights and window offsets."""
    tmp = tmp_path_factory.mktemp("lanes")
    prob = Quadratic(_N)
    p = np.random.default_rng(1).uniform(0.5, 1.5, _N)
    p /= p.sum()
    j_setup = j_fl._cached_fl_setup(JData(n_clients=16, seed=0), 0,
                                    j_fl.ClassificationTask(hidden=32))
    inputs = {"c": prob.c, "p": p, "starts": np.asarray(j_setup.clients._starts)}
    inputs.update({f"w0/{k}": np.asarray(v) for k, v in j_setup.params.items()})
    np.savez(tmp / "inputs.npz", **inputs)
    (tmp / "ranks.py").write_text(_RANKS_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, str(tmp / "ranks.py"), str(tmp / "inputs.npz"),
                          str(tmp / "out.npz")],
                         capture_output=True, text=True, timeout=300, env=env, cwd=tmp)
    assert res.returncode == 0, res.stderr[-4000:]
    out = np.load(tmp / "out.npz")
    return {k: out[k] for k in out.files}, prob, p


def _jax_unsharded(case, prob, p):
    C, kernel, Z = _quad_case(case)
    pp = np.full(_N, 1 / _N) if Z else p
    st = j_export_stream(JSimConfig(mu=np.ones(_N), p=pp, C=C, T=500, seed=0 if Z else 3))
    args = j_blocked_inputs(JEventBlocks.from_stream(st, _E),
                            j_step_scales(st, 0.05 if Z else 0.02, pp,
                                          "plain" if Z else "importance"))
    from test_torch_engine import JQuadratic

    run = j_jit_runner(JQuadratic(prob.c).device_grad, C, fedbuff_Z=Z, block_size=_E,
                       kernel=kernel, interpret=True)
    w, _ = run(jnp.zeros(4, jnp.float32), *map(jnp.asarray, args[:5]),
               chunk_blocks=args[5], n_chunks=args[6])
    return np.asarray(w)


@pytest.mark.parametrize("case", QUAD_CASES)
def test_sharded_quadratic_matches_jax_unsharded(ranks, case):
    out, prob, p = ranks
    w0, w1 = out[f"r0/{case}"], out[f"r1/{case}"]
    np.testing.assert_array_equal(w0, w1)  # the ranks hold one replicated result
    np.testing.assert_allclose(w0, _jax_unsharded(case, prob, p), atol=1e-5)


@pytest.mark.parametrize("method", ["gen_async", "fedbuff"])
def test_sharded_mlp_matches_jax_unsharded(ranks, method):
    out, _, _ = ranks
    rj = j_fl.run_experiment(JFLConfig(**_MLP_KW), method, eval_every=100,
                             data=JData(n_clients=16, seed=0), task=j_fl.ClassificationTask(hidden=32))
    pre = f"mlp_{method}/"
    for k, v in rj.final_params.items():
        np.testing.assert_array_equal(out[f"r0/{pre}w/{k}"], out[f"r1/{pre}w/{k}"])
        np.testing.assert_allclose(out[f"r0/{pre}w/{k}"], np.asarray(v), atol=1e-4)
    np.testing.assert_array_equal(out[f"r0/{pre}steps"], rj.eval_steps)
    np.testing.assert_array_equal(out[f"r0/{pre}acc"], out[f"r1/{pre}acc"])
    np.testing.assert_allclose(out[f"r0/{pre}acc"], rj.eval_acc, atol=2 / 2048)


def test_wrong_world_size_raises(ranks):
    """In a group of 2 ranks, ``lane_devices=4`` is refused."""
    out, _, _ = ranks
    for r in (0, 1):
        msg = str(out[f"r{r}/wrong_world_size"])
        assert "world size 2" in msg and "lane_devices=4" in msg


# ---------------------------------------------------------------------------
# guard rails (no process group in this process)
# ---------------------------------------------------------------------------
def test_no_process_group_raises():
    prob = Quadratic(_N)
    with pytest.raises(ValueError, match="process group"):
        engine_scan.jit_runner(prob.device_grad, 4, block_size=4, lane_devices=2)
    flc = FLConfig(n_clients=8, concurrency=2, server_steps=20, engine="scan", block_size=4,
                   devices=2, device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        t_fl.run_experiment(flc, "gen_async")


def test_per_event_rejects_lane_devices():
    prob = Quadratic(_N)
    with pytest.raises(ValueError, match="block_size > 1"):
        engine_scan.jit_runner(prob.device_grad, 4, lane_devices=2)
    cfg = ServerConfig(n=_N, C=4, T=50, eta=0.1, engine="scan", devices=2, device="cpu")
    with pytest.raises(ValueError, match="block"):
        run_generalized_async_sgd(np.zeros(4, np.float32), prob, cfg)


def test_block_size_must_divide():
    prob = Quadratic(_N)
    with pytest.raises(ValueError, match="multiple of"):
        engine_scan.jit_runner(prob.device_grad, 4, block_size=3, lane_devices=2)
    with pytest.raises(ValueError, match=">= 1"):
        engine_scan.jit_runner(prob.device_grad, 4, block_size=4, lane_devices=0)
