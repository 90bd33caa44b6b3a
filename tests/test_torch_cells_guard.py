"""PyTorch port, the cell axis under FedBuff and the guard, K6 across cells,
and the launcher's choice of backend and card.

The cell axis (the scenario matrix's B runs in lockstep) replays FedBuff
with one buffer a cell and the guard with one counter a cell, as the
reference's ``jax.vmap`` of its runners does: on the host stream
(`engine_scan.jit_runner(vmap_streams=True)`, per event and blocked E=4)
against JAX's vmapped runner on the same stacked arrays, and on the device
stream (`make_fused_runner(vmap_scenarios=True)`, per event and blocked)
against ``jax.vmap`` of JAX's fused runner on the reference's draws, the
Quadratic within 1e-5 and every cell's counters exact; with serving and the
guard, each cell bitwise its own run.  A spiking source
whose spikes hit odd clients only gives each cell its own reject count.
K6's plain version across cells is bitwise ``jax.vmap`` of the Pallas
`block_scatter_rows` (interpret mode) and of its jnp reference.  Last,
`launch.lanes.placement`: NCCL with one card a rank, else gloo.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import EventBlocks as JEventBlocks  # noqa: E402
from repro.core import SimConfig as JSimConfig  # noqa: E402
from repro.core import blocked_inputs_batch as j_blocked_inputs_batch  # noqa: E402
from repro.core import engine_scan as jes  # noqa: E402
from repro.core import export_stream as j_export_stream  # noqa: E402
from repro.core import step_scales as j_step_scales  # noqa: E402
from repro.core.engine_scan import GuardConfig as JGuardConfig  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.weighted_update import block_scatter_rows as j_scatter  # noqa: E402
from repro_torch.core import engine_scan  # noqa: E402
from repro_torch.core.engine_scan import GuardConfig  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import weighted_update as cuda_kernels  # noqa: E402
from repro_torch.launch.lanes import placement  # noqa: E402
from test_stream_device import _nonuniform_p  # noqa: E402
from test_torch_fused import _draws  # noqa: E402

N, C, T, B, ETA = 8, 4, 300, 4, 0.05
SPIKE_EVERY, NAN_STEP = 7, 40


class Spiky:
    """grad = w - c_j, plus 1e6 at every 7th server step for odd clients and
    NaN at step 40 (`tests/test_faults.py`'s spikes, client-dependent so
    that cells with other streams reject other counts); ``spikes=False``:
    the plain quadratic."""

    def __init__(self, c, spikes=True):
        self.c_t, self.spikes = torch.tensor(c), spikes

    def device_grad(self, j, w, k):
        g = w - self.c_t.index_select(0, j.reshape(1))[0]
        if not self.spikes:
            return g
        g = torch.where(((k % SPIKE_EVERY) == SPIKE_EVERY - 1) & ((j % 2) == 1), g + 1e6, g)
        return torch.where(k == NAN_STEP, torch.full_like(g, float("nan")), g)


class JSpiky:
    def __init__(self, c, spikes=True):
        self.c, self.spikes = jnp.asarray(c), spikes

    def device_grad(self, j, w, k):
        g = w - self.c[j]
        if not self.spikes:
            return g
        g = jnp.where(((k % SPIKE_EVERY) == SPIKE_EVERY - 1) & ((j % 2) == 1), g + 1e6, g)
        return jnp.where(k == NAN_STEP, jnp.full_like(g, jnp.nan), g)


def _centres(d=4):
    return np.random.default_rng(0).normal(size=(N, d)).astype(np.float32)


def _cells():
    """B cells: their speeds, sampling vectors and seeds."""
    mus = np.stack([np.random.default_rng(b).uniform(0.5, 4.0, N) for b in range(B)])
    ps = np.stack([_nonuniform_p(N, seed=b + 1) for b in range(B)])
    return mus, ps


# the modes: (port kwargs, reference kwargs) of the runner
MODES = {
    "fedbuff": (dict(fedbuff_Z=5), dict(fedbuff_Z=5)),
    "guard": (dict(guard=GuardConfig(max_grad_norm=100.0)),
              dict(guard=JGuardConfig(max_grad_norm=100.0))),
}


def _host_arrays(E):
    """The B cells' host streams stacked (per event) or cut into one common
    blocked layout (E > 1), by the reference's simulator (the port's is
    bitwise it)."""
    mus, ps = _cells()
    streams = [j_export_stream(JSimConfig(mu=mus[b], p=ps[b], C=C, T=T, seed=b))
               for b in range(B)]
    scales = [j_step_scales(es, ETA, ps[b], "importance") for b, es in enumerate(streams)]
    if E == 1:
        return (np.stack([es.J for es in streams]), np.stack([es.slot for es in streams]),
                np.stack(scales).astype(np.float32))
    return j_blocked_inputs_batch([JEventBlocks.from_stream(es, E) for es in streams], scales)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("E", [1, 4])
def test_host_cell_axis_matches_jax_vmap(mode, E):
    """FedBuff (one buffer a cell) and the guard (one (2,) counter a cell,
    the (B, 2) rows of JAX's vmapped runner, exact) across 4 cells."""
    t_kw, j_kw = MODES[mode]
    c = _centres()
    arrays = _host_arrays(E)
    idx = lambda a: torch.as_tensor(a, dtype=torch.int64)  # noqa: E731
    spikes = mode == "guard"  # FedBuff alone: its own arithmetic, no spikes
    src, jsrc = Spiky(c, spikes), JSpiky(c, spikes)
    jr = jes.jit_runner(jsrc.device_grad, C, block_size=E, vmap_streams=True, **j_kw)
    tr = engine_scan.jit_runner(src.device_grad, C, block_size=E, vmap_streams=True, **t_kw)
    if E == 1:
        J, slot, sc = arrays
        out_j = jr(jnp.zeros(4), *map(jnp.asarray, arrays))
        out_t = tr(torch.zeros(4), idx(J), idx(slot), torch.as_tensor(sc))
    else:
        *a, G, nc = arrays
        out_j = jr(jnp.zeros(4), *map(jnp.asarray, a), chunk_blocks=G, n_chunks=nc)
        J, slot, sc, kb, mask = a
        out_t = tr(torch.zeros(4), idx(J), idx(slot), torch.as_tensor(sc), idx(kb),
                   torch.as_tensor(mask), chunk_blocks=G, n_chunks=nc)
    assert out_t[0].shape == (B, 4)
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]), atol=1e-5)
    if mode == "guard":
        gcnt = out_t[2].numpy()
        assert gcnt.shape == (B, 2) and gcnt.dtype == np.int32
        np.testing.assert_array_equal(gcnt, np.asarray(out_j[2]))
        assert len(set(gcnt[:, 0].tolist())) > 1 and gcnt[:, 0].min() > 0  # each cell its own
        assert np.isfinite(out_t[0].numpy()).all()


@pytest.mark.parametrize("mode", ["fedbuff", "guard", "guard_stale"])
@pytest.mark.parametrize("E", [1, 4])
def test_device_cell_axis_matches_jax_vmap(mode, E):
    """``make_fused_runner(vmap_scenarios=True)`` with FedBuff or the guard
    (and its staleness cutoff, the stream's own delays) on the reference's
    draws, against ``jax.vmap`` of the reference's fused runner: weights
    within 1e-5, ``guard_rejects`` / ``stale_drops`` (B,) and exact."""
    c = _centres()
    mus, ps = _cells()
    src, jsrc = Spiky(c, mode != "fedbuff"), JSpiky(c, mode != "fedbuff")
    if mode == "fedbuff":
        kw_t = kw_j = dict(fedbuff_Z=5, weighting="plain")
    else:
        cut = 3 if mode == "guard_stale" else 0
        kw_t = dict(guard=GuardConfig(max_grad_norm=100.0, stale_cutoff=cut))
        kw_j = dict(guard=JGuardConfig(max_grad_norm=100.0, stale_cutoff=cut))
    keys = [jax.random.PRNGKey(20 + b) for b in range(B)]
    jr = jes.make_fused_runner(jsrc.device_grad, N, C, T, block_size=E, **kw_j)
    wj, _, xj = jax.jit(jax.vmap(jr, in_axes=(None, 0, 0, 0, None)))(
        jnp.zeros(4), jnp.asarray(mus), jnp.asarray(ps), jnp.stack(keys), ETA)
    draws = [torch.stack(x) for x in zip(*[_draws(keys[b], N, C, T, ps[b]) for b in range(B)])]
    tr = engine_scan.make_fused_runner(src.device_grad, N, C, T, block_size=E,
                                       vmap_scenarios=True, **kw_t)
    wt, _, xt = tr.from_draws(torch.zeros(4), mus, ps, ETA, *draws)
    assert wt.shape == (B, 4)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-5)
    if mode != "fedbuff":
        for name in ("guard_rejects", "stale_drops"):
            assert xt[name].shape == (B,)
            np.testing.assert_array_equal(xt[name].numpy(), np.asarray(xj[name]))
        assert xt["guard_rejects"].numpy().min() > 0
        if mode == "guard_stale":
            assert xt["stale_drops"].numpy().min() > 0


def test_guarded_serving_cell_axis_is_each_cell_alone():
    """Serving with the guard on the cell axis (a client whose gradients are
    infinite for 300 steps): each cell's weights, counters and ``serve_*``
    extras bitwise its guarded run alone, so the known-good pointer of each
    cell moves only on its own accepted updates."""
    from repro_torch.core import ServingConfig
    from test_torch_serving import C as SC, MU, N as SN, OVERLOAD, P, _t_poison
    from test_torch_stream import _ref_draws

    T_ = 500
    guard = GuardConfig(max_grad_norm=1e3, stale_cutoff=6)
    draws = [_ref_draws(jax.random.PRNGKey(s), SN, SC, T_, P)[:4] for s in range(3)]
    stacked = [torch.tensor(np.stack(d)) for d in zip(*draws)]
    mus = np.stack([MU * (1 + 0.1 * s) for s in range(3)])
    kw = dict(serving=ServingConfig(**OVERLOAD), guard=guard)
    cells = engine_scan.make_fused_runner(_t_poison, SN, SC, T_, vmap_scenarios=True, **kw)
    wc, _, xc = cells.from_draws({"a": torch.zeros(6)}, mus, np.stack([P] * 3), 0.05, *stacked)
    one = engine_scan.make_fused_runner(_t_poison, SN, SC, T_, **kw)
    for s in range(3):
        w1, _, x1 = one.from_draws({"a": torch.zeros(6)}, mus[s], P, 0.05,
                                   *[torch.tensor(a) for a in draws[s]])
        assert torch.equal(wc["a"][s], w1["a"])
        assert int(x1["guard_rejects"]) > 0
        for k in x1:
            if k.startswith("serve_") or k in ("guard_rejects", "stale_drops"):
                assert torch.equal(xc[k][s], x1[k]), k


def _cells_scatter_inputs(dtype, B_, E=8, pad=3, C_=8, P=2048):
    """B cells' (C+1, P) rings, fp32 w, (E, P) iterates and slots: E - pad
    distinct real rows (one targeted twice), then ``pad`` lanes on the trash
    row C."""
    rng = np.random.default_rng(B_ + E)
    snaps = rng.normal(size=(B_, C_ + 1, P)).astype(np.float32)
    w = rng.normal(size=(B_, P)).astype(np.float32)
    W = rng.normal(size=(B_, E, P)).astype(np.float32)
    slots = np.stack([np.concatenate([rng.choice(C_, size=E - pad, replace=False),
                                      np.full(pad, C_)]) for _ in range(B_)]).astype(np.int64)
    slots[:, 1] = slots[:, 0]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return ((torch.tensor(snaps).to(dtype), torch.tensor(w), torch.tensor(W), torch.tensor(slots)),
            (jnp.asarray(snaps, jdt), jnp.asarray(w), jnp.asarray(W), jnp.asarray(slots, jnp.int32)),
            C_)


def _f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B_", [1, 4, 27])
def test_block_scatter_rows_across_cells_matches_jax_vmap(dtype, B_):
    """K6's plain version (and `kernels.ops` on a CPU tensor) over B cells:
    every ring row and w' bitwise ``jax.vmap`` of the Pallas kernel in
    interpret mode, the real rows bitwise ``jax.vmap`` of its jnp reference,
    and each cell bitwise its own one-cell call."""
    t_in, j_in, C_ = _cells_scatter_inputs(dtype, B_)
    cuda_kernels.reset_launches()
    got_s, got_w = ops.block_scatter_rows(t_in[0].clone(), *t_in[1:])
    assert cuda_kernels.launches["block_scatter_rows"] == 0  # a CPU tensor: no launch
    assert got_s.shape == t_in[0].shape and got_w.shape == (B_, t_in[1].shape[1])
    jk_s, jk_w = jax.vmap(lambda s, w, W, sl: j_scatter(s, w, W, sl, interpret=True))(*j_in)
    jr_s, jr_w = jax.vmap(j_ref.block_scatter_rows_ref)(*j_in)
    np.testing.assert_array_equal(_f32(got_s), _f32(jk_s))
    np.testing.assert_array_equal(_f32(got_s)[:, :C_], _f32(jr_s)[:, :C_])
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(jk_w))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(jr_w))
    for b in range(B_):
        one_s, one_w = ref.block_scatter_rows_ref(t_in[0][b].clone(), t_in[1][b], t_in[2][b],
                                                  t_in[3][b])
        assert torch.equal(one_s, got_s[b]) and torch.equal(one_w, got_w[b])


def test_block_scatter_rows_cuda_wrapper_checks_cell_operands():
    """The CUDA wrapper refuses CPU operands, and cell operands whose axes
    disagree, before it builds anything."""
    t_in, _, _ = _cells_scatter_inputs(torch.float32, 3)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.block_scatter_rows(*t_in)
    with pytest.raises(ValueError, match="do not agree"):
        cuda_kernels.block_scatter_rows(t_in[0], t_in[1][:2], t_in[2], t_in[3])


@pytest.mark.parametrize("world,cards,backend,want", [
    (2, 8, "auto", ("nccl", [0, 1])),
    (4, 4, "auto", ("nccl", [0, 1, 2, 3])),
    (2, 1, "auto", ("gloo", [0, 0])),
    (4, 1, "auto", ("gloo", [0, 0, 0, 0])),
    (4, 2, "auto", ("gloo", [0, 1, 0, 1])),
    (1, 1, "auto", ("gloo", [0])),
    (3, 0, "auto", ("gloo", [None, None, None])),
    (2, 8, "gloo", ("gloo", [0, 1])),
    (2, 2, "nccl", ("nccl", [0, 1])),
])
def test_run_lanes_placement(world, cards, backend, want):
    """One card a rank and more than one card: NCCL, rank r on card r;
    ranks sharing a card (or none): gloo, rank r on card r mod cards."""
    assert placement(world, cards, backend) == want


def test_run_lanes_placement_refuses():
    with pytest.raises(ValueError, match="a card for each rank"):
        placement(2, 1, "nccl")
    with pytest.raises(ValueError, match="backend"):
        placement(2, 2, "mpi")
    with pytest.raises(ValueError, match="at least one rank"):
        placement(0, 2)
