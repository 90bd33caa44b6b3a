"""PyTorch port on the card: the CUDA kernels against their plain versions,
the kernel paths of the replay engine against the plain paths, and the LM
paths with the flash-attention, chunked-SSD and grouped-matmul kernels
against the plain versions.

Every test here needs a CUDA device (marker ``gpu``) and skips without one;
the file imports neither JAX nor `repro`, so it runs on a machine that has
only the port's dependencies:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import ServerConfig, run_generalized_async_sgd  # noqa: E402
from repro_torch.core.engine_scan import blocked_inputs, step_scales  # noqa: E402
from repro_torch.core.queue_sim import EventBlocks, SimConfig, export_stream  # noqa: E402
from repro_torch.data.pipeline import FederatedClassification, make_client_speeds  # noqa: E402
from repro_torch.fl import engine as fl  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gmm as k5  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as k4  # noqa: E402
from repro_torch.kernels import weighted_update as cuda_kernels  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.module import init_params  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}  # tests/test_kernels.py's


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(17,), (1000, 37), (64, 128), (3, 5, 7)])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_weighted_update_matches_plain(dev, dtype, shape, momentum):
    gen = torch.Generator().manual_seed(int(np.prod(shape)))
    w = torch.randn(shape, generator=gen).to(dev, dtype)
    g = torch.randn(shape, generator=gen).to(dev, dtype)
    m = torch.randn(shape, generator=gen).to(dev) if momentum else None
    s = torch.tensor(0.37, device=dev)
    kw, km = cuda_kernels.weighted_update(w, g, s, m=m, momentum=momentum)
    rw, rm = ref.weighted_update_ref(w, g, s, m=m, momentum=momentum)
    torch.cuda.synchronize()
    assert kw.dtype == dtype and _err(kw, rw) <= TOL[dtype]
    if momentum:
        assert _err(km, rm) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E", [1, 4, 8, 16])
def test_block_prefix_update_matches_plain(dev, dtype, E):
    """The MLP's blocked ring (C+1, P) = (65, 26624), full ring compared;
    the last two lanes are padding on the trash row C (E=1: none)."""
    C, P = 64, 26624
    pad = 2 if E > 2 else 0
    gen = torch.Generator().manual_seed(E)
    snaps = torch.randn((C + 1, P), generator=gen).to(dev, dtype)
    w = torch.randn((P,), generator=gen).to(dev)
    D = (0.01 * torch.randn((E, P), generator=gen)).to(dev)
    D[E - pad:] = 0.0
    slots = torch.tensor(list(range(E - pad)) + [C] * pad, device=dev)
    ks, kw = cuda_kernels.block_prefix_update(snaps.clone(), w, D, slots)
    rs, rw = ref.block_prefix_update_ref(snaps.clone(), w, D, slots)
    torch.cuda.synchronize()
    assert _err(ks, rs) <= TOL[dtype] and _err(kw, rw) <= 1e-5


# K1 leaf lists: (shapes, w dtypes, g dtypes); "f" float32, "b" bfloat16
LEAF_LISTS = {
    "mlp": ([(128,), (128,), (10,), (64, 128), (128, 128), (128, 10)], "ffffff", "ffffff"),
    "mixed": ([(2048, 3), (1000,), (3, 5, 7), (8197,), (40, 33)], "fbbfb", "fbfbf"),
    "ragged": ([(1,), (4097,), (8191,), (8193,), (12345,), (3,)], "bbffbf", "bbffbf"),
    "empty_and_0d": ([(0,), (), (5, 0), (17,), ()], "fbfbb", "fbfbf"),
    "more_than_max_leaves": ([((7 * i) % 300 + 1,) for i in range(150)], "fb" * 75, "bf" * 75),
}
_DT = {"f": torch.float32, "b": torch.bfloat16}


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("case", sorted(LEAF_LISTS))
def test_weighted_update_leaves_matches_plain(dev, case, momentum):
    """K1 over a leaf list: ceil(leaves with values / MAX_LEAVES) launches,
    every leaf (and m') bitwise equal to the plain version, and to a second
    launch; each leaf keeps its dtype and shape."""
    shapes, wd, gd = LEAF_LISTS[case]
    gen = torch.Generator().manual_seed(len(shapes))
    ws = [torch.randn(sh, generator=gen).to(dev, _DT[d]) for sh, d in zip(shapes, wd)]
    gs = [torch.randn(sh, generator=gen).to(dev, _DT[d]) for sh, d in zip(shapes, gd)]
    ms = [torch.randn(sh, generator=gen).to(dev) for sh in shapes] if momentum else None
    s = torch.tensor(0.37, device=dev)
    key = "weighted_update_momentum" if momentum else "weighted_update"
    covered = sum(1 for w in ws if w.numel())
    cuda_kernels.reset_launches()
    out, out_m = cuda_kernels.weighted_update_leaves(ws, gs, s, ms, momentum)
    assert cuda_kernels.launches[key] == -(-covered // cuda_kernels.MAX_LEAVES)
    assert cuda_kernels.launches[key + "_leaves"] == covered
    again, again_m = cuda_kernels.weighted_update_leaves(ws, gs, s, ms, momentum)
    for i in range(len(ws)):
        rw, rm = ref.weighted_update_ref(ws[i], gs[i], s, m=None if ms is None else ms[i],
                                         momentum=momentum)
        assert out[i].dtype == ws[i].dtype and out[i].shape == ws[i].shape
        assert torch.equal(out[i], rw) and torch.equal(again[i], rw)
        if momentum:
            assert torch.equal(out_m[i], rm) and torch.equal(again_m[i], rm)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_weighted_update_leaves_on_misaligned_views(dev, momentum):
    """Leaves that start one value into their storage (one value an access)
    and non-contiguous leaves, beside aligned ones, in one launch."""
    gen = torch.Generator().manual_seed(3)
    base = [torch.randn((4099,), generator=gen).to(dev), torch.randn((64, 130), generator=gen)
            .to(dev, torch.bfloat16), torch.randn((33, 17), generator=gen).to(dev)]
    ws = [_misaligned(base[0], 1), _misaligned(base[1], 1), base[2].t()]
    gs = [_misaligned(torch.randn((4099,), generator=gen).to(dev), 1),
          torch.randn((64, 130), generator=gen).to(dev), torch.randn((17, 33), generator=gen)
          .to(dev)]
    ms = [_misaligned(torch.randn(w.shape, generator=gen).to(dev), 1) for w in ws] \
        if momentum else None
    s = torch.tensor(0.37, device=dev)
    cuda_kernels.reset_launches()
    out, out_m = cuda_kernels.weighted_update_leaves(ws, gs, s, ms, momentum)
    key = "weighted_update_momentum" if momentum else "weighted_update"
    assert cuda_kernels.launches[key] == 1
    for i in range(3):
        rw, rm = ref.weighted_update_ref(ws[i], gs[i], s, m=None if ms is None else ms[i],
                                         momentum=momentum)
        assert torch.equal(out[i], rw)
        if momentum:
            assert torch.equal(out_m[i], rm)


def test_weighted_update_tree_is_one_launch(dev):
    params = {"w": torch.randn(64, 128, device=dev), "b": torch.randn(128, device=dev),
              "e": torch.randn(50, 24, device=dev).to(torch.bfloat16)}
    grads = {k: torch.randn_like(v) for k, v in params.items()}
    cuda_kernels.reset_launches()
    new = ops.tree_weighted_update(params, grads, torch.tensor(0.1, device=dev))
    assert cuda_kernels.launches["weighted_update"] == 1
    assert cuda_kernels.launches["weighted_update_leaves"] == 3
    for k in params:
        assert torch.equal(new[k], ref.weighted_update_ref(params[k], grads[k], 0.1)[0])


# K2 cells (R, P, E, slots, ring dtype, w dtype, storage offset of the ring):
# the MLP's ring, a ragged P, a misaligned ring, repeated non-trash slots and
# Mamba2-130M's blocked ring (fp32 and bf16, the ring and w both)
PREFIX_CELLS = [
    (65, 26624, 8, [5, 9, 60, 1, 33, 2, 64, 64], torch.float32, torch.float32, 0),
    (65, 26624, 8, [5, 9, 60, 1, 33, 2, 64, 64], torch.bfloat16, torch.float32, 0),
    (65, 26122, 8, [5, 9, 60, 1, 33, 2, 64, 64], torch.float32, torch.float32, 0),
    (65, 4096, 8, [5, 9, 60, 1, 33, 2, 64, 64], torch.float32, torch.float32, 1),
    (65, 4096, 8, [5, 9, 60, 1, 33, 2, 64, 64], torch.bfloat16, torch.bfloat16, 2),
    (9, 4096, 12, [3, 1, 3, 5, 3, 2, 1, 1, 7, 8, 7, 8], torch.float32, torch.float32, 0),
    (9, 4096, 16, [5, 5, 5, 5, 2, 2, 8, 8, 8, 8, 7, 6, 5, 4, 3, 8], torch.bfloat16,
     torch.float32, 0),
    (9, 128_984_064, 4, [6, 0, 3, 7], torch.float32, torch.float32, 0),
    (9, 128_984_064, 4, [6, 0, 3, 7], torch.bfloat16, torch.bfloat16, 0),
]


@pytest.mark.parametrize("R,P,E,slots,dtype,w_dtype,offset", PREFIX_CELLS)
def test_block_prefix_update_bitwise(dev, R, P, E, slots, dtype, w_dtype, offset):
    """K2 stores only the live lanes; every ring row and w' equal the plain
    version's (every lane in event order) bitwise, in one launch, twice; the
    library moves 16 bytes of ring values an access where P and alignment
    allow it, else one."""
    gen = torch.Generator(device=dev).manual_seed(P + E)
    snaps = torch.randn((R, P), generator=gen, device=dev).to(dtype)
    w = torch.randn((P,), generator=gen, device=dev).to(w_dtype)
    D = 0.01 * torch.randn((E, P), generator=gen, device=dev)
    st = torch.tensor(slots, device=dev)
    ring = lambda: _misaligned(snaps, offset) if offset else snaps.clone()  # noqa: E731
    wide = 4 if dtype == torch.float32 else 8
    assert cuda_kernels.prefix_vec(ring(), w, D) == (1 if offset or P % wide else wide)
    rs, rw = ref.block_prefix_update_ref(snaps.clone(), w, D, st)
    cuda_kernels.reset_launches()
    ks, kw = cuda_kernels.block_prefix_update(ring(), w, D, st)  # in place: keeps the offset
    assert cuda_kernels.launches["block_prefix_update"] == 1
    assert torch.equal(ks, rs) and torch.equal(kw, rw) and kw.dtype == w_dtype
    del rs, rw
    again, again_w = cuda_kernels.block_prefix_update(ring(), w, D, st)
    assert torch.equal(ks, again) and torch.equal(kw, again_w)


@pytest.mark.parametrize("momentum", [False, True])
def test_weighted_update_leaves_kernel_does_not_spill(dev, momentum):
    info = cuda_kernels.update_kernel_info(momentum)
    assert info["local_bytes"] == 0 and info["registers"] > 0 and info["ctas_per_sm"] >= 3
    assert info["max_leaves"] == cuda_kernels.MAX_LEAVES and info["table_bytes"] <= 4096


@pytest.mark.parametrize("dtype,w_dtype,vec", [
    (torch.float32, torch.float32, 4), (torch.float32, torch.float32, 1),
    (torch.bfloat16, torch.float32, 8), (torch.bfloat16, torch.float32, 1),
    (torch.bfloat16, torch.bfloat16, 8), (torch.float32, torch.bfloat16, 4),
])
def test_block_prefix_update_kernels_do_not_spill(dev, dtype, w_dtype, vec):
    info = cuda_kernels.prefix_kernel_info(dtype, vec, 8, w_dtype)
    assert info["local_bytes"] == 0 and info["registers"] > 0 and info["ctas_per_sm"] >= 4


# the cell axis (the scenario matrix): B cells in one launch, each cell's
# slots with duplicate trash-row lanes and a real row targeted twice
@pytest.mark.parametrize("dtype,w_dtype", [(torch.float32, torch.float32),
                                           (torch.bfloat16, torch.float32),
                                           (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("B", [1, 3, 27])
def test_block_prefix_update_across_cells_bitwise(dev, B, dtype, w_dtype):
    """K2 over B cells, one launch: every cell's ring rows and w' bitwise
    equal to the plain version with a cell axis and to that cell's own
    launch, and to a second launch; at B = 1 the (1, R, P) call equals the
    (R, P) call."""
    R, P, E = 17, 26624, 8
    rng = np.random.default_rng(B)
    slots = np.stack([np.concatenate([rng.choice(R - 1, size=E - 3, replace=False),
                                      [R - 1, R - 1, R - 1]]) for _ in range(B)])
    slots[:, 1] = slots[:, 0]  # a real row twice: the later lane wins
    st = torch.tensor(slots, device=dev)
    gen = torch.Generator(device=dev).manual_seed(B)
    snaps = torch.randn((B, R, P), generator=gen, device=dev).to(dtype)
    w = torch.randn((B, P), generator=gen, device=dev).to(w_dtype)
    D = 0.01 * torch.randn((B, E, P), generator=gen, device=dev)
    rs, rw = ref.block_prefix_update_ref(snaps.clone(), w, D, st)
    cuda_kernels.reset_launches()
    ks, kw = cuda_kernels.block_prefix_update(snaps.clone(), w, D, st)
    assert cuda_kernels.launches["block_prefix_update"] == 1
    assert torch.equal(ks, rs) and torch.equal(kw, rw) and kw.shape == (B, P)
    again, again_w = cuda_kernels.block_prefix_update(snaps.clone(), w, D, st)
    assert torch.equal(ks, again) and torch.equal(kw, again_w)
    for c in range(B):
        cs, cw = cuda_kernels.block_prefix_update(snaps[c].clone(), w[c], D[c], st[c])
        assert torch.equal(ks[c], cs) and torch.equal(kw[c], cw)


# K1 leaf sets across cells: (shapes, w dtypes, g dtypes) of one cell
CELL_LEAVES = {
    "mlp": LEAF_LISTS["mlp"],
    "mixed": LEAF_LISTS["mixed"],
}


@pytest.mark.parametrize("case", sorted(CELL_LEAVES))
@pytest.mark.parametrize("B", [1, 3, 27])
def test_weighted_update_leaves_across_cells_bitwise(dev, B, case):
    """K1 with one scale a cell over (B, ...) leaves: ceil(B L / MAX_LEAVES)
    launches covering B L leaves, every cell of every leaf bitwise equal to
    the plain version with that cell's scale, and to a second launch."""
    shapes, wd, gd = CELL_LEAVES[case]
    gen = torch.Generator().manual_seed(B)
    ws = [torch.randn((B, *sh), generator=gen).to(dev, _DT[d]) for sh, d in zip(shapes, wd)]
    gs = [torch.randn((B, *sh), generator=gen).to(dev, _DT[d]) for sh, d in zip(shapes, gd)]
    sc = torch.rand((B,), generator=gen).to(dev) + 0.1
    L = len(shapes)
    cuda_kernels.reset_launches()
    out, _ = cuda_kernels.weighted_update_leaves(ws, gs, sc)
    assert cuda_kernels.launches["weighted_update"] == -(-B * L // cuda_kernels.MAX_LEAVES)
    assert cuda_kernels.launches["weighted_update_leaves"] == B * L
    again, _ = cuda_kernels.weighted_update_leaves(ws, gs, sc)
    for i in range(L):
        assert out[i].shape == ws[i].shape and out[i].dtype == ws[i].dtype
        assert torch.equal(out[i], ref.weighted_update_ref(ws[i], gs[i], sc)[0])
        assert torch.equal(out[i], again[i])
        for c in range(B):
            assert torch.equal(out[i][c], ref.weighted_update_ref(ws[i][c], gs[i][c], sc[c])[0])


def test_cell_axis_kernel_paths_match_plain_paths(dev):
    """The lockstep replay of 3 cells on the card: per event K1 across cells
    (3 x 6 leaves: one launch an event) against the flat update, blocked E=4
    K2 across cells (one launch a block) bitwise against the plain version."""
    from repro_torch.core import jit_runner
    from repro_torch.core.engine_scan import blocked_inputs_batch

    setup, mu = _setup(dev)
    T, streams = 120, []
    for seed in range(3):
        p = np.full(16, 1 / 16)
        es = export_stream(SimConfig(mu=mu, p=p, C=4, T=T, seed=seed))
        streams.append((es, step_scales(es, 0.05, p, "importance")))
    idx = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64, device=dev)  # noqa: E731
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)  # noqa: E731
    args = (idx([es.J for es, _ in streams]), idx([es.slot for es, _ in streams]),
            f32([s for _, s in streams]))
    grad = setup.clients.device_grad
    cuda_kernels.reset_launches()
    w_k, ev_k = jit_runner(grad, 4, eval_fn=setup.eval_fn, eval_every=40,
                           update_fn=ops.tree_weighted_update, vmap_streams=True)(setup.params, *args)
    assert cuda_kernels.launches["weighted_update"] == T
    assert cuda_kernels.launches["weighted_update_leaves"] == T * 3 * 6
    w_p, ev_p = jit_runner(grad, 4, eval_fn=setup.eval_fn, eval_every=40,
                           vmap_streams=True)(setup.params, *args)
    assert max(_err(w_k[k], w_p[k]) for k in w_k) <= 1e-5 and ev_k.shape == (3, 3)
    J, slot, sc, kb, mask, G, nc = blocked_inputs_batch(
        [EventBlocks.from_stream(es, 4, cut_every=40) for es, _ in streams],
        [s for _, s in streams], 40)
    bargs = (idx(J), idx(slot), f32(sc), idx(kb), torch.as_tensor(mask, device=dev))
    run = lambda kernel: jit_runner(grad, 4, eval_fn=setup.eval_fn, block_size=4,  # noqa: E731
                                    kernel=kernel, vmap_streams=True)(
        setup.params, *bargs, chunk_blocks=G, n_chunks=nc)
    cuda_kernels.reset_launches()
    w_b, ev_b = run("pallas")
    assert cuda_kernels.launches["block_prefix_update"] == J.shape[1]
    w_j, ev_j = run("jnp")
    assert all(torch.equal(w_b[k], w_j[k]) for k in w_b) and torch.equal(ev_b, ev_j)


# K6 grid (C+1, P, E, padded lanes, ring dtype), as chip_smoke.py checks it:
# the MLP's blocked ring, a ragged P, and Mamba2-130M's ring at C=8 (P padded
# to a multiple of 1024) in fp32 and bf16
SCATTER_SHAPES = [
    (65, 26624, 8, 3, torch.float32),
    (65, 26624, 8, 3, torch.bfloat16),
    (65, 26122, 8, 3, torch.float32),
    (9, 128_984_064, 4, 0, torch.float32),
    (9, 128_984_064, 4, 0, torch.bfloat16),
]


@pytest.mark.parametrize("R,P,E,pad,dtype", SCATTER_SHAPES)
def test_block_scatter_rows_matches_plain(dev, R, P, E, pad, dtype):
    """K6 writes every ring row and w' bitwise as its plain version does
    (the same casts, in the same order: the trash row R-1 keeps the last
    padded lane's row), in one launch."""
    gen = torch.Generator().manual_seed(P + E)
    snaps = torch.randn((R, P), generator=gen).to(dev, dtype)
    w = torch.randn((P,), generator=gen).to(dev)
    W = torch.randn((E, P), generator=gen).to(dev)
    real = torch.randperm(R - 1, generator=gen)[: E - pad].tolist()
    slots = torch.tensor(real + [R - 1] * pad, device=dev)
    cuda_kernels.reset_launches()
    ks, kw = ops.block_scatter_rows(snaps.clone(), w, W, slots)
    assert cuda_kernels.launches["block_scatter_rows"] == 1
    rs, rw = ref.block_scatter_rows_ref(snaps.clone(), w, W, slots)
    torch.cuda.synchronize()
    assert torch.equal(ks, rs) and torch.equal(kw, rw) and kw.dtype == w.dtype


@pytest.mark.parametrize("dtype,w_dtype", [(torch.float32, torch.float32),
                                           (torch.bfloat16, torch.float32),
                                           (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("B", [1, 4, 27])
def test_block_scatter_rows_across_cells_bitwise(dev, B, dtype, w_dtype):
    """K6 over B cells, one launch: every cell's ring rows and w' bitwise
    equal to the plain version with a cell axis, to that cell's own launch
    and to a second launch; padded lanes on the trash row and a real row
    targeted twice."""
    R, P, E = 17, 26624, 8
    rng = np.random.default_rng(B)
    slots = np.stack([np.concatenate([rng.choice(R - 1, size=E - 3, replace=False),
                                      [R - 1, R - 1, R - 1]]) for _ in range(B)])
    slots[:, 1] = slots[:, 0]  # a real row twice: the later lane wins
    st = torch.tensor(slots, device=dev)
    gen = torch.Generator(device=dev).manual_seed(B)
    snaps = torch.randn((B, R, P), generator=gen, device=dev).to(dtype)
    w = torch.randn((B, P), generator=gen, device=dev).to(w_dtype)
    W = torch.randn((B, E, P), generator=gen, device=dev)
    rs, rw = ref.block_scatter_rows_ref(snaps.clone(), w, W, st)
    cuda_kernels.reset_launches()
    ks, kw = ops.block_scatter_rows(snaps.clone(), w, W, st)
    assert cuda_kernels.launches["block_scatter_rows"] == 1
    assert torch.equal(ks, rs) and torch.equal(kw, rw) and kw.shape == (B, P)
    again, again_w = cuda_kernels.block_scatter_rows(snaps.clone(), w, W, st)
    assert torch.equal(ks, again) and torch.equal(kw, again_w)
    for c in range(B):
        cs, cw = cuda_kernels.block_scatter_rows(snaps[c].clone(), w[c], W[c], st[c])
        assert torch.equal(ks[c], cs) and torch.equal(kw[c], cw)


# slot patterns on a ring of 9 rows (trash row 8): padded lanes, a real row
# targeted twice, every lane on the trash row; E in {1, 8, 16}
LIVE_PATTERNS = [
    [3],
    [8],
    [3, 1, 3, 5, 8, 2, 8, 1],
    [8] * 8,
    [8] * 16,
    [5, 5, 5, 5, 2, 2, 8, 8, 8, 8, 7, 6, 5, 4, 3, 8],
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("slots", LIVE_PATTERNS)
def test_block_scatter_rows_over_duplicate_slots(dev, dtype, slots):
    """K6 writes only the live lanes (`live_lanes`): the ring and w' equal
    the plain version's (every lane in event order) bitwise, twice."""
    E, P = len(slots), 4096
    gen = torch.Generator().manual_seed(E)
    snaps = torch.randn((9, P), generator=gen).to(dev, dtype)
    w = torch.randn((P,), generator=gen).to(dev)
    W = torch.randn((E, P), generator=gen).to(dev)
    st = torch.tensor(slots, device=dev)
    ks, kw = cuda_kernels.block_scatter_rows(snaps.clone(), w, W, st)
    again, again_w = cuda_kernels.block_scatter_rows(snaps.clone(), w, W, st)
    rs, rw = ref.block_scatter_rows_ref(snaps.clone(), w, W, st)
    torch.cuda.synchronize()
    assert torch.equal(ks, rs) and torch.equal(kw, rw)
    assert torch.equal(ks, again) and torch.equal(kw, again_w)


@pytest.mark.parametrize("dtype,P,offset,vec", [
    (torch.float32, 4096, 0, 4), (torch.bfloat16, 4096, 0, 8), (torch.float32, 26122, 0, 1),
    (torch.bfloat16, 26122, 0, 1), (torch.float32, 4099, 0, 1), (torch.float32, 4096, 1, 1),
    (torch.bfloat16, 4096, 2, 1),
])
def test_block_scatter_rows_access_width(dev, dtype, P, offset, vec):
    """The library moves 16 bytes of ring values an access where P and the
    alignment of the ring allow it, and one value otherwise; both widths
    give the plain version's bits."""
    gen = torch.Generator().manual_seed(P)
    snaps = torch.randn((5, P), generator=gen).to(dev, dtype)
    if offset:
        snaps = _misaligned(snaps, offset)
    w = torch.randn((P,), generator=gen).to(dev)
    W = torch.randn((3, P), generator=gen).to(dev)
    st = torch.tensor([2, 4, 4], device=dev)
    assert cuda_kernels.scatter_vec(snaps, W) == vec
    rs, rw = ref.block_scatter_rows_ref(snaps.clone(), w, W, st)
    ks, kw = cuda_kernels.block_scatter_rows(snaps, w, W, st)  # in place: keeps the offset
    assert torch.equal(ks, rs) and torch.equal(kw, rw)


@pytest.mark.parametrize("dtype,vec", [(torch.float32, 4), (torch.float32, 1),
                                       (torch.bfloat16, 8), (torch.bfloat16, 1)])
def test_block_scatter_rows_kernels_do_not_spill(dev, dtype, vec):
    info = cuda_kernels.scatter_kernel_info(dtype, vec)
    assert info["local_bytes"] == 0 and info["registers"] > 0 and info["ctas_per_sm"] >= 8


def _setup(dev, n=16, hidden=32):
    data = FederatedClassification(n_clients=n, seed=0)
    setup = fl._cached_fl_setup(data, 0, fl.ClassificationTask(hidden=hidden), device=dev)
    mu = make_client_speeds(n, 0.5, 10.0, seed=0)
    return setup, mu


def test_per_event_kernel_path_matches_plain_path(dev):
    setup, mu = _setup(dev)
    cfg = ServerConfig(n=16, C=4, T=300, eta=0.05, mu=mu, eval_every=100, engine="scan",
                       device="cuda")
    cuda_kernels.reset_launches()
    w_k, tr_k = run_generalized_async_sgd(setup.params, setup.clients,
                                          replace(cfg, update="pallas"), eval_fn=setup.eval_fn)
    # one launch an event, covering the MLP's 6 leaves
    assert cuda_kernels.launches["weighted_update"] == 300
    assert cuda_kernels.launches["weighted_update_leaves"] == 300 * 6
    w_p, tr_p = run_generalized_async_sgd(setup.params, setup.clients, cfg,
                                          eval_fn=setup.eval_fn)
    assert max(_err(w_k[k], w_p[k]) for k in w_k) <= 1e-5
    assert tr_k.eval_values == tr_p.eval_values


def test_blocked_kernel_path_matches_plain_path(dev):
    setup, mu = _setup(dev)
    cfg = ServerConfig(n=16, C=4, T=300, eta=0.05, mu=mu, eval_every=100, engine="scan",
                       block_size=4, device="cuda")
    stream = export_stream(SimConfig(mu=mu, p=np.full(16, 1 / 16), C=4, T=300))
    rows = blocked_inputs(EventBlocks.from_stream(stream, 4, cut_every=100),
                          step_scales(stream, 0.05, np.full(16, 1 / 16), "importance"),
                          100)[0].shape[0]
    cuda_kernels.reset_launches()
    w_k, _ = run_generalized_async_sgd(setup.params, setup.clients,
                                       replace(cfg, update="pallas"), eval_fn=setup.eval_fn)
    assert cuda_kernels.launches["block_prefix_update"] == rows
    w_p, _ = run_generalized_async_sgd(setup.params, setup.clients, cfg,
                                       eval_fn=setup.eval_fn)
    assert max(_err(w_k[k], w_p[k]) for k in w_k) <= 1e-5
    w_e, _ = run_generalized_async_sgd(setup.params, setup.clients,
                                       replace(cfg, block_size=1, T=150, eval_every=0))
    w_b, _ = run_generalized_async_sgd(setup.params, setup.clients,
                                       replace(cfg, update="pallas", T=150, eval_every=0))
    assert max(_err(w_e[k], w_b[k]) for k in w_e) <= 1e-4


def test_fedbuff_kernel_paths_match_plain_path(dev):
    """FedBuff (Z=5) on the card: per event with K1 (one launch), blocked (E=4)
    with K2, against the plain flat update, the Python loop and each other."""
    from repro_torch.core.async_sgd import run_fedbuff

    setup, mu = _setup(dev)
    cfg = ServerConfig(n=16, C=4, T=300, eta=0.05, mu=mu, eval_every=100, engine="scan",
                       device="cuda")
    run = lambda c: run_fedbuff(setup.params, setup.clients, c, Z=5,  # noqa: E731
                                eval_fn=setup.eval_fn)
    u = np.full(16, 1 / 16)  # FedBuff samples uniformly
    stream = export_stream(SimConfig(mu=mu, p=u, C=4, T=300))
    rows = blocked_inputs(EventBlocks.from_stream(stream, 4, cut_every=100),
                          step_scales(stream, 0.05, u, "plain"), 100)[0].shape[0]
    cuda_kernels.reset_launches()
    w_k1, tr_k1 = run(replace(cfg, update="pallas"))
    assert cuda_kernels.launches["weighted_update"] == 300
    assert cuda_kernels.launches["weighted_update_leaves"] == 300 * 6
    w_k2, tr_k2 = run(replace(cfg, update="pallas", block_size=4))
    assert cuda_kernels.launches["block_prefix_update"] == rows
    w_p, tr_p = run(cfg)
    assert max(_err(w_k1[k], w_p[k]) for k in w_p) <= 1e-5
    assert tr_k1.eval_values == tr_p.eval_values
    assert max(abs(a - b) for a, b in zip(tr_k2.eval_values, tr_p.eval_values)) <= 10 / 2048
    small = replace(cfg, T=150, eval_every=0)
    w_py, _ = run(replace(small, engine="python"))
    w_e, _ = run(replace(small, update="pallas"))
    w_b, _ = run(replace(small, update="pallas", block_size=4))
    assert max(_err(w_py[k], w_e[k]) for k in w_py) <= 1e-5
    assert max(_err(w_py[k], w_b[k]) for k in w_py) <= 1e-4


def test_engine_matches_python_oracle_on_card(dev):
    setup, mu = _setup(dev)
    cfg = ServerConfig(n=16, C=4, T=150, eta=0.05, mu=mu, device="cuda")
    w_py, _ = run_generalized_async_sgd(setup.params, setup.clients, cfg)
    w_sc, _ = run_generalized_async_sgd(setup.params, setup.clients,
                                        replace(cfg, engine="scan", update="pallas"))
    assert max(_err(w_py[k], w_sc[k]) for k in w_py) <= 1e-5


# K3 shapes (B, S, H, K, D, T, window, q_offset), as chip_smoke.py checks them:
# the grid of tests/test_kernels.py, the LM path shapes (Granite-3.0-2B's,
# Qwen1.5-MoE-A2.7B's), a long causal sequence with and without a window, D=80
# and D=128 with ragged S and T, rows whose every key is masked (T a multiple
# of the key tile or not), and windows that let the tensor-core kernel skip
# key tiles, beside rows masked on every key
FA_PATH_SHAPES = [(8, 128, 32, 8, 64, 128, 0, 0), (8, 128, 16, 16, 128, 128, 0, 0)]
FA_SHAPES = [
    (2, 128, 4, 2, 64, 128, 0, 0),
    (1, 256, 8, 4, 64, 256, 64, 0),
    (1, 64, 4, 1, 128, 64, 0, 0),
    (1, 128, 4, 4, 128, 384, 0, 256),
    (2, 64, 6, 2, 32, 64, 16, 0),
    *FA_PATH_SHAPES,
    (1, 2048, 32, 8, 64, 2048, 0, 0),
    (1, 2048, 32, 8, 64, 2048, 512, 0),
    (2, 100, 8, 2, 80, 100, 0, 0),
    (1, 200, 4, 2, 128, 333, 0, 133),
    (1, 64, 4, 2, 64, 64, 16, 200),
    (1, 40, 2, 1, 64, 50, 8, 100),
    (1, 512, 8, 2, 64, 512, 96, 0),
    (2, 200, 8, 2, 80, 200, 70, 0),
    (1, 192, 4, 2, 128, 256, 40, 100),
    (1, 128, 4, 2, 64, 128, 16, 120),
]


def _qkv(dev, dtype, B, S, H, K, D, T, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen).to(dev, dtype)
                 for shape in ((B, S, H, D), (B, T, K, D), (B, T, K, D)))


def _misaligned(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts ``offset`` elements into its
    storage (not 16-byte aligned for an offset that is not a multiple of
    16 bytes)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    buf[offset:].copy_(t.reshape(-1))
    return buf[offset:].view(t.shape)


def _close(a, b, tol) -> bool:
    """allclose with atol = rtol = tol (tests/test_kernels.py's rule)."""
    return bool(((a.float() - b.float()).abs() <= tol + tol * b.float().abs()).all())


FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # tests/test_kernels.py's


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,D,T,window,q_offset", FA_SHAPES)
def test_flash_attention_matches_plain(dev, dtype, B, S, H, K, D, T, window, q_offset):
    q, k, v = _qkv(dev, dtype, B, S, H, K, D, T)
    fa.reset_launches()
    out = fa.flash_attention_fwd(q, k, v, causal=True, window=window, q_offset=q_offset)
    exp = ref.flash_attention_ref(q, k, v, causal=True, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention"] == 1
    assert out.dtype == dtype and out.shape == exp.shape
    assert _close(out, exp, FA_TOL[dtype]), _err(out, exp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FA_PATH_SHAPES + [(1, 192, 4, 2, 128, 256, 40, 100),
                                                    (2, 100, 8, 2, 80, 100, 0, 0)])
def test_flash_attention_launches_repeat_bitwise(dev, dtype, shape):
    """No atomics and a fixed order of summation: two launches on the same
    inputs give the same bits."""
    B, S, H, K, D, T, window, q_offset = shape
    q, k, v = _qkv(dev, dtype, B, S, H, K, D, T, seed=3)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    assert torch.equal(fa.flash_attention_fwd(q, k, v, **kw), fa.flash_attention_fwd(q, k, v, **kw))


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, D) for D in fa.TC_HEAD_DIMS]
                         + [(torch.bfloat16, 96), (torch.float32, 64)])
def test_flash_attention_kernels_do_not_spill(dev, dtype, D):
    info = fa.kernel_info(dtype, D)
    assert info["local_bytes"] == 0 and info["registers"] > 0
    assert info["static_smem"] + info["dynamic_smem"] <= 227 * 1024


@pytest.mark.parametrize("dtype,D,offset,tc", [
    (torch.bfloat16, 64, 0, True), (torch.bfloat16, 80, 0, True),
    (torch.bfloat16, 128, 0, True), (torch.bfloat16, 32, 0, True),
    (torch.bfloat16, 96, 0, False), (torch.bfloat16, 64, 1, False),
    (torch.float32, 64, 0, False), (torch.float32, 128, 0, False),
])
def test_flash_attention_route_follows_the_dispatch(dev, dtype, D, offset, tc):
    """The library reports the tensor-core tile for bf16 at `TC_HEAD_DIMS`
    with 16-byte aligned operands and the CUDA-core tile otherwise, and the
    kernel it takes equals the plain version."""
    q, k, v = _qkv(dev, dtype, 1, 64, 4, 2, D, 96, seed=5)
    if offset:
        q = _misaligned(q, offset)
    out = fa.flash_attention_fwd(q, k, v, window=40, q_offset=32)
    assert fa.kernel_tiles(q, k, v, out, 40, 32) == (fa.TC_TILE if tc else fa.SIMPLE_TILE)
    exp = ref.flash_attention_ref(q, k, v, window=40, q_offset=32)
    assert _close(out, exp, FA_TOL[dtype]), _err(out, exp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_grads_match_reference(dev, dtype):
    """Grads through `FlashAttention` (kernel forward, reference VJP) vs
    grads through the reference, with a linear probe loss so the cotangent
    does not depend on the forward's rounding (tests/test_lm_engine.py)."""
    q, k, v = _qkv(dev, dtype, 2, 128, 8, 2, 64, 128)
    probe = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)).to(dev)

    def loss(fn):
        return lambda q, k, v: torch.sum(fn(q, k, v).float() * probe)

    gk = torch.func.grad(loss(ops.flash_attention), argnums=(0, 1, 2))(q, k, v)
    gr = torch.func.grad(loss(ref.flash_attention_ref), argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(gk, gr):
        assert a.dtype == b.dtype and _close(a, b, FA_TOL[dtype])


def test_flash_attention_vmap_is_one_launch(dev):
    q, k, v = _qkv(dev, torch.float32, 2, 64, 4, 2, 64, 64)
    qs, ks, vs = (torch.stack([x, 0.5 * x, -x]) for x in (q, k, v))
    fa.reset_launches()
    out = torch.func.vmap(ops.flash_attention)(qs, ks, vs)
    assert fa.launches["flash_attention"] == 1
    for i in range(3):
        assert _close(out[i], ref.flash_attention_ref(qs[i], ks[i], vs[i]), 2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_loss_and_grads_kernel_vs_plain(dev, dtype):
    """Granite's smoke config: loss and grads with the kernel (use_pallas)
    against the plain attention, one K3 launch per layer per forward."""
    cfg = smoke_config("granite-3-2b").replace(dtype=dtype)
    params = init_params(api.model_meta(cfg), 0, dev)
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 32), generator=gen).to(dev)
             for k in ("tokens", "labels")}
    grads = {}
    for use_pallas in (True, False):
        c = cfg.replace(use_pallas=use_pallas)
        fa.reset_launches()
        grads[use_pallas] = torch.func.grad_and_value(
            lambda p: api.loss_fn(p, batch, c)[0])(params)
        assert fa.launches["flash_attention"] == (cfg.num_layers if use_pallas else 0)
    (gk, lk), (gp, lp) = grads[True], grads[False]
    # loss relative, grads against each leaf's largest entry: fp32 as
    # chip_smoke.py's full-width check, bf16 loose (10 bf16 ulps)
    tol_loss, tol_grad = (1e-5, 1e-4) if dtype == "float32" else (2e-2, 4e-2)
    assert abs(float(lk) - float(lp)) <= tol_loss * abs(float(lp))
    for a, b in zip(tree_leaves(gk), tree_leaves(gp)):
        assert _err(a, b) <= tol_grad * float(b.float().abs().max())


# K4 shapes (B, S, H, P, N, chunk, A range, dt range), as chip_smoke.py checks
# them: the grid of tests/test_kernels.py, Mamba2-130M's path shape and the
# same folded to B=32 (blocked E=4), Zamba2-2.7B's shape, a long sequence (32
# chunks of carried state), S < chunk, and the overflow case (A in -[1, 16],
# dt up to 1: the masked exp(cs_i - cs_j) is inf)
SSD_SHAPES = [
    (2, 128, 3, 32, 16, 32, (0.5, 2.0), (0.01, 0.2)),
    (1, 64, 2, 64, 128, 64, (0.5, 2.0), (0.01, 0.2)),
    (1, 256, 4, 16, 8, 16, (0.5, 2.0), (0.01, 0.2)),
    (8, 128, 24, 64, 128, 64, (1.0, 16.0), (0.001, 0.1)),
    (32, 128, 24, 64, 128, 64, (1.0, 16.0), (0.001, 0.1)),
    (2, 128, 80, 64, 64, 64, (1.0, 16.0), (0.001, 0.1)),
    (1, 2048, 24, 64, 128, 64, (1.0, 16.0), (0.001, 0.1)),
    (2, 40, 4, 32, 16, 64, (0.5, 2.0), (0.01, 0.2)),
    (2, 128, 3, 32, 16, 64, (1.0, 16.0), (0.0, 1.0)),
]
SSD_STATE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}  # tests/test_kernels.py's


def _ssd_inputs(dev, dtype, B, S, H, P, N, a_range, dt_range, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((B, S, H, P), generator=gen).to(dev, dtype)
    dt = (dt_range[0] + (dt_range[1] - dt_range[0]) * torch.rand((B, S, H), generator=gen)).to(dev)
    A = -(a_range[0] + (a_range[1] - a_range[0]) * torch.rand((H,), generator=gen)).to(dev)
    Bm = torch.randn((B, S, N), generator=gen).to(dev, dtype)
    Cm = torch.randn((B, S, N), generator=gen).to(dev, dtype)
    return x, dt, A, Bm, Cm


def _state_ok(s, e, tol) -> bool:
    """The state within ``tol`` relative to its magnitude (at least 1)."""
    return _err(s, e) <= tol * max(1.0, float(e.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,chunk,a_range,dt_range", SSD_SHAPES)
def test_ssd_scan_matches_plain(dev, dtype, B, S, H, P, N, chunk, a_range, dt_range):
    x, dt, A, Bm, Cm = _ssd_inputs(dev, dtype, B, S, H, P, N, a_range, dt_range)
    k4.reset_launches()
    y, s = k4.ssd_scan_fwd(x, dt, A.expand(B, H), Bm, Cm, chunk)
    ey, es = ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk)
    torch.cuda.synchronize()
    assert k4.launches["ssd_scan"] == 1
    assert y.dtype == dtype and s.dtype == torch.float32 and s.shape == (B, H, N, P)
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(s).all())
    assert _close(y, ey, FA_TOL[dtype]), _err(y, ey)
    assert _state_ok(s, es, SSD_STATE_TOL[dtype]), _err(s, es)


@pytest.mark.parametrize("B,S,H,P,N,chunk,a_range,dt_range", SSD_SHAPES)
def test_ssd_scan_launches_repeat_bitwise(dev, B, S, H, P, N, chunk, a_range, dt_range):
    """No atomics: two bf16 launches give the same bits, on either kernel."""
    x, dt, A, Bm, Cm = _ssd_inputs(dev, torch.bfloat16, B, S, H, P, N, a_range, dt_range, seed=2)
    A = A.expand(B, H).contiguous()
    y, s = k4.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk)
    y2, s2 = k4.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk)
    assert torch.equal(y, y2) and torch.equal(s, s2)


@pytest.mark.parametrize("dtype,shape,offset,route", [
    (torch.bfloat16, (8, 128, 24, 64, 128, 64), 0, "tc"),
    (torch.bfloat16, (2, 128, 80, 64, 64, 64), 0, "tc"),
    (torch.bfloat16, (2, 40, 4, 32, 16, 64), 0, "tc"),
    (torch.bfloat16, (1, 256, 4, 16, 8, 16), 0, "tc"),
    (torch.bfloat16, (1, 64, 2, 64, 128, 64), 1, "simt"),
    (torch.bfloat16, (1, 64, 2, 36, 16, 64), 0, "simt"),
    (torch.float32, (1, 64, 2, 64, 128, 64), 0, "simt"),
])
def test_ssd_scan_route_follows_the_dispatch(dev, dtype, shape, offset, route):
    """The library takes the tensor-core kernel for bf16 at the shapes of
    `ssd_scan.route` with 16-byte aligned x, B and C, and the CUDA-core
    kernel otherwise; the kernel it takes equals the plain version."""
    B, S, H, P, N, chunk = shape
    x, dt, A, Bm, Cm = _ssd_inputs(dev, dtype, B, S, H, P, N, (0.5, 2.0), (0.01, 0.2), seed=3)
    if offset:
        x = _misaligned(x, offset)
    Q = min(chunk, S)
    assert k4.kernel_route(x, Bm, Cm, chunk) == route
    assert k4.route(dtype, Q, N, P) == ("tc" if route == "tc" or offset else "simt")
    y, s = k4.ssd_scan_fwd(x, dt, A.expand(B, H), Bm, Cm, chunk)
    ey, es = ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk)
    assert _close(y, ey, FA_TOL[dtype]), _err(y, ey)
    assert _state_ok(s, es, SSD_STATE_TOL[dtype]), _err(s, es)


@pytest.mark.parametrize("dtype,N", [(torch.bfloat16, 128), (torch.bfloat16, 64),
                                     (torch.float32, 128)])
def test_ssd_scan_kernels_do_not_spill(dev, dtype, N):
    """Neither kernel spills; `kernel_info` names the kernel the Python
    mirror's route names; the tensor-core kernel's shared memory is the
    Python mirror's, and two of its CTAs fit on an SM."""
    info = k4.kernel_info(dtype, 64, N, 64)
    assert info["local_bytes"] == 0 and info["registers"] > 0
    assert info["kernel"] == k4.route(dtype, 64, N, 64)
    if info["kernel"] == "tc":
        assert info["dynamic_smem"] == k4.tc_smem_bytes(N)
        assert info["ctas_per_sm"] >= 2
    else:
        assert info["dynamic_smem"] == k4.smem_bytes(64, N, 64)


def test_ssd_scan_init_state_raises_on_card(dev):
    """With a state, `ops.ssd_scan` on the card takes the plain version, as
    the reference's dispatch does on every backend, and launches no K4.
    (The name is kept from when the port raised here instead.)"""
    x, dt, A, Bm, Cm = _ssd_inputs(dev, torch.float32, 1, 64, 2, 16, 8, (0.5, 2.0), (0.01, 0.2))
    h0 = torch.randn((1, 2, 8, 16), generator=torch.Generator().manual_seed(2)).to(dev)
    k4.reset_launches()
    y, s = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=32, init_state=h0)
    ey, es = ref.ssd_scan_ref(x, dt, A, Bm, Cm, 32, h0)
    torch.cuda.synchronize()
    assert k4.launches["ssd_scan"] == 0
    assert torch.equal(y, ey) and torch.equal(s, es)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_grads_match_reference(dev, dtype):
    """Grads of all five inputs through `SSDScan` (kernel forward, reference
    VJP) vs grads through the reference, linear probe loss on both outputs."""
    args = _ssd_inputs(dev, dtype, 2, 128, 4, 32, 16, (0.5, 2.0), (0.01, 0.2))
    gen = torch.Generator().manual_seed(1)
    py = torch.randn((2, 128, 4, 32), generator=gen).to(dev)
    ps = torch.randn((2, 4, 16, 32), generator=gen).to(dev)

    def loss(fn):
        def f(*a):
            y, s = fn(*a, chunk=32)
            return torch.sum(y.float() * py) + torch.sum(s * ps)
        return f

    gk = torch.func.grad(loss(ops.ssd_scan), argnums=(0, 1, 2, 3, 4))(*args)
    gr = torch.func.grad(loss(ref.ssd_scan_ref), argnums=(0, 1, 2, 3, 4))(*args)
    for a, b in zip(gk, gr):
        assert a.dtype == b.dtype and _close(a, b, FA_TOL[dtype]), _err(a, b)


def test_ssd_scan_vmap_is_one_launch(dev):
    """A batched A (one per lane, as the blocked engine's snapshots give):
    one launch over the folded lanes, equal to a loop."""
    x, dt, A, Bm, Cm = _ssd_inputs(dev, torch.float32, 2, 128, 4, 32, 16, (0.5, 2.0), (0.01, 0.2))
    xs, dts, Bs, Cs = (torch.stack([t, 0.5 * t, 2.0 * t]) for t in (x, dt, Bm, Cm))
    As = torch.stack([A, 2.0 * A, 0.25 * A])
    k4.reset_launches()
    y, s = torch.func.vmap(lambda *a: ops.ssd_scan(*a, chunk=64))(xs, dts, As, Bs, Cs)
    assert k4.launches["ssd_scan"] == 1
    for i in range(3):
        ey, es = ref.ssd_scan_ref(xs[i], dts[i], As[i], Bs[i], Cs[i], chunk=64)
        assert _close(y[i], ey, 2e-5) and _state_ok(s[i], es, 1e-4)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_loss_and_grads_kernel_vs_plain(dev, arch, dtype):
    """The Mamba2 and Zamba2 smoke configs: loss and grads with the kernels
    (use_pallas) against the plain versions; one K4 launch per Mamba2 layer
    and one K3 launch per shared-block site per forward."""
    from repro_torch.models import hybrid

    cfg = smoke_config(arch).replace(dtype=dtype)
    sites = hybrid.num_shared_sites(cfg) if cfg.family == "hybrid" else 0
    params = init_params(api.model_meta(cfg), 0, dev)
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 32), generator=gen).to(dev)
             for k in ("tokens", "labels")}
    grads = {}
    for use_pallas in (True, False):
        c = cfg.replace(use_pallas=use_pallas)
        k4.reset_launches()
        fa.reset_launches()
        grads[use_pallas] = torch.func.grad_and_value(
            lambda p: api.loss_fn(p, batch, c)[0])(params)
        assert k4.launches["ssd_scan"] == (cfg.num_layers if use_pallas else 0)
        assert fa.launches["flash_attention"] == (sites if use_pallas else 0)
    (gk, lk), (gp, lp) = grads[True], grads[False]
    tol_loss, tol_grad = (1e-5, 1e-4) if dtype == "float32" else (2e-2, 4e-2)
    assert abs(float(lk) - float(lp)) <= tol_loss * abs(float(lp))
    for a, b in zip(tree_leaves(gk), tree_leaves(gp)):
        assert _err(a, b) <= tol_grad * float(b.float().abs().max())


@pytest.mark.parametrize("arch", ["mamba2-130m", "granite-3-2b"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_grads_with_the_kernels_equal_none(dev, arch, remat):
    """bf16 smoke configs with the kernels (K4, K3): the loss and gradients
    at ``remat`` bitwise those at "none", under `grad` and `vmap(grad)` over
    two parameter rows; the recompute runs each block's kernel a second
    time."""
    from repro_torch.tree import tree_map

    cfg = smoke_config(arch).replace(dtype="bfloat16", use_pallas=True)
    params = init_params(api.model_meta(cfg), 0, dev)
    rows = tree_map(lambda x: torch.stack([x, (x.float() * 1.01).to(x.dtype)]), params)
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 64), generator=gen).to(dev)
             for k in ("tokens", "labels")}
    out, counts = {}, {}
    for r in ("none", remat):
        c = cfg.replace(remat=r)
        k4.reset_launches()
        fa.reset_launches()
        fn = torch.func.grad_and_value(lambda p: api.loss_fn(p, batch, c)[0])
        out[r] = (fn(params), torch.func.vmap(fn)(rows))
        torch.cuda.synchronize()
        counts[r] = k4.launches["ssd_scan"] + fa.launches["flash_attention"]
    assert counts["none"] == 2 * cfg.num_layers and counts[remat] == 2 * counts["none"]
    for a, b in zip(tree_leaves(out["none"]), tree_leaves(out[remat])):
        assert torch.equal(a, b)


# K5 shapes (E, C, D, F), as chip_smoke.py checks them: Qwen1.5-MoE-A2.7B's
# path shapes (capacity 88; gate/up, then down), the grid of
# tests/test_kernels.py, a ragged capacity, C over two 128-row slabs with D
# and F that rule out 16-byte loads, and Arctic's per-expert shape at 16 of
# its 128 experts (capacity 12 from a group of 512 tokens, top-2)
GMM_SHAPES = [
    (60, 88, 2048, 1408),
    (60, 88, 1408, 2048),
    (4, 256, 128, 256),
    (2, 128, 256, 128),
    (8, 64, 64, 64),
    (4, 20, 256, 128),
    (3, 130, 100, 70),
]
GMM_ARCTIC = (16, 12, 7168, 4864)


def _gmm_inputs(dev, dtype, E, C, D, F, seed=0):
    """x unit normal, w normal with std 1/sqrt(D) (the experts' fan-in
    init), so y is O(1) as on the path."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((E, C, D), generator=gen).to(dev, dtype)
    w = (torch.randn((E, D, F), generator=gen) / np.sqrt(D)).to(dev, dtype)
    return x, w


@pytest.mark.parametrize("dtype,shape", [(d, s) for d in (torch.float32, torch.bfloat16)
                                         for s in GMM_SHAPES] + [(torch.bfloat16, GMM_ARCTIC)])
def test_moe_gmm_matches_plain(dev, dtype, shape):
    x, w = _gmm_inputs(dev, dtype, *shape)
    k5.reset_launches()
    y = k5.moe_gmm_fwd(x, w)
    e = ref.moe_gmm_ref(x, w)
    torch.cuda.synchronize()
    assert k5.launches["moe_gmm"] == 1
    assert y.dtype == dtype and y.shape == e.shape
    assert bool(torch.isfinite(y.float()).all())
    assert _close(y, e, FA_TOL[dtype]), _err(y, e)


@pytest.mark.parametrize("dtype,shape", [(torch.bfloat16, s) for s in GMM_SHAPES[:2]]
                         + [(torch.bfloat16, (3, 130, 100, 70)), (torch.float32, GMM_SHAPES[0])])
def test_moe_gmm_launches_repeat_bitwise(dev, dtype, shape):
    """No atomics and no split of D: two launches give the same bits."""
    x, w = _gmm_inputs(dev, dtype, *shape, seed=4)
    assert torch.equal(k5.moe_gmm_fwd(x, w), k5.moe_gmm_fwd(x, w))


@pytest.mark.parametrize("dtype,shape,offset,path", [
    (torch.bfloat16, (4, 20, 256, 128), 0, "tc"), (torch.bfloat16, (3, 130, 100, 70), 0, "scalar"),
    (torch.bfloat16, (4, 20, 256, 128), 1, "scalar"), (torch.float32, (4, 20, 256, 128), 0, "f32x4"),
    (torch.float32, (4, 20, 256, 128), 2, "f32"),
])
def test_moe_gmm_route_follows_the_dispatch(dev, dtype, shape, offset, path):
    """The library reports the wgmma kernel for bf16 with D, F % 8 == 0 and
    16-byte aligned x and w, and the kernel it takes equals the plain
    version."""
    x, w = _gmm_inputs(dev, dtype, *shape, seed=6)
    if offset:
        x = _misaligned(x, offset)
    assert k5.kernel_path(x, w) == path
    y, e = k5.moe_gmm_fwd(x, w), ref.moe_gmm_ref(x, w)
    assert _close(y, e, FA_TOL[dtype]), _err(y, e)


@pytest.mark.parametrize("dtype,vector", [(torch.bfloat16, True), (torch.bfloat16, False),
                                          (torch.float32, True)])
def test_moe_gmm_kernels_do_not_spill(dev, dtype, vector):
    info = k5.kernel_info(dtype, vector)
    assert info["local_bytes"] == 0 and info["registers"] > 0
    assert info["static_smem"] + info["dynamic_smem"] <= 227 * 1024


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gmm_grads_match_reference(dev, dtype):
    """Grads of x and w through `MoeGMM` (kernel forward, reference VJP) vs
    grads through the reference, linear probe loss."""
    x, w = _gmm_inputs(dev, dtype, 4, 20, 256, 128)
    probe = torch.randn((4, 20, 128), generator=torch.Generator().manual_seed(1)).to(dev)

    def loss(fn):
        return lambda x, w: torch.sum(fn(x, w).float() * probe)

    k5.reset_launches()
    gk = torch.func.grad(loss(ops.moe_gmm), argnums=(0, 1))(x, w)
    assert k5.launches["moe_gmm"] == 1
    gr = torch.func.grad(loss(ref.moe_gmm_ref), argnums=(0, 1))(x, w)
    for a, b in zip(gk, gr):
        assert a.dtype == b.dtype and _close(a, b, FA_TOL[dtype]), _err(a, b)


def test_moe_gmm_vmap_is_one_launch(dev):
    """x and w both mapped over 4 lanes (the blocked engine's case): one
    launch over the lanes folded into E, equal to a loop."""
    x, w = _gmm_inputs(dev, torch.bfloat16, 6, 24, 256, 128)
    xs = torch.stack([x, 0.5 * x, -x, x.flip(1)])
    ws = torch.stack([w, 2.0 * w, w.flip(0), -w])
    k5.reset_launches()
    y = torch.func.vmap(ops.moe_gmm)(xs, ws)
    assert k5.launches["moe_gmm"] == 1
    for i in range(4):
        assert _close(y[i], ref.moe_gmm_ref(xs[i], ws[i]), FA_TOL[torch.bfloat16])


def test_moe_gmm_wrapper_rejects_bad_operands(dev):
    x, w = _gmm_inputs(dev, torch.float32, 2, 16, 64, 32)
    with pytest.raises(TypeError, match="one dtype"):
        k5.moe_gmm_fwd(x, w.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        k5.moe_gmm_fwd(x.transpose(1, 2).contiguous().transpose(1, 2), w)
    with pytest.raises(ValueError, match="contiguous"):
        k5.moe_gmm_fwd(x, w[:, :, ::2])
    with pytest.raises(ValueError, match="one CUDA device"):
        k5.moe_gmm_fwd(x, w.cpu())


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "arctic-480b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_loss_and_grads_kernel_vs_plain(dev, arch, dtype):
    """The MoE smoke configs under the sort dispatch: loss and grads with
    the kernels (use_pallas: K3 and K5) against the plain versions; three
    K5 launches (gate, up, down) per MoE layer per forward."""
    cfg = smoke_config(arch).replace(dtype=dtype, moe_dispatch="sort")
    params = init_params(api.model_meta(cfg), 0, dev)
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 32), generator=gen).to(dev)
             for k in ("tokens", "labels")}
    grads = {}
    for use_pallas in (True, False):
        c = cfg.replace(use_pallas=use_pallas)
        k5.reset_launches()
        fa.reset_launches()
        grads[use_pallas] = torch.func.grad_and_value(
            lambda p: api.loss_fn(p, batch, c)[0])(params)
        assert k5.launches["moe_gmm"] == (3 * cfg.num_layers if use_pallas else 0)
        assert fa.launches["flash_attention"] == (cfg.num_layers if use_pallas else 0)
    (gk, lk), (gp, lp) = grads[True], grads[False]
    tol_loss, tol_grad = (1e-5, 1e-4) if dtype == "float32" else (2e-2, 4e-2)
    assert abs(float(lk) - float(lp)) <= tol_loss * abs(float(lp))
    if dtype == "float32":  # bf16: the loss only (a near-tied router choice may flip)
        for a, b in zip(tree_leaves(gk), tree_leaves(gp)):
            assert _err(a, b) <= tol_grad * float(b.float().abs().max())


# ------------------------------------------------------------------ #
# faults, the guard and checkpoints on the host stream, on the card
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("dtype,w_dtype", [(torch.float32, torch.float32),
                                           (torch.bfloat16, torch.float32),
                                           (torch.bfloat16, torch.bfloat16)])
def test_block_prefix_update_with_guard_and_fault_rows_bitwise(dev, dtype, w_dtype):
    """A guarded block of a fault stream: rows the guard zeroed (their slot
    live), scale-0 fault rows on live slots and flip / stage rows on the
    trash row C, among ordinary rows; K2 equals its plain version bitwise."""
    C, P, E = 64, 26624, 8
    gen = torch.Generator(device=dev).manual_seed(20)
    snaps = torch.randn((C + 1, P), generator=gen, device=dev).to(dtype)
    w = torch.randn((P,), generator=gen, device=dev).to(w_dtype)
    D = 0.01 * torch.randn((E, P), generator=gen, device=dev)
    D[1] = 0.0          # guard-zeroed (non-finite or over-norm gradient)
    D[[3, 4, 6]] = 0.0  # scale 0: a crash on slot 9, flip / stage rows on C
    slots = torch.tensor([5, 17, 2, 9, C, 40, C, 63], device=dev)
    rs, rw = ref.block_prefix_update_ref(snaps.clone(), w, D, slots)
    cuda_kernels.reset_launches()
    ks, kw = cuda_kernels.block_prefix_update(snaps.clone(), w, D, slots)
    assert cuda_kernels.launches["block_prefix_update"] == 1
    assert torch.equal(ks, rs) and torch.equal(kw, rw)


def test_guarded_fault_kernel_paths_match_plain_paths(dev):
    """The MLP with faults and the guard on the card: blocked with K2 bitwise
    ``update="jnp"``; the guard's counter and kind counts equal; a
    per-event fault stream (slot C on every flip) replays without a device
    assert and K1 per event (no guard) matches the flat update."""
    from repro_torch.core import FaultConfig, GuardConfig

    setup, mu = _setup(dev)
    cfg = ServerConfig(n=16, C=4, T=300, eta=0.05, mu=mu, eval_every=100, engine="scan",
                       device="cuda", faults=FaultConfig(0.2, 1.0, 0.05, 0.1))
    run = lambda c: run_generalized_async_sgd(setup.params, setup.clients, c,  # noqa: E731
                                              eval_fn=setup.eval_fn)
    guarded = replace(cfg, guard=GuardConfig(max_grad_norm=1e3, stale_cutoff=16))
    cuda_kernels.reset_launches()
    w_k, tr_k = run(replace(guarded, update="pallas", block_size=4))
    assert cuda_kernels.launches["block_prefix_update"] > 0
    w_j, tr_j = run(replace(guarded, block_size=4))
    assert all(torch.equal(w_k[k], w_j[k]) for k in w_k) and tr_k.eval_values == tr_j.eval_values
    assert tr_k.extras["guard_rejects"] == tr_j.extras["guard_rejects"] == 0
    assert tr_k.extras["stale_drops"] == tr_j.extras["stale_drops"] > 0
    w_e, tr_e = run(guarded)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(v).all()) for v in w_e.values())
    np.testing.assert_array_equal(tr_e.extras["kind_count"], tr_k.extras["kind_count"])
    w_k1, _ = run(replace(cfg, update="pallas"))
    w_f, _ = run(cfg)
    assert max(_err(w_k1[k], w_f[k]) for k in w_f) <= 1e-5


def test_bf16_ring_checkpoint_roundtrip_on_card(dev, tmp_path):
    """A CUDA bf16 ring (every bit pattern) and an fp32 w through
    `ckpt.save` / `restore`: bitwise, back on the card."""
    from repro_torch.ckpt import checkpoint as ck

    bits = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32).to(torch.int16)
    ring = bits.view(torch.bfloat16).reshape(2, -1).to(dev)
    w = torch.randn(1000, device=dev)
    ck.save(str(tmp_path), 7, {"ring": ring, "w": w})
    back = ck.restore(str(tmp_path), 7, {"ring": torch.empty_like(ring), "w": torch.empty_like(w)})
    assert back["ring"].is_cuda and back["ring"].dtype == torch.bfloat16
    assert torch.equal(back["ring"].view(torch.int16), ring.view(torch.int16))
    assert torch.equal(back["w"], w)


@pytest.mark.parametrize("block_size", [1, 4])
def test_checkpointed_resume_on_card_is_bitwise(dev, tmp_path, block_size):
    """The checkpointed MLP replay on the card with faults and the guard:
    truncated and resumed, bitwise the uninterrupted run, which is bitwise
    the un-checkpointed run (K2 blocked, bf16 ring per event)."""
    import shutil

    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.core import FaultConfig, GuardConfig

    setup, mu = _setup(dev)
    d = str(tmp_path / "ck")
    cfg = ServerConfig(n=16, C=4, T=300, eta=0.05, mu=mu, eval_every=100, engine="scan",
                       device="cuda", faults=FaultConfig(0.2, 1.0, 0.05, 0.1),
                       guard=GuardConfig(1e3, 16), block_size=block_size, update="pallas"
                       if block_size > 1 else "jnp", ckpt_dir=d, ckpt_every=100,
                       snapshot_dtype="bfloat16" if block_size == 1 else None)
    run = lambda c: run_generalized_async_sgd(setup.params, setup.clients, c,  # noqa: E731
                                              eval_fn=setup.eval_fn)
    w_full, tr_full = run(cfg)
    for s in ck.available_steps(d):
        if s > 100:
            shutil.rmtree(f"{d}/step_{s:010d}")
    w_res, tr_res = run(replace(cfg, resume=True))
    assert all(torch.equal(w_full[k], w_res[k]) for k in w_full)
    assert tr_full.eval_values == tr_res.eval_values
    if block_size > 1:
        w_0, tr_0 = run(replace(cfg, ckpt_dir=None, ckpt_every=0))
        assert all(torch.equal(w_full[k], w_0[k]) for k in w_full)
        assert tr_full.eval_values == tr_0.eval_values


# ------------------------------------------------------------------ #
# the device event stream on the card (the CPU side is held against the
# JAX package in tests/test_torch_stream.py and test_torch_fused.py)
# ------------------------------------------------------------------ #
def _stream_inputs(n, C, T, cells=None, seed=0):
    """Draws made on the CPU by the port's generator, so the card and the
    CPU run the same inputs (a CUDA and a CPU generator differ)."""
    from repro_torch.core import stream_device as sd

    p = np.random.default_rng(seed).uniform(0.5, 1.5, n)
    p /= p.sum()
    mu = np.random.default_rng(seed + 1).uniform(0.5, 4.0, n)
    draws = [sd.draw_uniforms(seed * 100 + b, n, C, T, p, device="cpu")
             for b in range(cells or 1)]
    nodes, ur, ue, ud = (torch.stack(a) for a in zip(*draws))
    pt = torch.tensor(p, dtype=torch.float32).expand(cells or 1, n)
    K = sd.tree_sample(sd.tree_build(pt), ud)
    mu_t = torch.tensor(mu, dtype=torch.float32).expand(cells or 1, n)
    out = [mu_t, nodes, ur, ue, K]
    return [a[0] for a in out] if cells is None else out


@pytest.mark.parametrize("cells", [None, 5])
def test_device_stream_on_card_equals_cpu(dev, cells):
    from repro_torch.core import stream_device as sd

    args = _stream_inputs(64, 16, 400, cells)
    n_c, ev_c, st_c = sd.scan_draws(*args)
    n_g, ev_g, st_g = sd.scan_draws(*(a.to(dev) for a in args))
    for i in (0, 1, 3, 4):  # J, K, slot, delay
        assert torch.equal(ev_g[i].cpu(), ev_c[i])
    torch.testing.assert_close(ev_g[2].cpu(), ev_c[2], rtol=1e-6, atol=0)
    for f in ("occ_sum", "comp", "slot_step"):
        assert torch.equal(getattr(st_g, f).cpu(), getattr(st_c, f))
    for f in ("occ_tw", "busy_t", "delay_sum"):
        torch.testing.assert_close(getattr(st_g, f).cpu(), getattr(st_c, f), rtol=1e-6,
                                   atol=1e-6)


def test_device_stream_chunk_makes_no_host_sync(dev):
    from repro_torch.core import stream_device as sd

    mu, nodes, ur, ue, K = (a.to(dev) for a in _stream_inputs(64, 16, 200, cells=3))
    state, _ = sd.stream_init(nodes, 64, 16)
    stats = sd.stats_init(64, 16, cells=3, device=dev)
    cst = sd._Consts((3,), 16, dev)
    e_hold = -torch.log1p(-ue)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        K2 = sd.tree_sample(sd.tree_build(torch.full((3, 64), 1 / 64, device=dev)), ur)
        sd._advance(state, stats, mu, e_hold, ur, K2, 0, cst)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def test_fused_chunk_makes_no_host_sync(dev):
    """One chunk of the fused runner itself, importance-weighted and
    adaptive: the stream, the dispatch-time slot scales, the MLP's per-event
    replay and the `ctrl_refresh` at the chunk's end, under the sync check."""
    from repro_torch.core import stream_device as sd
    from repro_torch.core.async_sgd import _device_grad_fn
    from repro_torch.core.engine_scan import make_fused_runner

    n, C, T = 16, 4, 200
    setup, mu = _setup(dev, n=n)
    p = np.full(n, 1.0 / n)
    run = make_fused_runner(_device_grad_fn(setup.clients), n, C, T, weighting="importance",
                            adaptive=True, refresh_every=T)
    draws = sd.draw_uniforms(3, n, C, T, p, device=dev)
    mu_g, p_g = (torch.tensor(a, dtype=torch.float32, device=dev) for a in (mu, p))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        w, _, ex = run.from_draws(setup.params, mu_g, p_g, 0.05, *draws)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(bool(torch.isfinite(v).all()) for v in w.values())
    assert ex["p_traj"].shape == (1, n) and abs(float(ex["p_final"].sum()) - 1.0) <= 1e-5


_ROBUST_FAULT = dict(off_rate=0.2, on_rate=1.0, crash_rate=0.05, timeout_rate=0.1)


def _robust_mode(mode):
    """``(fault, scenario)`` of a robust-stream test case."""
    from repro_torch.core import FaultConfig, get_scenario

    if mode == "fault":
        return FaultConfig(**_ROBUST_FAULT), None
    return None, get_scenario(mode)


@pytest.mark.parametrize("mode,cells", [("fault", None), ("fault", 5), ("erlang2_onoff", None),
                                        ("hyperexp2", None), ("onoff", 4)])
def test_fault_and_scenario_streams_on_card_equal_cpu(dev, mode, cells):
    """The fault and scenario streams on the card against the CPU on the
    same CPU-drawn uniforms: J, K, slot, delay, kind and the integer
    statistics equal, times and float statistics within 1e-6."""
    from repro_torch.core import stream_device as sd

    n, C, T = 64, 16, 400
    fault, scenario = _robust_mode(mode)
    mu, nodes, ur, ue, K = _stream_inputs(n, C, T, cells)
    lead = () if cells is None else (cells,)
    gen = torch.Generator().manual_seed(7)
    u_ph = torch.rand(*lead, T, generator=gen) if scenario else None
    u0 = torch.rand(*lead, C, generator=gen) if scenario else None
    args = (mu, nodes, ur, ue, K)
    on = lambda d: dict(fault=fault, scenario=scenario,  # noqa: E731
                        u_ph=None if u_ph is None else u_ph.to(d),
                        u_phase0=None if u0 is None else u0.to(d))
    _, ev_c, st_c = sd.scan_draws(*args, **on("cpu"))
    _, ev_g, st_g = sd.scan_draws(*(a.to(dev) for a in args), **on(dev))
    for i in (0, 1, 3, 4, 5):  # J, K, slot, delay, kind
        assert torch.equal(ev_g[i].cpu(), ev_c[i])
    torch.testing.assert_close(ev_g[2].cpu(), ev_c[2], rtol=1e-6, atol=0)
    for f in ("occ_sum", "comp", "slot_step", "kind_count"):
        assert torch.equal(getattr(st_g, f).cpu(), getattr(st_c, f))
    for f in ("occ_tw", "busy_t", "delay_sum", "avail_tw"):
        torch.testing.assert_close(getattr(st_g, f).cpu(), getattr(st_c, f), rtol=1e-6,
                                   atol=1e-6)
    assert int(st_c.kind_count.sum()) == T * (cells or 1)


def _sparse_inputs(n: int, C: int, T: int, mode: str, cells=None):
    """A two-class population (`tests/test_scale.py`'s mix) and one sparse
    stream's CPU-drawn uniforms: ``(spec, mu_m, args, kw)`` for
    `stream_device.sparse_scan_draws`."""
    from repro_torch.core import FaultConfig, get_scenario
    from repro_torch.core import stream_device as sd

    mu = np.where(np.random.default_rng(7).random(n) < 0.3, 2.5, 1.0)
    spec, mu_m, p_m = sd.build_class_spec(mu)
    fault = FaultConfig(**_ROBUST_FAULT) if mode == "fault" else None
    scenario = get_scenario(mode) if mode not in ("plain", "fault") else None
    draws = [sd.draw_sparse_uniforms(s, spec, C, T, p_m, device="cpu", fault=fault is not None,
                                     scenario=scenario is not None) for s in range(cells or 1)]
    nodes, ur, ue, ud, um, *rest = (torch.stack(a) if cells else a[0] for a in zip(*draws))
    p_t = torch.tensor(p_m, dtype=torch.float32)
    K = sd.sample_dispatch_classes(p_t.expand(cells, -1) if cells else p_t, spec, ud, um)
    args = (torch.tensor(mu_m, dtype=torch.float32), nodes, ur, ue, K, *rest)
    return spec, args, dict(fault=fault, scenario=scenario)


@pytest.mark.parametrize("n,mode,cells", [(1000, "plain", None), (1_000_000, "plain", None),
                                          (1_000_000, "fault", None), (1000, "fault", 3),
                                          (1000, "erlang2_onoff", None)])
def test_sparse_stream_on_card_equals_cpu(dev, n, mode, cells):
    """The sparse stream on the card against the CPU on the same CPU-drawn
    uniforms: J, K, slot, delay (and kind) and the integer statistics
    equal, times and float statistics within 1e-6."""
    from repro_torch.core import stream_device as sd

    spec, args, kw = _sparse_inputs(n, 16, 300, mode, cells)
    _, ev_c, st_c, _ = sd.sparse_scan_draws(args[0], spec, *args[1:], **kw)
    _, ev_g, st_g, _ = sd.sparse_scan_draws(args[0].to(dev), sd._spec_on(spec, dev),
                                            *(a.to(dev) for a in args[1:]), **kw)
    tagged = mode != "plain"
    for i in (0, 1, 3, 4) + ((5,) if tagged else ()):  # J, K, slot, delay, kind
        assert torch.equal(ev_g[i].cpu(), ev_c[i])
    torch.testing.assert_close(ev_g[2].cpu(), ev_c[2], rtol=1e-6, atol=0)
    for f in ("occ_sum", "comp", "slot_step") + (("kind_count",) if tagged else ()):
        assert torch.equal(getattr(st_g, f).cpu(), getattr(st_c, f))
    for f in ("occ_tw", "busy_t", "delay_sum") + (("avail_tw",) if tagged else ()):
        torch.testing.assert_close(getattr(st_g, f).cpu(), getattr(st_c, f), rtol=1e-6,
                                   atol=1e-6)


def test_sparse_fused_chunk_makes_no_host_sync(dev):
    """One chunk of the sparse fused runner on the MLP, importance-weighted
    and adaptive under faults: the class draws, the pools, the slot scales
    and `ctrl_refresh(counts=)` stay on the card."""
    from repro_torch.core import FaultConfig
    from repro_torch.core import stream_device as sd
    from repro_torch.core.async_sgd import _device_grad_fn
    from repro_torch.core.engine_scan import make_fused_runner

    n, C, T = 16, 4, 200
    setup, mu = _setup(dev, n=n)
    spec, mu_m, p_m = sd.build_class_spec(mu)
    run = make_fused_runner(_device_grad_fn(setup.clients), n, C, T, weighting="importance",
                            adaptive=True, refresh_every=T, classes=spec,
                            fault=FaultConfig(**_ROBUST_FAULT))
    nodes, ur, ue, ud, um, ub = sd.draw_sparse_uniforms(3, spec, C, T, p_m, device=dev,
                                                        fault=True)
    mu_g, p_g = (torch.tensor(a, dtype=torch.float32, device=dev) for a in (mu_m, p_m))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        w, _, ex = run.from_draws(setup.params, mu_g, p_g, 0.05, nodes, ur, ue, ud, u_mem=um,
                                  u_bit=ub)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(bool(torch.isfinite(v).all()) for v in w.values())
    assert ex["p_traj"].shape == (1, spec.m) and int(ex["kind_count"].sum()) == T


@pytest.mark.parametrize("mode", ["fault", "erlang2_onoff"])
def test_robust_fused_chunk_makes_no_host_sync(dev, mode):
    """One chunk of the fused runner under faults and the guard (stale
    cutoff and norm cap), and one under a scenario, on the MLP per event:
    the kind mask, the guard's verdicts and counters stay on the card."""
    from repro_torch.core import stream_device as sd
    from repro_torch.core.async_sgd import _device_grad_fn
    from repro_torch.core.engine_scan import GuardConfig, make_fused_runner

    n, C, T = 16, 4, 200
    setup, mu = _setup(dev, n=n)
    p = np.full(n, 1.0 / n)
    fault, scenario = _robust_mode(mode)
    run = make_fused_runner(_device_grad_fn(setup.clients), n, C, T, fault=fault,
                            scenario=scenario, guard=GuardConfig(max_grad_norm=1e3,
                                                                 stale_cutoff=4 * C))
    draws = sd.draw_uniforms(3, n, C, T, p, device=dev, scenario=scenario is not None)
    mu_g, p_g = (torch.tensor(a, dtype=torch.float32, device=dev) for a in (mu, p))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        w, _, ex = run.from_draws(setup.params, mu_g, p_g, 0.05, *draws)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(bool(torch.isfinite(v).all()) for v in w.values())
    assert int(ex["kind_count"].sum()) == T and int(ex["guard_rejects"]) == 0


def test_control_plane_on_card_equals_cpu(dev):
    from repro_torch.core import stream_device as sd
    from repro_torch.core.theory import BoundConstants

    n, C = 64, 16
    rng = np.random.default_rng(2)
    mu = torch.tensor(rng.uniform(0.5, 6.0, n), dtype=torch.float32)
    p = torch.tensor(rng.uniform(0.5, 1.5, n), dtype=torch.float32)
    p = p / p.sum()
    k = BoundConstants(C=C, T=2000)
    m_c, lam_c = sd.mva_throughput_delays(mu, p, C)
    m_g, lam_g = sd.mva_throughput_delays(mu.to(dev), p.to(dev), C)
    torch.testing.assert_close(m_g.cpu(), m_c, rtol=1e-5, atol=0)
    comp = torch.tensor(rng.integers(10, 200, n))
    busy = torch.tensor(rng.uniform(10.0, 100.0, n), dtype=torch.float32)
    p1_c = sd.ctrl_refresh(p, comp, busy, k)
    p1_g = sd.ctrl_refresh(p.to(dev), comp.to(dev), busy.to(dev), k)
    torch.testing.assert_close(p1_g.cpu(), p1_c, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kw", [dict(), dict(update="pallas"), dict(block_size=4),
                                dict(adaptive=True, refresh_every=100)])
def test_fused_run_on_card_equals_cpu(dev, kw):
    """The fused runner on the card against the CPU on the same draws: the
    Quadratic's weights within 1e-5 (K1 on the card, its plain version on
    the CPU, with ``update="pallas"``)."""
    from repro_torch.core import engine_scan
    from repro_torch.kernels.ops import tree_weighted_update

    n, C, T = 16, 4, 400
    c = torch.tensor(np.random.default_rng(0).normal(size=(n, 5)), dtype=torch.float32)

    def grad_on(cc):
        return lambda j, w, k: {"w": w["w"] - cc.index_select(0, j.reshape(1))[0]}

    kw = dict(kw)
    if kw.pop("update", None) == "pallas":
        kw["update_fn"] = tree_weighted_update
    mu, nodes, ur, ue, _ = _stream_inputs(n, C, T)
    ud = torch.rand(T, generator=torch.Generator().manual_seed(9))
    p = np.full(n, 1.0 / n)
    out = []
    for d in (torch.device("cpu"), dev):
        run = engine_scan.make_fused_runner(grad_on(c.to(d)), n, C, T, **kw)
        w, _, x = run.from_draws({"w": torch.zeros(5, device=d)}, mu.numpy(), p, 0.05,
                                 *(a.to(d) for a in (nodes, ur, ue, ud)))
        out.append((w["w"].cpu(), x["comp"].cpu()))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0, atol=1e-5)
    assert torch.equal(out[1][1], out[0][1])


_SERVE = dict(arrival_rate=6.0, serve_rate=3.0, queue_cap=5, deadline=1.0, max_retries=2,
              backoff_base=0.1, backoff_cap=0.4)


@pytest.mark.parametrize("fault,cells", [(False, None), (True, None), (False, 4)])
def test_merged_stream_on_card_equals_cpu(dev, fault, cells):
    """The stream merged with the serving plane (`scan_draws(serving=)`) on
    the card against the CPU on the same draws: events and integer state
    exact, times <= 1e-6, the serving table and its counters exact."""
    from repro_torch.core import FaultConfig, stream_device as sd
    from repro_torch.core.serving import ServingConfig

    args = _stream_inputs(64, 16, 1000, cells)
    kw = dict(serving=ServingConfig(**_SERVE),
              fault=FaultConfig(**_ROBUST_FAULT) if fault else None)
    _, ev_c, st_c, (sv_c, ss_c) = sd.scan_draws(*args, **kw)
    _, ev_g, st_g, (sv_g, ss_g) = sd.scan_draws(*(a.to(dev) for a in args), **kw)
    for i in (0, 1, 3, 4, 5):  # J, K, slot, delay, kind
        assert torch.equal(ev_g[i].cpu(), ev_c[i])
    torch.testing.assert_close(ev_g[2].cpu(), ev_c[2], rtol=1e-6, atol=0)
    for f in ("occ_sum", "comp", "slot_step"):
        assert torch.equal(getattr(st_g, f).cpu(), getattr(st_c, f))
    for f in ("stt", "seq", "attempt", "next_seq", "depth", "cdf"):
        assert torch.equal(getattr(sv_g, f).cpu(), getattr(sv_c, f)), f
    for f in ("arrivals", "served", "shed", "timed_out", "retried", "qdepth_max",
              "sojourn_hist"):
        assert torch.equal(getattr(ss_g, f).cpu(), getattr(ss_c, f)), f
    torch.testing.assert_close(ss_g.sojourn.cpu(), ss_c.sojourn, rtol=1e-6, atol=0)
    assert int(ss_c.served.sum()) > 0


def _serve_run(d, kw, n=16, C=4, T=400):
    """The fused runner with serving on ``d`` over CPU-drawn inputs, ready
    to run: ``run()`` -> ``(w, evals, extras)`` (the inputs are on ``d``
    before it is called)."""
    from repro_torch.core import engine_scan
    from repro_torch.core.serving import ServingConfig

    c = torch.tensor(np.random.default_rng(0).normal(size=(n, 5)), dtype=torch.float32).to(d)
    mu, nodes, ur, ue, _ = _stream_inputs(n, C, T)
    ud = torch.rand(T, generator=torch.Generator().manual_seed(9))
    fused = engine_scan.make_fused_runner(
        lambda j, w, k: {"w": w["w"] - c.index_select(0, j.reshape(1))[0]}, n, C, T,
        serving=ServingConfig(**_SERVE), **kw)
    args = ({"w": torch.zeros(5, device=d)}, torch.tensor(mu.numpy(), device=d),
            torch.full((n,), 1.0 / n, device=d), 0.05, *(a.to(d) for a in (nodes, ur, ue, ud)))
    return lambda: fused.from_draws(*args)


@pytest.mark.parametrize("kw", [dict(), dict(adaptive=True, refresh_every=100)])
def test_serving_fused_run_on_card_equals_cpu(dev, kw):
    """The fused runner with serving on the card against the CPU on the
    same draws: weights within 1e-5, every integer ``serve_*`` extra and
    histogram exact, the served rows' checksum within 1e-5."""
    (wc, _, xc), (wg, _, xg) = (_serve_run(d, kw)() for d in (torch.device("cpu"), dev))
    torch.testing.assert_close(wg["w"].cpu(), wc["w"], rtol=0, atol=1e-5)
    for k, v in xc.items():
        if k.startswith("serve_") and not v.is_floating_point():
            assert torch.equal(xg[k].cpu(), v), k
    torch.testing.assert_close(xg["serve_checksum"].cpu(), xc["serve_checksum"], rtol=1e-5,
                               atol=1e-6)


def test_serving_fused_chunk_makes_no_host_sync(dev):
    """One chunk of the fused runner with serving and the guard under the
    sync check: the merged race, the request table, the replay and the
    known-good read path all stay on the card."""
    from repro_torch.core.engine_scan import GuardConfig

    run = _serve_run(dev, dict(guard=GuardConfig(max_grad_norm=1e3)), T=200)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        w, _, x = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(w["w"]).all()) and int(x["serve_arrivals"]) > 0


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-130m", "zamba2-2.7b", "qwen2-moe-a2.7b",
                                  "musicgen-medium"])
def test_decode_on_card_equals_cpu(dev, arch):
    """Decode at smoke size (fp32) on the card against the CPU on the same
    weights: every step's logits within 1e-4; the MoE decode with K5 (sort
    dispatch, ``use_pallas``) on the card against its plain version."""
    from repro_torch.launch.serve import materialize_cache

    cfg = smoke_config(arch)
    if cfg.family == "moe":
        cfg = cfg.replace(capacity_factor=16.0, use_pallas=True, moe_dispatch="sort")
    params = init_params(api.model_meta(cfg), 3, "cpu")
    B, S = 2, 8
    rng = np.random.default_rng(3)
    if cfg.frontend == "audio_stub":
        x = torch.from_numpy(rng.normal(size=(B, S, cfg.d_model)).astype(np.float32))
        feeds = [{"embeds": x[:, t:t + 1]} for t in range(S)]
    else:
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
        feeds = [{"tokens": toks[:, t:t + 1]} for t in range(S)]
    logits = {}
    for d in (torch.device("cpu"), dev):
        p = {k: v for k, v in params.items()} if d.type == "cpu" else _to(params, d)
        cache = materialize_cache(api.init_cache(cfg, B, S), d)
        out = []
        with torch.no_grad():
            for b in feeds:
                lg, cache = api.decode_step(p, cache, {k: v.to(d) for k, v in b.items()}, cfg)
                out.append(lg.cpu())
        logits[d.type] = torch.stack(out)
    torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=0, atol=1e-4)


def _to(tree, d):
    if isinstance(tree, dict):
        return {k: _to(v, d) for k, v in tree.items()}
    return tree.to(d)
