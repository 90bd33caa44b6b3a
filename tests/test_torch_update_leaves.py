"""PyTorch port, K1 over all leaves of an event and K2's live-lane stores.

K1 (`kernels.weighted_update.weighted_update_leaves`) takes every leaf of an
event in one launch.  Its split of the leaves into chunks lives in C; the
Python mirror `leaf_plan` / `leaf_of` is checked here to cover every value
of every leaf exactly once, thread by thread.  `ops.weighted_update_tree`
(the plain version leaf by leaf on the CPU) is held against the JAX
package's `repro.kernels.ops.weighted_update_tree` (Pallas in interpret
mode) on a mixed bf16 / fp32 tree.  K2 stores only its live lanes
(`live_lanes`): writing those rows of the plain version's iterates, in any
order, gives the ring that event-order writes give.  Across cells (the
scenario matrix) K1 takes one scale a cell, each cell's slice of a leaf a
row of its table (`leaf_code`, `cell_rows`), and K2 B rings at once: their
plain versions with a cell axis are held against JAX's under `jax.vmap`
and bitwise against the port's per-cell calls.  The kernels themselves
are held against the plain versions on the card by `tests/test_torch_gpu.py`.

Inputs are drawn with numpy and handed to both packages.  Tolerances: the
tree update 1e-5 fp32, 2e-2 bf16; K2 against the JAX kernel
`tests/test_kernels.py`'s 2e-5 fp32, 2e-2 bf16 (the CPU plain version sums
in double, the JAX kernel in fp32); everything within the port bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels.weighted_update import block_prefix_update as j_block_pallas  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import weighted_update as wu  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
K2_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


# ---------------------------------------------------------------------------
# K1's split of a leaf list into launches and chunks
# ---------------------------------------------------------------------------
def _covered(numels, widths) -> list[np.ndarray]:
    """How often each value of each leaf is touched when every CTA of every
    launch of `leaf_plan` runs thread by thread as the kernel does: thread t
    of chunk c takes vectors c * T * U + u * T + t (u < U), each ``width``
    values, cut at the leaf's end."""
    T, U = wu.LEAF_THREADS, wu.LEAF_UNROLL
    hits = [np.zeros(n, np.int64) for n in numels]
    for launch in wu.leaf_plan(numels, widths):
        assert 1 <= len(launch) <= wu.MAX_LEAVES
        total = launch[-1][1] + launch[-1][2]
        for b in range(total):
            i, first, _ = launch[wu.leaf_of(launch, b)]
            c, w, n = b - first, widths[i], numels[i]
            v = c * T * U + np.arange(U)[:, None] * T + np.arange(T)[None, :]
            e = (v.reshape(-1, 1) * w + np.arange(w)[None, :]).reshape(-1)
            np.add.at(hits[i], e[e < n], 1)
    return hits


MLP = [128, 128, 10, 64 * 128, 128 * 128, 128 * 10]  # b1 b2 b3 w1 w2 w3
PLANS = {
    "mlp_fp32": (MLP, [4] * 6),
    "ragged_empty_and_0d": ([17, 0, 1, 4097, 0, 1, 8193, 3], [4, 4, 1, 4, 8, 8, 8, 1]),
    "mixed_fp32_bf16": ([2048 * 3, 1000, 8192 * 2 + 5, 77, 12288], [4, 8, 8, 1, 4]),
    "more_than_max_leaves": ([(7 * i) % 300 + (i % 5 == 0) * 9000 for i in range(150)],
                             [(1, 4, 8)[i % 3] for i in range(150)]),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_leaf_plan_covers_every_value_once(case):
    numels, widths = PLANS[case]
    hits = _covered(numels, widths)
    assert all(np.array_equal(h, np.ones_like(h)) for h in hits)
    plan = wu.leaf_plan(numels, widths)
    live = [i for i, n in enumerate(numels) if n > 0]
    assert [row[0] for launch in plan for row in launch] == live
    assert len(plan) == -(-len(live) // wu.MAX_LEAVES)
    for launch in plan:  # chunks in leaf order, no gap
        assert launch[0][1] == 0
        assert all(a[1] + a[2] == b[1] for a, b in zip(launch, launch[1:]))


def test_leaf_of_finds_the_leaf_of_each_cta():
    launch = wu.leaf_plan(MLP, [4] * 6)[0]
    assert [wu.leaf_of(launch, b) for b in range(10)] == [0, 1, 2, 3, 3, 4, 4, 4, 4, 5]


def test_weighted_update_leaves_refuses_cpu_tensors():
    wu.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        wu.weighted_update_leaves([torch.zeros(3)], [torch.zeros(3)], 0.1)
    assert all(v == 0 for v in wu.launches.values())


# ---------------------------------------------------------------------------
# the tree update on the CPU against the JAX package
# ---------------------------------------------------------------------------
TREE = {  # name: (shape, w dtype, g dtype)
    "b": ((128,), "float32", "float32"),
    "emb": ((50, 24), "bfloat16", "bfloat16"),
    "norm": ((), "float32", "float32"),
    "proj": ((3, 5, 7), "bfloat16", "float32"),
    "w": ((64, 33), "float32", "bfloat16"),
}


def _tree(seed, momentum):
    rng = np.random.default_rng(seed)
    arrays = {k: [rng.normal(size=s).astype(np.float32) for _ in range(3)]
              for k, (s, _, _) in TREE.items()}
    t_dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    j_dt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    tw = {k: torch.tensor(a[0]).to(t_dt[TREE[k][1]]) for k, a in arrays.items()}
    tg = {k: torch.tensor(a[1]).to(t_dt[TREE[k][2]]) for k, a in arrays.items()}
    jw = {k: jnp.asarray(a[0], j_dt[TREE[k][1]]) for k, a in arrays.items()}
    jg = {k: jnp.asarray(a[1], j_dt[TREE[k][2]]) for k, a in arrays.items()}
    tm = {k: torch.tensor(a[2]) for k, a in arrays.items()} if momentum else None
    jm = {k: jnp.asarray(a[2]) for k, a in arrays.items()} if momentum else None
    return (tw, tg, tm), (jw, jg, jm)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_weighted_update_tree_matches_jax_on_a_mixed_tree(momentum):
    (tw, tg, tm), (jw, jg, jm) = _tree(int(10 * momentum), momentum)
    wu.reset_launches()
    new, new_m = ops.weighted_update_tree(tw, tg, 0.37, momenta=tm, momentum=momentum)
    assert all(v == 0 for v in wu.launches.values())  # CPU leaves: no launch
    j_new, j_m = j_ops.weighted_update_tree(jw, jg, jnp.float32(0.37), momenta=jm,
                                            momentum=momentum)
    assert set(new) == set(TREE)
    for k, (_, dt, _) in TREE.items():
        assert new[k].dtype == tw[k].dtype and new[k].shape == tw[k].shape
        np.testing.assert_allclose(new[k].float().numpy(), np.asarray(j_new[k], np.float32),
                                   atol=TOL[dt], rtol=TOL[dt])
        if momentum:
            assert new_m[k].dtype == torch.float32
            np.testing.assert_allclose(new_m[k].numpy(), np.asarray(j_m[k]), atol=1e-5)
        else:
            assert new_m is None and j_m is None
    # the engine's entry point is the same update without momentum
    if not momentum:
        same = ops.tree_weighted_update(tw, tg, 0.37)
        assert all(torch.equal(same[k], new[k]) for k in TREE)


# ---------------------------------------------------------------------------
# K2: the live lanes alone give the ring
# ---------------------------------------------------------------------------
# slot patterns of one block on a ring of R = 9 rows (trash row 8):
# duplicate trash-row lanes, a real row targeted twice, slots outside [0, R)
# (dropped, as the JAX scatter drops them), every lane on the trash row
K2_PATTERNS = [
    [3, 1, 6, 5, 0, 8, 8, 8],
    [3, 1, 3, 5, 8, 2, 8, 1],
    [8] * 8,
    [5, 5, 5, 5, 2, 2, 8, 8, 8, 8, 7, 6, 5, 4, 3, 8],
    [2, -1, 4, 9, 4, 8, 12, 8],
    [9, 9, -3],
    [0, 7, 3, 100, 7],
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("slots", K2_PATTERNS)
def test_prefix_live_lanes_give_the_event_order_ring(dtype, slots):
    R, P, E = 9, 1024, len(slots)
    rng = np.random.default_rng([E, sum(slots) % 97])
    snaps = rng.normal(size=(R, P)).astype(np.float32)
    w = rng.normal(size=P).astype(np.float32)
    D = (0.05 * rng.normal(size=(E, P))).astype(np.float32)
    t_dt = torch.float32 if dtype == "float32" else torch.bfloat16
    t_snaps, tw, tD = torch.tensor(snaps).to(t_dt), torch.tensor(w), torch.tensor(D)
    st = torch.tensor(slots, dtype=torch.int64)
    # the plain version's iterates: W_i is w' of the block cut after lane i
    W = [ref.block_prefix_update_ref(t_snaps.clone(), tw, tD[:i + 1],
                                     st[:i + 1].clamp(0, R - 1))[1] for i in range(E)]
    live = wu.live_lanes(slots, R)
    in_ring = [0 <= s < R for s in slots]
    assert sum(live) == len({s for s in slots if 0 <= s < R})
    events = t_snaps.clone()
    for i in range(E):  # every lane, in event order
        if in_ring[i]:
            events[slots[i]] = W[i].to(t_dt)
    lanes = t_snaps.clone()
    for i in reversed(range(E)):  # the live lanes alone, in reverse
        if live[i]:
            lanes[slots[i]] = W[i].to(t_dt)
    assert torch.equal(lanes, events)
    if all(in_ring):  # the plain version itself, and the JAX kernel
        ref_s, ref_w = ref.block_prefix_update_ref(t_snaps.clone(), tw, tD, st)
        assert torch.equal(lanes, ref_s) and torch.equal(W[-1], ref_w)
        j_dt = jnp.float32 if dtype == "float32" else jnp.bfloat16
        js, jw_ = j_block_pallas(jnp.asarray(snaps, j_dt), jnp.asarray(w), jnp.asarray(D),
                                 jnp.asarray(slots, jnp.int32), interpret=True)
        np.testing.assert_allclose(lanes.float().numpy(), np.asarray(js, np.float32),
                                   atol=K2_TOL[dtype], rtol=K2_TOL[dtype])
        np.testing.assert_allclose(W[-1].numpy(), np.asarray(jw_), atol=2e-5)


# ---------------------------------------------------------------------------
# the cell axis (the scenario matrix's B runs in lockstep)
# ---------------------------------------------------------------------------
def test_leaf_code_packs_dtypes_and_cell():
    f, b = torch.float32, torch.bfloat16
    assert wu.leaf_code(f, f) == 0 and wu.leaf_code(b, f) == 1 and wu.leaf_code(f, b) == 1 << 8
    code = wu.leaf_code(b, b, cell=26)
    assert (code & 0xFF, (code >> 8) & 0xFF, code >> 16) == (1, 1, 26)
    assert wu.leaf_code(f, f, wu.MAX_CELLS - 1) >> 16 == 0xFFFF
    with pytest.raises(ValueError, match="cell"):
        wu.leaf_code(f, f, wu.MAX_CELLS)


def test_cell_rows_split_a_leaf_over_its_cells():
    """Cell c's row points c slices into every operand (0 stays 0: no
    momentum) and carries c in the code's upper bits."""
    ptrs, sizes = (1 << 20, 2 << 20, 3 << 20, 0, 0), (4, 2, 4, 4, 4)
    rows = wu.cell_rows(ptrs, sizes, 3 * 10, wu.leaf_code(torch.float32, torch.bfloat16), 3)
    assert [r[:5] for r in rows] == [(p0 + c * 40, p1 + c * 20, p2 + c * 40, 0, 0)
                                     for c in range(3) for p0, p1, p2 in [ptrs[:3]]]
    assert [r[5] for r in rows] == [10] * 3
    assert [(r[6] & 0xFFFF, r[6] >> 16) for r in rows] == [(1 << 8, c) for c in range(3)]
    assert wu.cell_rows(ptrs, sizes, 7, 0) == [ptrs + (7, 0)]  # one cell: the leaf itself
    assert wu.cell_rows(ptrs, sizes, 0, 0, 4) == []
    with pytest.raises(ValueError, match="split"):
        wu.cell_rows(ptrs, sizes, 10, 0, 3)


@pytest.mark.parametrize("cells", [3, 27])
def test_leaf_plan_over_cells_covers_every_value_once(cells):
    """The MLP's 6 leaves over B cells are B x 6 table rows, ceil(6B / 64)
    launches (27 cells: 3), each cell's slice covered once; a cell slice
    off the 16-byte grid (b3's 10 values at an odd cell) takes one value
    an access."""
    numels = [n for n in MLP for _ in range(cells)]
    widths = [4 if (c * n) % 4 == 0 else 1 for n in MLP for c in range(cells)]
    assert all(np.array_equal(h, np.ones_like(h)) for h in _covered(numels, widths))
    assert len(wu.leaf_plan(numels, widths)) == -(-6 * cells // wu.MAX_LEAVES)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cell_axis_plain_versions_match_jax_vmap(dtype):
    """K1 (one scale a cell) and K2 (B rings) with a cell axis: against JAX's
    `weighted_update_tree` and Pallas `block_prefix_update` under `jax.vmap`
    (interpret mode), and bitwise against the port's own per-cell calls.
    Against JAX: measured 2.4e-7 in fp32 (XLA fuses w - s*g into one
    multiply-add, and the CPU cumsum accumulates in double), 0 in bf16."""
    B, R, P, E = 3, 9, 1024, 8
    slots = np.array([[3, 1, 6, 5, 0, 8, 8, 8], [2, 7, 1, 8, 8, 8, 8, 8], [8] * 8])
    rng = np.random.default_rng(B)
    t_dt = getattr(torch, dtype)
    j_dt = getattr(jnp, dtype)
    snaps = rng.normal(size=(B, R, P)).astype(np.float32)
    w = rng.normal(size=(B, P)).astype(np.float32)
    D = (0.05 * rng.normal(size=(B, E, P))).astype(np.float32)
    ts, tw = ref.block_prefix_update_ref(torch.tensor(snaps).to(t_dt), torch.tensor(w),
                                         torch.tensor(D), torch.tensor(slots))
    js, jw_ = jax.vmap(lambda s, w, d, sl: j_block_pallas(s, w, d, sl, interpret=True))(
        jnp.asarray(snaps, j_dt), jnp.asarray(w), jnp.asarray(D), jnp.asarray(slots, jnp.int32))
    np.testing.assert_allclose(ts.float().numpy(), np.asarray(js, np.float32),
                               atol=K2_TOL[dtype], rtol=K2_TOL[dtype])
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw_), atol=K2_TOL["float32"])
    for c in range(B):  # each cell as its own call
        cs, cw = ref.block_prefix_update_ref(torch.tensor(snaps[c]).to(t_dt), torch.tensor(w[c]),
                                             torch.tensor(D[c]), torch.tensor(slots[c]))
        assert torch.equal(ts[c], cs) and torch.equal(tw[c], cw)

    (tw1, tg1, _), (jw1, jg1, _) = _tree(7, 0.0)
    stack = lambda t, f: {k: f([v, 0.5 * v, -v]) for k, v in t.items()}  # noqa: E731
    tws, tgs = stack(tw1, torch.stack), stack(tg1, torch.stack)
    sc = np.array([0.1, 0.37, 2.0], np.float32)
    new = ops.tree_weighted_update(tws, tgs, torch.tensor(sc))
    j_new = jax.vmap(lambda a, b, s: j_ops.weighted_update_tree(a, b, s)[0])(
        stack(jw1, jnp.stack), stack(jg1, jnp.stack), jnp.asarray(sc))
    for k, (_, wdt, _) in TREE.items():
        assert new[k].dtype == tws[k].dtype and new[k].shape == tws[k].shape
        np.testing.assert_allclose(new[k].float().numpy(), np.asarray(j_new[k], np.float32),
                                   atol=TOL[wdt], rtol=TOL[wdt])
        for c in range(B):
            one = ops.tree_weighted_update({k: tws[k][c]}, {k: tgs[k][c]}, float(sc[c]))[k]
            assert torch.equal(new[k][c], one)
