"""PyTorch port, K3's tile plan on the CPU: the rule by which the CUDA
flash-attention kernels leave out key tiles (`kernels.flash_attention.
key_tiles`, the mirror of ``csrc/flash_attention.cu:key_tiles``).

A query tile may leave out a key tile only when every real row of the query
tile masks every key of it, and it leaves out nothing when one of its rows
masks all T keys (that row averages v over all of them, as the reference
does).  The rule is held against the boolean mask of the reference
(`repro.kernels.ref.flash_attention_ref`'s), and an fp32 emulation of the
kernel's tile walk (online softmax over the visited tiles only) is held
against the JAX reference, so leaving tiles out is shown to change nothing.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as j_ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

NEG_INF = -1e30  # the kernels' masked score


def _mask(S, T, causal, window, q_offset):
    """The reference's keep mask (S, T): `flash_attention_ref`'s rule."""
    rel = (np.arange(S) + q_offset)[:, None] - np.arange(T)[None, :]
    keep = np.ones((S, T), bool)
    if causal:
        keep &= rel >= 0
    if window:
        keep &= rel < window
    return keep


def _check_plan(S, T, causal, window, q_offset, bq, bk):
    keep = _mask(S, T, causal, window, q_offset)
    ntiles = -(-T // bk)
    for q0 in range(0, S, bq):
        rows = keep[q0:min(q0 + bq, S)]
        lo, hi = fa.key_tiles(q0, bq, S, T, causal, window, q_offset, bk)
        assert 0 <= lo < hi <= ntiles
        if not rows.any(axis=1).all():  # a row masked on every key: visit all
            assert (lo, hi) == (0, ntiles)
            continue
        for j in range(ntiles):
            live = rows[:, j * bk:(j + 1) * bk].any()
            if j < lo or j >= hi:
                assert not live, (q0, j)  # a skipped tile is masked for every row
        # and the range is tight: its end tiles hold a key some row keeps
        assert rows[:, lo * bk:(lo + 1) * bk].any() and rows[:, (hi - 1) * bk:hi * bk].any()


# (S, T, window, q_offset): the LM path shapes, the grid of
# tests/test_kernels.py and chip_smoke.py's K3 shapes (rows masked on every
# key among them), windows shorter and longer than a tile, ragged S and T
PLANS = [
    (128, 128, 0, 0),
    (256, 256, 64, 0),
    (64, 64, 0, 0),
    (128, 384, 0, 256),
    (64, 64, 16, 0),
    (2048, 2048, 512, 0),
    (100, 100, 0, 0),
    (200, 333, 0, 133),
    (64, 64, 16, 200),
    (40, 50, 8, 100),
    (512, 512, 96, 0),
    (200, 200, 70, 0),
    (192, 256, 40, 100),
    (128, 128, 16, 120),
    (1, 1, 0, 0),
    (1, 300, 0, 299),
    (130, 65, 0, -30),
    (64, 129, 1, 64),
    (100, 200, 50, 100),
    (64, 300, 250, 236),
    (33, 97, 3, -10),
]


@pytest.mark.parametrize("tiles", [fa.TC_TILE, fa.SIMPLE_TILE, (16, 128)])
@pytest.mark.parametrize("S,T,window,q_offset", PLANS)
def test_key_tiles_skip_only_tiles_masked_for_every_row(S, T, window, q_offset, tiles):
    _check_plan(S, T, True, window, q_offset, *tiles)


def test_key_tiles_over_a_grid_causal_and_not():
    """Every combination of a small grid, causal and not (the kernels take
    both), rows masked on every key included."""
    for S, T, window, q_offset, causal in itertools.product(
            (1, 17, 64, 65, 130), (1, 31, 64, 100), (0, 1, 5, 64, 70), (-70, -3, 0, 9, 64, 99),
            (True, False)):
        for bq, bk in (fa.TC_TILE, fa.SIMPLE_TILE):
            _check_plan(S, T, causal, window, q_offset, bq, bk)


@pytest.mark.parametrize("S,T,window,q_offset", PLANS)
def test_visited_pairs_count_the_scored_tiles(S, T, window, q_offset):
    """`visited_pairs` is the (real row, real key) pairs of the visited
    tiles; it covers every pair the reference needs (`chip_smoke.py`'s
    `_fa_pairs`: the kept keys of a row, all T for a row with none)."""
    bq, bk = fa.TC_TILE
    want = 0
    for q0 in range(0, S, bq):
        lo, hi = fa.key_tiles(q0, bq, S, T, True, window, q_offset, bk)
        want += (min(q0 + bq, S) - q0) * (min(hi * bk, T) - lo * bk)
    assert fa.visited_pairs(S, T, True, window, q_offset, bq, bk) == want
    keep = _mask(S, T, True, window, q_offset)
    per_row = keep.sum(axis=1)
    needed = int(np.where(per_row == 0, T, per_row).sum())
    assert needed <= want <= S * T


def _tile_walk(q, k, v, causal, window, q_offset, bq, bk):
    """fp32 numpy emulation of the kernels' walk for one head: per query
    tile, the online softmax over the key tiles of `key_tiles` only, masked
    scores -1e30, keys past T -inf, division by l at the end."""
    S, D = q.shape
    T = k.shape[0]
    ntiles = -(-T // bk)
    kp = np.zeros((ntiles * bk, D), np.float32)
    vp = np.zeros((ntiles * bk, D), np.float32)
    kp[:T], vp[:T] = k, v
    out = np.zeros((S, D), np.float32)
    for q0 in range(0, S, bq):
        rows = np.arange(q0, min(q0 + bq, S))
        lo, hi = fa.key_tiles(q0, bq, S, T, causal, window, q_offset, bk)
        m = np.full(len(rows), NEG_INF, np.float32)
        l = np.zeros(len(rows), np.float32)
        acc = np.zeros((len(rows), D), np.float32)
        for j in range(lo, hi):
            t = np.arange(j * bk, (j + 1) * bk)
            s = (q[rows] @ kp[t].T / np.float32(np.sqrt(D))).astype(np.float32)
            p_ = rows[:, None] + q_offset
            keep = np.ones_like(s, bool)
            if causal:
                keep &= t[None, :] <= p_
            if window:
                keep &= p_ - t[None, :] < window
            s = np.where(keep, s, np.float32(NEG_INF))
            s = np.where(t[None, :] < T, s, -np.inf).astype(np.float32)
            m_new = np.maximum(m, s.max(axis=1))
            alpha = np.exp(m - m_new)
            p = np.exp(s - m_new[:, None])
            l = l * alpha + p.sum(axis=1)
            acc = acc * alpha[:, None] + p @ vp[t]
            m = m_new
        out[rows] = acc / np.where(l == 0, 1.0, l)[:, None]
    return out


@pytest.mark.parametrize("S,T,window,q_offset", [
    (128, 128, 0, 0), (130, 200, 0, 70), (192, 256, 40, 100), (128, 128, 16, 120),
    (64, 64, 16, 200), (40, 50, 8, 100), (200, 200, 70, 0),
])
def test_tile_walk_with_skips_matches_jax_reference(S, T, window, q_offset):
    """Leaving out the tiles of `key_tiles` changes nothing: the emulated
    walk equals the JAX reference in fp32 (2e-5), all-masked rows included
    (they average v over all T keys)."""
    rng = np.random.default_rng([S, T, window, q_offset])
    q = rng.normal(size=(1, S, 1, 32)).astype(np.float32)
    k = rng.normal(size=(1, T, 1, 32)).astype(np.float32)
    v = rng.normal(size=(1, T, 1, 32)).astype(np.float32)
    exp = np.asarray(j_ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               causal=True, window=window, q_offset=q_offset))
    for bq, bk in (fa.TC_TILE, fa.SIMPLE_TILE):
        got = _tile_walk(q[0, :, 0], k[0, :, 0], v[0, :, 0], True, window, q_offset, bq, bk)
        np.testing.assert_allclose(got, exp[0, :, 0], atol=2e-5, rtol=2e-5)
