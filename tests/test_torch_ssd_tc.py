"""PyTorch port, K4's tensor-core kernel on the CPU: its route rule, its
shared memory, and its rounding points.

The CUDA kernel (`csrc/ssd_scan.cu:ssd_tc_kernel`) runs only on the card.
What can be checked here is (1) the rule by which the library picks it
(`kernels.ssd_scan.route`, the mirror of ``tc_path``), (2) that its shared
memory leaves room for two CTAs an SM, so Mamba2-130M's 192 CTAs run as one
wave, and (3) that its arithmetic fits the bf16 tolerances: `_tc_emulate`
repeats, in torch on the CPU, what the kernel computes per chunk: the chunk
zero-padded to the kernel's tile, the prefix sum in order in fp32, dt
folded into the masked scores, and fp32 accumulation of products whose
operands are bf16: the inputs C, B and x exactly, and the three fp32
operands (the scaled scores, the state of the chunk's start, the decayed x)
as bf16 pairs hi + lo; the state carried in fp32.  It is held against the
JAX package's Pallas kernel in interpret mode (`_ssd_impl`, the TPU kernel
K4 replaces) within the bf16 tolerances the card checks use.  The same
emulation with one bf16 rounding per fp32 operand does not fit them, which
is why the kernel carries pairs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import _ssd_impl  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd_scan as k4  # noqa: E402

Y_TOL = 2e-2      # y allclose, atol = rtol (bf16, tests/test_kernels.py's)
STATE_TOL = 1e-2  # the state within this much of its magnitude (at least 1)
SMS = 132         # an H100 SXM's streaming multiprocessors

# (B, S, H, P, N, chunk, A range, dt range): Mamba2-130M's head and state
# widths at a small batch, Zamba2-2.7B's N = 64, a chunk longer than the
# sequence (Q = 40, zero-padded to 64), and the overflow case (A in
# -[1, 16], dt up to 1: exp of the masked cs_i - cs_j is inf)
EMULATED = [
    (2, 128, 4, 64, 128, 64, (1.0, 16.0), (0.001, 0.1)),
    (2, 128, 3, 64, 64, 64, (1.0, 16.0), (0.001, 0.1)),
    (2, 40, 4, 32, 16, 64, (0.5, 2.0), (0.01, 0.2)),
    (2, 128, 3, 32, 16, 64, (1.0, 16.0), (0.0, 1.0)),
]


def _inputs(B, S, H, P, N, a_range, dt_range, seed=0):
    """(x, dt, A, Bm, Cm) for JAX and for the port, from one numpy draw;
    x, B and C in bf16."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = rng.uniform(*dt_range, (B, S, H)).astype(np.float32)
    A = -rng.uniform(*a_range, (H,)).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    j = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt), jnp.asarray(A),
         jnp.asarray(Bm, jnp.bfloat16), jnp.asarray(Cm, jnp.bfloat16))
    t = (torch.from_numpy(x).bfloat16(), torch.from_numpy(dt), torch.from_numpy(A),
         torch.from_numpy(Bm).bfloat16(), torch.from_numpy(Cm).bfloat16())
    return j, t


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """One bf16 rounding of an fp32 operand, held as fp32 (products of two
    bf16 values are exact in fp32, and the sums run in fp32)."""
    return t.to(torch.bfloat16).float()


def _pair(t: torch.Tensor) -> torch.Tensor:
    """An fp32 operand as the kernel carries it, hi + lo with hi = bf16(t)
    and lo = bf16(t - hi): two mma, each on bf16 operands."""
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def _tc_emulate(x, dt, A, Bm, Cm, chunk, operand=_pair):
    """What ``ssd_tc_kernel`` computes, with its rounding points (``operand``
    is how an fp32 operand enters a product): returns ``(y (B,S,H,P) bf16,
    state (B,H,N,P) fp32)``."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = S // Q
    QT, _, PT = k4.TC_TILE
    NT = 64 if N <= 64 else 128
    # each chunk zero-padded to the tile (QT positions, NT, PT columns)
    xc = torch.zeros((B, nc, QT, H, PT))
    xc[:, :, :Q, :, :P] = x.float().reshape(B, nc, Q, H, P)
    dtc = torch.zeros((B, nc, QT, H))
    dtc[:, :, :Q] = dt.reshape(B, nc, Q, H)
    Bc, Cc = torch.zeros((B, nc, QT, NT)), torch.zeros((B, nc, QT, NT))
    Bc[:, :, :Q, :N] = Bm.float().reshape(B, nc, Q, N)
    Cc[:, :, :Q, :N] = Cm.float().reshape(B, nc, Q, N)
    a = dtc * A[None, None, None, :]
    cs = torch.empty_like(a)  # the prefix sum in order, in fp32
    acc = torch.zeros((B, nc, H))
    for j in range(QT):
        acc = acc + a[:, :, j]
        cs[:, :, j] = acc
    keep = torch.tril(torch.ones((QT, QT), dtype=torch.bool))[None, :, :, None]
    y = torch.zeros((B, nc, QT, H, PT))
    state = torch.zeros((B, H, NT, PT))
    for c in range(nc):
        csc = cs[:, c]                                           # (B, QT, H)
        seg = csc[:, :, None, :] - csc[:, None, :, :]           # (B, i, j, H)
        L = torch.where(keep, torch.exp(torch.where(keep, seg, 0.0)), 0.0)
        scores = Cc[:, c] @ Bc[:, c].transpose(1, 2)             # (B, i, j)
        M = operand(scores[..., None] * L * dtc[:, c, None, :, :])  # (S o L) diag(dt)
        yc = torch.einsum("bijh,bjhp->bihp", M, xc[:, c])
        if c:
            yo = torch.einsum("bin,bhnp->bihp", Cc[:, c], operand(state))
            yc = yc + torch.exp(csc)[..., None] * yo
        y[:, c] = yc
        wd = dtc[:, c] * torch.exp(csc[:, -1:, :] - csc)        # (B, QT, H)
        xdec = operand(wd[..., None] * xc[:, c])
        state = (torch.exp(csc[:, -1, :])[:, :, None, None] * state
                 + torch.einsum("bjn,bjhp->bhnp", Bc[:, c], xdec))
    y = y[:, :, :Q, :, :P].reshape(B, S, H, P).to(torch.bfloat16)
    return y, state[:, :, :N, :P]


def _allclose_tol(a, b) -> float:
    """The least tol with |a - b| <= tol + tol |b| (`chip_smoke.py`'s)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float((np.abs(a - b) / (1.0 + np.abs(b))).max())


@pytest.mark.parametrize("B,S,H,P,N,chunk,a_range,dt_range", EMULATED)
def test_tc_rounding_fits_the_bf16_tolerances(B, S, H, P, N, chunk, a_range, dt_range):
    """The tensor-core kernel's rounding points, emulated, against the JAX
    Pallas kernel in interpret mode (fp32 inside) and the port's plain
    version, at the tolerances `chip_smoke.py` holds the kernel to."""
    assert k4.route(torch.bfloat16, min(chunk, S), N, P) == "tc"
    j_in, t_in = _inputs(B, S, H, P, N, a_range, dt_range)
    y, s = _tc_emulate(*t_in, chunk)
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(s).all())
    jy, js = _ssd_impl(*j_in, chunk, True)
    py, ps = ref.ssd_scan_ref(*t_in, chunk)
    for ey, es in ((np.asarray(jy.astype(jnp.float32)), np.asarray(js)),
                   (py.float().numpy(), ps.numpy())):
        assert _allclose_tol(y.float().numpy(), ey) <= Y_TOL
        smax = max(1.0, float(np.abs(es).max()))
        assert float(np.abs(s.numpy() - es).max()) <= STATE_TOL * smax


def test_one_bf16_rounding_per_operand_does_not_fit():
    """At Mamba2-130M's widths with slow decay (A in -[0.1, 1]: the state
    and C state matter), one bf16 rounding of each fp32 operand leaves y
    outside the 2e-2 tolerance of the plain version (measured 2.7e-2; 0.7-
    1.3e-2 at `EMULATED`), and the pairs the kernel carries leave it within
    half the tolerance."""
    _, t_in = _inputs(2, 128, 4, 64, 128, (0.1, 1.0), (0.01, 0.2))
    py, _ = ref.ssd_scan_ref(*t_in, 64)
    one, _ = _tc_emulate(*t_in, 64, operand=_bf16)
    pair, _ = _tc_emulate(*t_in, 64)
    assert _allclose_tol(one.float(), py.float()) > Y_TOL
    assert _allclose_tol(pair.float(), py.float()) <= Y_TOL / 2


def test_tc_zero_padding_changes_no_output():
    """A chunk of 48 positions zero-padded to the 64 of the tile gives the
    same bits for those positions as the first 48 of a full 64-position
    chunk (position i reads positions <= i only, and a padded position has
    dt = 0, so cs stays), and its state is the plain version's."""
    _, t_in = _inputs(1, 64, 2, 64, 128, (1.0, 16.0), (0.001, 0.1), seed=3)
    x, dt, A, Bm, Cm = t_in
    y, _ = _tc_emulate(x, dt, A, Bm, Cm, 64)
    cut = (x[:, :48], dt[:, :48], A, Bm[:, :48], Cm[:, :48])
    y48, s48 = _tc_emulate(*cut, 64)
    assert torch.equal(y48, y[:, :48])
    _, es = ref.ssd_scan_ref(*cut, 64)
    assert float((s48 - es).abs().max()) <= STATE_TOL * max(1.0, float(es.abs().max()))


# (dtype, Q, N, P, route): the three path shapes (Mamba2-130M, its B = 32
# fold, Zamba2-2.7B: Q, N, P alike), the grid's other bf16 cells, and what
# the tensor-core kernel does not take
ROUTES = [
    (torch.bfloat16, 64, 128, 64, "tc"),
    (torch.bfloat16, 64, 64, 64, "tc"),
    (torch.bfloat16, 32, 16, 32, "tc"),
    (torch.bfloat16, 16, 8, 16, "tc"),
    (torch.bfloat16, 40, 16, 32, "tc"),
    (torch.bfloat16, 1, 8, 8, "tc"),
    (torch.float32, 64, 128, 64, "simt"),
    (torch.float32, 32, 16, 32, "simt"),
    (torch.bfloat16, 128, 128, 64, "simt"),
    (torch.bfloat16, 64, 256, 64, "simt"),
    (torch.bfloat16, 64, 128, 128, "simt"),
    (torch.bfloat16, 64, 12, 64, "simt"),
    (torch.bfloat16, 64, 128, 36, "simt"),
    (torch.bfloat16, 64, 4, 64, "simt"),
]


@pytest.mark.parametrize("dtype,Q,N,P,expected", ROUTES)
def test_route_rule(dtype, Q, N, P, expected):
    assert k4.route(dtype, Q, N, P) == expected


@pytest.mark.parametrize("N,ctas", [(128, 2), (64, 3)])
def test_tc_shared_memory_holds_two_ctas_an_sm(N, ctas):
    """At Mamba2-130M's (Q, N, P) = (64, 128, 64) the tensor-core CTA
    (115,456 bytes) leaves room for two on an SM, where the CUDA-core CTA
    (~132 KB) fits once; so the path shape's 8 x 24 CTAs run as one wave."""
    smem = k4.tc_smem_bytes(N)
    assert smem <= k4.MAX_SMEM
    assert k4.ctas_per_sm(smem) == ctas
    assert k4.ctas_per_sm(k4.smem_bytes(64, N, 64)) < ctas
    if N == 128:
        assert smem == 115_456
        assert 8 * 24 <= SMS * k4.ctas_per_sm(smem)
