"""PyTorch port, the SSM and hybrid slice on the CPU: K4's plain version and
differentiable wrapper, the Mamba2 and Zamba2 models, and `LMTask` over
Mamba2 through the replay engine, against the JAX package.

The port's `ssd_scan_ref` and `ops.ssd_scan` against the Pallas kernel in
interpret mode and against `repro.kernels.ref.ssd_scan_ref`; gradients
through `SSDScan` against JAX grads through the kernel's custom_vjp; the
`vmap` rule with a batched ``A`` against a loop.  On the CPU the wrapper's
forward takes the plain version, so these tests pin its wiring; the CUDA
kernel itself is held against the plain version by
`tests/test_torch_gpu.py` and `chip_smoke.py` on the card.  Inputs come
from numpy, from a seed; weights and window offsets are the JAX package's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.configs.base import FLConfig as JFLConfig  # noqa: E402
from repro.fl import engine as j_fl  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as j_ssd  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.models import mamba2 as j_mamba2  # noqa: E402
from repro.models import module as j_module  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.fl import engine as t_fl  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as k4  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import api as t_api  # noqa: E402
from repro_torch.models import hybrid as t_hybrid  # noqa: E402
from repro_torch.models import mamba2 as t_mamba2  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_lm import _batch, _gap, _jleaves, _tasks, _to_port  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}        # tests/test_kernels.py's atol = rtol (y)
STATE_TOL = {"float32": 1e-4, "bfloat16": 1e-2}  # and its state atol
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# (B, S, H, P, N, chunk, A range, dt range): the grid of tests/test_kernels.py,
# then the overflow case — A in -[1, 16] and dt up to 1, where cs_i - cs_j of
# the masked upper triangle reaches ~290 and its exp is inf
OVERFLOW = (2, 128, 3, 32, 16, 64, (1.0, 16.0), (0.0, 1.0))
SHAPES = [
    (2, 128, 3, 32, 16, 32, (0.5, 2.0), (0.01, 0.2)),
    (1, 64, 2, 64, 128, 64, (0.5, 2.0), (0.01, 0.2)),
    (1, 256, 4, 16, 8, 16, (0.5, 2.0), (0.01, 0.2)),
    OVERFLOW,
]
# The overflow row in fp32 against JAX: torch's CPU cumsum accumulates fp32
# in float64, XLA's in fp32, and at |cs| ~ 290 that moves exp(cs_i - cs_j)
# by ~|cs| * 2^-24 relative (measured 3.9e-5 against both JAX versions,
# which agree with each other to 7.6e-8).  On the card the kernel and the
# plain version sum cs in the same fp32 order and are held to 2e-5
# (tests/test_torch_gpu.py, chip_smoke.py).
OVERFLOW_F32_TOL = 1e-4


def _inputs(dtype, B, S, H, P, N, a_range=(0.5, 2.0), dt_range=(0.01, 0.2), seed=0):
    """(x, dt, A, Bm, Cm) for JAX and for the port, from one numpy draw."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = rng.uniform(*dt_range, (B, S, H)).astype(np.float32)
    A = -rng.uniform(*a_range, (H,)).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    jdt, tdt = DT[dtype]
    j = (jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(Bm, jdt), jnp.asarray(Cm, jdt))
    t = (torch.from_numpy(x).to(tdt), torch.from_numpy(dt), torch.from_numpy(A),
         torch.from_numpy(Bm).to(tdt), torch.from_numpy(Cm).to(tdt))
    return j, t


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


# ---------------------------------------------------------------------------
# K4: the plain version and the differentiable wrapper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk,a_range,dt_range", SHAPES)
def test_ref_matches_jax_kernel_and_ref(dtype, B, S, H, P, N, chunk, a_range, dt_range):
    j_in, t_in = _inputs(dtype, B, S, H, P, N, a_range, dt_range)
    overflow = (B, S, H, P, N, chunk, a_range, dt_range) == OVERFLOW
    tol = OVERFLOW_F32_TOL if overflow and dtype == "float32" else TOL[dtype]
    j_kernel = j_ssd(*j_in, chunk=chunk, interpret=True)
    j_plain = j_ref.ssd_scan_ref(*j_in, chunk=chunk)
    # measured allclose gaps of y: fp32 <= 1.1e-6 (the overflow row 3.9e-5),
    # bf16 <= 2.2e-3 (the overflow row 4.2e-3); state max abs <= 5.4e-7
    for y, s in (ref.ssd_scan_ref(*t_in, chunk=chunk), ops.ssd_scan(*t_in, chunk=chunk)):
        assert y.dtype == t_in[0].dtype and y.shape == t_in[0].shape
        assert s.dtype == torch.float32 and s.shape == (B, H, N, P)
        assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(s).all())
        for ey, es in (j_kernel, j_plain):
            np.testing.assert_allclose(_f32(y), _f32(ey), atol=tol, rtol=tol)
            np.testing.assert_allclose(s.numpy(), np.asarray(es), atol=STATE_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_state_matches_jax_ref(dtype):
    """With a state the CPU path runs the plain version, as the reference's
    `ops.ssd_scan` falls back to its jnp reference."""
    j_in, t_in = _inputs(dtype, 2, 64, 3, 16, 8, seed=1)
    h0 = np.random.default_rng(2).normal(size=(2, 3, 8, 16)).astype(np.float32)
    ey, es = j_ref.ssd_scan_ref(*j_in, chunk=16, init_state=jnp.asarray(h0))
    y, s = ops.ssd_scan(*t_in, chunk=16, init_state=torch.from_numpy(h0))
    np.testing.assert_allclose(_f32(y), _f32(ey), atol=TOL[dtype], rtol=TOL[dtype])
    np.testing.assert_allclose(s.numpy(), np.asarray(es), atol=STATE_TOL[dtype])


def test_per_row_A_equals_per_batch_reference():
    """``A`` given per row (B, H), as `SSDScan` takes it: each batch row
    equals the JAX reference with that row's (H,)."""
    j_in, t_in = _inputs("float32", 3, 64, 2, 16, 8)
    A_rows = -np.random.default_rng(3).uniform(0.5, 2.0, (3, 2)).astype(np.float32)
    x, dt, _, Bm, Cm = t_in
    y, s = ref.ssd_scan_ref(x, dt, torch.from_numpy(A_rows), Bm, Cm, chunk=32)
    y2, s2 = ops.ssd_scan(x, dt, torch.from_numpy(A_rows), Bm, Cm, chunk=32)
    assert torch.equal(y, y2) and torch.equal(s, s2)
    jx, jdt, _, jB, jC = j_in
    for b in range(3):
        ey, es = j_ref.ssd_scan_ref(jx[b:b + 1], jdt[b:b + 1], jnp.asarray(A_rows[b]),
                                    jB[b:b + 1], jC[b:b + 1], chunk=32)
        np.testing.assert_allclose(y[b:b + 1].numpy(), np.asarray(ey), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(s[b:b + 1].numpy(), np.asarray(es), atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["func", "autograd"])
def test_grads_match_jax_custom_vjp(dtype, mode):
    """Grads of all five inputs through `SSDScan` vs `jax.grad` through the
    kernel's custom_vjp, with tests/test_lm_engine.py's linear probe loss
    over both outputs."""
    j_in, t_in = _inputs(dtype, 1, 64, 2, 16, 8, seed=4)
    rng = np.random.default_rng(5)
    py = rng.normal(size=(1, 64, 2, 16)).astype(np.float32)
    ps = rng.normal(size=(1, 2, 8, 16)).astype(np.float32)

    def j_loss(x, dt, A, Bm, Cm):
        y, s = j_ssd(x, dt, A, Bm, Cm, chunk=32, interpret=True)
        return jnp.sum(y.astype(jnp.float32) * py) + jnp.sum(s * ps)

    jg = jax.grad(j_loss, argnums=(0, 1, 2, 3, 4))(*j_in)
    tpy, tps = torch.from_numpy(py), torch.from_numpy(ps)

    def loss(x, dt, A, Bm, Cm):
        y, s = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=32)
        return torch.sum(y.float() * tpy) + torch.sum(s * tps)

    if mode == "func":
        tg = torch.func.grad(loss, argnums=(0, 1, 2, 3, 4))(*t_in)
    else:
        leaves = [t.clone().requires_grad_(True) for t in t_in]
        loss(*leaves).backward()
        tg = [t.grad for t in leaves]
    # measured allclose gaps: fp32 1.3e-5 (grads up to 109), bf16 5.6e-3
    for a, b, t in zip(tg, jg, t_in):
        assert a.dtype == t.dtype and a.shape == t.shape
        np.testing.assert_allclose(_f32(a), _f32(b), atol=TOL[dtype], rtol=TOL[dtype])


def test_vmap_rule_is_one_call_equal_to_a_loop(monkeypatch):
    """Under `vmap` with a batched ``A`` (one per lane, as the blocked
    engine's snapshots give) `SSDScan` makes one forward call over the lanes
    folded into B — on the card one launch — with plain tensors, and equals a
    loop over the lanes; likewise under ``vmap(grad(...))``."""
    seen = []
    forward = k4._forward

    def spy(x, dt, A, *args):
        seen.append((tuple(x.shape), tuple(A.shape), torch._C._functorch.is_functorch_wrapped_tensor(x)))
        return forward(x, dt, A, *args)

    monkeypatch.setattr(k4, "_forward", spy)
    _, (x, dt, A, Bm, Cm) = _inputs("float32", 2, 32, 3, 8, 4)
    xs, dts, Bs, Cs = (torch.stack([t, 0.5 * t, 2.0 * t]) for t in (x, dt, Bm, Cm))
    As = torch.stack([A, 2.0 * A, 0.25 * A])  # a different A on every lane
    y, s = torch.func.vmap(lambda *a: ops.ssd_scan(*a, chunk=16))(xs, dts, As, Bs, Cs)
    assert seen == [((6, 32, 3, 8), (6, 3), False)]
    for i in range(3):
        ey, es = ref.ssd_scan_ref(xs[i], dts[i], As[i], Bs[i], Cs[i], chunk=16)
        torch.testing.assert_close(y[i], ey, atol=1e-6, rtol=0)
        torch.testing.assert_close(s[i], es, atol=1e-6, rtol=0)
    # vmap over grad, as the blocked engine differentiates; A's gradient
    # sums over the batch rows (A is expanded from (H,) to (B, H))
    seen.clear()
    probe = torch.randn(2, 32, 3, 8, generator=torch.Generator().manual_seed(0))

    def loss(x, dt, A, Bm, Cm):
        return torch.sum(ops.ssd_scan(x, dt, A, Bm, Cm, chunk=16)[0] * probe)

    g = torch.func.vmap(torch.func.grad(loss, argnums=(0, 2)))(xs, dts, As, Bs, Cs)
    assert seen == [((6, 32, 3, 8), (6, 3), False)]
    for i in range(3):
        gi = torch.func.grad(
            lambda x, A: torch.sum(ref.ssd_scan_ref(x, dts[i], A, Bs[i], Cs[i], chunk=16)[0] * probe),
            argnums=(0, 1))(xs[i], As[i])
        assert g[1][i].shape == (3,)
        for a, b in zip((g[0][i], g[1][i]), gi):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-6)
    # an unbatched operand is broadcast across the mapped dimension
    y, _ = torch.func.vmap(lambda x: ops.ssd_scan(x, dt, A, Bm, Cm, chunk=16))(xs)
    torch.testing.assert_close(y[2], ref.ssd_scan_ref(xs[2], dt, A, Bm, Cm, chunk=16)[0],
                               atol=1e-6, rtol=0)


def test_other_devices_raise():
    x = torch.empty((1, 4, 2, 8), device="meta")
    dt = torch.empty((1, 4, 2), device="meta")
    B = torch.empty((1, 4, 4), device="meta")
    with pytest.raises(NotImplementedError, match="no kernel for device"):
        ops.ssd_scan(x, dt, torch.empty((2,), device="meta"), B, B)


def test_init_state_on_cuda_raises_naming_item_11(monkeypatch):
    """On a CUDA tensor a given state takes the plain version, as the
    reference's dispatch does on every backend, and launches nothing.  (The
    name is kept from when the port raised here instead; dispatch is
    `device.on_cuda`, here forced to True, and a launch would fail on the
    CPU tensor.)"""
    monkeypatch.setattr(ops, "on_cuda", lambda t: True)
    monkeypatch.setattr(k4, "on_cuda", lambda t: True)
    _, t_in = _inputs("float32", 1, 16, 2, 8, 4)
    h0 = torch.from_numpy(np.random.default_rng(4).normal(size=(1, 2, 4, 8)).astype(np.float32))
    k4.reset_launches()
    y, s = ops.ssd_scan(*t_in, chunk=16, init_state=h0)
    ey, es = ref.ssd_scan_ref(*t_in, chunk=16, init_state=h0)
    assert k4.launches["ssd_scan"] == 0
    assert torch.equal(y, ey) and torch.equal(s, es)


@pytest.mark.parametrize("card", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_state_matches_jax_ops_on_either_route(monkeypatch, card, dtype):
    """`ops.ssd_scan` with a state against the JAX package's `ops.ssd_scan`
    with the same state, on the CUDA route (`on_cuda` forced True) and the
    CPU route alike: both take the plain version."""
    from repro.kernels import ops as j_ops

    monkeypatch.setattr(ops, "on_cuda", lambda t: card)
    j_in, t_in = _inputs(dtype, 2, 64, 3, 16, 8, seed=6)
    h0 = np.random.default_rng(7).normal(size=(2, 3, 8, 16)).astype(np.float32)
    ey, es = j_ops.ssd_scan(*j_in, chunk=16, init_state=jnp.asarray(h0))
    y, s = ops.ssd_scan(*t_in, chunk=16, init_state=torch.from_numpy(h0))
    assert y.dtype == t_in[0].dtype and s.dtype == torch.float32
    np.testing.assert_allclose(_f32(y), _f32(ey), atol=TOL[dtype], rtol=TOL[dtype])
    np.testing.assert_allclose(s.numpy(), np.asarray(es), atol=STATE_TOL[dtype])


def test_cuda_wrapper_rejects_bad_operands():
    """The CUDA wrapper checks shapes, dtypes, the chunking and its shared
    memory before anything is built."""
    _, (x, dt, A, Bm, Cm) = _inputs("float32", 2, 64, 3, 16, 8)
    A2 = A.expand(2, 3)
    with pytest.raises(ValueError, match="shapes"):
        k4.ssd_scan_fwd(x, dt, A, Bm, Cm)  # A must be per row
    with pytest.raises(ValueError, match="do not agree"):
        k4.ssd_scan_fwd(x, dt[:, :32], A2, Bm, Cm)
    with pytest.raises(ValueError, match="chunk"):
        k4.ssd_scan_fwd(x, dt, A2, Bm, Cm, chunk=48)
    with pytest.raises(TypeError, match="one dtype"):
        k4.ssd_scan_fwd(x, dt, A2, Bm.bfloat16(), Cm)
    with pytest.raises(TypeError, match="not supported"):
        k4.ssd_scan_fwd(x.half(), dt, A2, Bm.half(), Cm.half())
    # (Q, N, P) = (128, 128, 64), the Pallas docstring's shape, needs 258 KB
    big = torch.zeros((1, 128, 1, 64)), torch.zeros((1, 128, 1)), torch.zeros((1, 1))
    with pytest.raises(ValueError, match="shared memory"):
        k4.ssd_scan_fwd(*big, torch.zeros((1, 128, 128)), torch.zeros((1, 128, 128)), chunk=128)
    assert k4.smem_bytes(64, 128, 64) <= k4.MAX_SMEM and k4.smem_bytes(64, 64, 64) <= k4.MAX_SMEM


# ---------------------------------------------------------------------------
# the Mamba2 pieces and the two models against the reference
# ---------------------------------------------------------------------------


def test_mamba2_pieces_match_reference():
    """`_segsum`, `_causal_conv` and `ssd_chunked` (fp32) on the same inputs."""
    rng = np.random.default_rng(6)
    a = -rng.uniform(0.0, 1.0, (3, 16)).astype(np.float32)
    seg_t, seg_j = t_mamba2._segsum(torch.from_numpy(a)).numpy(), np.asarray(j_mamba2._segsum(jnp.asarray(a)))
    np.testing.assert_array_equal(np.isinf(seg_t), np.isinf(seg_j))
    np.testing.assert_allclose(np.where(np.isinf(seg_t), 0, seg_t), np.where(np.isinf(seg_j), 0, seg_j),
                               atol=1e-6)
    xBC, w, b = (rng.normal(size=s).astype(np.float32) for s in ((2, 9, 12), (4, 12), (12,)))
    np.testing.assert_allclose(
        t_mamba2._causal_conv(*map(torch.from_numpy, (xBC, w, b))).numpy(),
        np.asarray(j_mamba2._causal_conv(*map(jnp.asarray, (xBC, w, b)))), atol=1e-6)
    j_in, t_in = _inputs("float32", 2, 64, 3, 16, 8, seed=7)
    for a, b in zip(t_mamba2.ssd_chunked(*t_in, 16), j_mamba2.ssd_chunked(*j_in, 16)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)


# bf16 gaps (logits, grads) relative to the reference's largest magnitude,
# measured with the plain / kernel path: Mamba2 (1.4e-2, 1.6e-2) both;
# Zamba2 (1.5e-2, 2.2e-2) / (2.0e-2, 2.9e-2) — six bf16 blocks (attention,
# FFN and Mamba2, twice) in which the frameworks round at other places, and
# on the kernel path the port's CPU attention casts the softmax weights to
# bf16 where the Pallas kernel keeps them fp32.  So the hybrid is held to
# 10 bf16 ulps (4e-2), as tests/test_torch_gpu.py holds bf16 grads.
BF16_TOL = {"mamba2-130m": 2e-2, "zamba2-2.7b": 4e-2}


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
@pytest.mark.parametrize("dtype,use_pallas", [
    ("float32", False),   # measured: logits <= 1.9e-6, grads <= 2.2e-6 (x max)
    ("float32", True),    # measured: logits <= 2.1e-6, grads <= 2.0e-6
    ("bfloat16", False),
    ("bfloat16", True),
])
def test_forward_and_grads_match_reference(arch, dtype, use_pallas):
    """Logits and loss gradients of the smoke configs on converted weights,
    each gap relative to the reference's largest magnitude: fp32 within
    1e-5, bf16 within `BF16_TOL` (bf16 rounds at other places in the two
    frameworks)."""
    tol = 1e-5 if dtype == "float32" else BF16_TOL[arch]
    jcfg = j_configs.smoke_config(arch).replace(dtype=dtype, use_pallas=use_pallas)
    cfg = t_configs.smoke_config(arch).replace(dtype=dtype, use_pallas=use_pallas)
    j_p = j_module.init_params(j_api.model_meta(jcfg), jax.random.PRNGKey(0))
    t_p = _to_port(j_p)
    j_b, t_b = _batch(jcfg, S=32)
    t_logits = t_api.forward(t_p, t_b, cfg)[0]
    j_logits = np.asarray(j_api.forward(j_p, j_b, jcfg)[0].astype(jnp.float32))
    assert t_logits.dtype == getattr(torch, dtype)
    assert np.abs(t_logits.float().numpy() - j_logits).max() <= tol * np.abs(j_logits).max()
    j_g = jax.grad(lambda p: j_api.loss_fn(p, j_b, jcfg)[0])(j_p)
    t_g = torch.func.grad(lambda p: t_api.loss_fn(p, t_b, cfg)[0])(t_p)
    scale = max(float(np.abs(g.astype(np.float32)).max()) for g in _jleaves(j_g))
    assert _gap(t_g, j_g) <= tol * scale
    assert [x.dtype for x in tree_leaves(t_g)] == [x.dtype for x in tree_leaves(t_p)]


def test_family_modules_and_shared_sites():
    assert t_api.family_module(t_configs.smoke_config("mamba2-130m")) is t_mamba2
    assert t_api.family_module(t_configs.smoke_config("zamba2-2.7b")) is t_hybrid
    cfg = t_configs.get_config("zamba2-2.7b")
    assert t_hybrid.num_shared_sites(cfg) == 9 and cfg.num_layers % cfg.attn_every == 0


def test_hybrid_trailing_layers_match_reference():
    """A backbone that does not divide into segments (3 layers, a shared
    block every 2): the trailing layer runs after the last segment."""
    upd = dict(num_layers=3, attn_every=2)
    jcfg = j_configs.smoke_config("zamba2-2.7b").replace(**upd)
    cfg = t_configs.smoke_config("zamba2-2.7b").replace(**upd)
    j_p = j_module.init_params(j_api.model_meta(jcfg), jax.random.PRNGKey(1))
    j_b, t_b = _batch(jcfg, S=16)
    np.testing.assert_allclose(t_api.forward(_to_port(j_p), t_b, cfg)[0].numpy(),
                               np.asarray(j_api.forward(j_p, j_b, jcfg)[0]), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_decode_entry_points_raise(arch):
    """Decode (item 11) is ported: the family's `init_cache` is the api's,
    and a prompt decoded token by token from the empty cache gives the
    last position's logits of the full-sequence forward (the reference's
    bar, 2e-4; per-step parity with the reference is in
    `tests/test_torch_decode.py`)."""
    from repro_torch.launch.serve import materialize_cache
    from repro_torch.models import module as t_module

    cfg = t_configs.smoke_config(arch)
    mod = t_api.family_module(cfg)
    assert mod.init_cache(cfg, 1, 8) == t_api.init_cache(cfg, 1, 8)
    params = t_module.init_params(t_api.model_meta(cfg), 1, "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 8)))
    cache = materialize_cache(mod.init_cache(cfg, 1, 8), "cpu")
    with torch.no_grad():
        full, _ = t_api.forward(params, {"tokens": toks}, cfg)
        for t in range(8):
            logits, cache = mod.decode_step(params, cache, {"tokens": toks[:, t:t + 1]}, cfg)
    np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(), atol=2e-4)
    assert cache["ssm"].dtype == torch.float32 and int(cache["pos"]) == 8


# ---------------------------------------------------------------------------
# LMTask over Mamba2 through the engines
# ---------------------------------------------------------------------------

N, C, T = 4, 2, 8


@pytest.mark.parametrize("block_size", [1, 4])
def test_mamba2_run_experiment_matches_jax(block_size):
    """Per-event and blocked (``vmap(grad(loss))`` over E snapshots, one A
    per lane) replay of the Mamba2 smoke config with K4's wrapper
    (``use_pallas``), against JAX's on shared weights and window offsets.
    The mixed bf16/fp32 tree of the full config packs its ring in fp32; the
    smoke config is all fp32."""
    (j_task, _), (t_task, _) = _tasks(arch="mamba2-130m")
    kw = dict(n_clients=N, concurrency=C, server_steps=T, sampling="uniform", block_size=block_size)
    rj = j_fl.run_experiment(JFLConfig(**kw), "gen_async", eval_every=T // 2, engine="scan",
                             task=j_task)
    rt = t_fl.run_experiment(FLConfig(device="cpu", **kw), "gen_async", eval_every=T // 2,
                             engine="scan", task=t_task)
    np.testing.assert_array_equal(rt.eval_steps, rj.eval_steps)
    np.testing.assert_allclose(rt.eval_acc, rj.eval_acc, atol=1e-4)  # measured <= 1.4e-6
    assert _gap(rt.final_params, rj.final_params) <= 1e-4  # measured <= 2.4e-7
    assert rt.extras["grad_calls"] == T


def test_cli_lm_mode_runs_mamba2_on_cpu(capsys):
    t_train.main(["--mode", "lm", "--arch", "mamba2-130m", "--device", "cpu", "--clients", "4",
                  "--concurrency", "2", "--steps", "4", "--batch", "2", "--seq", "16",
                  "--shard-size", "32", "--eval-every", "2", "--block-size", "2"])
    out = capsys.readouterr().out
    losses = [float(line.split()[-1]) for line in out.splitlines() if "eval_loss" in line]
    assert len(losses) == 2 and all(np.isfinite(losses))
