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
    assert cuda_kernels.launches["weighted_update"] == 300 * 6
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


def test_engine_matches_python_oracle_on_card(dev):
    setup, mu = _setup(dev)
    cfg = ServerConfig(n=16, C=4, T=150, eta=0.05, mu=mu, device="cuda")
    w_py, _ = run_generalized_async_sgd(setup.params, setup.clients, cfg)
    w_sc, _ = run_generalized_async_sgd(setup.params, setup.clients,
                                        replace(cfg, engine="scan", update="pallas"))
    assert max(_err(w_py[k], w_sc[k]) for k in w_py) <= 1e-5


# K3 shapes (B, S, H, K, D, T, window, q_offset), as chip_smoke.py checks them:
# the grid of tests/test_kernels.py, Granite-3.0-2B's path shape, a long
# causal sequence with and without a window, D=80 and D=128 with ragged S and
# T, and rows whose every key is masked (T a multiple of the key tile or not)
FA_SHAPES = [
    (2, 128, 4, 2, 64, 128, 0, 0),
    (1, 256, 8, 4, 64, 256, 64, 0),
    (1, 64, 4, 1, 128, 64, 0, 0),
    (1, 128, 4, 4, 128, 384, 0, 256),
    (2, 64, 6, 2, 32, 64, 16, 0),
    (8, 128, 32, 8, 64, 128, 0, 0),
    (1, 2048, 32, 8, 64, 2048, 0, 0),
    (1, 2048, 32, 8, 64, 2048, 512, 0),
    (2, 100, 8, 2, 80, 100, 0, 0),
    (1, 200, 4, 2, 128, 333, 0, 133),
    (1, 64, 4, 2, 64, 64, 16, 200),
    (1, 40, 2, 1, 64, 50, 8, 100),
]


def _qkv(dev, dtype, B, S, H, K, D, T, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen).to(dev, dtype)
                 for shape in ((B, S, H, D), (B, T, K, D), (B, T, K, D)))


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


def test_ssd_scan_init_state_raises_on_card(dev):
    x, dt, A, Bm, Cm = _ssd_inputs(dev, torch.float32, 1, 64, 2, 16, 8, (0.5, 2.0), (0.01, 0.2))
    with pytest.raises(NotImplementedError, match="item 11"):
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=32, init_state=torch.zeros((1, 2, 8, 16), device=dev))


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
