"""PyTorch port, the MoE slice on the CPU: K5's plain version and
differentiable wrapper, the routing (GShard one-hot and sort dispatch), the
MoE block, the Qwen1.5-MoE and Arctic smoke models, and `LMTask` over
Qwen1.5-MoE through the replay engine, against the JAX package.

The port's `moe_gmm_ref` and `ops.moe_gmm` against the Pallas kernel in
interpret mode and against `repro.kernels.ref.moe_gmm_ref`; gradients
through `MoeGMM` against JAX grads through the kernel's custom_vjp; the
`vmap` rule against a loop.  On the CPU the wrapper's forward takes the
plain version, so these tests pin its wiring; the CUDA kernel itself is
held against the plain version by `tests/test_torch_gpu.py` and
`chip_smoke.py` on the card.  Inputs come from numpy, from a seed; weights
and window offsets are the JAX package's (`params_from_numpy`).  The JAX
interpret-mode kernel needs C, D and F divisible by its tiles
(``min(128, dim)``), so every shape here is one it takes; the port's kernel
takes any shape, and its ragged cases are tested on the card.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.configs.base import FLConfig as JFLConfig  # noqa: E402
from repro.core import ServerConfig as JServerConfig  # noqa: E402
from repro.core import run_generalized_async_sgd as j_run  # noqa: E402
from repro.fl import engine as j_fl  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.moe_gmm import moe_gmm as j_gmm  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import module as j_module  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.core import ServerConfig, run_generalized_async_sgd  # noqa: E402
from repro_torch.fl import engine as t_fl  # noqa: E402
from repro_torch.kernels import moe_gmm as k5  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import api as t_api  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import transformer as t_transformer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_lm import _batch, _gap, _jleaves, _tasks, _to_port  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py's atol = rtol
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ARCHS = ["qwen2-moe-a2.7b", "arctic-480b"]
# (E, C, D, F): the grid of tests/test_kernels.py
GMM_SHAPES = [(4, 256, 128, 256), (2, 128, 256, 128), (8, 64, 64, 64)]


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


def _both(a: np.ndarray, dtype: str):
    jdt, tdt = DT[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _gmm_inputs(dtype, E, C, D, F, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(E, C, D)).astype(np.float32)
    w = rng.normal(size=(E, D, F)).astype(np.float32)
    (jx, tx), (jw, tw) = _both(x, dtype), _both(w, dtype)
    return (jx, jw), (tx, tw)


# ---------------------------------------------------------------------------
# K5: the plain version and the differentiable wrapper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,D,F", GMM_SHAPES)
def test_gmm_ref_and_wrapper_match_jax(dtype, E, C, D, F):
    (jx, jw), (tx, tw) = _gmm_inputs(dtype, E, C, D, F)
    bc, bf, bd = min(128, C), min(128, F), min(128, D)
    j_kernel = j_gmm(jx, jw, bc=bc, bf=bf, bd=bd, interpret=True)
    j_plain = j_ref.moe_gmm_ref(jx, jw)
    for y in (ref.moe_gmm_ref(tx, tw), ops.moe_gmm(tx, tw)):
        assert y.dtype == tx.dtype and y.shape == (E, C, F)
        for e in (j_kernel, j_plain):
            np.testing.assert_allclose(_f32(y), _f32(e), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["func", "autograd"])
def test_gmm_grads_match_jax_custom_vjp(dtype, mode):
    """Grads of x and w through `MoeGMM` vs `jax.grad` through the kernel's
    custom_vjp, on tests/test_lm_engine.py's case (E, C, D, F) = (2, 64,
    64, 64) with its linear probe loss."""
    (jx, jw), (tx, tw) = _gmm_inputs(dtype, 2, 64, 64, 64, seed=1)
    probe = np.random.default_rng(2).normal(size=(2, 64, 64)).astype(np.float32)
    jg = jax.grad(lambda x, w: jnp.sum(
        j_gmm(x, w, bc=64, bf=64, bd=64, interpret=True).astype(jnp.float32) * probe),
        argnums=(0, 1))(jx, jw)
    tprobe = torch.from_numpy(probe)

    def loss(x, w):
        return torch.sum(ops.moe_gmm(x, w).float() * tprobe)

    if mode == "func":
        tg = torch.func.grad(loss, argnums=(0, 1))(tx, tw)
    else:
        leaves = [t.clone().requires_grad_(True) for t in (tx, tw)]
        loss(*leaves).backward()
        tg = [t.grad for t in leaves]
    for a, b, t in zip(tg, jg, (tx, tw)):
        assert a.dtype == t.dtype and a.shape == t.shape
        np.testing.assert_allclose(_f32(a), _f32(b), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("mapped", ["both", "x", "w"])
def test_gmm_vmap_rule_is_one_call_equal_to_a_loop(monkeypatch, mapped):
    """Under `vmap` `MoeGMM` makes one forward call — on the card one
    launch — on plain tensors with the mapped dimension folded into E
    (x and w mapped, or w alone) or into C (x alone), and equals a loop;
    likewise under ``vmap(grad(...))``, as the blocked engine
    differentiates."""
    seen = []
    forward = k5._forward

    def spy(x, w):
        seen.append((tuple(x.shape), tuple(w.shape),
                     torch._C._functorch.is_functorch_wrapped_tensor(x)))
        return forward(x, w)

    monkeypatch.setattr(k5, "_forward", spy)
    _, (x, w) = _gmm_inputs("float32", 2, 12, 16, 8, seed=3)
    xs = torch.stack([x, 0.5 * x, -x]) if mapped != "w" else x
    ws = torch.stack([w, 2.0 * w, w.flip(0)]) if mapped != "x" else w
    dims = (0 if mapped != "w" else None, 0 if mapped != "x" else None)
    want = {"both": ((6, 12, 16), (6, 16, 8)), "x": ((2, 36, 16), (2, 16, 8)),
            "w": ((6, 12, 16), (6, 16, 8))}[mapped]
    y = torch.func.vmap(ops.moe_gmm, in_dims=dims)(xs, ws)
    assert seen == [(*want, False)]

    def lane(i):
        return (xs[i] if dims[0] is not None else x), (ws[i] if dims[1] is not None else w)

    for i in range(3):
        torch.testing.assert_close(y[i], ref.moe_gmm_ref(*lane(i)), atol=1e-6, rtol=0)
    seen.clear()
    probe = torch.randn(2, 12, 8, generator=torch.Generator().manual_seed(0))
    g = torch.func.vmap(torch.func.grad(
        lambda x, w: torch.sum(ops.moe_gmm(x, w) * probe), argnums=(0, 1)), in_dims=dims)(xs, ws)
    assert seen == [(*want, False)]
    for i in range(3):
        gi = torch.func.grad(lambda x, w: torch.sum(ref.moe_gmm_ref(x, w) * probe),
                             argnums=(0, 1))(*lane(i))
        for a, b in zip((g[0][i], g[1][i]), gi):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-6)


def test_gmm_other_devices_raise():
    x, w = torch.empty((2, 4, 8), device="meta"), torch.empty((2, 8, 4), device="meta")
    with pytest.raises(NotImplementedError, match="no kernel for device"):
        ops.moe_gmm(x, w)


def test_gmm_cuda_wrapper_rejects_bad_operands():
    """The CUDA wrapper checks dtypes, ranks, the inner dimensions, the
    expert count and the device before anything is built."""
    _, (x, w) = _gmm_inputs("float32", 2, 8, 16, 4)
    with pytest.raises(TypeError, match="one dtype"):
        k5.moe_gmm_fwd(x, w.bfloat16())
    with pytest.raises(TypeError, match="not supported"):
        k5.moe_gmm_fwd(x.half(), w.half())
    with pytest.raises(ValueError, match="shapes"):
        k5.moe_gmm_fwd(x, w[:, :8])
    with pytest.raises(ValueError, match="shapes"):
        k5.moe_gmm_fwd(x[0], w[0])
    with pytest.raises(ValueError, match="experts per launch"):
        k5.moe_gmm_fwd(torch.zeros((65536, 1, 1)), torch.zeros((65536, 1, 1)))
    with pytest.raises(ValueError, match="CUDA"):
        k5.moe_gmm_fwd(x, w)  # CPU tensors


# ---------------------------------------------------------------------------
# routing and the MoE block against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25, 2.0])
def test_capacity_matches_jax(cf):
    cfg, jcfg = t_configs.smoke_config(ARCHS[0]), j_configs.smoke_config(ARCHS[0])
    for N in (1, 7, 32, 96, 512, 1024, 4096):
        for E, k in ((4, 1), (4, 2), (60, 4), (128, 2)):
            upd = dict(num_experts=E, num_experts_per_tok=k, capacity_factor=cf)
            assert t_layers._capacity(N, cfg.replace(**upd)) == \
                j_layers._capacity(N, jcfg.replace(**upd))
    # the full-width slice: one group of 8 x 128 tokens, 60 experts, top-4
    assert t_layers._capacity(1024, t_configs.get_config(ARCHS[0])) == 88
    assert t_layers._capacity(512, t_configs.get_config(ARCHS[1])) == 12


def _moe_params(arch, seed, **upd):
    jcfg = j_configs.smoke_config(arch).replace(**upd)
    cfg = t_configs.smoke_config(arch).replace(**upd)
    j_p = j_module.init_params(j_layers.moe_meta(jcfg), jax.random.PRNGKey(seed))
    return (jcfg, j_p), (cfg, _to_port(j_p))


def _kept(cfg, params, xg: np.ndarray) -> int:
    """Routed (token, expert) pairs that fit their expert's capacity."""
    _, _, idx = t_layers._router(params, torch.from_numpy(xg), cfg)
    counts = np.bincount(idx.numpy().ravel(), minlength=cfg.num_experts)
    return int(np.minimum(counts, t_layers._capacity(xg.shape[0], cfg)).sum())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_route_group_matches_jax(arch, dispatch, cf):
    """One token group through each dispatch, fp32: out within 1e-5, aux
    within 1e-6.  At capacity factor 0.5 tokens are dropped."""
    (jcfg, j_p), (cfg, t_p) = _moe_params(arch, 1, capacity_factor=cf)
    xg = np.random.default_rng(7).normal(size=(96, cfg.d_model)).astype(np.float32)
    kept = _kept(cfg, t_p, xg)
    assert (kept < 96 * cfg.num_experts_per_tok) == (cf == 0.5)
    j_fn = j_layers._route_group_sorted if dispatch == "sort" else j_layers._route_group
    t_fn = t_layers._route_group_sorted if dispatch == "sort" else t_layers._route_group
    jo, ja = j_fn(j_p, jnp.asarray(xg), jcfg)
    to, ta = t_fn(t_p, torch.from_numpy(xg), cfg)
    assert to.shape == (96, cfg.d_model) and to.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_sort_dispatch_equals_einsum_in_port(arch):
    """tests/test_models.py's check inside the port: the sort dispatch
    gives the one-hot dispatch's slots and drops, so the same outputs."""
    _, (cfg, t_p) = _moe_params(arch, 1)
    xg = torch.from_numpy(np.random.default_rng(7).normal(size=(96, cfg.d_model)).astype(np.float32))
    o1, a1 = t_layers._route_group(t_p, xg, cfg)
    o2, a2 = t_layers._route_group_sorted(t_p, xg, cfg)
    torch.testing.assert_close(o1, o2, atol=1e-5, rtol=0)
    torch.testing.assert_close(a1, a2, atol=1e-6, rtol=0)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sort_dispatch_grads_repeat_bitwise(dtype, use_pallas):
    """Two gradient calls through the sort dispatch, of the token group and
    of every weight, are bitwise equal.  Its gather of each token's k copies
    is a ``repeat``, whose backward sums the k gradients in k order (an
    ``index_select`` over ``arange(N).repeat(k)`` would add them with
    atomics on the card, in no fixed order)."""
    _, (cfg, t_p) = _moe_params(ARCHS[0], 3, moe_dispatch="sort", use_pallas=use_pallas)
    tdt = DT[dtype][1]
    t_p = {k: v.to(tdt) if v.is_floating_point() else v for k, v in t_p.items()}
    xg = torch.from_numpy(
        np.random.default_rng(9).normal(size=(96, cfg.d_model)).astype(np.float32)).to(tdt)
    probe = torch.from_numpy(
        np.random.default_rng(10).normal(size=(96, cfg.d_model)).astype(np.float32))

    def loss(p, x):
        out, aux = t_layers._route_group_sorted(p, x, cfg)
        return torch.sum(out.float() * probe) + aux

    g1 = torch.func.grad(loss, argnums=(0, 1))(t_p, xg)
    g2 = torch.func.grad(loss, argnums=(0, 1))(t_p, xg)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g1), tree_leaves(g2)))
    assert float(g1[1].float().abs().max()) > 0


@pytest.mark.parametrize("dispatch,use_pallas", [("einsum", False), ("sort", False),
                                                 ("sort", True)])
@pytest.mark.parametrize("arch,group", [
    ("qwen2-moe-a2.7b", 128),  # shared experts, one group
    ("arctic-480b", 128),      # dense residual, one group
    ("qwen2-moe-a2.7b", 16),   # two groups along S
])
def test_moe_block_matches_jax(arch, group, dispatch, use_pallas):
    (jcfg, j_p), (cfg, t_p) = _moe_params(arch, 2, moe_group_size=group, moe_dispatch=dispatch,
                                          use_pallas=use_pallas)
    x = np.random.default_rng(8).normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    jo, ja = j_layers.moe_block(j_p, jnp.asarray(x), jcfg)
    to, ta = t_layers.moe_block(t_p, torch.from_numpy(x), cfg)
    assert ("ws_gate" in t_p) == (arch == ARCHS[0]) and ("wd_gate" in t_p) == (arch == ARCHS[1])
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6)


def test_moe_block_kernel_calls_per_group(monkeypatch):
    """Under the sort dispatch with ``use_pallas`` every group makes three
    K5 calls (gate, up, down); the einsum dispatch makes none."""
    calls = []
    forward = k5._forward
    monkeypatch.setattr(k5, "_forward", lambda x, w: calls.append(x.shape) or forward(x, w))
    _, (cfg, t_p) = _moe_params(ARCHS[0], 2, moe_group_size=16, moe_dispatch="sort",
                                use_pallas=True)
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(2, 32, cfg.d_model)).astype(np.float32))
    t_layers.moe_block(t_p, x, cfg)
    cap = t_layers._capacity(32, cfg)
    assert calls == [(4, cap, 256), (4, cap, 256), (4, cap, 128)] * 2
    calls.clear()
    t_layers.moe_block(t_p, x, cfg.replace(moe_dispatch="einsum"))
    assert calls == []


# ---------------------------------------------------------------------------
# the two smoke models against the reference
# ---------------------------------------------------------------------------

# bf16 rounds at other places in the two frameworks (the dispatch einsums,
# silu, the shared / dense branches; with ``use_pallas`` the port's CPU
# attention is the plain version, which casts the softmax weights to bf16,
# while the JAX side runs the Pallas kernel, which does not).  Routing is
# discontinuous: a token whose k-th and (k+1)-th router probabilities lie
# closer than the bf16 noise on the router's input (~1e-4 here: logits of
# std ~0.1 over 4 experts) may pick another expert in one package than in
# the other.  Measured without the mask below: Arctic's token (1, 15), at a
# margin of 1.8e-4, flips with ``use_pallas`` and moves its logits by 0.25 of
# the largest.  So in bf16 the tokens within `NEAR_TIE` (about ten times
# that noise; 4 to 9 of the 64 tokens) are left out of the logits compared
# and, through the same ``loss_mask`` in both packages, out of the loss.
# Measured gaps of the rest, relative to the reference's largest magnitude:
# logits <= 1.4e-2, grads <= 1.9e-2 (Arctic, sort dispatch) — several bf16
# blocks, as in the hybrid (tests/test_torch_ssm.py), so held to 10 bf16
# ulps (4e-2).  fp32 is compared on every token.
BF16_TOL = 4e-2
NEAR_TIE = 1e-3


def _router_margins(monkeypatch, fn):
    """``fn()``'s result and, per token, the smallest gap between the k-th
    and (k+1)-th router probability over the port's MoE layers (one
    dispatch group per layer, rows in (b, s) order)."""
    margins, router = [], t_layers._router

    def spy(params, xg, cfg):
        probs, gates, idx = router(params, xg, cfg)
        top = torch.topk(probs, cfg.num_experts_per_tok + 1, dim=-1).values
        margins.append(top[:, -2] - top[:, -1])
        return probs, gates, idx

    monkeypatch.setattr(t_layers, "_router", spy)
    out = fn()
    monkeypatch.setattr(t_layers, "_router", router)
    return out, torch.stack(margins).min(dim=0).values.numpy()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
@pytest.mark.parametrize("dtype,use_pallas", [
    ("float32", False),   # measured: logits <= 1.5e-6, grads <= 1.5e-6 (x max)
    ("float32", True),    # measured: logits <= 1.4e-6, grads <= 1.6e-6
    ("bfloat16", False),
    ("bfloat16", True),
])
def test_forward_and_grads_match_reference(monkeypatch, arch, dispatch, dtype, use_pallas):
    """Logits, aux and loss gradients of the smoke configs on converted
    weights, each gap relative to the reference's largest magnitude: fp32
    within 1e-5 on every token, bf16 within `BF16_TOL` away from routing
    near-ties."""
    tol = 1e-5 if dtype == "float32" else BF16_TOL
    upd = dict(dtype=dtype, use_pallas=use_pallas, moe_dispatch=dispatch)
    jcfg = j_configs.smoke_config(arch).replace(**upd)
    cfg = t_configs.smoke_config(arch).replace(**upd)
    j_p = j_module.init_params(j_api.model_meta(jcfg), jax.random.PRNGKey(0))
    t_p = _to_port(j_p)
    j_b, t_b = _batch(jcfg, S=32)
    (t_logits, t_aux), margin = _router_margins(monkeypatch, lambda: t_api.forward(t_p, t_b, cfg))
    j_logits, j_aux = j_api.forward(j_p, j_b, jcfg)
    j_logits = np.asarray(j_logits.astype(jnp.float32))
    keep = margin.reshape(2, 32) >= (NEAR_TIE if dtype == "bfloat16" else 0.0)
    assert keep.mean() >= 0.85
    assert t_logits.dtype == getattr(torch, dtype)
    gap = np.abs(t_logits.float().numpy() - j_logits).max(axis=-1)
    assert gap[keep].max() <= tol * np.abs(j_logits).max()
    np.testing.assert_allclose(float(t_aux), float(j_aux), rtol=tol)
    if not keep.all():
        j_b = dict(j_b, loss_mask=jnp.asarray(keep, jnp.float32))
        t_b = dict(t_b, loss_mask=torch.from_numpy(keep.astype(np.float32)))
    j_g = jax.grad(lambda p: j_api.loss_fn(p, j_b, jcfg)[0])(j_p)
    t_g = torch.func.grad(lambda p: t_api.loss_fn(p, t_b, cfg)[0])(t_p)
    scale = max(float(np.abs(g.astype(np.float32)).max()) for g in _jleaves(j_g))
    assert _gap(t_g, j_g) <= tol * scale
    assert [x.dtype for x in tree_leaves(t_g)] == [x.dtype for x in tree_leaves(t_p)]


@pytest.mark.parametrize("scan_layers", [True, False])
def test_aux_sum_follows_scan_layers(monkeypatch, scan_layers):
    """The aux loss is summed over the layers in the reference's order for
    each ``scan_layers`` (the scan: the sum, then / num_layers; the loop:
    each layer's share added in turn), to the last bit of the port's own
    per-layer values, and equals the reference's to fp32 rounding."""
    upd = dict(scan_layers=scan_layers, num_layers=3)
    jcfg = j_configs.smoke_config(ARCHS[0]).replace(**upd)
    cfg = t_configs.smoke_config(ARCHS[0]).replace(**upd)
    j_p = j_module.init_params(j_api.model_meta(jcfg), jax.random.PRNGKey(4))
    j_b, t_b = _batch(jcfg, S=16)
    per_layer, block = [], t_layers.moe_block

    def spy(*args):
        out = block(*args)
        per_layer.append(out[1])
        return out

    monkeypatch.setattr(t_layers, "moe_block", spy)
    assert t_api.family_module(cfg) is t_transformer
    aux = t_api.forward(_to_port(j_p), t_b, cfg)[1]
    want = torch.zeros(())
    for a in per_layer:
        want = want + a if scan_layers else want + a / 3
    want = want / 3 if scan_layers else want
    assert len(per_layer) == 3 and torch.equal(aux, want)
    np.testing.assert_allclose(float(aux), float(j_api.forward(j_p, j_b, jcfg)[1]), rtol=1e-6)


# ---------------------------------------------------------------------------
# LMTask over Qwen1.5-MoE through the engines
# ---------------------------------------------------------------------------

N, C, T = 4, 2, 8
# the K5 path (``use_pallas`` is `_tasks`' default); an eval batch of 8 x 16
# tokens gives capacity 80, which the JAX interpret-mode kernel's C tile
# divides (16 x 16 tokens would give 160)
SORT = dict(arch=ARCHS[0], moe_dispatch="sort", eval_batch=8)


@pytest.mark.parametrize("block_size", [1, 4])
def test_moe_run_experiment_matches_jax(block_size):
    """Per-event and blocked (``vmap(grad(loss))`` over E snapshots, one set
    of expert weights per lane, so K5's `vmap` rule folds lanes into E)
    replay of the Qwen1.5-MoE smoke config with the sort dispatch and
    ``use_pallas``, against JAX's on shared weights and window offsets.
    A `vmap` that fell back to a per-lane loop (a missing batching rule)
    warns; here that warning is an error."""
    (j_task, _), (t_task, _) = _tasks(**SORT)
    kw = dict(n_clients=N, concurrency=C, server_steps=T, sampling="uniform", block_size=block_size)
    rj = j_fl.run_experiment(JFLConfig(**kw), "gen_async", eval_every=T // 2, engine="scan",
                             task=j_task)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*(performance drop|batching rule).*")
        rt = t_fl.run_experiment(FLConfig(device="cpu", **kw), "gen_async", eval_every=T // 2,
                                 engine="scan", task=t_task)
    np.testing.assert_array_equal(rt.eval_steps, rj.eval_steps)
    np.testing.assert_allclose(rt.eval_acc, rj.eval_acc, atol=1e-4)  # measured <= 1.5e-6
    assert _gap(rt.final_params, rj.final_params) <= 1e-4  # measured <= 1.2e-7
    assert rt.extras["grad_calls"] == T


def test_moe_kernel_update_path_matches_jax_pallas():
    """``update="pallas"`` (K1 per leaf) on the MoE tree against the JAX
    Pallas kernels in interpret mode, same task setup."""
    (_, j_setup), (_, setup) = _tasks(**SORT)
    mu = j_fl.make_client_speeds(N, 0.5, 10.0, seed=0)
    kw = dict(n=N, C=C, T=T, eta=0.05, mu=mu, p=np.full(N, 1 / N), eval_every=T // 2,
              engine="scan", update="pallas")
    w_j, tr_j = j_run(j_setup.params, j_setup.clients, JServerConfig(pallas_interpret=True, **kw),
                      eval_fn=j_setup.eval_fn)
    w_t, tr_t = run_generalized_async_sgd(setup.params, setup.clients,
                                          ServerConfig(device="cpu", **kw), eval_fn=setup.eval_fn)
    assert _gap(w_t, w_j) <= 1e-4  # measured 1.2e-7
    np.testing.assert_allclose(tr_t.eval_values, tr_j.eval_values, atol=1e-4)  # measured 9.5e-7


def test_moe_task_setup_equals_reference():
    """The converted smoke weights give the reference's eval loss, and the
    tree has the MoE leaves `params_from_numpy` carries across."""
    (_, j_setup), (_, setup) = _tasks(**SORT)
    moe = setup.params["blocks"]["moe"]
    assert sorted(moe) == ["pre_norm", "router", "we_down", "we_gate", "we_up",
                           "ws_down", "ws_gate", "ws_up"]
    for a, b in zip(tree_leaves(setup.params), _jleaves(j_setup.params)):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_allclose(float(setup.eval_fn(setup.params)),
                               float(j_setup.eval_fn(j_setup.params)), rtol=1e-6)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "arctic-480b"])
def test_cli_lm_mode_runs_moe_on_cpu(arch, capsys):
    t_train.main(["--mode", "lm", "--arch", arch, "--device", "cpu", "--clients", "4",
                  "--concurrency", "2", "--steps", "4", "--batch", "2", "--seq", "16",
                  "--shard-size", "32", "--eval-every", "2"])
    out = capsys.readouterr().out
    losses = [float(line.split()[-1]) for line in out.splitlines() if "eval_loss" in line]
    assert len(losses) == 2 and all(np.isfinite(losses))

