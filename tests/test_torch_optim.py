"""PyTorch port, the optimizers and `api.train_step` against the JAX package.

`repro_torch.optim.make_optimizer`'s sgd, momentum and adamw against
`repro.optim`'s on the same mixed fp32 / bf16 tree over 5 steps with the
state carried (``scale`` a float and a 0-d tensor, weight decay on, fp32
and bf16 moments): fp32 leaves within 1e-5, bf16 leaves and bf16 moments
within 2e-2 of the largest magnitude (ROADMAP's limits); the reference's
own optimizer tests (`tests/test_substrates.py::TestOptimizers`), ported;
the optimizer state carried across by `fl.engine.params_from_numpy`; and
one `api.train_step` (AdamW, ``optimizer_for``'s config) of the smoke
configs of the four families on converted weights and the same batch,
fp32 with the plain routes and with the kernels' (their plain versions on
the CPU; JAX's Pallas kernels in interpret mode), and bf16 on the kernels'
routes.  Each test prints the gaps it measured.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.configs.base import OptimConfig as JOptimConfig  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.models import module as j_module  # noqa: E402
from repro.optim import make_optimizer as j_make  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.configs.base import OptimConfig  # noqa: E402
from repro_torch.fl.engine import params_from_numpy  # noqa: E402
from repro_torch.models import api as t_api  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

LIMIT = {np.dtype("float32"): 1e-5, "bfloat16": 2e-2}


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _tree(seed):
    """A mixed tree: fp32 and bf16 leaves, nested dicts."""
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(7, 5)).astype(np.float32),
            "blk": {"w": rng.normal(size=(4, 9)).astype(np.float32),
                    "b": rng.normal(size=(9,)).astype(np.float32) * 0.1},
            "emb": rng.normal(size=(6, 8)).astype(np.float32)}


def _bf16_keys(tree, keys=("emb", "w")):
    """Cast the leaves named in ``keys`` to bf16 (numpy in, jax out)."""
    def one(path, a):
        return jnp.asarray(a, jnp.bfloat16 if path[-1].key in keys else jnp.float32)
    return jax.tree_util.tree_map_with_path(one, tree)


def _gap(t_tree, j_tree) -> dict:
    """Per dtype, the largest |port - reference| over the leaves of that
    dtype, relative to the reference's largest magnitude (fp32 absolute)."""
    out = {}
    for a, b in zip(tree_leaves(t_tree), jax.tree_util.tree_leaves(j_tree)):
        key = "bfloat16" if a.dtype == torch.bfloat16 else np.dtype("float32")
        assert str(a.dtype)[6:] == str(b.dtype)
        d = float(np.abs(_np(a) - _jnp(b)).max())
        if key == "bfloat16":
            d /= max(float(np.abs(_jnp(b)).max()), 1e-30)
        out[key] = max(out.get(key, 0.0), d)
    return out


@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale_kind", ["float", "tensor"])
def test_update_matches_reference(name, state_dtype, scale_kind):
    kw = dict(name=name, lr=0.05, weight_decay=0.01, state_dtype=state_dtype)
    jopt, topt = j_make(JOptimConfig(**kw)), make_optimizer(OptimConfig(**kw))
    jp = _bf16_keys(_tree(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    assert ts["count"].dtype == torch.int32 and ts["count"].shape == ()
    assert set(ts) == set(js)
    scales = [1.0, 0.37, 2.5, 1.0 / 3.0, 0.8]
    worst = {}
    for step, s in enumerate(scales):
        g = _bf16_keys(_tree(step + 1))
        tg = params_from_numpy(jax.tree_util.tree_map(np.asarray, g), "cpu")
        j_s = jnp.float32(s) if scale_kind == "tensor" else s
        t_s = torch.tensor(s, dtype=torch.float32) if scale_kind == "tensor" else s
        jp, js = jopt.update(g, js, jp, scale=j_s)
        tp, ts = topt.update(tg, ts, tp, scale=t_s)
        for k, v in list(_gap(tp, jp).items()) + [
                (f"state {k}", d) for k, d in _gap({x: ts[x] for x in ts if x != "count"},
                                                   {x: js[x] for x in js if x != "count"}).items()]:
            worst[k] = max(worst.get(k, 0.0), v)
        assert int(ts["count"]) == int(js["count"]) == step + 1
    print(f"{name} {state_dtype} scale={scale_kind}: gaps over 5 steps {worst}")
    for k, v in worst.items():
        limit = LIMIT["bfloat16" if "bfloat16" in str(k) else np.dtype("float32")]
        assert v <= limit, (k, v)
    if state_dtype == "bfloat16" and name != "sgd":
        assert all(m.dtype == torch.bfloat16 for m in tree_leaves(ts["m"]))


class TestOptimizers:
    """`tests/test_substrates.py::TestOptimizers`, on the port."""

    def _quad_min(self, name, **kw):
        opt = make_optimizer(OptimConfig(name=name, lr=0.1, **kw))
        params = {"w": torch.tensor([3.0, -2.0])}
        state = opt.init(params)
        grad_fn = torch.func.grad(lambda p: torch.sum(p["w"] ** 2))
        for _ in range(300):
            params, state = opt.update(grad_fn(params), state, params)
        return float(params["w"].abs().max())

    @pytest.mark.parametrize("name", ["sgd", "momentum", "adamw"])
    def test_minimizes_quadratic(self, name):
        assert self._quad_min(name) < 1e-2

    def test_scale_is_importance_weight(self):
        opt = make_optimizer(OptimConfig(name="sgd", lr=0.1))
        params = {"w": torch.tensor([1.0])}
        st = opt.init(params)
        g = {"w": torch.tensor([1.0])}
        p1, _ = opt.update(g, st, params, scale=1.0)
        p2, _ = opt.update(g, st, params, scale=2.0)
        assert float(params["w"][0] - p2["w"][0]) == pytest.approx(
            2 * float(params["w"][0] - p1["w"][0]))

    def test_bf16_state_dtype(self):
        opt = make_optimizer(OptimConfig(name="adamw", state_dtype="bfloat16"))
        params = {"w": torch.zeros((4,), dtype=torch.bfloat16)}
        assert opt.init(params)["m"]["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_state_crosses_from_the_reference_bitwise(state_dtype):
    """A reference AdamW state after two steps, carried by
    `params_from_numpy`: the same keys, dtypes and bits, and the port's
    next step from it equals the reference's."""
    kw = dict(name="adamw", lr=0.05, state_dtype=state_dtype)
    jopt, topt = j_make(JOptimConfig(**kw)), make_optimizer(OptimConfig(**kw))
    jp = _bf16_keys(_tree(0))
    js = jopt.init(jp)
    for step in range(2):
        jp, js = jopt.update(_bf16_keys(_tree(step + 1)), js, jp)
    ts = params_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
    assert ts["count"].dtype == torch.int32 and int(ts["count"]) == 2
    for a, b in zip(tree_leaves(ts), jax.tree_util.tree_leaves(js)):
        assert str(a.dtype)[6:] == str(b.dtype)
        bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        np.testing.assert_array_equal(a.view(bits).numpy(),
                                      np.asarray(b).view(np.int16 if bits == torch.int16
                                                         else np.int32))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    g = _bf16_keys(_tree(9))
    jp2, _ = jopt.update(g, js, jp)
    tp2, _ = topt.update(params_from_numpy(jax.tree_util.tree_map(np.asarray, g), "cpu"), ts, tp)
    gaps = _gap(tp2, jp2)
    print(f"the step after the crossing: {gaps}")
    assert gaps[np.dtype("float32")] <= 1e-5 and gaps["bfloat16"] <= 2e-2


# ---------------------------------------------------------------------------
# api.train_step
# ---------------------------------------------------------------------------
# the family tolerances of bf16 (tests/test_torch_lm.py, test_torch_ssm.py,
# test_torch_moe.py): a few bf16 ulps of the largest magnitude
BF16_TOL = {"granite-3-2b": 2e-2, "mamba2-130m": 2e-2, "zamba2-2.7b": 4e-2,
            "qwen2-moe-a2.7b": 4e-2}
# the MoE smoke config under the sort dispatch: 8 x 16 tokens give capacity
# 80, which the JAX interpret-mode K5 tile divides (tests/test_torch_moe.py)
SHAPE = {"qwen2-moe-a2.7b": (8, 16)}
NEAR_TIE = 1e-3
STEEP = 1e-3


def _train_batch(jcfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S)),
         "labels": rng.integers(0, jcfg.vocab_size, (B, S))}
    return ({k: jnp.asarray(v, jnp.int32) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _router_keep(cfg, t_p, t_b):
    """Per token, whether every MoE layer's router margin (k-th against the
    (k+1)-th probability) is at least `NEAR_TIE` in the port's forward:
    bf16 tokens nearer a tie may route to other experts in the two
    frameworks (tests/test_torch_moe.py)."""
    from repro_torch.models import layers as t_layers

    margins, router = [], t_layers._router

    def spy(params, xg, c):
        probs, gates, idx = router(params, xg, c)
        top = torch.topk(probs, c.num_experts_per_tok + 1, dim=-1).values
        margins.append(top[:, -2] - top[:, -1])
        return probs, gates, idx

    t_layers._router = spy
    try:
        with torch.no_grad():
            t_api.forward(t_p, t_b, cfg)
    finally:
        t_layers._router = router
    return (torch.stack(margins).min(dim=0).values >= NEAR_TIE).numpy()


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen2-moe-a2.7b", "mamba2-130m",
                                  "zamba2-2.7b"])
@pytest.mark.parametrize("dtype,use_pallas", [("float32", False), ("float32", True),
                                              ("bfloat16", True)])
def test_train_step_matches_reference(arch, dtype, use_pallas):
    """One AdamW `train_step` with ``sampling_weight`` 0.7 on converted
    weights: loss, ``grad_norm`` and the new params within 1e-5 in fp32
    (the params absolute, loss and norm relative), bf16 within the family's
    tolerance of the largest magnitude; ``moe_aux`` likewise; the first
    moment (the gradient, scaled) relative to its largest magnitude, as the
    family tests hold gradients, and ``count`` of the new state too."""
    upd = dict(dtype=dtype, use_pallas=use_pallas)
    if arch == "qwen2-moe-a2.7b":
        upd["moe_dispatch"] = "sort"
    jcfg = j_configs.smoke_config(arch).replace(**upd)
    cfg = t_configs.smoke_config(arch).replace(**upd)
    ocfg = dict(name="adamw", state_dtype="float32")
    jopt_cfg = JOptimConfig(**ocfg)
    jopt, topt = j_make(jopt_cfg), make_optimizer(OptimConfig(**ocfg))
    j_p = j_module.init_params(j_api.model_meta(jcfg), jax.random.PRNGKey(0))
    t_p = params_from_numpy(jax.tree_util.tree_map(np.asarray, j_p), "cpu")
    j_b, t_b = _train_batch(jcfg, *SHAPE.get(arch, (2, 32)))
    if dtype == "bfloat16" and cfg.family == "moe":
        keep = _router_keep(cfg, t_p, t_b).reshape(t_b["tokens"].shape)
        assert keep.mean() >= 0.85
        j_b = dict(j_b, loss_mask=jnp.asarray(keep, jnp.float32))
        t_b = dict(t_b, loss_mask=torch.from_numpy(keep.astype(np.float32)))
    jp2, js2, jm = jax.jit(lambda p, s, b: j_api.train_step(p, s, b, jcfg, jopt, 0.7))(
        j_p, jopt.init(j_p), j_b)
    tp2, ts2, tm = t_api.train_step(t_p, topt.init(t_p), t_b, cfg, topt, 0.7)
    tol = 1e-5 if dtype == "float32" else BF16_TOL[arch]
    rel = {k: abs(float(tm[k]) - float(jm[k])) / max(abs(float(jm[k])), 1e-30)
           for k in ("loss", "grad_norm")}
    rel["moe_aux"] = abs(float(tm["moe_aux"]) - float(jm["moe_aux"]))
    scale = max(float(np.abs(_jnp(x)).max()) for x in jax.tree_util.tree_leaves(jp2))
    # AdamW's first step is lr * w * g / (|g| + eps): where |g| is near eps
    # (1e-8) a gradient that differs by 1e-9 moves it by a good part of lr.
    # Those elements are held to the step's own bound, 2 * lr * w; the rest,
    # |g| >= STEEP (g from the new first moment, m = (1 - beta1) g), to tol.
    p_gap, p_flat = 0.0, 0.0
    for a, b, m in zip(tree_leaves(tp2), jax.tree_util.tree_leaves(jp2),
                       jax.tree_util.tree_leaves(js2["m"])):
        d = np.abs(_np(a) - _jnp(b))
        steep = np.abs(np.asarray(m)) / (1 - jopt_cfg.beta1) >= STEEP
        p_gap = max(p_gap, float(d[steep].max(initial=0.0)))
        p_flat = max(p_flat, float(d[~steep].max(initial=0.0)))
    m_scale = max(float(np.abs(_jnp(b)).max()) for b in jax.tree_util.tree_leaves(js2["m"]))
    m_gap = max(float(np.abs(_np(a) - _jnp(b)).max())
                for a, b in zip(tree_leaves(ts2["m"]), jax.tree_util.tree_leaves(js2["m"]))) / m_scale
    print(f"{arch} {dtype} use_pallas={use_pallas}: loss / grad_norm relative {rel['loss']:.2e} /"
          f" {rel['grad_norm']:.2e}, moe_aux {rel['moe_aux']:.2e}, new params {p_gap:.2e} where "
          f"|g| >= {STEEP} ({p_flat:.2e} elsewhere; largest {scale:.3f}), m {m_gap:.2e} of its "
          "largest")
    assert int(ts2["count"]) == int(js2["count"]) == 1
    assert [str(x.dtype)[6:] for x in tree_leaves(tp2)] == \
        [str(x.dtype) for x in jax.tree_util.tree_leaves(jp2)]
    assert rel["loss"] <= tol and rel["grad_norm"] <= tol and rel["moe_aux"] <= tol
    assert m_gap <= tol
    if dtype == "float32":
        assert p_gap <= tol and p_flat <= 2 * jopt_cfg.lr * 0.7
    else:
        assert max(p_gap, p_flat) <= tol * scale
