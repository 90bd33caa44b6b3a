"""PyTorch port, the LM slice on the CPU: configs, parameter trees, the dense
transformer and `LMTask` through the replay engine, against the JAX package.

The JAX package draws initial weights and window offsets from `jax.random`;
the port's parity tests take the same arrays (`params_from_numpy`,
``DeviceTaskClients(starts=)``), so both packages replay identical
minibatches on identical event streams.  Init parity is "in law": each
leaf's mean and spread against the reference's.
"""
import dataclasses

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
from repro.models import api as j_api  # noqa: E402
from repro.models import module as j_module  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.core import ServerConfig, run_generalized_async_sgd  # noqa: E402
from repro_torch.fl import engine as t_fl  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import api as t_api  # noqa: E402
from repro_torch.models import module as t_module  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

PORTED = ["internvl2_26b", "starcoder2_7b", "musicgen_medium", "qwen2_5_32b", "yi_6b",
          "granite_3_2b", "mamba2_130m", "zamba2_2_7b", "arctic_480b",
          "qwen2_moe_a2_7b"]  # dense, vlm, audio, ssm, hybrid, moe


def _jleaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _to_port(j_params):
    return t_fl.params_from_numpy(jax.tree_util.tree_map(np.asarray, j_params), "cpu")


def _gap(t_tree, j_tree) -> float:
    return max(float(np.abs(a.float().numpy() - b.astype(np.float32)).max())
               for a, b in zip(tree_leaves(t_tree), _jleaves(j_tree)))


# ---------------------------------------------------------------------------
# configs and parameter trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", j_configs.ARCH_IDS)
def test_configs_equal_reference(arch):
    for fn in ("get_config", "smoke_config"):
        a = dataclasses.asdict(getattr(t_configs, fn)(arch))
        b = dataclasses.asdict(getattr(j_configs, fn)(arch))
        assert a == b
    assert t_configs.ARCH_IDS == j_configs.ARCH_IDS and t_configs.ALIASES == j_configs.ALIASES
    assert t_configs.all_pairs() == j_configs.all_pairs()
    tcfg, jcfg = t_configs.get_config(arch), j_configs.get_config(arch)
    for name, shape in t_configs.SHAPES.items():
        jshape = j_configs.SHAPES[name]
        assert dataclasses.asdict(t_configs.for_shape(tcfg, shape)) == \
            dataclasses.asdict(j_configs.for_shape(jcfg, jshape))
        t_spec, j_spec = t_configs.input_specs(tcfg, shape), j_configs.input_specs(jcfg, jshape)
        assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in t_spec.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in j_spec.items()}
        assert all(v.device.type == "meta" for v in t_spec.values())
        assert t_configs.batch_logical_axes(tcfg, shape) == j_configs.batch_logical_axes(jcfg, jshape)


@pytest.mark.parametrize("arch", PORTED)
def test_model_meta_matches_reference(arch):
    """Leaf order, shapes, dtypes, logical axes and parameter count of the
    full-size tree (metadata only, nothing allocated)."""
    cfg, jcfg = t_configs.get_config(arch), j_configs.get_config(arch)
    t_meta, j_meta = t_api.model_meta(cfg), j_api.model_meta(jcfg)
    t_abs = tree_leaves(t_module.abstract_params(t_meta))
    j_abs = jax.tree_util.tree_leaves(j_module.abstract_params(j_meta))
    assert [tuple(x.shape) for x in t_abs] == [tuple(x.shape) for x in j_abs]
    assert [str(x.dtype)[6:] for x in t_abs] == [str(x.dtype) for x in j_abs]
    assert all(x.device.type == "meta" for x in t_abs)
    assert t_module.logical_specs(t_meta) == j_module.logical_specs(j_meta)
    assert t_module.param_count(t_meta) == j_module.param_count(j_meta)


def test_granite_full_width_parameter_count():
    assert t_module.param_count(t_api.model_meta(t_configs.get_config("granite-3-2b"))) \
        == 2_533_531_648


@pytest.mark.parametrize("arch,n_params,n_leaves", [
    ("mamba2-130m", 128_983_488, 11),
    ("zamba2-2.7b", 2_422_670_240, 21),
])
def test_ssm_full_width_parameter_count(arch, n_params, n_leaves):
    """Full-width counts, and the two fp32 leaves (``A_log``, ``dt_bias``)
    that make the packed snapshot ring fp32."""
    meta = t_api.model_meta(t_configs.get_config(arch))
    assert t_module.param_count(meta) == n_params
    leaves = tree_leaves(t_module.abstract_params(meta))
    assert len(leaves) == n_leaves
    assert sum(x.dtype == torch.float32 for x in leaves) == 2


@pytest.mark.parametrize("arch,n_params,n_leaves", [
    ("qwen2-moe-a2.7b", 14_315_735_040, 19),
    ("arctic-480b", 476_850_275_328, 16),
])
def test_moe_full_width_parameter_count(arch, n_params, n_leaves):
    """Full-width counts of the two MoE configs (nothing allocated): every
    leaf bf16; Qwen1.5-MoE has shared experts (ws_*) and attention biases,
    Arctic a dense residual FFN (wd_*)."""
    meta = t_api.model_meta(t_configs.get_config(arch))
    assert t_module.param_count(meta) == n_params
    leaves = tree_leaves(t_module.abstract_params(meta))
    assert len(leaves) == n_leaves
    assert all(x.dtype == torch.bfloat16 for x in leaves)


def test_init_law_matches_reference():
    """Each leaf's mean and standard deviation against the reference's at
    smoke size: 'ones' and 'zeros' exactly, the normal laws within a few
    standard errors (leaves of >= 32k entries)."""
    cfg, jcfg = t_configs.smoke_config("starcoder2-7b"), j_configs.smoke_config("starcoder2-7b")
    t_p = tree_leaves(t_module.init_params(t_api.model_meta(cfg), 3, "cpu"))
    j_p = _jleaves(j_module.init_params(j_api.model_meta(jcfg), jax.random.PRNGKey(3)))
    assert len(t_p) == len(j_p) == 14  # qkv biases, plain GELU MLP, untied head
    for a, b in zip(t_p, j_p):
        a = a.numpy().astype(np.float64)
        b = b.astype(np.float64)
        if b.std() == 0:
            np.testing.assert_array_equal(a, b)
            continue
        se = b.std() / np.sqrt(b.size)
        assert abs(a.mean()) < 5 * se and abs(b.mean()) < 5 * se
        assert abs(a.std() / b.std() - 1) < 0.03
    # deterministic per (seed, leaf path), distinct across leaves and seeds
    again = tree_leaves(t_module.init_params(t_api.model_meta(cfg), 3, "cpu"))
    assert all(torch.equal(x, y) for x, y in zip(t_p, again))
    other = tree_leaves(t_module.init_params(t_api.model_meta(cfg), 4, "cpu"))
    assert not torch.equal(t_p[-1], other[-1])


def test_ssm_init_laws():
    meta = {"a": t_module.ParamMeta((4096,), (None,), init="ssm_a"),
            "dt": t_module.ParamMeta((4096,), (None,), init="ssm_dt")}
    p = t_module.init_params(meta, 0, "cpu", dtype_override=torch.bfloat16)
    assert p["a"].dtype == p["dt"].dtype == torch.float32  # kept fp32
    assert float(p["a"].min()) >= 0.0 and float(p["a"].max()) <= np.log(16.0) + 1e-6
    u = torch.nn.functional.softplus(p["dt"])
    assert float(u.min()) >= 1e-3 - 1e-6 and float(u.max()) <= 1e-1 + 1e-6


def test_params_from_numpy_bf16_roundtrips_bitwise():
    j_p = j_module.init_params(j_api.model_meta(j_configs.smoke_config("granite-3-2b").replace(
        dtype="bfloat16")), jax.random.PRNGKey(0))
    t_p = _to_port(j_p)
    for a, b in zip(tree_leaves(t_p), _jleaves(j_p)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.view(torch.uint16).numpy(), b.view(np.uint16))


# ---------------------------------------------------------------------------
# the model against the reference on converted weights
# ---------------------------------------------------------------------------


def _batch(jcfg, B=2, S=24, seed=0):
    rng = np.random.default_rng(seed)
    b = {"labels": rng.integers(0, jcfg.vocab_size, (B, S))}
    if jcfg.frontend == "audio_stub":
        b["embeds"] = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, jcfg.vocab_size, (B, S))
    if jcfg.frontend == "vision_stub":
        b["patch_embeds"] = rng.normal(size=(B, jcfg.num_patches, jcfg.d_model)).astype(np.float32)
    j_b = {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else jnp.float32) for k, v in b.items()}
    return j_b, {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("dtype,use_pallas,tol", [
    ("float32", False, 1e-5),   # measured: logits 1.3e-6, grads 1.4e-6 (x max)
    ("float32", True, 1e-5),    # measured: logits 1.6e-6, grads 1.4e-6
    ("bfloat16", False, 2e-2),  # measured: logits 1.0e-2, grads 1.2e-2
    ("bfloat16", True, 2e-2),   # measured: logits 1.2e-2, grads 1.6e-2
])
def test_granite_forward_and_grads_match_reference(dtype, use_pallas, tol):
    """Logits and loss gradients on converted weights, each gap relative to
    the reference's largest magnitude.  bf16 rounds at other places in the
    two frameworks (and on the kernel path the port's CPU attention is the
    plain version, which casts the softmax weights to bf16, while the JAX
    side runs the Pallas kernel, which does not): a few bf16 ulps."""
    jcfg = j_configs.smoke_config("granite-3-2b").replace(dtype=dtype, use_pallas=use_pallas)
    cfg = t_configs.smoke_config("granite-3-2b").replace(dtype=dtype, use_pallas=use_pallas)
    j_p = j_module.init_params(j_api.model_meta(jcfg), jax.random.PRNGKey(0))
    t_p = _to_port(j_p)
    j_b, t_b = _batch(jcfg)
    t_logits = t_api.forward(t_p, t_b, cfg)[0]
    j_logits = np.asarray(j_api.forward(j_p, j_b, jcfg)[0].astype(jnp.float32))
    assert t_logits.dtype == getattr(torch, dtype)
    assert np.abs(t_logits.float().numpy() - j_logits).max() <= tol * np.abs(j_logits).max()
    j_g = jax.grad(lambda p: j_api.loss_fn(p, j_b, jcfg)[0])(j_p)
    t_g = torch.func.grad(lambda p: t_api.loss_fn(p, t_b, cfg)[0])(t_p)
    scale = max(float(np.abs(g.astype(np.float32)).max()) for g in _jleaves(j_g))
    assert _gap(t_g, j_g) <= tol * scale
    assert [x.dtype for x in tree_leaves(t_g)] == [x.dtype for x in tree_leaves(t_p)]


@pytest.mark.parametrize("arch", ["internvl2-26b", "musicgen-medium"])
def test_vlm_and_audio_forward_match_reference(arch):
    """The vision-stub (patch prefix) and audio-stub (precomputed frame
    embeddings) front ends, fp32, kernel path."""
    jcfg = j_configs.smoke_config(arch).replace(use_pallas=True)
    cfg = t_configs.smoke_config(arch).replace(use_pallas=True)
    j_p = j_module.init_params(j_api.model_meta(jcfg), jax.random.PRNGKey(1))
    t_p = _to_port(j_p)
    j_b, t_b = _batch(jcfg, S=16)
    np.testing.assert_allclose(t_api.forward(t_p, t_b, cfg)[0].numpy(),
                               np.asarray(j_api.forward(j_p, j_b, jcfg)[0]), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(t_api.loss_fn(t_p, t_b, cfg)[0]),
                               float(j_api.loss_fn(j_p, j_b, jcfg)[0]), rtol=1e-6)


def test_layer_loop_scan_flag_and_kernel_launches():
    """``scan_layers`` True and False give the same forward; the kernel path
    calls the attention once per layer."""
    cfg = t_configs.smoke_config("yi-6b").replace(use_pallas=True)
    p = t_module.init_params(t_api.model_meta(cfg), 0, "cpu")
    _, b = _batch(j_configs.smoke_config("yi-6b"))
    fa.reset_launches()
    a = t_api.forward(p, b, cfg)[0]
    assert fa.launches["flash_attention"] == 0  # CPU: the plain version, no launch
    c = t_api.forward(p, b, cfg.replace(scan_layers=False))[0]
    assert torch.equal(a, c)


# ---------------------------------------------------------------------------
# LMTask through the engines
# ---------------------------------------------------------------------------

N, C, T = 4, 2, 8


def _tasks(use_pallas=True, arch="granite-3-2b", eval_batch=16, **upd):
    """The JAX task's cached setup and the port's setup built from its
    weights and window offsets, placed in the port task's setup cache
    (tests/test_lm_engine.py's smoke-config sizes); ``upd`` replaces
    further config fields in both."""
    kw = dict(batch_size=2, seq_len=16, shard_size=32, eval_batch=eval_batch)
    upd = dict(use_pallas=use_pallas, **upd)
    j_task = j_fl.LMTask(cfg=j_configs.smoke_config(arch).replace(**upd), **kw)
    t_task = t_fl.LMTask(cfg=t_configs.smoke_config(arch).replace(**upd), **kw)
    j_setup = j_fl._cached_fl_setup(None, 0, j_task, n_clients=N)
    own = t_task.build(None, 0, N, device="cpu")
    clients = t_fl.DeviceTaskClients(own.clients.loss_fn, t_task.shards(0, N), batch_size=2,
                                     starts=np.asarray(j_setup.clients._starts), device="cpu")
    setup = dataclasses.replace(own, params=_to_port(j_setup.params), clients=clients)
    t_task.__dict__.setdefault("_fl_setup_cache", {})[(0, t_task.cache_key())] = setup
    return (j_task, j_setup), (t_task, setup)


def test_lm_shards_equal_reference():
    (_, j_setup), (t_task, setup) = _tasks()
    shards = t_task.shards(0, N)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(shards[k], np.asarray(j_setup.clients.shards[k]))
        np.testing.assert_array_equal(setup.clients.shards[k].numpy(),
                                      shards[k].reshape(-1, shards[k].shape[-1]))
    # the eval loss of the converted weights equals the reference's
    np.testing.assert_allclose(float(setup.eval_fn(setup.params)),
                               float(j_setup.eval_fn(j_setup.params)), rtol=1e-6)


@pytest.mark.parametrize("block_size", [1, 4])
def test_run_experiment_matches_jax(block_size):
    (j_task, _), (t_task, _) = _tasks()
    kw = dict(n_clients=N, concurrency=C, server_steps=T, sampling="uniform", block_size=block_size)
    rj = j_fl.run_experiment(JFLConfig(**kw), "gen_async", eval_every=T // 2, engine="scan",
                             task=j_task)
    rt = t_fl.run_experiment(FLConfig(device="cpu", **kw), "gen_async", eval_every=T // 2,
                             engine="scan", task=t_task)
    np.testing.assert_array_equal(rt.eval_steps, rj.eval_steps)
    np.testing.assert_allclose(rt.eval_acc, rj.eval_acc, atol=1e-4)  # measured <= 4.8e-7
    assert _gap(rt.final_params, rj.final_params) <= 1e-4  # measured <= 1.2e-7
    assert rt.extras["engine"] == "scan" and rt.extras["grad_calls"] == T


@pytest.mark.parametrize("block_size", [1, 4])
def test_kernel_update_path_matches_jax_pallas(block_size):
    """``update="pallas"`` (K1 per leaf, K2 blocked) against the JAX Pallas
    kernels in interpret mode, same task setup."""
    (_, j_setup), (_, setup) = _tasks()
    mu = j_fl.make_client_speeds(N, 0.5, 10.0, seed=0)
    kw = dict(n=N, C=C, T=T, eta=0.05, mu=mu, p=np.full(N, 1 / N), eval_every=T // 2,
              engine="scan", update="pallas", block_size=block_size)
    w_j, tr_j = j_run(j_setup.params, j_setup.clients, JServerConfig(pallas_interpret=True, **kw),
                      eval_fn=j_setup.eval_fn)
    w_t, tr_t = run_generalized_async_sgd(setup.params, setup.clients,
                                          ServerConfig(device="cpu", **kw), eval_fn=setup.eval_fn)
    assert _gap(w_t, w_j) <= 1e-4  # measured <= 1.2e-7
    np.testing.assert_allclose(tr_t.eval_values, tr_j.eval_values, atol=1e-4)


def test_port_scan_matches_port_python():
    _, (t_task, _) = _tasks(use_pallas=False)
    kw = dict(n_clients=N, concurrency=C, server_steps=T, sampling="uniform", device="cpu")
    r_py = t_fl.run_experiment(FLConfig(**kw), "gen_async", eval_every=T // 2, engine="python",
                               task=t_task)
    r_sc = t_fl.run_experiment(FLConfig(**kw), "gen_async", eval_every=T // 2, engine="scan",
                               task=t_task)
    assert r_py.extras["grad_calls"] == T
    np.testing.assert_allclose(r_sc.eval_acc, r_py.eval_acc, atol=1e-5)
    assert max(float((a - b).abs().max()) for a, b in
               zip(tree_leaves(r_sc.final_params), tree_leaves(r_py.final_params))) <= 1e-5


def test_bf16_flat_update_rounds_once_like_jax():
    """The per-event flat update of a bf16 ring promotes to fp32 and rounds
    once, as JAX's ``w - scale * g`` does in `repro.core.engine_scan.
    _make_apply_event` (torch alone would round twice)."""
    from repro_torch.core import engine_scan as t_es

    rng = np.random.default_rng(0)
    w, g = rng.normal(size=(2, 3000)).astype(np.float32)
    jw, jg = jnp.asarray(w, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    scale = jnp.float32(0.0371)
    j_new = np.asarray((jw - scale * jg).astype(jnp.bfloat16).astype(jnp.float32))
    tw, tg = (torch.from_numpy(x).to(torch.bfloat16) for x in (w, g))
    t_new = t_es._flat_axpy(tw, tg, torch.tensor(0.0371))
    assert t_new.dtype == torch.bfloat16
    np.testing.assert_array_equal(t_new.float().numpy(), j_new)


# ---------------------------------------------------------------------------
# devices, unported options and the command line
# ---------------------------------------------------------------------------


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    cfg = t_configs.smoke_config("granite-3-2b")
    with pytest.raises(RuntimeError, match="cuda"):
        t_module.init_params(t_api.model_meta(cfg), 0)
    with pytest.raises(RuntimeError, match="cuda"):
        t_fl.LMTask(cfg=cfg).build(None, 0, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        t_fl.run_experiment(FLConfig(n_clients=2, concurrency=1, server_steps=2), "gen_async",
                            task=t_fl.LMTask(cfg=cfg))
    with pytest.raises(RuntimeError, match="cuda"):
        t_train.main(["--mode", "lm", "--steps", "2", "--clients", "2", "--concurrency", "1"])


@pytest.mark.parametrize("argv,item", [
    (["--mode", "lm", "--engine", "fused"], "item 6"),
    (["--mode", "lm", "--ckpt-dir", "ckpt"], "item 8"),
    (["--mode", "fl"], "item 4"),  # the default --methods ends with fedbuff
])
def test_cli_unported_options_raise(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        t_train.main(argv + ["--device", "cpu"])


def test_unported_model_entry_points_raise():
    cfg = t_configs.smoke_config("granite-3-2b")
    for fn, item in ((lambda: t_api.train_step(), "item 7d"),
                     (lambda: t_api.init_cache(cfg, 1, 8), "item 11"),
                     (lambda: t_api.decode_step(None, None, None, cfg), "item 11"),
                     (lambda: t_api.serve_step(), "item 11")):
        with pytest.raises(NotImplementedError, match=item):
            fn()


def test_cli_lm_mode_runs_on_cpu(capsys):
    t_train.main(["--mode", "lm", "--device", "cpu", "--clients", "4", "--concurrency", "2",
                  "--steps", "4", "--batch", "2", "--seq", "16", "--shard-size", "32",
                  "--eval-every", "2"])
    out = capsys.readouterr().out
    losses = [float(line.split()[-1]) for line in out.splitlines() if "eval_loss" in line]
    assert len(losses) == 2 and all(np.isfinite(losses))
