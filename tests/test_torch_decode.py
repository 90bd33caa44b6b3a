"""PyTorch port, decode (`models.*.init_cache` / `decode_step`,
`api.serve_step`): against the JAX package on the same weights.

For a dense model (Yi-6B), the SSM (Mamba2-130M), the hybrid (Zamba2-2.7B),
the MoE (Qwen1.5-MoE-A2.7B) and the audio backbone (MusicGen-medium) at
smoke size, with the reference's parameters carried across by
`fl.engine.params_from_numpy`: the cache spec equals the reference's
(shapes and dtypes), every decode step's logits and new cache equal the
reference's `decode_step` within 1e-5 (fp32), decode equals the port's own
full-sequence forward at each position within 2e-4 (as
`tests/test_models.py` holds the reference), and `serve_step`'s greedy ids
equal the reference's wherever its top two logits are more than the
tolerance apart.  Ring eviction: a sliding window shorter than the prompt.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.launch.serve import materialize_cache as j_materialize  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.models import module as j_module  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.launch.serve import materialize_cache  # noqa: E402
from repro_torch.models import api as t_api  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import mamba2 as t_mamba2  # noqa: E402
from repro_torch.models.module import CacheSpec  # noqa: E402
from test_torch_lm import _to_port  # noqa: E402

ARCHS = ["yi_6b", "mamba2_130m", "zamba2_2_7b", "qwen2_moe_a2_7b", "musicgen_medium"]
B, S = 2, 12
TOL = 1e-5


def _cfgs(arch, **upd):
    jcfg, tcfg = j_configs.smoke_config(arch), t_configs.smoke_config(arch)
    if jcfg.family == "moe":
        # capacity drops depend on the group size (prefill groups B*S
        # tokens, decode B); ample capacity makes the paths identical
        upd.setdefault("capacity_factor", 16.0)
    return jcfg.replace(**upd), tcfg.replace(**upd)


def _feeds(cfg, seed=0):
    """Per-step decode inputs for both packages, and the port's full batch."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_stub":
        x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
        j = [{"embeds": jnp.asarray(x[:, t:t + 1])} for t in range(S)]
        t = [{"embeds": torch.from_numpy(x[:, i:i + 1])} for i in range(S)]
        return j, t, {"embeds": torch.from_numpy(x)}
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    j = [{"tokens": jnp.asarray(toks[:, t:t + 1], jnp.int32)} for t in range(S)]
    t = [{"tokens": torch.from_numpy(toks[:, i:i + 1])} for i in range(S)]
    return j, t, {"tokens": torch.from_numpy(toks)}


def _params(jcfg, seed=3):
    j_p = j_module.init_params(j_api.model_meta(jcfg), jax.random.PRNGKey(seed))
    return j_p, _to_port(j_p)


def _same_cache(t_cache, j_cache, tol):
    for name in j_cache:
        a, b = t_cache[name], np.asarray(j_cache[name])
        if b.dtype.kind == "f":
            np.testing.assert_allclose(a.float().numpy(), b.astype(np.float32), atol=tol,
                                       rtol=tol, err_msg=name)
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_equals_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    j_spec = j_api.init_cache(jcfg, B, S)
    t_spec = t_api.init_cache(tcfg, B, S)
    assert sorted(t_spec) == sorted(j_spec)
    for name, js in j_spec.items():
        ts = t_spec[name]
        assert isinstance(ts, CacheSpec)
        assert tuple(ts.shape) == tuple(js.shape), name
        assert str(ts.dtype).removeprefix("torch.") == jnp.dtype(js.dtype).name, name
    assert t_api.cache_logical_axes(tcfg) == j_api.cache_logical_axes(jcfg)
    cache = materialize_cache(t_spec, "cpu")
    j_cache = j_materialize(j_spec)
    _same_cache(cache, j_cache, 0.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference_decode_step(arch):
    """Every step's logits and the whole new cache (KV rings, positions,
    SSM states, conv rings) within 1e-5 of the reference's."""
    jcfg, tcfg = _cfgs(arch)
    j_p, t_p = _params(jcfg)
    j_feeds, t_feeds, _ = _feeds(jcfg)
    j_cache = j_materialize(j_api.init_cache(jcfg, B, S))
    t_cache = materialize_cache(t_api.init_cache(tcfg, B, S), "cpu")
    j_step = jax.jit(lambda p, c, b: j_api.decode_step(p, c, b, jcfg))
    worst = 0.0
    with torch.no_grad():
        for jb, tb in zip(j_feeds, t_feeds):
            jl, j_cache = j_step(j_p, j_cache, jb)
            tl, t_cache = t_api.decode_step(t_p, t_cache, tb, tcfg)
            worst = max(worst, float(np.abs(tl.numpy() - np.asarray(jl)).max()))
            _same_cache(t_cache, j_cache, TOL)
    assert worst <= TOL, worst


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_own_forward(arch):
    """Decode through the ring cache equals the port's full-sequence
    forward at each position within 2e-4, the reference's own bar."""
    jcfg, tcfg = _cfgs(arch)
    _, t_p = _params(jcfg, seed=5)
    _, t_feeds, full_batch = _feeds(jcfg, seed=5)
    with torch.no_grad():
        full, _ = t_api.forward(t_p, full_batch, tcfg)
        cache = materialize_cache(t_api.init_cache(tcfg, B, S), "cpu")
        for t, tb in enumerate(t_feeds):
            lg, cache = t_api.decode_step(t_p, cache, tb, tcfg)
            np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(), atol=2e-4)
    assert int(cache["pos"]) == S


@pytest.mark.parametrize("arch", ["yi_6b", "qwen2_moe_a2_7b"])
def test_serve_step_next_ids_match_reference(arch):
    """Greedy ids equal the reference's wherever its top two logits are
    more than the tolerance apart (a closer pair may round either way)."""
    jcfg, tcfg = _cfgs(arch)
    j_p, t_p = _params(jcfg, seed=7)
    j_feeds, t_feeds, _ = _feeds(jcfg, seed=7)
    j_cache = j_materialize(j_api.init_cache(jcfg, B, S))
    t_cache = materialize_cache(t_api.init_cache(tcfg, B, S), "cpu")
    compared = 0
    with torch.no_grad():
        for jb, tb in zip(j_feeds, t_feeds):
            jo, j_cache = j_api.serve_step(j_p, j_cache, jb, jcfg)
            to, t_cache = t_api.serve_step(t_p, t_cache, tb, tcfg)
            assert to["next_ids"].dtype == torch.int32 and to["next_ids"].shape == (B,)
            top2 = np.sort(np.asarray(jo["logits"]), axis=-1)[:, -2:]
            clear = (top2[:, 1] - top2[:, 0]) > TOL
            np.testing.assert_array_equal(to["next_ids"].numpy()[clear],
                                          np.asarray(jo["next_ids"])[clear])
            compared += int(clear.sum())
    assert compared >= B * S // 2


def test_sliding_window_ring_eviction_matches_reference():
    """A 5-slot window over a 12-token prompt: the ring wraps and evicts,
    and the port's decode stays within 1e-5 of the reference's."""
    jcfg, tcfg = _cfgs("yi_6b", sliding_window=5)
    j_p, t_p = _params(jcfg, seed=9)
    j_feeds, t_feeds, full_batch = _feeds(jcfg, seed=9)
    j_cache = j_materialize(j_api.init_cache(jcfg, B, S))
    t_cache = materialize_cache(t_api.init_cache(tcfg, B, S), "cpu")
    assert t_cache["k"].shape[2] == 5
    with torch.no_grad():
        full, _ = t_api.forward(t_p, full_batch, tcfg)
        for t, (jb, tb) in enumerate(zip(j_feeds, t_feeds)):
            jl, j_cache = j_api.decode_step(j_p, j_cache, jb, jcfg)
            tl, t_cache = t_api.decode_step(t_p, t_cache, tb, tcfg)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
            np.testing.assert_allclose(tl.numpy(), full[:, t].numpy(), atol=2e-4)
    np.testing.assert_array_equal(t_cache["positions"].numpy(), np.asarray(j_cache["positions"]))


def test_recurrent_step_matches_reference():
    """One `ssd_recurrent_step` from a random state, fp32, within 1e-5."""
    from repro.models import mamba2 as j_mamba2

    rng = np.random.default_rng(11)
    Bz, H, N, P = 3, 4, 8, 6
    h = rng.normal(size=(Bz, H, N, P)).astype(np.float32)
    x = rng.normal(size=(Bz, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (Bz, H)).astype(np.float32)
    A = -rng.uniform(0.5, 4.0, H).astype(np.float32)
    Bm, Cm = (rng.normal(size=(Bz, N)).astype(np.float32) for _ in range(2))
    jy, jh = j_mamba2.ssd_recurrent_step(*(jnp.asarray(a) for a in (h, x, dt, A, Bm, Cm)))
    ty, th = t_mamba2.ssd_recurrent_step(*(torch.from_numpy(a) for a in (h, x, dt, A, Bm, Cm)))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL, rtol=TOL)


def test_decode_attention_leaves_its_inputs():
    """The block returns a new cache and positions; the inputs stay as they
    were (the reference's arrays are immutable)."""
    _, tcfg = _cfgs("yi_6b")
    _, t_p = _params(j_configs.smoke_config("yi_6b"))
    blocks = {k: v[0] for k, v in t_p["blocks"]["attn"].items()}
    cache = materialize_cache(t_api.init_cache(tcfg, B, S), "cpu")
    ck, cv, pos_v = cache["k"][0].clone(), cache["v"][0].clone(), cache["positions"].clone()
    x = torch.randn(B, 1, tcfg.d_model)
    with torch.no_grad():
        _, (nk, _), npos = t_layers.decode_attention_block(
            blocks, x, tcfg, (cache["k"][0], cache["v"][0]), cache["positions"],
            torch.tensor(0, dtype=torch.int32))
    assert torch.equal(cache["k"][0], ck) and torch.equal(cache["v"][0], cv)
    assert torch.equal(cache["positions"], pos_v)
    assert int(npos[0]) == 0 and bool((nk[:, 0] != 0).any())
