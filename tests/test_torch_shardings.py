"""PyTorch port, the partition rules, the production mesh and the sharded
step (`repro_torch.launch.shardings`, `launch.mesh`), against the JAX
package's `repro.launch.shardings` and `api.train_step`.

(a) The rule tables are the reference's, and for every arch's full config,
both production meshes and every rule set each parameter leaf's spec is the
reference's `logical_to_pspec(meta.axes, filter_rules(...), meta.shape,
mesh)`, its local shard the reference's arithmetic (a stand-in mesh with
``shape`` and ``axis_names``, as `tests/test_distributed.py` uses, so no
256 devices are needed).  (b) Without a rule context the hints change
nothing: loss and gradients bitwise those of the model with the hints taken
out.  (c)-(d) In one subprocess on a fake 2x4 world (meta tensors): the
smoke archs' train steps communicate, decode steps trace, and a sharded
matmul's per-rank FLOPs are the global count over its 8 shards.  (e) One
subprocess starts 2 gloo CPU ranks: on the (1, 2) tensor-parallel and
(2, 1) FSDP meshes, fp32 smoke dense, MoE, SSM and hybrid train steps (and
a dense config with one kv head, whose kv heads the model axis does not
split) equal the port's one-rank step and JAX's `api.train_step` on the
same weights within 1e-5.  (f) The dry run's mesh flags write the
reference's records.
"""
import functools
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.configs.base import OptimConfig as JOptimConfig  # noqa: E402
from repro.launch import shardings as j_sh  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.models import module as j_module  # noqa: E402
from repro.optim import make_optimizer as j_make  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.configs.base import OptimConfig  # noqa: E402
from repro_torch.fl.engine import params_from_numpy  # noqa: E402
from repro_torch.launch import shardings as t_sh  # noqa: E402
from repro_torch.models import api as t_api  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models.module import _map_with_path  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent


class StandInMesh:
    """What the rules read of a mesh: its axis names and sizes."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"16x16": StandInMesh({"data": 16, "model": 16}),
          "2x16x16": StandInMesh({"pod": 2, "data": 16, "model": 16})}


# ---------------------------------------------------------------------------
# (a) the rules
# ---------------------------------------------------------------------------
def test_rule_tables_equal_reference():
    assert t_sh.DEFAULT_RULES == j_sh.DEFAULT_RULES
    assert t_sh.DECODE_RULES == j_sh.DECODE_RULES
    assert t_sh.RULE_SETS == j_sh.RULE_SETS


def _ref_leaves(jcfg) -> dict:
    """``{path: ParamMeta}`` of the reference's tree, paths joined by '/'."""
    flat = jax.tree_util.tree_flatten_with_path(
        j_api.model_meta(jcfg), is_leaf=lambda x: isinstance(x, j_module.ParamMeta))[0]
    return {"/".join(str(k.key) for k in path): m for path, m in flat}


@pytest.mark.parametrize("rules_name", sorted(j_sh.RULE_SETS))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", t_configs.ARCH_IDS)
def test_param_specs_equal_reference(arch, mesh_name, rules_name):
    """Every leaf's spec (shape-aware fallback) and local shard, and
    `param_shardings`' placements."""
    mesh = MESHES[mesh_name]
    rules = j_sh.RULE_SETS[rules_name]
    ref = _ref_leaves(j_configs.get_config(arch))
    jrules = j_sh.filter_rules(rules, mesh)
    trules = t_sh.filter_rules(rules, mesh)
    assert trules == jrules
    ours, placed = {}, {}
    meta = t_api.model_meta(t_configs.get_config(arch))
    _map_with_path(lambda path, m: ours.setdefault(path, m), meta)
    _map_with_path(lambda path, pl: placed.setdefault(path, pl),
                   _meta_like(t_sh.param_shardings(meta, mesh, rules)))
    assert sorted(ours) == sorted(ref)
    for path, m in ours.items():
        jm = ref[path]
        assert (m.shape, m.axes) == (tuple(jm.shape), tuple(jm.axes)), path
        want = tuple(j_sh.logical_to_pspec(jm.axes, jrules, jm.shape, mesh))
        spec = t_sh.logical_to_pspec(m.axes, trules, m.shape, mesh)
        assert spec == want, (path, spec, want)
        local = [d // int(np.prod([mesh.shape[a] for a in
                                   (() if e is None else e if isinstance(e, tuple) else (e,))]))
                 for d, e in zip(jm.shape, want)]
        assert t_sh.local_shape(m.shape, spec, mesh) == tuple(local), path
        assert placed[path].axes == t_sh.placements(want, mesh), path


def _meta_like(tree):
    """A tree of placements as ParamMeta leaves (placements in ``axes``), so
    `_map_with_path` walks it as it walks the metadata."""
    from repro_torch.models.module import ParamMeta

    if isinstance(tree, dict):
        return {k: _meta_like(v) for k, v in tree.items()}
    return ParamMeta(tuple(range(len(tree))), tuple(tree))


def test_logical_rules_match_reference_cases():
    """`tests/test_distributed.py::TestLogicalRules` on the port, and the
    placements a spec gets."""
    from torch.distributed.tensor import Replicate, Shard

    m44 = StandInMesh({"data": 4, "model": 4})
    assert t_sh.logical_to_pspec(("embed", "mlp"), {"embed": "data", "mlp": "model"},
                                 (64, 128), m44) == ("data", "model")
    m416 = StandInMesh({"data": 4, "model": 16})
    assert t_sh.logical_to_pspec(("embed", "mlp"), {"embed": "data", "mlp": "model"},
                                 (64, 3352), m416) == ("data", None)
    m3 = StandInMesh({"pod": 2, "data": 16, "model": 16})
    assert t_sh.logical_to_pspec(("batch",), {"batch": ("pod", "data")}, (32,), m3) == \
        (("pod", "data"),)
    assert t_sh.logical_to_pspec(("batch",), {"batch": ("pod", "data")}, (2,), m3) == ("pod",)
    m4 = StandInMesh({"model": 4})
    assert t_sh.logical_to_pspec(("heads", "mlp"), {"heads": "model", "mlp": "model"},
                                 (8, 8), m4) == ("model", None)
    # a dimension on two mesh axes is Shard(d) on each, in mesh order
    assert t_sh.placements((("pod", "data"), None, "model"), m3) == (Shard(0), Shard(0),
                                                                      Shard(2))
    assert t_sh.placements((None, "data"), m44) == (Shard(1), Replicate())
    with pytest.raises(ValueError, match="order"):
        t_sh.placements((("model", "data"),), m44)
    assert t_sh.local_shape((64, 8, 32), (("pod", "data"), None, "model"), m3) == (2, 8, 2)
    with pytest.raises(ValueError, match="not divisible"):
        t_sh.local_shape((2, 64, 32), (("pod", "data"), None, "model"), m3)


def test_mesh_needs_its_ranks():
    from repro_torch.launch.mesh import fake_world, make_debug_mesh, make_production_mesh

    with pytest.raises(RuntimeError, match="256 ranks"):
        make_production_mesh()
    with fake_world(8):
        with pytest.raises(RuntimeError, match="need 512 ranks, found 8"):
            make_production_mesh(multi_pod=True)
        mesh = make_debug_mesh(2, 4)
        assert tuple(mesh.shape) == (2, 4) and mesh.mesh_dim_names == ("data", "model")
        with pytest.raises(RuntimeError, match="initialised already"):
            with fake_world(2):
                pass
    import torch.distributed as dist

    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# (b) no context: the hints change nothing
# ---------------------------------------------------------------------------
SMOKE_ARCHS = ["granite-3-2b", "qwen2-moe-a2.7b", "mamba2-130m", "zamba2-2.7b"]


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_hints_without_a_context_are_bitwise_today(arch, monkeypatch):
    """Loss and gradients (`torch.func.grad`, and `api.train_step`'s) with
    the hints as shipped equal, bitwise, those with every hint replaced by
    the plain operation it stands for."""
    import torch.nn.functional as F

    cfg = t_configs.smoke_config(arch)
    jcfg = j_configs.smoke_config(arch)
    params = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, j_module.init_params(j_api.model_meta(jcfg), jax.random.PRNGKey(0))), "cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32))
             for k in ("tokens", "labels")}
    x = torch.ones(2, 3)
    assert t_layers._shard(x, ("batch", "embed")) is x
    assert t_layers._gather(params) is params
    assert t_sh.active() is None

    def grads():
        return torch.func.grad_and_value(lambda p: t_api.loss_fn(p, batch, cfg)[0])(params)

    g_hint, l_hint = grads()
    opt = make_optimizer(OptimConfig(name="sgd", lr=1.0))
    stepped = t_api.train_step(params, opt.init(params), batch, cfg, opt, 1.0)[0]
    monkeypatch.setattr(t_layers, "_shard", lambda x, axes, shape=None: x)
    monkeypatch.setattr(t_layers, "_gather", lambda p: p)
    monkeypatch.setattr(t_layers, "embed_lookup", lambda table, tok: F.embedding(tok, table))
    monkeypatch.setattr(t_layers, "_heads",
                        lambda t, B, S, n, Dh, name: t.reshape(B, S, n, Dh))
    g_plain, l_plain = grads()
    assert torch.equal(l_hint, l_plain)
    for a, b in zip(tree_leaves(g_hint), tree_leaves(g_plain)):
        assert torch.equal(a, b)
    # train_step's gradient is torch.func's without a context: w - 1.0 * g
    for w, w2, g in zip(tree_leaves(params), tree_leaves(stepped), tree_leaves(g_plain)):
        assert torch.equal(w2, (w.float() - 1.0 * g.float()).to(w.dtype))


# ---------------------------------------------------------------------------
# (c)-(d) a fake 2x4 world on the meta device, in a subprocess
# ---------------------------------------------------------------------------
_FAKE_SCRIPT = textwrap.dedent(
    """
    import json
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, shardings as SH
    from repro_torch.launch.mesh import fake_world, make_debug_mesh
    from repro_torch.launch.op_analysis import analyze

    out = {}
    with fake_world(8):
        mesh = make_debug_mesh(2, 4)
        x = SH.distribute_like(torch.empty(32, 1024, device="meta"), mesh, ("data", None))
        w = SH.distribute_like(torch.empty(1024, 4096, device="meta"), mesh, (None, "model"))
        y, r = analyze(lambda a, b: a @ b, x, w)
        out["matmul"] = {"flops": r["flops"], "global": 2 * 32 * 1024 * 4096,
                         "local": list(y.to_local().shape), "coll": r["collectives"]["total"]}
        w2 = SH.distribute_like(torch.empty(1024, 4096, device="meta"), mesh, ("model", None))
        y, r = analyze(lambda a, b: (a @ b).redistribute(mesh, SH.placements(("data", None),
                                                                             mesh)), x, w2)
        out["matmul_reduced"] = {"flops": r["flops"], "coll": r["collectives"]}
        shape = ShapeConfig("t", 64, 8, "train")
        for arch in ["yi-6b", "qwen2-moe-a2.7b", "mamba2-130m", "zamba2-2.7b"]:
            cfg = smoke_config(arch).replace(moe_group_size=64)
            fn, args = dryrun.build_step(cfg, shape, mesh, dict(SH.DEFAULT_RULES))
            res, r = analyze(fn, *args)
            loss = res[2]["loss"]
            out[arch] = {"coll": r["collectives"]["total"], "flops": r["flops"],
                         "count": r["collectives"]["count"],
                         "loss": [type(loss).__name__, list(loss.shape)]}
        dshape = ShapeConfig("d", 64, 8, "decode")
        for arch in ["yi-6b", "mamba2-130m", "zamba2-2.7b"]:
            fn, args = dryrun.build_step(smoke_config(arch), dshape, mesh,
                                         dict(SH.DEFAULT_RULES))
            res, r = analyze(fn, *args)
            out[arch + "_decode"] = {"logits": list(res[0]["logits"].shape),
                                     "cache": sorted(res[1]), "flops": r["flops"]}
    print(json.dumps(out))
    """
)


@pytest.fixture(scope="module")
def fake_2x4():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", _FAKE_SCRIPT], capture_output=True, text=True,
                         timeout=300, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ["yi-6b", "qwen2-moe-a2.7b", "mamba2-130m", "zamba2-2.7b"])
def test_smoke_archs_train_on_fake_2x4_mesh(fake_2x4, arch):
    """`tests/test_distributed.py::test_smoke_archs_lower_on_2x4_mesh`'s
    claim: sharded training must communicate."""
    r = fake_2x4[arch]
    assert r["coll"] > 0 and r["count"] > 0 and r["flops"] > 0
    assert r["loss"] == ["DTensor", []]


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-130m", "zamba2-2.7b"])
def test_smoke_archs_decode_on_fake_2x4_mesh(fake_2x4, arch):
    r = fake_2x4[arch + "_decode"]
    assert r["logits"] == [8, 512] and r["flops"] > 0 and "pos" in r["cache"]


def test_sharded_matmul_flops_are_per_rank(fake_2x4):
    """(32, 1024) on data x (1024, 4096) on model: each of the 8 ranks
    multiplies its (16, 1024) by its (1024, 1024), no collective; with the
    weight's rows on model the product is a partial sum, whose reduction
    is one all-reduce of the rank's (16, 4096) fp32 rows."""
    r = fake_2x4["matmul"]
    assert r["flops"] == r["global"] / 8 and r["local"] == [16, 1024] and r["coll"] == 0
    r = fake_2x4["matmul_reduced"]
    assert r["flops"] == 2 * 16 * 256 * 4096
    assert r["coll"]["all-reduce"] == 16 * 4096 * 4 and r["coll"]["count"] == 1


# ---------------------------------------------------------------------------
# (e) 2 gloo CPU ranks: the sharded step against one rank and JAX
# ---------------------------------------------------------------------------
CASES = {
    "dense": ("granite-3-2b", {}),
    "dense_kv1": ("granite-3-2b", {"num_kv_heads": 1}),
    "moe": ("qwen2-moe-a2.7b", {}),
    "ssm": ("mamba2-130m", {}),
    "hybrid": ("zamba2-2.7b", {}),
}
SHAPE = {"moe": (8, 16)}
SHARD_MESHES = {"tp_1x2": (1, 2, "tp_only"), "fsdp_2x1": (2, 1, "default")}
WEIGHT = 0.7
STEEP = 1e-3

_RANKS_SCRIPT = textwrap.dedent(
    """
    import json
    import sys
    import numpy as np
    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import OptimConfig
    from repro_torch.fl.engine import params_from_numpy
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.lanes import run_lanes
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import api
    from repro_torch.optim import make_optimizer
    from repro_torch.tree import tree_flatten

    def nest(flat):
        out = {}
        for key, v in flat.items():
            d = out
            *head, last = key.split("/")
            for k in head:
                d = d.setdefault(k, {})
            d[last] = v
        return out

    def rank(rank, world, inputs_path, spec):
        torch.set_num_threads(1)
        inputs = np.load(inputs_path)
        out = {}
        for case, (arch, upd) in spec["cases"].items():
            cfg = smoke_config(arch).replace(**upd)
            w = nest({k[len(case) + 3:]: inputs[k] for k in inputs.files
                      if k.startswith(case + "/w/")})
            params = params_from_numpy(w, "cpu")
            batch = {k: torch.from_numpy(inputs[f"{case}/{k}"]) for k in ("tokens", "labels")}
            for name, (data, model, rules_name) in spec["meshes"].items():
                mesh = make_debug_mesh(data, model)
                rules = SH.filter_rules(SH.RULE_SETS[rules_name], mesh)
                dp = SH.distribute_params(params, mesh, rules, api.model_meta(cfg))
                db = {k: SH.distribute_like(v, mesh, SH.logical_to_pspec(
                    ("batch", "seq"), {**rules, "seq": None}, tuple(v.shape), mesh))
                    for k, v in batch.items()}
                opt = make_optimizer(OptimConfig(name="adamw", state_dtype="float32"))
                st = opt.init(dp)
                st["count"] = SH.distribute_like(st["count"], mesh, ())
                with SH.activate_rules(rules, mesh):
                    p2, s2, m = api.train_step(dp, st, db, cfg, opt, spec["weight"])
                full = lambda t: (t.full_tensor() if hasattr(t, "full_tensor")
                                  else t).detach().numpy()
                pre = f"{case}/{name}"
                for k in ("loss", "grad_norm", "moe_aux"):
                    out[f"{pre}/{k}"] = full(m[k])
                for i, t in enumerate(tree_flatten(p2)[0]):
                    out[f"{pre}/p/{i}"] = full(t)
                for i, t in enumerate(tree_flatten(s2["m"])[0]):
                    out[f"{pre}/m/{i}"] = full(t)
                out[f"{pre}/placements"] = str(dp["embed"].placements)
        return out

    if __name__ == "__main__":
        inputs_path, spec_path, out_path = sys.argv[1:4]
        spec = json.loads(open(spec_path).read())
        res = run_lanes(rank, 2, (inputs_path, spec), timeout=280.0)
        np.savez(out_path, **{f"r{r}/{k}": np.asarray(v)
                              for r, d in enumerate(res) for k, v in d.items()})
    """
)


def _case_inputs(case):
    arch, upd = CASES[case]
    jcfg = j_configs.smoke_config(arch).replace(**upd)
    jp = j_module.init_params(j_api.model_meta(jcfg), jax.random.PRNGKey(0))
    B, S = SHAPE.get(case, (4, 16))
    rng = np.random.default_rng(1)
    b = {k: rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
         for k in ("tokens", "labels")}
    return jcfg, jp, b


@pytest.fixture(scope="module")
def sharded_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    inputs = {}
    for case in CASES:
        _, jp, b = _case_inputs(case)
        flat = jax.tree_util.tree_flatten_with_path(jp)[0]
        inputs.update({f"{case}/w/" + "/".join(str(k.key) for k in path): np.asarray(v)
                       for path, v in flat})
        inputs.update({f"{case}/{k}": v for k, v in b.items()})
    np.savez(tmp / "inputs.npz", **inputs)
    (tmp / "spec.json").write_text(json.dumps(
        {"cases": CASES, "meshes": SHARD_MESHES, "weight": WEIGHT}))
    (tmp / "ranks.py").write_text(_RANKS_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, str(tmp / "ranks.py"), str(tmp / "inputs.npz"),
                          str(tmp / "spec.json"), str(tmp / "out.npz")],
                         capture_output=True, text=True, timeout=300, env=env, cwd=tmp)
    assert res.returncode == 0, res.stderr[-4000:]
    out = np.load(tmp / "out.npz")
    return {k: out[k] for k in out.files}


def _np(t):
    return t.detach().float().numpy()


OCFG = dict(name="adamw", state_dtype="float32")


@functools.lru_cache(maxsize=None)
def _unsharded_steps(case):
    """The port's one-rank `api.train_step` and JAX's on the case's weights
    and batch, AdamW with ``sampling_weight`` `WEIGHT`."""
    arch, upd = CASES[case]
    jcfg, jp, b = _case_inputs(case)
    cfg = t_configs.smoke_config(arch).replace(**upd)
    topt, jopt = make_optimizer(OptimConfig(**OCFG)), j_make(JOptimConfig(**OCFG))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    one = t_api.train_step(tp, topt.init(tp), tb, cfg, topt, WEIGHT)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    ref = jax.jit(lambda p, s, bb: j_api.train_step(p, s, bb, jcfg, jopt, WEIGHT))(
        jp, jopt.init(jp), jb)
    return one, ref


@pytest.mark.parametrize("mesh", sorted(SHARD_MESHES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_matches_one_rank_and_reference(sharded_ranks, case, mesh):
    """Loss, grad_norm and moe_aux within 1e-5 (relative; moe_aux absolute),
    the first moment m = 0.1 g within 1e-5 of its largest magnitude, the new
    params within 1e-5 where |g| >= `STEEP` (AdamW's first step is
    lr·g/(|g| + eps), which moves by a good part of lr where |g| is near
    eps: those are held to 2·lr·w, as `tests/test_torch_optim.py` does),
    against the port's one-rank step and JAX's; both ranks bitwise alike."""
    (tp2, ts2, tm), (jp2, js2, jm) = _unsharded_steps(case)
    pre = f"{case}/{mesh}"
    n_p = len(tree_leaves(tp2))
    for key in sharded_ranks:
        if key.startswith(f"r0/{pre}/") and not key.endswith("placements"):
            np.testing.assert_array_equal(sharded_ranks[key],
                                          sharded_ranks["r1" + key[2:]], err_msg=key)
    got = {k: float(sharded_ranks[f"r0/{pre}/{k}"]) for k in ("loss", "grad_norm", "moe_aux")}
    gaps = {}
    for name, ref in (("one rank", {k: float(tm[k]) for k in got}),
                      ("jax", {k: float(jm[k]) for k in got})):
        rel = {k: abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-30) for k in ("loss", "grad_norm")}
        rel["moe_aux"] = abs(got["moe_aux"] - ref["moe_aux"])
        gaps[name] = rel
        assert max(rel.values()) <= 1e-5, (name, rel)
    refs_m = {"one rank": [_np(t) for t in tree_leaves(ts2["m"])],
              "jax": [np.asarray(x) for x in jax.tree_util.tree_leaves(js2["m"])]}
    refs_p = {"one rank": [_np(t) for t in tree_leaves(tp2)],
              "jax": [np.asarray(jnp.asarray(x, jnp.float32))
                      for x in jax.tree_util.tree_leaves(jp2)]}
    m = [sharded_ranks[f"r0/{pre}/m/{i}"] for i in range(n_p)]
    p = [sharded_ranks[f"r0/{pre}/p/{i}"].astype(np.float32) for i in range(n_p)]
    lr = OptimConfig(**OCFG).lr
    for name in refs_m:
        scale = max(float(np.abs(x).max()) for x in refs_m[name])
        m_gap = max(float(np.abs(a - r).max()) for a, r in zip(m, refs_m[name])) / scale
        p_gap = p_flat = 0.0
        for a, r, mm in zip(p, refs_p[name], refs_m[name]):
            d = np.abs(a - r)
            steep = np.abs(mm) / 0.1 >= STEEP
            p_gap = max(p_gap, float(d[steep].max(initial=0.0)))
            p_flat = max(p_flat, float(d[~steep].max(initial=0.0)))
        print(f"{case} {mesh} vs {name}: {gaps[name]}, m {m_gap:.2e} of its largest, new params "
              f"{p_gap:.2e} where |g| >= {STEEP} ({p_flat:.2e} elsewhere)")
        assert m_gap <= 1e-5 and p_gap <= 1e-5 and p_flat <= 2 * lr * WEIGHT


def test_sharded_params_are_sharded(sharded_ranks):
    """The embedding (vocab, d_model) on (data, model): the FSDP rules shard
    its d_model on data (and its vocab on the model axis of 1), the
    tensor-parallel ones its 512 vocab rows on model only."""
    assert str(sharded_ranks["r0/dense/fsdp_2x1/placements"]) == "(Shard(dim=1), Shard(dim=0))"
    assert str(sharded_ranks["r0/dense/tp_1x2/placements"]) == "(Replicate(), Shard(dim=0))"


# ---------------------------------------------------------------------------
# (f) the dry run on the production meshes
# ---------------------------------------------------------------------------
MESH_KEYS = ("arch", "shape", "mesh", "chips", "rules", "kind", "params", "ok",
             "flops_per_device", "bytes_per_device", "collective_bytes_per_device",
             "collectives", "memory", "roofline", "dominant", "model_flops_total",
             "hlo_flops_total", "useful_flops_ratio", "wall_s")


def test_dryrun_both_meshes_writes_the_reference_records(tmp_path):
    from repro_torch.launch import dryrun

    dryrun.main(["--arch", "yi-6b", "--shape", "train_4k", "--both-meshes",
                 "--out-dir", str(tmp_path)])
    import torch.distributed as dist

    assert not dist.is_initialized()
    for tag, mesh, chips in (("singlepod", "16x16", 256), ("multipod", "2x16x16", 512)):
        rec = json.loads((tmp_path / f"yi-6b__train_4k__{tag}__default.json").read_text())
        assert all(k in rec for k in MESH_KEYS), [k for k in MESH_KEYS if k not in rec]
        assert rec["ok"] and rec["mesh"] == mesh and rec["chips"] == chips
        assert rec["rules"] == "default" and rec["devices"] in (["meta"], ["cpu", "meta"])
        assert rec["off_meta_bytes"] < 2**16
        assert rec["collective_bytes_per_device"] > 0
        assert rec["collectives"]["total"] == rec["collective_bytes_per_device"]
        assert set(rec["collectives"]) == {"all-gather", "all-reduce", "reduce-scatter",
                                           "all-to-all", "collective-permute", "count", "total"}
        assert rec["hlo_flops_total"] == rec["flops_per_device"] * chips
        assert 0 < rec["useful_flops_ratio"] < 1
        assert rec["roofline"]["collective_s"] > 0
        # the rank's argument bytes are its shards: far below the whole model's
        assert rec["memory"]["argument_bytes"] < 2 * rec["params"] / 16
