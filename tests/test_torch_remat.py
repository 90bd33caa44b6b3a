"""PyTorch port, rematerialisation (`repro_torch.models.remat`) on the CPU.

``cfg.remat`` "full" and "dots" change what the backward pass keeps, never
the numbers: every family's smoke model gives the loss and gradients of
remat "none" bit for bit under `torch.func.grad`, `vmap(grad)` over stacked
parameter rows and an eager ``.backward()``, and matches the reference's
``jax.checkpoint`` at the same policy.  The kernel Functions (K3, K4, K5's
wrappers, on their plain versions here) run inside the recompute.  The
saved bytes, counted with `saved_tensors_hooks`, show what each policy
keeps, and the peak of live tensor bytes under `torch.func` what each
policy holds at once; the dry run's FLOPs count the recompute once.
"""
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves as pytree_leaves  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.models import module as j_module  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.configs.base import FLConfig, ShapeConfig  # noqa: E402
from repro_torch.fl import engine as t_fl  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.op_analysis import analyze  # noqa: E402
from repro_torch.models import api as t_api  # noqa: E402
from repro_torch.models import module as t_module  # noqa: E402
from repro_torch.models import remat as R  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.module import abstract_params  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

from test_torch_lm import _batch, _gap, _jleaves, _to_port  # noqa: E402

# each family's smoke config at 2-4 layers, the kernels' wrappers on
FAMILIES = {
    "granite": ("granite-3-2b", {}),
    "qwen-moe-einsum": ("qwen2-moe-a2.7b", {}),
    "qwen-moe-sort": ("qwen2-moe-a2.7b", {"moe_dispatch": "sort"}),
    "internvl2": ("internvl2-26b", {}),
    "musicgen": ("musicgen-medium", {}),
    "mamba2": ("mamba2-130m", {"num_layers": 3}),
    "zamba2": ("zamba2-2.7b", {"num_layers": 4, "attn_every": 2}),
}


def _cfg(family, remat="none", lib=t_configs):
    arch, upd = FAMILIES[family]
    return lib.smoke_config(arch).replace(use_pallas=True, remat=remat, **upd)


def _port_setup(family, seed=0):
    cfg = _cfg(family)
    p = t_module.init_params(t_api.model_meta(cfg), seed, "cpu")
    _, b = _batch(j_configs.smoke_config(FAMILIES[family][0]), S=16, seed=seed)
    return cfg, p, b


def _loss(cfg, b):
    return lambda q: t_api.loss_fn(q, b, cfg)[0]


def _run(mode, p, b, cfg):
    """``(loss or losses, gradient tree)`` by one of the three autograd routes."""
    if mode == "grad":
        g, loss = torch.func.grad_and_value(_loss(cfg, b))(p)
        return loss, g
    if mode == "vmap":
        rows = tree_map(lambda x: torch.stack([x, x * 1.01]), p)
        fn = torch.func.vmap(torch.func.grad_and_value(_loss(cfg, b)))
        g, loss = fn(rows)
        return loss, g
    leaves = tree_map(lambda x: x.detach().clone().requires_grad_(True), p)
    loss = _loss(cfg, b)(leaves)
    loss.backward()
    return loss.detach(), tree_map(lambda x: x.grad, leaves)


@pytest.mark.parametrize("mode", ["grad", "vmap", "eager"])
@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_is_bitwise_none(family, policy, mode):
    cfg, p, b = _port_setup(family)
    loss0, g0 = _run(mode, p, b, cfg)
    loss1, g1 = _run(mode, p, b, cfg.replace(remat=policy))
    assert torch.equal(loss0, loss1)
    for a, c in zip(tree_leaves(g0), tree_leaves(g1)):
        assert a.dtype == c.dtype and torch.equal(a, c)


def test_dots_recompute_takes_the_recorded_products(monkeypatch):
    """Under "dots" each 2-D-weight product of a block is recorded once in
    the forward and handed back once in the recompute (Granite: q, k, v, o,
    up, gate, down a layer); "full" records none."""
    cfg, p, b = _port_setup("granite")
    taken = []
    real = R._Recorded.backward
    monkeypatch.setattr(R._Recorded, "backward",
                        staticmethod(lambda ctx, g: taken.append(1) or real(ctx, g)))
    torch.func.grad(_loss(cfg.replace(remat="dots"), b))(p)
    assert len(taken) == 7 * cfg.num_layers
    taken.clear()
    torch.func.grad(_loss(cfg.replace(remat="full"), b))(p)
    assert not taken


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("family", ["granite", "qwen-moe-sort", "mamba2", "zamba2"])
def test_remat_gradients_match_reference(family, policy):
    """The reference's ``loss_fn`` gradients at ``cfg.replace(remat=policy)``
    (``jax.checkpoint``, its dots policy) against the port's at the same
    policy, on the reference's weights, fp32, 1e-5 of the largest
    magnitude (the tolerance of `tests/test_torch_lm.py`)."""
    jcfg = _cfg(family, policy, j_configs)
    cfg = _cfg(family, policy)
    j_p = j_module.init_params(j_api.model_meta(jcfg), jax.random.PRNGKey(3))
    t_p = _to_port(j_p)
    j_b, t_b = _batch(jcfg, S=16)
    j_g = jax.grad(lambda q: j_api.loss_fn(q, j_b, jcfg)[0])(j_p)
    t_g = torch.func.grad(_loss(cfg, t_b))(t_p)
    scale = max(float(np.abs(g).max()) for g in _jleaves(j_g))
    assert _gap(t_g, j_g) <= 1e-5 * scale


def _saved_bytes(cfg, p, b) -> int:
    """The bytes an eager forward saves for its backward, each storage
    once, the parameters' own storage left out."""
    leaves = tree_map(lambda x: x.detach().clone().requires_grad_(True), p)
    own = {x.untyped_storage().data_ptr() for x in tree_leaves(leaves)}
    seen = {}

    def pack(t):
        s = t.untyped_storage()
        if s.data_ptr() not in own:
            seen[s.data_ptr()] = s.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = _loss(cfg, b)(leaves)
    loss.backward()
    return sum(seen.values())


@pytest.mark.parametrize("family", ["granite", "qwen-moe-sort", "mamba2"])
def test_saved_bytes_per_policy(family):
    """"full" keeps one block input a layer beyond the head's terms (the
    count at 0 layers), plus the shared positions vector; "dots" keeps
    more, "none" the most; each layer added to "full" adds one block
    input, (B, S, D) fp32."""
    cfg, _, b = _port_setup(family)
    B, S = b["labels"].shape
    block_in = B * S * cfg.d_model * 4
    saved = {}
    for nl in (0, 2, 4):
        c = cfg.replace(num_layers=nl)
        p = t_module.init_params(t_api.model_meta(c), 0, "cpu")
        saved[nl] = {r: _saved_bytes(c.replace(remat=r), p, b) for r in R.POLICIES}
    head = saved[0]["full"]
    assert saved[0]["none"] == saved[0]["dots"] == head
    for nl in (2, 4):
        s = saved[nl]
        assert head + nl * block_in <= s["full"] <= head + nl * block_in + S * 4
        assert s["full"] < s["dots"] < s["none"]
    assert saved[4]["full"] - saved[2]["full"] == 2 * block_in


def test_hybrid_remats_the_mamba_body_only():
    """Zamba2: "dots" checkpoints the Mamba2 body whole, as "full" does (the
    reference's `hybrid.forward`), and the shared attention sites keep their
    activations: a backbone layer added without a site adds one block input
    to "full", far less than it adds to "none"."""
    cfg, _, b = _port_setup("zamba2")
    B, S = b["labels"].shape
    block_in = B * S * cfg.d_model * 4
    saved = {}
    for nl in (4, 5):  # attn_every 2: 2 sites either way, one trailing layer at 5
        c = cfg.replace(num_layers=nl)
        p = t_module.init_params(t_api.model_meta(c), 0, "cpu")
        saved[nl] = {r: _saved_bytes(c.replace(remat=r), p, b) for r in R.POLICIES}
    assert saved[4]["dots"] == saved[4]["full"] < saved[4]["none"]
    assert saved[5]["full"] - saved[4]["full"] == block_in
    assert saved[5]["none"] - saved[4]["none"] > 4 * block_in


class _LiveBytes(TorchDispatchMode):
    """The bytes of the tensors the operations under it made that are still
    alive, and their peak: each new (non-view) output counted until the
    tensor object is freed.  It sees the backward's operations, and under
    `torch.func` each level's unwrapped ones."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func is not torch.ops.aten._unsafe_view.default:
            for t in pytree_leaves(out):
                if isinstance(t, torch.Tensor):
                    nb = t.untyped_storage().nbytes()
                    self.live += nb
                    weakref.finalize(t, self._free, nb)
            self.peak = max(self.peak, self.live)
        return out

    def _free(self, nb):
        self.live -= nb


@pytest.mark.parametrize("mode", ["grad", "vmap"])
@pytest.mark.parametrize("family", ["granite", "mamba2", "zamba2"])
def test_live_peak_per_policy(family, mode):
    """The peak of live tensor bytes over one loss and gradient under
    `torch.func` (the eager route's saved bytes are counted above): "full"
    and "dots" below "none", and under "full" each Mamba2
    layer added costs less than half what it costs under "none".
    `torch.func.grad` differentiates with ``create_graph=True``, so a
    recompute whose cotangents kept its graph would hold every layer's
    activations to the end of the backward, as "none" does.  A batch of
    4 x 64 tokens, so that activations outweigh the smoke parameters."""
    cfg = _cfg(family)
    _, b = _batch(j_configs.smoke_config(FAMILIES[family][0]), B=4, S=64)
    peak = {}
    for nl in (4, 8):
        c = cfg.replace(num_layers=nl)
        p = t_module.init_params(t_api.model_meta(c), 0, "cpu")
        for r in R.POLICIES:
            with _LiveBytes() as m:
                _run(mode, p, b, c.replace(remat=r))
            peak[nl, r] = m.peak
    for nl in (4, 8):
        assert peak[nl, "full"] < peak[nl, "none"] and peak[nl, "dots"] < peak[nl, "none"]
    if family == "mamba2":  # the others add attention too, kept whole by Zamba2
        assert peak[8, "full"] - peak[4, "full"] < 0.5 * (peak[8, "none"] - peak[4, "none"])


@pytest.mark.parametrize("block_size", [1, 2])
def test_mamba2_run_experiment_remat_full_is_bitwise_none(block_size):
    """A Mamba2 smoke `LMTask` through the replay engine, per event
    (`grad`) and blocked E=2 (`vmap(grad)` over the snapshots), K4's
    wrapper on: the final weights and eval curve at remat "full" are those
    at "none" bit for bit."""
    kw = dict(batch_size=2, seq_len=16, shard_size=32, eval_batch=8)
    flc = FLConfig(n_clients=4, concurrency=2, server_steps=8, sampling="uniform",
                   block_size=block_size, device="cpu")
    runs = {}
    for r in ("none", "full"):
        task = t_fl.LMTask(cfg=_cfg("mamba2", r), **kw)
        runs[r] = t_fl.run_experiment(flc, "gen_async", eval_every=4, engine="scan", task=task)
    np.testing.assert_array_equal(runs["full"].eval_acc, runs["none"].eval_acc)
    for a, c in zip(tree_leaves(runs["none"].final_params), tree_leaves(runs["full"].final_params)):
        assert torch.equal(a, c)


@pytest.mark.parametrize("family", ["granite", "mamba2"])
def test_dry_run_counts_one_more_forward_of_the_blocks(family, tmp_path):
    """The meta-device train step at "full" counts the FLOPs at "none" plus
    one forward of the blocks (the forward's FLOPs less the head's
    product); the record carries both counts and both ratios."""
    cfg = _cfg(family).replace(use_pallas=False)
    shape = ShapeConfig("smoke_train", 64, 2, "train")
    rec = {r: dryrun.run_pair(FAMILIES[family][0], shape, out_dir=str(tmp_path), tag_suffix=r,
                              cfg=cfg.replace(remat=r)) for r in ("none", "full")}
    assert rec["none"]["ok"] and rec["full"]["ok"]
    batch = t_configs.input_specs(cfg, shape)
    fwd = analyze(t_api.forward, abstract_params(t_api.model_meta(cfg)), batch, cfg)[1]["flops"]
    head = 2 * shape.global_batch * shape.seq_len * cfg.d_model * cfg.vocab_size
    assert rec["full"]["hlo_flops_total"] - rec["none"]["hlo_flops_total"] == fwd - head
    assert rec["full"]["hlo_flops_remat_none"] == rec["none"]["hlo_flops_total"]
    assert rec["full"]["remat"] == "full" and rec["none"]["remat"] == "none"
    mf = rec["full"]["model_flops_total"]
    assert rec["full"]["useful_flops_ratio"] == mf / rec["full"]["hlo_flops_total"]
    assert rec["full"]["useful_flops_ratio_remat_none"] == mf / rec["none"]["hlo_flops_total"]


@pytest.mark.parametrize("where", ["remat", "config", "hybrid"])
def test_unknown_policy_raises(where):
    with pytest.raises(ValueError, match="unknown remat 'bogus'"):
        if where == "remat":
            R.remat(lambda x: x, "bogus")
        elif where == "config":
            transformer._remat(lambda x: x, t_configs.smoke_config("yi-6b").replace(remat="bogus"))
        else:
            cfg, p, b = _port_setup("zamba2")
            t_api.loss_fn(p, b, cfg.replace(remat="bogus"))
