"""PyTorch port, the dry run on the meta device (`repro_torch.launch.dryrun`)
and its operation counter (`launch.op_analysis`), against the JAX package's
`repro.launch.dryrun` where both compute the same thing: the model-FLOP
estimate of every (arch × shape) pair and the optimizer state's bytes of
every arch.  The dry run needs no card and allocates nothing beyond host
constants: every tensor of the step lives on the meta device.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

# `repro.launch.dryrun` sets XLA_FLAGS to 512 host devices when imported;
# the backend is initialised first (so this process keeps its devices) and
# the variable restored (so no later subprocess inherits it)
jax.devices()
_flags = os.environ.get("XLA_FLAGS")
from repro import configs as j_configs  # noqa: E402
from repro.launch import dryrun as j_dry  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.models import module as j_module  # noqa: E402
from repro.optim import make_optimizer as j_make  # noqa: E402

if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.op_analysis import analyze  # noqa: E402
from repro_torch.models import api as t_api  # noqa: E402
from repro_torch.models.module import abstract_params, param_count  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402


@pytest.mark.parametrize("arch", t_configs.ARCH_IDS)
def test_model_flops_estimate_equals_reference(arch):
    for name, shape in t_configs.SHAPES.items():
        cfg = t_configs.for_shape(t_configs.get_config(arch), shape)
        jcfg = j_configs.for_shape(j_configs.get_config(arch), j_configs.SHAPES[name])
        assert dryrun.model_flops_estimate(cfg, shape) == \
            j_dry.model_flops_estimate(jcfg, j_configs.SHAPES[name])


@pytest.mark.parametrize("arch", t_configs.ARCH_IDS)
def test_optimizer_state_bytes_equal_reference(arch):
    """``opt.init`` on the meta params against ``jax.eval_shape(opt.init,
    abstract_params(...))``, under each package's ``optimizer_for``."""
    cfg, jcfg = t_configs.get_config(arch), j_configs.get_config(arch)
    ocfg, jocfg = dryrun.optimizer_for(cfg), j_dry.optimizer_for(jcfg)
    assert (ocfg.name, ocfg.state_dtype) == (jocfg.name, jocfg.state_dtype)
    state = make_optimizer(ocfg).init(abstract_params(t_api.model_meta(cfg)))
    jstate = jax.eval_shape(j_make(jocfg).init, j_module.abstract_params(j_api.model_meta(jcfg)))
    jbytes = sum(int(np.prod(x.shape)) * x.dtype.itemsize
                 for x in jax.tree_util.tree_leaves(jstate))
    assert dryrun.tree_bytes(state) == jbytes
    assert set(state) == set(jstate)
    assert all(t.device.type == "meta" for k in state if k != "count"
               for t in jax.tree_util.tree_leaves(state[k]))


def test_op_analysis_counts_a_matmul():
    """The reference's own check (`tests/test_distributed.py`): 2·128·32·64
    FLOPs for a (128, 64) @ (64, 32) fp32 product, and the three tensors'
    bytes; a view counts none."""
    a, b = torch.ones((128, 64)), torch.ones((64, 32))
    _, r = analyze(lambda x, y: x @ y, a, b)
    assert r["flops"] == 2 * 128 * 32 * 64
    assert r["bytes"] == 4 * (128 * 64 + 64 * 32 + 128 * 32)
    _, r = analyze(lambda x: x.t()[:3].unsqueeze(0).view(3, -1), a)
    assert r["bytes"] == 0 and r["flops"] == 0


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen2-moe-a2.7b", "mamba2-130m",
                                  "zamba2-2.7b"])
def test_run_pair_on_smoke_configs(arch, tmp_path):
    """Train, prefill and decode of the smoke config: ``ok``, every tensor on
    meta but host constants, the reference's record keys, the FLOPs at least
    the model estimate's, one file each under ``tmp_path``."""
    cfg = t_configs.smoke_config(arch).replace(use_pallas=True)
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig(f"smoke_{kind}", 64, 2, kind)
        rec = dryrun.run_pair(arch, shape, out_dir=str(tmp_path), cfg=cfg)
        assert rec["ok"], rec.get("error")
        assert rec["devices"] in (["meta"], ["cpu", "meta"]) and rec["off_meta_bytes"] < 2**16
        assert rec["params"] == param_count(t_api.model_meta(cfg))
        for key in ("flops_per_device", "bytes_per_device", "memory", "roofline", "dominant",
                    "model_flops_total", "hlo_flops_total", "useful_flops_ratio", "wall_s"):
            assert key in rec
        assert rec["chips"] == 1 and rec["mesh"] == "1xH100"
        assert rec["roofline"]["collective_s"] == 0.0
        assert rec["hlo_flops_total"] >= 0.9 * rec["model_flops_total"] > 0
        assert rec["memory"]["argument_bytes"] > 0 and rec["memory"]["output_bytes"] > 0
        with open(tmp_path / f"{arch}__smoke_{kind}__1xH100.json") as f:
            assert json.load(f)["ok"]


def test_cli_runs_without_a_card_and_refuses_the_mesh_flags(tmp_path, capsys):
    """The one-card record as before; the mesh flags write the production
    meshes' records (``--multi-pod`` the 2x16x16 one, ``--both-meshes``
    both, ``--rules`` a rule set on 16x16) and an unknown rule set is
    refused (exit code 2)."""
    dryrun.main(["--arch", "mamba2-130m", "--shape", "decode_32k", "--out-dir", str(tmp_path)])
    rec = json.loads((tmp_path / "mamba2-130m__decode_32k__1xH100.json").read_text())
    assert rec["ok"] and rec["devices"] == ["meta"]
    pair = ["--arch", "mamba2-130m", "--shape", "decode_32k", "--out-dir", str(tmp_path)]
    for argv, tags in ((["--multi-pod"], ["multipod__default"]),
                       (["--both-meshes"], ["singlepod__default", "multipod__default"]),
                       (["--rules", "kv_seq"], ["singlepod__kv_seq"])):
        for tag in tags:
            (tmp_path / f"mamba2-130m__decode_32k__{tag}.json").unlink(missing_ok=True)
        dryrun.main(pair + argv)
        for tag in tags:
            rec = json.loads((tmp_path / f"mamba2-130m__decode_32k__{tag}.json").read_text())
            assert rec["ok"], rec.get("error")
            assert rec["mesh"] == ("2x16x16" if tag.startswith("multi") else "16x16")
            assert rec["rules"] == tag.split("__")[1]
    with pytest.raises(SystemExit) as e:
        dryrun.main(pair + ["--rules", "bogus"])
    assert e.value.code == 2
    assert "invalid choice: 'bogus'" in capsys.readouterr().err
