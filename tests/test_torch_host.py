"""PyTorch port, numpy host layer: bitwise equal to the JAX package.

The port copies the numpy control plane, event simulator and data pipeline
(`repro_torch.core.{theory,jackson,scenario,queue_sim,sampling,classes}`,
`repro_torch.data.pipeline`) and the numpy half of the replay engine
(`engine_scan.step_scales` / `_blocked_layout`).  Same seeds must give
identical arrays in both packages.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import engine_scan as j_engine  # noqa: E402
from repro.core import jackson as j_jackson  # noqa: E402
from repro.core import queue_sim as j_qs  # noqa: E402
from repro.core import sampling as j_sampling  # noqa: E402
from repro.core.stream_device import build_class_spec as j_build_class_spec  # noqa: E402
from repro.core.theory import BoundConstants as JBoundConstants  # noqa: E402
from repro.data import pipeline as j_pipeline  # noqa: E402
from repro_torch.core import engine_scan as t_engine  # noqa: E402
from repro_torch.core import jackson as t_jackson  # noqa: E402
from repro_torch.core import queue_sim as t_qs  # noqa: E402
from repro_torch.core import sampling as t_sampling  # noqa: E402
from repro_torch.core.classes import build_class_spec as t_build_class_spec  # noqa: E402
from repro_torch.core.theory import BoundConstants as TBoundConstants  # noqa: E402
from repro_torch.data import pipeline as t_pipeline  # noqa: E402

SRC = Path(__file__).resolve().parent.parent / "src"


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _speeds(n, seed=0):
    return j_pipeline.make_client_speeds(n, 0.5, 10.0, seed=seed)


def _p(n, seed=1):
    p = np.random.default_rng(seed).uniform(0.5, 1.5, n)
    return p / p.sum()


def test_port_imports_neither_jax_nor_repro():
    """A fresh interpreter importing the port and all its subpackages leaves
    `jax` and every `repro` module out of `sys.modules`."""
    code = (
        "import sys, importlib\n"
        "for m in ['repro_torch', 'repro_torch.core', 'repro_torch.fl', "
        "'repro_torch.kernels', 'repro_torch.kernels.ops', 'repro_torch.kernels.build', "
        "'repro_torch.kernels.weighted_update', 'repro_torch.kernels.ref', "
        "'repro_torch.kernels.flash_attention', 'repro_torch.configs', "
        "'repro_torch.configs.registry', 'repro_torch.data', 'repro_torch.models', "
        "'repro_torch.models.api', 'repro_torch.launch', 'repro_torch.launch.train']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}, check=True,
    )
    assert out.stdout.strip() == "", f"port pulled in: {out.stdout.strip()}"


@pytest.mark.parametrize("C", [1, 4, 8])
@pytest.mark.parametrize("service", ["exp", "det"])
def test_export_stream_bitwise(C, service):
    n, T = 8, 400
    kw = dict(mu=_speeds(n), p=_p(n), C=C, T=T, service=service, seed=3, record_delays=True)
    a = j_qs.export_stream(j_qs.SimConfig(**kw))
    b = t_qs.export_stream(t_qs.SimConfig(**kw))
    for name in ("J", "K", "t", "slot", "delay_steps", "init_nodes", "queue_len_sum"):
        _equal(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("method", ["greedy", "dp"])
@pytest.mark.parametrize("E,cut_every", [(4, 0), (8, 0), (4, 100)])
def test_segment_blocks_bitwise(method, E, cut_every):
    slot = j_qs.export_stream(
        j_qs.SimConfig(mu=_speeds(16), p=_p(16), C=6, T=500, seed=1)
    ).slot
    ia, ma = j_qs.segment_blocks(slot, E, cut_every, method)
    ib, mb = t_qs.segment_blocks(slot, E, cut_every, method)
    _equal(ia, ib)
    _equal(ma, mb)


def test_select_block_size_bitwise():
    slots = [
        j_qs.export_stream(j_qs.SimConfig(mu=_speeds(16), p=_p(16), C=C, T=400, seed=s)).slot
        for C, s in ((4, 0), (12, 1))
    ]
    for s in (slots[0], slots):
        assert j_qs.select_block_size(s, cut_every=100) == t_qs.select_block_size(s, cut_every=100)


@pytest.mark.parametrize("optimizer", ["optimize_two_cluster", "optimize_physical_time"])
def test_two_cluster_optimizers_bitwise(optimizer):
    a = getattr(j_sampling, optimizer)(10.0, 1.0, 20, 10, JBoundConstants(C=5, T=1000))
    b = getattr(t_sampling, optimizer)(10.0, 1.0, 20, 10, TBoundConstants(C=5, T=1000))
    _equal(a.p, b.p)


def test_optimize_general_class_collapse_bitwise():
    """The collapsed path goes through `build_class_spec` (moved to
    `repro_torch.core.classes`)."""
    mu = _speeds(40)
    a = j_sampling.optimize_general(mu, JBoundConstants(C=6, T=500), iters=20, collapse=True)
    b = t_sampling.optimize_general(mu, TBoundConstants(C=6, T=500), iters=20, collapse=True)
    _equal(a.p, b.p)


@pytest.mark.parametrize("C", [3, 20])
def test_jackson_expected_delays_bitwise(C):
    mu, p = _speeds(12), _p(12)
    _equal(
        j_jackson.JacksonNetwork(mu=mu, p=p, C=C).expected_delays(),
        t_jackson.JacksonNetwork(mu=mu, p=p, C=C).expected_delays(),
    )


def test_build_class_spec_bitwise():
    mu = _speeds(30)
    p = np.where(mu > 1.0, 0.02, 0.0466666)
    p = p / p.sum()
    (sa, mua, pa), (sb, mub, pb) = j_build_class_spec(mu, p), t_build_class_spec(mu, p)
    for x, y in zip(sa, sb):
        _equal(x, y)
    _equal(mua, mub)
    _equal(pa, pb)


def test_device_shards_and_client_speeds_bitwise():
    a = j_pipeline.FederatedClassification(n_clients=6, seed=2)
    b = t_pipeline.FederatedClassification(n_clients=6, seed=2)
    for x, y in zip(a.device_shards(64), b.device_shards(64)):
        _equal(x, y)
    _equal(a.eval_batch(32)["x"], b.eval_batch(32)["x"])
    _equal(j_pipeline.make_client_speeds(50, 0.3, 4.0, seed=5),
           t_pipeline.make_client_speeds(50, 0.3, 4.0, seed=5))


@pytest.mark.parametrize("weighting", ["importance", "plain"])
@pytest.mark.parametrize("eval_every", [0, 100])
def test_step_scales_and_blocked_layout_bitwise(weighting, eval_every):
    n, C, T, E = 10, 4, 420, 4
    p = _p(n)
    stream = t_qs.export_stream(t_qs.SimConfig(mu=_speeds(n), p=p, C=C, T=T, seed=7))
    sa = j_engine.step_scales(stream, 0.05, p, weighting)
    sb = t_engine.step_scales(stream, 0.05, p, weighting)
    _equal(sa, sb)
    blocks = t_qs.EventBlocks.from_stream(stream, E, cut_every=eval_every)
    la = j_engine._blocked_layout(blocks, sa, eval_every)
    lb = t_engine._blocked_layout(blocks, sb, eval_every)
    for x, y in zip(la, lb):
        _equal(x, y)
