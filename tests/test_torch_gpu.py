"""PyTorch port on the card: the CUDA kernels against their plain versions,
and the kernel paths of the replay engine against the plain paths.

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
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import weighted_update as cuda_kernels  # noqa: E402

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
