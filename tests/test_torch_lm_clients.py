"""PyTorch port, the legacy host-streaming gradient source
(`repro_torch.launch.train.LMClients`) against the JAX package's
(`repro.launch.train.LMClients`): one seed gives bitwise the same batches,
client by client and call by call, and on them the port's gradient is
JAX's within 1e-5 (fp32 smoke config, converted weights).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.launch.train import LMClients as JLMClients  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.models import module as j_module  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.fl.engine import params_from_numpy  # noqa: E402
from repro_torch.launch.train import LMClients  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


@pytest.mark.parametrize("seed", [0, 3])
def test_streams_give_the_reference_batches(seed):
    cfg, jcfg = t_configs.smoke_config("granite-3-2b"), j_configs.smoke_config("granite-3-2b")
    ours, ref = LMClients(cfg, 3, 4, 16, seed=seed), JLMClients(jcfg, 3, 4, 16, seed=seed)
    for client in (0, 2, 0, 1):
        a, b = ours.streams[client].batch(ours.batch), ref.streams[client].batch(ref.batch)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-130m"])
def test_gradients_match_reference(arch):
    """Three `grad` calls (two clients, one twice: the stream moves on) on
    converted weights, each gradient within 1e-5 of JAX's; ``grad_calls``
    counts them."""
    cfg, jcfg = t_configs.smoke_config(arch), j_configs.smoke_config(arch)
    jp = j_module.init_params(j_api.model_meta(jcfg), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    ours, ref = LMClients(cfg, 2, 2, 32, seed=1), JLMClients(jcfg, 2, 2, 32, seed=1)
    for step, client in enumerate((1, 0, 1)):
        g = ours.grad(client, tp, step)
        jg = ref.grad(client, jp, step)
        scale = max(float(np.abs(np.asarray(x)).max()) for x in jax.tree_util.tree_leaves(jg))
        gap = max(float(np.abs(a.numpy() - np.asarray(b)).max())
                  for a, b in zip(tree_leaves(g), jax.tree_util.tree_leaves(jg)))
        print(f"{arch} call {step} client {client}: gradient gap {gap:.2e} (largest {scale:.3f})")
        assert gap <= 1e-5
    assert ours.grad_calls == ref.grad_calls == 3
