"""PyTorch port, kernels: the plain versions against the JAX package's
references and Pallas kernels (interpret mode), and the device dispatch.
The CUDA kernels themselves are held against the plain versions on the card
by `tests/test_torch_gpu.py`.

Inputs are drawn with numpy and handed to both packages.  Tolerances are
`tests/test_kernels.py`'s: 2e-5 fp32, 2e-2 bf16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.weighted_update import block_prefix_update as j_block_pallas  # noqa: E402
from repro.kernels.weighted_update import weighted_update as j_wu_pallas  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.kernels import weighted_update as t_cuda  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" else dict(atol=2e-5, rtol=2e-5)


def _both(a: np.ndarray, name: str):
    td, jd = DTYPES[name]
    return torch.tensor(a).to(td), jnp.asarray(a, jd)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------------ #
# K1: weighted_update
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(17,), (1000, 37), (8, 128), (3, 5, 7)])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_weighted_update_plain_matches_jax(dtype, shape, momentum):
    rng = np.random.default_rng([int(np.prod(shape)), len(shape), int(10 * momentum)])
    w, g = rng.normal(size=shape).astype(np.float32), rng.normal(size=shape).astype(np.float32)
    m = rng.normal(size=shape).astype(np.float32) if momentum else None
    (tw, jw), (tg, jg) = _both(w, dtype), _both(g, dtype)
    tm = None if m is None else torch.tensor(m)
    jm = None if m is None else jnp.asarray(m)
    scale = 0.37
    ow, om = t_ref.weighted_update_ref(tw, tg, torch.tensor(scale), m=tm, momentum=momentum)
    assert ow.dtype == tw.dtype
    for ew, em in (
        j_ref.weighted_update_ref(jw, jg, jnp.float32(scale), m=jm, momentum=momentum),
        j_wu_pallas(jw, jg, jnp.float32(scale), m=jm, momentum=momentum, interpret=True),
    ):
        np.testing.assert_allclose(_np(ow), _np(ew), **_tol(dtype))
        if momentum:
            np.testing.assert_allclose(_np(om), _np(em), atol=1e-5)


def test_weighted_update_casts_g_to_w_dtype_first():
    """The kernels' dtype rule: g is rounded to w's dtype before the fp32
    math (the TPU kernel does so; the JAX reference does not)."""
    rng = np.random.default_rng(0)
    w = torch.tensor(rng.normal(size=64).astype(np.float32)).to(torch.bfloat16)
    g = torch.tensor(rng.normal(size=64).astype(np.float32))
    ow, _ = t_ref.weighted_update_ref(w, g, 0.5)
    jw, _ = j_wu_pallas(jnp.asarray(w.float().numpy(), jnp.bfloat16), jnp.asarray(g.numpy()),
                        jnp.float32(0.5), interpret=True)
    np.testing.assert_array_equal(_np(ow), _np(jw))


def test_weighted_update_tree_matches_per_leaf():
    rng = np.random.default_rng(1)
    params = {k: torch.tensor(rng.normal(size=s).astype(np.float32))
              for k, s in (("w", (4, 3)), ("b", (3,)))}
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    mom = {k: torch.zeros_like(v) for k, v in params.items()}
    new, m2 = ops.weighted_update_tree(params, grads, 0.1, momenta=mom, momentum=0.9)
    for k in params:
        np.testing.assert_allclose(new[k].numpy(), params[k].numpy() - 0.1, atol=1e-7)
        np.testing.assert_allclose(m2[k].numpy(), 1.0)
    assert set(ops.tree_weighted_update(params, grads, 0.1)) == {"w", "b"}


# ------------------------------------------------------------------ #
# K2: block_prefix_update
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("store", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,P,E,pad", [(4, 1024, 1, 0), (8, 2048, 4, 0), (8, 1024, 4, 2),
                                        (16, 3072, 8, 3)])
def test_block_prefix_update_plain_matches_jax(store, C, P, E, pad):
    """Full ring compared, trash row C included; ``pad`` padded lanes all
    write the trash row (duplicate slots resolve last-writer-wins)."""
    rng = np.random.default_rng(C * 100 + E * 10 + pad)
    snaps = rng.normal(size=(C + 1, P)).astype(np.float32)
    w = rng.normal(size=P).astype(np.float32)
    D = (0.05 * rng.normal(size=(E, P))).astype(np.float32)
    slots = np.concatenate([rng.choice(C, size=E - pad, replace=False), [C] * pad]).astype(np.int64)
    ts, js = _both(snaps, store)
    out_s, out_w = t_ref.block_prefix_update_ref(
        ts, torch.tensor(w), torch.tensor(D), torch.tensor(slots))
    assert out_s is ts and out_s.dtype == DTYPES[store][0]  # written in place
    for es, ew in (
        j_ref.block_prefix_update_ref(js, jnp.asarray(w), jnp.asarray(D), jnp.asarray(slots, jnp.int32)),
        j_block_pallas(js, jnp.asarray(w), jnp.asarray(D), jnp.asarray(slots, jnp.int32),
                       interpret=True),
    ):
        np.testing.assert_allclose(_np(out_s), _np(es), **_tol(store))
        np.testing.assert_allclose(_np(out_w), _np(ew), atol=2e-5)


def test_block_prefix_update_duplicate_trash_slots_last_writer_wins():
    """Every lane on the trash row: the row holds the last prefix W_{E-1},
    as the Pallas kernel leaves it."""
    C, P, E = 3, 1024, 4
    rng = np.random.default_rng(5)
    snaps = rng.normal(size=(C + 1, P)).astype(np.float32)
    w = rng.normal(size=P).astype(np.float32)
    D = rng.normal(size=(E, P)).astype(np.float32)
    slots = np.full(E, C, np.int64)
    out_s, out_w = t_ref.block_prefix_update_ref(
        torch.tensor(snaps), torch.tensor(w), torch.tensor(D), torch.tensor(slots))
    js, _ = j_block_pallas(jnp.asarray(snaps), jnp.asarray(w), jnp.asarray(D),
                           jnp.asarray(slots, jnp.int32), interpret=True)
    np.testing.assert_allclose(out_s.numpy(), np.asarray(js), atol=2e-5)
    np.testing.assert_allclose(out_s[C].numpy(), out_w.numpy(), atol=0)
    np.testing.assert_array_equal(out_s[:C].numpy(), snaps[:C])


# ------------------------------------------------------------------ #
# dispatch by the tensor's device
# ------------------------------------------------------------------ #
def test_ops_on_cpu_take_the_plain_version_and_launch_nothing():
    t_cuda.reset_launches()
    w, g = torch.randn(10), torch.randn(10)
    ow, _ = ops.weighted_update(w, g, 0.5)
    np.testing.assert_array_equal(ow.numpy(), t_ref.weighted_update_ref(w, g, 0.5)[0].numpy())
    snaps = torch.zeros(3, 1024)
    ops.block_prefix_update(snaps, torch.ones(1024), torch.ones(2, 1024), torch.tensor([0, 2]))
    np.testing.assert_array_equal(snaps[2].numpy(), -1.0)
    assert all(v == 0 for v in t_cuda.launches.values())


def test_cuda_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        t_cuda.weighted_update(torch.randn(4), torch.randn(4), torch.tensor(0.1))
    with pytest.raises(ValueError, match="CUDA"):
        t_cuda.block_prefix_update(torch.zeros(3, 8), torch.zeros(8), torch.zeros(2, 8),
                                   torch.tensor([0, 1]))
    with pytest.raises(TypeError):
        t_cuda.block_prefix_update(torch.zeros(3, 8), torch.zeros(8), torch.zeros(2, 8),
                                   torch.tensor([0, 1], dtype=torch.int32))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build.Path, "is_file", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
