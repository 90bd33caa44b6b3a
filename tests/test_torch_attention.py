"""PyTorch port, K3 flash attention on the CPU: the plain version and the
differentiable wrapper against the JAX package.

The port's `flash_attention_ref` against the Pallas kernel in interpret mode
and against `repro.kernels.ref.flash_attention_ref`; gradients through
`FlashAttention` (under `torch.func.grad` and `torch.autograd`) against JAX
grads through the kernel's custom_vjp; the `vmap` rule against a loop.  On
the CPU the wrapper's forward takes the plain version, so these tests pin
its wiring; the CUDA kernel itself is held against the plain version by
`tests/test_torch_gpu.py` and `chip_smoke.py` on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py's atol = rtol
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# (B, S, H, K, D, T, window, q_offset, bq, bk): rows of tests/test_kernels.py's
# grid, and rows whose every key is masked (q_offset past the window)
SHAPES = [
    (2, 128, 4, 2, 64, 128, 0, 0, 64, 64),
    (1, 64, 4, 1, 128, 64, 0, 0, 32, 32),       # MQA
    (1, 128, 4, 4, 128, 384, 0, 256, 64, 128),  # decode-ish offset
    (2, 64, 6, 2, 32, 64, 16, 0, 64, 64),       # narrow window
    (1, 64, 4, 2, 32, 64, 16, 200, 32, 32),     # all masked
]


def _inputs(dtype, B, S, H, K, D, T, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32) for s in ((B, S, H, D), (B, T, K, D), (B, T, K, D))]
    jdt, tdt = DT[dtype]
    return [jnp.asarray(a, jdt) for a in arrs], [torch.from_numpy(a).to(tdt) for a in arrs]


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,D,T,window,q_offset,bq,bk", SHAPES)
def test_ref_matches_jax_kernel_and_ref(dtype, B, S, H, K, D, T, window, q_offset, bq, bk):
    (jq, jk, jv), (q, k, v) = _inputs(dtype, B, S, H, K, D, T)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    out = ops.flash_attention(q, k, v, bq=bq, bk=bk, **kw)  # CPU: the plain version
    assert out.dtype == q.dtype and out.shape == q.shape
    j_kernel = j_flash(jq, jk, jv, bq=bq, bk=bk, interpret=True, **kw)
    j_plain = j_ref.flash_attention_ref(jq, jk, jv, **kw)
    # measured max abs gap over these rows: fp32 1.2e-6, bf16 1.6e-2 (one bf16
    # ulp of an output in [2, 4)); both within atol + rtol * |exp|
    for exp in (j_kernel, j_plain):
        np.testing.assert_allclose(_f32(out), _f32(exp), atol=TOL[dtype], rtol=TOL[dtype])


def test_all_masked_rows_average_v():
    """A row with every key masked averages v over all T keys (the finite
    -1e30 of the TPU kernel, not -inf)."""
    _, (q, k, v) = _inputs("float32", 1, 8, 2, 1, 16, 24)
    out = ref.flash_attention_ref(q, k, v, window=4, q_offset=100)
    mean = v.mean(dim=1, keepdim=True).expand(1, 8, 1, 16)
    torch.testing.assert_close(out[:, :, 0], mean[:, :, 0], atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["func", "autograd"])
def test_grads_match_jax_custom_vjp(dtype, mode):
    """Grads through `FlashAttention` vs `jax.grad` through the kernel's
    custom_vjp, with a linear probe loss (tests/test_lm_engine.py) so the
    cotangent does not depend on the forward's rounding."""
    (jq, jk, jv), (q, k, v) = _inputs(dtype, 1, 64, 2, 1, 32, 64)
    probe = np.random.default_rng(1).normal(size=(1, 64, 2, 32)).astype(np.float32)
    jp, tp = jnp.asarray(probe), torch.from_numpy(probe)
    jg = jax.grad(lambda q, k, v: jnp.sum(
        j_flash(q, k, v, bq=32, bk=32, interpret=True).astype(jnp.float32) * jp),
        argnums=(0, 1, 2))(jq, jk, jv)

    def loss(q, k, v):
        return torch.sum(ops.flash_attention(q, k, v).float() * tp)

    if mode == "func":
        tg = torch.func.grad(loss, argnums=(0, 1, 2))(q, k, v)
    else:
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        loss(*leaves).backward()
        tg = [x.grad for x in leaves]
    # measured max abs gap: fp32 1.4e-6, bf16 1.2e-4 (grads up to 3.9)
    for a, b in zip(tg, jg):
        assert a.dtype == q.dtype
        np.testing.assert_allclose(_f32(a), _f32(b), atol=TOL[dtype], rtol=TOL[dtype])


def test_vmap_rule_is_one_call_equal_to_a_loop(monkeypatch):
    """`vmap` folds the mapped dimension into B (one forward call, which on
    the card is one launch) and equals a Python loop over the batch; the
    forward sees plain tensors under `grad` and `vmap` (the CUDA wrapper
    reads ``data_ptr()``)."""
    seen = []
    forward = fa._forward

    def spy(q, *args):
        seen.append((tuple(q.shape), torch._C._functorch.is_functorch_wrapped_tensor(q)))
        return forward(q, *args)

    monkeypatch.setattr(fa, "_forward", spy)
    _, (q, k, v) = _inputs("float32", 2, 16, 4, 2, 8, 16)
    qs, ks, vs = (torch.stack([x, 0.5 * x, -x]) for x in (q, k, v))
    out = torch.func.vmap(lambda q, k, v: ops.flash_attention(q, k, v, window=6))(qs, ks, vs)
    assert seen == [((6, 16, 4, 8), False)]
    for i in range(3):
        torch.testing.assert_close(out[i], ref.flash_attention_ref(qs[i], ks[i], vs[i], window=6),
                                   atol=1e-6, rtol=0)
    # vmap over grad, as the blocked engine differentiates
    seen.clear()
    probe = torch.randn(2, 16, 4, 8, generator=torch.Generator().manual_seed(0))
    g = torch.func.vmap(torch.func.grad(
        lambda q, k, v: torch.sum(ops.flash_attention(q, k, v) * probe)))(qs, ks, vs)
    assert seen == [((6, 16, 4, 8), False)]
    for i in range(3):
        gi = torch.func.grad(lambda q: torch.sum(ref.flash_attention_ref(q, ks[i], vs[i]) * probe))(qs[i])
        torch.testing.assert_close(g[i], gi, atol=1e-6, rtol=0)
    # an unbatched operand is broadcast across the mapped dimension
    out = torch.func.vmap(ops.flash_attention, in_dims=(0, None, None))(qs, k, v)
    torch.testing.assert_close(out[2], ref.flash_attention_ref(qs[2], k, v), atol=1e-6, rtol=0)


def test_other_devices_raise():
    q = torch.empty((1, 4, 2, 8), device="meta")
    k = torch.empty((1, 4, 1, 8), device="meta")
    with pytest.raises(NotImplementedError, match="no kernel for device"):
        ops.flash_attention(q, k, k)


def test_cuda_wrapper_rejects_bad_operands():
    """The CUDA wrapper checks dtype and shapes before anything is built."""
    q = torch.zeros((1, 4, 3, 8))
    with pytest.raises(ValueError, match="do not agree"):
        fa.flash_attention_fwd(q, torch.zeros((1, 4, 2, 8)), torch.zeros((1, 4, 2, 8)))
    with pytest.raises(TypeError, match="not supported"):
        fa.flash_attention_fwd(q.half(), q.half(), q.half())
