"""K3: causal / sliding-window GQA flash attention (`csrc/flash_attention.cu`).

The CUDA kernel replaces the TPU kernel
`repro/kernels/flash_attention.py:_fa_kernel` (the forward).  As in the JAX
package, the gradient is not a kernel: `FlashAttention` is a
`torch.autograd.Function` whose forward runs the kernel on a CUDA tensor
(the plain version on a CPU tensor) and whose backward recomputes attention
through `torch.func.vjp` of `ref.flash_attention_ref` from the saved
``(q, k, v)`` — exactly the reference's ``_fa_bwd``.  Its `vmap` rule folds
the mapped dimension into the batch and makes one launch, so the blocked
engine's ``vmap(grad(loss))`` goes through the kernel too.

`flash_attention_fwd` takes CUDA tensors only: it checks dtype, shape,
device and contiguity, allocates the output, launches on PyTorch's current
stream, raises if the launch is refused, never synchronises, and adds one
to `launches["flash_attention"]` per launch, and nowhere else.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import on_cuda
from . import build, ref
from .weighted_update import _check_cuda, _code, _raise_on, _stream

__all__ = ["FlashAttention", "flash_attention_fwd", "launches", "reset_launches"]

launches = {"flash_attention": 0}


def reset_launches() -> None:
    launches["flash_attention"] = 0


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        q_offset: int = 0) -> torch.Tensor:
    """The CUDA kernel: q (B,S,H,D), k/v (B,T,K,D) with H % K == 0, one
    dtype (float32 | bfloat16), D <= 256.  Returns (B,S,H,D) in q's dtype."""
    code = _code(q, "flash_attention")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, S, H, D = q.shape
    _, T, K, Dk = k.shape
    if k.shape[0] != B or Dk != D or K < 1 or H % K or T < 1 or D > 256:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)} do not agree "
                         "(need B and D equal, H % K == 0, T >= 1, D <= 256)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check_cuda(q, k, v)
    out = torch.empty_like(q)
    lib = build.load("flash_attention")
    _raise_on(lib.flash_attention_fwd(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, H, T, K, D, int(bool(causal)), int(window), int(q_offset),
        ctypes.c_float(1.0 / np.sqrt(D)), _stream(q)), "flash_attention_fwd")
    launches["flash_attention"] += 1
    return out


def _forward(q, k, v, causal, window, q_offset):
    """Device dispatch: the kernel on CUDA (or raise), the plain version on
    the CPU (`device.on_cuda`)."""
    if on_cuda(q):
        return flash_attention_fwd(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)


class FlashAttention(torch.autograd.Function):
    """Kernel forward, plain-reference VJP (`torch.func` compatible)."""

    @staticmethod
    def forward(q, k, v, causal, window, q_offset):
        return _forward(q, k, v, causal, window, q_offset)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, q_offset = inputs
        ctx.save_for_backward(q, k, v)
        ctx.opts = (causal, window, q_offset)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        causal, window, q_offset = ctx.opts
        _, pullback = torch.func.vjp(
            lambda q_, k_, v_: ref.flash_attention_ref(
                q_, k_, v_, causal=causal, window=window, q_offset=q_offset),
            q, k, v,
        )
        return (*pullback(g), None, None, None)

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, q_offset):
        """Fold the mapped dimension into B: one call over (N*B, ...)."""
        n = info.batch_size

        def fold(x, d):
            x = x.movedim(d, 0) if d is not None else x.expand(n, *x.shape)
            return x.reshape(n * x.shape[1], *x.shape[2:])

        qf, kf, vf = (fold(x, d) for x, d in zip((q, k, v), in_dims[:3]))
        out = FlashAttention.apply(qf, kf, vf, causal, window, q_offset)
        return out.reshape(n, -1, *out.shape[1:]), 0
