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

The CUDA source has two kernels behind that one entry point: the
tensor-core kernel (bf16 at a head dim of `TC_HEAD_DIMS`, 64 query rows x
64-key tiles) and the CUDA-core kernel (fp32, and bf16 at any other D; 32 x
32).  `kernel_tiles` asks the library which tile a call gets, and
`key_tiles` is the kernels' rule for the key tiles a query tile visits,
kept in Python too so that the rule can be tested on the CPU.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import on_cuda
from . import build, ref
from .weighted_update import _DTYPES as _DTYPE_CODES
from .weighted_update import _check_cuda, _code, _raise_on, _stream

__all__ = ["FlashAttention", "TC_HEAD_DIMS", "flash_attention_fwd", "kernel_info",
           "kernel_tiles", "key_tiles", "launches", "reset_launches", "visited_pairs"]

launches = {"flash_attention": 0}

TC_HEAD_DIMS = (32, 64, 80, 128)  # the tensor-core kernel's templates
TC_TILE = (64, 64)                # its (query rows, keys) per CTA and staged tile
SIMPLE_TILE = (32, 32)            # the CUDA-core kernel's


def kernel_tiles(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                 window: int = 0, q_offset: int = 0) -> tuple[int, int]:
    """``(query rows, keys)`` of the tile of the kernel that
    `flash_attention_fwd` takes on these CUDA operands and output, as the
    library's dispatch reports it (``csrc/flash_attention.cu:
    flash_attention_route``): `TC_TILE` for the tensor-core kernel,
    `SIMPLE_TILE` for the CUDA-core kernel."""
    S, D, T = q.shape[1], q.shape[3], k.shape[1]
    tc = build.load("flash_attention").flash_attention_route(
        _code(q, "flash_attention"), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        S, T, D, int(window), int(q_offset))
    return TC_TILE if tc else SIMPLE_TILE


def key_tiles(q0: int, bq: int, S: int, T: int, causal: bool, window: int, q_offset: int,
              bk: int) -> tuple[int, int]:
    """Key tiles ``[lo, hi)`` (of ``bk`` keys) that the CTA of query rows
    ``[q0, q0 + bq)`` visits; the mirror of ``csrc/flash_attention.cu:
    key_tiles``.  A tile is left out only when every real row (< S) of the
    query tile masks all its keys, and when some row masks all T keys (that
    row averages v over all of them, as the reference does) nothing is
    left out."""
    ntiles = -(-T // bk)
    p0 = q0 + q_offset
    p1 = min(q0 + bq, S) - 1 + q_offset
    if (causal and p0 < 0) or (window > 0 and p1 - window + 1 > T - 1):
        return 0, ntiles
    t_lo = max(0, p0 - window + 1) if window > 0 else 0
    t_hi = min(T - 1, p1) if causal else T - 1
    return t_lo // bk, t_hi // bk + 1


def visited_pairs(S: int, T: int, causal: bool, window: int, q_offset: int,
                  bq: int, bk: int) -> int:
    """(query row, key) pairs the kernel scores: each real row against the
    real keys of its query tile's visited key tiles."""
    total = 0
    for q0 in range(0, S, bq):
        lo, hi = key_tiles(q0, bq, S, T, causal, window, q_offset, bk)
        total += (min(q0 + bq, S) - q0) * (min(hi * bk, T) - lo * bk)
    return total


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


def kernel_info(dtype: torch.dtype, D: int) -> dict:
    """Registers, static and dynamic shared memory and local (spill) bytes
    of the kernel `flash_attention_fwd` launches for ``dtype`` at head dim
    ``D``, as the CUDA runtime reports them (builds the library)."""
    out = (ctypes.c_int * 4)()
    _raise_on(build.load("flash_attention").flash_attention_kernel_info(
        _DTYPE_CODES[dtype], D, ctypes.cast(out, ctypes.c_void_p)), "flash_attention_kernel_info")
    return dict(zip(("registers", "static_smem", "dynamic_smem", "local_bytes"), out))


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
