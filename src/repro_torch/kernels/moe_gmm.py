"""K5: the grouped (per-expert) matmul of the MoE FFN (`csrc/moe_gmm.cu`).

The CUDA kernel replaces the TPU kernel `repro/kernels/moe_gmm.py:
_gmm_kernel` (the forward, y[e] = x[e] @ w[e] with fp32 accumulation).  As
in the JAX package, the gradient is not a kernel: `MoeGMM` is a
`torch.autograd.Function` whose forward runs the kernel on a CUDA tensor
(the plain version on a CPU tensor) and whose backward is `torch.func.vjp`
of `ref.moe_gmm_ref` from the saved ``(x, w)`` — the two transposed
products in fp32, each cast back to its input's dtype, exactly the
reference's ``_gmm_bwd``.

Its `vmap` rule makes one launch: with x and w both mapped (the blocked
engine's case, one set of expert weights per lane) the mapped dimension
folds into E; with x alone mapped it folds into C; with w alone mapped x is
expanded along it and folded into E.

`moe_gmm_fwd` takes CUDA tensors only: it checks device, dtype (x and w
alike, float32 | bfloat16), rank, contiguity and the inner dimensions and
raises on anything else, allocates ``y`` with `torch.empty`, launches on
PyTorch's current stream, raises if the launch is refused, never
synchronises, and adds one to ``launches["moe_gmm"]`` per launch, and
nowhere else.

The CUDA source has three kernels behind that one entry point: bf16 with
16-byte aligned rows ("tc": a ring of TMA copies feeding wgmma, one
producer and two consumer warpgroups), bf16 otherwise ("scalar") and fp32
("f32", "f32x4" with 16-byte loads); `kernel_path` asks the library which
one a call takes.
"""
from __future__ import annotations

import ctypes

import torch

from ..device import on_cuda
from . import build, ref
from .weighted_update import _DTYPES as _DTYPE_CODES
from .weighted_update import _check_cuda, _code, _raise_on, _stream

__all__ = ["MoeGMM", "kernel_info", "kernel_path", "moe_gmm_fwd", "launches", "reset_launches"]

launches = {"moe_gmm": 0}

MAX_GRID_Z = 65535  # experts per launch: the grid's z dimension


def reset_launches() -> None:
    launches["moe_gmm"] = 0


def moe_gmm_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: x (E,C,D), w (E,D,F), one dtype (float32 |
    bfloat16), both contiguous.  Returns (E,C,F) in x's dtype."""
    code = _code(x, "moe_gmm")
    if w.dtype != x.dtype:
        raise TypeError(f"moe_gmm: x ({x.dtype}) and w ({w.dtype}) must share one dtype")
    if x.ndim != 3 or w.ndim != 3 or w.shape[0] != x.shape[0] or w.shape[1] != x.shape[2]:
        raise ValueError(f"moe_gmm: shapes x {tuple(x.shape)}, w {tuple(w.shape)} "
                         "(need x (E,C,D), w (E,D,F))")
    E, C, D = x.shape
    F = w.shape[2]
    if E > MAX_GRID_Z:
        raise ValueError(f"moe_gmm: E={E} > {MAX_GRID_Z} experts per launch")
    _check_cuda(x, w)
    y = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    lib = build.load("moe_gmm")
    _raise_on(lib.moe_gmm_fwd(code, x.data_ptr(), w.data_ptr(), y.data_ptr(),
                              E, C, D, F, _stream(x)), "moe_gmm_fwd")
    launches["moe_gmm"] += 1
    return y


_ROUTES = ("f32", "f32x4", "scalar", "tc")  # csrc/moe_gmm.cu:moe_gmm_route's codes


def kernel_path(x: torch.Tensor, w: torch.Tensor) -> str:
    """Which kernel `moe_gmm_fwd` takes on these CUDA operands, as the
    library's dispatch reports it (``csrc/moe_gmm.cu:moe_gmm_route``):
    "tc" (the wgmma kernel) or "scalar" for bf16, "f32x4" (16-byte loads)
    or "f32" for float32."""
    code = build.load("moe_gmm").moe_gmm_route(_code(x, "moe_gmm"), x.data_ptr(), w.data_ptr(),
                                               x.shape[2], w.shape[2])
    return _ROUTES[code]


def kernel_info(dtype: torch.dtype, vector: bool = True) -> dict:
    """Registers, static and dynamic shared memory and local (spill) bytes
    of the kernel `moe_gmm_fwd` launches for ``dtype`` with 16-byte copies
    (``vector``) or without, as the CUDA runtime reports them (builds the
    library)."""
    out = (ctypes.c_int * 4)()
    _raise_on(build.load("moe_gmm").moe_gmm_kernel_info(
        _DTYPE_CODES[dtype], int(vector), ctypes.cast(out, ctypes.c_void_p)),
        "moe_gmm_kernel_info")
    return dict(zip(("registers", "static_smem", "dynamic_smem", "local_bytes"), out))


def _forward(x, w):
    """Device dispatch: the kernel on CUDA (or raise), the plain version on
    the CPU (`device.on_cuda`)."""
    if on_cuda(x):
        return moe_gmm_fwd(x, w)
    return ref.moe_gmm_ref(x, w)


class MoeGMM(torch.autograd.Function):
    """Kernel forward, plain-reference VJP (`torch.func` compatible)."""

    @staticmethod
    def forward(x, w):
        return _forward(x, w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        _, pullback = torch.func.vjp(ref.moe_gmm_ref, *ctx.saved_tensors)
        return pullback(g)

    @staticmethod
    def vmap(info, in_dims, x, w):
        """One call: fold the mapped dimension n into E (x and w mapped, or
        w alone with x expanded) or into C (x alone)."""
        n = info.batch_size
        xd, wd = in_dims
        if wd is None:  # x alone: (n, E, C, D) -> (E, n*C, D)
            xs = x.movedim(xd, 1)
            E, _, C, D = xs.shape
            y = MoeGMM.apply(xs.reshape(E, n * C, D).contiguous(), w)
            return y.reshape(E, n, C, -1), 1
        ws = w.movedim(wd, 0)
        xs = x.movedim(xd, 0) if xd is not None else x.expand(n, *x.shape)
        _, E, C, D = xs.shape
        y = MoeGMM.apply(xs.reshape(n * E, C, D).contiguous(),
                         ws.reshape(n * E, *ws.shape[2:]).contiguous())
        return y.reshape(n, E, C, -1), 0
