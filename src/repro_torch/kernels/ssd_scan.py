"""K4: the Mamba2 chunked SSD scan (`csrc/ssd_scan.cu`).

The CUDA kernel replaces the TPU kernel `repro/kernels/ssd_scan.py:
_ssd_kernel` (the forward from a zero state).  As in the JAX package, the
gradient is not a kernel: `SSDScan` is a `torch.autograd.Function` whose
forward runs the kernel on a CUDA tensor (the plain version on a CPU
tensor) and whose backward is `torch.func.vjp` of `ref.ssd_scan_ref` over
all five inputs from the saved ones — exactly the reference's ``_ssd_bwd``.

`SSDScan` takes ``A`` per row, as (B, H): the blocked engine's
``vmap(grad(loss))`` maps over snapshots, so ``A = -exp(A_log)`` differs per
lane, and the `vmap` rule folds the mapped dimension of all five inputs
into B, which keeps one launch with the right ``A`` on every lane.
`kernels.ops.ssd_scan` expands the model's (H,) to (B, H), and autograd
sums ``A``'s gradient back over the rows.

`ssd_scan_fwd` takes CUDA tensors only: it checks dtype, shape, device and
shared memory, makes its operands contiguous (in `mamba2.mamba_block`
``x``, ``Bm`` and ``Cm`` are strided splits of one projection), allocates
``y`` and the state, launches on PyTorch's current stream, raises if the
launch is refused, never synchronises, and adds one to
``launches["ssd_scan"]`` per launch, and nowhere else.

The CUDA source has two kernels behind that one entry point: the
tensor-core kernel ("tc": bf16 with Q <= 64, N <= 128, P <= 64, N and P
multiples of 8, 16-byte aligned x, B and C; the chunk zero-padded to its
tile) and the CUDA-core kernel ("simt": fp32, and every other bf16 call).
`kernel_route` asks the library which one a call takes, and `kernel_info`
reports which kernel it describes.  `route` (the rule in Python),
`tc_smem_bytes` and `ctas_per_sm` (the tensor-core kernel's shared memory
and the CTAs an SM holds at that size) exist for the CPU tests only; no
code path of the port uses them.
"""
from __future__ import annotations

import ctypes

import torch

from ..device import on_cuda
from . import build, ref
from .weighted_update import _DTYPES as _DTYPE_CODES
from .weighted_update import _check_cuda, _code, _raise_on, _stream

__all__ = ["SSDScan", "TC_TILE", "ctas_per_sm", "kernel_info", "kernel_route", "route",
           "ssd_scan_fwd", "smem_bytes", "tc_smem_bytes", "launches", "reset_launches"]

launches = {"ssd_scan": 0}

MAX_SMEM = 232448  # the shared memory one block may opt in to on sm_90 (227 KB)
SM_SMEM = 233472   # the shared memory of one SM (228 KB) ...
BLOCK_RESERVED_SMEM = 1024  # ... of which the runtime reserves this much per resident block
TC_TILE = (64, 128, 64)  # the tensor-core kernel's largest (Q, N, P): its tile


def reset_launches() -> None:
    launches["ssd_scan"] = 0


def smem_bytes(Q: int, N: int, P: int) -> int:
    """Shared memory of one CTA; must agree with ``smem_bytes`` in the CUDA
    source: the fp32 state (N, P), B (Q, N+1), C (Q, N), dt*x (Q, P), the
    scores (Q, Q), and three (Q,) vectors."""
    return 4 * (N * P + Q * (N + 1) + Q * N + Q * P + Q * Q + 3 * Q)


def route(dtype: torch.dtype, Q: int, N: int, P: int) -> str:
    """The kernel `ssd_scan_fwd` takes for 16-byte aligned operands:
    "tc" for bf16 with 1 <= Q <= 64, 8 <= N <= 128, 8 <= P <= 64 and N, P
    multiples of 8, else "simt".  The Python mirror of ``csrc/ssd_scan.cu:
    tc_path``; on the card the library's answer is `kernel_route`'s."""
    tq, tn, tp = TC_TILE
    tc = (dtype == torch.bfloat16 and 1 <= Q <= tq and 8 <= N <= tn and N % 8 == 0
          and 8 <= P <= tp and P % 8 == 0)
    return "tc" if tc else "simt"


def tc_smem_bytes(N: int) -> int:
    """Shared memory of one tensor-core CTA; must agree with ``tc::Layout``
    in the CUDA source: two stages of C and B (64 x NT bf16 each), x (64 x
    64 bf16) and dt (64 fp32), then the state's bf16 pair (2 x NT x 64) and
    cs (64 fp32), with NT = 64 for N <= 64, else 128."""
    Q, _, P = TC_TILE
    NT = 64 if N <= 64 else 128
    stage = 2 * (2 * Q * NT + Q * P) + 4 * Q
    return 2 * stage + 2 * 2 * NT * P + 4 * Q


def ctas_per_sm(smem: int) -> int:
    """CTAs of ``smem`` bytes of shared memory one SM holds (shared memory
    alone)."""
    return SM_SMEM // (smem + BLOCK_RESERVED_SMEM)


def kernel_route(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 64) -> str:
    """Which kernel `ssd_scan_fwd` takes on these contiguous CUDA operands,
    as the library's dispatch reports it (``csrc/ssd_scan.cu:
    ssd_scan_route``): "tc" or "simt"."""
    S, P, N = x.shape[1], x.shape[3], Bm.shape[-1]
    tc = build.load("ssd_scan").ssd_scan_route(
        _code(x, "ssd_scan"), x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), min(chunk, S), N, P)
    return "tc" if tc else "simt"


def kernel_info(dtype: torch.dtype, Q: int = 64, N: int = 128, P: int = 64) -> dict:
    """Which kernel `ssd_scan_fwd` launches for ``dtype`` at (Q, N, P) on
    aligned operands ("tc" or "simt", as the library's dispatch reports it),
    and its registers, static and dynamic shared memory, local (spill)
    bytes and CTAs an SM, as the CUDA runtime reports them (builds the
    library)."""
    out = (ctypes.c_int * 6)()
    _raise_on(build.load("ssd_scan").ssd_scan_kernel_info(
        _DTYPE_CODES[dtype], Q, N, P, ctypes.cast(out, ctypes.c_void_p)), "ssd_scan_kernel_info")
    info = dict(zip(("registers", "static_smem", "dynamic_smem", "local_bytes", "ctas_per_sm"),
                    out))
    return {"kernel": "tc" if out[5] else "simt", **info}


def ssd_scan_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel: x (B,S,H,P), dt (B,S,H), A per row (B,H), Bm/Cm
    (B,S,N), with x, Bm and Cm in one dtype (float32 | bfloat16).  Returns
    ``(y (B,S,H,P) in x's dtype, state (B,H,N,P) float32)``."""
    code = _code(x, "ssd_scan")
    if x.ndim != 4 or dt.ndim != 3 or A.ndim != 2 or Bm.ndim != 3 or Bm.shape != Cm.shape:
        raise ValueError(f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
                         f"Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if dt.shape != (B, S, H) or A.shape != (B, H) or Bm.shape[:2] != (B, S):
        raise ValueError(f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
                         f"Bm {tuple(Bm.shape)} do not agree (dt (B,S,H), A (B,H), Bm (B,S,N))")
    if S < 1:
        raise ValueError("ssd_scan needs S >= 1")
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"S={S} % chunk={Q} != 0")
    # the CUDA-core kernel's shared memory; a call within the tensor-core
    # kernel's tile (`TC_TILE`) needs less than this in either kernel
    if smem_bytes(Q, N, P) > MAX_SMEM:
        raise ValueError(f"(Q, N, P) = ({Q}, {N}, {P}) needs {smem_bytes(Q, N, P)} bytes of "
                         f"shared memory per CTA, more than the {MAX_SMEM} a block may use")
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError("x, Bm and Cm must share one dtype")
    x, Bm, Cm = x.contiguous(), Bm.contiguous(), Cm.contiguous()
    dt = dt.to(torch.float32).contiguous()
    A = A.to(torch.float32).contiguous()
    _check_cuda(x, dt, A, Bm, Cm)
    y = torch.empty_like(x)
    state = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    lib = build.load("ssd_scan")
    _raise_on(lib.ssd_scan_fwd(
        code, x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        y.data_ptr(), state.data_ptr(), B, S, H, P, N, Q, _stream(x)), "ssd_scan_fwd")
    launches["ssd_scan"] += 1
    return y, state


def _forward(x, dt, A, Bm, Cm, chunk):
    """Device dispatch: the kernel on CUDA (or raise), the plain version on
    the CPU (`device.on_cuda`)."""
    if on_cuda(x):
        return ssd_scan_fwd(x, dt, A, Bm, Cm, chunk)
    return ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk)


class SSDScan(torch.autograd.Function):
    """Kernel forward, plain-reference VJP (`torch.func` compatible).
    ``A`` is per row, (B, H)."""

    @staticmethod
    def forward(x, dt, A, Bm, Cm, chunk):
        return _forward(x, dt, A, Bm, Cm, chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, dt, A, Bm, Cm, chunk = inputs
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk

    @staticmethod
    def backward(ctx, g_y, g_state):
        chunk = ctx.chunk
        _, pullback = torch.func.vjp(
            lambda *args: ref.ssd_scan_ref(*args, chunk=chunk), *ctx.saved_tensors)
        return (*pullback((g_y, g_state)), None)

    @staticmethod
    def vmap(info, in_dims, x, dt, A, Bm, Cm, chunk):
        """Fold the mapped dimension of all five inputs into B: one call
        over (n*B, ...), with one A per folded row."""
        n = info.batch_size

        def fold(t, d):
            t = t.movedim(d, 0) if d is not None else t.expand(n, *t.shape)
            return t.reshape(n * t.shape[1], *t.shape[2:])

        folded = [fold(t, d) for t, d in zip((x, dt, A, Bm, Cm), in_dims[:5])]
        y, state = SSDScan.apply(*folded, chunk)
        return (y.reshape(n, -1, *y.shape[1:]), state.reshape(n, -1, *state.shape[1:])), (0, 0)
