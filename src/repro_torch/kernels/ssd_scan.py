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
"""
from __future__ import annotations

import torch

from ..device import on_cuda
from . import build, ref
from .weighted_update import _check_cuda, _code, _raise_on, _stream

__all__ = ["SSDScan", "ssd_scan_fwd", "smem_bytes", "launches", "reset_launches"]

launches = {"ssd_scan": 0}

MAX_SMEM = 232448  # the shared memory one block may opt in to on sm_90 (227 KB)


def reset_launches() -> None:
    launches["ssd_scan"] = 0


def smem_bytes(Q: int, N: int, P: int) -> int:
    """Shared memory of one CTA; must agree with ``smem_bytes`` in the CUDA
    source: the fp32 state (N, P), B (Q, N+1), C (Q, N), dt*x (Q, P), the
    scores (Q, Q), and three (Q,) vectors."""
    return 4 * (N * P + Q * (N + 1) + Q * N + Q * P + Q * Q + 3 * Q)


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
