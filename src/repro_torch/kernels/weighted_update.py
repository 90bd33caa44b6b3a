"""CUDA wrappers of the fused server-update kernels (`csrc/weighted_update.cu`).

K1 (`weighted_update`) replaces the TPU kernel
`repro/kernels/weighted_update.py:weighted_update` — the per-event
Algorithm 1 line-10 update, plain (K1a) or with momentum (K1b).  K2
(`block_prefix_update`) replaces `repro/kernels/weighted_update.py:
block_prefix_update` — the blocked engine's prefix sum plus the in-place
scatter into the (C+1, P) snapshot ring.  K6 (`block_scatter_rows`)
replaces `repro/kernels/weighted_update.py:block_scatter_rows` — the
lane-sharded engine's scatter of precomputed iterates into the ring.  K6
writes a lane's row only when the lane is live (`live_lanes`, the rule the
CUDA kernel follows), so each distinct ring row is written once, by the
last lane that targets it; `scatter_vec` asks the library how many ring
values a thread moves per access, `scatter_kernel_info` what the kernel
holds.

These wrappers take CUDA tensors only: they check dtype, shape, device and
contiguity, allocate the outputs, launch on PyTorch's current stream and
raise if the launch is refused.  They never synchronise.  `kernels.ops`
picks between them and the plain versions in `kernels.ref` by the tensor's
device.  Each wrapper adds one to its entry of `launches` per launch, and
nowhere else, so a run can show that it went through the kernels.
"""
from __future__ import annotations

import ctypes
from collections.abc import Sequence

import torch

from . import build

__all__ = ["BLOCK_TILE", "MAX_SCATTER_LANES", "launches", "live_lanes", "reset_launches",
           "scatter_kernel_info", "scatter_vec", "weighted_update", "block_prefix_update",
           "block_scatter_rows"]

# the blocked engine pads the packed parameter vector to a multiple of this
# once at init, as the TPU path does (its column tile); the CUDA kernel
# itself takes any P
BLOCK_TILE = 1024
# K6 keeps a block's slots in shared memory: at most this many lanes
MAX_SCATTER_LANES = 4096

launches = {"weighted_update": 0, "weighted_update_momentum": 0, "block_prefix_update": 0,
            "block_scatter_rows": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _code(t: torch.Tensor, what: str) -> int:
    if t.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {t.dtype} not supported (float32 | bfloat16)")
    return _DTYPES[t.dtype]


def _check_cuda(*ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"CUDA kernel needs all operands on one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("CUDA kernel needs contiguous operands")


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {fn} failed to launch: cudaError {err}")


def _block_operands(snaps, w, rows, slots, name: str) -> tuple[int, int, int, int, int]:
    """Check the operands of K2 / K6: ring ``snaps`` (R, P) and ``w`` (P,)
    float32 | bfloat16, ``rows`` (E, P) float32, ``slots`` (E,) int64, all
    contiguous on one CUDA device.  Returns ``(R, P, E, ring code, w code)``."""
    R, P = snaps.shape
    E = rows.shape[0]
    if w.shape != (P,) or rows.shape != (E, P) or slots.shape != (E,):
        raise ValueError(
            f"shapes snaps {tuple(snaps.shape)}, w {tuple(w.shape)}, "
            f"{name} {tuple(rows.shape)}, slots {tuple(slots.shape)} do not agree"
        )
    if E < 1:
        raise ValueError("a block needs at least one event")
    if rows.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 (fp32 rows)")
    if slots.dtype != torch.int64:
        raise TypeError("slots must be int64")
    sc, wc = _code(snaps, "snaps"), _code(w, "w")
    _check_cuda(snaps, w, rows, slots)
    return R, P, E, sc, wc


def live_lanes(slots: Sequence[int], R: int) -> list[bool]:
    """K6's rule (``csrc/weighted_update.cu:block_scatter_rows_kernel``):
    lane i writes its row of W to the ring when its slot lies in [0, R) and
    no later lane has the same slot.  Writing only the live lanes, in any
    order, leaves the ring as writing every lane in event order does."""
    s = [int(v) for v in slots]
    return [0 <= s[i] < R and s[i] not in s[i + 1:] for i in range(len(s))]


def weighted_update(
    w: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
    m: torch.Tensor | None = None, momentum: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """K1 on one parameter tensor of any shape: ``(w', m')`` (``m'`` None
    without momentum).  ``scale`` is a float32 device scalar; ``g`` is cast
    to ``w.dtype`` first (the TPU kernel's rule); ``m`` is float32."""
    code = _code(w, "weighted_update")
    if g.shape != w.shape:
        raise ValueError(f"g shape {tuple(g.shape)} != w shape {tuple(w.shape)}")
    g = g.to(w.dtype).contiguous()
    w = w.contiguous()
    scale = scale.to(device=w.device, dtype=torch.float32).reshape(1)
    _check_cuda(w, g, scale)
    out = torch.empty_like(w)
    n = w.numel()
    lib = build.load("weighted_update")
    if m is None:
        if n:
            _raise_on(lib.wu_plain(code, w.data_ptr(), g.data_ptr(), scale.data_ptr(),
                                   out.data_ptr(), n, _stream(w)), "wu_plain")
            launches["weighted_update"] += 1
        return out, None
    if m.dtype != torch.float32 or m.shape != w.shape:
        raise ValueError("momentum buffer must be float32 with w's shape")
    m = m.contiguous()
    _check_cuda(w, m)
    out_m = torch.empty_like(m)
    if n:
        _raise_on(lib.wu_momentum(code, w.data_ptr(), g.data_ptr(), m.data_ptr(),
                                  scale.data_ptr(), float(momentum), out.data_ptr(),
                                  out_m.data_ptr(), n, _stream(w)), "wu_momentum")
        launches["weighted_update_momentum"] += 1
    return out, out_m


def block_prefix_update(
    snaps: torch.Tensor, w: torch.Tensor, D: torch.Tensor, slots: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K2: apply one conflict-free micro-block to ``(snaps, w)``.

    ``snaps`` (R, P) float32 | bfloat16 is updated in place (the CUDA
    counterpart of the TPU kernel's ``input_output_aliases``); ``w`` (P,),
    ``D`` (E, P) float32, ``slots`` (E,) int64 with the trash row R-1 on
    padded lanes.  Returns ``(snaps, w')``.
    """
    R, P, E, sc, wc = _block_operands(snaps, w, D, slots, "D")
    w_out = torch.empty_like(w)
    lib = build.load("weighted_update")
    _raise_on(lib.block_prefix_update(sc, wc, snaps.data_ptr(), w.data_ptr(), D.data_ptr(),
                                      slots.data_ptr(), w_out.data_ptr(), R, P, E,
                                      _stream(w)), "block_prefix_update")
    launches["block_prefix_update"] += 1
    return snaps, w_out


def block_scatter_rows(
    snaps: torch.Tensor, w: torch.Tensor, W: torch.Tensor, slots: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K6: scatter one micro-block's precomputed iterates into ``(snaps, w)``.

    ``snaps`` (R, P) float32 | bfloat16 is updated in place; ``w`` (P,) sets
    the dtype of ``w'`` only; ``W`` (E, P) float32, ``slots`` (E,) int64
    with the trash row R-1 on padded lanes.  Returns ``(snaps, W[E-1])``,
    the last row cast to ``w.dtype``.
    """
    R, P, E, sc, wc = _block_operands(snaps, w, W, slots, "W")
    if E > MAX_SCATTER_LANES:
        raise ValueError(f"block_scatter_rows takes at most {MAX_SCATTER_LANES} lanes, got {E}")
    w_out = torch.empty_like(w)
    lib = build.load("weighted_update")
    _raise_on(lib.block_scatter_rows(sc, wc, snaps.data_ptr(), W.data_ptr(), slots.data_ptr(),
                                     w_out.data_ptr(), R, P, E, _stream(w)), "block_scatter_rows")
    launches["block_scatter_rows"] += 1
    return snaps, w_out


def scatter_vec(snaps: torch.Tensor, W: torch.Tensor) -> int:
    """Ring values one thread of K6 moves per access on these CUDA operands,
    as the library picks it (``csrc/weighted_update.cu:scatter_vec``): 16
    bytes (4 fp32, 8 bf16) when P and the alignment of ``snaps`` and ``W``
    allow it, else 1 value."""
    return build.load("weighted_update").block_scatter_rows_vec(
        _code(snaps, "snaps"), snaps.data_ptr(), W.data_ptr(), snaps.shape[1])


def scatter_kernel_info(ring_dtype: torch.dtype, vec: int, E: int = 8,
                        w_dtype: torch.dtype = torch.float32) -> dict:
    """Registers, static and dynamic shared memory, local (spill) bytes and
    CTAs an SM holds of the K6 kernel for a ring of ``ring_dtype`` moving
    ``vec`` values per access (1, or 16 bytes of them), at ``E`` lanes
    (builds the library)."""
    out = (ctypes.c_int * 5)()
    _raise_on(build.load("weighted_update").block_scatter_rows_kernel_info(
        _DTYPES[ring_dtype], _DTYPES[w_dtype], vec, E, ctypes.cast(out, ctypes.c_void_p)),
        "block_scatter_rows_kernel_info")
    return dict(zip(("registers", "static_smem", "dynamic_smem", "local_bytes", "ctas_per_sm"),
                    out))
