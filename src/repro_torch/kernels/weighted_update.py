"""CUDA wrappers of the fused server-update kernels (`csrc/weighted_update.cu`).

K1 (`weighted_update_leaves`) replaces the TPU kernel
`repro/kernels/weighted_update.py:weighted_update` — the per-event
Algorithm 1 line-10 update, plain (K1a) or with momentum (K1b) — and takes
every leaf of an event in one launch (`leaf_plan` mirrors its split of the
leaves into chunks, `update_kernel_info` says what the kernel holds).  K2
(`block_prefix_update`) replaces `repro/kernels/weighted_update.py:
block_prefix_update` — the blocked engine's prefix sum plus the in-place
scatter into the (C+1, P) snapshot ring.  K6 (`block_scatter_rows`)
replaces `repro/kernels/weighted_update.py:block_scatter_rows` — the
lane-sharded engine's scatter of precomputed iterates into the ring.  K2
and K6 write a lane's row only when the lane is live (`live_lanes`, the
rule the CUDA kernels follow), so each distinct ring row is written once,
by the last lane that targets it; `prefix_vec` and `scatter_vec` ask the
library how many ring values a thread moves per access,
`prefix_kernel_info` and `scatter_kernel_info` what the kernels hold.
All three also take a cell axis (the scenario matrix's B runs in
lockstep): K1 one scale a cell, each cell's slice of a leaf a leaf of its
table (`cell_rows`, `leaf_code`); K2 B rings, weights, deltas and slots in
one launch, and K6 B rings, iterates and slots (the lane-sharded matrix).

These wrappers take CUDA tensors only: they check dtype, shape, device and
contiguity, allocate the outputs, launch on PyTorch's current stream and
raise if the launch is refused.  They never synchronise.  `kernels.ops`
picks between them and the plain versions in `kernels.ref` by the tensor's
device.  Each wrapper adds one to its entry of `launches` per launch, and
nowhere else, so a run can show that it went through the kernels; K1 also
adds the leaves each launch covered to ``weighted_update_leaves`` (or
``weighted_update_momentum_leaves``).
"""
from __future__ import annotations

import array
import ctypes
import functools
from bisect import bisect_right
from collections.abc import Sequence

import torch

from . import build

__all__ = ["BLOCK_TILE", "LEAF_THREADS", "LEAF_UNROLL", "MAX_BLOCK_LANES", "MAX_CELLS",
           "MAX_LEAVES", "cell_rows", "launches", "leaf_code", "leaf_of", "leaf_plan",
           "live_lanes", "reset_launches",
           "prefix_kernel_info", "prefix_vec", "scatter_kernel_info", "scatter_vec",
           "update_kernel_info", "weighted_update", "weighted_update_leaves",
           "block_prefix_update", "block_scatter_rows"]

# the blocked engine pads the packed parameter vector to a multiple of this
# once at init, as the TPU path does (its column tile); the CUDA kernel
# itself takes any P
BLOCK_TILE = 1024
# K2 and K6 keep a block's slots in shared memory: at most this many lanes
MAX_BLOCK_LANES = 4096
# K1's split, as csrc/weighted_update.cu fixes it: a launch takes at most
# MAX_LEAVES leaves; a chunk (one CTA) is LEAF_THREADS * LEAF_UNROLL accesses
MAX_LEAVES = 64
LEAF_THREADS, LEAF_UNROLL = 256, 4
# K1's cell index of a leaf is 16 bits
MAX_CELLS = 1 << 16

launches = {"weighted_update": 0, "weighted_update_leaves": 0, "weighted_update_momentum": 0,
            "weighted_update_momentum_leaves": 0, "block_prefix_update": 0,
            "block_scatter_rows": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# bytes of a value, by dtype code
_ESZ = (4, 2)
# K1's C entry point with its argtypes, resolved at first launch
_leaves_fn = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _code_of(dtype: torch.dtype, what: str) -> int:
    if dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {dtype} not supported (float32 | bfloat16)")
    return _DTYPES[dtype]


def _code(t: torch.Tensor, what: str) -> int:
    return _code_of(t.dtype, what)


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


def _block_operands(snaps, w, rows, slots, name: str,
                    cells: bool = False) -> tuple[int, int, int, int, int]:
    """Check the operands of K2 / K6: ring ``snaps`` (R, P) and ``w`` (P,)
    float32 | bfloat16, ``rows`` (E, P) float32, ``slots`` (E,) int64, all
    contiguous on one CUDA device, 1 <= E <= `MAX_BLOCK_LANES`; with
    ``cells`` each has a leading axis of B cells.  Returns ``(R, P, E, ring
    code, w code)``."""
    lead = tuple(snaps.shape[:1]) if cells else ()
    if snaps.ndim != len(lead) + 2:
        raise ValueError(f"snaps must be ({'B, ' if cells else ''}R, P), got {tuple(snaps.shape)}")
    R, P = snaps.shape[-2:]
    E = rows.shape[-2] if rows.ndim >= 2 else 0
    if w.shape != lead + (P,) or rows.shape != lead + (E, P) or slots.shape != lead + (E,):
        raise ValueError(
            f"shapes snaps {tuple(snaps.shape)}, w {tuple(w.shape)}, "
            f"{name} {tuple(rows.shape)}, slots {tuple(slots.shape)} do not agree"
        )
    if not 1 <= E <= MAX_BLOCK_LANES:
        raise ValueError(f"a block takes 1 to {MAX_BLOCK_LANES} events, got {E}")
    if rows.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 (fp32 rows)")
    if slots.dtype != torch.int64:
        raise TypeError("slots must be int64")
    sc, wc = _code(snaps, "snaps"), _code(w, "w")
    _check_cuda(snaps, w, rows, slots)
    return R, P, E, sc, wc


def live_lanes(slots: Sequence[int], R: int) -> list[bool]:
    """K2's and K6's rule (``csrc/weighted_update.cu``): lane i writes its
    row to the ring when its slot lies in [0, R) and no later lane has the
    same slot.  Writing only the live lanes, in any order, leaves the ring
    as writing every lane in event order does."""
    s = [int(v) for v in slots]
    return [0 <= s[i] < R and s[i] not in s[i + 1:] for i in range(len(s))]


def leaf_plan(numels: Sequence[int], widths: Sequence[int]) -> list[list[tuple[int, int, int]]]:
    """K1's split of a list of leaves (``csrc/weighted_update.cu:
    weighted_update_leaves``), for the CPU tests: the leaves with values go,
    in order, at most `MAX_LEAVES` a launch; each launch lists ``(leaf,
    first chunk, chunks)``.  Leaf i moves ``widths[i]`` values an access, so
    a chunk covers LEAF_THREADS * LEAF_UNROLL * widths[i] of its values:
    CTA b of a launch takes chunk ``b - first`` of leaf `leaf_of`(launch, b)."""
    live = [i for i, n in enumerate(numels) if n > 0]
    plan = []
    for k in range(0, len(live), MAX_LEAVES):
        first, rows = 0, []
        for i in live[k:k + MAX_LEAVES]:
            chunks = -(-int(numels[i]) // (LEAF_THREADS * LEAF_UNROLL * int(widths[i])))
            rows.append((i, first, chunks))
            first += chunks
        plan.append(rows)
    return plan


def leaf_of(launch: Sequence[tuple[int, int, int]], b: int) -> int:
    """The row of ``launch`` (`leaf_plan`) that CTA ``b`` takes: the last
    whose first chunk is <= b (the kernel's binary search)."""
    return bisect_right([first for _, first, _ in launch], b) - 1


def leaf_code(w_dtype: torch.dtype, g_dtype: torch.dtype, cell: int = 0) -> int:
    """The code field of a K1 leaf row: w's dtype code | g's << 8 | the
    leaf's cell << 16 (the cell whose scale it takes; 16 bits)."""
    if not 0 <= cell < MAX_CELLS:
        raise ValueError(f"cell {cell} outside [0, {MAX_CELLS})")
    return (_code_of(w_dtype, "weighted_update w") | _code_of(g_dtype, "weighted_update g") << 8
            | cell << 16)


def cell_rows(ptrs: Sequence[int], sizes: Sequence[int], n: int, code: int,
              cells: int = 1) -> list[tuple[int, ...]]:
    """K1's table rows of one leaf of ``n`` values over its ``cells``: the
    rows (w, g, w', m, m' pointers, numel, code) of each cell's slice, cell
    c's ``n / cells`` values at c * (n / cells) values from each base
    pointer (``ptrs``, 0 for an operand that is absent), ``sizes`` the
    operands' bytes a value, and c in bits 16 and up of the code."""
    if n % cells:
        raise ValueError(f"{n} values do not split over {cells} cells")
    per = n // cells
    if not per:
        return []
    return [tuple(p + c * per * sz if p else 0 for p, sz in zip(ptrs, sizes))
            + (per, code | c << 16) for c in range(cells)]


def _leaves_kernel():
    global _leaves_fn
    if _leaves_fn is None:
        _leaves_fn = build.load("weighted_update").weighted_update_leaves
    return _leaves_fn


@functools.lru_cache(maxsize=64)
def _leaf_layout(key: tuple, with_m: bool):
    """Where K1's outputs of a leaf list go, from its (w shape, w dtype, g
    shape, g dtype) per leaf: ``(totals, leaves, m_total)``.  ``totals``
    maps each w dtype to the values of its one output buffer; ``leaves``
    holds per leaf (w dtype, offset in that buffer, shape, strides, numel,
    dtype codes, offset in the m' buffer).  Every offset starts a leaf on a
    16-byte boundary."""
    totals: dict[torch.dtype, int] = {}
    leaves, m_total = [], 0
    for w_shape, w_dtype, g_shape, g_dtype in key:
        if g_shape != w_shape:
            raise ValueError(f"g shape {tuple(g_shape)} != w shape {tuple(w_shape)}")
        wc = _code_of(w_dtype, "weighted_update w")
        codes = leaf_code(w_dtype, g_dtype)
        n = w_shape.numel()
        off = totals.get(w_dtype, 0)
        totals[w_dtype] = off + n + (-n % (16 // _ESZ[wc]))
        strides, step = [], 1
        for d in reversed(w_shape):
            strides.append(step)
            step *= d
        leaves.append((w_dtype, off, w_shape, tuple(reversed(strides)), n, codes, m_total))
        m_total += n + (-n % 4) if with_m else 0
    return totals, leaves, m_total


def weighted_update_leaves(
    ws: Sequence[torch.Tensor], gs: Sequence[torch.Tensor], scale,
    ms: Sequence[torch.Tensor] | None = None, momentum: float = 0.0,
) -> tuple[list[torch.Tensor], list[torch.Tensor] | None]:
    """K1 over a list of parameter tensors of any shapes, in one launch (one
    more for each further `MAX_LEAVES` leaves): ``(ws', ms')``, ``ms'`` None
    without momentum.

    Each leaf keeps its dtype (float32 | bfloat16; a list may mix them);
    ``gs[i]`` (float32 | bfloat16, ``ws[i]``'s shape) is rounded to
    ``ws[i]``'s dtype in the kernel (the TPU kernel's rule); ``ms[i]`` is
    float32.  ``scale`` is a float32 device scalar (a number is copied to the
    device).  Non-contiguous leaves are made contiguous.  The outputs of a
    dtype are views of one allocation, each starting on a 16-byte boundary.

    Across cells: a (B,) ``scale`` means every leaf has a leading axis of B
    cells, and cell c's slice takes scale[c].  Each cell's slice of a leaf
    is a leaf of the kernel's table (`cell_rows`), so B x L leaves take
    ceil(B L / `MAX_LEAVES`) launches.
    """
    if len(gs) != len(ws) or (ms is not None and len(ms) != len(ws)):
        raise ValueError("ws, gs (and ms) must have one entry per leaf")
    if not ws:
        return [], (None if ms is None else [])
    dev = ws[0].device
    if not ws[0].is_cuda:
        raise ValueError(f"CUDA kernel needs all operands on one CUDA device, got {dev}")
    index = ws[0].get_device()
    if not (isinstance(scale, torch.Tensor) and scale.dtype == torch.float32
            and scale.get_device() == index):
        scale = torch.as_tensor(scale, dtype=torch.float32, device=dev)
    if scale.ndim > 1 or (scale.ndim == 0 and scale.numel() != 1):
        raise ValueError(f"scale must be one value or one a cell, got shape {tuple(scale.shape)}")
    cells = scale.shape[0] if scale.ndim == 1 else 1
    if scale.ndim == 1:
        if not 1 <= cells <= MAX_CELLS:
            raise ValueError(f"K1 takes 1 to {MAX_CELLS} cells, got {cells}")
        if any(w.ndim < 1 or w.shape[0] != cells for w in ws):
            raise ValueError(f"a ({cells},) scale needs a leading axis of {cells} cells on "
                             "every leaf")
        scale = scale.contiguous()
    with_m = ms is not None
    totals, leaves, m_total = _leaf_layout(
        tuple((w.shape, w.dtype, g.shape, g.dtype) for w, g in zip(ws, gs)), with_m)
    bufs = {dt: torch.empty(n, dtype=dt, device=dev) for dt, n in totals.items()}
    bases = {dt: (b.data_ptr(), b.element_size()) for dt, b in bufs.items()}
    outs = [bufs[dt].as_strided(shape, strides, off) for dt, off, shape, strides, *_ in leaves]
    if with_m:
        mbuf = torch.empty(m_total, dtype=torch.float32, device=dev)
        m_base = mbuf.data_ptr()
        out_ms = [mbuf.as_strided(shape, strides, moff) for _, _, shape, strides, _, _, moff in leaves]
    else:
        out_ms = None
    table, keep = [], []
    for i, (dt, off, shape, _, n, codes, moff) in enumerate(leaves):
        w, g = ws[i], gs[i]
        if w.get_device() != index or g.get_device() != index:
            raise ValueError("CUDA kernel needs all operands on one CUDA device")
        if not n:
            continue
        if not w.is_contiguous():
            w = w.contiguous()
        if not g.is_contiguous():
            g = g.contiguous()
        base, esz = bases[dt]
        m = None
        if with_m:
            m = ms[i]
            if m.dtype != torch.float32 or m.shape != shape or m.get_device() != index:
                raise ValueError("momentum buffer must be float32 with w's shape, on w's device")
            m = m if m.is_contiguous() else m.contiguous()
        ptrs = (w.data_ptr(), g.data_ptr(), base + off * esz,
                m.data_ptr() if with_m else 0, m_base + moff * 4 if with_m else 0)
        # keep the contiguous copies alive until the launch is queued
        keep.append((w, g, m))
        table += cell_rows(ptrs, (esz, g.element_size(), esz, 4, 4), n, codes, cells)
    if table:
        fn = _leaves_kernel()
        stream = _stream(ws[0])
        key = "weighted_update_momentum" if with_m else "weighted_update"
        for k in range(0, len(table), MAX_LEAVES):
            part = table[k:k + MAX_LEAVES]
            rows = array.array("q", [x for row in part for x in row])
            _raise_on(fn(rows.buffer_info()[0], len(part), scale.data_ptr(), cells,
                         float(momentum), int(with_m), stream), "weighted_update_leaves")
            launches[key] += 1
            launches[key + "_leaves"] += len(part)
    return outs, out_ms


def weighted_update(
    w: torch.Tensor, g: torch.Tensor, scale,
    m: torch.Tensor | None = None, momentum: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """K1 on one parameter tensor: `weighted_update_leaves` of one leaf,
    ``(w', m')`` (``m'`` None without momentum)."""
    outs, out_ms = weighted_update_leaves([w], [g], scale, None if m is None else [m], momentum)
    return outs[0], (None if out_ms is None else out_ms[0])


def update_kernel_info(momentum: bool = False) -> dict:
    """Registers, static shared memory, local (spill) bytes and CTAs an SM
    of the K1 kernel (with momentum or not), and the bytes of its leaf table
    and the leaves it holds (builds the library)."""
    lib = build.load("weighted_update")
    out = (ctypes.c_int * 6)()
    _raise_on(lib.weighted_update_leaves_kernel_info(int(momentum),
                                                     ctypes.cast(out, ctypes.c_void_p)),
              "weighted_update_leaves_kernel_info")
    return dict(registers=out[0], static_smem=out[1], local_bytes=out[3], ctas_per_sm=out[4],
                table_bytes=out[5], max_leaves=lib.weighted_update_max_leaves())


def block_prefix_update(
    snaps: torch.Tensor, w: torch.Tensor, D: torch.Tensor, slots: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K2: apply one conflict-free micro-block to ``(snaps, w)``.

    ``snaps`` (R, P) float32 | bfloat16 is updated in place (the CUDA
    counterpart of the TPU kernel's ``input_output_aliases``); ``w`` (P,),
    ``D`` (E, P) float32, ``slots`` (E,) int64 with the trash row R-1 on
    padded lanes; only live lanes (`live_lanes`) store.  Returns
    ``(snaps, w')``.  With a cell axis — ``snaps`` (B, R, P), ``w`` (B, P),
    ``D`` (B, E, P), ``slots`` (B, E) — one launch applies each cell's block
    to its own ring (at most 65,535 cells).
    """
    cells = snaps.ndim == 3
    R, P, E, sc, wc = _block_operands(snaps, w, D, slots, "D", cells=cells)
    B = snaps.shape[0] if cells else 1
    if not 1 <= B <= 65535:
        raise ValueError(f"K2 takes 1 to 65535 cells a launch, got {B}")
    w_out = torch.empty_like(w)
    lib = build.load("weighted_update")
    _raise_on(lib.block_prefix_update(sc, wc, snaps.data_ptr(), w.data_ptr(), D.data_ptr(),
                                      slots.data_ptr(), w_out.data_ptr(), B, R, P, E,
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
    the last row cast to ``w.dtype``.  With a cell axis — ``snaps`` (B, R,
    P), ``w`` (B, P), ``W`` (B, E, P), ``slots`` (B, E) — one launch
    scatters each cell's block into its own ring (at most 65,535 cells).
    """
    cells = snaps.ndim == 3
    R, P, E, sc, wc = _block_operands(snaps, w, W, slots, "W", cells=cells)
    B = snaps.shape[0] if cells else 1
    if not 1 <= B <= 65535:
        raise ValueError(f"K6 takes 1 to 65535 cells a launch, got {B}")
    w_out = torch.empty_like(w)
    lib = build.load("weighted_update")
    _raise_on(lib.block_scatter_rows(sc, wc, snaps.data_ptr(), W.data_ptr(), slots.data_ptr(),
                                     w_out.data_ptr(), B, R, P, E, _stream(w)),
              "block_scatter_rows")
    launches["block_scatter_rows"] += 1
    return snaps, w_out


def scatter_vec(snaps: torch.Tensor, W: torch.Tensor) -> int:
    """Ring values one thread of K6 moves per access on these CUDA operands,
    as the library picks it (``csrc/weighted_update.cu:scatter_vec``): 16
    bytes (4 fp32, 8 bf16) when P and the alignment of ``snaps`` and ``W``
    allow it, else 1 value (a leading cell axis is allowed)."""
    return build.load("weighted_update").block_scatter_rows_vec(
        _code(snaps, "snaps"), snaps.data_ptr(), W.data_ptr(), snaps.shape[-1])


def prefix_vec(snaps: torch.Tensor, w: torch.Tensor, D: torch.Tensor) -> int:
    """Ring values one thread of K2 moves per access on these CUDA operands,
    as the library picks it (``csrc/weighted_update.cu:prefix_vec``): 16
    bytes (4 fp32, 8 bf16) when P and the alignment of ``snaps``, ``w`` and
    ``D`` allow it, else 1 value."""
    return build.load("weighted_update").block_prefix_update_vec(
        _code(snaps, "snaps"), snaps.data_ptr(), w.data_ptr(), D.data_ptr(), snaps.shape[1])


def _block_kernel_info(fn: str, ring_dtype, vec, E, w_dtype) -> dict:
    out = (ctypes.c_int * 5)()
    _raise_on(getattr(build.load("weighted_update"), fn)(
        _DTYPES[ring_dtype], _DTYPES[w_dtype], vec, E, ctypes.cast(out, ctypes.c_void_p)), fn)
    return dict(zip(("registers", "static_smem", "dynamic_smem", "local_bytes", "ctas_per_sm"),
                    out))


def prefix_kernel_info(ring_dtype: torch.dtype, vec: int, E: int = 8,
                       w_dtype: torch.dtype = torch.float32) -> dict:
    """Registers, static and dynamic shared memory, local (spill) bytes and
    CTAs an SM holds of the K2 kernel for a ring of ``ring_dtype`` moving
    ``vec`` values per access (1, or 16 bytes of them), at ``E`` lanes
    (builds the library)."""
    return _block_kernel_info("block_prefix_update_kernel_info", ring_dtype, vec, E, w_dtype)


def scatter_kernel_info(ring_dtype: torch.dtype, vec: int, E: int = 8,
                        w_dtype: torch.dtype = torch.float32) -> dict:
    """The same for the K6 kernel."""
    return _block_kernel_info("block_scatter_rows_kernel_info", ring_dtype, vec, E, w_dtype)
