#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one card.

    python3 chip_smoke.py

Phases, each a hard check (any failure exits non-zero and prints no result):

1. the card (``nvidia-smi`` name and power limit) and the nvcc build of
   every kernel source, from this checkout (one nvcc per source, all
   started together);
2. every hand-written kernel held against its plain PyTorch version on the
   card, timed with CUDA events (median over batches of back-to-back
   launches after warm-up) beside its plain version, the one PyTorch call
   computing the same function where there is one, and its bound: the
   larger of bytes moved / 3.35 TB/s and operations / peak (67 TFLOP/s
   fp32 without tensor cores, 989 TFLOP/s bf16):
   K1/K2 (max abs error, fp32 <= 1e-5, bf16 <= 2e-2) and K3 flash
   attention over its shape grid (allclose with atol = rtol = 2e-5 fp32,
   2e-2 bf16, `tests/test_kernels.py`'s rule), plus K3's gradients through
   `FlashAttention` against the reference's; K4 chunked SSD over its shape
   grid (y allclose as K3, the state within 1e-4 fp32 / 1e-2 bf16 of its
   magnitude), its gradients through `SSDScan`, and one launch under
   ``vmap`` with a batched A, equal to a loop (K5: phase 11);
3. the MLP slice — the paper's experiment, the plain path:
   ``run_experiment(FLConfig(n_clients=256, concurrency=64,
   server_steps=2000, engine="scan"), "gen_async", eval_every=500)`` with
   the full-width `ClassificationTask` MLP (hidden 128, batch 128, shard
   1024);
4. the MLP per-event kernel path (``update="pallas"``, block_size=1): K1
   launches == T x 6, weights within 1e-5 of ``update="jnp"``;
5. the MLP blocked kernel path (``block_size=8, update="pallas"``): K2
   launches == block count, weights within 1e-5 of ``update="jnp"``;
   against the per-event run, eval accuracies within 10/2048 at T=2000 and
   weights within 1e-4 at T=200;
6. the replay engine against the port's own per-event Python oracle at full
   width and T=200 (<= 1e-5), then a profile of the MLP kernel paths;
7. Granite-3.0-2B at full width in fp32: one loss and gradient with the
   kernel (``use_pallas=True``) and with the plain attention — loss within
   1e-5 relative, gradients within 1e-4 x max|g|;
8. the LM slice: full-width Granite-3.0-2B (bf16, ``use_pallas=True``),
   ``LMTask(batch 8, seq 128, shard 256)`` through ``run_experiment(
   FLConfig(n_clients=20, concurrency=4, server_steps=64,
   sampling="optimal", speed_ratio=10.0, engine="scan"), "gen_async",
   eval_every=16)`` (``run_lm``'s configuration with C cut from 8 to 4 to
   fit the card), then the same task with ``update="pallas"``: K3
   launches == 40 x forward calls, K1 launches == 64 x 11, eval loss
   finite and falling, the curve within `LM_CURVE_TOL` of the plain
   attention's, peak device memory, and a profile of a few events;
9. Mamba2-130M (K4) and Zamba2-2.7B (K3 at head_dim 80 and K4) at full
   width in fp32: one loss and gradient with the kernels and with the plain
   versions — loss within 1e-5 relative, gradients within 1e-4 x max|g|,
   K4 launches == num_layers and K3 launches == shared sites;
10. the Mamba2 LM slice at full width and depth (bf16, ``use_pallas=True``):
   ``run_lm``'s configuration, ``LMTask(batch 8, seq 128, shard 256)``,
   n=20, C=8, sampling "optimal", speed ratio 10, with T cut from 200 to 64
   and the eval cadence from 50 to 16, four ways: ``run_experiment`` (K4),
   ``update="pallas"`` (K1 launches == 64 x 11), blocked ``block_size=4,
   update="pallas"`` (K2 launches == block rows, K4 through the `vmap`
   rule == 24 x (block rows + evals)), and the plain SSD; K4 launches ==
   24 x forwards on the per-event runs, eval loss finite and falling, the
   curves within `MAMBA_CURVE_TOL` of each other, peak device memory, and a
   profile of a few events of the per-event and blocked kernel paths;
11. K5, the grouped expert matmul, against its plain version over
   `GMM_SHAPES` (allclose with atol = rtol = 2e-5 fp32, 2e-2 bf16), timed
   at Qwen1.5-MoE-A2.7B's path shape beside the plain version and
   `torch.bmm`; its gradients through `MoeGMM`; one launch under ``vmap``
   over 4 lanes, equal to a loop; a CPU tensor takes the plain version and
   a dtype mismatch raises;
12. Qwen1.5-MoE-A2.7B at full width, depth cut to `MOE_LAYERS`, in fp32
   under the sort dispatch: one loss and gradient with the kernels (K3, K5)
   and with the plain versions — loss within 1e-5 relative, gradients
   within 1e-4 x max|g|, K5 launches == 3 x layers — and the loss of the
   einsum dispatch (no K5) on the same weights within 1e-5 of the sort
   dispatch's;
13. the Qwen1.5-MoE LM slice at full width, depth `MOE_LAYERS` (bf16,
   ``use_pallas=True``, ``moe_dispatch="sort"``): ``run_lm``'s
   configuration with C cut to 4, T to 64 and the eval cadence to 16, as
   for Granite, three ways: ``run_experiment`` (K3 + K5), ``update=
   "pallas"`` (K1 launches == 64 x 19) and ``use_pallas=False`` (plain
   attention, bf16 einsum experts on the same dispatch); K5 launches == 3
   x layers x forwards and K3 == layers x forwards on the kernel runs,
   eval loss finite and falling, the curves within 1e-3 (K1) and
   `MOE_CURVE_TOL` (plain) of the kernel run's, peak device memory, and a
   profile of a few events.

Phases 4, 5, 8, 10 and 13 are the kernel paths: each launch count is zeroed
just before the run and read just after.  fp32 matmuls run in full fp32 (TF32
off for matmul and cuDNN).  The line before the last is the ``kernels``
JSON object; the last line is the result object.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12         # H100 SXM bf16 tensor cores, dense
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # tests/test_kernels.py's
# K3 shapes (B, S, H, K, D, T, window, q_offset): the grid of
# tests/test_kernels.py, Granite-3.0-2B's path shape, a long causal sequence
# with and without a window, D=80 and D=128 with ragged S and T, and rows
# whose every key is masked (T a multiple of the key tile or not)
FA_PATH_SHAPE = (8, 128, 32, 8, 64, 128, 0, 0)
FA_SHAPES = [
    (2, 128, 4, 2, 64, 128, 0, 0),
    (1, 256, 8, 4, 64, 256, 64, 0),
    (1, 64, 4, 1, 128, 64, 0, 0),
    (1, 128, 4, 4, 128, 384, 0, 256),
    (2, 64, 6, 2, 32, 64, 16, 0),
    FA_PATH_SHAPE,
    (1, 2048, 32, 8, 64, 2048, 0, 0),
    (1, 2048, 32, 8, 64, 2048, 512, 0),
    (2, 100, 8, 2, 80, 100, 0, 0),
    (1, 200, 4, 2, 128, 333, 0, 133),
    (1, 64, 4, 2, 64, 64, 16, 200),
    (1, 40, 2, 1, 64, 50, 8, 100),
]
# the LM slice: run_lm's configuration, C cut from 8 to 4 (memory)
LM_ARCH, LM_N, LM_C, LM_T, LM_EVAL = "granite-3-2b", 20, 4, 64, 16
LM_BATCH, LM_SEQ, LM_SHARD = 8, 128, 256
LM_PARAMS = 2_533_531_648
LM_LEAVES = 11
# eval-loss curve, kernel vs plain attention, relative: 5x the gap measured
# on the card (1.95e-4, NVIDIA H100 80GB HBM3, 700 W)
LM_CURVE_TOL = 1e-3
# K4 shapes (B, S, H, P, N, chunk, A range, dt range): the grid of
# tests/test_kernels.py, Mamba2-130M's path shape and the same folded to
# B=32 (blocked E=4), Zamba2-2.7B's shape, a long sequence (32 chunks of
# carried state), S < chunk, and the overflow case (A in -[1, 16], dt up to
# 1: the masked exp(cs_i - cs_j) is inf, so the kernel must select)
SSD_PATH_SHAPE = (8, 128, 24, 64, 128, 64, (1.0, 16.0), (0.001, 0.1))
SSD_SHAPES = [
    (2, 128, 3, 32, 16, 32, (0.5, 2.0), (0.01, 0.2)),
    (1, 64, 2, 64, 128, 64, (0.5, 2.0), (0.01, 0.2)),
    (1, 256, 4, 16, 8, 16, (0.5, 2.0), (0.01, 0.2)),
    SSD_PATH_SHAPE,
    (32, 128, 24, 64, 128, 64, (1.0, 16.0), (0.001, 0.1)),
    (2, 128, 80, 64, 64, 64, (1.0, 16.0), (0.001, 0.1)),
    (1, 2048, 24, 64, 128, 64, (1.0, 16.0), (0.001, 0.1)),
    (2, 40, 4, 32, 16, 64, (0.5, 2.0), (0.01, 0.2)),
    (2, 128, 3, 32, 16, 64, (1.0, 16.0), (0.0, 1.0)),
]
SSD_STATE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# the Mamba2 LM slice: run_lm's configuration at full width and depth
MAMBA_ARCH, MAMBA_C, MAMBA_E = "mamba2-130m", 8, 4
MAMBA_PARAMS, MAMBA_LEAVES = 128_983_488, 11
# eval-loss curves, relative: 5x the gaps measured on the card (NVIDIA H100
# 80GB HBM3, 700 W): K1 per leaf (bf16 leaves rounded every event) vs the
# fp32 flat update 7.52e-4, K4 vs the plain SSD 2.77e-4, blocked E=4 vs
# per-event 1.76e-4
MAMBA_CURVE_TOL = {"pallas_update": 3.8e-3, "plain_ssd": 1.4e-3, "blocked": 8.8e-4}
# K5 shapes (E, C, D, F): Qwen1.5-MoE-A2.7B's path shapes (one dispatch group
# of 8 x 128 tokens, capacity 88; gate / up, then down), the grid of
# tests/test_kernels.py, a ragged capacity, C over two 128-row slabs with D
# and F that rule out 16-byte loads, and Arctic's per-expert shape at 16 of
# its 128 experts (capacity 12 from a group of 512 tokens, top-2; bf16 only)
GMM_PATH_SHAPE = (60, 88, 2048, 1408)
GMM_SHAPES = [
    GMM_PATH_SHAPE,
    (60, 88, 1408, 2048),
    (4, 256, 128, 256),
    (2, 128, 256, 128),
    (8, 64, 64, 64),
    (4, 20, 256, 128),
    (3, 130, 100, 70),
]
GMM_ARCTIC = (16, 12, 7168, 4864)
# gradients and vmap: Qwen1.5-MoE's experts at the capacity of phase 12's
# batch (2 x 128 tokens: 24)
GMM_GRAD_SHAPE = (60, 24, 2048, 1408)
# the Qwen1.5-MoE LM slice: run_lm's configuration at full width, depth cut
# from 24 to 3 layers (the bf16 ring of 24 layers is 28.6 GB a row)
MOE_ARCH, MOE_LAYERS = "qwen2-moe-a2.7b", 3
MOE_PARAMS, MOE_LEAVES = 2_334_007_296, 19
# eval-loss curve, K3 + K5 vs plain attention and einsum experts, relative:
# 5x the gap measured on the card (7.30e-4, NVIDIA H100 80GB HBM3, 700 W)
MOE_CURVE_TOL = 3.7e-3
MLP_LEAVES = {  # the ClassificationTask MLP at dim 64, hidden 128, 10 classes
    "b1": (128,), "b2": (128,), "b3": (10,),
    "w1": (64, 128), "w2": (128, 128), "w3": (128, 10),
}
EXTRA_SHAPES = [(17,), (1000, 37), (3, 5, 7)]

failures: list[str] = []


def check(ok: bool, what: str) -> None:
    print(("ok   " if ok else "FAIL ") + what, flush=True)
    if not ok:
        failures.append(what)


def time_ms(fn, batches: int = 11, per_batch: int = 50, warmup: int = 10) -> float:
    """Time of one call as its caller sees it: CUDA events around each batch
    of back-to-back calls, median over the batches of the per-call mean.
    Where the host launches slower than the device runs, this is the host's
    launch cost."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per_batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_batch)
    return float(np.median(times))


def _device_events(prof) -> list:
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def profile(fn, calls: int = 1):
    """``(device_ms_per_call, wall_ms_per_call, top, device_ops_per_call)``
    over one profiled window: device time is the sum of the kernels' and
    copies' own durations on the card (one stream, so they do not overlap),
    ``top`` the five largest names.  ``None`` device time if the profiler
    saw no device activity."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    warnings.filterwarnings("ignore", message=".*Profiler clears events.*")
    fn()
    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    evs = _device_events(prof)
    if not evs:
        return None, wall, [], 0
    by_name: dict[str, float] = {}
    for e in evs:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return sum(by_name.values()), wall, top, len(evs) / calls


def bound_ms(nbytes: float, flops: float, peak: float = FP32_FLOPS) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


# ------------------------------------------------------------------ #
def _timings(kernel, plain, library=None) -> dict:
    """Per-call time (`time_ms`) and device-only time (`profile`) of a
    kernel, its plain version and, where there is one, the library call."""
    out = {}
    for key, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        if fn is None:
            out[key + "ms"], out[key + "device_ms"] = None, None
            continue
        out[key + "ms"] = time_ms(fn)
        out[key + "device_ms"] = profile(fn, calls=50)[0]
    return out


def _sum_rows(rows: list[dict]) -> dict:
    return {k: (None if any(r[k] is None for r in rows) else sum(r[k] for r in rows))
            for k in rows[0]}


def phase_kernels(dev, gen):
    from repro_torch.kernels import ref
    from repro_torch.kernels import weighted_update as wu

    rows = {}
    # K1a / K1b at every shape, fp32 and bf16
    for momentum in (0.0, 0.9):
        name = "weighted_update_momentum" if momentum else "weighted_update"
        worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
        for dtype in (torch.float32, torch.bfloat16):
            for shape in list(MLP_LEAVES.values()) + EXTRA_SHAPES:
                w = torch.randn(shape, generator=gen).to(dev, dtype)
                g = torch.randn(shape, generator=gen).to(dev, dtype)
                m = torch.randn(shape, generator=gen).to(dev) if momentum else None
                s = torch.tensor(0.37, device=dev)
                kw, km = wu.weighted_update(w, g, s, m=m, momentum=momentum)
                rw, rm = ref.weighted_update_ref(w, g, s, m=m, momentum=momentum)
                err = max_err(kw, rw)
                if momentum:
                    err = max(err, max_err(km, rm))
                worst[dtype] = max(worst[dtype], err)
        torch.cuda.synchronize()
        for dtype, err in worst.items():
            check(err <= TOL[dtype], f"{name} {str(dtype)[6:]} max_abs_err {err:.3e} <= {TOL[dtype]}")
        # timed work: one event's update on the main path, the six fp32 MLP
        # leaves (one launch each)
        per_leaf = []
        nbytes = flops = 0.0
        for shape in MLP_LEAVES.values():
            w = torch.randn(shape, generator=gen).to(dev)
            g = torch.randn(shape, generator=gen).to(dev)
            m = torch.randn(shape, generator=gen).to(dev)
            s = torch.tensor(0.37, device=dev)
            n = w.numel()
            if momentum:
                per_leaf.append(_timings(
                    lambda: wu.weighted_update(w, g, s, m=m, momentum=momentum),
                    lambda: ref.weighted_update_ref(w, g, s, m=m, momentum=momentum)))
                nbytes += 5 * 4 * n  # read w, g, m; write w', m'
                flops += 4 * n
            else:
                per_leaf.append(_timings(
                    lambda: wu.weighted_update(w, g, s),
                    lambda: ref.weighted_update_ref(w, g, s),
                    lambda: torch.addcmul(w, g, s, value=-1)))
                nbytes += 3 * 4 * n  # read w, g; write w'
                flops += 2 * n
        t = _sum_rows(per_leaf)
        b, by = bound_ms(nbytes, flops)
        rows[name] = dict(max_abs_err=max(worst.values()), bound_ms=b, bound_by=by, **t)
        print(f"     {name}, one event (6 fp32 leaves): {json.dumps(rows[name])}")

    # K2 on the blocked ring at the main path's width: (C+1, P) = (65, 26624)
    C, P = 64, 26624
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for E in (4, 8, 16):
            real = E - 2  # two padded lanes, both on the trash row C
            slots_np = np.concatenate([
                np.random.default_rng(E).choice(C, size=real, replace=False), [C, C]
            ]).astype(np.int64)
            slots = torch.as_tensor(slots_np, device=dev)
            snaps0 = torch.randn((C + 1, P), generator=gen).to(dev, dtype)
            w = torch.randn((P,), generator=gen).to(dev)
            D = (0.01 * torch.randn((E, P), generator=gen)).to(dev)
            D[real:] = 0.0
            ks, kw_ = wu.block_prefix_update(snaps0.clone(), w, D, slots)
            rs, rw_ = ref.block_prefix_update_ref(snaps0.clone(), w, D, slots)
            err = max(max_err(ks, rs), max_err(kw_, rw_))  # full ring, trash row included
            worst[dtype] = max(worst[dtype], err)
            buf = snaps0.clone()
            t = _timings(lambda: wu.block_prefix_update(buf, w, D, slots),
                         lambda: ref.block_prefix_update_ref(buf, w, D, slots))
            esz = torch.finfo(dtype).bits // 8
            distinct = len(set(slots_np.tolist()))
            # read w, D, slots; write the distinct ring rows and w'
            nbytes = 4 * P + 4 * E * P + 8 * E + distinct * P * esz + 4 * P
            b, by = bound_ms(nbytes, E * P)
            row = dict(max_abs_err=err, bound_ms=b, bound_by=by, **t)
            print(f"     block_prefix_update {str(dtype)[6:]} E={E}: {json.dumps(row)}")
            if dtype == torch.float32 and E == 8:  # the main path's ring and block
                rows["block_prefix_update"] = row
    torch.cuda.synchronize()
    for dtype, err in worst.items():
        check(err <= TOL[dtype], f"block_prefix_update {str(dtype)[6:]} max_abs_err {err:.3e} <= {TOL[dtype]}")
    rows["block_prefix_update"]["max_abs_err"] = max(worst.values())
    return rows


def _build_task(flc, dev):
    """The task, clients, p and mu exactly as `run_experiment` builds them."""
    from repro_torch.data.pipeline import FederatedClassification, make_client_speeds
    from repro_torch.fl.engine import _cached_fl_setup, sampling_for

    data = FederatedClassification(n_clients=flc.n_clients, seed=flc.seed)
    mu = make_client_speeds(flc.n_clients, flc.frac_fast, flc.speed_ratio, seed=flc.seed)
    setup = _cached_fl_setup(data, flc.seed, None, n_clients=flc.n_clients, device=dev)
    return setup, mu, sampling_for(flc, mu)


def _tree_gap(a: dict, b: dict) -> float:
    return max(max_err(a[k], b[k]) for k in a)


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _allclose_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """The least tol with |a - b| <= tol + tol * |b| everywhere (allclose
    with atol = rtol = tol)."""
    a, b = a.float(), b.float()
    return float(((a - b).abs() / (1.0 + b.abs())).max())


def _fa_pairs(S: int, T: int, window: int, q_offset: int) -> int:
    """(query, key) pairs the attention needs: the unmasked keys of each
    row, or all T keys for a row whose every key is masked (it averages v
    over all of them)."""
    qpos = np.arange(S)[:, None] + q_offset
    kpos = np.arange(T)[None, :]
    keep = kpos <= qpos
    if window:
        keep &= qpos - kpos < window
    per_row = keep.sum(axis=1)
    return int(np.where(per_row == 0, T, per_row).sum())


def phase_flash_attention(dev) -> dict:
    """K3 against its plain version over `FA_SHAPES`, fp32 and bf16, timed
    beside the plain version and `F.scaled_dot_product_attention` (causal,
    square, no window: the only shapes where one library call computes the
    same function); then its gradients through `FlashAttention`."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    gen = torch.Generator().manual_seed(0)
    out_row = None
    for dtype in (torch.float32, torch.bfloat16):
        for shape in FA_SHAPES:
            B, S, H, K, D, T, window, q_offset = shape
            q = torch.randn((B, S, H, D), generator=gen).to(dev, dtype)
            k = torch.randn((B, T, K, D), generator=gen).to(dev, dtype)
            v = torch.randn((B, T, K, D), generator=gen).to(dev, dtype)
            kw = dict(causal=True, window=window, q_offset=q_offset)
            out = fa.flash_attention_fwd(q, k, v, **kw)
            exp = ref.flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            err, close = max_err(out, exp), _allclose_err(out, exp)
            tag = f"flash_attention {str(dtype)[6:]} {shape}"
            check(close <= FA_TOL[dtype] and out.dtype == dtype,
                  f"{tag} allclose tol {close:.3e} <= {FA_TOL[dtype]} (max abs err {err:.3e})")
            library = None
            if window == 0 and q_offset == 0 and S == T:
                qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
                library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qt, kt, vt, is_causal=True, enable_gqa=True)
            esz = torch.finfo(dtype).bits // 8
            nbytes = esz * (2 * B * S * H * D + 2 * B * T * K * D)  # read q, k, v; write o
            flops = 4 * D * B * H * _fa_pairs(S, T, window, q_offset)  # QK^T and PV
            b, by = bound_ms(nbytes, flops, BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS)
            if shape == FA_PATH_SHAPE and dtype == torch.bfloat16:
                t = _timings(lambda: fa.flash_attention_fwd(q, k, v, **kw),
                             lambda: ref.flash_attention_ref(q, k, v, **kw), library)
                out_row = dict(max_abs_err=err, allclose_tol=close, bound_ms=b, bound_by=by, **t)
                row = out_row
            else:
                quick = dict(batches=5, per_batch=10, warmup=3)
                row = dict(max_abs_err=err, allclose_tol=close, bound_ms=b, bound_by=by,
                           ms=time_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw), **quick),
                           plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw), **quick),
                           library_ms=None if library is None else time_ms(library, **quick))
            print(f"     {tag}: {json.dumps(row)}")
            del q, k, v, out, exp, library
    torch.cuda.empty_cache()

    # gradients: FlashAttention (kernel forward, reference VJP) vs the
    # reference, with tests/test_lm_engine.py's linear probe loss
    for dtype in (torch.float32, torch.bfloat16):
        B, S, H, K, D, T = 2, 128, 8, 2, 64, 128
        q, k, v = (torch.randn(sh, generator=gen).to(dev, dtype)
                   for sh in ((B, S, H, D), (B, T, K, D), (B, T, K, D)))
        probe = torch.randn((B, S, H, D), generator=gen).to(dev)

        def loss(fn):
            return lambda q, k, v: torch.sum(fn(q, k, v).float() * probe)

        gk = torch.func.grad(loss(ops.flash_attention), argnums=(0, 1, 2))(q, k, v)
        gr = torch.func.grad(loss(ref.flash_attention_ref), argnums=(0, 1, 2))(q, k, v)
        close = max(_allclose_err(a, b) for a, b in zip(gk, gr))
        check(close <= FA_TOL[dtype],
              f"flash_attention grads {str(dtype)[6:]} allclose tol {close:.3e} <= {FA_TOL[dtype]}")
    return {"flash_attention": out_row}


def _ssd_inputs(dev, dtype, B, S, H, P, N, a_range, dt_range, gen):
    """(x, dt, A (H,), Bm, Cm) on the card: x, B and C normal in ``dtype``,
    dt and -A uniform over their ranges in fp32."""
    x = torch.randn((B, S, H, P), generator=gen).to(dev, dtype)
    dt = (dt_range[0] + (dt_range[1] - dt_range[0]) * torch.rand((B, S, H), generator=gen)).to(dev)
    A = -(a_range[0] + (a_range[1] - a_range[0]) * torch.rand((H,), generator=gen)).to(dev)
    Bm = torch.randn((B, S, N), generator=gen).to(dev, dtype)
    Cm = torch.randn((B, S, N), generator=gen).to(dev, dtype)
    return x, dt, A, Bm, Cm


def _ssd_cost(B: int, S: int, H: int, P: int, N: int, Q: int, esz: int) -> tuple[int, int]:
    """(bytes, operations) of one chunked SSD call: x, B, C, dt and A read
    once, y and the fp32 state written once; per chunk C B^T once per batch
    row (lower triangle), and per (row, head) the masked (Q,Q)(Q,P) product,
    C state and B^T x."""
    nc, tri = S // Q, Q * (Q + 1) // 2
    nbytes = esz * (2 * B * S * H * P + 2 * B * S * N) + 4 * (B * S * H + B * H + B * H * N * P)
    flops = 2 * B * nc * tri * N + 2 * B * H * nc * (tri * P + 2 * Q * N * P)
    return nbytes, flops


def phase_ssd_scan(dev) -> dict:
    """K4 against its plain version over `SSD_SHAPES`, fp32 and bf16, timed
    beside the plain version at the path shape (no single PyTorch call
    computes the chunked SSD); then its gradients through `SSDScan`, and one
    launch under ``vmap`` with a batched A, equal to a loop."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as k4

    gen = torch.Generator().manual_seed(1)
    out_row = None
    for dtype in (torch.float32, torch.bfloat16):
        for shape in SSD_SHAPES:
            B, S, H, P, N, chunk, a_range, dt_range = shape
            x, dt, A, Bm, Cm = _ssd_inputs(dev, dtype, *shape[:5], a_range, dt_range, gen)
            A_rows = A.expand(B, H).contiguous()
            y, st = k4.ssd_scan_fwd(x, dt, A_rows, Bm, Cm, chunk)
            ey, est = ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk)
            torch.cuda.synchronize()
            err, close = max_err(y, ey), _allclose_err(y, ey)
            smax = max(1.0, float(est.abs().max()))
            serr = max_err(st, est)
            finite = bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(st).all())
            tag = f"ssd_scan {str(dtype)[6:]} {shape[:6]} A in -{list(a_range)} dt in {list(dt_range)}"
            check(finite and close <= FA_TOL[dtype] and y.dtype == dtype
                  and serr <= SSD_STATE_TOL[dtype] * smax,
                  f"{tag}: finite {finite}, y allclose tol {close:.3e} <= {FA_TOL[dtype]} (max abs "
                  f"err {err:.3e}), state err {serr:.3e} <= {SSD_STATE_TOL[dtype]} x {smax:.3g}")
            Q = min(chunk, S)
            nbytes, flops = _ssd_cost(B, S, H, P, N, Q, torch.finfo(dtype).bits // 8)
            b, by = bound_ms(nbytes, flops, BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS)
            kernel = lambda: k4.ssd_scan_fwd(x, dt, A_rows, Bm, Cm, chunk)  # noqa: E731
            plain = lambda: ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk)  # noqa: E731
            row = dict(max_abs_err=err, allclose_tol=close, state_err=serr, bound_ms=b, bound_by=by)
            if shape == SSD_PATH_SHAPE and dtype == torch.bfloat16:
                row.update(_timings(kernel, plain))
                out_row = row
            else:
                quick = dict(batches=5, per_batch=10, warmup=3)
                row.update(ms=time_ms(kernel, **quick), plain_ms=time_ms(plain, **quick),
                           library_ms=None)
            print(f"     {tag}: {json.dumps(row)}")
            del x, dt, A, A_rows, Bm, Cm, y, st, ey, est
    torch.cuda.empty_cache()

    # gradients of all five inputs: SSDScan (kernel forward, reference VJP)
    # vs the reference, linear probe loss on both outputs
    for dtype in (torch.float32, torch.bfloat16):
        args = _ssd_inputs(dev, dtype, 2, 128, 4, 32, 16, (0.5, 2.0), (0.01, 0.2), gen)
        py = torch.randn((2, 128, 4, 32), generator=gen).to(dev)
        ps = torch.randn((2, 4, 16, 32), generator=gen).to(dev)

        def loss(fn):
            def f(*a):
                y, s = fn(*a, chunk=32)
                return torch.sum(y.float() * py) + torch.sum(s * ps)
            return f

        gk = torch.func.grad(loss(ops.ssd_scan), argnums=(0, 1, 2, 3, 4))(*args)
        gr = torch.func.grad(loss(ref.ssd_scan_ref), argnums=(0, 1, 2, 3, 4))(*args)
        close = max(_allclose_err(a, b) for a, b in zip(gk, gr))
        check(close <= FA_TOL[dtype],
              f"ssd_scan grads {str(dtype)[6:]} allclose tol {close:.3e} <= {FA_TOL[dtype]}")

    # vmap with a batched A (one per lane, as the blocked engine's snapshots
    # give): one launch over the folded lanes, equal to a loop
    x, dt, A, Bm, Cm = _ssd_inputs(dev, torch.float32, 2, 128, 24, 64, 128, (1.0, 16.0),
                                   (0.001, 0.1), gen)
    xs, Bs, Cs = (torch.stack([t, 0.5 * t, 2.0 * t, -t]) for t in (x, Bm, Cm))
    dts = torch.stack([dt, 0.5 * dt, 2.0 * dt, dt.flip(0)])
    As = torch.stack([A, 2.0 * A, 0.25 * A, A.flip(0)])
    k4.reset_launches()
    y, st = torch.func.vmap(lambda *a: ops.ssd_scan(*a, chunk=64))(xs, dts, As, Bs, Cs)
    n = k4.launches["ssd_scan"]
    close = max(_allclose_err(y[i], ref.ssd_scan_ref(xs[i], dts[i], As[i], Bs[i], Cs[i], 64)[0])
                for i in range(4))
    check(n == 1 and close <= FA_TOL[torch.float32],
          f"ssd_scan under vmap with a batched A: {n} launch(es) == 1, equal to a loop "
          f"(allclose tol {close:.3e} <= {FA_TOL[torch.float32]})")
    return {"ssd_scan": out_row}


def _gmm_inputs(dev, dtype, E, C, D, F, gen):
    """x unit normal, w normal with std 1/sqrt(D) (the experts' fan-in
    init), so y is O(1) as on the path."""
    x = torch.randn((E, C, D), generator=gen).to(dev, dtype)
    w = (torch.randn((E, D, F), generator=gen) / np.sqrt(D)).to(dev, dtype)
    return x, w


def phase_moe_gmm(dev) -> dict:
    """11. K5 against its plain version over `GMM_SHAPES` (and Arctic's shape
    in bf16), timed at the path shape beside the plain version and
    `torch.bmm` (bf16 in, fp32 accumulation, bf16 out: the same function in
    one call); its gradients through `MoeGMM`; one launch under ``vmap``;
    the CPU and dtype dispatch."""
    from repro_torch.kernels import moe_gmm as k5
    from repro_torch.kernels import ops, ref

    gen = torch.Generator().manual_seed(2)
    out_row = None
    cells = [(d, s) for d in (torch.float32, torch.bfloat16) for s in GMM_SHAPES]
    for dtype, shape in cells + [(torch.bfloat16, GMM_ARCTIC)]:
        E, C, D, F = shape
        x, w = _gmm_inputs(dev, dtype, *shape, gen)
        y = k5.moe_gmm_fwd(x, w)
        e = ref.moe_gmm_ref(x, w)
        torch.cuda.synchronize()
        err, close = max_err(y, e), _allclose_err(y, e)
        finite = bool(torch.isfinite(y.float()).all())
        tag = f"moe_gmm {str(dtype)[6:]} {shape}"
        check(finite and close <= FA_TOL[dtype] and y.dtype == dtype,
              f"{tag}: finite {finite}, allclose tol {close:.3e} <= {FA_TOL[dtype]} "
              f"(max abs err {err:.3e})")
        esz = torch.finfo(dtype).bits // 8
        nbytes = esz * (E * C * D + E * D * F + E * C * F)  # read x, w; write y
        b, by = bound_ms(nbytes, 2 * E * C * D * F,
                         BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS)
        kernel = lambda: k5.moe_gmm_fwd(x, w)  # noqa: E731
        plain = lambda: ref.moe_gmm_ref(x, w)  # noqa: E731
        library = lambda: torch.bmm(x, w)  # noqa: E731
        row = dict(max_abs_err=err, allclose_tol=close, bound_ms=b, bound_by=by)
        if shape == GMM_PATH_SHAPE and dtype == torch.bfloat16:
            row.update(_timings(kernel, plain, library))
            out_row = row
        else:
            quick = dict(batches=5, per_batch=10, warmup=3)
            row.update(ms=time_ms(kernel, **quick), plain_ms=time_ms(plain, **quick),
                       library_ms=time_ms(library, **quick))
        print(f"     {tag}: {json.dumps(row)}")
        del x, w, y, e, kernel, plain, library
    torch.cuda.empty_cache()

    # gradients of x and w: MoeGMM (kernel forward, reference VJP) vs the
    # reference, linear probe loss
    for dtype in (torch.float32, torch.bfloat16):
        x, w = _gmm_inputs(dev, dtype, *GMM_GRAD_SHAPE, gen)
        E, C, _, F = GMM_GRAD_SHAPE
        probe = torch.randn((E, C, F), generator=gen).to(dev)

        def loss(fn):
            return lambda x, w: torch.sum(fn(x, w).float() * probe)

        gk = torch.func.grad(loss(ops.moe_gmm), argnums=(0, 1))(x, w)
        gr = torch.func.grad(loss(ref.moe_gmm_ref), argnums=(0, 1))(x, w)
        close = max(_allclose_err(a, b) for a, b in zip(gk, gr))
        check(close <= FA_TOL[dtype] and all(a.dtype == dtype for a in gk),
              f"moe_gmm grads {str(dtype)[6:]} allclose tol {close:.3e} <= {FA_TOL[dtype]}")
        del x, w, gk, gr

    # vmap with x and w both mapped over 4 lanes (the blocked engine's case:
    # one set of expert weights per lane): one launch, equal to a loop
    x, w = _gmm_inputs(dev, torch.bfloat16, *GMM_GRAD_SHAPE, gen)
    xs = torch.stack([x, 0.5 * x, -x, x.flip(1)])
    ws = torch.stack([w, 2.0 * w, w.flip(0), -w])
    k5.reset_launches()
    y = torch.func.vmap(ops.moe_gmm)(xs, ws)
    n = k5.launches["moe_gmm"]
    close = max(_allclose_err(y[i], ref.moe_gmm_ref(xs[i], ws[i])) for i in range(4))
    check(n == 1 and close <= FA_TOL[torch.bfloat16],
          f"moe_gmm under vmap over 4 lanes: {n} launch(es) == 1, equal to a loop "
          f"(allclose tol {close:.3e} <= {FA_TOL[torch.bfloat16]})")
    del x, w, xs, ws, y
    # a CPU tensor takes the plain version (no launch); a dtype mismatch raises
    xc, wc = _gmm_inputs(torch.device("cpu"), torch.float32, 2, 8, 16, 4, gen)
    k5.reset_launches()
    same = torch.equal(ops.moe_gmm(xc, wc), ref.moe_gmm_ref(xc, wc))
    try:
        k5.moe_gmm_fwd(xc.to(dev), wc.to(dev, torch.bfloat16))
        raised = False
    except TypeError:
        raised = True
    check(same and k5.launches["moe_gmm"] == 0 and raised,
          f"moe_gmm dispatch: CPU tensor -> plain version {same}, no launch "
          f"({k5.launches['moe_gmm']}), dtype mismatch raises {raised}")
    torch.cuda.empty_cache()
    return {"moe_gmm": out_row}


def phase_mlp(dev, launches: dict) -> None:
    """Phases 3-6 (the MLP slice) and its profile; adds the kernel paths'
    launch counts to ``launches`` under "mlp"."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.async_sgd import ServerConfig, run_generalized_async_sgd
    from repro_torch.core.engine_scan import blocked_inputs, step_scales
    from repro_torch.core.queue_sim import EventBlocks, SimConfig, export_stream
    from repro_torch.fl.engine import run_experiment
    from repro_torch.kernels import weighted_update as wu

    # 3. the paper's experiment, plain (jnp-equivalent) update path
    flc = FLConfig(n_clients=256, concurrency=64, server_steps=2000, engine="scan",
                   device=dev.type)
    r, wall = _timed(lambda: run_experiment(flc, "gen_async", eval_every=500))
    acc = np.asarray(r.eval_acc, np.float64)
    print(f"run_experiment n=256 C=64 T=2000: {wall:.3f} s, {flc.server_steps / wall:.1f} events/s, "
          f"eval steps {r.eval_steps.tolist()} acc {acc.tolist()}")
    check(acc.shape == (4,) and bool(np.all(np.isfinite(acc))), "eval accuracies finite, 4 points")
    check(bool(acc[-1] > acc[0]), f"accuracy rises: {acc[0]:.4f} -> {acc[-1]:.4f}")
    check(all(bool(torch.isfinite(v).all()) for v in r.final_params.values()), "final params finite")

    # 4./5. the kernel path, built as run_experiment builds it
    (setup, mu, p), wall = _timed(lambda: _build_task(flc, dev))
    print(f"task setup (data shards, sampling p, MLP, clients): {wall:.3f} s")
    base = ServerConfig(n=flc.n_clients, C=flc.concurrency, T=flc.server_steps, eta=0.05,
                        mu=mu, p=p, seed=flc.seed, eval_every=500, engine="scan",
                        weighting="importance", device=dev.type)
    run = lambda cfg: run_generalized_async_sgd(setup.params, setup.clients, cfg,  # noqa: E731
                                                eval_fn=setup.eval_fn)
    mlp = launches.setdefault("mlp", {})

    wu.reset_launches()
    (w_pe, tr_pe), wall = _timed(lambda: run(replace(base, update="pallas", block_size=1)))
    mlp["weighted_update"] = wu.launches["weighted_update"]
    print(f"per-event pallas: {wall:.3f} s ({flc.server_steps / wall:.1f} events/s), "
          f"launches {dict(wu.launches)}, acc {tr_pe.eval_values}")
    check(wu.launches["weighted_update"] == flc.server_steps * 6,
          f"K1 launches {wu.launches['weighted_update']} == T*6 = {flc.server_steps * 6}")
    (w_pe_j, _), wall = _timed(lambda: run(replace(base, update="jnp", block_size=1)))
    print(f"per-event jnp: {wall:.3f} s ({flc.server_steps / wall:.1f} events/s)")
    gap = _tree_gap(w_pe, w_pe_j)
    check(gap <= 1e-5, f"per-event pallas vs jnp max gap {gap:.3e} <= 1e-5")

    E = 8
    stream = export_stream(SimConfig(mu=mu, p=p, C=base.C, T=base.T, seed=base.seed))
    blocks = EventBlocks.from_stream(stream, E, cut_every=base.eval_every)
    # one launch per row of the blocked layout: the conflict-free blocks plus
    # the all-masked rows that pad each eval interval to a common width
    n_blocks = blocked_inputs(blocks, step_scales(stream, base.eta, p, "importance"),
                              base.eval_every)[0].shape[0]
    print(f"blocked layout E={E}: {blocks.B} conflict-free blocks, {n_blocks} rows")
    wu.reset_launches()
    (w_bl, tr_bl), wall = _timed(lambda: run(replace(base, update="pallas", block_size=E)))
    mlp["block_prefix_update"] = wu.launches["block_prefix_update"]
    print(f"blocked E={E} pallas: {wall:.3f} s ({flc.server_steps / wall:.1f} events/s), "
          f"launches {dict(wu.launches)}, acc {tr_bl.eval_values}")
    check(wu.launches["block_prefix_update"] == n_blocks,
          f"K2 launches {wu.launches['block_prefix_update']} == block count {n_blocks}")
    (w_bl_j, _), wall = _timed(lambda: run(replace(base, update="jnp", block_size=E)))
    print(f"blocked E={E} jnp: {wall:.3f} s ({flc.server_steps / wall:.1f} events/s)")
    gap = _tree_gap(w_bl, w_bl_j)
    check(gap <= 1e-5, f"blocked pallas vs jnp max gap {gap:.3e} <= 1e-5")
    # blocked and per-event replay re-associate the fp32 update sums; after a
    # few hundred events a ReLU kink turns that rounding into a ~1e-3 weight
    # gap, in the JAX package as in the port, so the weights are held to
    # 1e-4 over the first 200 events and the T=2000 curves to 10 of 2048
    # eval samples
    dacc = float(np.max(np.abs(np.subtract(tr_bl.eval_values, tr_pe.eval_values))))
    check(dacc <= 10 / 2048, f"blocked vs per-event eval accuracy gap {dacc:.5f} <= 10/2048")
    small = replace(base, T=200, eval_every=0)
    (w_pe_s, _), (w_bl_s, _) = run(small), run(replace(small, update="pallas", block_size=E))
    gap = _tree_gap(w_bl_s, w_pe_s)
    check(gap <= 1e-4, f"blocked vs per-event (T=200) max gap {gap:.3e} <= 1e-4")

    # 6. replay engine vs the port's per-event Python oracle, full width
    w_py, _ = run_generalized_async_sgd(setup.params, setup.clients,
                                        replace(small, engine="python"))
    gap = _tree_gap(w_pe_s, w_py)
    check(gap <= 1e-5, f"scan vs python oracle (T=200) max gap {gap:.3e} <= 1e-5")

    # where the time goes on the kernel path (under the profiler)
    for label, cfg, T in (("per-event", replace(small, update="pallas"), 200),
                          ("blocked E=8", replace(small, update="pallas", block_size=E, T=400), 400)):
        _print_profile(f"MLP {label} T={T}", lambda: run(cfg), T)


def _print_profile(label: str, fn, events: int) -> None:
    dms, wms, top, ops = profile(fn)
    idle = None if dms is None else 1.0 - dms / wms
    print(f"profile {label}: wall {wms / events:.4f} ms/event, device busy "
          f"{None if dms is None else round(dms / events, 6)} ms/event, idle share {idle}, "
          f"{ops / events:.1f} device ops/event")
    for k, v in top:
        print(f"     {v / events:.6f} ms/event  {k[:110]}")


def _lm_batch(cfg, B: int, S: int, seed: int, dev) -> dict:
    from repro_torch.data.pipeline import SyntheticLMStream

    b = SyntheticLMStream(cfg.vocab_size, S, seed=seed).batch(B)
    return {k: torch.as_tensor(v, dtype=torch.int64, device=dev) for k, v in b.items()}


def phase_grad_check(dev, arch: str, num_layers: int | None = None) -> None:
    """7. / 9. / 12. One loss and gradient of a full-width config in fp32
    with the kernels (``use_pallas=True``) and with the plain versions, on
    the same weights and batch; one K3 launch per attention block, one K4
    launch per Mamba2 layer and three K5 launches per MoE layer (the sort
    dispatch) per forward.  ``num_layers`` cuts the depth; an MoE config
    also gives the loss of the einsum dispatch (no K5) on the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as k5
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.models import api, hybrid
    from repro_torch.models.module import init_params
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch).replace(dtype="float32")
    if num_layers is not None:
        cfg = cfg.replace(num_layers=num_layers)
    moe = cfg.family == "moe"
    if moe:
        cfg = cfg.replace(moe_dispatch="sort")
    ssm = cfg.family in ("ssm", "hybrid")
    attention = (0 if cfg.family == "ssm" else
                 hybrid.num_shared_sites(cfg) if cfg.family == "hybrid" else cfg.num_layers)
    want = {"flash_attention": attention, "ssd_scan": cfg.num_layers if ssm else 0,
            "moe_gmm": 3 * cfg.num_layers if moe else 0}
    params = init_params(api.model_meta(cfg), 0, dev)
    batch = _lm_batch(cfg, 2, LM_SEQ, 1, dev)
    res = {}
    for use_pallas in (True, False):
        c = cfg.replace(use_pallas=use_pallas)
        for mod in (fa, k4, k5):
            mod.reset_launches()
        res[use_pallas], wall = _timed(lambda: torch.func.grad_and_value(
            lambda p: api.loss_fn(p, batch, c)[0])(params))
        got = {"flash_attention": fa.launches["flash_attention"], "ssd_scan": k4.launches["ssd_scan"],
               "moe_gmm": k5.launches["moe_gmm"]}
        print(f"{arch} ({cfg.num_layers} layers) fp32 full-width loss+grad, use_pallas={use_pallas}: "
              f"{wall:.3f} s, loss {float(res[use_pallas][1]):.7f}, launches {got}")
        if use_pallas:
            check(got == want, f"{arch} launches per forward {got} == {want}")
    (gk, lk), (gp, lp) = res[True], res[False]
    rel = abs(float(lk) - float(lp)) / abs(float(lp))
    check(rel <= 1e-5, f"{arch} fp32 full-width loss, kernel vs plain: relative gap {rel:.3e} <= 1e-5")
    if moe:
        with torch.no_grad():
            le = api.loss_fn(params, batch, cfg.replace(moe_dispatch="einsum"))[0]
        rel = abs(float(le) - float(lp)) / abs(float(lp))
        check(rel <= 1e-5, f"{arch} fp32 full-width loss, einsum vs sort dispatch: relative gap "
              f"{rel:.3e} <= 1e-5 (einsum {float(le):.7f})")
    gmax = max(float(g.abs().max()) for g in tree_leaves(gp))
    gap = max(max_err(a, b) for a, b in zip(tree_leaves(gk), tree_leaves(gp)))
    per_leaf = max(max_err(a, b) / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(tree_leaves(gk), tree_leaves(gp)))
    check(gap <= 1e-4 * gmax, f"{arch} fp32 full-width grads, kernel vs plain: max gap {gap:.3e} <= "
          f"1e-4 * max|g| = {1e-4 * gmax:.3e} (worst leaf, relative to its own max: {per_leaf:.3e})")
    del params, res, gk, gp
    torch.cuda.empty_cache()


def phase_lm(dev, launches: dict) -> None:
    """8. The LM slice at full width (see the module docstring); adds the
    kernel launches of its two runs to ``launches`` under "lm"."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.async_sgd import ServerConfig, run_generalized_async_sgd
    from repro_torch.data.pipeline import make_client_speeds
    from repro_torch.fl.engine import LMTask, _cached_fl_setup, run_experiment, sampling_for
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import weighted_update as wu
    from repro_torch.models import api
    from repro_torch.models.module import param_count

    cfg = get_config(LM_ARCH).replace(use_pallas=True)
    n_params = param_count(api.model_meta(cfg))
    check(n_params == LM_PARAMS, f"{LM_ARCH} parameters {n_params:,} == {LM_PARAMS:,}")
    flc = FLConfig(n_clients=LM_N, concurrency=LM_C, server_steps=LM_T, sampling="optimal",
                   speed_ratio=10.0, engine="scan", device=dev.type)
    forwards = _forwards(LM_T, LM_EVAL)
    tokens = LM_T * LM_BATCH * LM_SEQ
    lm = launches.setdefault("lm", {"weighted_update": 0, "flash_attention": 0})

    def experiment(use_pallas: bool):
        task = LMTask(cfg.replace(use_pallas=use_pallas), batch_size=LM_BATCH,
                      seq_len=LM_SEQ, shard_size=LM_SHARD)
        r, wall = _timed(lambda: run_experiment(flc, "gen_async", eval_every=LM_EVAL, task=task))
        curve = np.asarray(r.eval_acc, np.float64)
        print(f"LM run_experiment {LM_ARCH} use_pallas={use_pallas} n={LM_N} C={LM_C} "
              f"T={LM_T}: {wall:.3f} s, {LM_T / wall:.3f} events/s, {tokens / wall:.1f} tokens/s, "
              f"eval steps {r.eval_steps.tolist()} loss {curve.tolist()}")
        return task, curve

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    wu.reset_launches()
    task, curve = experiment(True)
    lm["flash_attention"] += fa.launches["flash_attention"]
    peak = torch.cuda.max_memory_allocated()
    print(f"LM peak device memory (run_experiment): {peak / 2**30:.3f} GiB")
    check(curve.shape == (LM_T // LM_EVAL,) and bool(np.all(np.isfinite(curve))),
          f"LM eval losses finite, {LM_T // LM_EVAL} points")
    check(bool(curve[-1] < curve[0]), f"LM eval loss falls: {curve[0]:.5f} -> {curve[-1]:.5f}")
    check(fa.launches["flash_attention"] == cfg.num_layers * forwards,
          f"K3 launches {fa.launches['flash_attention']} == {cfg.num_layers} x {forwards} forwards")

    # the same task with the per-leaf K1 update
    setup = _cached_fl_setup(None, flc.seed, task, n_clients=LM_N, device=dev)
    mu = make_client_speeds(LM_N, flc.frac_fast, flc.speed_ratio, seed=flc.seed)
    base = ServerConfig(n=LM_N, C=LM_C, T=LM_T, eta=0.05, mu=mu, p=sampling_for(flc, mu),
                        seed=flc.seed, eval_every=LM_EVAL, engine="scan",
                        weighting="importance", update="pallas", device=dev.type)
    run = lambda c: run_generalized_async_sgd(setup.params, setup.clients, c,  # noqa: E731
                                              eval_fn=setup.eval_fn)
    fa.reset_launches()
    wu.reset_launches()
    (w, tr), wall = _timed(lambda: run(base))
    lm["flash_attention"] += fa.launches["flash_attention"]
    lm["weighted_update"] += wu.launches["weighted_update"]
    del w
    print(f"LM update=pallas: {wall:.3f} s, {LM_T / wall:.3f} events/s, {tokens / wall:.1f} "
          f"tokens/s, launches K1 {wu.launches['weighted_update']} K3 "
          f"{fa.launches['flash_attention']}, loss {tr.eval_values}")
    check(wu.launches["weighted_update"] == LM_T * LM_LEAVES,
          f"K1 launches {wu.launches['weighted_update']} == {LM_T} x {LM_LEAVES} leaves")
    check(fa.launches["flash_attention"] == cfg.num_layers * forwards,
          f"K3 launches {fa.launches['flash_attention']} == {cfg.num_layers} x {forwards} forwards")
    gap = float(np.max(np.abs(np.asarray(tr.eval_values) - curve) / np.abs(curve)))
    check(gap <= 1e-3, f"LM eval curve, update=pallas vs jnp: relative gap {gap:.3e} <= 1e-3")
    peak = torch.cuda.max_memory_allocated()
    st = torch.cuda.memory_stats()
    print(f"LM peak device memory (both runs): {peak / 2**30:.3f} GiB; allocator: "
          + ", ".join(f"{k} {st[k]}" for k in ("num_alloc_retries", "num_device_alloc",
                                                "num_device_free") if k in st))

    # where the time goes: a few events of the kernel path under the profiler
    few = 8
    _print_profile(f"LM update=pallas, use_pallas=True, T={few} (incl. ring set-up)",
                   lambda: run(replace(base, T=few, eval_every=0)), few)
    del setup, run
    task.__dict__.pop("_fl_setup_cache")
    torch.cuda.empty_cache()

    # the same run with the plain attention
    _, curve0 = experiment(False)
    gap = float(np.max(np.abs(curve - curve0) / np.abs(curve0)))
    check(gap <= LM_CURVE_TOL,
          f"LM eval curve, K3 vs plain attention: relative gap {gap:.3e} <= {LM_CURVE_TOL}")


def _forwards(T: int, every: int) -> int:
    """Forward passes of a per-event run: one per gradient, one per eval."""
    return T + T // every


def phase_mamba(dev, launches: dict) -> None:
    """10. The Mamba2 LM slice at full width and depth (see the module
    docstring); adds the kernel launches of its three kernel runs to
    ``launches`` under "mamba2"."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.async_sgd import ServerConfig, run_generalized_async_sgd
    from repro_torch.core.engine_scan import blocked_inputs, step_scales
    from repro_torch.core.queue_sim import EventBlocks, SimConfig, export_stream
    from repro_torch.data.pipeline import make_client_speeds
    from repro_torch.fl.engine import LMTask, _cached_fl_setup, run_experiment, sampling_for
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.kernels import weighted_update as wu
    from repro_torch.models import api
    from repro_torch.models.module import param_count

    cfg = get_config(MAMBA_ARCH).replace(use_pallas=True)
    n_params = param_count(api.model_meta(cfg))
    check(n_params == MAMBA_PARAMS, f"{MAMBA_ARCH} parameters {n_params:,} == {MAMBA_PARAMS:,}")
    nL = cfg.num_layers
    flc = FLConfig(n_clients=LM_N, concurrency=MAMBA_C, server_steps=LM_T, sampling="optimal",
                   speed_ratio=10.0, engine="scan", device=dev.type)
    forwards = _forwards(LM_T, LM_EVAL)
    tokens = LM_T * LM_BATCH * LM_SEQ
    path = launches.setdefault("mamba2", {"weighted_update": 0, "block_prefix_update": 0,
                                          "ssd_scan": 0})

    def task_for(use_pallas: bool):
        return LMTask(cfg.replace(use_pallas=use_pallas), batch_size=LM_BATCH, seq_len=LM_SEQ,
                      shard_size=LM_SHARD)

    def experiment(task, label: str):
        r, wall = _timed(lambda: run_experiment(flc, "gen_async", eval_every=LM_EVAL, task=task))
        curve = np.asarray(r.eval_acc, np.float64)
        print(f"Mamba2 run_experiment ({label}) n={LM_N} C={MAMBA_C} T={LM_T}: {wall:.3f} s, "
              f"{LM_T / wall:.3f} events/s, {tokens / wall:.1f} tokens/s, "
              f"eval steps {r.eval_steps.tolist()} loss {curve.tolist()}")
        return curve

    def curve_gap(a, b) -> float:
        return float(np.max(np.abs(np.asarray(a) - b) / np.abs(b)))

    # 1. run_experiment with K4, the plain update
    torch.cuda.reset_peak_memory_stats()
    task = task_for(True)
    k4.reset_launches()
    curve = experiment(task, "K4")
    path["ssd_scan"] += k4.launches["ssd_scan"]
    print(f"Mamba2 peak device memory (run_experiment): "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    check(curve.shape == (LM_T // LM_EVAL,) and bool(np.all(np.isfinite(curve))),
          f"Mamba2 eval losses finite, {LM_T // LM_EVAL} points")
    check(bool(curve[-1] < curve[0]), f"Mamba2 eval loss falls: {curve[0]:.5f} -> {curve[-1]:.5f}")
    check(k4.launches["ssd_scan"] == nL * forwards,
          f"K4 launches {k4.launches['ssd_scan']} == {nL} x {forwards} forwards")

    # 2. the same task with the per-leaf K1 update; 3. blocked with K2
    setup = _cached_fl_setup(None, flc.seed, task, n_clients=LM_N, device=dev)
    mu = make_client_speeds(LM_N, flc.frac_fast, flc.speed_ratio, seed=flc.seed)
    p = sampling_for(flc, mu)
    base = ServerConfig(n=LM_N, C=MAMBA_C, T=LM_T, eta=0.05, mu=mu, p=p, seed=flc.seed,
                        eval_every=LM_EVAL, engine="scan", weighting="importance",
                        update="pallas", device=dev.type)
    run = lambda c: run_generalized_async_sgd(setup.params, setup.clients, c,  # noqa: E731
                                              eval_fn=setup.eval_fn)
    wu.reset_launches()
    k4.reset_launches()
    (w, tr), wall = _timed(lambda: run(base))
    path["weighted_update"] += wu.launches["weighted_update"]
    path["ssd_scan"] += k4.launches["ssd_scan"]
    del w
    print(f"Mamba2 update=pallas: {wall:.3f} s, {LM_T / wall:.3f} events/s, "
          f"{tokens / wall:.1f} tokens/s, launches K1 {wu.launches['weighted_update']} "
          f"K4 {k4.launches['ssd_scan']}, loss {tr.eval_values}")
    check(wu.launches["weighted_update"] == LM_T * MAMBA_LEAVES,
          f"K1 launches {wu.launches['weighted_update']} == {LM_T} x {MAMBA_LEAVES} leaves")
    check(k4.launches["ssd_scan"] == nL * forwards,
          f"K4 launches {k4.launches['ssd_scan']} == {nL} x {forwards} forwards")
    gap = curve_gap(tr.eval_values, curve)
    tol = MAMBA_CURVE_TOL["pallas_update"]
    check(gap <= tol, f"Mamba2 eval curve, update=pallas (bf16 leaves) vs the fp32 flat "
          f"update: relative gap {gap:.3e} <= {tol}")

    stream = export_stream(SimConfig(mu=mu, p=p, C=MAMBA_C, T=LM_T, seed=flc.seed))
    rows = blocked_inputs(EventBlocks.from_stream(stream, MAMBA_E, cut_every=LM_EVAL),
                          step_scales(stream, base.eta, p, "importance"), LM_EVAL)[0].shape[0]
    evals = LM_T // LM_EVAL
    blocked = replace(base, block_size=MAMBA_E)
    wu.reset_launches()
    k4.reset_launches()
    (w, tr_b), wall = _timed(lambda: run(blocked))
    path["block_prefix_update"] += wu.launches["block_prefix_update"]
    path["ssd_scan"] += k4.launches["ssd_scan"]
    del w
    print(f"Mamba2 blocked E={MAMBA_E} update=pallas: {rows} block rows, {wall:.3f} s, "
          f"{LM_T / wall:.3f} events/s, {tokens / wall:.1f} tokens/s, launches K2 "
          f"{wu.launches['block_prefix_update']} K4 {k4.launches['ssd_scan']}, "
          f"loss {tr_b.eval_values}")
    check(wu.launches["block_prefix_update"] == rows,
          f"K2 launches {wu.launches['block_prefix_update']} == block rows {rows}")
    check(k4.launches["ssd_scan"] == nL * (rows + evals),
          f"K4 launches {k4.launches['ssd_scan']} == {nL} x ({rows} block rows + {evals} evals)")
    gap = curve_gap(tr_b.eval_values, curve)
    tol = MAMBA_CURVE_TOL["blocked"]
    check(gap <= tol, f"Mamba2 eval curve, blocked vs per-event: relative gap {gap:.3e} <= {tol}")
    peak = torch.cuda.max_memory_allocated()
    print(f"Mamba2 peak device memory (three kernel runs): {peak / 2**30:.3f} GiB")

    # where the time goes: a few events of each kernel path under the profiler
    few = 8
    _print_profile(f"Mamba2 update=pallas, use_pallas=True, T={few} (incl. ring set-up)",
                   lambda: run(replace(base, T=few, eval_every=0)), few)
    _print_profile(f"Mamba2 blocked E={MAMBA_E}, update=pallas, use_pallas=True, T={2 * few} "
                   "(incl. ring set-up)",
                   lambda: run(replace(blocked, T=2 * few, eval_every=0)), 2 * few)
    del setup, run
    task.__dict__.pop("_fl_setup_cache")
    torch.cuda.empty_cache()

    # 4. the same run with the plain SSD
    curve0 = experiment(task_for(False), "plain SSD")
    gap = curve_gap(curve, curve0)
    tol = MAMBA_CURVE_TOL["plain_ssd"]
    check(gap <= tol, f"Mamba2 eval curve, K4 vs plain SSD: relative gap {gap:.3e} <= {tol}")


def phase_moe_lm(dev, launches: dict) -> None:
    """13. The Qwen1.5-MoE LM slice at full width (see the module
    docstring); adds the kernel launches of its two kernel runs to
    ``launches`` under "qwen_moe"."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.async_sgd import ServerConfig, run_generalized_async_sgd
    from repro_torch.data.pipeline import make_client_speeds
    from repro_torch.fl.engine import LMTask, _cached_fl_setup, run_experiment, sampling_for
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as k5
    from repro_torch.kernels import weighted_update as wu
    from repro_torch.models import api
    from repro_torch.models.module import param_count

    cfg = get_config(MOE_ARCH).replace(num_layers=MOE_LAYERS, use_pallas=True,
                                       moe_dispatch="sort")
    n_params = param_count(api.model_meta(cfg))
    check(n_params == MOE_PARAMS,
          f"{MOE_ARCH} ({MOE_LAYERS} layers) parameters {n_params:,} == {MOE_PARAMS:,}")
    nL = cfg.num_layers
    flc = FLConfig(n_clients=LM_N, concurrency=LM_C, server_steps=LM_T, sampling="optimal",
                   speed_ratio=10.0, engine="scan", device=dev.type)
    forwards = _forwards(LM_T, LM_EVAL)
    tokens = LM_T * LM_BATCH * LM_SEQ
    path = launches.setdefault("qwen_moe", {"weighted_update": 0, "flash_attention": 0,
                                            "moe_gmm": 0})

    def experiment(use_pallas: bool):
        task = LMTask(cfg.replace(use_pallas=use_pallas), batch_size=LM_BATCH,
                      seq_len=LM_SEQ, shard_size=LM_SHARD)
        r, wall = _timed(lambda: run_experiment(flc, "gen_async", eval_every=LM_EVAL, task=task))
        curve = np.asarray(r.eval_acc, np.float64)
        print(f"Qwen-MoE run_experiment use_pallas={use_pallas} n={LM_N} C={LM_C} T={LM_T}: "
              f"{wall:.3f} s, {LM_T / wall:.3f} events/s, {tokens / wall:.1f} tokens/s, "
              f"eval steps {r.eval_steps.tolist()} loss {curve.tolist()}")
        return task, curve

    def counts_ok(label: str) -> None:
        check(k5.launches["moe_gmm"] == 3 * nL * forwards,
              f"Qwen-MoE {label}: K5 launches {k5.launches['moe_gmm']} == 3 x {nL} x "
              f"{forwards} forwards")
        check(fa.launches["flash_attention"] == nL * forwards,
              f"Qwen-MoE {label}: K3 launches {fa.launches['flash_attention']} == {nL} x "
              f"{forwards} forwards")

    # 1. run_experiment with K3 and K5, the plain update
    torch.cuda.reset_peak_memory_stats()
    for mod in (fa, k5, wu):
        mod.reset_launches()
    task, curve = experiment(True)
    path["flash_attention"] += fa.launches["flash_attention"]
    path["moe_gmm"] += k5.launches["moe_gmm"]
    print(f"Qwen-MoE peak device memory (run_experiment): "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    check(curve.shape == (LM_T // LM_EVAL,) and bool(np.all(np.isfinite(curve))),
          f"Qwen-MoE eval losses finite, {LM_T // LM_EVAL} points")
    check(bool(curve[-1] < curve[0]), f"Qwen-MoE eval loss falls: {curve[0]:.5f} -> {curve[-1]:.5f}")
    counts_ok("run_experiment")

    # 2. the same task with the per-leaf K1 update
    setup = _cached_fl_setup(None, flc.seed, task, n_clients=LM_N, device=dev)
    mu = make_client_speeds(LM_N, flc.frac_fast, flc.speed_ratio, seed=flc.seed)
    base = ServerConfig(n=LM_N, C=LM_C, T=LM_T, eta=0.05, mu=mu, p=sampling_for(flc, mu),
                        seed=flc.seed, eval_every=LM_EVAL, engine="scan",
                        weighting="importance", update="pallas", device=dev.type)
    run = lambda c: run_generalized_async_sgd(setup.params, setup.clients, c,  # noqa: E731
                                              eval_fn=setup.eval_fn)
    for mod in (fa, k5, wu):
        mod.reset_launches()
    (w, tr), wall = _timed(lambda: run(base))
    path["weighted_update"] += wu.launches["weighted_update"]
    path["flash_attention"] += fa.launches["flash_attention"]
    path["moe_gmm"] += k5.launches["moe_gmm"]
    del w
    print(f"Qwen-MoE update=pallas: {wall:.3f} s, {LM_T / wall:.3f} events/s, "
          f"{tokens / wall:.1f} tokens/s, launches K1 {wu.launches['weighted_update']} K3 "
          f"{fa.launches['flash_attention']} K5 {k5.launches['moe_gmm']}, loss {tr.eval_values}")
    check(wu.launches["weighted_update"] == LM_T * MOE_LEAVES,
          f"Qwen-MoE K1 launches {wu.launches['weighted_update']} == {LM_T} x {MOE_LEAVES} leaves")
    counts_ok("update=pallas")
    gap = float(np.max(np.abs(np.asarray(tr.eval_values) - curve) / np.abs(curve)))
    check(gap <= 1e-3, f"Qwen-MoE eval curve, update=pallas vs the flat update: relative gap "
          f"{gap:.3e} <= 1e-3")
    peak = torch.cuda.max_memory_allocated()
    print(f"Qwen-MoE peak device memory (both kernel runs): {peak / 2**30:.3f} GiB")
    check(peak < 80e9, f"Qwen-MoE peak device memory {peak / 1e9:.3f} GB < 80 GB")

    # where the time goes: a few events of the kernel path under the profiler
    few = 8
    _print_profile(f"Qwen-MoE update=pallas, use_pallas=True, T={few} (incl. ring set-up)",
                   lambda: run(replace(base, T=few, eval_every=0)), few)
    del setup, run
    task.__dict__.pop("_fl_setup_cache")
    torch.cuda.empty_cache()

    # 3. plain attention and bf16 einsum experts on the same sort dispatch
    _, curve0 = experiment(False)
    gap = float(np.max(np.abs(curve - curve0) / np.abs(curve0)))
    check(gap <= MOE_CURVE_TOL, f"Qwen-MoE eval curve, K3 + K5 vs plain: relative gap "
          f"{gap:.3e} <= {MOE_CURVE_TOL}")
    torch.cuda.empty_cache()


def main() -> int:
    t_start = time.perf_counter()

    def done(phases: str) -> None:
        print(f"phases {phases} done at {time.perf_counter() - t_start:.1f} s", flush=True)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {smi}")

    # 1. build every kernel source of the checkout, one nvcc each, in parallel
    t0 = time.perf_counter()
    srcs = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    with ThreadPoolExecutor(len(srcs)) as pool:
        list(pool.map(lambda name: build.build(name, verbose=True), srcs))
    for name in srcs:
        build.load(name)
    print(f"build: {srcs} in {time.perf_counter() - t0:.2f} s")
    done("1")

    # 2. kernels against their plain versions
    gen = torch.Generator().manual_seed(0)
    rows = phase_kernels(dev, gen)
    rows.update(phase_flash_attention(dev))
    rows.update(phase_ssd_scan(dev))
    rows.update(phase_moe_gmm(dev))
    done("2, 11")

    # 3.-8. the MLP and dense LM slices, each kernel path's launches counted per path
    launches: dict = {}
    phase_mlp(dev, launches)
    done("3-6")
    torch.cuda.empty_cache()
    phase_grad_check(dev, LM_ARCH)
    phase_lm(dev, launches)
    done("7-8")
    torch.cuda.empty_cache()
    # 9.-10. the SSM and hybrid slice
    phase_grad_check(dev, MAMBA_ARCH)
    phase_grad_check(dev, "zamba2-2.7b")
    phase_mamba(dev, launches)
    done("9-10")
    torch.cuda.empty_cache()
    # 12.-13. the MoE slice
    phase_grad_check(dev, MOE_ARCH, num_layers=MOE_LAYERS)
    phase_moe_lm(dev, launches)
    done("12-13")

    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}", file=sys.stderr)
        return 1
    csrc = "src/repro_torch/kernels/csrc/"
    meta = {
        "weighted_update": ("weighted_update.cu", "src/repro/kernels/weighted_update.py:112"),
        "weighted_update_momentum": ("weighted_update.cu", "src/repro/kernels/weighted_update.py:96"),
        "block_prefix_update": ("weighted_update.cu", "src/repro/kernels/weighted_update.py:166"),
        "flash_attention": ("flash_attention.cu", "src/repro/kernels/flash_attention.py:103"),
        "ssd_scan": ("ssd_scan.cu", "src/repro/kernels/ssd_scan.py:85"),
        "moe_gmm": ("moe_gmm.cu", "src/repro/kernels/moe_gmm.py:54"),
    }
    kernels = []
    for name, row in rows.items():
        by_path = {path: c[name] for path, c in launches.items() if name in c}
        kernels.append(dict(name=name, route="cuda", source=csrc + meta[name][0],
                            replaces=meta[name][1], launches=sum(by_path.values()),
                            launches_by_path=by_path, **row))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
