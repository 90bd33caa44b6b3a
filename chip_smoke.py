#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one card.

    python3 chip_smoke.py

Phases, each a hard check (any failure exits non-zero and prints no result):

1. the card (``nvidia-smi`` name and power limit) and the nvcc build of
   every kernel source, from this checkout;
2. every hand-written kernel held against its plain PyTorch version on the
   card (max abs error; fp32 <= 1e-5, bf16 <= 2e-2, the JAX package's kernel
   tolerances), timed with CUDA events (median of 100 launches after
   warm-up) beside its plain version, the one PyTorch call computing the
   same function where there is one, and its bound: the larger of bytes
   moved / 3.35 TB/s and operations / 67 TFLOP/s (fp32, no tensor cores);
3. the paper's experiment, the plain path: ``run_experiment(FLConfig(
   n_clients=256, concurrency=64, server_steps=2000, engine="scan"),
   "gen_async", eval_every=500)`` with the full-width `ClassificationTask`
   MLP (hidden 128, batch 128, shard 1024);
4. the per-event kernel path (``update="pallas"``, block_size=1): K1
   launches == T x 6, weights within 1e-5 of ``update="jnp"``;
5. the blocked kernel path (``block_size=8, update="pallas"``): K2 launches
   == block count, weights within 1e-5 of ``update="jnp"``; against the
   per-event run, eval accuracies within 10/2048 at T=2000 and weights
   within 1e-4 at T=200;
6. the replay engine against the port's own per-event Python oracle at full
   width and T=200 (<= 1e-5).

Phases 4 and 5 are the slice's kernel path: each launch count is zeroed
just before the run and read just after.  fp32 matmuls run in full fp32
(TF32 off for matmul and cuDNN).  The line before the last is the
``kernels`` JSON object; the last line is the result object.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
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
    """``(device_ms_per_call, wall_ms_per_call, top)`` over one profiled
    window: device time is the sum of the kernels' and copies' own
    durations on the card (one stream, so they do not overlap), ``top`` the
    five largest names.  ``None`` device time if the profiler saw no device
    activity."""
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
        return None, wall, []
    by_name: dict[str, float] = {}
    for e in evs:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return sum(by_name.values()), wall, top


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU",
              file=sys.stderr)
        return 2
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.async_sgd import ServerConfig, run_generalized_async_sgd
    from repro_torch.core.engine_scan import blocked_inputs, step_scales
    from repro_torch.core.queue_sim import EventBlocks, SimConfig, export_stream
    from repro_torch.fl.engine import run_experiment
    from repro_torch.kernels import build
    from repro_torch.kernels import weighted_update as wu

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {smi}")

    # 1. build every kernel source of the checkout
    t0 = time.perf_counter()
    srcs = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    for name in srcs:
        build.build(name, verbose=True)
        build.load(name)
    print(f"build: {srcs} in {time.perf_counter() - t0:.2f} s")

    # 2. kernels against their plain versions
    gen = torch.Generator().manual_seed(0)
    rows = phase_kernels(dev, gen)

    # 3. the paper's experiment, plain (jnp-equivalent) update path
    flc = FLConfig(n_clients=256, concurrency=64, server_steps=2000, engine="scan",
                   device="cuda")
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
                        weighting="importance", device="cuda")
    run = lambda cfg: run_generalized_async_sgd(setup.params, setup.clients, cfg,
                                                eval_fn=setup.eval_fn)
    launches = {}

    wu.reset_launches()
    (w_pe, tr_pe), wall = _timed(lambda: run(replace(base, update="pallas", block_size=1)))
    launches.update(wu.launches)
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
    launches["block_prefix_update"] = wu.launches["block_prefix_update"]
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

    # 7. where the time goes on the kernel path (under the profiler)
    for label, cfg, T in (("per-event", replace(small, update="pallas"), 200),
                          ("blocked E=8", replace(small, update="pallas", block_size=E, T=400), 400)):
        dms, wms, top = profile(lambda: run(cfg))
        idle = None if dms is None else 1.0 - dms / wms
        print(f"profile {label} T={T}: wall {wms / T:.4f} ms/event, device busy "
              f"{None if dms is None else round(dms / T, 6)} ms/event, idle share {idle}")
        for k, v in top:
            print(f"     {v / T:.6f} ms/event  {k[:110]}")

    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}", file=sys.stderr)
        return 1
    replaces = {
        "weighted_update": "src/repro/kernels/weighted_update.py:112",
        "weighted_update_momentum": "src/repro/kernels/weighted_update.py:96",
        "block_prefix_update": "src/repro/kernels/weighted_update.py:166",
    }
    kernels = [
        dict(name=name, route="cuda", source="src/repro_torch/kernels/csrc/weighted_update.cu",
             replaces=replaces[name], launches=launches.get(name, 0), **row)
        for name, row in rows.items()
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
