"""Generalized AsyncSGD (Algorithm 1) in PyTorch, and the asynchronous /
synchronous baselines (FedBuff, FedAvg, FAVANO): the reference loops and the
replay engine entry point.

The counterpart of `repro.core.async_sgd`.  The server algorithm is written
against an abstract gradient source (anything that can produce a stochastic
gradient for client i at parameters w).

Faithfulness notes
------------------
* Line 10 of Algorithm 1:  w_{k+1} = w_k - eta/(n p_{J_k}) * g_{J_k}(w_{I_k})
  — the gradient is computed *at the dispatch-time parameters* w_{I_k}.  We
  snapshot parameters per in-flight task (C snapshots live at any time).
* Event timing follows the closed Jackson network (`core.queue_sim`).

Engines
-------
  * "python" — the per-event reference loop below (the port's own oracle;
    with faults, a guard or a scenario, `_python_fault_loop`);
  * "scan"   — the device-resident replay engine (`core.engine_scan`):
    ``stream="host"`` pre-simulates the event stream on the host and
    Algorithm 1 replays it over a flat snapshot ring buffer on the device;
    ``stream="device"`` generates the events on the device chunk by chunk
    and replays each chunk with the same steps (the fused runner,
    `engine_scan.make_fused_runner`), the only mode of ``adaptive``
    sampling.  Faults, the guard and scenarios run on both streams; with
    ``ckpt_dir`` either stream runs chunk by chunk through
    `core.engine_ckpt`, kill-and-resume safe.
Identical (seed, block) => identical event stream => iterates agree to
float-associativity tolerance.

Every run lives on ``ServerConfig.device`` ("cuda" by default; it raises
when no card is visible — pass "cpu" explicitly).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Protocol

import numpy as np
import torch

from ..device import resolve_device
from ..tree import tree_leaves, tree_map
from .queue_sim import (
    KIND_COMPLETE,
    KIND_FLIP,
    KIND_STAGE,
    ClosedNetworkSim,
    FaultConfig,
    SimConfig,
    export_stream,
)

__all__ = [
    "GradientSource",
    "ServerConfig",
    "TraceRecord",
    "run_generalized_async_sgd",
    "run_fedbuff",
    "run_fedavg",
    "run_favano",
]

Pytree = Any


class GradientSource(Protocol):
    def grad(self, client_id: int, params: Pytree, server_step: int) -> Pytree:
        """Stochastic gradient of client `client_id`'s local loss at `params`."""
        ...


def _axpy(w: Pytree, g: Pytree, a: float) -> Pytree:
    """w + a*g elementwise over the pytree."""
    a = float(a)
    return tree_map(lambda x, y: x + a * y, w, g)


@dataclass
class ServerConfig:
    """One server-loop run of Generalized AsyncSGD / AsyncSGD.

    The field names are `repro.core.async_sgd.ServerConfig`'s, so one config
    drives both packages, plus ``device``.
    """

    n: int                      # number of clients
    C: int                      # concurrency (in-flight tasks)
    T: int                      # CS steps
    eta: float                  # learning rate
    p: np.ndarray | None = None  # sampling probabilities (None = uniform)
    mu: np.ndarray | None = None  # client speeds for the event clock (None = 1)
    service: str = "exp"
    seed: int = 0
    weighting: str = "importance"  # "importance" (Alg. 1) | "plain" (AsyncSGD)
    eval_every: int = 0
    track_virtual: bool = False
    apply_update: Callable[[Pytree, Pytree, float], Pytree] | None = None
    # apply_update(w, g, scale) -> new w.  Defaults to w - scale*g.
    engine: str = "python"      # "python" (reference loop) | "scan" (replay engine)
    update: str = "jnp"         # scan engine update path: "jnp" (plain torch) |
                                # "pallas" (the hand-written CUDA kernels; the
                                # plain versions on a CPU device)
    stream: str = "host"        # scan engine event source: "host" (pre-simulated
                                # replay) | "device" (fused on-device generator)
    sparse: bool | str = "auto"  # device stream: the sparse O(C) class-collapsed
                                 # stream; "auto" takes it at n >= SPARSE_AUTO_N
                                 # where it composes (else dense), True always
                                 # (raising where it does not); the host
                                 # stream ignores it
    adaptive: bool = False      # device stream: re-optimize p from the measured
                                # rates every refresh_every CS steps
    refresh_every: int = 0
    ctrl_lr: float = 0.3
    ctrl_iters: int = 4
    block_size: int | str = 1   # events per micro-block (1 = per-event replay;
                                # "auto" = queue_sim.select_block_size)
    devices: int = 1            # lane-shard rank count: the blocked engine's E
                                # lanes over this many torch.distributed ranks
    segmentation: str = "greedy"  # blocked cut placement: "greedy" | "dp"
    snapshot_dtype: str | None = None  # ring-buffer storage dtype of the
                                       # scan engine (e.g. "bfloat16")
    pallas_interpret: bool = True  # a TPU-only knob (Pallas interpret mode):
                                   # accepted so configs carry over, ignored
    collect_extras: bool = True  # record per-event delays in the host stream
    faults: "FaultConfig | None" = None  # client churn / crash / straggler
                                 # injection (queue_sim.FaultConfig), both
                                 # engines and streams: non-completion
                                 # events apply no update and re-dispatch
                                 # with the current weights
    guard: Any | None = None     # engine_scan.GuardConfig: reject non-finite /
                                 # norm-exploding gradients and updates staler
                                 # than stale_cutoff CS steps
    ckpt_dir: str | None = None  # scan engine: checkpoint directory; routes the
                                 # run through core.engine_ckpt, saving the
                                 # full carry every ckpt_every CS steps
    ckpt_every: int = 0          # checkpoint cadence in CS steps
    resume: bool = False         # resume from the latest checkpoint in ckpt_dir
                                 # (config-fingerprint validated)
    serving: Any | None = None   # serving.ServingConfig: merge an open Poisson
                                 # inference stream into the device-stream
                                 # event race; requests are served from the
                                 # snapshot ring (the last known-good
                                 # iterate) and serve_* counters land in
                                 # TraceRecord.extras
    scenario: Any | None = None  # scenario.ScenarioConfig or a registry name:
                                 # phase-type service + Markov-modulated
                                 # availability, both engines and streams
                                 # (per event on the device stream);
                                 # exclusive with `faults`
    device: str = "cuda"         # torch device of the run


@dataclass
class TraceRecord:
    steps: np.ndarray
    times: np.ndarray
    eval_steps: list[int] = field(default_factory=list)
    eval_values: list[float] = field(default_factory=list)
    delays: list[list[int]] | None = None
    mean_queue_lengths: np.ndarray | None = None
    virtual_gap_sq: list[float] = field(default_factory=list)
    inflight_cardinality: list[int] = field(default_factory=list)
    extras: dict = field(default_factory=dict)


def _resolve(cfg: ServerConfig) -> tuple[np.ndarray, np.ndarray]:
    p = np.full(cfg.n, 1.0 / cfg.n) if cfg.p is None else np.asarray(cfg.p, float)
    mu = np.ones(cfg.n) if cfg.mu is None else np.asarray(cfg.mu, float)
    return p, mu


def _resolve_scenario_cfg(cfg: ServerConfig):
    """``cfg.scenario`` (name | ScenarioConfig | None) -> enabled config or
    None.  A disabled scenario (exponential + always-on) resolves to None so
    every engine takes its unmodified — bitwise-identical — path."""
    if cfg.scenario is None:
        return None
    from .scenario import get_scenario

    sc = get_scenario(cfg.scenario)
    return sc if sc.enabled else None


def _check_config(cfg: ServerConfig) -> None:
    """The checks of `repro`'s ServerConfig that come before any run; the
    engines' own validation follows, as the reference's does."""
    if cfg.stream not in ("host", "device"):
        raise ValueError(cfg.stream)
    if cfg.engine == "python" and (cfg.stream == "device" or cfg.adaptive):
        raise ValueError("stream='device' / adaptive require engine='scan'")
    if cfg.stream == "host" and cfg.adaptive and cfg.engine == "scan":
        raise ValueError("adaptive sampling requires stream='device'")
    if cfg.stream == "device" and cfg.engine == "scan":
        if cfg.service != "exp":
            raise ValueError(
                "stream='device' supports exponential service only "
                "(the on-device race relies on memorylessness)"
            )
        if cfg.sparse not in (True, False, "auto"):
            raise ValueError(f"sparse={cfg.sparse!r} (expected bool or 'auto')")


def _device_grad_fn(source) -> Callable:
    """Resolve the device gradient fn for the scan engine."""
    fn = getattr(source, "device_grad", None)
    if fn is None and callable(source):
        fn = source
    if fn is None:
        raise TypeError(
            "engine='scan' needs a device gradient source (a `device_grad(j, "
            f"w, k)` method over device tensors); got {type(source).__name__} "
            "— use engine='python' for host sources."
        )
    return fn


def _pallas_update_fn():
    """The ``update="pallas"`` per-event update: K1, one launch over every
    leaf of the tree."""
    from ..kernels.ops import tree_weighted_update

    return tree_weighted_update


#: cap for block_size="auto" selection
DEFAULT_BLOCK_SIZE_MAX = 16
#: probe length for "auto" when no event stream is materialized (device path)
AUTO_PROBE_STEPS = 4000
#: sparse="auto" switches the device stream to the O(C) class-collapsed
#: stream at and above this population size (below it the dense (n, C)
#: stream is already fast and stays the oracle)
SPARSE_AUTO_N = 50_000


def _probe_stream_slots(mu, p, C: int, T: int, seed, device, fault=None,
                        scenario=None) -> np.ndarray:
    """A short device-generated probe stream for block-size auto-selection.

    The fused engine never materializes its event stream, so ``"auto"`` on
    the device path measures conflict rates on a law-identical probe of at
    most `AUTO_PROBE_STEPS` CS steps from `stream_device.generate_stream`.
    Shared by `_run_scan` and `fl.run_matrix`, so both resolve "auto" alike.
    The probe draws from the configured stream: a clean probe under faults
    or a scenario would misjudge the conflict rates (flip and stage events
    carry the trash slot C).
    """
    from .stream_device import generate_stream

    return generate_stream(mu, p, C, min(T, AUTO_PROBE_STEPS), seed=seed, fault=fault,
                           scenario=scenario, device=device).slot


def _auto_block_size(slots, devices: int = 1, cut_every: int = 0) -> int:
    """Resolve ``block_size="auto"`` from measured conflict-free run lengths
    (`queue_sim.select_block_size`), scaled to multiples of ``devices``.
    ``slots`` is one measured (T,) slot array or a list of them."""
    from .queue_sim import select_block_size

    E, _ = select_block_size(
        slots,
        block_size_max=max(DEFAULT_BLOCK_SIZE_MAX, devices),
        devices=max(devices, 1),
        cut_every=cut_every,
        # greedy and DP cuts have identical block counts, so the cheaper
        # single pass suffices for the utilization measurements
        method="greedy",
    )
    return E


def _scan_update_fn(cfg: ServerConfig):
    if cfg.apply_update is not None:
        return cfg.apply_update
    if cfg.update == "pallas":
        return _pallas_update_fn()
    if cfg.update != "jnp":
        raise ValueError(cfg.update)
    return None  # engine default: w - scale*g


def _to_device(w0: Pytree, device: torch.device) -> Pytree:
    return tree_map(lambda x: torch.as_tensor(x, device=device), w0)


def _run_scan(
    w0: Pytree,
    source,
    cfg: ServerConfig,
    eval_fn,
    p: np.ndarray,
    mu: np.ndarray,
    device: torch.device,
    *,
    fedbuff_Z: int = 0,
) -> tuple[Pytree, TraceRecord]:
    """Scan-engine run of Generalized AsyncSGD or FedBuff on ``device``.

    ``cfg.stream == "device"`` generates the events on the device
    (`_run_fused`).  The host stream pre-simulates them with
    `queue_sim.export_stream` (faults and scenarios enter only there) and
    replays them; ``cfg.devices > 1`` lane-shards the blocked replay over
    that many `torch.distributed` ranks (every rank makes the same call).
    The guard's staleness cutoff zeroes the scales here, where the exported
    delays live; ``cfg.ckpt_dir`` routes the replay through the
    checkpointed drivers of `core.engine_ckpt`.  The options' validation
    is shared by both streams, as in the reference."""
    from .engine_scan import blocked_inputs, jit_runner, step_scales, stream_arrays
    from .queue_sim import EventBlocks

    if cfg.track_virtual:
        raise NotImplementedError("track_virtual requires engine='python'")
    weighting = "plain" if fedbuff_Z else cfg.weighting
    faults = cfg.faults if (cfg.faults is not None and cfg.faults.enabled) else None
    scenario = _resolve_scenario_cfg(cfg)
    if scenario is not None:
        if faults is not None:
            raise ValueError(
                "scenario= and faults= are separate injection paths; model "
                "suspension via ScenarioConfig modulation (rate_scale)"
            )
        if fedbuff_Z:
            raise ValueError("scenario= composes with Algorithm 1, not FedBuff")
        if cfg.service != "exp":
            raise ValueError("scenario= replaces the service law; leave service='exp'")
    guard = cfg.guard
    guard_stale = guard is not None and int(guard.stale_cutoff) > 0
    ckpt_on = cfg.ckpt_dir is not None
    if ckpt_on and cfg.ckpt_every <= 0:
        raise ValueError("ckpt_dir requires ckpt_every > 0")
    serving = _serving(cfg)
    if serving is not None and cfg.stream != "device":
        raise ValueError("serving requires stream='device' (the open arrival stream is merged "
                         "into the on-device event race)")
    if fedbuff_Z and (faults is not None or guard_stale):
        raise ValueError(
            "fault injection / staleness cutoff compose with Algorithm 1, "
            "not FedBuff (the buffer flush has no per-event masking)"
        )
    if cfg.stream == "device":
        return _run_fused(w0, source, cfg, eval_fn, p, mu, device, fedbuff_Z=fedbuff_Z,
                          faults=faults, scenario=scenario)
    w0_dev = _to_device(w0, device)
    eval_every = cfg.eval_every if eval_fn is not None else 0
    block_size = cfg.block_size
    stream = export_stream(
        SimConfig(mu=mu, p=p, C=cfg.C, T=cfg.T, service=cfg.service, seed=cfg.seed,
                  record_delays=cfg.collect_extras or guard_stale,
                  fault=faults, scenario=scenario)
    )
    scale = step_scales(stream, cfg.eta, p, weighting)
    host_stale_drops = 0
    if guard_stale:
        # the host replay drops stale updates here, where the exported
        # per-event delays live: the in-replay counter's second slot stays 0
        stale = (stream.delay_steps > int(guard.stale_cutoff)) & (scale != 0)
        host_stale_drops = int(stale.sum())
        scale = np.where(stale, 0.0, scale).astype(scale.dtype)
    if cfg.update not in ("jnp", "pallas"):
        raise ValueError(cfg.update)
    if block_size == "auto":
        block_size = _auto_block_size(stream.slot, cfg.devices, cut_every=eval_every)
    block_size = int(block_size)
    if block_size > 1 and cfg.apply_update is not None:
        raise ValueError("block_size > 1 requires the default update w - scale*g")
    if ckpt_on and cfg.devices > 1:
        raise ValueError("checkpointing does not compose with lane sharding")
    grad_fn = _device_grad_fn(source)
    if block_size > 1:
        group_events = eval_every
        if ckpt_on:
            # checkpoint cursors need exact event counts per row group,
            # which only the grouped (cut_every) layout provides
            group_events = eval_every if eval_every else min(cfg.ckpt_every, cfg.T)
        blocks = EventBlocks.from_stream(
            stream, block_size, cut_every=group_events, method=cfg.segmentation
        )
        J, slot, sc, kb, mask, chunk_blocks, n_chunks = blocked_inputs(
            blocks, scale, group_events
        )
        if ckpt_on:
            from .engine_ckpt import run_checkpointed_host_blocked

            out = run_checkpointed_host_blocked(
                grad_fn, cfg.C, block_size, w0_dev, J, slot, sc, kb, mask,
                group_events=group_events, chunk_blocks=chunk_blocks, n_chunks=n_chunks,
                ckpt_dir=cfg.ckpt_dir, ckpt_every=cfg.ckpt_every, eval_fn=eval_fn,
                kernel=cfg.update, snapshot_dtype=cfg.snapshot_dtype, fedbuff_Z=fedbuff_Z,
                guard=guard, resume=cfg.resume,
            )
        else:
            runner = jit_runner(
                grad_fn, cfg.C, fedbuff_Z=fedbuff_Z, eval_fn=eval_fn, block_size=block_size,
                kernel=cfg.update, snapshot_dtype=cfg.snapshot_dtype, lane_devices=cfg.devices,
                guard=guard,
            )
            idx = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)  # noqa: E731
            out = runner(
                w0_dev, idx(J), idx(slot),
                torch.as_tensor(sc, dtype=torch.float32, device=device),
                idx(kb), torch.as_tensor(mask, device=device),
                chunk_blocks=chunk_blocks, n_chunks=n_chunks,
            )
    else:
        if cfg.devices > 1:
            raise ValueError(
                "devices > 1 lane-shards micro-blocks and requires the "
                "blocked engine (block_size > 1)"
            )
        if ckpt_on:
            from .engine_ckpt import run_checkpointed_host

            out = run_checkpointed_host(
                grad_fn, cfg.C, w0_dev, stream.J, stream.slot, scale,
                ckpt_dir=cfg.ckpt_dir, ckpt_every=cfg.ckpt_every, eval_fn=eval_fn,
                eval_every=eval_every, fedbuff_Z=fedbuff_Z, update_fn=_scan_update_fn(cfg),
                snapshot_dtype=cfg.snapshot_dtype, guard=guard, resume=cfg.resume,
            )
        else:
            # the ring in the weights' dtype: `repro`'s un-checkpointed
            # per-event replay does not pass snapshot_dtype (the checkpointed
            # drivers and the blocked runner honour it, in both packages)
            runner = jit_runner(
                grad_fn, cfg.C, fedbuff_Z=fedbuff_Z, eval_fn=eval_fn, eval_every=eval_every,
                update_fn=_scan_update_fn(cfg), guard=guard,
            )
            J_dev, slot_dev = stream_arrays(stream, device)
            out = runner(
                w0_dev, J_dev, slot_dev,
                torch.as_tensor(scale, dtype=torch.float32, device=device),
            )
    w, evals = out[0], out[1]
    trace = TraceRecord(steps=np.arange(cfg.T), times=np.asarray(stream.t))
    trace.delays = stream.delays
    trace.mean_queue_lengths = (
        stream.queue_len_sum / cfg.T if stream.queue_len_sum is not None else None
    )
    if guard is not None:
        gcnt = out[2].cpu().numpy()
        trace.extras["guard_rejects"] = int(gcnt[0])
        trace.extras["stale_drops"] = int(gcnt[1]) + host_stale_drops
    if stream.kind is not None and (faults is not None or scenario is not None):
        trace.extras["kind_count"] = np.bincount(
            stream.kind, minlength=6 if scenario is not None else 4
        )
    if eval_fn is not None and cfg.eval_every:
        vals = evals.detach().cpu().numpy()  # the run's one host sync
        trace.eval_steps = [(i + 1) * cfg.eval_every for i in range(vals.shape[0])]
        trace.eval_values = [float(v) for v in vals]
    return w, trace


def _resolve_sparse(cfg: ServerConfig, mu, p, block_size, ckpt_on: bool = False):
    """Decide whether the device stream runs sparse, and collapse to classes.

    Returns ``(ClassSpec, mu_m, p_m)``, the class-level rates and per-node
    sampling probabilities, or ``(None, None, None)`` to keep the dense
    stream.  ``sparse=True`` raises on a blocked, lane-sharded or
    checkpointed run and where the population does not collapse (too many
    speed classes, fault rates that vary within a class);
    ``sparse="auto"`` falls back to the dense stream in those cases and
    below `SPARSE_AUTO_N` clients, as the reference does."""
    from .stream_device import build_class_spec, resolve_fault_rates_classes

    forced = cfg.sparse is True
    blockers = []
    if block_size != "auto" and int(block_size) > 1:
        blockers.append("block_size > 1")
    if cfg.devices > 1:
        blockers.append("devices > 1")
    if ckpt_on:
        blockers.append("checkpointing")
    if blockers:
        if forced:
            raise ValueError("sparse=True does not compose with " + ", ".join(blockers))
        return None, None, None
    if not forced and cfg.n < SPARSE_AUTO_N:
        return None, None, None
    try:
        spec, mu_m, p_m = build_class_spec(mu, p)
        if cfg.faults is not None and cfg.faults.enabled:
            resolve_fault_rates_classes(cfg.faults, spec, cfg.device)  # class-constant?
    except ValueError:
        if forced:
            raise
        return None, None, None
    return spec, np.asarray(mu_m, np.float64), np.asarray(p_m, np.float64)


def _expand_class_extras(extras: dict, classes) -> dict:
    """Expand the fused runner's (m,) class-level extras (numpy) back to
    per-client (n,) arrays.

    Per-node quantities (``p_final``, ``p_traj``) gather through
    ``inv_cls``; class totals (``occ_mean``, ``busy_time``, ``comp``, ...)
    divide by the class size first (within a class the clients are
    exchangeable, so a client's expectation is the class total over the
    class count).  ``mean_delays`` is computed per class (the class totals
    keep the ratio exact) and gathered.
    """
    inv = np.asarray(classes.inv_cls)
    cnt = np.asarray(classes.counts, np.float64)
    out = {k: np.asarray(v) for k, v in extras.items()}
    if "p_final" in out:
        out["p_final"] = out["p_final"][inv]
    if "p_traj" in out:
        out["p_traj"] = out["p_traj"][..., inv]
    if "comp" in out and "delay_sum" in out:
        out["mean_delays"] = (np.asarray(out["delay_sum"], np.float64)
                              / np.maximum(np.asarray(out["comp"], np.float64), 1.0))[inv]
    for k in ("occ_mean", "occ_time_avg", "busy_time", "delay_sum", "comp", "avail_time"):
        if k in out:
            out[k] = (np.asarray(out[k], np.float64) / cnt)[inv]
    return out


def _serving(cfg: ServerConfig):
    """``cfg.serving`` when it is on, else None."""
    return cfg.serving if (cfg.serving is not None and cfg.serving.enabled) else None


def _run_fused(w0, source, cfg: ServerConfig, eval_fn, p, mu, device, *, fedbuff_Z: int = 0,
               faults=None, scenario=None):
    """The device-stream branch of `_run_scan` (`repro`'s ``stream="device"``):
    the fused runner (`engine_scan.jit_fused_runner`) generates the closed
    network's events on ``device`` chunk by chunk and replays them, under
    ``faults`` or ``scenario`` (resolved by `_run_scan`) and ``cfg.guard``;
    the trace carries the event times and the on-device statistics
    (p_final, p_traj, mean delays, completions, busy time, mean queue
    lengths, the guard's and the kinds' counters, and with ``cfg.serving``
    the ``serve_*`` counters).  ``cfg.ckpt_dir`` runs
    `engine_ckpt.run_checkpointed` instead, whose trace has NaN times (the
    chunked driver keeps only the final clock)."""
    from .engine_scan import jit_fused_runner

    weighting = "plain" if fedbuff_Z else cfg.weighting
    block_size = cfg.block_size
    if block_size != "auto" and int(block_size) > 1 and cfg.apply_update is not None:
        raise ValueError("block_size > 1 requires the default update w - scale*g")
    if cfg.update not in ("jnp", "pallas"):
        raise ValueError(cfg.update)
    ckpt_on = cfg.ckpt_dir is not None
    serving = _serving(cfg)
    if cfg.sparse is True and serving is not None:
        raise ValueError("serving composes with the dense stream only (the serve read path "
                         "indexes the dense snapshot ring)")
    if scenario is not None:
        if cfg.sparse is True:
            raise ValueError("the fused engine's scenario path is dense-only; use "
                             "sparse_stats_stream_fn(scenario=True) for class-level laws")
        if serving is not None:
            raise ValueError("scenario= does not compose with serving=")
        if ckpt_on:
            raise ValueError("scenario= does not compose with checkpointing yet")
        if block_size == "auto":
            block_size = 1  # the scenario stream is per event
        elif int(block_size) > 1:
            raise ValueError("scenario= requires block_size=1")
    classes = class_mu = class_p = None
    if scenario is None and serving is None:  # serving keeps "auto" on the dense stream
        classes, class_mu, class_p = _resolve_sparse(cfg, mu, p, block_size, ckpt_on)
    if classes is not None:
        block_size = 1  # the sparse stream is per event: no "auto" probe
    eval_every = cfg.eval_every if eval_fn is not None else 0
    if block_size == "auto":
        block_size = _auto_block_size(
            _probe_stream_slots(mu, p, cfg.C, cfg.T, cfg.seed, device, fault=faults),
            cfg.devices)
    grad_fn = _device_grad_fn(source)
    if ckpt_on:
        return _run_fused_checkpointed(w0, grad_fn, cfg, eval_fn, eval_every, p, mu, device,
                                       weighting, int(block_size), fedbuff_Z, faults, serving)
    runner = jit_fused_runner(
        grad_fn, cfg.n, cfg.C, cfg.T,
        weighting=weighting, fedbuff_Z=fedbuff_Z, eval_fn=eval_fn, eval_every=eval_every,
        adaptive=cfg.adaptive, refresh_every=cfg.refresh_every, ctrl_lr=cfg.ctrl_lr,
        ctrl_iters=cfg.ctrl_iters, update_fn=_scan_update_fn(cfg), block_size=int(block_size),
        snapshot_dtype=cfg.snapshot_dtype, collect_extras=cfg.collect_extras,
        lane_devices=cfg.devices, fault=faults, guard=cfg.guard, scenario=scenario,
        classes=classes, serving=serving,
    )
    run_mu, run_p = (mu, p) if classes is None else (class_mu, class_p)
    w, evals, extras = runner(_to_device(w0, device), run_mu, run_p, cfg.seed, cfg.eta)
    extras = {k: v.detach().cpu().numpy() for k, v in extras.items()}  # one host sync
    if classes is not None:
        extras = _expand_class_extras(extras, classes)
    # collect_extras=False prunes the per-step clock: NaN, not made-up times
    times = np.asarray(extras["t"], np.float64) if "t" in extras else np.full(cfg.T, np.nan)
    trace = TraceRecord(steps=np.arange(cfg.T), times=times)
    trace.extras = {"p_final": np.asarray(extras["p_final"], np.float64)}
    for name in ("guard_rejects", "stale_drops", "kind_count", "avail_time"):
        if name in extras:
            trace.extras[name] = np.asarray(extras[name])
    for name in extras:
        if name.startswith("serve_"):
            trace.extras[name] = np.asarray(extras[name])
    if "occ_mean" in extras:
        trace.mean_queue_lengths = np.asarray(extras["occ_mean"], np.float64)
        comp = np.asarray(extras["comp"], np.float64)
        mean_delays = (np.asarray(extras["mean_delays"], np.float64)
                       if "mean_delays" in extras  # sparse: the exact class-level ratio
                       else np.asarray(extras["delay_sum"], np.float64) / np.maximum(comp, 1.0))
        trace.extras.update(
            p_traj=np.asarray(extras["p_traj"], np.float64),
            mean_delays=mean_delays,
            comp=comp,
            busy_time=np.asarray(extras["busy_time"], np.float64),
        )
    _trace_evals(trace, cfg, eval_fn, evals)
    return w, trace


def _run_fused_checkpointed(w0, grad_fn, cfg: ServerConfig, eval_fn, eval_every: int, p, mu,
                            device, weighting: str, block_size: int, fedbuff_Z: int, faults,
                            serving=None):
    """`_run_fused` with ``cfg.ckpt_dir``: `engine_ckpt.run_checkpointed`,
    seeded by ``cfg.seed``, with a full-carry checkpoint every
    ``cfg.ckpt_every`` events.  The trace's times are NaN (the chunked
    driver keeps only the final clock, ``extras["t_final"]``)."""
    from .engine_ckpt import run_checkpointed

    if cfg.devices > 1:
        raise ValueError("checkpointing does not compose with lane sharding — checkpoint the "
                         "unsharded run")
    if fedbuff_Z or _scan_update_fn(cfg) is not None:
        raise ValueError("the checkpointed fused engine supports the default update w - "
                         "scale*g with fedbuff_Z=0")
    w, evals, extras = run_checkpointed(
        grad_fn, cfg.n, cfg.C, cfg.T, w0=_to_device(w0, device), mu=mu, p0=p, key=cfg.seed,
        eta=cfg.eta, ckpt_dir=cfg.ckpt_dir, ckpt_every=cfg.ckpt_every, weighting=weighting,
        eval_fn=eval_fn, eval_every=eval_every, adaptive=cfg.adaptive,
        refresh_every=cfg.refresh_every, ctrl_lr=cfg.ctrl_lr, ctrl_iters=cfg.ctrl_iters,
        block_size=block_size, snapshot_dtype=cfg.snapshot_dtype, fault=faults, guard=cfg.guard,
        serving=serving, resume=cfg.resume,
    )
    trace = TraceRecord(steps=np.arange(cfg.T), times=np.full(cfg.T, np.nan))
    trace.extras = {k: v.detach().cpu().numpy() for k, v in extras.items()}  # one host sync
    _trace_evals(trace, cfg, eval_fn, evals)
    return w, trace


def _trace_evals(trace: TraceRecord, cfg: ServerConfig, eval_fn, evals) -> None:
    if eval_fn is not None and cfg.eval_every:
        vals = evals.detach().cpu().numpy()
        trace.eval_steps = [(i + 1) * cfg.eval_every for i in range(vals.shape[0])]
        trace.eval_values = [float(v) for v in vals]


def run_generalized_async_sgd(
    w0: Pytree,
    source: GradientSource,
    cfg: ServerConfig,
    eval_fn: Callable[[Pytree], float] | None = None,
) -> tuple[Pytree, TraceRecord]:
    """Algorithm 1.  Returns final parameters (tensors on ``cfg.device``)
    and the execution trace.

    With ``cfg.engine == "scan"``, `source` must have a ``device_grad(j, w,
    k)`` taking 0-d device tensors, and `eval_fn` (if given) must return a
    device scalar.  The "python" engine accepts any host callable.
    """
    _check_config(cfg)
    device = resolve_device(cfg.device)
    p, mu = _resolve(cfg)
    if cfg.engine == "scan":
        return _run_scan(w0, source, cfg, eval_fn, p, mu, device)
    if cfg.engine != "python":
        raise ValueError(cfg.engine)
    if cfg.ckpt_dir is not None:
        raise ValueError("checkpointing requires engine='scan'")
    scenario = _resolve_scenario_cfg(cfg)
    sim = ClosedNetworkSim(
        SimConfig(mu=mu, p=p, C=cfg.C, T=cfg.T, service=cfg.service,
                  seed=cfg.seed, record_delays=True, fault=cfg.faults, scenario=scenario)
    )
    apply_update = cfg.apply_update or (lambda w, g, s: _axpy(w, g, -s))
    faults_on = cfg.faults is not None and cfg.faults.enabled
    if faults_on or cfg.guard is not None or scenario is not None:
        if cfg.track_virtual:
            raise NotImplementedError(
                "track_virtual does not compose with faults/guards/scenarios"
            )
        return _python_fault_loop(w0, source, cfg, eval_fn, p, sim, apply_update, device)

    w = _to_device(w0, device)
    mu_virtual = w if cfg.track_virtual else None
    # dispatch-time parameter snapshot per client FIFO queue (mirrors sim.queues)
    snaps: list[deque] = [deque(w for _ in q) for q in sim.queues]

    times = np.zeros(cfg.T)
    steps = np.arange(cfg.T)
    trace = TraceRecord(steps=steps, times=times)

    for k in range(cfg.T):
        j, k_new = sim.step()          # J_k completes; K_{k+1} sampled; task enqueued
        w_disp = snaps[j].popleft()    # FIFO: the completed task's dispatch params
        g = source.grad(j, w_disp, k)
        if cfg.weighting == "importance":
            scale = cfg.eta / (cfg.n * p[j])
        elif cfg.weighting == "plain":
            scale = cfg.eta
        else:
            raise ValueError(cfg.weighting)
        w = apply_update(w, g, scale)
        snaps[k_new].append(w)    # the new task departs with the *updated* model
        times[k] = sim.now

        if cfg.track_virtual:
            # mu_{k+1} = mu_k - eta/(n p_{K_k}) g_{K_k}(w_k): instantaneous
            # contribution of the *newly sampled* client at the current w.
            g_virt = source.grad(k_new, w, k)
            mu_virtual = _axpy(mu_virtual, g_virt, -cfg.eta / (cfg.n * p[k_new]))
            gap = tree_map(lambda a, b: float(torch.sum((a - b) ** 2)), w, mu_virtual)
            trace.virtual_gap_sq.append(sum(tree_leaves(gap)))
            trace.inflight_cardinality.append(sim.total_tasks())

        _record_eval(trace, cfg, eval_fn, w, k + 1)

    trace.delays = sim.delays
    trace.mean_queue_lengths = sim.queue_len_sum / cfg.T
    return w, trace


def _python_fault_loop(
    w0: Pytree,
    source: GradientSource,
    cfg: ServerConfig,
    eval_fn,
    p: np.ndarray,
    sim: ClosedNetworkSim,
    apply_update,
    device: torch.device,
) -> tuple[Pytree, TraceRecord]:
    """Fault-, guard- and scenario-aware reference loop: the oracle of the
    replay engine's fault semantics (`repro`'s, on tensors).

    One iteration consumes one merged event (`ClosedNetworkSim.step_event`):
    a completion computes the gradient at the dispatch-time snapshot and,
    guards permitting, applies it; a crash or straggler timeout discards
    the in-flight work and re-dispatches the freed slot with the current
    weights; an availability flip or a service-stage advance moves no task.
    The guard's order (staleness before divergence, each reject counted
    once) is `engine_scan._make_flat_guard`'s, with staleness measured in
    merged-event steps, the clock the exported ``delay_steps`` count in.
    The verdicts are host floats: this loop syncs every event anyway.
    """
    guard = cfg.guard
    max_sq = float(guard.max_grad_norm) ** 2 if guard is not None else 0.0
    cutoff = int(guard.stale_cutoff) if guard is not None else 0
    gcnt = [0, 0]  # [guard_rejects, stale_drops]
    w = _to_device(w0, device)
    # per-node FIFO of (dispatch-time snapshot, dispatch step + 1)
    snaps: list[deque] = [deque((w, 0) for _ in q) for q in sim.queues]
    times = np.zeros(cfg.T)
    trace = TraceRecord(steps=np.arange(cfg.T), times=times)
    for k in range(cfg.T):
        kind, j, k_new = sim.step_event()
        times[k] = sim.now
        if kind == KIND_FLIP or kind == KIND_STAGE:
            # no task moved: flips touch no queue, a stage advance keeps the
            # head task in service — no snapshot pop, no update
            continue
        w_disp, disp_k = snaps[j].popleft()
        if kind == KIND_COMPLETE:
            live = True
            if cutoff and (k - disp_k) > cutoff:
                gcnt[1] += 1
                live = False
            if live:
                g = source.grad(j, w_disp, k)
                if guard is not None:
                    sq = sum(float(torch.sum(torch.square(torch.as_tensor(x).float())))
                             for x in tree_leaves(g))
                    if not np.isfinite(sq) or (max_sq > 0.0 and sq > max_sq):
                        gcnt[0] += 1
                        live = False
            if live:
                if cfg.weighting == "importance":
                    scale = cfg.eta / (cfg.n * p[j])
                elif cfg.weighting == "plain":
                    scale = cfg.eta
                else:
                    raise ValueError(cfg.weighting)
                w = apply_update(w, g, scale)
        # crash / timeout: the work is discarded; the slot re-dispatches at w
        snaps[k_new].append((w, k + 1))
        _record_eval(trace, cfg, eval_fn, w, k + 1)
    trace.delays = sim.delays
    trace.mean_queue_lengths = sim.queue_len_sum / cfg.T
    trace.extras = {
        "guard_rejects": gcnt[0],
        "stale_drops": gcnt[1],
        "kind_count": np.asarray(sim.kind_counts)
        if getattr(sim, "_fault", False) or getattr(sim, "_scenario", False)
        else None,
    }
    return w, trace


def _record_eval(trace: TraceRecord, cfg: ServerConfig, eval_fn, w, step: int) -> None:
    if eval_fn is not None and cfg.eval_every and step % cfg.eval_every == 0:
        trace.eval_steps.append(step)
        trace.eval_values.append(float(eval_fn(w)))


def run_fedbuff(
    w0: Pytree,
    source: GradientSource,
    cfg: ServerConfig,
    Z: int = 10,
    eval_fn: Callable[[Pytree], float] | None = None,
) -> tuple[Pytree, TraceRecord]:
    """FedBuff (Nguyen et al. 2022): uniform sampling, server applies the
    *average* of a buffer of Z received gradients.  The buffer fill shares the
    same queueing clock; the CS performs T//Z buffered updates over T
    completions.  ``cfg.engine == "scan"`` replays it on the engine (per
    event, blocked, lane-sharded), as `run_generalized_async_sgd` does."""
    _check_config(cfg)
    device = resolve_device(cfg.device)
    p, mu = _resolve(cfg)
    pu = np.full(cfg.n, 1.0 / cfg.n)  # FedBuff samples uniformly
    if cfg.engine == "scan":
        return _run_scan(w0, source, cfg, eval_fn, pu, mu, device, fedbuff_Z=Z)
    if cfg.engine != "python":
        raise ValueError(cfg.engine)
    if ((cfg.faults is not None and cfg.faults.enabled) or cfg.guard is not None
            or _resolve_scenario_cfg(cfg) is not None):
        raise ValueError(
            "faults/guards/scenarios compose with Algorithm 1 "
            "(run_generalized_async_sgd), not the FedBuff reference loop"
        )
    if cfg.ckpt_dir is not None:
        raise ValueError("checkpointing requires engine='scan'")
    sim = ClosedNetworkSim(
        SimConfig(mu=mu, p=pu, C=cfg.C, T=cfg.T, service=cfg.service,
                  seed=cfg.seed, record_delays=True)
    )
    apply_update = cfg.apply_update or (lambda w, g, s: _axpy(w, g, -s))
    w = _to_device(w0, device)
    snaps: list[deque] = [deque(w for _ in q) for q in sim.queues]
    buffer: list[Pytree] = []
    times = np.zeros(cfg.T)
    trace = TraceRecord(steps=np.arange(cfg.T), times=times)
    for k in range(cfg.T):
        j, k_new = sim.step()
        w_disp = snaps[j].popleft()
        buffer.append(source.grad(j, w_disp, k))
        if len(buffer) >= Z:
            g_mean = buffer[0]
            for g in buffer[1:]:
                g_mean = _axpy(g_mean, g, 1.0)
            g_mean = tree_map(lambda x: x / len(buffer), g_mean)
            w = apply_update(w, g_mean, cfg.eta)
            buffer = []
        snaps[k_new].append(w)
        times[k] = sim.now
        _record_eval(trace, cfg, eval_fn, w, k + 1)
    trace.delays = sim.delays
    trace.mean_queue_lengths = sim.queue_len_sum / cfg.T
    return w, trace


def run_fedavg(
    w0: Pytree,
    source: GradientSource,
    cfg: ServerConfig,
    clients_per_round: int = 10,
    local_steps: int = 1,
    eval_fn: Callable[[Pytree], float] | None = None,
) -> tuple[Pytree, TraceRecord]:
    """Synchronous FedAvg baseline.  Each round waits for the slowest sampled
    client (round time = max of their service draws); `cfg.T` counts rounds.
    The client choices and round times come from `numpy`'s generator, as in
    `repro`, so they are bitwise the reference's.  Like the reference, it
    reads only the queueing-free fields of ``cfg`` (n, T, eta, mu, service,
    seed, eval_every, apply_update) and ``device``."""
    device = resolve_device(cfg.device)
    _, mu = _resolve(cfg)
    rng = np.random.default_rng(cfg.seed)
    apply_update = cfg.apply_update or (lambda w, g, s: _axpy(w, g, -s))
    w = _to_device(w0, device)
    now = 0.0
    times = np.zeros(cfg.T)
    trace = TraceRecord(steps=np.arange(cfg.T), times=times)
    for r in range(cfg.T):
        sel = rng.choice(cfg.n, size=clients_per_round, replace=False)
        # round wall time = slowest client's total local work
        if cfg.service == "exp":
            durs = rng.exponential(1.0 / mu[sel], size=sel.size) * local_steps
        else:
            durs = local_steps / mu[sel]
        now += float(np.max(durs))
        g_mean = None
        for i in sel:
            g = source.grad(int(i), w, r)
            for _ in range(local_steps - 1):
                g = _axpy(g, source.grad(int(i), _axpy(w, g, -cfg.eta), r), 1.0)
            g_mean = g if g_mean is None else _axpy(g_mean, g, 1.0)
        g_mean = tree_map(lambda x: x / sel.size, g_mean)
        w = apply_update(w, g_mean, cfg.eta)
        times[r] = now
        _record_eval(trace, cfg, eval_fn, w, r + 1)
    return w, trace


def run_favano(
    w0: Pytree,
    source: GradientSource,
    cfg: ServerConfig,
    period: float = 1.0,
    max_local_steps: int = 8,
    eval_fn: Callable[[Pytree], float] | None = None,
) -> tuple[Pytree, TraceRecord]:
    """FAVANO/QuAFL-style baseline (Leconte et al. 2023; Zakerinia et al. 2022).

    No queues: the CS ticks at a fixed cadence `period`; between ticks each
    client performs as many local SGD steps as its speed allows (capped at
    `max_local_steps`, interruptible), and the CS averages the client models.
    The CS step rate is bounded by the cadence — the contrast the paper draws
    against queue-driven AsyncSGD (§5).  `cfg.T` counts CS rounds; the local
    step counts come from `numpy`'s generator, bitwise the reference's.
    """
    device = resolve_device(cfg.device)
    _, mu = _resolve(cfg)
    rng = np.random.default_rng(cfg.seed)
    apply_update = cfg.apply_update or (lambda w, g, s: _axpy(w, g, -s))
    w = _to_device(w0, device)
    locals_ = [w for _ in range(cfg.n)]
    now = 0.0
    times = np.zeros(cfg.T)
    trace = TraceRecord(steps=np.arange(cfg.T), times=times)
    for r in range(cfg.T):
        now += period
        for i in range(cfg.n):
            # local steps completed within the window (speed-proportional)
            n_i = min(int(rng.poisson(mu[i] * period)), max_local_steps)
            wi = locals_[i]
            for _ in range(n_i):
                wi = apply_update(wi, source.grad(i, wi, r), cfg.eta)
            locals_[i] = wi
        # CS averages client models and broadcasts
        w = _tree_mean(locals_)
        locals_ = [w for _ in range(cfg.n)]
        times[r] = now
        _record_eval(trace, cfg, eval_fn, w, r + 1)
    return w, trace


def _tree_mean(trees: list) -> Pytree:
    out = trees[0]
    for t in trees[1:]:
        out = _axpy(out, t, 1.0)
    return tree_map(lambda x: x / len(trees), out)
