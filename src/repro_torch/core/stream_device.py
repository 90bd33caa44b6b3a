"""Device-resident closed-Jackson-network simulator and the adaptive
sampling control plane, in PyTorch.

The counterpart of `repro.core.stream_device`, dense:
`queue_sim.ClosedNetworkSim` is the host oracle (exact, per-event Python);
this module is the same closed network as tensor operations on the stream's
device, so the event stream can be generated next to the replay
(`engine_scan.make_runner(stream="device")`) instead of being
pre-simulated on the host:

  * `StreamState` carries per-node queue occupancy, fixed-shape ``(n, C)``
    FIFO ring buffers of slot ids and per-node head/tail counters;
  * `stream_step` advances one CS step: the exponential completion race is
    an inverse-CDF draw over the busy-rate vector by segment-tree descent
    (`tree_build` / `tree_sample`), driven by pre-drawn uniforms, and the
    step emits the ``(J, K, t, slot)`` tuple `queue_sim.EventStream` carries;
  * `fault_stream_step` races 4n clocks instead (completion, crash,
    straggler timeout, availability flip; `resolve_fault_rates`), and
    `scenario_stream_step` 2n (phase-type service stages and modulated
    availability; `resolve_scenario`): a flip or stage event moves no task
    and carries the trash slot C, and every event a kind tag;
  * `merged_stream_step` races the closed network against an open stream
    of total rate ``ext_rate`` (the serving plane, `core.serving`): an
    external win emits ``Event(j=n, slot=C, kind=KIND_SERVE)`` and hands
    the open side its conditional uniform; `merged_stats_step` leaves the
    per-node statistics of such an event as they were;
  * `StatsState` / `stats_step` accumulate running occupancy, busy time,
    completion counts and FIFO delays on the device, the float integrals as
    Kahan-compensated pairs (`fault_stats_step` / `scenario_stats_step`:
    completions only, busy time gated on availability or scaled by the
    modulated speed, the availability integral and a kind histogram);
  * the control plane: `mva_throughput_delays` (Mean Value Analysis),
    `optimal_eta_jnp`, `generalized_bound_jnp`, `make_bound_value_and_grad`
    (the Theorem-1 objective with its simplex gradient by autograd through
    the MVA recurrence), `estimate_mu` and `ctrl_refresh`, one adaptive
    sampling update from measured rates.  The names keep the reference's
    ``_jnp`` suffixes so a reader finds each counterpart.

Every state tensor may carry a leading cell axis B (one closed network per
scenario-matrix cell, all advanced in lockstep): the steps index through
``gather`` / ``scatter`` on the last axis, so the same code runs one
network or B of them.  Integer state is int64 (torch's index dtype) where
the reference keeps int32; the values are the same.  No step reads a device
value on the host: indices stay tensors, so a chunk of events makes no host
sync.  Where the reference clamps a gather at the trash slot C or drops a
scatter there (``mode="drop"``), a step here gathers at ``min(slot, C-1)``
and writes back the old value under a mask, which gives the same values.

Random draws come from a `torch.Generator` (seeded from ``seed``, or
passed in) in the reference's order: the initial placement, then the race,
holding-time and dispatch uniforms; a scenario stream then draws its (T,)
dispatch-phase uniforms and the C initial-phase uniforms.  Threefry streams
cannot be reproduced in torch, so the stream is held against the reference
in law, and bitwise on the reference's own draws through `scan_draws`.

The sparse O(C) stream is the same network for a population of few speed
classes (`ClassSpec`): its state is the C in-flight tasks (`SparseStreamState`:
node, class, FIFO stamp and head-of-line flag a slot, and under faults the
per-class idle pools), each event races the <= C head-of-line tasks
(`sparse_stream_step`; `sparse_fault_stream_step` 4C + 2m clocks,
`sparse_scenario_stream_step` 2C + 2m), and the statistics are per class.
Nothing per event touches an (n,) tensor but O(1) gathers from ``perm`` and
``inv_cls``, so an event costs the same at n = 10^3 and n = 10^6.  Its draws
(`draw_sparse_uniforms`) add the dispatch member uniforms ``u_mem`` and, under
faults or a scenario, the availability-bit uniforms ``u_bit``;
`sparse_scan_draws` runs it on given draws.  The control plane takes
``counts=`` (the class sizes) and then runs on the class simplex.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Any, NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from .classes import ClassSpec, build_class_spec
from .queue_sim import (
    KIND_COMPLETE,
    KIND_FLIP,
    KIND_SERVE,
    KIND_STAGE,
    N_KINDS,
    EventBlocks,
    EventStream,
)
from .theory import BoundConstants

__all__ = [
    "StreamState",
    "StatsState",
    "Event",
    "stream_init",
    "stream_step",
    "fault_stream_step",
    "merged_stream_step",
    "merged_stats_step",
    "FaultRates",
    "resolve_fault_rates",
    "ScenarioRates",
    "resolve_scenario",
    "resolve_scenario_classes",
    "scenario_stream_init",
    "scenario_stream_step",
    "scenario_stats_step",
    "stats_init",
    "stats_step",
    "fault_stats_step",
    "scan_draws",
    "draw_uniforms",
    "stats_stream_fn",
    "generate_stream",
    "generate_blocks",
    "tree_build",
    "tree_sample",
    "tree_update",
    "kahan_add",
    "kahan_value",
    "ClassSpec",
    "build_class_spec",
    "resolve_fault_rates_classes",
    "SparseStreamState",
    "sample_dispatch_classes",
    "sparse_stream_init",
    "sparse_stream_step",
    "sparse_fault_stream_step",
    "sparse_scenario_stream_init",
    "sparse_scenario_stream_step",
    "sparse_scenario_class_stats",
    "sparse_class_stats",
    "class_occupancy",
    "sparse_stats_init",
    "sparse_stats_step",
    "sparse_fault_stats_step",
    "sparse_scan_draws",
    "draw_sparse_uniforms",
    "sparse_stats_stream_fn",
    "mva_throughput_delays",
    "optimal_eta_jnp",
    "generalized_bound_jnp",
    "make_bound_value_and_grad",
    "ctrl_refresh",
    "estimate_mu",
]

_I64 = torch.int64
_F32 = torch.float32


# ---------------------------------------------------------------------- #
# segment-tree CDF sampler: pairwise sums; the descent never lands on a
# zero-weight leaf
# ---------------------------------------------------------------------- #
def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length() if n > 1 else 1


def tree_build(w: torch.Tensor) -> torch.Tensor:
    """Flattened-heap sum tree over the last axis of ``w``.

    Returns ``(..., 2N)`` (N the next power of two >= n): ``tree[..., 1]``
    is the root total, the children of node i sit at ``2i`` / ``2i+1`` and
    the zero-padded leaves at ``tree[..., N:]``.  Each level is one add of
    adjacent pairs, so every node is the same fp32 sum of two values as in
    the reference.
    """
    n = w.shape[-1]
    N = _next_pow2(n)
    level = torch.nn.functional.pad(w, (0, N - n)) if N != n else w
    levels = [level]
    while levels[-1].shape[-1] > 1:
        lv = levels[-1]
        levels.append(lv[..., 0::2] + lv[..., 1::2])
    return torch.cat([w.new_zeros(*w.shape[:-1], 1)] + levels[::-1], dim=-1)


def tree_sample(tree: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draws from a `tree_build` tree: the leaf index per draw.

    Descends ``x = u * total``: go right iff the left mass is exhausted and
    the right subtree has positive mass, so a zero-weight leaf is never
    drawn.  ``tree`` is ``(2N,)`` or ``(B, 2N)``; ``u`` holds any number
    of draws per tree (``(M,)`` for one tree, ``(B,)`` or ``(B, M)`` for B).
    """
    N = tree.shape[-1] // 2
    depth = max(N.bit_length() - 1, 0)
    lead = tree.shape[:-1]
    t2 = tree.reshape(-1, 2 * N)
    Bt = t2.shape[0]
    squeeze = u.dim() == len(lead)  # one draw per tree
    x = u.reshape(Bt, -1) if not squeeze else u.reshape(Bt, 1)
    x = x * t2[:, 1:2]
    idx = torch.ones(x.shape, dtype=_I64, device=x.device)
    if depth:
        # per node: (the left child's mass, or +inf where the right subtree
        # is empty, so ``x >= .`` is the reference's go-right test in one
        # compare; the left child's mass, which a right step subtracts)
        pairs = t2.view(Bt, N, 2)  # pairs[:, i] = children of node i
        left = pairs[..., 0]
        table = torch.stack([torch.where(pairs[..., 1] > 0, left, torch.inf), left], dim=-1)
    for _ in range(depth):
        lr = table.gather(1, idx[..., None].expand(*idx.shape, 2))
        go = x >= lr[..., 0]
        x = torch.where(go, x - lr[..., 1], x)
        idx = torch.add(go, idx, alpha=2)
    out = idx - N
    return out.reshape(u.shape)


def tree_update(tree: torch.Tensor, idx: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """Set leaf ``idx`` to ``value`` and refresh its root path (O(log n)):
    the root path gets ``value - old`` added once per node."""
    N = tree.shape[-1] // 2
    depth = max(N.bit_length() - 1, 0)
    pos = torch.as_tensor(idx, dtype=_I64, device=tree.device) + N
    delta = value - tree.gather(-1, pos[..., None])[..., 0]
    path = torch.stack([pos >> d for d in range(depth + 1)], dim=-1)
    return tree.scatter_add(-1, path, delta[..., None].expand(path.shape).to(tree.dtype))


# ---------------------------------------------------------------------- #
# Kahan-compensated accumulation: an fp32 time integral stalls once it
# passes ~2^24; a compensated (sum, c) pair keeps relative O(eps) accuracy
# ---------------------------------------------------------------------- #
def kahan_add(s, c, x):
    """One compensated add: the new ``(s, c)`` pair.  The represented total
    is ``s - c``; ``s`` alone is the correctly rounded fp32 running sum."""
    y = x - c
    t = s + y
    return t, (t - s) - y


def fma32(a, b, c) -> torch.Tensor:
    """``a * b + c`` of float32 tensors, rounded once to float32: XLA's CPU
    backend contracts a product that feeds an add into one fused
    multiply-add, and where the reference's arithmetic is held bitwise the
    port rounds such sums once too.  Computed in float64, which holds the
    product of two float32 values exactly, then rounded."""
    return (a.double() * b.double() + c.double()).to(_F32)


def kahan_value(s, c) -> np.ndarray:
    """Host-side exact readout of a compensated pair (float64)."""
    f64 = lambda a: np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a,  # noqa: E731
                               np.float64)
    return f64(s) - f64(c)


def _take(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``a[..., i]`` with one index per leading position."""
    return a.gather(-1, i[..., None])[..., 0]


def _kahan_scatter_add(s, c, idx, x):
    """Compensated ``s.at[idx].add(x)`` for one index per leading position."""
    sj, cj = _take(s, idx), _take(c, idx)
    y = x - cj
    t = sj + y
    i = idx[..., None]
    return s.scatter(-1, i, t[..., None]), c.scatter(-1, i, ((t - sj) - y)[..., None])


class StreamState(NamedTuple):
    """State of the closed network (one cell, or B along a leading axis)."""

    occ: Any    # (n,) int64: queue length per node (X_i)
    ring: Any   # (n, C) int64: FIFO ring buffer of slot ids per node
    head: Any   # (n,) int64: pop counter per node (ring index = head % C)
    tail: Any   # (n,) int64: push counter per node
    t: Any      # () float32: physical time (Kahan sum; see t_c)
    avail: Any = None  # (n,) float32 0/1 availability (fault and scenario
                       # mode; else None)
    t_c: Any = 0.0     # () float32: Kahan compensation of t
    phase: Any = None  # (C,) int64: service stage of each slot's task
                       # (scenario mode; else None)


class Event(NamedTuple):
    """One CS step, as `stream_step` emits it (EventStream's columns)."""

    j: Any      # completing client J_k
    k: Any      # newly sampled client K_{k+1}
    t: Any      # physical completion time
    slot: Any   # ring slot of the completing task (freed and reused)
    dt: Any     # time since the previous CS step
    kind: Any = 0  # KIND_COMPLETE: a fault-free stream has no other kind


class StatsState(NamedTuple):
    """Running observables on the device; float accumulators are Kahan
    pairs (``x`` plus compensation ``x_c``; host readout `kahan_value`)."""

    occ_sum: Any    # (n,) int64: sum over steps of post-step X_{i,k} (Palm)
    occ_tw: Any     # (n,) float32: time-weighted integral of X_i(t)
    busy_t: Any     # (n,) float32: integral of 1{X_i > 0} dt (fault mode:
                    # gated on availability; scenario mode: the modulated
                    # speed, so mu MLEs stay unbiased)
    comp: Any       # (n,) int64: completions per node
    delay_sum: Any  # (n,) float32: sum of CS-step delays per node
    slot_step: Any  # (C,) int64: dispatch step of the task in each slot
    avail_tw: Any = None    # (n,) float32: integral of availability (fault
                            # and scenario mode; else None)
    kind_count: Any = None  # (4,) int64 events per KIND_* tag (fault mode),
                            # (N_KINDS,) (scenario mode); else None
    occ_tw_c: Any = 0.0     # Kahan compensations of the float integrals
    busy_t_c: Any = 0.0
    delay_sum_c: Any = 0.0
    avail_tw_c: Any = None


def _enabled(opt) -> bool:
    """A fault / scenario option (a bool flag or a config) is switched on."""
    return bool(opt) if isinstance(opt, bool) else opt is not None and opt.enabled


def _init_nodes(gen: torch.Generator, n: int, C: int, p: torch.Tensor, init: str) -> torch.Tensor:
    """The initial placement of the C tasks, drawn from ``gen``:
    ``"distinct"`` a uniform random subset of C clients (round-robin when
    C > n), ``"sampled"`` C iid draws from ``p`` (`queue_sim.SimConfig.initial`'s
    two conventions)."""
    dev = p.device
    if init == "distinct":
        if C <= n:
            return torch.randperm(n, generator=gen, device=dev)[:C]
        return torch.arange(C, dtype=_I64, device=dev) % n
    if init == "sampled":
        u = torch.rand(C, generator=gen, device=dev)
        return tree_sample(tree_build(p.to(_F32)), u)
    raise ValueError(init)


def stream_init(nodes, n: int, C: int, fault: bool = False) -> tuple[StreamState, torch.Tensor]:
    """The state with the C tasks at ``nodes`` (``(C,)``, or ``(B, C)`` for
    B cells): task s sits at the FIFO position of the earlier tasks at its
    node; with ``fault`` every node starts available.  Returns ``(state,
    nodes)`` as the reference's does; the nodes come from `draw_uniforms`
    (the port's generator) or from the caller (the reference's draws, in
    parity tests)."""
    nodes = torch.as_tensor(nodes).to(_I64)
    dev = nodes.device
    lead = nodes.shape[:-1]
    eq = nodes[..., None, :] == nodes[..., :, None]
    pos = torch.tril(eq, -1).sum(-1)
    occ = torch.zeros(*lead, n, dtype=_I64, device=dev).scatter_add(
        -1, nodes, torch.ones_like(nodes))
    ring = torch.zeros(*lead, n * C, dtype=_I64, device=dev).scatter(
        -1, nodes * C + pos, torch.arange(C, dtype=_I64, device=dev).expand(nodes.shape))
    zero = torch.zeros(lead, dtype=_F32, device=dev)
    state = StreamState(occ=occ, ring=ring.view(*lead, n, C),
                        head=torch.zeros_like(occ), tail=occ.clone(), t=zero,
                        avail=torch.ones(*lead, n, dtype=_F32, device=dev) if fault else None,
                        t_c=zero.clone())
    return state, nodes


class _Consts:
    """Per-shape constants of the step (built once a run, not per event);
    ``cols`` (with ``n``) holds each node's first ring index, ``i * C``, and
    ``ar`` the slot indices the sparse steps compare against."""

    def __init__(self, lead, C: int, device, n: int | None = None):
        self.one = torch.ones(*lead, 1, dtype=_I64, device=device)
        self.neg = -self.one
        self.C = C
        self.cols = None if n is None else torch.arange(n, dtype=_I64, device=device) * C
        self.ar = torch.arange(C, dtype=_I64, device=device)


def _stream_step(state: StreamState, mu, e_hold, u_race, k_new, cst: _Consts):
    """One CS step; ``e_hold = -log1p(-u_exp)`` (precomputed for a chunk)."""
    occ, ring, head, tail = state.occ, state.ring, state.head, state.tail
    C = cst.C
    lead = occ.shape[:-1]
    rates = torch.where(occ > 0, mu, 0.0)
    rtree = tree_build(rates)
    dt = e_hold / rtree[..., 1]
    t, t_c = kahan_add(state.t, state.t_c, dt)
    j = tree_sample(rtree, u_race)
    # pop the oldest in-flight task at j; its freed slot hosts the dispatch
    flat = ring.reshape(*lead, -1)
    s = _take(flat, torch.add(_take(head, j) % C, j, alpha=C))
    jj, kk = j[..., None], k_new[..., None]
    head = head.scatter_add(-1, jj, cst.one)
    occ = occ.scatter_add(-1, jj, cst.neg)
    flat = flat.scatter(-1, torch.add(_take(tail, k_new) % C, k_new, alpha=C)[..., None],
                        s[..., None])
    tail = tail.scatter_add(-1, kk, cst.one)
    occ = occ.scatter_add(-1, kk, cst.one)
    new = StreamState(occ=occ, ring=flat.view(ring.shape), head=head, tail=tail, t=t, t_c=t_c)
    return new, Event(j=j, k=k_new, t=t, slot=s, dt=dt)


def stream_step(state: StreamState, mu, xs) -> tuple[StreamState, Event]:
    """One CS step of the closed network.

    ``xs = (u_race, u_exp, k_new)``: the race and holding-time uniforms and
    the pre-sampled dispatch target K_{k+1} ~ p (one each per cell).  With
    exponential service the network is a CTMC: given the occupancy the next
    completion is at node j w.p. mu_j 1{X_j>0} / sum(...) after an
    Exp(sum) holding time.
    """
    u_race, u_exp, k_new = xs
    dev = state.occ.device
    cst = _Consts(state.occ.shape[:-1], state.ring.shape[-1], dev)
    return _stream_step(state, _f32(mu, dev), _hold(u_exp, dev), _f32(u_race, dev),
                        torch.as_tensor(k_new, dtype=_I64, device=dev), cst)


def _f32(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F32, device=dev)


def _hold(u_exp, dev) -> torch.Tensor:
    """``-log1p(-u_exp)``, the unit-rate exponential holding times."""
    return -torch.log1p(-_f32(u_exp, dev))


class FaultRates(NamedTuple):
    """Device-resident per-node fault intensities, in the operand order
    `fault_stream_step` races over (`resolve_fault_rates`)."""

    kappa: Any   # (n,) float32: crash rate while available
    theta: Any   # (n,) float32: straggler timeout rate of the head task
    q_off: Any   # (n,) float32: on -> off flip intensity
    q_on: Any    # (n,) float32: off -> on flip intensity


def _table(a, dtype, device) -> torch.Tensor:
    """A host table on ``device``: on a card, an asynchronous copy from
    pinned memory, so resolving a run's tables makes no host sync."""
    t = torch.as_tensor(np.asarray(a), dtype=dtype)
    dev = resolve_device(device)
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t


def resolve_fault_rates(fault, n: int, device="cuda") -> FaultRates:
    """`FaultConfig` -> float32 ``(kappa, theta, q_off, q_on)`` tensors on
    ``device``, the operand order `fault_stream_step` races over."""
    q_off, q_on, kappa, theta = fault.resolve(n)
    return FaultRates(*(_table(a, _F32, device) for a in (kappa, theta, q_off, q_on)))


def _push(flat, tail, k_new, s, move, C: int):
    """The ring write of a masked step: the dispatched slot ``s`` at
    ``k_new``'s tail where ``move``, else the old entry written back (the
    reference drops that write)."""
    pos = torch.add(_take(tail, k_new) % C, k_new, alpha=C)[..., None]
    old = flat.gather(-1, pos)
    return flat.scatter(-1, pos, torch.where(move[..., None], s[..., None], old))


def _toggle(avail, j, flip):
    """``avail[j] += flip * (1 - 2 avail[j])``: a flip event's toggle."""
    aj = _take(avail, j)
    return avail.scatter_add(-1, j[..., None], (flip.to(_F32) * (1.0 - 2.0 * aj))[..., None])


def _fault_stream_step(state: StreamState, mu, fr: FaultRates, e_hold, u_race, k_new,
                       cst: _Consts):
    """`fault_stream_step` on precomputed holding times (a chunk's)."""
    occ, ring, head, tail, avail = state.occ, state.ring, state.head, state.tail, state.avail
    C = cst.C
    n = occ.shape[-1]
    lead = occ.shape[:-1]
    busy = occ > 0
    rates = torch.cat([torch.where(busy, mu * avail, 0.0),
                       torch.where(busy, fr.kappa * avail, 0.0),
                       torch.where(busy, fr.theta, 0.0),
                       torch.where(avail > 0, fr.q_off, fr.q_on)], dim=-1)
    rtree = tree_build(rates)
    # all nodes off and no clock running: time still moves
    dt = e_hold / torch.clamp_min(rtree[..., 1], 1e-30)
    t, t_c = kahan_add(state.t, state.t_c, dt)
    idx = tree_sample(rtree, u_race)
    kind = torch.div(idx, n, rounding_mode="floor")
    j = idx - kind * n
    move = kind < KIND_FLIP
    # pop the oldest in-flight task at j (a flip pops nothing: slot -> C)
    flat = ring.reshape(*lead, -1)
    s = torch.where(move, _take(flat, torch.add(_take(head, j) % C, j, alpha=C)), C)
    mv = move.to(_I64)[..., None]
    jj, kk = j[..., None], k_new[..., None]
    head = head.scatter_add(-1, jj, mv)
    occ = occ.scatter_add(-1, jj, -mv)
    flat = _push(flat, tail, k_new, s, move, C)
    tail = tail.scatter_add(-1, kk, mv)
    occ = occ.scatter_add(-1, kk, mv)
    avail = _toggle(avail, j, kind == KIND_FLIP)
    new = StreamState(occ=occ, ring=flat.view(ring.shape), head=head, tail=tail, t=t,
                      avail=avail, t_c=t_c)
    return new, Event(j=j, k=k_new, t=t, slot=s, dt=dt, kind=kind)


def fault_stream_step(state: StreamState, mu, fr: FaultRates, xs):
    """One merged-CTMC event of the faulty closed network.

    The same machinery as `stream_step`, but the inverse-CDF race runs over
    ``4n`` competing exponential clocks:

      ``[ mu_i a_i 1{X_i>0} | kappa_i a_i 1{X_i>0} | theta_i 1{X_i>0} |
         q_off_i a_i + q_on_i (1 - a_i) ]``

    completions, crashes, straggler timeouts (server-side deadlines, so
    they fire while the node is off) and availability flips, with ``a`` the
    0/1 availability vector.  The winner decodes as ``kind = idx // n``,
    ``node = idx % n``.  Task movements (kind < 3) pop the head-of-line
    slot and re-dispatch it at the pre-sampled ``k_new``; a flip toggles
    availability, moves no task and carries the trash slot C.  ``fr =
    resolve_fault_rates(...)``.
    """
    u_race, u_exp, k_new = xs
    dev = state.occ.device
    cst = _Consts(state.occ.shape[:-1], state.ring.shape[-1], dev)
    return _fault_stream_step(state, _f32(mu, dev), fr, _hold(u_exp, dev), _f32(u_race, dev),
                              torch.as_tensor(k_new, dtype=_I64, device=dev), cst)


#: the conditional uniforms' upper clip, 1 - 1e-7 rounded to float32 once
_U_TOP = float(np.float32(1.0 - 1e-7))


def _merged_stream_step(state: StreamState, mu, ext, e_hold, u_race, k_new, cst: _Consts,
                        fr: FaultRates | None = None):
    """`merged_stream_step` on precomputed holding times: ``(state, ev,
    is_ext, u_ext)``."""
    occ, ring, head, tail, avail = state.occ, state.ring, state.head, state.tail, state.avail
    C = cst.C
    n = occ.shape[-1]
    lead = occ.shape[:-1]
    if fr is not None:
        busy = occ > 0
        rates = torch.cat([torch.where(busy, mu * avail, 0.0),
                           torch.where(busy, fr.kappa * avail, 0.0),
                           torch.where(busy, fr.theta, 0.0),
                           torch.where(avail > 0, fr.q_off, fr.q_on)], dim=-1)
    else:
        rates = torch.where(occ > 0, mu, 0.0)
    rtree = tree_build(rates)
    r_train = torch.clamp_min(rtree[..., 1], 1e-30)
    tot = r_train + ext
    dt = e_hold / tot
    t, t_c = kahan_add(state.t, state.t_c, dt)
    x = u_race * tot
    is_ext = x >= r_train
    # conditional uniforms: exact given the branch (clipped only against
    # the open boundary so the tree descent stays in range)
    u_train = torch.clamp(x / r_train, 0.0, _U_TOP)
    # x - r_train as XLA computes it: u_race * tot - r_train in one rounding
    u_ext = torch.clamp(fma32(u_race, tot, -r_train) / torch.clamp_min(ext, 1e-30), 0.0, _U_TOP)
    idx = tree_sample(rtree, u_train)
    if fr is not None:
        kind = torch.div(idx, n, rounding_mode="floor")
        j = idx - kind * n
        kind = torch.where(is_ext, KIND_SERVE, kind)
    else:
        kind = torch.where(is_ext, KIND_SERVE, KIND_COMPLETE)
        j = idx
    move = kind < KIND_FLIP  # excludes flips and external events
    # the reference gathers at j % n and drops the scatters at j = n: an
    # external event reads node 0 here and adds 0 there
    flat = ring.reshape(*lead, -1)
    s = torch.where(move, _take(flat, torch.add(_take(head, j) % C, j, alpha=C)), C)
    mv = move.to(_I64)[..., None]
    jj, kk = j[..., None], k_new[..., None]
    head = head.scatter_add(-1, jj, mv)
    occ = occ.scatter_add(-1, jj, -mv)
    flat = _push(flat, tail, k_new, s, move, C)
    tail = tail.scatter_add(-1, kk, mv)
    occ = occ.scatter_add(-1, kk, mv)
    if fr is not None:
        avail = _toggle(avail, j, kind == KIND_FLIP)
    new = StreamState(occ=occ, ring=flat.view(ring.shape), head=head, tail=tail, t=t,
                      avail=avail, t_c=t_c)
    j = torch.where(is_ext, n, j)
    return new, Event(j=j, k=k_new, t=t, slot=s, dt=dt, kind=kind), is_ext, u_ext


def merged_stream_step(state: StreamState, mu, ext_rate, xs, fr: FaultRates | None = None):
    """One event of the closed network merged with an external event class.

    ``ext_rate`` is the total rate of an independent open stream (the
    serving plane, `serving.serve_total_rate`) racing the closed network's
    clocks.  With all clocks exponential the merged system is a CTMC: the
    holding time is ``Exp(r_train + ext_rate)`` and the winner is external
    w.p. ``ext_rate / (r_train + ext_rate)``; the conditional uniforms
    handed to each side (``x / r_train`` and ``(x - r_train) / ext_rate``
    with ``x = u_race * tot``) are again uniform, so both sub-races stay
    exact in law.  An external win leaves the queues untouched and emits
    ``Event(j=n, slot=C, kind=KIND_SERVE)``, the flip's masking pattern.
    ``fr`` switches the closed side to the faulty 4n-clock race of
    `fault_stream_step`.  Returns ``(state', ev, is_ext, u_ext)``, ``u_ext``
    the external side's conditional uniform (meaningless unless
    ``is_ext``).
    """
    u_race, u_exp, k_new = xs
    dev = state.occ.device
    cst = _Consts(state.occ.shape[:-1], state.ring.shape[-1], dev)
    return _merged_stream_step(state, _f32(mu, dev), _f32(ext_rate, dev), _hold(u_exp, dev),
                               _f32(u_race, dev), torch.as_tensor(k_new, dtype=_I64, device=dev),
                               cst, fr)


class ScenarioRates(NamedTuple):
    """Device-resident tables of a resolved `ScenarioConfig`.

    ``acdf`` is the cumulative initial-stage distribution (inverse-CDF
    phase draws), ``srate`` / ``absorb`` / ``nxt`` the unit-mean stage chain
    of `ServiceLaw.chain`, ``q_off`` / ``q_on`` the per-node modulation
    intensities and ``rate_scale`` the service-speed multiplier while off.
    """

    acdf: Any        # (S,) float32: cumsum of alpha, tail pinned to 1
    srate: Any       # (S,) float32: stage clock rates (unit-mean chain)
    absorb: Any      # (S,) float32: 1.0 where firing completes service
    nxt: Any         # (S,) int64: successor stage otherwise
    q_off: Any       # (n,) float32: on -> off flip intensity
    q_on: Any        # (n,) float32: off -> on flip intensity
    rate_scale: Any  # () float32: service-speed multiplier while off


def _scenario_tables(scenario):
    from .scenario import ModulationConfig

    alpha, srate, absorb, nxt = scenario.service.chain()
    acdf = np.cumsum(alpha)
    acdf[-1] = max(acdf[-1], 1.0)  # guard an fp undershoot at the tail
    mod = scenario.modulation if scenario.modulation is not None else ModulationConfig()
    return acdf, srate, absorb, nxt, mod


def resolve_scenario(scenario, n: int, device="cuda") -> ScenarioRates:
    """`ScenarioConfig` -> dense `ScenarioRates` ((n,) modulation) on
    ``device``."""
    acdf, srate, absorb, nxt, mod = _scenario_tables(scenario)
    q_off, q_on = mod.resolve(n)
    f = lambda a: _table(a, _F32, device)  # noqa: E731
    return ScenarioRates(acdf=f(acdf), srate=f(srate), absorb=f(absorb),
                         nxt=_table(nxt, _I64, device), q_off=f(q_off), q_on=f(q_on),
                         rate_scale=f(mod.rate_scale))


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _class_values(rates, spec, what: str, group: str) -> list:
    """Each class's value of each per-node rate in ``rates`` ((name, (n,))
    pairs), as float64 (m,) arrays; a rate that varies within a speed class
    raises the reference's ValueError (the sparse idle pools need
    exchangeable nodes within a class)."""
    perm, offsets, counts = (_host(a) for a in (spec.perm, spec.offsets, spec.counts))
    out = []
    for name, r in rates:
        rc = np.asarray(r, np.float64)[perm]
        vals = rc[offsets]
        for c in range(counts.size):
            if not np.allclose(rc[offsets[c]: offsets[c] + counts[c]], vals[c]):
                raise ValueError(f"{what}.{name} varies within speed class {c}; the sparse "
                                 f"stream requires class-constant {group}")
        out.append(vals)
    return out


def resolve_scenario_classes(scenario, spec, device="cuda") -> ScenarioRates:
    """Class-level `resolve_scenario`: the modulation rates as ``(m,)``
    tensors.  Modulation must be constant within each speed class, as the
    fault rates must (`resolve_fault_rates_classes`)."""
    acdf, srate, absorb, nxt, mod = _scenario_tables(scenario)
    q_off, q_on = mod.resolve(spec.n)
    q_off, q_on = _class_values((("off_rate", q_off), ("on_rate", q_on)), spec,
                                "ModulationConfig", "modulation")
    f = lambda a: _table(a, _F32, device)  # noqa: E731
    return ScenarioRates(acdf=f(acdf), srate=f(srate), absorb=f(absorb),
                         nxt=_table(nxt, _I64, device), q_off=f(q_off), q_on=f(q_on),
                         rate_scale=f(mod.rate_scale))


def _phase_draw(acdf, u):
    """Inverse-CDF initial-stage draw from the (S,) cumulative alpha."""
    return torch.clamp_max(torch.searchsorted(acdf, u.contiguous(), right=True), acdf.shape[0] - 1)


def scenario_stream_init(nodes, n: int, C: int, sr: ScenarioRates, u_phase):
    """`stream_init` (every node available) plus the C initial phases,
    drawn from ``u_phase`` ((C,), or (B, C)).  Returns ``(state, nodes)``.

    A task's phase is drawn at dispatch (here: at the initial placement);
    the stage sequence is independent of the queue process, so this is
    law-identical to drawing at service start, and it is the host oracle's
    convention."""
    state, nodes = stream_init(nodes, n, C, fault=True)
    return state._replace(phase=_phase_draw(sr.acdf, _f32(u_phase, nodes.device))), nodes


def _scenario_speed(avail, sr: ScenarioRates):
    """The modulated service speed ``a + (1 - a) rate_scale``."""
    return avail + (1.0 - avail) * sr.rate_scale


def _scenario_stream_step(state: StreamState, mu, sr: ScenarioRates, e_hold, u_race, k_new,
                          u_ph, cst: _Consts):
    """`scenario_stream_step` on precomputed holding times (a chunk's)."""
    occ, ring, head, tail, avail, phase = (state.occ, state.ring, state.head, state.tail,
                                           state.avail, state.phase)
    C = cst.C
    n = occ.shape[-1]
    lead = occ.shape[:-1]
    busy = occ > 0
    flat = ring.reshape(*lead, -1)
    head_slots = flat.gather(-1, head % C + cst.cols)
    ph_head = phase.gather(-1, head_slots)
    r_serve = torch.where(busy, mu * torch.take(sr.srate, ph_head) * _scenario_speed(avail, sr),
                          0.0)
    rates = torch.cat([r_serve, torch.where(avail > 0, sr.q_off, sr.q_on)], dim=-1)
    rtree = tree_build(rates)
    # every node suspended: time still moves
    dt = e_hold / torch.clamp_min(rtree[..., 1], 1e-30)
    t, t_c = kahan_add(state.t, state.t_c, dt)
    idx = tree_sample(rtree, u_race)
    is_serve = idx < n
    j = torch.where(is_serve, idx, idx - n)
    s_head = _take(flat, torch.add(_take(head, j) % C, j, alpha=C))
    ph_j = _take(phase, s_head)
    complete = is_serve & (torch.take(sr.absorb, ph_j) > 0)
    kind = torch.where(complete, KIND_COMPLETE, torch.where(is_serve, KIND_STAGE, KIND_FLIP))
    # completions pop and re-dispatch; stages and flips carry slot C
    s = torch.where(complete, s_head, C)
    mv = complete.to(_I64)[..., None]
    jj, kk = j[..., None], k_new[..., None]
    head = head.scatter_add(-1, jj, mv)
    occ = occ.scatter_add(-1, jj, -mv)
    flat = _push(flat, tail, k_new, s, complete, C)
    tail = tail.scatter_add(-1, kk, mv)
    occ = occ.scatter_add(-1, kk, mv)
    # a completion's freed slot hosts the dispatched task (a fresh phase
    # draw), a stage advance steps the head task to nxt; a flip writes
    # the old phase back (the reference drops that write)
    ph_new = torch.where(complete, _phase_draw(sr.acdf, u_ph), torch.take(sr.nxt, ph_j))
    phase = phase.scatter(-1, s_head[..., None],
                          torch.where(is_serve, ph_new, ph_j)[..., None])
    avail = _toggle(avail, j, kind == KIND_FLIP)
    new = StreamState(occ=occ, ring=flat.view(ring.shape), head=head, tail=tail, t=t,
                      avail=avail, t_c=t_c, phase=phase)
    return new, Event(j=j, k=k_new, t=t, slot=s, dt=dt, kind=kind)


def scenario_stream_step(state: StreamState, mu, sr: ScenarioRates, xs):
    """One merged-CTMC event of the scenario closed network.

    The race runs over ``2n`` clocks:

      ``[ mu_i srate[phase_i] speed_i 1{X_i>0} | q_off_i a_i + q_on_i (1-a_i) ]``

    where ``phase_i`` is the stage of node i's head-of-line task and
    ``speed_i = a_i + (1-a_i) rate_scale`` the modulated service speed.  A
    serve-clock win is a task completion (KIND_COMPLETE: pop and
    re-dispatch, as in `fault_stream_step`) where ``absorb[phase]``, else a
    stage advance (KIND_STAGE: the head task steps to ``nxt[phase]``, no
    queue change, slot C).  Flips toggle availability like fault flips.
    ``xs = (u_race, u_exp, k_new, u_ph)``: ``u_ph`` draws the phase of the
    re-dispatched task.
    """
    u_race, u_exp, k_new, u_ph = xs
    dev = state.occ.device
    cst = _Consts(state.occ.shape[:-1], state.ring.shape[-1], dev, n=state.occ.shape[-1])
    return _scenario_stream_step(state, _f32(mu, dev), sr, _hold(u_exp, dev), _f32(u_race, dev),
                                 torch.as_tensor(k_new, dtype=_I64, device=dev), _f32(u_ph, dev),
                                 cst)


def stats_init(n: int, C: int, fault: bool = False, scenario: bool = False, *,
               cells: int | None = None, device="cuda") -> StatsState:
    """The stream's zeroed statistics on ``device`` (the card unless the
    caller asks for the CPU; `device.resolve_device` raises without one)."""
    device = resolve_device(device)
    lead = () if cells is None else (cells,)
    zi = lambda m: torch.zeros(*lead, m, dtype=_I64, device=device)  # noqa: E731
    zf = lambda: torch.zeros(*lead, n, dtype=_F32, device=device)  # noqa: E731
    tagged = bool(fault) or bool(scenario)
    return StatsState(occ_sum=zi(n), occ_tw=zf(), busy_t=zf(), comp=zi(n), delay_sum=zf(),
                      slot_step=zi(C), avail_tw=zf() if tagged else None,
                      kind_count=zi(N_KINDS if scenario else 4) if tagged else None,
                      occ_tw_c=zf(), busy_t_c=zf(), delay_sum_c=zf(),
                      avail_tw_c=zf() if tagged else None)


def _stats_step(stats: StatsState, ev: Event, occ_pre, occ_post, k, delay, cst: _Consts,
                busy=None, at=None):
    """`stats_step` given the step's integer delay ``k - slot_step[slot]``;
    the sparse stream's passes its per-class ``busy`` exposure over ``ev.dt``
    and the completing node's class ``at`` (default: ``1{X > 0} dt`` at
    node ``ev.j``)."""
    dt = ev.dt[..., None]
    at = ev.j if at is None else at
    occ_tw, occ_tw_c = kahan_add(stats.occ_tw, stats.occ_tw_c, torch.mul(occ_pre, dt))
    busy_t, busy_t_c = kahan_add(stats.busy_t, stats.busy_t_c,
                                 torch.where(occ_pre > 0, dt, 0.0) if busy is None else busy)
    delay_sum, delay_sum_c = _kahan_scatter_add(stats.delay_sum, stats.delay_sum_c, at,
                                                delay.to(_F32))
    return StatsState(
        occ_sum=stats.occ_sum + occ_post,
        occ_tw=occ_tw,
        busy_t=busy_t,
        comp=stats.comp.scatter_add(-1, at[..., None], cst.one),
        delay_sum=delay_sum,
        slot_step=stats.slot_step.scatter(-1, ev.slot[..., None], k + 1),
        occ_tw_c=occ_tw_c,
        busy_t_c=busy_t_c,
        delay_sum_c=delay_sum_c,
    )


def stats_step(stats: StatsState, ev: Event, occ_pre, occ_post, k) -> StatsState:
    """Accumulate observables for step k (0-based): ``occ_pre`` persisted
    over ``ev.dt`` (its time integral is what product form predicts),
    ``occ_post`` is the X_{i,k} the Palm accumulators count."""
    cst = _Consts(occ_pre.shape[:-1], stats.slot_step.shape[-1], occ_pre.device)
    delay = k - _take(stats.slot_step, ev.slot)
    return _stats_step(stats, ev, occ_pre, occ_post, k, delay, cst)


def _delay(stats: StatsState, slot, k: int, C: int):
    """``k - slot_step[slot]`` with the reference's clamp at the trash slot
    C (a flip or stage event reads slot C - 1's dispatch step)."""
    return k - _take(stats.slot_step, torch.clamp_max(slot, C - 1))


def _exposure(occ_pre, avail_pre, dt, speed_pre=None):
    """The (n,) busy time a tagged event adds over ``dt``: ``1{X > 0 and
    available} dt`` on the fault stream, ``speed 1{X > 0} dt`` on the
    scenario stream (``speed_pre``, the modulated speed)."""
    if speed_pre is None:
        return torch.where((occ_pre > 0) & (avail_pre > 0), dt, 0.0)
    return torch.where(occ_pre > 0, speed_pre, 0.0) * dt


def _tagged_stats_step(stats: StatsState, ev: Event, occ_pre, busy_pre, avail_pre, occ_post,
                       k: int, delay, C: int, at=None):
    """The fault and scenario stats step: ``busy_pre`` is the (n,) exposure
    integrated over ``ev.dt`` (`_exposure`); the sparse stream's passes
    per-class counts and the completing node's class ``at``."""
    dt = ev.dt[..., None]
    at = ev.j if at is None else at
    comp = ev.kind == KIND_COMPLETE
    occ_tw, occ_tw_c = kahan_add(stats.occ_tw, stats.occ_tw_c, torch.mul(occ_pre, dt))
    busy_t, busy_t_c = kahan_add(stats.busy_t, stats.busy_t_c, busy_pre)
    delay_sum, delay_sum_c = _kahan_scatter_add(stats.delay_sum, stats.delay_sum_c, at,
                                                delay.to(_F32) * comp.to(_F32))
    avail_tw, avail_tw_c = kahan_add(stats.avail_tw, stats.avail_tw_c, avail_pre * dt)
    # any task movement refreshes its slot's dispatch step; a flip or stage
    # event writes the old value back (the reference drops the write)
    sl = torch.clamp_max(ev.slot, C - 1)[..., None]
    slot_step = stats.slot_step.scatter(
        -1, sl, torch.where((ev.slot < C)[..., None], k + 1, stats.slot_step.gather(-1, sl)))
    return StatsState(
        occ_sum=stats.occ_sum + occ_post,
        occ_tw=occ_tw,
        busy_t=busy_t,
        comp=stats.comp.scatter_add(-1, at[..., None], comp.to(_I64)[..., None]),
        delay_sum=delay_sum,
        slot_step=slot_step,
        avail_tw=avail_tw,
        kind_count=stats.kind_count.scatter_add(-1, ev.kind[..., None],
                                                torch.ones_like(ev.kind)[..., None]),
        occ_tw_c=occ_tw_c,
        busy_t_c=busy_t_c,
        delay_sum_c=delay_sum_c,
        avail_tw_c=avail_tw_c,
    )


def fault_stats_step(stats: StatsState, ev: Event, occ_pre, avail_pre, occ_post,
                     k) -> StatsState:
    """Fault-aware `stats_step`: completions and delays count only
    KIND_COMPLETE events, ``busy_t`` integrates ``1{X_i > 0 and
    available}`` (the time a node was serving, so `estimate_mu` stays
    unbiased under churn), and the availability integral and the (4,) kind
    counts accumulate.  Any task movement refreshes ``slot_step`` (a crash
    or timeout re-dispatch resets staleness); a flip carries slot C."""
    C = stats.slot_step.shape[-1]
    return _tagged_stats_step(stats, ev, occ_pre, _exposure(occ_pre, avail_pre, ev.dt[..., None]),
                              avail_pre, occ_post, k, _delay(stats, ev.slot, k, C), C)


def scenario_stats_step(stats: StatsState, ev: Event, occ_pre, avail_pre, speed_pre, occ_post,
                        k) -> StatsState:
    """Scenario-aware `stats_step`: as `fault_stats_step`, but ``busy_t``
    integrates the modulated exposure ``speed_i 1{X_i > 0}`` (in the time
    change ``dtau = speed dt`` the head task's stages are the unmodulated
    unit-mean chain at rate mu_i, so ``comp / busy_t -> mu``), and
    ``kind_count`` is the full (N_KINDS,) histogram (stage advances are
    tag 5)."""
    C = stats.slot_step.shape[-1]
    busy = _exposure(occ_pre, avail_pre, ev.dt[..., None], speed_pre)
    return _tagged_stats_step(stats, ev, occ_pre, busy, avail_pre, occ_post, k,
                              _delay(stats, ev.slot, k, C), C)


def _merged_stats(stats: StatsState, ev: Event, occ_pre, avail_pre, occ_post, k, n: int,
                  cst: _Consts):
    """`merged_stats_step` given the ring width in ``cst``: ``(stats,
    delay)``.  An external event (``j == n``) leaves the per-node counters,
    the delay sum, the dispatch steps and the kind counts as they were
    (the reference drops those scatters out of range) and integrates the
    occupancy, busy time and availability over its ``dt`` like any event."""
    C = cst.C
    live = ev.j < n
    at = torch.clamp_max(ev.j, n - 1)
    dt = ev.dt[..., None]
    delay = _delay(stats, ev.slot, k, C)
    count = live if avail_pre is None else live & (ev.kind == KIND_COMPLETE)
    occ_tw, occ_tw_c = kahan_add(stats.occ_tw, stats.occ_tw_c, torch.mul(occ_pre, dt))
    if avail_pre is None:
        busy = torch.where(occ_pre > 0, dt, 0.0)
        x = delay.to(_F32)
    else:
        busy = _exposure(occ_pre, avail_pre, dt)
        x = delay.to(_F32) * count.to(_F32)
    busy_t, busy_t_c = kahan_add(stats.busy_t, stats.busy_t_c, busy)
    sd_, cd_ = _kahan_scatter_add(stats.delay_sum, stats.delay_sum_c, at, x)
    keep = live[..., None]
    delay_sum = torch.where(keep, sd_, stats.delay_sum)
    delay_sum_c = torch.where(keep, cd_, stats.delay_sum_c)
    sl = torch.clamp_max(ev.slot, C - 1)[..., None]
    slot_step = stats.slot_step.scatter(
        -1, sl, torch.where((ev.slot < C)[..., None], k + 1, stats.slot_step.gather(-1, sl)))
    out = stats._replace(
        occ_sum=stats.occ_sum + occ_post, occ_tw=occ_tw, busy_t=busy_t,
        comp=stats.comp.scatter_add(-1, at[..., None], count.to(_I64)[..., None]),
        delay_sum=delay_sum, slot_step=slot_step, occ_tw_c=occ_tw_c, busy_t_c=busy_t_c,
        delay_sum_c=delay_sum_c)
    if avail_pre is not None:
        avail_tw, avail_tw_c = kahan_add(stats.avail_tw, stats.avail_tw_c, avail_pre * dt)
        K = stats.kind_count.shape[-1]
        kc = ev.kind[..., None]
        out = out._replace(
            avail_tw=avail_tw, avail_tw_c=avail_tw_c,
            kind_count=stats.kind_count.scatter_add(-1, torch.clamp_max(kc, K - 1),
                                                    (kc < K).to(_I64)))
    return out, delay


def merged_stats_step(stats: StatsState, ev: Event, occ_pre, avail_pre, occ_post,
                      k) -> StatsState:
    """The statistics of one `merged_stream_step` event: `stats_step`'s
    (``avail_pre`` None) or `fault_stats_step`'s, where an external event
    (``j = n``, slot C, `KIND_SERVE`) changes no per-node counter, delay
    sum, dispatch step or kind count, as the reference's out-of-range
    scatters drop, while the time integrals run over its ``dt``."""
    n = occ_pre.shape[-1]
    cst = _Consts(occ_pre.shape[:-1], stats.slot_step.shape[-1], occ_pre.device)
    return _merged_stats(stats, ev, occ_pre, avail_pre, occ_post, k, n, cst)[0]


# ---------------------------------------------------------------------- #
# the scan harness: T fused steps of stream_step + stats_step
# ---------------------------------------------------------------------- #
def _dense_event(state, stats, mu, e_hold, u_race, k_new, u_ph, k: int, cst, need_stats: bool,
                 fr, sr):
    """One event of the dense stream and its statistics: ``(state, stats,
    ev, delay)`` (delay None without stats)."""
    occ_pre, avail_pre, speed_pre = state.occ, state.avail, None
    if sr is not None:
        speed_pre = _scenario_speed(avail_pre, sr)
        state, ev = _scenario_stream_step(state, mu, sr, e_hold, u_race, k_new, u_ph, cst)
    elif fr is not None:
        state, ev = _fault_stream_step(state, mu, fr, e_hold, u_race, k_new, cst)
    else:
        state, ev = _stream_step(state, mu, e_hold, u_race, k_new, cst)
    if not need_stats:
        return state, stats, ev, None
    if sr is None and fr is None:
        delay = k - _take(stats.slot_step, ev.slot)
        return state, _stats_step(stats, ev, occ_pre, state.occ, k, delay, cst), ev, delay
    delay = _delay(stats, ev.slot, k, cst.C)
    busy = _exposure(occ_pre, avail_pre, ev.dt[..., None], speed_pre)
    stats = _tagged_stats_step(stats, ev, occ_pre, busy, avail_pre, state.occ, k, delay, cst.C)
    return state, stats, ev, delay


def _merged_event(state, stats, mu, e_hold, u_race, k_new, k: int, cst, need_stats: bool, fr,
                  serve):
    """One event of the dense stream merged with the serving plane
    (``serve``, a `serving.ServeLoop`): the race against its current rate,
    the statistics, then the serving table's transition."""
    occ_pre, avail_pre = state.occ, state.avail
    state, ev, is_ext, u_ext = _merged_stream_step(state, mu, serve.rate(), e_hold, u_race,
                                                   k_new, cst, fr)
    delay = None
    if need_stats:
        stats, delay = _merged_stats(stats, ev, occ_pre, avail_pre, state.occ, k,
                                     occ_pre.shape[-1], cst)
    serve.step(ev.dt, ev.t, is_ext, u_ext)
    return state, stats, ev, delay


def _advance(state, stats, mu, e_hold, u_race, K, k0: int, cst, need_stats=True, on_event=None,
             fr=None, sr=None, u_ph=None, spec=None, u_bit=None, serve=None):
    """Advance the network over one block of pre-drawn inputs.

    ``e_hold``, ``u_race``, ``K`` (and the scenario stream's ``u_ph``) are
    ``(L,)`` (or ``(B, L)``); ``fr`` (`FaultRates`) selects the fault
    stream, ``sr`` (`ScenarioRates`) the scenario stream, and ``spec`` (a
    `ClassSpec` with int64 tables on the device, `_spec_on`) the sparse
    stream, whose tagged streams also take the availability-bit uniforms
    ``u_bit``.  ``serve`` (a `serving.ServeLoop`) merges the serving plane
    into the dense race (`merged_stream_step`; with or without ``fr``).
    Returns the new ``(state, stats)`` and the stacked ``(J, t, slot,
    delay, kind)`` columns (delay None without stats, kind None on the
    plain stream).  ``on_event(i, ev)`` runs after each event's stream
    step (the fused runner's slot-scale bookkeeping).
    """
    L = K.shape[-1]
    Js, ts, ss, ds, ks = [], [], [], [], []
    for i in range(L):
        if serve is not None:
            state, stats, ev, delay = _merged_event(
                state, stats, mu, e_hold[..., i], u_race[..., i], K[..., i], k0 + i, cst,
                need_stats, fr, serve)
        elif spec is not None:
            state, stats, ev, delay = _sparse_event(
                state, stats, mu, spec, e_hold[..., i], u_race[..., i], K[..., i],
                None if u_bit is None else u_bit[..., i], None if u_ph is None else u_ph[..., i],
                k0 + i, cst, need_stats, fr, sr)
        else:
            state, stats, ev, delay = _dense_event(
                state, stats, mu, e_hold[..., i], u_race[..., i], K[..., i],
                None if u_ph is None else u_ph[..., i], k0 + i, cst, need_stats, fr, sr)
        if need_stats:
            ds.append(delay)
        if on_event is not None:
            on_event(i, ev)
        Js.append(ev.j)
        ts.append(ev.t)
        ss.append(ev.slot)
        if fr is not None or sr is not None or serve is not None:
            ks.append(ev.kind)
    st = lambda xs: torch.stack(xs, dim=-1) if xs else None  # noqa: E731
    return state, stats, (st(Js), st(ts), st(ss), st(ds), st(ks))


def _resolve_modes(fault, scenario, n: int, device):
    """``(fr, sr)``: the resolved fault rates and scenario tables of a run
    (None where off); a disabled config is off, so it takes the plain
    stream, bitwise.  Fault and scenario exclude each other."""
    fr = sr = None
    if isinstance(fault, FaultRates):
        fr = fault
    elif _enabled(fault):
        fr = resolve_fault_rates(fault, n, device)
    if isinstance(scenario, ScenarioRates):
        sr = scenario
    elif _enabled(scenario):
        sr = resolve_scenario(scenario, n, device)
    if fr is not None and sr is not None:
        raise ValueError("fault= and scenario= are mutually exclusive")
    return fr, sr


def scan_draws(mu, nodes, u_race, u_exp, K, emit_events: bool = True, fault=None, scenario=None,
               u_ph=None, u_phase0=None, serving=None):
    """The stream over pre-drawn inputs: the reference's ``xs``.

    ``nodes`` (the initial placement, ``(C,)`` or ``(B, C)``), ``u_race``,
    ``u_exp`` and ``K`` (``(T,)`` or ``(B, T)``) are given, so parity tests
    pass the reference's own draws (`jax.random.split(key, 4)`, then
    ``stream_init`` and the three uniform blocks) and get its J, K, slot and
    delays bitwise.  ``fault`` (a `FaultConfig` or `FaultRates`) runs the
    fault stream; ``scenario`` (a `ScenarioConfig` or `ScenarioRates`) the
    scenario stream, which also takes the dispatch-phase uniforms ``u_ph``
    (like ``K``) and the initial-phase uniforms ``u_phase0`` (like
    ``nodes``).  ``serving`` (a `serving.ServingConfig`) merges the serving
    plane's open stream into the race (`merged_stream_step`, with or
    without ``fault``) and advances its request table with the stream;
    there is no replay here, so the known-good pointer stays at its start
    and the read path's checksum and staleness are not taken.  Returns
    ``(nodes, events, stats)`` with ``events = (J, K, t, slot, delay)``
    tensors (plus ``kind`` with a fault, a scenario or serving), or None
    without ``emit_events``; with ``serving`` a fourth entry, the final
    ``(ServeState, ServeStats)``.
    """
    mu = torch.as_tensor(mu)
    dev = mu.device
    nodes = torch.as_tensor(nodes, device=dev).to(_I64)
    n, C = mu.shape[-1], nodes.shape[-1]
    lead = nodes.shape[:-1]
    mu = mu.to(_F32).expand(*lead, n)
    fr, sr = _resolve_modes(fault, scenario, n, dev)
    if sr is not None:
        state, nodes = scenario_stream_init(nodes, n, C, sr, u_phase0)
        u_ph = _f32(u_ph, dev)
    else:
        state, nodes = stream_init(nodes, n, C, fault=fr is not None)
    stats = stats_init(n, C, fault=fr is not None, scenario=sr is not None,
                       cells=lead[0] if lead else None, device=dev)
    u_race = torch.as_tensor(u_race, device=dev).to(_F32)
    e_hold = _hold(torch.as_tensor(u_exp, device=dev), dev)
    K = torch.as_tensor(K, device=dev).to(_I64)
    cst = _Consts(lead, C, dev, n=n)
    serve = None
    if serving is not None and serving.enabled:
        if sr is not None:
            raise ValueError("scenario= does not compose with serving=")
        from .serving import ServeLoop, serve_init, serve_stats_init

        cells = lead[0] if lead else None
        serve = ServeLoop(serving.validate(), serve_init(serving, cells=cells, device=dev),
                          serve_stats_init(cells=cells, device=dev))
    _, stats, (J, t, slot, delay, kind) = _advance(state, stats, mu, e_hold, u_race, K, 0, cst,
                                                   fr=fr, sr=sr, u_ph=u_ph, serve=serve)
    events = (J, K, t, slot, delay) + ((kind,) if kind is not None else ())
    out = (nodes, (events if emit_events else None), stats)
    return out if serve is None else out + ((serve.sv, serve.stats),)


def _generator(seed, device) -> torch.Generator:
    """``seed`` (an int) as a `torch.Generator` on ``device``, or the
    generator itself."""
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


def draw_uniforms(seed, n: int, C: int, T: int, p, init: str = "distinct", device="cuda",
                  scenario: bool = False):
    """One cell's draws from the port's generator, in the reference's order:
    ``(nodes (C,), u_race (T,), u_exp (T,), u_disp (T,))`` on ``device``;
    with ``scenario`` then ``u_ph (T,)``, the dispatch-phase uniforms, and
    ``u_phase0 (C,)``, the initial phases'."""
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    p = torch.as_tensor(np.asarray(p) if not isinstance(p, torch.Tensor) else p).to(
        device=dev, dtype=_F32)
    nodes = _init_nodes(gen, n, C, p, init)
    u_race, u_exp, u_disp = (torch.rand(T, generator=gen, device=dev) for _ in range(3))
    if not scenario:
        return nodes, u_race, u_exp, u_disp
    u_ph = torch.rand(T, generator=gen, device=dev)
    return nodes, u_race, u_exp, u_disp, u_ph, torch.rand(C, generator=gen, device=dev)


def _inputs(mu, p, C: int, T: int, seed, init: str, device, scenario: bool = False):
    mu = np.asarray(mu, dtype=np.float64)
    p = np.asarray(p, dtype=np.float64)
    if abs(p.sum() - 1.0) > 1e-8:
        raise ValueError("p must sum to 1")
    dev = resolve_device(device)
    n = mu.size
    p_t = torch.as_tensor(p, dtype=_F32, device=dev)
    nodes, u_race, u_exp, u_disp, *ph = draw_uniforms(seed, n, C, T, p_t, init, dev,
                                                      scenario=scenario)
    K = tree_sample(tree_build(p_t), u_disp)
    return torch.as_tensor(mu, dtype=_F32, device=dev), p, nodes, u_race, u_exp, K, ph


def stats_stream_fn(n: int, C: int, T: int, init: str = "distinct", fault: bool = False,
                    scenario: bool = False):
    """Stats-only network run: ``gen(seed, mu, p, device="cuda") ->
    StatsState`` (no per-event outputs), the observables the control loop
    and the stream benchmarks consume.  With ``fault`` or ``scenario`` it
    is ``gen(seed, mu, p, fr, device="cuda")``, ``fr`` the
    `resolve_fault_rates` / `resolve_scenario` tables (or the configs)."""
    if fault and scenario:
        raise ValueError("fault and scenario streams are mutually exclusive")

    def run(seed, mu, p, fr, device):
        mu_t, _, nodes, u_race, u_exp, K, ph = _inputs(mu, p, C, T, seed, init, device,
                                                       scenario=scenario)
        if mu_t.shape[-1] != n:
            raise ValueError(f"mu has {mu_t.shape[-1]} clients, the function was made for {n}")
        return scan_draws(mu_t, nodes, u_race, u_exp, K, emit_events=False,
                          fault=fr if fault else None, scenario=fr if scenario else None,
                          u_ph=ph[0] if ph else None, u_phase0=ph[1] if ph else None)[2]

    if fault or scenario:
        return lambda seed, mu, p, fr, device="cuda": run(seed, mu, p, fr, device)
    return lambda seed, mu, p, device="cuda": run(seed, mu, p, None, device)


def generate_stream(mu, p, C: int, T: int, seed: int | torch.Generator = 0,
                    init: str = "distinct", fault=None, scenario=None,
                    device="cuda") -> EventStream:
    """Simulate T CS steps on ``device`` and export a host `EventStream`.

    Drop-in for `queue_sim.export_stream` (exponential service, or a
    ``scenario``'s phase-type law): same arrays, same invariants, a
    different but law-identical realization.  ``seed`` is an int or a
    `torch.Generator` on ``device``.  With ``fault`` (a `FaultConfig`) or
    ``scenario`` (a `ScenarioConfig`, exclusive with ``fault``) the stream
    carries a kind column and T counts merged events, flips and stage
    advances included, as `queue_sim.export_stream` counts them.  A
    disabled config gives the plain stream, bitwise.
    """
    dev = resolve_device(device)
    n = np.asarray(mu).size
    fr, sr = _resolve_modes(fault, scenario, n, dev)
    mu_t, p, nodes, u_race, u_exp, K, ph = _inputs(mu, p, C, T, seed, init, device,
                                                   scenario=sr is not None)
    nodes, events, stats = scan_draws(mu_t, nodes, u_race, u_exp, K, fault=fr, scenario=sr,
                                      u_ph=ph[0] if ph else None,
                                      u_phase0=ph[1] if ph else None)
    J, K, t, slot, delay = events[:5]
    kind = events[5] if len(events) > 5 else None
    return EventStream(
        J=J.cpu().numpy().astype(np.int32),
        K=K.cpu().numpy().astype(np.int32),
        t=t.cpu().numpy().astype(np.float64),
        slot=slot.cpu().numpy().astype(np.int32),
        init_nodes=nodes.cpu().numpy().astype(np.int32),
        n=int(mu_t.shape[-1]),
        C=int(C),
        p=p.copy(),
        delay_steps=delay.cpu().numpy().astype(np.int64),
        queue_len_sum=stats.occ_sum.cpu().numpy().astype(np.float64),
        queue_len_tw=kahan_value(stats.occ_tw, stats.occ_tw_c),
        kind=None if kind is None else kind.cpu().numpy().astype(np.int8),
    )


def generate_blocks(mu, p, C: int, T: int, block_size: int, seed: int | torch.Generator = 0,
                    init: str = "distinct", cut_every: int = 0, method: str = "greedy",
                    fault=None, scenario=None, device="cuda") -> EventBlocks:
    """The device-generated stream cut into conflict-free ``(B, E)``
    micro-blocks by `queue_sim.segment_blocks`: the blocked engine's feed."""
    return EventBlocks.from_stream(
        generate_stream(mu, p, C, T, seed=seed, init=init, fault=fault, scenario=scenario,
                        device=device),
        block_size, cut_every, method,
    )


# ---------------------------------------------------------------------- #
# the sparse O(C) closed network: state keyed by the C in-flight tasks of a
# population of few speed classes
# ---------------------------------------------------------------------- #
#: the FIFO stamp no slot reaches (the reference's int32 2**31 - 1 sentinel,
#: here on int64 stamps): sorts after every real stamp
_SEQ_LAST = torch.iinfo(torch.int64).max


def _same_device(t: torch.Tensor, dev: torch.device) -> bool:
    return t.device.type == dev.type and (dev.index is None or t.device.index == dev.index)


def _spec_on(spec: ClassSpec, device) -> ClassSpec:
    """``spec`` with its tables as int64 tensors on ``device`` (the index
    dtype of torch's gathers); a spec already there is returned as it is.
    Built once a run: the steps take it as it is."""
    dev = torch.device(device)
    if (isinstance(spec.perm, torch.Tensor) and spec.perm.dtype == _I64
            and _same_device(spec.perm, dev)):
        return spec
    return ClassSpec(*(a.to(device=dev, dtype=_I64) if isinstance(a, torch.Tensor)
                       else _table(a, _I64, dev) for a in spec))


def resolve_fault_rates_classes(fault, spec: ClassSpec, device="cuda") -> FaultRates:
    """Class-level `resolve_fault_rates`: ``(kappa, theta, q_off, q_on)`` as
    ``(m,)`` float32 tensors on ``device``.  The rates must be constant
    within each speed class (the exchangeability the sparse idle pools rely
    on): a rate that varies within a class raises the reference's
    ValueError."""
    q_off, q_on, kappa, theta = fault.resolve(spec.n)
    vals = _class_values((("crash_rate", kappa), ("timeout_rate", theta),
                          ("off_rate", q_off), ("on_rate", q_on)), spec,
                         "FaultConfig", "fault rates")
    return FaultRates(*(_table(v, _F32, device) for v in vals))


class SparseStreamState(NamedTuple):
    """Sparse state of the closed network: O(C + m), not O(n C).

    Each of the C circulating tasks is one slot; FIFO order within a node is
    the monotone ``seq`` stamp and ``head`` marks the head-of-line task (one
    per busy node).  Under faults the availability is carried per slot (the
    same on every slot of a node) and the idle nodes as per-class ``(idle_on,
    idle_off)`` counts: within a class idle nodes are exchangeable, so the
    collapse is exact in law for every per-class observable.  Integer state
    is int64 where the reference keeps int32.
    """

    node: Any      # (C,) int64: global client id of each in-flight task
    cls: Any       # (C,) int64: speed class of that node
    seq: Any       # (C,) int64: dispatch stamp (FIFO: head = min seq per node)
    head: Any      # (C,) bool: head-of-line flag
    t: Any         # () float32: physical time (Kahan sum; see t_c)
    t_c: Any       # () float32
    next_seq: Any  # () int64: the next dispatch stamp
    avail: Any = None     # (C,) float32: availability bit of the slot's node
    idle_on: Any = None   # (m,) int64: idle and available nodes per class
    idle_off: Any = None  # (m,) int64: idle and unavailable nodes per class
    phase: Any = None     # (C,) int64: service stage of each slot's task
                          # (scenario mode; else None)


def _gather_cls(v, cls):
    """``v[cls]`` for a per-class vector ``v`` ((m,) or with the leading
    axes of ``cls``)."""
    return v.expand(*cls.shape[:-1], v.shape[-1]).gather(-1, cls)


def _add_at(v, i, x):
    """``v.at[i].add(x)`` for one index per leading position (integers:
    exact in any order)."""
    return v.scatter_add(-1, i[..., None], x[..., None])


def sample_dispatch_classes(p, spec: ClassSpec, u_cls, u_mem):
    """Dispatch draws K ~ p for a class-structured population: the class
    from the (m,) mass vector ``counts * p`` (fp32) by segment-tree descent,
    then a uniform member ``min(int(u_mem * counts[c]), counts[c] - 1)``
    (the product in fp32, as in the reference: a float64 product would
    choose another member for some uniforms).  ``p`` is the (m,) per-node
    probability by class (or (B, m)); returns global client ids shaped like
    ``u_cls``."""
    p = torch.as_tensor(p)
    dev = p.device
    sp = _spec_on(spec, dev)
    mass = sp.counts.to(_F32) * p.to(_F32)
    c = tree_sample(tree_build(mass), _f32(u_cls, dev))
    cnt = torch.take(sp.counts, c)
    member = torch.minimum((_f32(u_mem, dev) * cnt.to(_F32)).to(_I64), cnt - 1)
    return torch.take(sp.perm, torch.take(sp.offsets, c) + member)


def _rank_bump(ranks: torch.Tensor, n: int) -> torch.Tensor:
    """A uniform C-subset of ``range(n)`` from C ranks, ``ranks[i]`` uniform
    on ``[0, n - i)``: the i-th id is the ``ranks[i]``-th smallest id not
    yet chosen, found by bumping the rank past every chosen id at or below
    it (the reference's rank-bump, O(C^2), never an O(n) permutation).
    Over the chosen ids sorted, ``s_j``, the bump passes exactly those with
    ``s_j - j <= rank``, a prefix; so each draw is one sort and one count."""
    C = ranks.shape[-1]
    pos = torch.arange(C, dtype=_I64, device=ranks.device)
    chosen = torch.full_like(ranks, n)  # the sentinels n sort last
    for i in range(C):
        s = torch.sort(chosen).values
        r = ranks[i] + ((s - pos <= ranks[i]) & (pos < i)).sum()
        chosen = torch.where(pos == i, r, chosen)
    return chosen


def _init_sparse_nodes(gen: torch.Generator, spec: ClassSpec, C: int, p: torch.Tensor,
                       init: str) -> torch.Tensor:
    """The initial placement of the C tasks, drawn from ``gen`` in O(C^2)
    without an (n,) tensor: ``"distinct"`` a uniform C-subset by the
    rank-bump draw (round-robin when C > n), ``"sampled"`` C draws of
    `sample_dispatch_classes` from the (m,) class-level ``p``."""
    dev = p.device
    n = spec.n
    if init == "distinct":
        if C > n:
            return torch.arange(C, dtype=_I64, device=dev) % n
        hi = n - torch.arange(C, dtype=_I64, device=dev)
        u = torch.rand(C, dtype=torch.float64, generator=gen, device=dev)
        return _rank_bump(torch.minimum((u * hi).to(_I64), hi - 1), n)
    if init == "sampled":
        u_cls = torch.rand(C, generator=gen, device=dev)
        return sample_dispatch_classes(p, spec, u_cls, torch.rand(C, generator=gen, device=dev))
    raise ValueError(init)


def sparse_stream_init(nodes, spec: ClassSpec, C: int, fault: bool = False):
    """The sparse state with the C tasks at ``nodes`` ((C,) or (B, C)):
    task s is head of line where no earlier slot holds its node; with
    ``fault`` every node starts available and each class's idle nodes sit
    in its ``idle_on`` pool.  Returns ``(state, nodes)``."""
    nodes = torch.as_tensor(nodes).to(_I64)
    dev = nodes.device
    sp = _spec_on(spec, dev)
    lead = nodes.shape[:-1]
    eq = nodes[..., None, :] == nodes[..., :, None]
    head = torch.tril(eq, -1).sum(-1) == 0
    cls = torch.take(sp.inv_cls, nodes)
    avail = idle_on = idle_off = None
    if fault:
        busy = torch.zeros(*lead, sp.m, dtype=_I64, device=dev).scatter_add(-1, cls,
                                                                             head.to(_I64))
        idle_on = sp.counts - busy
        idle_off = torch.zeros_like(idle_on)
        avail = torch.ones(*lead, C, dtype=_F32, device=dev)
    zero = torch.zeros(lead, dtype=_F32, device=dev)
    state = SparseStreamState(
        node=nodes, cls=cls, seq=torch.arange(C, dtype=_I64, device=dev).expand(nodes.shape),
        head=head, t=zero, t_c=zero.clone(),
        next_seq=torch.full(lead, C, dtype=_I64, device=dev),
        avail=avail, idle_on=idle_on, idle_off=idle_off)
    return state, nodes


def class_occupancy(cls, m: int):
    """(m,) int64 per-class task counts from the (C,) slot classes."""
    return torch.zeros(*cls.shape[:-1], m, dtype=_I64, device=cls.device).scatter_add(
        -1, cls, torch.ones_like(cls))


def sparse_class_stats(state: SparseStreamState, m: int, fault: bool = False):
    """Per-class ``(occupancy, busy nodes, available nodes or None)``:
    ``busy`` counts heads (one per busy node), under faults only available
    ones (`estimate_mu`'s exposure), and ``avail`` the available heads plus
    the idle-on pool."""
    occ = class_occupancy(state.cls, m)
    h = state.head.to(_I64)
    if fault:
        h = h * (state.avail > 0).to(_I64)
    busy = torch.zeros_like(occ).scatter_add(-1, state.cls, h)
    return occ, busy, (busy + state.idle_on if fault else None)


def sparse_scenario_class_stats(state: SparseStreamState, m: int, rate_scale):
    """Per-class ``(occupancy, modulated busy exposure, available nodes)``:
    ``busy`` is the float ``sum over heads of the speed``, the denominator
    that keeps `estimate_mu` unbiased under modulation."""
    occ = class_occupancy(state.cls, m)
    hf = state.head.to(_F32)
    speed = state.avail + (1.0 - state.avail) * rate_scale
    busy = torch.zeros(occ.shape, dtype=_F32, device=occ.device).scatter_add(-1, state.cls,
                                                                             hf * speed)
    ha = state.head.to(_I64) * (state.avail > 0).to(_I64)
    return occ, busy, torch.zeros_like(occ).scatter_add(-1, state.cls, ha) + state.idle_on


def _race(rates, e_hold, state, floor: bool):
    """The race's tree, holding time and clock: ``(rtree, dt, t, t_c)``;
    ``floor`` keeps time moving when no clock runs (all nodes off)."""
    rtree = tree_build(rates)
    tot = torch.clamp_min(rtree[..., 1], 1e-30) if floor else rtree[..., 1]
    dt = e_hold / tot
    t, t_c = kahan_add(state.t, state.t_c, dt)
    return rtree, dt, t, t_c


def _sparse_stream_step(state: SparseStreamState, mu, sp: ClassSpec, e_hold, u_race, k_new,
                        cst: _Consts):
    """`sparse_stream_step` on a precomputed holding time (a chunk's)."""
    node, cls, seq, head = state.node, state.cls, state.seq, state.head
    ar = cst.ar
    rtree, dt, t, t_c = _race(torch.where(head, _gather_cls(mu, cls), 0.0), e_hold, state, False)
    s = tree_sample(rtree, u_race)
    j = _take(node, s)
    at_s = ar == s[..., None]
    # promote j's next-oldest task (if any) to head of line
    others = (node == j[..., None]) & ~at_s
    has_succ = others.any(-1)
    succ = torch.where(others, seq, _SEQ_LAST).argmin(-1)
    head = (head & ~at_s) | ((ar == succ[..., None]) & has_succ[..., None])
    # the freed slot hosts the dispatch; join-or-fresh by O(C) membership
    exists_k = ((node == k_new[..., None]) & ~at_s).any(-1)
    new = state._replace(
        node=torch.where(at_s, k_new[..., None], node),
        cls=torch.where(at_s, torch.take(sp.inv_cls, k_new)[..., None], cls),
        seq=torch.where(at_s, state.next_seq[..., None], seq),
        head=torch.where(at_s, ~exists_k[..., None], head),
        t=t, t_c=t_c, next_seq=state.next_seq + 1)
    return new, Event(j=j, k=k_new, t=t, slot=s, dt=dt)


def sparse_stream_step(state: SparseStreamState, mu, spec: ClassSpec, xs):
    """One CS step of the sparse closed network, O(C + log m).

    ``xs = (u_race, u_exp, k_new)`` as in `stream_step`; ``mu`` is the (m,)
    class rate vector.  The completion race runs over the <= C head-of-line
    tasks only (each busy node has exactly one head), so nothing scales
    with n."""
    u_race, u_exp, k_new = xs
    dev = state.node.device
    cst = _Consts(state.node.shape[:-1], state.node.shape[-1], dev)
    return _sparse_stream_step(state, _f32(mu, dev), _spec_on(spec, dev), _hold(u_exp, dev),
                               _f32(u_race, dev), torch.as_tensor(k_new, dtype=_I64, device=dev),
                               cst)


def _sparse_relocate(state: SparseStreamState, sp: ClassSpec, k_new, u_bit, move, s_mv, is_bf,
                     s_bf, is_if, on2off, if_c, named, cst: _Consts):
    """The task movement, availability flips and idle pools of a tagged
    sparse event (shared by the fault and the scenario step).

    ``move`` pops the head at slot ``s_mv`` and re-dispatches it at
    ``k_new`` (joining a busy node, or a fresh one whose availability bit
    comes from its class's idle pools through ``u_bit``); ``is_bf`` toggles
    every slot of the node at ``s_bf``; ``is_if`` moves one node of class
    ``if_c`` between the pools (``on2off`` says which way) and names the
    class's representative ``perm[offsets[if_c]]``.  ``named`` selects the
    events whose node is slot ``s_mv``'s.  Returns ``(state, j, slot)``."""
    node, cls, seq, head, a = state.node, state.cls, state.seq, state.head, state.avail
    ion, ioff = state.idle_on, state.idle_off
    ar, C = cst.ar, cst.C
    j_mv, cls_j, a_j = _take(node, s_mv), _take(cls, s_mv), _take(a, s_mv)
    j_bf = _take(node, s_bf)
    rep = torch.take(sp.perm, torch.take(sp.offsets, if_c))
    j = torch.where(named, j_mv, torch.where(is_bf, j_bf, rep))
    s = torch.where(move, s_mv, C)
    at_mv = ar == s_mv[..., None]
    mv = move[..., None]
    # a movement pops the head at j_mv: its next-oldest task takes the head
    others = mv & (node == j_mv[..., None]) & ~at_mv
    has_succ = others.any(-1)
    succ = torch.where(others, seq, _SEQ_LAST).argmin(-1)
    head = (head & ~(mv & at_mv)) | ((ar == succ[..., None]) & has_succ[..., None])
    cls_k = torch.take(sp.inv_cls, k_new)
    k_is_j = move & (k_new == j_mv)
    k_at = (node == k_new[..., None]) & ~at_mv
    exists_k = move & k_at.any(-1)
    j_idles = move & ~has_succ & ~k_is_j
    # the pools the fresh draw sees: after j (possibly) went idle
    ion1 = _add_at(ion, cls_j, (j_idles & (a_j > 0)).to(_I64))
    ioff1 = _add_at(ioff, cls_j, (j_idles & (a_j == 0)).to(_I64))
    pool_on = _take(ion1, cls_k).to(_F32)
    pool = pool_on + _take(ioff1, cls_k).to(_F32)
    bit_pool = (u_bit * torch.clamp_min(pool, 1.0) < pool_on).to(_F32)
    bit_join = torch.where(k_at, a, 0.0).amax(-1)
    bit_new = torch.where(exists_k, bit_join, torch.where(k_is_j, a_j, bit_pool))
    fresh = move & ~exists_k & ~k_is_j
    ion2 = _add_at(ion1, cls_k, -(fresh & (bit_new > 0)).to(_I64))
    ioff2 = _add_at(ioff1, cls_k, -(fresh & (bit_new == 0)).to(_I64))
    # a busy node's flip toggles every slot of that node; an idle-pool
    # flip moves one node between the class's (on, off) counts
    a = torch.where(is_bf[..., None] & (node == j_bf[..., None]), 1.0 - a, a)
    step = torch.where(is_if, torch.where(on2off, -1, 1), 0)
    at_s = mv & at_mv
    new = state._replace(
        node=torch.where(at_s, k_new[..., None], node),
        cls=torch.where(at_s, cls_k[..., None], cls),
        seq=torch.where(at_s, state.next_seq[..., None], seq),
        head=torch.where(at_s, ~exists_k[..., None], head),
        next_seq=state.next_seq + move.to(_I64),
        avail=torch.where(at_s, bit_new[..., None], a),
        idle_on=_add_at(ion2, if_c, step), idle_off=_add_at(ioff2, if_c, -step))
    return new, j, s


def _sparse_fault_stream_step(state: SparseStreamState, mu, sp: ClassSpec, fr: FaultRates,
                              e_hold, u_race, k_new, u_bit, cst: _Consts):
    """`sparse_fault_stream_step` on a precomputed holding time."""
    cls, a, ion, ioff = state.cls, state.avail, state.idle_on, state.idle_off
    C, m = cst.C, ion.shape[-1]
    hf = state.head.to(_F32)
    g = lambda v: _gather_cls(v, cls)  # noqa: E731
    rates = torch.cat([g(mu) * a * hf, g(fr.kappa) * a * hf, g(fr.theta) * hf,
                       (g(fr.q_off) * a + g(fr.q_on) * (1.0 - a)) * hf,
                       ion.to(_F32) * fr.q_off, ioff.to(_F32) * fr.q_on], dim=-1)
    rtree, dt, t, t_c = _race(rates, e_hold, state, True)
    idx = tree_sample(rtree, u_race)
    move = idx < 3 * C
    kind = torch.where(move, torch.div(idx, C, rounding_mode="floor"), KIND_FLIP)
    is_bf = (idx >= 3 * C) & (idx < 4 * C)
    is_if = idx >= 4 * C
    on2off = is_if & (idx < 4 * C + m)
    if_c = torch.where(is_if, torch.where(on2off, idx - 4 * C, idx - 4 * C - m), 0)
    new, j, s = _sparse_relocate(state, sp, k_new, u_bit, move, torch.where(move, idx % C, 0),
                                 is_bf, torch.where(is_bf, idx - 3 * C, 0), is_if, on2off, if_c,
                                 move, cst)
    return new._replace(t=t, t_c=t_c), Event(j=j, k=k_new, t=t, slot=s, dt=dt, kind=kind)


def sparse_fault_stream_step(state: SparseStreamState, mu, spec: ClassSpec, fr: FaultRates, xs):
    """One merged-CTMC event of the faulty sparse network, O(C + m).

    The race runs over ``4C + 2m`` clocks: per head slot [completion |
    crash | timeout | availability flip] plus per class [idle on -> off |
    idle off -> on], the exact class-collapse of the dense 4n race.  ``xs =
    (u_race, u_exp, k_new, u_bit)``: ``u_bit`` draws the availability bit
    of a dispatch that lands on an idle node from the class's (idle_on,
    idle_off) composition.  An idle-pool flip emits the class's
    representative id ``perm[offsets[c]]`` with the trash slot C.  ``fr =
    resolve_fault_rates_classes(...)``."""
    u_race, u_exp, k_new, u_bit = xs
    dev = state.node.device
    cst = _Consts(state.node.shape[:-1], state.node.shape[-1], dev)
    return _sparse_fault_stream_step(state, _f32(mu, dev), _spec_on(spec, dev), fr,
                                     _hold(u_exp, dev), _f32(u_race, dev),
                                     torch.as_tensor(k_new, dtype=_I64, device=dev),
                                     _f32(u_bit, dev), cst)


def sparse_scenario_stream_init(nodes, spec: ClassSpec, C: int, sr: ScenarioRates, u_phase):
    """`sparse_stream_init` (every node available) plus the C initial
    phases, drawn from ``u_phase``.  Returns ``(state, nodes)``."""
    state, nodes = sparse_stream_init(nodes, spec, C, fault=True)
    return state._replace(phase=_phase_draw(sr.acdf, _f32(u_phase, nodes.device))), nodes


def _sparse_scenario_stream_step(state: SparseStreamState, mu, sp: ClassSpec, sr: ScenarioRates,
                                 e_hold, u_race, k_new, u_bit, u_ph, cst: _Consts):
    """`sparse_scenario_stream_step` on a precomputed holding time."""
    cls, a, ion, ioff, phase = state.cls, state.avail, state.idle_on, state.idle_off, state.phase
    C, m = cst.C, ion.shape[-1]
    hf = state.head.to(_F32)
    speed = a + (1.0 - a) * sr.rate_scale
    rates = torch.cat([_gather_cls(mu, cls) * torch.take(sr.srate, phase) * speed * hf,
                       (_gather_cls(sr.q_off, cls) * a + _gather_cls(sr.q_on, cls) * (1.0 - a))
                       * hf,
                       ion.to(_F32) * sr.q_off, ioff.to(_F32) * sr.q_on], dim=-1)
    rtree, dt, t, t_c = _race(rates, e_hold, state, True)
    idx = tree_sample(rtree, u_race)
    is_sv = idx < C
    s_sv = torch.where(is_sv, idx, 0)
    ph_sv = _take(phase, s_sv)
    complete = is_sv & (torch.take(sr.absorb, ph_sv) > 0)
    is_bf = (idx >= C) & (idx < 2 * C)
    is_if = idx >= 2 * C
    on2off = is_if & (idx < 2 * C + m)
    if_c = torch.where(is_if, torch.where(on2off, idx - 2 * C, idx - 2 * C - m), 0)
    kind = torch.where(complete, KIND_COMPLETE, torch.where(is_sv, KIND_STAGE, KIND_FLIP))
    new, j, s = _sparse_relocate(state, sp, k_new, u_bit, complete, s_sv, is_bf,
                                 torch.where(is_bf, idx - C, 0), is_if, on2off, if_c, is_sv, cst)
    # a completion's slot takes the dispatched task's fresh phase, a stage
    # advance steps the head task to nxt; a flip writes the old phase back
    # (the reference drops that write)
    ph_w = torch.where(complete, _phase_draw(sr.acdf, u_ph), torch.take(sr.nxt, ph_sv))
    phase = phase.scatter(-1, s_sv[..., None], torch.where(is_sv, ph_w, ph_sv)[..., None])
    return (new._replace(t=t, t_c=t_c, phase=phase),
            Event(j=j, k=k_new, t=t, slot=s, dt=dt, kind=kind))


def sparse_scenario_stream_step(state: SparseStreamState, mu, spec: ClassSpec, sr: ScenarioRates,
                                xs):
    """One merged-CTMC event of the scenario sparse network, O(C + m).

    The race runs over ``2C + 2m`` clocks: per head slot [serve or stage |
    availability flip] plus per class [idle on -> off | idle off -> on], the
    class-collapse of `scenario_stream_step`'s 2n race.  A serve win is a
    completion where ``absorb[phase]``, else a stage advance; only
    completions move a task (the idle pools and the join bit as in
    `sparse_fault_stream_step`).  ``xs = (u_race, u_exp, k_new, u_bit,
    u_ph)``; ``sr = resolve_scenario_classes(...)``."""
    u_race, u_exp, k_new, u_bit, u_ph = xs
    dev = state.node.device
    cst = _Consts(state.node.shape[:-1], state.node.shape[-1], dev)
    return _sparse_scenario_stream_step(state, _f32(mu, dev), _spec_on(spec, dev), sr,
                                        _hold(u_exp, dev), _f32(u_race, dev),
                                        torch.as_tensor(k_new, dtype=_I64, device=dev),
                                        _f32(u_bit, dev), _f32(u_ph, dev), cst)


def sparse_stats_init(m: int, C: int, fault: bool = False, scenario: bool = False, *,
                      cells: int | None = None, device="cuda") -> StatsState:
    """Per-class `StatsState`: the same fields, (m,) where the dense ones
    are (n,)."""
    return stats_init(m, C, fault=fault, scenario=scenario, cells=cells, device=device)


def sparse_stats_step(stats: StatsState, ev: Event, cls_j, occ_pre, busy_pre, occ_post,
                      k) -> StatsState:
    """Per-class `stats_step`: ``occ_pre`` / ``busy_pre`` / ``occ_post`` are
    the (m,) counts of `sparse_class_stats` and ``cls_j`` the completing
    node's class."""
    cst = _Consts(occ_pre.shape[:-1], stats.slot_step.shape[-1], occ_pre.device)
    delay = k - _take(stats.slot_step, ev.slot)
    return _stats_step(stats, ev, occ_pre, occ_post, k, delay, cst,
                       busy=busy_pre.to(_F32) * ev.dt[..., None], at=cls_j)


def sparse_fault_stats_step(stats: StatsState, ev: Event, cls_j, occ_pre, busy_pre, avail_pre,
                            occ_post, k) -> StatsState:
    """Fault-aware per-class stats, `fault_stats_step` on (m,) vectors
    (``avail_pre``: the available nodes per class, busy plus idle-on); a
    flip's slot C writes no dispatch step."""
    C = stats.slot_step.shape[-1]
    return _tagged_stats_step(stats, ev, occ_pre, busy_pre.to(_F32) * ev.dt[..., None],
                              avail_pre, occ_post, k, _delay(stats, ev.slot, k, C), C, at=cls_j)


def _sparse_event(state, stats, mu, sp: ClassSpec, e_hold, u_race, k_new, u_bit, u_ph, k: int,
                  cst, need_stats: bool, fr, sr):
    """One event of the sparse stream and its per-class statistics:
    ``(state, stats, ev, delay)`` (delay None without stats)."""
    m = sp.counts.shape[0]
    if need_stats:
        if sr is not None:
            pre = sparse_scenario_class_stats(state, m, sr.rate_scale)
        else:
            pre = sparse_class_stats(state, m, fault=fr is not None)
    if sr is not None:
        state, ev = _sparse_scenario_stream_step(state, mu, sp, sr, e_hold, u_race, k_new, u_bit,
                                                 u_ph, cst)
    elif fr is not None:
        state, ev = _sparse_fault_stream_step(state, mu, sp, fr, e_hold, u_race, k_new, u_bit,
                                              cst)
    else:
        state, ev = _sparse_stream_step(state, mu, sp, e_hold, u_race, k_new, cst)
    if not need_stats:
        return state, stats, ev, None
    occ_pre, busy_pre, avail_pre = pre
    cls_j = torch.take(sp.inv_cls, ev.j)
    occ_post = class_occupancy(state.cls, m)
    busy = busy_pre.to(_F32) * ev.dt[..., None]
    if sr is None and fr is None:
        delay = k - _take(stats.slot_step, ev.slot)
        return (state, _stats_step(stats, ev, occ_pre, occ_post, k, delay, cst, busy=busy,
                                   at=cls_j), ev, delay)
    delay = _delay(stats, ev.slot, k, cst.C)
    stats = _tagged_stats_step(stats, ev, occ_pre, busy, avail_pre, occ_post, k, delay, cst.C,
                               at=cls_j)
    return state, stats, ev, delay


def _resolve_class_modes(fault, scenario, spec: ClassSpec, device):
    """`_resolve_modes` for the sparse stream: class-level tables."""
    fr = sr = None
    if isinstance(fault, FaultRates):
        fr = fault
    elif _enabled(fault):
        fr = resolve_fault_rates_classes(fault, spec, device)
    if isinstance(scenario, ScenarioRates):
        sr = scenario
    elif _enabled(scenario):
        sr = resolve_scenario_classes(scenario, spec, device)
    if fr is not None and sr is not None:
        raise ValueError("fault= and scenario= are mutually exclusive")
    return fr, sr


def sparse_scan_draws(mu, spec: ClassSpec, nodes, u_race, u_exp, K, u_bit=None, u_ph=None,
                      u_phase0=None, *, fault=None, scenario=None, emit_events: bool = True):
    """The sparse stream over pre-drawn inputs, `scan_draws`'s analogue.

    ``mu`` is the (m,) class rate vector, ``nodes`` the initial placement
    ((C,) or (B, C)), ``u_race`` / ``u_exp`` / ``K`` (global client ids,
    `sample_dispatch_classes`) ``(T,)`` or ``(B, T)``; a fault or scenario
    stream also takes ``u_bit`` (like ``K``), a scenario stream ``u_ph``
    (like ``K``) and ``u_phase0`` (like ``nodes``).  Parity tests pass the
    reference's draws (`jax.random.split(key, 6)`, or 7 with a scenario).
    Returns ``(nodes, events, stats, state)``: ``events = (J, K, t, slot,
    delay)`` (plus ``kind`` with a fault or scenario; None without
    ``emit_events``), the per-class stats and the final sparse state.
    """
    mu = torch.as_tensor(mu)
    dev = mu.device
    sp = _spec_on(spec, dev)
    nodes = torch.as_tensor(nodes, device=dev).to(_I64)
    m, C = sp.m, nodes.shape[-1]
    lead = nodes.shape[:-1]
    mu = mu.to(_F32).expand(*lead, m)
    fr, sr = _resolve_class_modes(fault, scenario, spec, dev)
    if sr is not None:
        state, nodes = sparse_scenario_stream_init(nodes, sp, C, sr, u_phase0)
        u_ph = _f32(u_ph, dev)
    else:
        state, nodes = sparse_stream_init(nodes, sp, C, fault=fr is not None)
    if fr is not None or sr is not None:
        u_bit = _f32(u_bit, dev)
    stats = sparse_stats_init(m, C, fault=fr is not None, scenario=sr is not None,
                              cells=lead[0] if lead else None, device=dev)
    K = torch.as_tensor(K, device=dev).to(_I64)
    cst = _Consts(lead, C, dev)
    state, stats, (J, t, slot, delay, kind) = _advance(
        state, stats, mu, _hold(torch.as_tensor(u_exp, device=dev), dev), _f32(u_race, dev), K,
        0, cst, fr=fr, sr=sr, u_ph=u_ph, spec=sp, u_bit=u_bit)
    events = (J, K, t, slot, delay) + ((kind,) if kind is not None else ())
    return nodes, (events if emit_events else None), stats, state


def draw_sparse_uniforms(seed, spec: ClassSpec, C: int, T: int, p, init: str = "distinct",
                         device="cuda", fault: bool = False, scenario: bool = False):
    """One sparse stream's draws from the port's generator, in the
    reference's order (`_sparse_network_scan`'s key split): ``(nodes (C,),
    u_race, u_exp, u_disp, u_mem)`` (T,) each on ``device``; with ``fault``
    or ``scenario`` then ``u_bit (T,)``; with ``scenario`` then ``u_ph
    (T,)`` and ``u_phase0 (C,)``.  ``p`` is the (m,) class-level p."""
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    p = torch.as_tensor(np.asarray(p) if not isinstance(p, torch.Tensor) else p).to(
        device=dev, dtype=_F32)
    nodes = _init_sparse_nodes(gen, _spec_on(spec, dev), C, p, init)
    out = [nodes] + [torch.rand(T, generator=gen, device=dev) for _ in range(4)]
    if fault or scenario:
        out.append(torch.rand(T, generator=gen, device=dev))
    if scenario:
        out += [torch.rand(T, generator=gen, device=dev), torch.rand(C, generator=gen, device=dev)]
    return tuple(out)


def sparse_stats_stream_fn(m: int, C: int, T: int, init: str = "distinct", fault: bool = False,
                           scenario: bool = False):
    """Stats-only sparse network run: ``gen(seed, mu, p, spec,
    device="cuda") -> (StatsState, SparseStreamState)`` with (m,)
    class-level ``mu`` / ``p``; with ``fault`` or ``scenario`` it is
    ``gen(seed, mu, p, spec, fr, device="cuda")``, ``fr`` the
    `resolve_fault_rates_classes` / `resolve_scenario_classes` tables (or
    the configs).  Its per-event cost is flat in n."""
    if fault and scenario:
        raise ValueError("fault and scenario streams are mutually exclusive")

    def run(seed, mu, p, spec, fr, device):
        dev = resolve_device(device)
        sp = _spec_on(spec, dev)
        if sp.m != m:
            raise ValueError(f"the ClassSpec has {sp.m} classes, the function was made for {m}")
        p_t = _f32(p, dev)
        nodes, ur, ue, ud, um, *rest = draw_sparse_uniforms(seed, sp, C, T, p_t, init, dev,
                                                            fault=fault, scenario=scenario)
        K = sample_dispatch_classes(p_t, sp, ud, um)
        return sparse_scan_draws(_f32(mu, dev), sp, nodes, ur, ue, K, *rest,
                                 fault=fr if fault else None, scenario=fr if scenario else None,
                                 emit_events=False)[2:]

    if fault or scenario:
        return lambda seed, mu, p, spec, fr, device="cuda": run(seed, mu, p, spec, fr, device)
    return lambda seed, mu, p, spec, device="cuda": run(seed, mu, p, spec, None, device)


# ---------------------------------------------------------------------- #
# the control plane: exact Jackson analysis and the Theorem-1 bound in
# torch, differentiable; every function takes (n,) or (B, n) vectors
# ---------------------------------------------------------------------- #
def _rdiv(a: float, t: torch.Tensor) -> torch.Tensor:
    """``a / t`` as a true division (torch rewrites a Python scalar over a
    tensor as a reciprocal times the scalar, which rounds differently)."""
    return torch.div(torch.full_like(t, a), t)


@lru_cache(maxsize=64)
def _counts_on(counts: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The class sizes as a tensor on ``device``, made once (an asynchronous
    copy on a card, so a refresh inside a chunk makes no host sync)."""
    return _table(np.asarray(counts, np.float64), dtype, device)


def _class_weights(p, counts):
    """``(weights, total n)`` of the node sums: ones and the vector's length
    (dense, ``counts=None``), or the class sizes and their sum (the
    class-collapsed form, ``p`` the (m,) per-node probability by class)."""
    if counts is None:
        return torch.ones_like(p), float(p.shape[-1])
    counts = tuple(int(c) for c in (counts.tolist() if isinstance(counts, torch.Tensor)
                                    else np.asarray(counts).ravel()))
    return _counts_on(counts, p.dtype, p.device), float(sum(counts))


def mva_throughput_delays(mu, p, C: int, normalized: bool = True, counts=None):
    """Exact ``(m, lam)`` of the closed network by Mean Value Analysis.

    Over populations M = 1..C: W = (1 + Q_{M-1}) / mu, lam_M = M / (p . W),
    Q_M = lam_M p W.  Returns the delays in CS steps (Prop. 3, with the
    (C-1)/C Little's-law normalization by default) and the throughput; the
    same values as the Buzen pipeline of `jackson.JacksonNetwork`, and a
    C-step recurrence that autograd differentiates.  ``counts`` (the class
    sizes) collapses identical nodes to classes: ``mu`` / ``p`` are then the
    (m,) class-level values and the dot products counts-weighted, O(m C).
    """
    p = torch.as_tensor(p)
    mu = torch.as_tensor(mu, dtype=p.dtype, device=p.device)
    w, _ = _class_weights(p, counts)
    Q = torch.zeros_like(p)
    lam = None
    for M in range(1, C + 1):
        W = (1.0 + Q) / mu
        lam = _rdiv(float(M), torch.sum(w * p * W, dim=-1, keepdim=True))
        Q = lam * p * W
    if C == 1:
        Q_prev = torch.zeros_like(p)
    else:
        # invert the last MVA step: Q_C = lam_C p (1 + Q_{C-1}) / mu
        Q_prev = mu * Q / (lam * p) - 1.0
    m = lam * (Q_prev + 1.0) / mu
    if normalized:
        m = m * (C - 1.0) / C
    return m, lam[..., 0]


def generalized_bound_jnp(eta, p, m, k: BoundConstants, counts=None):
    """G(p, eta) of Eq. (3), `theory.generalized_bound` in torch; with
    ``counts`` every node sum is a counts-weighted class sum."""
    w, n = _class_weights(p, counts)
    n2 = n**2
    t1 = _rdiv(k.A, eta * (k.T + 1))
    t2 = eta * k.L * k.B * torch.sum(w / (n2 * p), dim=-1)
    t3 = eta**2 * k.L**2 * k.B * k.C * torch.sum(w * m / (n2 * p**2), dim=-1)
    return t1 + t2 + t3


def optimal_eta_jnp(p, m, k: BoundConstants, newton_iters: int = 20, counts=None):
    """argmin_eta G(p, eta) s.t. eta <= eta_max, differentiable.

    The stationary point solves 2c eta^3 + b eta^2 = D; Newton from eta0 =
    cbrt(D / 2c) (``pow(., 1/3)`` on the positive argument) converges
    monotonically.  The Theorem-1 cap min(a, b) mirrors
    `theory.eta_max_components`.  ``counts`` collapses the node sums to
    counts-weighted class sums.
    """
    w, n = _class_weights(p, counts)
    n2 = n**2
    D = k.A / (k.T + 1)
    b = k.L * k.B * torch.sum(w / (n2 * p), dim=-1)
    c = k.L**2 * k.B * k.C * torch.sum(w * m / (n2 * p**2), dim=-1)
    eta = torch.pow(_rdiv(D, 2.0 * c), 1.0 / 3.0)
    for _ in range(newton_iters):
        f = 2.0 * c * eta**3 + b * eta**2 - D
        fp = 6.0 * c * eta**2 + 2.0 * b * eta
        eta = eta - f / fp
    growth = 1.0 + k.rho**2
    m_k = torch.sum(w * m / (n2 * p**2), dim=-1)
    a_cap = _rdiv(1.0, torch.sqrt(16.0 * k.L**2 * k.C * m_k * growth))
    b_cap = _rdiv(n2, 8.0 * k.L * growth * torch.sum(w / p, dim=-1))
    return torch.minimum(eta, torch.minimum(a_cap, b_cap))


def make_bound_value_and_grad(k: BoundConstants, counts=None):
    """``vg(p, mu) -> (value, grad)`` of f(p) = G(p, eta*(p)) with the
    delays from MVA: `sampling.bound_value_and_grad` in torch.

    The gradient is autograd through the MVA recurrence, the explicit 1/p
    terms and eta*(p) (the Newton iterates' channel vanishes at an interior
    stationary point by the envelope theorem; where the cap is active,
    ``torch.minimum`` routes the chain rule through it).  With a leading
    cell axis each cell gets its own value and gradient.  ``counts`` (the
    class sizes) switches everything to the O(m C) class-collapsed form
    with (m,) per-node class probabilities.
    """

    def vg(p, mu):
        with torch.enable_grad():
            pp = torch.as_tensor(p).detach().requires_grad_(True)
            m, _ = mva_throughput_delays(torch.as_tensor(mu).detach(), pp, int(k.C),
                                         counts=counts)
            eta = optimal_eta_jnp(pp, m, k, counts=counts)
            val = generalized_bound_jnp(eta, pp, m, k, counts=counts)
            (g,) = torch.autograd.grad(val.sum(), pp)
        return val.detach(), g

    return vg


def estimate_mu(comp, busy_t, prior_weight: float = 1.0, floor_frac: float = 1e-3):
    """Per-node service-rate MLE from observed (completions, busy time),
    shrunk toward the busy-time-weighted global rate and floored at
    ``floor_frac`` of it (a dark node reads as very slow but finite)."""
    comp = comp.to(_F32)
    mu_bar = torch.sum(comp, dim=-1, keepdim=True) / torch.clamp_min(
        torch.sum(busy_t, dim=-1, keepdim=True), 1e-20)
    mu_bar = torch.clamp_min(mu_bar, 1e-8)
    est = (comp + prior_weight) / torch.clamp_min(busy_t + _rdiv(prior_weight, mu_bar), 1e-20)
    return torch.maximum(est, floor_frac * mu_bar)


def ctrl_refresh(p, comp, busy_t, k: BoundConstants, lr: float = 0.3, iters: int = 4,
                 floor_scale: float = 1e-5, counts=None):
    """One adaptive-sampling refresh: re-estimate the rates from the
    observed stream, then ``iters`` exponentiated-gradient steps on the
    Theorem-1 bound (`sampling.optimize_general`'s mirror descent, on
    measured rates).  Non-finite gradient components are scrubbed to 0 and
    each iterate is re-floored and renormalized, so p never collapses to
    NaN or exact zeros.  With ``counts`` (the class sizes) it runs in the
    class-collapsed form: ``p`` is the (m,) per-node probability by class,
    ``comp`` / ``busy_t`` the per-class totals, and the exponentiated
    gradient steps the class masses ``z = counts p`` (the simplex the
    collapsed problem lives on); within a class the dense optimum is
    symmetric, so the collapsed optimum is exact.
    """
    vg = make_bound_value_and_grad(k, counts=counts)
    mu_hat = estimate_mu(comp, busy_t)
    w, n = _class_weights(p, counts)
    floor = floor_scale / n
    for _ in range(iters):
        _, g = vg(p, mu_hat)
        g = torch.where(torch.isfinite(g), g, 0.0)
        z = w * p
        gz = g / w
        gz = gz - torch.sum(gz * z, dim=-1, keepdim=True)
        z = z * torch.exp(-lr * gz / (torch.amax(torch.abs(gz), dim=-1, keepdim=True) + 1e-12))
        z = torch.where(torch.isfinite(z), z, w * floor)
        z = torch.maximum(z, w * floor)
        p = (z / torch.sum(z, dim=-1, keepdim=True)) / w
    return p
