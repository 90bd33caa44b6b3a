"""Event-driven simulator of the paper's closed queueing network.

Simulates exactly the process of §2: C tasks circulate among n FIFO clients;
when client J_k completes a task (k-th CS step), the dispatcher samples a new
client K_{k+1} ~ p and enqueues a fresh task there.  Produces the exact traces
(J_k, K_k, X_{i,k}, M_{i,k}) that the theory reasons about, for exponential or
deterministic service times.

This is the control-plane companion of `repro.fl.engine` (which attaches real
gradient computations to these events) and the oracle used to validate
`repro.core.jackson` closed forms.

Performance notes
-----------------
A CS step is O(log n) amortized, independent of the number of clients:

  * queue lengths are incremental counters, never recomputed from the deques;
  * the occupancy accumulators (event-sampled sum and time-weighted integral
    of X_i) use per-node "last changed at step/time" bookkeeping, so each
    event touches only the two affected nodes; reads flush lazily via the
    `queue_len_sum` / `queue_len_tw` properties;
  * dispatch samples and exponential service variates are pre-drawn in
    vectorized blocks (inverse-CDF via one `searchsorted` per block), so the
    per-event RNG cost is O(1) instead of `rng.choice`'s O(n);
  * per-event delay recording is opt-in (``SimConfig.record_delays``) and
    stored as flat numpy arrays — the old always-on list-of-lists cost
    hundreds of MB of Python objects at T=1e6.  The per-node views
    (``delays`` / ``time_delays``) are derived lazily.

The event stream is deterministic given (seed, block size); it differs from
the seed implementation's stream (which drew variates one at a time) but has
identical law.

Delay recording semantics
-------------------------
Delay recording is opt-in (``SimConfig.record_delays=True``) and **flat**:

  * `ClosedNetworkSim.delay_steps` is a ``(k,)`` int64 array in *completion
    order* — entry ``i`` is the CS-step delay of the i-th completion, i.e.
    the number of CS steps strictly between that task's dispatch and its
    completion (``M_{i,k}`` of §2).  The completing node of record ``i`` is
    ``J[i]``, so the pair ``(J, delay_steps)`` fully determines every
    per-node view and nothing per-node is ever materialized eagerly.
  * `EventStream.delay_steps` aligns 1:1 with the ``(J, K, t)`` trace:
    ``delay_steps[k]`` is the delay of the task completing at CS step ``k``
    (at node ``J[k]``).  ``None`` unless the stream was exported with
    ``record_delays=True`` (host) — device-generated streams
    (`stream_device.generate_stream`) always carry it.
  * The per-node list-of-lists views (``delays`` / ``time_delays``) are
    lazy, derived via `_split_delays`, and preserve event order within each
    node.  The flat invariant — regrouping the per-node view by ``J`` in
    event order reproduces ``delay_steps`` exactly — is locked by
    ``tests/test_queue_sim.py``.

Block segmentation
------------------
`segment_blocks` cuts a ``(T,)`` slot sequence into conflict-free
micro-blocks for the blocked scan engine.  Two cut policies are available
(``method=``): ``"greedy"`` extends each block until the next event's slot
repeats (or the length/eval caps hit) — provably minimal in block count for
this hereditary validity structure; ``"dp"`` is an exact O(T) dynamic
program over admissible cut points that certifies that minimum and
tie-breaks toward longer trailing blocks (never more padded lanes than
greedy — locked by tests).  `select_block_size` picks the lane count E from
the *measured* conflict structure of a stream: the delay distribution
governs conflict-free run lengths, so E is chosen as the largest candidate
whose measured lane utilization ``T / (B(E) * E)`` stays above a floor
(rounded to a multiple of the lane-shard device count).
"""
from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass

import numpy as np

__all__ = [
    "SimConfig",
    "SimResult",
    "EventStream",
    "EventBlocks",
    "FaultConfig",
    "ClosedNetworkSim",
    "simulate",
    "simulate_batch",
    "export_stream",
    "export_blocks",
    "segment_blocks",
    "select_block_size",
    "KIND_COMPLETE",
    "KIND_CRASH",
    "KIND_TIMEOUT",
    "KIND_FLIP",
    "KIND_SERVE",
    "KIND_STAGE",
    "N_KINDS",
]

#: event kind tags shared by the host simulator, the device stream and the
#: scan engine.  Only KIND_COMPLETE events apply a gradient; crash/timeout
#: events move the task (re-dispatch with the *current* server weights) and
#: KIND_FLIP events toggle availability without touching any queue.
KIND_COMPLETE = 0
KIND_CRASH = 1
KIND_TIMEOUT = 2
KIND_FLIP = 3
#: open-queue serving event (core.serving): an inference-plane arrival /
#: completion / deadline / retry-release interleaved into the merged race.
#: Serve events carry ``j = n`` and ``slot = C`` so every training-side
#: gather clamps harmlessly and every scatter drops out of bounds — the
#: same masking pattern as KIND_FLIP.  The serving sub-kind (arrival vs
#: completion vs timeout vs release) is resolved inside
#: `serving.serve_apply`, not in the event tag.
KIND_SERVE = 4
#: phase-type stage advance (scenario mode, `core.scenario`): the head-of-line
#: task at ``j`` moves to its next service stage — no queue changes, no
#: gradient.  Stage rows carry ``slot = C`` and ``K = -1`` (host) exactly like
#: KIND_FLIP, so every downstream gather/scatter masks them for free.
KIND_STAGE = 5
#: size of a kind-count histogram covering every tag above
N_KINDS = 6

#: shared RNG pre-draw block size — every entry point uses the same default so
#: `simulate(cfg)`, `simulate_batch(cfg)` and `ClosedNetworkSim(cfg).run(T)`
#: produce the identical event stream for the same seed
DEFAULT_BLOCK = 4096


@dataclass(frozen=True, eq=False)
class FaultConfig:
    """Memoryless fault processes layered on the closed network.

    Every rate is a per-node exponential intensity (scalar broadcast or an
    ``(n,)`` array), so the network + faults remain a CTMC and both the
    host event heap and the device inverse-CDF race survive unchanged in
    law.  Semantics:

      * availability is a 2-state Markov chain per node: ``off_rate`` is
        the on->off flip intensity, ``on_rate`` off->on.  An unavailable
        node serves nothing (completion and crash clocks are suspended;
        memorylessness means service simply redraws on resume).
      * ``crash_rate`` races the in-service completion while the node is
        available; on a crash the in-flight task's work is discarded and
        the task re-enters dispatch (K ~ p) with the current server
        weights.
      * ``timeout_rate`` is a per-task straggler deadline on the
        head-of-line task.  It fires *regardless of availability* (the
        deadline is enforced server-side), and the expired task is
        re-dispatched exactly like a crash.

    All four default to 0 (process disabled).
    """

    off_rate: float | tuple | np.ndarray = 0.0
    on_rate: float | tuple | np.ndarray = 0.0
    crash_rate: float | tuple | np.ndarray = 0.0
    timeout_rate: float | tuple | np.ndarray = 0.0

    def resolve(self, n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Broadcast all four rates to float64 ``(n,)`` arrays (validated)."""
        out = []
        for name in ("off_rate", "on_rate", "crash_rate", "timeout_rate"):
            a = np.broadcast_to(
                np.asarray(getattr(self, name), np.float64), (n,)
            ).copy()
            if not np.all(np.isfinite(a)) or np.any(a < 0):
                raise ValueError(f"FaultConfig.{name} must be finite and >= 0")
            out.append(a)
        return tuple(out)

    @property
    def enabled(self) -> bool:
        return any(
            np.any(np.asarray(r, np.float64) > 0)
            for r in (self.off_rate, self.on_rate, self.crash_rate, self.timeout_rate)
        )

    def cache_key(self) -> tuple:
        """Hashable fingerprint (rates flattened) for jit/runner caches."""
        def t(x):
            return tuple(np.asarray(x, np.float64).ravel().tolist())

        return (t(self.off_rate), t(self.on_rate), t(self.crash_rate),
                t(self.timeout_rate))


@dataclass
class SimConfig:
    mu: np.ndarray              # (n,) service rates
    p: np.ndarray               # (n,) dispatch probabilities
    C: int                      # concurrency (number of circulating tasks)
    T: int                      # number of CS steps to simulate
    service: str = "exp"        # "exp" | "det"
    seed: int = 0
    initial: str = "distinct"   # "distinct": C tasks on C distinct clients (S_0)
                                # "sampled": C iid draws from p
    record_delays: bool = False  # opt-in per-event delay recording (flat arrays;
                                 # off by default — the queue-length accumulators
                                 # and the (J, K, t) trace are always available)
    fault: FaultConfig | None = None  # optional churn/crash/straggler injection;
                                      # with faults, T counts *merged* CTMC
                                      # events (flips included), not only CS
                                      # steps — filter by `kind` to recover the
                                      # task-movement subsequence
    scenario: "object | None" = None  # optional core.scenario.ScenarioConfig:
                                      # phase-type service + Markov-modulated
                                      # availability.  Mutually exclusive with
                                      # `fault`; like fault mode, T counts
                                      # merged events (stages + flips included)


@dataclass
class SimResult:
    J: np.ndarray               # (T,) completing client per CS step
    K: np.ndarray               # (T,) newly-sampled client per CS step
    t: np.ndarray               # (T,) physical time of each CS step
    delays: list[list[int]] | None       # per-node delays in CS steps (M_{i,k});
                                         # None unless cfg.record_delays
    time_delays: list[list[float]] | None  # per-node physical-time sojourns
    queue_len_sum: np.ndarray   # (n,) event-sampled sum over steps of X_{i,k}
    queue_len_tw: np.ndarray    # (n,) time-weighted integral of X_i(t)
    queue_len_last: np.ndarray  # (n,) final queue lengths
    steps: int

    def _need_delays(self) -> list[list[int]]:
        if self.delays is None:
            raise ValueError(
                "delays were not recorded; simulate with "
                "SimConfig(record_delays=True)"
            )
        return self.delays

    def mean_delay_per_node(self) -> np.ndarray:
        return np.array([np.mean(d) if d else np.nan for d in self._need_delays()])

    def max_delay_per_node(self) -> np.ndarray:
        return np.array([np.max(d) if d else np.nan for d in self._need_delays()])

    def mean_queue_lengths(self) -> np.ndarray:
        """Event-sampled means (Palm view at CS steps)."""
        return self.queue_len_sum / self.steps

    def time_avg_queue_lengths(self) -> np.ndarray:
        """Time-stationary means — comparable to JacksonNetwork.mean_queue_lengths."""
        return self.queue_len_tw / float(self.t[-1])

    def throughput(self) -> float:
        """CS steps per unit physical time."""
        return self.steps / float(self.t[-1]) if self.steps else 0.0


@dataclass
class EventStream:
    """Pre-computed event stream of a closed-network run, in array form.

    This is the bridge between the host-side event simulator and the compiled
    (scan-based) training engine: the queuing structure makes every CS step's
    control decisions — who completes (``J``), who is sampled next (``K``),
    when (``t``) — independent of the gradient values, so they can be
    simulated once on the host and the whole training run replayed on device
    as a single XLA program.

    ``slot`` encodes the FIFO snapshot bookkeeping: the engine keeps C
    dispatch-time parameter snapshots in a ring buffer; at step k the
    completing task's snapshot lives in ``slot[k]``, and — because exactly one
    task completes and one is dispatched per step — the newly dispatched
    task reuses the same slot.
    """

    J: np.ndarray            # (T,) completing client per CS step
    K: np.ndarray            # (T,) newly-sampled client per CS step
    t: np.ndarray            # (T,) physical time of each CS step
    slot: np.ndarray         # (T,) ring-buffer slot of the completing task
    init_nodes: np.ndarray   # (C,) client of the initial task in each slot
    n: int                   # number of clients
    C: int                   # concurrency
    p: np.ndarray            # (n,) dispatch probabilities the stream was drawn from
    delay_steps: np.ndarray | None = None       # (T,) CS-step delay of the task
                                                # completing at step k (node J[k]);
                                                # None unless record_delays
    queue_len_sum: np.ndarray | None = None     # (n,) event-sampled occupancy sum
    queue_len_tw: np.ndarray | None = None      # (n,) time-weighted occupancy
                                                # integral (device streams)
    kind: np.ndarray | None = None              # (T,) event kind (KIND_*); None
                                                # on fault-free streams (all
                                                # events are completions).  On
                                                # KIND_FLIP rows slot == C (the
                                                # trash row) and K == -1 (host)
                                                # / unused (device).

    @property
    def T(self) -> int:
        return int(self.J.size)

    @property
    def delays(self) -> list[list[int]] | None:
        """Per-node CS-step delays, derived lazily from the flat arrays.

        The flat ``(J, delay_steps)`` pair is the stored form (O(T) ints —
        list-of-lists over 1e6 events used to cost hundreds of MB of Python
        objects); the per-node view is materialized on demand.
        """
        if self.delay_steps is None:
            return None
        return _split_delays(self.J, self.delay_steps, self.n)


def _greedy_starts(slot: np.ndarray, E: int, cut_every: int) -> list[int]:
    """Block start indices of the greedy maximal-extension cut."""
    T = slot.size
    starts = [0]
    seen: set[int] = set()
    length = 0
    for k in range(T):
        s = int(slot[k])
        cut = length >= E or s in seen or (cut_every and k and k % cut_every == 0)
        if cut:
            starts.append(k)
            seen = set()
            length = 0
        seen.add(s)
        length += 1
    return starts


def _window_starts(slot: np.ndarray, E: int, cut_every: int) -> np.ndarray:
    """``s_lim[k]``: leftmost admissible start of a block ending at event k
    (inclusive) — slots in ``[s_lim[k], k]`` are distinct, the span stays
    inside one ``cut_every`` interval, and the length is capped at E.  All
    three lower bounds are non-decreasing in k, so ``s_lim`` is monotone
    (which the DP's sliding-window minimum relies on)."""
    T = slot.size
    s_lim = np.empty(T, np.int64)
    last: dict[int, int] = {}
    s = 0
    for k in range(T):
        v = int(slot[k])
        p = last.get(v, -1)
        if p >= s:
            s = p + 1
        if cut_every:
            b = (k // cut_every) * cut_every
            if b > s:
                s = b
        lo = k - E + 1
        if lo > s:
            s = lo
        s_lim[k] = s
        last[v] = k
    return s_lim


def _dp_starts(slot: np.ndarray, E: int, cut_every: int) -> list[int]:
    """Exact minimum-block-count cut via an O(T) DP.

    ``f[k]`` = fewest blocks covering events ``[0, k)``; the transition
    minimizes over admissible last-block starts ``i in [s_lim[k-1], k)``
    (conflict-free, length <= E, no ``cut_every`` boundary inside).  The
    admissible window's left edge is monotone, so the minimum is maintained
    with a monotonic deque — one push/pop per event.  Ties prefer the
    smallest start (the longest trailing block), making the reconstruction
    deterministic.  Block validity is hereditary (any subinterval of a
    conflict-free block is conflict-free), so this matches the greedy
    count exactly — the DP is the optimality certificate the tests hold
    the greedy cut to, and the base `select_block_size` measures on.
    """
    T = slot.size
    if T == 0:
        return [0]
    s_lim = _window_starts(slot, E, cut_every)
    f = np.empty(T + 1, np.int64)
    f[0] = 0
    back = np.empty(T + 1, np.int64)
    dq: deque[tuple[int, int]] = deque()  # (f[i], i), f increasing
    pushed = 0
    for k in range(1, T + 1):
        while pushed < k:  # starts up to k-1 become available
            while dq and dq[-1][0] > f[pushed]:
                dq.pop()
            dq.append((int(f[pushed]), pushed))
            pushed += 1
        lo = s_lim[k - 1]
        while dq and dq[0][1] < lo:
            dq.popleft()
        fb, i = dq[0]
        f[k] = fb + 1
        back[k] = i
    starts = []
    k = T
    while k > 0:
        k = int(back[k])
        starts.append(k)
    starts.reverse()
    return starts


def segment_blocks(
    slot: np.ndarray, block_size: int, cut_every: int = 0, method: str = "greedy"
) -> tuple[np.ndarray, np.ndarray]:
    """Conflict-free cut of an event stream into micro-blocks.

    Walks the (T,) ``slot`` sequence and closes a block whenever the next
    event's ring-buffer slot already appears in it (its dispatch-time
    snapshot was *written inside the block*, so its gradient depends on an
    in-block update), the block holds ``block_size`` events, or — when
    ``cut_every > 0`` — the event index crosses a multiple of ``cut_every``
    (so evaluation points land exactly on block boundaries).

    ``method`` picks the cut placement: ``"greedy"`` extends each block
    maximally (provably minimal in block count — validity is hereditary);
    ``"dp"`` computes the same minimum by exact dynamic programming over all
    admissible cut points (`_dp_starts`), guaranteeing no more padded lanes
    than greedy and a deterministic longest-trailing-block tie-break.

    Returns ``(idx, mask)`` with fixed shape ``(B, E)``: ``idx[b, i]`` is the
    event index of the i-th event of block b (0 on padding), ``mask[b, i]``
    marks real events.  Within a block all slots are distinct, so the blocked
    replay — batch-gather, batched gradients, prefix-sum of the scaled
    updates — reproduces the sequential Algorithm 1 exactly.
    """
    E = int(block_size)
    if E < 1:
        raise ValueError("block_size >= 1 required")
    slot = np.asarray(slot)
    T = slot.size
    if method == "greedy":
        starts = _greedy_starts(slot, E, cut_every)
    elif method == "dp":
        starts = _dp_starts(slot, E, cut_every)
    else:
        raise ValueError(f"unknown segmentation method {method!r}")
    B = len(starts)
    bounds = np.asarray(starts + [T])
    idx = np.zeros((B, E), np.int32)
    mask = np.zeros((B, E), bool)
    for b in range(B):
        lo, hi = bounds[b], bounds[b + 1]
        idx[b, : hi - lo] = np.arange(lo, hi)
        mask[b, : hi - lo] = True
    return idx, mask


def select_block_size(
    slots: np.ndarray | list[np.ndarray],
    block_size_max: int = 16,
    devices: int = 1,
    cut_every: int = 0,
    min_utilization: float = 0.5,
    method: str = "dp",
) -> tuple[int, dict[int, float]]:
    """Pick the lane count E from the *measured* conflict structure.

    Cut placement is governed by the delay distribution: an intra-block
    conflict means a task completed with a delay shorter than its in-block
    offset, so the measured conflict-free run lengths of a stream bound how
    full E lanes can get.  For each candidate E (multiples of ``devices``,
    so every block splits evenly across lane-shard devices) this segments
    the measured ``slots`` (one ``(T,)`` array or a list of them, aggregated)
    and computes the mean lane utilization ``sum(T) / sum(B(E) * E)``.

    Returns ``(E, utilizations)`` where E is the **largest** candidate whose
    utilization stays at or above ``min_utilization`` — the biggest batch
    whose lanes actually fill — falling back to the highest-utilization
    candidate when none clears the floor.
    """
    if isinstance(slots, np.ndarray):
        slots = [slots]
    step = max(int(devices), 1)
    if block_size_max < step:
        raise ValueError("block_size_max must be >= devices")
    utils: dict[int, float] = {}
    for E in range(step, block_size_max + 1, step):
        total_T = total_lanes = 0
        for s in slots:
            _, mask = segment_blocks(np.asarray(s), E, cut_every, method=method)
            total_T += int(np.asarray(s).size)
            total_lanes += int(mask.size)
        utils[E] = total_T / max(total_lanes, 1)
    above = [E for E, u in utils.items() if u >= min_utilization]
    best = max(above) if above else max(utils, key=lambda E: (utils[E], E))
    return best, utils


@dataclass
class EventBlocks:
    """Conflict-free micro-blocks of an `EventStream`, in fixed-shape form.

    ``idx``/``mask`` come from `segment_blocks`; ``J``/``slot``/``k`` are the
    blocked event columns with padding already neutralized: padded lanes get
    client 0, the trash ring-buffer row ``C`` (the blocked engine allocates
    C+1 snapshot rows so padded scatters land in a scratch row) and event
    index 0 — their update scale is forced to 0 by `blocked_scales`.
    """

    idx: np.ndarray          # (B, E) event index per block lane
    mask: np.ndarray         # (B, E) True on real events, False on padding
    J: np.ndarray            # (B, E) completing client (0 on padding)
    slot: np.ndarray         # (B, E) ring slot; == C (trash row) on padding
    n: int
    C: int
    T: int
    block_size: int
    cut_every: int = 0
    method: str = "greedy"   # cut placement: "greedy" | "dp" (segment_blocks)
    stream: EventStream | None = None

    @property
    def B(self) -> int:
        return int(self.idx.shape[0])

    @property
    def utilization(self) -> float:
        """Mean lane utilization T / (B * E) — 1.0 means no padded lanes."""
        return self.T / max(self.mask.size, 1)

    @property
    def padded_lanes(self) -> int:
        """Number of no-op lanes (mask False) across all blocks."""
        return int(self.mask.size - self.T)

    @classmethod
    def from_stream(
        cls,
        stream: EventStream,
        block_size: int,
        cut_every: int = 0,
        method: str = "greedy",
    ) -> "EventBlocks":
        return cls.from_columns(stream.J, stream.slot, stream.n, stream.C, block_size,
                                cut_every, method, stream)

    @classmethod
    def from_columns(
        cls,
        J: np.ndarray,
        slot: np.ndarray,
        n: int,
        C: int,
        block_size: int,
        cut_every: int = 0,
        method: str = "greedy",
        stream: EventStream | None = None,
    ) -> "EventBlocks":
        """Blocks of a bare (T,) ``J`` / ``slot`` pair: the replay columns of
        a stream, or of a chunk of the device stream's events."""
        J, slot = np.asarray(J), np.asarray(slot)
        idx, mask = segment_blocks(slot, block_size, cut_every, method)
        return cls(
            idx=idx,
            mask=mask,
            J=np.where(mask, J[idx], 0).astype(np.int32),
            slot=np.where(mask, slot[idx], C).astype(np.int32),
            n=int(n),
            C=int(C),
            T=int(slot.size),
            block_size=int(block_size),
            cut_every=int(cut_every),
            method=method,
            stream=stream,
        )

    def blocked_scales(self, scale: np.ndarray) -> np.ndarray:
        """Blocked view of a per-step (T,) scale array; 0 on padding."""
        return np.where(self.mask, np.asarray(scale)[self.idx], 0.0)


def export_blocks(
    cfg: SimConfig,
    block_size: int,
    cut_every: int = 0,
    block: int = DEFAULT_BLOCK,
    method: str = "greedy",
) -> EventBlocks:
    """Simulate ``cfg`` and export conflict-free event micro-blocks.

    `export_stream` followed by `segment_blocks` — the host-side feed of the
    blocked scan engine (``engine_scan.make_runner(block_size=...)``).
    ``method`` picks the cut placement ("greedy" | "dp").
    """
    return EventBlocks.from_stream(
        export_stream(cfg, block=block), block_size, cut_every, method
    )


def _split_delays(node: np.ndarray, value: np.ndarray, n: int) -> list:
    """Per-node lists from flat (node, value) event records, in event order."""
    out: list[list] = [[] for _ in range(n)]
    for j, v in zip(node.tolist(), value.tolist()):
        out[j].append(v)
    return out


def export_stream(cfg: SimConfig, block: int = DEFAULT_BLOCK) -> EventStream:
    """Simulate ``cfg`` and export the event stream as replayable arrays.

    The (J, K, t) trace is identical to what ``ClosedNetworkSim(cfg).run(T)``
    produces for the same seed/block.  On top of it we compute the FIFO slot
    assignment by replaying per-client queues of slot ids — an O(T) host pass.
    """
    sim = ClosedNetworkSim(cfg, block=block)
    C = cfg.C
    # initial placement: task ids 0..C-1 were enqueued in order, one per slot
    init_nodes = np.empty(C, dtype=np.int32)
    for node, q in enumerate(sim.queues):
        for tid, _, _ in q:
            init_nodes[tid] = node
    J, K, t = sim.run(cfg.T)
    kinds = sim.kind_trace
    slot = np.empty(cfg.T, dtype=np.int32)
    slot_queues: list[deque] = [deque() for _ in range(sim.n)]
    for s, node in enumerate(init_nodes):
        slot_queues[node].append(s)
    if kinds is None:
        for k in range(cfg.T):
            s = slot_queues[J[k]].popleft()  # FIFO: oldest in-flight completes
            slot[k] = s
            slot_queues[K[k]].append(s)      # freed slot hosts the new dispatch
        delay_steps = sim.delay_steps
    else:
        # fault mode: delays recomputed per trace row (the sim records only
        # completion delays, which no longer align 1:1 with the merged trace)
        slot_disp = np.zeros(C, dtype=np.int64)  # dispatch step + 1, per slot
        delay_steps = np.zeros(cfg.T, dtype=np.int64)
        for k in range(cfg.T):
            if kinds[k] == KIND_FLIP or kinds[k] == KIND_STAGE:
                slot[k] = C        # trash row: flips/stages touch no queue
                continue
            s = slot_queues[J[k]].popleft()
            slot[k] = s
            delay_steps[k] = k - slot_disp[s]
            slot_queues[K[k]].append(s)   # freed slot hosts the (re-)dispatch
            slot_disp[s] = k + 1
    return EventStream(
        J=J,
        K=K,
        t=t,
        slot=slot,
        init_nodes=init_nodes,
        n=sim.n,
        C=C,
        p=sim.p.copy(),
        delay_steps=delay_steps,
        queue_len_sum=sim.queue_len_sum,
        queue_len_tw=sim.queue_len_tw,
        kind=kinds,
    )


class ClosedNetworkSim:
    """Stepable simulator (used by repro.fl.engine to drive real training).

    ``block`` sets the RNG pre-draw block size; it changes the (deterministic)
    event stream but not its law.
    """

    def __init__(self, cfg: SimConfig, block: int = DEFAULT_BLOCK):
        self.cfg = cfg
        self.n = int(np.asarray(cfg.mu).size)
        self.mu = np.asarray(cfg.mu, dtype=np.float64)
        self.p = np.asarray(cfg.p, dtype=np.float64)
        if abs(self.p.sum() - 1.0) > 1e-8:
            raise ValueError("p must sum to 1")
        if cfg.C < 1:
            raise ValueError("C >= 1 required")
        if cfg.service not in ("exp", "det"):
            raise ValueError(f"unknown service kind {cfg.service}")
        self.rng = np.random.default_rng(cfg.seed)
        self.now = 0.0
        self.step_idx = 0
        # FIFO queue per node: deque of (task_id, dispatch_step, dispatch_time)
        self.queues: list[deque] = [deque() for _ in range(self.n)]
        # Event heap of (time, seq, node, kind).  Only the head-of-line task
        # of each node is in service; lazy invalidation via seq check.  The
        # kind column is constant KIND_COMPLETE without faults, so ordering
        # (by time, seq) — and hence the fault-free stream — is unchanged.
        self.heap: list[tuple[float, int, int, int]] = []
        self._seq = 0
        self._inservice_seq = [-1] * self.n
        # fault injection (churn / crash / straggler timeout)
        fc = cfg.fault
        self._fault = fc is not None and fc.enabled
        if self._fault:
            if cfg.service != "exp":
                raise ValueError("fault injection requires service='exp'")
            qoff, qon, kap, theta = fc.resolve(self.n)
            self._qoff, self._qon = qoff.tolist(), qon.tolist()
            self._kap, self._theta = kap.tolist(), theta.tolist()
            # separate RNG sub-stream: fault clocks never perturb the main
            # service/dispatch draw sequence
            self._frng = np.random.default_rng((cfg.seed, 0xFA17))
            self._avail = [True] * self.n
            self._timeout_seq = [-1] * self.n
            self._avail_tw = [0.0] * self.n   # integral of 1{available}
            self._avail_last_t = [0.0] * self.n
            self.kind_counts = np.zeros(4, np.int64)
        # scenario injection (phase-type service + modulated availability)
        sc = getattr(cfg, "scenario", None)
        self._scenario = sc is not None and sc.enabled
        if self._scenario:
            if self._fault:
                raise ValueError(
                    "scenario= and fault= are separate injection paths; "
                    "fold churn rates into the scenario's modulation instead"
                )
            if cfg.service != "exp":
                raise ValueError("scenario= requires service='exp' "
                                 "(the phase chain replaces the service law)")
            alpha, srates, absorb, nxt = sc.service.chain()
            self._sc_cdf = np.cumsum(alpha)
            self._sc_cdf[-1] = max(self._sc_cdf[-1], 1.0)
            self._sc_rates = srates.tolist()
            self._sc_absorb = [bool(b) for b in absorb]
            self._sc_nxt = [int(x) for x in nxt]
            self._sc_S = len(self._sc_rates)
            mod = sc.modulation
            if mod is None:
                from .scenario import ModulationConfig

                mod = ModulationConfig()
            qoff, qon = mod.resolve(self.n)
            self._qoff, self._qon = qoff.tolist(), qon.tolist()
            self._rate_scale = float(mod.rate_scale)
            # scenario clocks (flips + phase draws) live on their own RNG
            # sub-stream, mirroring the fault path's isolation guarantee
            self._frng = np.random.default_rng((cfg.seed, 0x5CE9))
            self._avail = [True] * self.n
            self._avail_tw = [0.0] * self.n
            self._avail_last_t = [0.0] * self.n
            self.kind_counts = np.zeros(N_KINDS, np.int64)
            self._task_phase: dict[int, int] = {}
        self.kind_trace: np.ndarray | None = None  # filled by run() (fault mode)
        # delay recording (opt-in): flat per-event arrays with doubling growth
        # — the completing node of record k is the k-th completion, so the
        # per-node view is derivable and never materialized here.
        self._record = bool(cfg.record_delays)
        self._dcap = 0
        self._dlen = 0
        self._d_node: np.ndarray | None = None
        self._d_steps: np.ndarray | None = None
        self._d_time: np.ndarray | None = None
        if self._record:
            self._dcap = max(int(cfg.T), 1024)
            self._d_node = np.empty(self._dcap, np.int32)
            # int64: a CS-step delay is bounded by T, which exceeds int32
            # range on T > 2^31 runs — int32 here silently wrapped
            self._d_steps = np.empty(self._dcap, np.int64)
            self._d_time = np.empty(self._dcap, np.float64)
        # incremental queue-length counters + lazily-flushed accumulators
        # (python lists: O(1) scalar access is much faster than numpy indexing)
        self._qlen = [0] * self.n
        self._qsum = [0] * self.n          # flushed part of sum_k X_{i,k}
        self._last_snap = [1] * self.n     # 1-indexed step of last change
        self._tw = [0.0] * self.n          # flushed part of int X_i(t) dt
        self._last_t = [0.0] * self.n      # time of last change
        self._inv_mu = (1.0 / self.mu).tolist()
        self._is_exp = cfg.service == "exp"
        # block-buffered variates
        self._block = int(block)
        cdf = np.cumsum(self.p)
        cdf[-1] = max(cdf[-1], 1.0)  # guard fp undershoot at the tail
        self._cdf = cdf
        self._disp_buf: list[int] = []
        self._disp_ptr = 0
        self._exp_buf: list[float] = []
        self._exp_ptr = 0
        self._task_counter = 0
        self._init_tasks()
        if self._fault or self._scenario:
            # all nodes start available; arm the first on->off flip clocks
            for node in range(self.n):
                if self._qoff[node] > 0:
                    self._push_flip(node, self._qoff[node])

    # -------------------------------------------------------------- #
    def _refill_disp(self) -> None:
        u = self.rng.random(self._block)
        self._disp_buf = np.minimum(
            np.searchsorted(self._cdf, u, side="right"), self.n - 1
        ).tolist()
        self._disp_ptr = 0

    def _refill_exp(self) -> None:
        self._exp_buf = self.rng.standard_exponential(self._block).tolist()
        self._exp_ptr = 0

    def _std_exp(self) -> float:
        """Next pre-drawn standard-exponential variate from the main stream."""
        i = self._exp_ptr
        if i >= len(self._exp_buf):
            self._refill_exp()
            i = 0
        self._exp_ptr = i + 1
        return self._exp_buf[i]

    def _service_time(self, node: int) -> float:
        if self._is_exp:
            return self._std_exp() * self._inv_mu[node]
        return self._inv_mu[node]

    def _change(self, node: int, delta: int) -> None:
        """Update node's queue length; settle its accumulators up to now.

        The post-step states X_{i,k} are counted once per step k=1..T and the
        time integral carries the pre-change state over (last_t, now]; both
        only need attention at the (two) nodes an event touches.
        """
        k = self.step_idx + 1
        ql = self._qlen[node]
        self._qsum[node] += ql * (k - self._last_snap[node])
        self._last_snap[node] = k
        self._tw[node] += ql * (self.now - self._last_t[node])
        self._last_t[node] = self.now
        self._qlen[node] = ql + delta

    def _start_service(self, node: int) -> None:
        if self._scenario:
            # stage clock of the head-of-line task: rate = mu * stage-rate *
            # modulation speed.  A zero rate (node off, rate_scale=0) suspends
            # service until the next flip re-arms it — memorylessness makes
            # the fresh redraw on resume exact in law.
            tid = self.queues[node][0][0]
            ph = self._task_phase[tid]
            speed = 1.0 if self._avail[node] else self._rate_scale
            rate = self.mu[node] * self._sc_rates[ph] * speed
            if rate <= 0.0:
                self._inservice_seq[node] = -2
                return
            self._seq += 1
            self._inservice_seq[node] = self._seq
            heapq.heappush(
                self.heap,
                (self.now + self._std_exp() / rate, self._seq, node, KIND_COMPLETE),
            )
            return
        self._seq += 1
        self._inservice_seq[node] = self._seq
        heapq.heappush(
            self.heap,
            (self.now + self._service_time(node), self._seq, node, KIND_COMPLETE),
        )
        if self._fault and self._kap[node] > 0:
            # crash races the completion; same seq — both die together when
            # the head task changes or the node flips off
            heapq.heappush(
                self.heap,
                (
                    self.now + self._frng.standard_exponential() / self._kap[node],
                    self._seq,
                    node,
                    KIND_CRASH,
                ),
            )

    def _push_flip(self, node: int, rate: float) -> None:
        self._seq += 1
        heapq.heappush(
            self.heap,
            (self.now + self._frng.standard_exponential() / rate, self._seq,
             node, KIND_FLIP),
        )

    def _schedule_head(self, node: int) -> None:
        """Arm the clocks of a new head-of-line task.

        Service (completion + crash) only runs while the node is available;
        the straggler timeout is a server-side deadline and fires regardless.
        In scenario mode `_start_service` itself handles modulated speeds
        (including suspension at rate 0) and there are no timeout clocks.
        """
        if not self._fault:
            self._start_service(node)
            return
        if self._avail[node]:
            self._start_service(node)
        if self._theta[node] > 0:
            self._seq += 1
            self._timeout_seq[node] = self._seq
            heapq.heappush(
                self.heap,
                (self.now + self._frng.standard_exponential() / self._theta[node],
                 self._seq, node, KIND_TIMEOUT),
            )

    def _settle_avail(self, node: int) -> None:
        if self._avail[node]:
            self._avail_tw[node] += self.now - self._avail_last_t[node]
        self._avail_last_t[node] = self.now

    @property
    def avail_tw(self) -> np.ndarray | None:
        """(n,) time integral of availability, flushed to `now` (fault mode)."""
        if not (self._fault or self._scenario):
            return None
        out = np.array(self._avail_tw, np.float64)
        pending = np.array(self._avail, np.float64) * (
            self.now - np.array(self._avail_last_t)
        )
        return out + pending

    def availability(self) -> np.ndarray | None:
        if not (self._fault or self._scenario):
            return None
        return np.array(self._avail, bool)

    def _enqueue(self, node: int, dispatch_step: int) -> int:
        tid = self._task_counter
        self._task_counter += 1
        if self._scenario:
            # the task's initial service stage is drawn at dispatch — by
            # independence of the stage sequence from the queue process this
            # is law-identical to drawing it at service start, and it is what
            # the device stream does (one phase draw per dispatch)
            u = self._frng.random()
            self._task_phase[tid] = min(
                int(np.searchsorted(self._sc_cdf, u, side="right")), self._sc_S - 1
            )
        self.queues[node].append((tid, dispatch_step, self.now))
        self._change(node, +1)
        if len(self.queues[node]) == 1:
            self._schedule_head(node)
        return tid

    def _init_tasks(self) -> None:
        if self.cfg.initial == "distinct":
            if self.cfg.C > self.n:
                # spread round-robin when C > n (paper uses C <= n for S_0,
                # but saturated-regime experiments need C >> n)
                nodes = [i % self.n for i in range(self.cfg.C)]
            else:
                nodes = list(
                    self.rng.choice(self.n, size=self.cfg.C, replace=False, p=None)
                )
        elif self.cfg.initial == "sampled":
            nodes = list(self.rng.choice(self.n, size=self.cfg.C, p=self.p))
        else:
            raise ValueError(self.cfg.initial)
        for nd in nodes:
            self._enqueue(int(nd), dispatch_step=0)

    # -------------------------------------------------------------- #
    def _grow_delay_buffers(self) -> None:
        self._dcap *= 2
        for name in ("_d_node", "_d_steps", "_d_time"):
            buf = getattr(self, name)
            new = np.empty(self._dcap, buf.dtype)
            new[: self._dlen] = buf[: self._dlen]
            setattr(self, name, new)

    @property
    def delay_steps(self) -> np.ndarray | None:
        """(k,) flat CS-step delays in completion order (node k is J_k)."""
        if not self._record:
            return None
        return self._d_steps[: self._dlen].copy()

    @property
    def delays(self) -> list[list[int]] | None:
        """Per-node CS-step delays (derived view; None unless record_delays)."""
        if not self._record:
            return None
        return _split_delays(self._d_node[: self._dlen], self._d_steps[: self._dlen], self.n)

    @property
    def time_delays(self) -> list[list[float]] | None:
        """Per-node physical-time sojourns (derived view)."""
        if not self._record:
            return None
        return _split_delays(self._d_node[: self._dlen], self._d_time[: self._dlen], self.n)

    def total_tasks(self) -> int:
        return sum(self._qlen)

    def queue_lengths(self) -> np.ndarray:
        return np.array(self._qlen)

    @property
    def queue_len_sum(self) -> np.ndarray:
        """sum_{k=1..step_idx} X_{i,k} (post-step states), flushed on read."""
        q = np.array(self._qlen, dtype=np.float64)
        pending = q * (self.step_idx + 1 - np.array(self._last_snap))
        return np.array(self._qsum, dtype=np.float64) + pending

    @property
    def queue_len_tw(self) -> np.ndarray:
        """int_0^now X_i(t) dt, flushed on read."""
        q = np.array(self._qlen, dtype=np.float64)
        pending = q * (self.now - np.array(self._last_t))
        return np.array(self._tw, dtype=np.float64) + pending

    def step_event(self) -> tuple[int, int, int]:
        """Advance one merged-CTMC event.  Returns ``(kind, node, k_new)``.

        Without faults every event is a completion, so this is exactly one CS
        step.  With faults ``kind`` is a ``KIND_*`` tag: task movements
        (complete / crash / timeout) pop the head-of-line task at ``node`` and
        re-dispatch it at ``k_new ~ p``; availability flips toggle ``node``
        and return ``k_new = -1``.  ``step_idx`` counts merged events —
        exactly the scan-step counter of the device fault stream, so delays
        measured in steps agree between the two paths.
        """
        heap = self.heap
        inservice = self._inservice_seq
        fault = self._fault
        while True:
            t_ev, seq, node, kind = heapq.heappop(heap)
            if kind == KIND_FLIP:
                break  # exactly one outstanding flip per node — always valid
            if kind == KIND_TIMEOUT:
                if self._timeout_seq[node] == seq:
                    break
            elif inservice[node] == seq:
                break
        self.now = t_ev
        if kind == KIND_FLIP:
            self._settle_avail(node)
            up = not self._avail[node]
            self._avail[node] = up
            if self._scenario:
                # modulated speed changed: invalidate and re-arm the stage
                # clock at the new rate (exact by memorylessness; the task's
                # phase is preserved).  rate_scale=0 leaves it suspended.
                self._inservice_seq[node] = -2
                if self._qlen[node] > 0:
                    self._start_service(node)
                rate = self._qoff[node] if up else self._qon[node]
                if rate > 0:
                    self._push_flip(node, rate)
            elif up:
                if self._qlen[node] > 0:
                    self._start_service(node)  # memoryless: fresh service draw
                if self._qoff[node] > 0:
                    self._push_flip(node, self._qoff[node])
            else:
                self._inservice_seq[node] = -2  # suspend completion + crash
                if self._qon[node] > 0:
                    self._push_flip(node, self._qon[node])
            self.step_idx += 1
            self.kind_counts[KIND_FLIP] += 1
            return KIND_FLIP, node, -1
        if self._scenario:
            # a stage clock fired: absorb (fall through to the completion
            # path below) or advance the head task to its next stage
            tid = self.queues[node][0][0]
            ph = self._task_phase[tid]
            if not self._sc_absorb[ph]:
                self._task_phase[tid] = self._sc_nxt[ph]
                self._start_service(node)
                self.step_idx += 1
                self.kind_counts[KIND_STAGE] += 1
                return KIND_STAGE, node, -1
            del self._task_phase[tid]
            self.kind_counts[KIND_COMPLETE] += 1
            self._inservice_seq[node] = -2
        # task movement: complete / crash / timeout pops the head-of-line task
        q = self.queues[node]
        tid, disp_step, disp_time = q.popleft()
        if kind == KIND_COMPLETE and self._record:
            # delay in CS steps: completions strictly between dispatch and this
            i = self._dlen
            if i >= self._dcap:
                self._grow_delay_buffers()
            self._d_node[i] = node
            self._d_steps[i] = self.step_idx - disp_step
            self._d_time[i] = t_ev - disp_time
            self._dlen = i + 1
        self._change(node, -1)
        if fault:
            self._inservice_seq[node] = -2  # kill the crash/completion sibling
            self._timeout_seq[node] = -2
            self.kind_counts[kind] += 1
        if q:
            self._schedule_head(node)
        # dispatcher samples the next client from the pre-drawn block
        i = self._disp_ptr
        if i >= len(self._disp_buf):
            self._refill_disp()
            i = 0
        self._disp_ptr = i + 1
        k_new = self._disp_buf[i]
        self._enqueue(k_new, dispatch_step=self.step_idx + 1)
        self.step_idx += 1
        return kind, node, k_new

    def step(self) -> tuple[int, int]:
        """Advance one CS step.  Returns (J_k, K_{k+1}).

        With faults enabled this advances one *merged* event (which may be a
        flip, returning K = -1) — fault-aware callers should use `step_event`
        to see the kind tag.
        """
        _, node, k_new = self.step_event()
        return node, k_new

    def run(self, T: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Advance T steps, returning the (J, K, t) trace arrays.

        In fault mode the per-event kind tags of this run are kept in
        ``self.kind_trace`` (int8, aligned with the returned arrays).
        """
        step_event = self.step_event
        Jl: list[int] = []
        Kl: list[int] = []
        tl: list[float] = []
        kl: list[int] | None = [] if (self._fault or self._scenario) else None
        append_J, append_K, append_t = Jl.append, Kl.append, tl.append
        for _ in range(T):
            kind, j, k_new = step_event()
            append_J(j)
            append_K(k_new)
            append_t(self.now)
            if kl is not None:
                kl.append(kind)
        if kl is not None:
            self.kind_trace = np.array(kl, dtype=np.int8)
        return (
            np.array(Jl, dtype=np.int32),
            np.array(Kl, dtype=np.int32),
            np.array(tl, dtype=np.float64),
        )


def simulate_batch(cfg: SimConfig, block: int = DEFAULT_BLOCK) -> SimResult:
    """Fast-path simulation: pre-drawn RNG blocks + the O(1)-per-event core."""
    sim = ClosedNetworkSim(cfg, block=block)
    J, K, t = sim.run(cfg.T)
    return SimResult(
        J=J,
        K=K,
        t=t,
        delays=sim.delays,
        time_delays=sim.time_delays,
        queue_len_sum=sim.queue_len_sum,
        queue_len_tw=sim.queue_len_tw,
        queue_len_last=sim.queue_lengths(),
        steps=cfg.T,
    )


def simulate(cfg: SimConfig) -> SimResult:
    return simulate_batch(cfg)
