"""Resilient serving plane: an open inference queue coupled to the closed
training network, in PyTorch.

The counterpart of `repro.core.serving`.  Inference requests form an open
Poisson stream merged into the engine's event race
(`stream_device.merged_stream_step`): every competing clock (client
completions, faults, request arrivals, service completions, per-request
deadline timeouts, retry-backoff releases) is exponential, so the merged
system stays a CTMC and one pre-drawn uniform pair per event still drives
it exactly in law.

Robustness envelope (`ServingConfig`, the reference's fields):

  * token-bucket admission (``bucket_rate`` / ``bucket_cap``, refilled
    lazily at arrival epochs) and load shedding above the queue-depth cap
    ``queue_cap``, so the in-system depth is bounded whatever the load;
  * deadline timeouts (an ``Exp(1/deadline)`` clock per queued request)
    with capped exponential backoff: a timed-out request retries after an
    ``Exp(1/delay)`` hold, ``delay = min(backoff_base * 2**attempt,
    backoff_cap)``, until ``max_retries`` is spent, then is evicted;
  * known-good reads: a serve answers from the snapshot ring's row at the
    known-good pointer, the row of the most recent *accepted* update, so a
    guard-rejected update is never served; the staleness ``k - kg_step``
    of each serve is histogrammed.

Every transition is a masked write on fixed-shape tensors (the reference's
out-of-range ``mode="drop"`` scatters at index R write the old value back
here), so a run makes no host sync.  State tensors may carry a leading
cell axis.  Integer state is int64 (torch's index dtype) where the
reference keeps int32; the values are the same.

Where the reference's arithmetic is held bitwise, the port rounds as XLA's
CPU backend does: the (2R + 2,) cumulative rate vector ``cdf`` is summed
in XLA's order (`_xla_cumsum`: rows of 16, each left to right, then the
rows' running totals added), not by `torch.cumsum`, which accumulates fp32
in float64 on the CPU; a product feeding an add (the bucket refill, the
depth integral's compensated add) is rounded once, as XLA contracts it to
a fused multiply-add (`stream_device.fma32`); and the histogram bucket is
``floor(log2(x))`` in float32, kept as those two ops.

`simulate_serving_host` is the reference's numpy oracle of the serving
marginal, copied so that it gives the same numbers for the same seed.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from functools import lru_cache
from typing import Any, NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from .stream_device import fma32, kahan_add, kahan_value

__all__ = [
    "HIST_BUCKETS",
    "HIST_LO",
    "ServingConfig",
    "ServeState",
    "ServeStats",
    "serve_init",
    "serve_stats_init",
    "serve_total_rate",
    "serve_depth",
    "serve_time_step",
    "serve_apply",
    "backoff_delay",
    "hist_bucket",
    "hist_quantile",
    "serve_extras",
    "drain_counters",
    "simulate_serving_host",
]

#: number of log2 buckets in the sojourn / staleness histograms
HIST_BUCKETS = 24
#: sojourn histogram: bucket i covers [2**(i + HIST_LO), 2**(i + 1 + HIST_LO))
HIST_LO = -10

_I64 = torch.int64
_F32 = torch.float32


@dataclass(frozen=True)
class ServingConfig:
    """The serving plane's traffic and robustness envelope.

    ``arrival_rate`` (lambda) and ``serve_rate`` (nu) are in the time unit
    of the training network's ``mu``; ``deadline`` is the *mean* of the
    exponential per-request deadline; ``backoff_base`` / ``backoff_cap``
    bound the mean retry delay ``min(base * 2**attempt, cap)``.
    ``queue_cap`` is the admission threshold on in-system depth;
    ``table_cap`` (>= queue_cap; 0 = auto ``queue_cap + max_retries + 1``)
    sizes the static request table, which also holds backoff parkers.
    ``bucket_rate <= 0`` disables the token bucket (depth-only admission).
    """

    arrival_rate: float = 0.0
    serve_rate: float = 1.0
    queue_cap: int = 8
    bucket_rate: float = 0.0
    bucket_cap: float = 8.0
    deadline: float = 0.0
    max_retries: int = 2
    backoff_base: float = 0.25
    backoff_cap: float = 2.0
    table_cap: int = 0

    @property
    def enabled(self) -> bool:
        return float(self.arrival_rate) > 0.0

    @property
    def R(self) -> int:
        """Static request-table capacity."""
        if int(self.table_cap) > 0:
            return int(self.table_cap)
        return int(self.queue_cap) + int(self.max_retries) + 1

    def validate(self) -> "ServingConfig":
        if self.enabled:
            if float(self.serve_rate) <= 0:
                raise ValueError("serve_rate must be > 0")
            if int(self.queue_cap) < 1:
                raise ValueError("queue_cap must be >= 1")
            if self.R < int(self.queue_cap):
                raise ValueError("table_cap must be >= queue_cap")
            if float(self.backoff_base) <= 0 or float(self.backoff_cap) <= 0:
                raise ValueError("backoff_base/backoff_cap must be > 0")
        return self

    def cache_key(self):
        return (
            float(self.arrival_rate), float(self.serve_rate),
            int(self.queue_cap), float(self.bucket_rate),
            float(self.bucket_cap), float(self.deadline),
            int(self.max_retries), float(self.backoff_base),
            float(self.backoff_cap), int(self.R),
        )


class _Consts:
    """A configuration's float32 constants on one device, each rounded from
    the Python float once, as ``jnp.float32(v)`` rounds it.  Made once (by
    fills, `_consts`): a tensor made from a Python float on every event
    would copy from the host and wait for the copy."""

    def __init__(self, cfg: ServingConfig, dev: torch.device):
        f = lambda v: torch.full((), float(v), dtype=_F32, device=dev)  # noqa: E731
        self.arrival, self.serve = f(cfg.arrival_rate), f(cfg.serve_rate)
        self.inv_deadline = f(1.0 / cfg.deadline) if float(cfg.deadline) > 0 else None
        self.base, self.cap = f(cfg.backoff_base), f(cfg.backoff_cap)
        self.bucket_rate, self.bucket_cap = f(cfg.bucket_rate), f(cfg.bucket_cap)
        self.zero = f(0.0)
        # the release rate of a parked request by its attempt count (0 ..
        # max_retries, the counts a table slot can hold), by `backoff_delay`'s
        # own ops: a gather a step instead of its six
        att = torch.arange(int(cfg.max_retries) + 1, device=dev)
        a = torch.clamp_min(att.to(_F32) - 1.0, 0.0)
        self.release = 1.0 / torch.minimum(self.base * torch.exp2(a), self.cap)


@lru_cache(maxsize=None)
def _consts(cfg: ServingConfig, dev: torch.device) -> _Consts:
    return _Consts(cfg, dev)


def backoff_delay(cfg: ServingConfig, attempt) -> torch.Tensor:
    """Mean backoff delay before retry number ``attempt`` (1-based):
    ``min(backoff_base * 2**(attempt - 1), backoff_cap)``, capped
    exponential backoff.  ``attempt`` is a tensor, an array or an int."""
    a = torch.as_tensor(np.asarray(attempt) if not isinstance(attempt, torch.Tensor)
                        else attempt)
    k = _consts(cfg, a.device)
    a = torch.clamp_min(a.to(_F32) - 1.0, 0.0)
    return torch.minimum(k.base * torch.exp2(a), k.cap)


# request states in ServeState.stt
_FREE, _QUEUED, _BACKOFF = 0, 1, 2
_SEQ_MAX = 2**31 - 1


class ServeState(NamedTuple):
    """Device state of the open serving queue (one cell, or B along a
    leading axis).

    ``stt`` is the per-slot request state (0 free / 1 queued / 2 in
    backoff); ``seq`` the FIFO stamp (service pops the minimum);
    ``kg_slot`` / ``kg_step`` the known-good pointer: the ring row and
    server step of the most recent *accepted* training update.  ``depth``
    and ``cdf`` are caches of the table (the in-system count, and the
    cumulative sum of the (2R + 2,) rate vector `_rates`, so ``cdf[-1]``
    is `serve_total_rate`), recomputed at `serve_apply`'s commit only.
    """

    t_arr: Any     # (R,) float32: first-arrival time of the request
    attempt: Any   # (R,) int64: retries consumed (0 on the first attempt)
    stt: Any       # (R,) int64: _FREE / _QUEUED / _BACKOFF
    seq: Any       # (R,) int64: FIFO stamp (re-stamped on retry release)
    next_seq: Any  # () int64
    tokens: Any    # () float32: token bucket level
    t_tok: Any     # () float32: last lazy bucket refill time
    depth: Any     # () int64: cached in-system count (== serve_depth)
    cdf: Any       # (2R+2,) float32: cached cumulative sum of `_rates`
    kg_slot: Any   # () int64: snapshot-ring row of the known-good iterate
    kg_step: Any   # () int64: server step that wrote it


class ServeStats(NamedTuple):
    """Serving observables; float accumulators are Kahan pairs."""

    arrivals: Any    # () int64: every Poisson arrival, admitted or not
    served: Any      # () int64
    shed: Any        # () int64: rejected at admission (bucket or depth)
    timed_out: Any   # () int64: evicted after exhausting the retry budget
    retried: Any     # () int64: deadline hits that re-entered via backoff
    sojourn: Any     # () float32: Kahan sum of served sojourn times
    sojourn_c: Any
    qdepth_tw: Any   # () float32: time integral of in-system depth
    qdepth_tw_c: Any
    qdepth_max: Any  # () int64: max in-system depth ever observed
    sojourn_hist: Any  # (HIST_BUCKETS,) int64: log2 sojourn buckets
    stale_hist: Any    # (HIST_BUCKETS,) int64: log2 served-staleness buckets
    checksum: Any    # () float32: Kahan sum over serves of the served
    checksum_c: Any  # snapshot row's mean (the serving read path)


def serve_init(cfg: ServingConfig, *, cells: int | None = None, device="cuda") -> ServeState:
    """The empty request table (with a leading axis of ``cells``)."""
    device = resolve_device(device)
    R = cfg.R
    lead = () if cells is None else (cells,)
    zi = lambda *s: torch.zeros((*lead, *s), dtype=_I64, device=device)  # noqa: E731
    zf = lambda *s: torch.zeros((*lead, *s), dtype=_F32, device=device)  # noqa: E731
    return ServeState(
        t_arr=zf(R), attempt=zi(R), stt=zi(R), seq=zi(R), next_seq=zi(),
        tokens=torch.full(lead, float(np.float32(cfg.bucket_cap)), dtype=_F32, device=device),
        t_tok=zf(), depth=zi(),
        # empty table: only the arrival clock runs, so the cumulative rate
        # vector is flat at lambda, what cumsum(_rates) gives
        cdf=torch.full((*lead, 2 * R + 2), float(np.float32(cfg.arrival_rate)), dtype=_F32,
                       device=device),
        kg_slot=zi(), kg_step=zi(),
    )


def serve_stats_init(*, cells: int | None = None, device="cuda") -> ServeStats:
    device = resolve_device(device)
    lead = () if cells is None else (cells,)
    zi = lambda *s: torch.zeros((*lead, *s), dtype=_I64, device=device)  # noqa: E731
    zf = lambda: torch.zeros(lead, dtype=_F32, device=device)  # noqa: E731
    return ServeStats(
        arrivals=zi(), served=zi(), shed=zi(), timed_out=zi(), retried=zi(),
        sojourn=zf(), sojourn_c=zf(), qdepth_tw=zf(), qdepth_tw_c=zf(),
        qdepth_max=zi(), sojourn_hist=zi(HIST_BUCKETS), stale_hist=zi(HIST_BUCKETS),
        checksum=zf(), checksum_c=zf(),
    )


def _seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right fp32 running sums over the last axis, one add a column."""
    acc = x[..., 0]
    out = [acc]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
        out.append(acc)
    return torch.stack(out, dim=-1)


#: the row length of XLA's CPU cumulative sum (its reduce-window rewrite)
_XLA_SCAN_BASE = 16


def _xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """``jnp.cumsum`` over the last axis, bitwise as XLA's CPU backend sums
    it: up to 16 values left to right; beyond, the zero-padded rows of 16
    each left to right, plus the left-to-right running total of the rows
    before.  Elementwise fp32 adds only, so the card gives the same bits."""
    n = x.shape[-1]
    if n <= _XLA_SCAN_BASE:
        return _seq_cumsum(x)
    m = -(-n // _XLA_SCAN_BASE)
    rows = _seq_cumsum(torch.nn.functional.pad(x, (0, m * _XLA_SCAN_BASE - n)).reshape(
        *x.shape[:-1], m, _XLA_SCAN_BASE))
    before = _xla_cumsum(rows[..., -1])[..., :-1]
    before = torch.cat([torch.zeros_like(before[..., :1]), before], dim=-1)
    out = (rows + before[..., None]).reshape(*x.shape[:-1], m * _XLA_SCAN_BASE)
    return out[..., :n].contiguous()


def _rates(cfg: ServingConfig, sv: ServeState) -> torch.Tensor:
    """The serving side's (2R + 2,) competing-clock rate vector:
    ``[arrival | service | R deadline clocks | R backoff releases]``."""
    k = _consts(cfg, sv.stt.device)
    queued = sv.stt == _QUEUED
    lead = sv.stt.shape[:-1]
    r_arr = k.arrival.expand(*lead, 1)
    r_srv = torch.where(queued.any(-1, keepdim=True), k.serve, k.zero)
    if k.inv_deadline is not None:
        r_tmo = torch.where(queued, k.inv_deadline, k.zero)
    else:
        r_tmo = torch.zeros_like(sv.t_arr)
    rel = k.release.gather(0, torch.clamp_max(sv.attempt, int(cfg.max_retries)).reshape(-1))
    r_rel = torch.where(sv.stt == _BACKOFF, rel.view(sv.attempt.shape), k.zero)
    return torch.cat([r_arr, r_srv, r_tmo, r_rel], dim=-1)


def serve_total_rate(cfg: ServingConfig, sv: ServeState) -> torch.Tensor:
    """Total serving-side event rate: the open stream's share of the merged
    race (`stream_device.merged_stream_step`'s ``ext_rate``)."""
    return _xla_cumsum(_rates(cfg, sv))[..., -1]


def serve_depth(sv: ServeState) -> torch.Tensor:
    """In-system request count (queued + backoff)."""
    return torch.sum(sv.stt != _FREE, dim=-1)


def serve_time_step(stats: ServeStats, sv: ServeState, dt) -> ServeStats:
    """Time-integral accumulation over one merged event of duration ``dt``
    (training and serving events both advance the clock, so this runs on
    every event, before the transition), from the cached ``sv.depth``."""
    d = sv.depth
    # the compensated add of d * dt, its first difference fused as XLA fuses it
    y = fma32(d.to(_F32), torch.as_tensor(dt), -stats.qdepth_tw_c)
    qtw = stats.qdepth_tw + y
    qtw_c = (qtw - stats.qdepth_tw) - y
    return stats._replace(qdepth_tw=qtw, qdepth_tw_c=qtw_c,
                          qdepth_max=torch.maximum(stats.qdepth_max, d))


def hist_bucket(x, lo: int = HIST_LO) -> torch.Tensor:
    """log2 bucket index of a positive float32 (clipped into range):
    ``floor(log2(x))`` in float32, as the reference computes it."""
    xb = torch.clamp_min(torch.as_tensor(x).to(_F32), 1e-30)
    b = torch.floor(torch.log2(xb)).to(_I64) - lo
    return torch.clamp(b, 0, HIST_BUCKETS - 1)


def _take(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``a[..., i]`` with one index per leading position."""
    return a.gather(-1, i[..., None])[..., 0]


def _put(a: torch.Tensor, i: torch.Tensor, value, R: int) -> torch.Tensor:
    """``a.at[..., i].set(value, mode="drop")`` with ``i == R`` the dropped
    index: the old value is written back there."""
    pos = torch.clamp_max(i, R - 1)[..., None]
    value = torch.as_tensor(value, dtype=a.dtype, device=a.device).expand(i.shape)
    return a.scatter(-1, pos, torch.where((i < R)[..., None], value[..., None], a.gather(-1, pos)))


def _count(hist: torch.Tensor, bucket: torch.Tensor, on: torch.Tensor) -> torch.Tensor:
    """``hist.at[..., where(on, bucket, HIST_BUCKETS)].add(1, mode="drop")``."""
    return hist.scatter_add(-1, bucket[..., None], on.to(_I64)[..., None])


def _serve_table(cfg: ServingConfig, sv: ServeState, stats: ServeStats, u, t, live):
    """The request table's half of `serve_apply`: which clock fired and its
    transition, the counters and the sojourn statistics.  Returns ``(sv',
    stats', is_srv)``; the read path (`_serve_read`) is the other half,
    which needs the known-good pointer at that event.  Nothing here reads
    the pointer or the ring, so the fused runner runs this half with the
    stream, a chunk ahead of the replay."""
    R = cfg.R
    dev = sv.stt.device
    kc = _consts(cfg, dev)
    cdf = sv.cdf  # cached cumulative rates over the pre-event table
    idx = torch.searchsorted(cdf, (u * cdf[..., -1])[..., None], right=True)[..., 0]
    lv = torch.as_tensor(live, dtype=torch.bool, device=dev)
    stt0 = sv.stt
    queued = stt0 == _QUEUED
    free = stt0 == _FREE
    it_raw = torch.clamp(idx - 2, 0, R - 1)
    ir_raw = torch.clamp(idx - (R + 2), 0, R - 1)
    is_arr = lv & (idx == 0)
    is_srv = lv & (idx == 1) & queued.any(-1)
    is_tmo = lv & (idx >= 2) & (idx < R + 2) & (_take(stt0, it_raw) == _QUEUED)
    is_rel = lv & (idx >= R + 2) & (idx < 2 * R + 2) & (_take(stt0, ir_raw) == _BACKOFF)

    # arrival: token bucket + depth admission, the bucket refilled lazily
    tok_ref = torch.minimum(kc.bucket_cap, fma32(kc.bucket_rate, t - sv.t_tok, sv.tokens))
    admit = is_arr & free.any(-1) & (sv.depth < int(cfg.queue_cap))
    if float(cfg.bucket_rate) > 0.0:
        admit = admit & (tok_ref >= 1.0)
    i_free = torch.argmax(free.to(_I64), dim=-1)
    tokens = torch.where(is_arr, tok_ref - admit.to(_F32), sv.tokens)
    t_tok = torch.where(is_arr, t, sv.t_tok)

    # service completion: the FIFO head
    i_head = torch.argmin(torch.where(queued, sv.seq, _SEQ_MAX), dim=-1)
    sj = t - _take(sv.t_arr, i_head)

    # deadline timeout: retry via backoff, or evict
    exhausted = _take(sv.attempt, it_raw) >= int(cfg.max_retries)
    evict = is_tmo & exhausted
    retry = is_tmo & ~exhausted

    # commit: one masked write per table column (index R drops)
    none = torch.full_like(idx, R)
    i_upd = torch.where(admit, i_free, torch.where(is_srv, i_head, torch.where(
        is_tmo, it_raw, torch.where(is_rel, ir_raw, none))))
    new_stt = torch.where(admit | is_rel, _QUEUED, torch.where(retry, _BACKOFF, _FREE))
    stt = _put(stt0, i_upd, new_stt, R)
    seq = _put(sv.seq, torch.where(admit | is_rel, i_upd, none), sv.next_seq, R)
    att_val = torch.where(admit, 0, _take(sv.attempt, it_raw) + 1)
    attempt = _put(sv.attempt, torch.where(admit | retry, i_upd, none), att_val, R)
    t_arr = _put(sv.t_arr, torch.where(admit, i_free, none), t, R)
    sv = ServeState(
        t_arr=t_arr, attempt=attempt, stt=stt, seq=seq,
        next_seq=sv.next_seq + (admit | is_rel),
        tokens=tokens, t_tok=t_tok,
        depth=sv.depth + admit - (is_srv | evict).to(_I64),
        cdf=sv.cdf, kg_slot=sv.kg_slot, kg_step=sv.kg_step,
    )
    # refresh the rate cache from the committed table; on a masked
    # (``~live``) call the table is unchanged and so is the cache
    sv = sv._replace(cdf=_xla_cumsum(_rates(cfg, sv)))

    sojourn, sojourn_c = kahan_add(stats.sojourn, stats.sojourn_c,
                                   torch.where(is_srv, sj, kc.zero))
    stats = stats._replace(  # int64 + bool adds as int64
        arrivals=stats.arrivals + is_arr,
        served=stats.served + is_srv,
        shed=stats.shed + (is_arr & ~admit),
        timed_out=stats.timed_out + evict,
        retried=stats.retried + retry,
        sojourn=sojourn, sojourn_c=sojourn_c,
        sojourn_hist=_count(stats.sojourn_hist, hist_bucket(sj), is_srv),
    )
    return sv, stats, is_srv


def _serve_read(stats: ServeStats, is_srv, row_mean, k, kg_step) -> ServeStats:
    """The read path's statistics of one event: the served row's mean into
    the checksum and the staleness ``k - kg_step`` into its histogram,
    both masked to serve completions."""
    checksum, checksum_c = kahan_add(stats.checksum, stats.checksum_c,
                                     torch.where(is_srv, row_mean, 0.0))
    staleness = torch.as_tensor(k, device=kg_step.device).sub(kg_step).to(_F32)
    bucket = hist_bucket(torch.clamp_min(staleness, 1.0), lo=0)
    return stats._replace(checksum=checksum, checksum_c=checksum_c,
                          stale_hist=_count(stats.stale_hist, bucket, is_srv))


def _row_mean(snaps: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """The fp32 mean of the snapshot ring's row ``slot`` (one cell's
    ``(rows, P)`` ring)."""
    return snaps.index_select(0, slot.reshape(1))[0].float().mean()


def serve_apply(cfg: ServingConfig, sv: ServeState, stats: ServeStats, u, t, k, snaps,
                live=True):
    """Resolve one serving event: which clock fired, and its transition.

    ``u`` is the conditional uniform from the merged race, ``t`` the
    post-event clock, ``k`` the server step, ``snaps`` the ``(C, P)``
    snapshot ring (one cell's).  Every transition is a masked write, so the
    engine calls it on every merged event with ``live = is_ext``: when
    ``live`` is False every flag masks off and the call leaves ``sv`` and
    ``stats`` as they were (the Kahan pairs take the reference's add of
    0).  The clock is drawn by inverse CDF over the cached ``cdf``
    (``searchsorted(..., right=True)`` skips zero-rate clocks) and the
    state guards turn a draw past the last positive rate into a no-op.  A
    serve completion answers from ``snaps[sv.kg_slot]``: its fp32 mean
    (computed on every call, then masked) enters the checksum and the
    staleness ``k - kg_step`` its histogram.  Returns ``(sv', stats')``.
    """
    kg_slot = sv.kg_slot
    sv, stats, is_srv = _serve_table(cfg, sv, stats, u, t, live)
    return sv, _serve_read(stats, is_srv, _row_mean(snaps, kg_slot), k, sv.kg_step)


class ServeLoop:
    """The serving plane's half of a fused run, one chunk at a time.

    The stream pass (`stream_device._advance`) asks `rate` for each event's
    ``ext_rate`` and hands each merged event to `step` (the pre-event depth
    integral, then `_serve_table`, recording whether a serve completed);
    the replay then runs `read` at each event, in event order, after the
    event's update: the known-good pointer moves on an accepted update and
    a serve completion reads the ring's row there.  ``sv`` and ``stats``
    carry a leading cell axis B."""

    def __init__(self, cfg: ServingConfig, sv: ServeState, stats: ServeStats):
        self.cfg, self.sv, self.stats = cfg, sv, stats
        self.srv: list = []
        _consts(cfg, sv.stt.device)  # the constants, before any event

    def rate(self) -> torch.Tensor:
        return self.sv.cdf[..., -1]

    def step(self, dt, t, is_ext, u_ext) -> None:
        self.stats = serve_time_step(self.stats, self.sv, dt)
        self.sv, self.stats, srv = _serve_table(self.cfg, self.sv, self.stats, u_ext, t, is_ext)
        self.srv.append(srv)

    def chunk_served(self) -> torch.Tensor:
        """The (B, L) serve-completion flags of the chunk streamed since the
        last call."""
        srv, self.srv = torch.stack(self.srv, dim=-1), []
        return srv

    def extras(self, t_final) -> dict:
        """The reference's ``serve_*`` extras of the run, device tensors."""
        sv, st = self.sv, self.stats
        return {
            "serve_arrivals": st.arrivals,
            "serve_served": st.served,
            "serve_shed": st.shed,
            "serve_timed_out": st.timed_out,
            "serve_retried": st.retried,
            "serve_pending": serve_depth(sv),
            "serve_sojourn_sum": st.sojourn - st.sojourn_c,
            "serve_sojourn_hist": st.sojourn_hist,
            "serve_stale_hist": st.stale_hist,
            "serve_qdepth_time": st.qdepth_tw - st.qdepth_tw_c,
            "serve_qdepth_max": st.qdepth_max,
            "serve_checksum": st.checksum - st.checksum_c,
            "serve_kg_step": sv.kg_step,
            "serve_kg_slot": sv.kg_slot,
            "serve_tokens": sv.tokens,
            "serve_t_final": t_final,
        }

    def read(self, slot, accepted, k, row_mean, srv) -> None:
        """One event of the replay: ``accepted`` moves the pointer to ``slot``
        and step ``k + 1``; ``row_mean(kg_slot)`` is the served row's mean."""
        sv = self.sv
        kg_slot = torch.where(accepted, slot, sv.kg_slot)
        kg_step = torch.where(accepted, k + 1, sv.kg_step)
        self.sv = sv._replace(kg_slot=kg_slot, kg_step=kg_step)
        self.stats = _serve_read(self.stats, srv, row_mean(kg_slot), k, kg_step)


# ------------------------------------------------------------------ #
# host-side readout
# ------------------------------------------------------------------ #
def hist_quantile(hist, q: float, lo: int = HIST_LO) -> float:
    """Approximate quantile from a log2-bucket histogram (geometric
    midpoint of the bucket where the cumulative mass crosses ``q``)."""
    h = _np(hist).astype(np.float64)
    total = h.sum()
    if total <= 0:
        return float("nan")
    cum = np.cumsum(h)
    b = int(np.searchsorted(cum, q * total))
    b = min(b, len(h) - 1)
    return float(2.0 ** (b + lo + 0.5))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def drain_counters(sv: ServeState, stats: ServeStats) -> dict:
    """End-of-run drain: requests still in flight when the run stops are
    flushed into ``timed_out`` (server-shutdown semantics) and reported
    separately as ``pending``, so ``served + shed + timed_out ==
    arrivals`` holds exactly."""
    pending = int(np.sum(_np(sv.stt) != _FREE))
    return {
        "arrivals": int(stats.arrivals),
        "served": int(stats.served),
        "shed": int(stats.shed),
        "timed_out": int(stats.timed_out) + pending,
        "retried": int(stats.retried),
        "pending_drained": pending,
    }


def serve_extras(cfg: ServingConfig, sv: ServeState, stats: ServeStats, t_final) -> dict:
    """Host-readable serving extras dict (counters, quantiles, SLO view)."""
    out = drain_counters(sv, stats)
    served = max(out["served"], 1)
    t = float(_np(t_final).astype(np.float64))
    out.update(
        sojourn_mean=float(kahan_value(stats.sojourn, stats.sojourn_c)) / served,
        sojourn_p50=hist_quantile(stats.sojourn_hist, 0.50),
        sojourn_p99=hist_quantile(stats.sojourn_hist, 0.99),
        staleness_p50=hist_quantile(stats.stale_hist, 0.50, lo=0),
        staleness_p99=hist_quantile(stats.stale_hist, 0.99, lo=0),
        qdepth_mean=float(kahan_value(stats.qdepth_tw, stats.qdepth_tw_c)) / max(t, 1e-30),
        qdepth_max=int(stats.qdepth_max),
        checksum=float(kahan_value(stats.checksum, stats.checksum_c)),
        kg_step=int(sv.kg_step),
        shed_frac=out["shed"] / max(out["arrivals"], 1),
    )
    return out


# ------------------------------------------------------------------ #
# host oracle: the serving marginal as a standalone event-driven sim
# ------------------------------------------------------------------ #
def simulate_serving_host(cfg: ServingConfig, horizon: float, seed: int = 0) -> dict:
    """Exact event-driven simulation of the serving plane's marginal law.

    The merged CTMC's serving marginal is independent of the training
    state (independent exponential clocks superpose), so this standalone
    heap simulation follows the same law as the device plane inside the
    engine.  Returns the counters of `drain_counters` plus the served
    sojourn list; the same draws and arithmetic as the reference's, so the
    same seed gives the same numbers.
    """
    cfg.validate()
    rng = np.random.default_rng(seed)
    R = cfg.R
    lam, nu = float(cfg.arrival_rate), float(cfg.serve_rate)
    arrivals = served = shed = timed_out = retried = 0
    sojourns: list[float] = []
    # the request table mirrors ServeState; events live on one heap.  Each
    # queued request re-arms its own Exp(1/deadline) clock; stale heap
    # entries are invalidated by an epoch stamp per slot.
    stt = np.zeros(R, np.int64)
    t_arr = np.zeros(R)
    attempt = np.zeros(R, np.int64)
    seq = np.zeros(R, np.int64)
    epoch = np.zeros(R, np.int64)
    next_seq = 0
    heap: list[tuple[float, int, int, int]] = []  # (t, kind, slot, epoch)
    A_ARR, A_SRV, A_TMO, A_REL = 0, 1, 2, 3
    heapq.heappush(heap, (rng.exponential(1.0 / lam), A_ARR, -1, 0))
    srv_slot = -1
    t = 0.0

    def arm_service():
        nonlocal srv_slot
        q = [i for i in range(R) if stt[i] == _QUEUED]
        if not q:
            srv_slot = -1
            return
        i = min(q, key=lambda i: seq[i])
        if srv_slot != i:
            srv_slot = i
            # memoryless: re-arming on a new head keeps the law
            heapq.heappush(heap, (t + rng.exponential(1.0 / nu), A_SRV, i, epoch[i]))

    tokens = float(cfg.bucket_cap)
    t_tok = 0.0
    while heap:
        te, kind, i, ep = heapq.heappop(heap)
        if te > horizon:
            break
        t = te
        if kind == A_ARR:
            heapq.heappush(heap, (t + rng.exponential(1.0 / lam), A_ARR, -1, 0))
            arrivals += 1
            if cfg.bucket_rate > 0:
                tokens = min(cfg.bucket_cap, tokens + cfg.bucket_rate * (t - t_tok))
                t_tok = t
            depth = int(np.sum(stt != _FREE))
            free = np.flatnonzero(stt == _FREE)
            ok = (len(free) > 0 and depth < cfg.queue_cap
                  and (cfg.bucket_rate <= 0 or tokens >= 1.0))
            if not ok:
                shed += 1
                continue
            if cfg.bucket_rate > 0:
                tokens -= 1.0
            s = int(free[0])
            stt[s], t_arr[s], attempt[s] = _QUEUED, t, 0
            seq[s] = next_seq
            next_seq += 1
            epoch[s] += 1
            if cfg.deadline > 0:
                heapq.heappush(heap, (t + rng.exponential(cfg.deadline), A_TMO, s, epoch[s]))
            arm_service()
        elif kind == A_SRV:
            if i != srv_slot or stt[i] != _QUEUED or ep != epoch[i]:
                continue  # a stale clock (the head changed / the request left)
            served += 1
            sojourns.append(t - t_arr[i])
            stt[i] = _FREE
            epoch[i] += 1
            srv_slot = -1
            arm_service()
        elif kind == A_TMO:
            if stt[i] != _QUEUED or ep != epoch[i]:
                continue
            epoch[i] += 1
            if attempt[i] >= cfg.max_retries:
                stt[i] = _FREE
                timed_out += 1
            else:
                retried += 1
                attempt[i] += 1
                stt[i] = _BACKOFF
                d = min(cfg.backoff_base * 2.0 ** (attempt[i] - 1), cfg.backoff_cap)
                heapq.heappush(heap, (t + rng.exponential(d), A_REL, i, epoch[i]))
            if i == srv_slot:
                srv_slot = -1
            arm_service()
        else:  # A_REL
            if stt[i] != _BACKOFF or ep != epoch[i]:
                continue
            epoch[i] += 1
            stt[i] = _QUEUED
            seq[i] = next_seq
            next_seq += 1
            if cfg.deadline > 0:
                heapq.heappush(heap, (t + rng.exponential(cfg.deadline), A_TMO, i, epoch[i]))
            arm_service()
    pending = int(np.sum(stt != _FREE))
    return {
        "arrivals": arrivals,
        "served": served,
        "shed": shed,
        "timed_out": timed_out + pending,
        "retried": retried,
        "pending_drained": pending,
        "sojourns": sojourns,
    }
