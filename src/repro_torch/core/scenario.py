"""Scenario library: phase-type service laws + Markov-modulated availability.

The paper's closed-Jackson analysis assumes exponential service at
always-on clients.  Real deployments (FLGo's system simulator, the
staleness/frequency analysis of arXiv:2502.08206) add two effects on
top of that:

* **non-exponential responsiveness** — client round times with squared
  coefficient of variation (SCV) below 1 (Erlang-like, deterministic-ish
  compute) or above 1 (hyperexponential, heavy-tailed stragglers);
* **time-varying availability** — clients cycle through on/off (or
  degraded) states independently of the training process.

Both stay *memoryless at every instant* when expressed the right way,
which is what lets the device engine keep its single inverse-CDF race:

* A phase-type service law is a k-stage chain of exponential clocks.
  We restrict to **deterministic-exit chains**: stage ``i`` fires at
  rate ``rates[i]``; on firing it either absorbs (service completes,
  ``absorb[i]``) or moves to a fixed next stage ``nxt[i]``.  This covers
  exponential (1 stage), Erlang-k (k stages in series) and
  hyperexponential (a mixture over single absorbing stages via the
  initial distribution ``alpha``) exactly, and keeps the device decode
  branch-free: the race winner's event is "stage advance" or
  "completion" by a single table lookup.
* Markov-modulated availability is a per-node 2-state chain
  (on -> off at ``off_rate``, off -> on at ``on_rate``).  While "off" a
  node serves at ``rate_scale`` times its nominal rate — ``0.0``
  recovers the fault model's hard on/off suspension, ``0 < rate_scale < 1`` models
  degraded (throttled / contended) service.

Chains are normalized to **unit mean** so that node ``i`` keeps mean
service time ``1/mu_i`` when fully available; the scenario reshapes the
distribution around that mean, never the mean itself.  This is what
keeps ``estimate_mu`` comparable across scenarios.

This module is numpy-only (no jax) so config/registry code stays
importable everywhere; `stream_device.resolve_scenario` lifts a
``ScenarioConfig`` onto the device.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any

import numpy as np

__all__ = [
    "ServiceLaw",
    "ModulationConfig",
    "ScenarioConfig",
    "SCENARIOS",
    "register_scenario",
    "get_scenario",
    "list_scenarios",
]


# ---------------------------------------------------------------------------
# Service laws (phase-type, deterministic-exit chains)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ServiceLaw:
    """A unit-mean phase-type service law as a deterministic-exit chain.

    ``kind`` selects the family:

    * ``"exp"`` — a single absorbing stage (the engine's default law).
    * ``"erlang"`` — ``shape`` stages in series, each at rate ``shape``
      (unit mean, SCV = 1/shape).
    * ``"hyperexp"`` — a mixture of single absorbing stages: branch ``i``
      is taken with probability ``branch_probs[i]`` and absorbs at rate
      ``branch_rates[i]``; rates are rescaled to unit mean in
      :meth:`chain`.
    """

    kind: str = "exp"
    shape: int = 1
    branch_probs: tuple[float, ...] = ()
    branch_rates: tuple[float, ...] = ()

    def __post_init__(self) -> None:
        if self.kind not in ("exp", "erlang", "hyperexp"):
            raise ValueError(f"unknown service law kind {self.kind!r}")
        if self.kind == "erlang" and self.shape < 1:
            raise ValueError("erlang shape must be >= 1")
        if self.kind == "hyperexp":
            p = np.asarray(self.branch_probs, dtype=np.float64)
            r = np.asarray(self.branch_rates, dtype=np.float64)
            if p.ndim != 1 or p.shape != r.shape or p.size == 0:
                raise ValueError("hyperexp needs matching non-empty branch_probs/branch_rates")
            if np.any(p < 0) or not np.isclose(p.sum(), 1.0, atol=1e-9):
                raise ValueError("branch_probs must be a probability vector")
            if np.any(r <= 0):
                raise ValueError("branch_rates must be positive")
        # Normalize tuple fields so equality / hashing is value-based.
        object.__setattr__(self, "branch_probs", tuple(float(x) for x in self.branch_probs))
        object.__setattr__(self, "branch_rates", tuple(float(x) for x in self.branch_rates))

    # -- constructors -------------------------------------------------------

    @classmethod
    def exponential(cls) -> "ServiceLaw":
        return cls(kind="exp")

    @classmethod
    def erlang(cls, k: int) -> "ServiceLaw":
        return cls(kind="erlang", shape=int(k))

    @classmethod
    def hyperexp(cls, probs, rates) -> "ServiceLaw":
        return cls(kind="hyperexp", branch_probs=tuple(probs), branch_rates=tuple(rates))

    @classmethod
    def hyperexp_scv(cls, scv: float) -> "ServiceLaw":
        """Balanced-means 2-phase hyperexponential with the given SCV > 1.

        The standard construction: ``p1 = (1 + sqrt((scv-1)/(scv+1)))/2``,
        branch rates ``2*p_i`` (each branch contributes half the mean).
        """
        if scv <= 1.0:
            raise ValueError("hyperexp_scv needs scv > 1 (use erlang for scv < 1)")
        p1 = 0.5 * (1.0 + np.sqrt((scv - 1.0) / (scv + 1.0)))
        p2 = 1.0 - p1
        return cls.hyperexp((p1, p2), (2.0 * p1, 2.0 * p2))

    # -- chain construction --------------------------------------------------

    def chain(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Return ``(alpha, rates, absorb, nxt)`` arrays, unit-mean normalized.

        ``alpha`` is the initial-stage distribution, ``rates[i] > 0`` the
        stage-``i`` clock rate, ``absorb[i]`` whether firing stage ``i``
        completes service, ``nxt[i]`` the successor stage otherwise.
        """
        if self.kind == "exp":
            alpha = np.array([1.0])
            rates = np.array([1.0])
            absorb = np.array([1], dtype=np.int32)
            nxt = np.array([0], dtype=np.int32)
        elif self.kind == "erlang":
            k = self.shape
            alpha = np.zeros(k)
            alpha[0] = 1.0
            rates = np.full(k, float(k))
            absorb = np.zeros(k, dtype=np.int32)
            absorb[-1] = 1
            nxt = np.arange(1, k + 1, dtype=np.int32) % k
        else:  # hyperexp: each branch is a single absorbing stage
            alpha = np.asarray(self.branch_probs, dtype=np.float64)
            rates = np.asarray(self.branch_rates, dtype=np.float64)
            absorb = np.ones(alpha.size, dtype=np.int32)
            nxt = np.zeros(alpha.size, dtype=np.int32)
            # Rescale to unit mean: E[T] = sum_i alpha_i / rates_i.
            rates = rates * float(np.sum(alpha / rates))
        _validate_chain(alpha, rates, absorb, nxt)
        return alpha, rates, absorb, nxt

    # -- moments -------------------------------------------------------------

    def moments(self) -> tuple[float, float]:
        """Return ``(E[T], E[T^2])`` of the (unit-mean) law via path following."""
        return chain_moments(*self.chain())

    def scv(self) -> float:
        """Squared coefficient of variation ``Var[T]/E[T]^2``."""
        m1, m2 = self.moments()
        return (m2 - m1 * m1) / (m1 * m1)

    def to_dict(self) -> dict[str, Any]:
        return {
            "kind": self.kind,
            "shape": self.shape,
            "branch_probs": list(self.branch_probs),
            "branch_rates": list(self.branch_rates),
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ServiceLaw":
        return cls(
            kind=d["kind"],
            shape=int(d.get("shape", 1)),
            branch_probs=tuple(d.get("branch_probs", ())),
            branch_rates=tuple(d.get("branch_rates", ())),
        )


def _validate_chain(alpha, rates, absorb, nxt) -> None:
    alpha = np.asarray(alpha, dtype=np.float64)
    rates = np.asarray(rates, dtype=np.float64)
    absorb = np.asarray(absorb)
    nxt = np.asarray(nxt)
    S = rates.size
    if not (alpha.shape == rates.shape == absorb.shape == nxt.shape):
        raise ValueError("chain arrays must share one shape (S,)")
    if np.any(alpha < 0) or not np.isclose(alpha.sum(), 1.0, atol=1e-9):
        raise ValueError("alpha must be a probability vector")
    if np.any(rates <= 0) or not np.all(np.isfinite(rates)):
        raise ValueError("stage rates must be positive and finite")
    if np.any((nxt < 0) | (nxt >= S)):
        raise ValueError("nxt indices out of range")
    # Every stage with alpha mass must reach absorption within S hops
    # (deterministic-exit chains cannot cycle before absorbing).
    for s0 in range(S):
        if alpha[s0] <= 0:
            continue
        s = int(s0)
        for _ in range(S):
            if absorb[s]:
                break
            s = int(nxt[s])
        else:
            raise ValueError(f"stage {s0} never absorbs (chain cycles)")


def chain_moments(alpha, rates, absorb, nxt) -> tuple[float, float]:
    """``(E[T], E[T^2])`` of a deterministic-exit phase chain.

    A path from start stage ``s0`` is a fixed sequence of independent
    exponential stages, so conditionally ``E[T] = sum 1/r`` and
    ``Var[T] = sum 1/r^2``; mix over ``alpha``.
    """
    alpha = np.asarray(alpha, dtype=np.float64)
    rates = np.asarray(rates, dtype=np.float64)
    absorb = np.asarray(absorb)
    nxt = np.asarray(nxt)
    S = rates.size
    mean = 0.0
    m2 = 0.0
    for s0 in range(S):
        if alpha[s0] <= 0:
            continue
        m1p = 0.0
        varp = 0.0
        s = int(s0)
        for _ in range(S):
            m1p += 1.0 / rates[s]
            varp += 1.0 / rates[s] ** 2
            if absorb[s]:
                break
            s = int(nxt[s])
        else:
            raise ValueError(f"stage {s0} never absorbs")
        mean += alpha[s0] * m1p
        m2 += alpha[s0] * (varp + m1p * m1p)
    return float(mean), float(m2)


# ---------------------------------------------------------------------------
# Markov-modulated availability
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModulationConfig:
    """Per-node 2-state availability chain with a degraded-service scale.

    ``off_rate`` (on -> off) and ``on_rate`` (off -> on) are scalars or
    per-node tuples; ``rate_scale`` multiplies the service rate while a
    node is off (``0.0`` = hard suspension, the `FaultConfig` on/off
    semantics; ``0 < rate_scale < 1`` = throttled).
    """

    off_rate: float | tuple[float, ...] = 0.0
    on_rate: float | tuple[float, ...] = 0.0
    rate_scale: float = 0.0

    def __post_init__(self) -> None:
        for name in ("off_rate", "on_rate"):
            v = getattr(self, name)
            if isinstance(v, (list, np.ndarray)):
                object.__setattr__(self, name, tuple(float(x) for x in np.asarray(v).ravel()))
            elif not isinstance(v, tuple):
                object.__setattr__(self, name, float(v))
        if not (0.0 <= float(self.rate_scale) <= 1.0):
            raise ValueError("rate_scale must be in [0, 1]")
        object.__setattr__(self, "rate_scale", float(self.rate_scale))

    def resolve(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        """Broadcast ``(off_rate, on_rate)`` to validated float64 ``(n,)``."""
        out = []
        for name in ("off_rate", "on_rate"):
            r = np.broadcast_to(np.asarray(getattr(self, name), dtype=np.float64), (n,)).copy()
            if np.any(~np.isfinite(r)) or np.any(r < 0):
                raise ValueError(f"{name} must be finite and >= 0")
            out.append(r)
        return out[0], out[1]

    @property
    def enabled(self) -> bool:
        off = np.asarray(self.off_rate, dtype=np.float64)
        return bool(np.any(off > 0))

    def stationary_on(self, n: int = 1) -> np.ndarray:
        """Stationary probability of the on state, ``q_on / (q_on + q_off)``."""
        q_off, q_on = self.resolve(n)
        tot = q_on + q_off
        return np.where(tot > 0, q_on / np.maximum(tot, 1e-300), 1.0)

    def to_dict(self) -> dict[str, Any]:
        def _val(v):
            return list(v) if isinstance(v, tuple) else v

        return {
            "off_rate": _val(self.off_rate),
            "on_rate": _val(self.on_rate),
            "rate_scale": self.rate_scale,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ModulationConfig":
        def _val(v):
            return tuple(v) if isinstance(v, list) else v

        return cls(
            off_rate=_val(d.get("off_rate", 0.0)),
            on_rate=_val(d.get("on_rate", 0.0)),
            rate_scale=float(d.get("rate_scale", 0.0)),
        )


# ---------------------------------------------------------------------------
# ScenarioConfig + registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ScenarioConfig:
    """A named (service law, availability modulation) pair.

    ``enabled`` is False for the exponential + always-on scenario: every
    entry point routes that case through the unmodified engine path, so
    the default scenario is bitwise-identical to not passing one at all.
    """

    name: str = "exponential"
    service: ServiceLaw = field(default_factory=ServiceLaw)
    modulation: ModulationConfig | None = None

    @property
    def enabled(self) -> bool:
        mod_on = self.modulation is not None and self.modulation.enabled
        return self.service.kind != "exp" or mod_on

    def cache_key(self) -> tuple:
        """Hashable identity for jit-cache memoization."""
        sl = self.service
        mod = self.modulation
        mod_key = None if mod is None else (mod.off_rate, mod.on_rate, mod.rate_scale)
        return (self.name, sl.kind, sl.shape, sl.branch_probs, sl.branch_rates, mod_key)

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "service": self.service.to_dict(),
            "modulation": None if self.modulation is None else self.modulation.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ScenarioConfig":
        mod = d.get("modulation")
        return cls(
            name=d["name"],
            service=ServiceLaw.from_dict(d["service"]),
            modulation=None if mod is None else ModulationConfig.from_dict(mod),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ScenarioConfig":
        return cls.from_dict(json.loads(s))


SCENARIOS: dict[str, ScenarioConfig] = {}


def register_scenario(cfg: ScenarioConfig, overwrite: bool = False) -> ScenarioConfig:
    if cfg.name in SCENARIOS and not overwrite:
        raise ValueError(f"scenario {cfg.name!r} already registered")
    SCENARIOS[cfg.name] = cfg
    return cfg


def get_scenario(s: "str | ScenarioConfig | None") -> ScenarioConfig | None:
    """Resolve a registry name / config / None to a ScenarioConfig (or None)."""
    if s is None:
        return None
    if isinstance(s, ScenarioConfig):
        return s
    if isinstance(s, str):
        if s not in SCENARIOS:
            raise KeyError(f"unknown scenario {s!r}; known: {sorted(SCENARIOS)}")
        return SCENARIOS[s]
    raise TypeError(f"scenario must be a name, ScenarioConfig, or None, got {type(s)}")


def list_scenarios() -> list[str]:
    return sorted(SCENARIOS)


# Built-in registry.  Modulation rates are in units of the nominal service
# rate (mu ~ 1): the on/off entries hold ~75% stationary availability with
# O(1) sojourns, so the chain mixes well inside typical T ~ 1e4 runs.
register_scenario(ScenarioConfig(name="exponential"))
register_scenario(ScenarioConfig(name="erlang2", service=ServiceLaw.erlang(2)))
register_scenario(ScenarioConfig(name="erlang4", service=ServiceLaw.erlang(4)))
register_scenario(ScenarioConfig(name="hyperexp2", service=ServiceLaw.hyperexp_scv(4.0)))
register_scenario(
    ScenarioConfig(
        name="onoff",
        modulation=ModulationConfig(off_rate=0.5, on_rate=1.5, rate_scale=0.0),
    )
)
register_scenario(
    ScenarioConfig(
        name="onoff_slow",
        modulation=ModulationConfig(off_rate=0.5, on_rate=1.5, rate_scale=0.25),
    )
)
register_scenario(
    ScenarioConfig(
        name="erlang2_onoff",
        service=ServiceLaw.erlang(2),
        modulation=ModulationConfig(off_rate=0.5, on_rate=1.5, rate_scale=0.0),
    )
)
