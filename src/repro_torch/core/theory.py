"""Non-convex convergence bounds (paper §3, Table 1).

Implements the Theorem 1 bound for Generalized AsyncSGD and the comparison
bounds of FedBuff (Nguyen et al. 2022) and uniform AsyncSGD (Koloskova et
al. 2022), plus the step-size rules eta_max(p).

All bounds are evaluated from *expected* delays m_i (from
`repro.core.jackson.JacksonNetwork.expected_delays` or from simulation),
never from tau_max — that is the paper's point.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "BoundConstants",
    "eta_max",
    "eta_max_components",
    "generalized_bound",
    "optimal_eta",
    "fedbuff_bound",
    "asyncsgd_bound",
]


@dataclass
class BoundConstants:
    """Problem constants of Theorem 1.

    A = E[f(mu_0) - f(mu_{T+1})] (initialization gap),
    L = smoothness, B = 2 G^2 + sigma^2 (heterogeneity + gradient noise),
    C = concurrency, T = number of CS steps.
    """

    A: float = 100.0
    L: float = 1.0
    B: float = 20.0
    C: int = 10
    T: int = 10_000
    rho: float = 0.0  # strong-growth constant (App. C.2); 0 = plain A3


def eta_max_components(
    p: np.ndarray, m: np.ndarray, k: BoundConstants
) -> tuple[float, float]:
    """The two branches (a, b) of the Theorem 1 cap, eta_max = min(a, b).

    a = (16 L^2 C m_k growth)^{-1/2} with m_k = sum_i m_i/(n^2 p_i^2),
    b = n^2 / (8 L growth sum_i 1/p_i).

    Exposed separately so the analytic gradient (sampling.bound_value_and_grad)
    can differentiate the *active* branch from the same formulas the objective
    uses — keep both call sites in sync through this single definition.
    """
    p = np.asarray(p, dtype=np.float64)
    m = np.asarray(m, dtype=np.float64)
    n = p.size
    m_k = float(np.sum(m / (n**2 * p**2)))
    growth = 1.0 + k.rho**2
    a = 1.0 / np.sqrt(16.0 * k.L**2 * k.C * m_k * growth)
    b = n**2 / (8.0 * k.L * growth * np.sum(1.0 / p))
    return float(a), float(b)


def eta_max(p: np.ndarray, m: np.ndarray, k: BoundConstants) -> float:
    """Theorem 1 step-size cap.

    eta_max = 1/(4L) * min( C^{-1/2} (max_k m_k^T)^{-1/2},
                            2 / sum_i 1/(n^2 p_i) )
    with m_k^T ~ stationary  m_k = sum_i m_i / (n^2 p_i^2).
    """
    return min(eta_max_components(p, m, k))


def generalized_bound(
    eta: float, p: np.ndarray, m: np.ndarray, k: BoundConstants
) -> float:
    """G(p, eta) of Eq. (3) — the Theorem 1 RHS in stationary regime.

        A/(eta (T+1)) + eta L B sum_i 1/(n^2 p_i)
                      + eta^2 L^2 B C sum_i m_i/(n^2 p_i^2)

    (stationarity: sum_k m_{i,k}^T/(T+1) -> m_i, Prop. 3.)
    """
    p = np.asarray(p, dtype=np.float64)
    m = np.asarray(m, dtype=np.float64)
    n = p.size
    t1 = k.A / (eta * (k.T + 1))
    t2 = eta * k.L * k.B * np.sum(1.0 / (n**2 * p))
    t3 = eta**2 * k.L**2 * k.B * k.C * np.sum(m / (n**2 * p**2))
    return float(t1 + t2 + t3)


def optimal_eta(p: np.ndarray, m: np.ndarray, k: BoundConstants) -> float:
    """argmin_eta G(p, eta) s.t. eta <= eta_max — exact via the cubic root.

    dG/deta = -A/(eta^2 (T+1)) + b + 2 c eta = 0
    with b = L B sum 1/(n^2 p_i), c = L^2 B C sum m_i/(n^2 p_i^2)
    <=>  2 c eta^3 + b eta^2 - A/(T+1) = 0.
    """
    p = np.asarray(p, dtype=np.float64)
    m = np.asarray(m, dtype=np.float64)
    n = p.size
    b = k.L * k.B * np.sum(1.0 / (n**2 * p))
    c = k.L**2 * k.B * k.C * np.sum(m / (n**2 * p**2))
    cap = eta_max(p, m, k)
    roots = np.roots([2.0 * c, b, 0.0, -k.A / (k.T + 1)])
    real = [float(r.real) for r in roots if abs(r.imag) < 1e-12 and r.real > 0]
    eta = min(min(real) if real else cap, cap)
    return float(eta)


# -------------------------------------------------------------------- #
# Baseline bounds (Table 1)
# -------------------------------------------------------------------- #
def fedbuff_bound(eta: float, tau_max: float, n: int, k: BoundConstants) -> float:
    """FedBuff: A/(eta(T+1)) + eta L B + eta^2 tau_max^2 L^2 B n.

    Note: with exponential service times tau_max is unbounded over T -> inf
    and the bound is vacuous — we surface that by returning inf when the
    caller passes tau_max = inf (the honest value).
    """
    if not np.isfinite(tau_max):
        return float("inf")
    return float(
        k.A / (eta * (k.T + 1))
        + eta * k.L * k.B
        + eta**2 * tau_max**2 * k.L**2 * k.B * n
    )


def fedbuff_eta_max(tau_max: float, k: BoundConstants) -> float:
    if not np.isfinite(tau_max):
        return 0.0
    return float(1.0 / (k.L * np.sqrt(tau_max**3)))


def asyncsgd_bound(
    eta: float, tau_c: float, tau_sum: np.ndarray, k: BoundConstants
) -> float:
    """Koloskova et al. AsyncSGD: A/(eta(T+1)) + eta L B + eta^2 tau_c L^2 B sum_i tau_sum_i/(T+1)."""
    if not np.all(np.isfinite(tau_sum)) or not np.isfinite(tau_c):
        return float("inf")
    return float(
        k.A / (eta * (k.T + 1))
        + eta * k.L * k.B
        + eta**2 * tau_c * k.L**2 * k.B * np.sum(tau_sum) / (k.T + 1)
    )


def asyncsgd_eta_max(tau_c: float, tau_max: float, k: BoundConstants) -> float:
    if not (np.isfinite(tau_c) and np.isfinite(tau_max)):
        return 0.0
    return float(1.0 / (k.L * np.sqrt(tau_c * tau_max)))
