"""Closed Jackson network analysis for Generalized AsyncSGD (paper §4).

The asynchronous FL computational graph is a closed Jackson network on the
complete graph with ``n`` single-server FIFO nodes (clients) and ``C``
circulating tasks (Prop. 2 of the paper).  Node ``i`` serves at rate ``mu_i``
(exponential) and the dispatcher routes a completed task to node ``i`` with
probability ``p_i``.  The stationary distribution is product-form

    pi_C(x) = H_C^{-1} * prod_i theta_i^{x_i},     theta_i = p_i / mu_i.

Everything here is exact, host-side math (numpy): the control plane of the
training system.  All quantities are computed with Buzen's convolution
algorithm, in a numerically-stable normalized form (thetas are rescaled by
max(theta) which leaves pi_C invariant, paper §4 'Scaling regime').

Performance notes
-----------------
``buzen_normalizing_constants`` accepts a batch of theta vectors (B, n) and
convolves all of them at once; the 1-D path runs each node's geometric-series
convolution as an O(C) C-level linear filter instead of a Python loop.
``buzen_remove_node`` / ``buzen_add_node`` give O(C) single-node
unconvolution / reconvolution, so perturbing one coordinate of ``p`` does not
cost a full O(n*C) pass.  ``mean_queue_lengths`` is one (n, N) matrix
operation (memoized per N), and ``expected_delays_vjp`` provides the exact
vector-Jacobian product of the delay vector w.r.t. theta via the product-form
identity  d log H_C / d theta_i = E_C[X_i] / theta_i,  which is what makes
analytic simplex gradients in `repro.core.sampling` O(n*C) per step.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "JacksonNetwork",
    "MixedServingResult",
    "mixed_serving_analysis",
    "serving_slo",
    "buzen_normalizing_constants",
    "buzen_add_node",
    "buzen_remove_node",
    "buzen_replace_node",
    "buzen_log_normalizing_constants",
    "buzen_log_add_node",
    "buzen_log_remove_node",
    "batched_expected_delays",
    "two_cluster_delay_bounds",
    "three_cluster_delay_bounds",
    "gamma_ratio",
]

_lfilter = None


def _get_lfilter():
    global _lfilter
    if _lfilter is None:
        from scipy.signal import lfilter

        _lfilter = lfilter
    return _lfilter


def _buzen_reference(theta: np.ndarray, C: int) -> np.ndarray:
    """Seed implementation (pure-Python double loop) — kept as the oracle for
    tests and before/after benchmarks."""
    theta = np.asarray(theta, dtype=np.float64)
    G = np.zeros(C + 1, dtype=np.float64)
    G[0] = 1.0
    for th in theta:
        for c in range(1, C + 1):
            G[c] = G[c] + th * G[c - 1]
    return G


def buzen_normalizing_constants(theta: np.ndarray, C: int) -> np.ndarray:
    """Buzen's convolution algorithm, scalar or batched.

    For ``theta`` of shape (n,), returns ``G`` with
    ``G[c] = H_c = sum_{x : sum x_i = c} prod theta_i^{x_i}`` for ``c = 0..C``
    (complexity O(n*C), executed as n O(C) linear filters at C speed).

    For ``theta`` of shape (B, n) — a batch of B independent theta vectors —
    returns (B, C+1), convolving the whole batch in vectorized sweeps.  This
    is what lets `optimize_two_cluster` evaluate its entire coarse grid in
    one call.

    For numerical stability the caller should pass *rescaled* thetas
    (``theta / theta.max()``); all ratios H_{c-1}/H_c etc. are invariant.
    """
    theta = np.asarray(theta, dtype=np.float64)
    if theta.ndim not in (1, 2) or theta.size == 0:
        raise ValueError("theta must be a non-empty 1-D or 2-D array")
    if np.any(theta <= 0):
        raise ValueError("theta must be strictly positive")
    if C < 0:
        raise ValueError("C must be >= 0")
    if theta.ndim == 1:
        lfilter = _get_lfilter()
        G = np.zeros(C + 1, dtype=np.float64)
        G[0] = 1.0
        b = np.ones(1)
        for th in theta:
            # G_new[c] = G_old[c] + th * G_new[c-1]: an IIR filter along c.
            G = lfilter(b, np.array([1.0, -th]), G)
        return G
    B, n = theta.shape
    G = np.zeros((B, C + 1), dtype=np.float64)
    G[:, 0] = 1.0
    for i in range(n):
        th = theta[:, i]
        for c in range(1, C + 1):
            G[:, c] += th * G[:, c - 1]
    return G


def buzen_remove_node(G: np.ndarray, th: float | np.ndarray) -> np.ndarray:
    """O(C) unconvolution: normalizing constants of the network with one node
    (traffic intensity ``th``) removed.

    Inverts the Buzen recurrence ``G[c] = G_minus[c] + th * G[c-1]``; note the
    right-hand side uses the *full* G, so this is a fully vectorized first
    difference, not a sequential recurrence.  Works on (C+1,) or batched
    (B, C+1) arrays (``th`` scalar or (B,)).

    Numerical caveat: the subtraction cancels catastrophically when the
    removed node *dominates* the network (H_c ≈ th * H_{c-1}, i.e. ``th``
    near the rescaling maximum with everyone else far below).  That regime is
    detectable — the true constants are strictly positive, cancellation
    drives entries to ~0 or below — so we raise instead of returning garbage;
    fall back to a full `buzen_normalizing_constants` pass in that case.
    """
    G = np.asarray(G, dtype=np.float64)
    th_arr = np.asarray(th, dtype=np.float64)
    if G.ndim == 2:
        th_arr = th_arr.reshape(-1, 1)
    out = np.empty_like(G)
    out[..., 0] = G[..., 0]
    out[..., 1:] = G[..., 1:] - th_arr * G[..., :-1]
    if np.any(out <= 0):
        raise FloatingPointError(
            "buzen_remove_node lost all precision (removed node dominates the "
            "network); recompute with buzen_normalizing_constants instead"
        )
    return out


def buzen_add_node(G: np.ndarray, th: float | np.ndarray) -> np.ndarray:
    """O(C) reconvolution: add a node with traffic intensity ``th``.

    ``buzen_add_node(buzen_remove_node(G, t), t) == G`` up to roundoff.
    """
    G = np.asarray(G, dtype=np.float64)
    if G.ndim == 1:
        lfilter = _get_lfilter()
        return lfilter(np.ones(1), np.array([1.0, -float(th)]), G)
    th_arr = np.asarray(th, dtype=np.float64)
    out = G.copy()
    C = G.shape[-1] - 1
    for c in range(1, C + 1):
        out[..., c] += th_arr * out[..., c - 1]
    return out


def buzen_replace_node(
    G: np.ndarray, th_old: float | np.ndarray, th_new: float | np.ndarray
) -> np.ndarray:
    """O(C) update of G after perturbing a single node's theta — the
    incremental alternative to a full O(n*C) reconvolution."""
    return buzen_add_node(buzen_remove_node(G, th_old), th_new)


# ---------------------------------------------------------------------- #
# log-space Buzen: large n / C / skewed theta without float64 over- or
# underflow.  Even after the theta/theta.max rescaling, G(c) ~ binom(n, c)
# exceeds float64 range once n*C is large (n = 10^4, C = 10^3 already
# overflows), and strongly skewed thetas underflow the tail entries — the
# linear-space path then returns inf/0 and every downstream ratio is
# garbage.  These variants carry log G(c) throughout.
# ---------------------------------------------------------------------- #
def _log_nb_series(lth: float, count: float, C: int) -> np.ndarray:
    """log coefficients of (1 - e^lth x)^(-count), orders 0..C.

    The generating function of a speed class with ``count`` identical
    nodes: its order-k coefficient is the negative-binomial weight
    binom(count+k-1, k) th^k, built stably via the log-ratio recurrence
    ``lnb_k = lnb_{k-1} + lth + log((count+k-1)/k)``.
    """
    if C == 0:
        return np.zeros(1)
    k = np.arange(1.0, C + 1.0)
    return np.concatenate([[0.0], np.cumsum(lth + np.log((count + k - 1.0) / k))])


def _log_conv(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Truncated log-space polynomial product: out[c] = logsumexp_j a[j]+b[c-j]."""
    from scipy.special import logsumexp

    L = a.shape[0]
    M = np.full((L, L), -np.inf)
    for c in range(L):
        M[c, : c + 1] = a[: c + 1] + b[c::-1]
    return logsumexp(M, axis=1)


def buzen_log_normalizing_constants(
    theta: np.ndarray, C: int, counts: np.ndarray | None = None
) -> np.ndarray:
    """log G(c), c = 0..C, overflow/underflow-free.

    Without ``counts``: one exact log-space convolution per node.  Adding
    a node is ``G'[c] = sum_j G[j] th^(c-j)``, i.e. with the tilted vector
    ``h[j] = log G[j] - j log th`` simply ``log G'[c] = c log th +
    logcumsumexp(h)[c]`` — a vectorized `np.logaddexp.accumulate`, O(C)
    per node with no renormalization step and no within-vector underflow
    (a plain running-renormalization sweep keeps the *scale* in range but
    still zeroes entries >~300 decades below the vector max, destroying
    the low-c constants that tail probabilities need).

    With ``counts`` (m,): ``theta`` holds one entry per *speed class* and
    ``counts`` its multiplicities — the class-collapsed control plane.
    Each class contributes a negative-binomial series (`_log_nb_series`)
    and the m series are convolved fully in log space: O(m*C^2)
    independent of n, which is what makes n = 10^6 exact analysis cheap.

    Same rescaling contract as `buzen_normalizing_constants`: pass
    ``theta / theta.max()``; all ratios of G entries are invariant.
    """
    theta = np.asarray(theta, dtype=np.float64)
    if theta.ndim != 1 or theta.size == 0:
        raise ValueError("theta must be a non-empty 1-D array")
    if np.any(theta <= 0):
        raise ValueError("theta must be strictly positive")
    if C < 0:
        raise ValueError("C must be >= 0")
    if counts is not None:
        counts = np.asarray(counts, dtype=np.float64)
        if counts.shape != theta.shape or np.any(counts < 1):
            raise ValueError("counts must match theta with entries >= 1")
        lg = _log_nb_series(float(np.log(theta[0])), float(counts[0]), C)
        for lth, cnt in zip(np.log(theta[1:]), counts[1:]):
            lg = _log_conv(lg, _log_nb_series(float(lth), float(cnt), C))
        return lg
    tilt = np.arange(C + 1, dtype=np.float64)
    lg = np.full(C + 1, -np.inf)
    lg[0] = 0.0
    for lth in np.log(theta):
        ct = tilt * lth
        lg = ct + np.logaddexp.accumulate(lg - ct)
    return lg


def buzen_log_add_node(lG: np.ndarray, lth: float) -> np.ndarray:
    """O(C) log-space reconvolution: add one node with log-theta ``lth``.

    ``lG'[c] = logaddexp(lG[c], lth + lG'[c-1])`` — the IIR recurrence of
    `buzen_add_node` carried in logs.
    """
    lG = np.asarray(lG, dtype=np.float64)
    out = np.empty_like(lG)
    out[0] = lG[0]
    for c in range(1, lG.shape[0]):
        out[c] = np.logaddexp(lG[c], lth + out[c - 1])
    return out


def buzen_log_remove_node(lG: np.ndarray, lth: float) -> np.ndarray:
    """O(C) log-space unconvolution, inverse of `buzen_log_add_node`.

    Inverts ``lG[c] = logaddexp(lG'[c], lth + lG[c-1])`` — like the
    linear-space first difference, the subtracted term uses the *full*
    network's constants, so this is vectorized:
    ``lG'[c] = lG[c] + log1p(-exp(lth + lG[c-1] - lG[c]))``.  Like
    `buzen_remove_node` it cancels catastrophically when the removed node
    dominates; that regime surfaces as the log1p argument reaching -1 and
    raises instead of returning NaN/-inf.
    """
    lG = np.asarray(lG, dtype=np.float64)
    d = lth + lG[:-1] - lG[1:]
    if np.any(d >= 0.0):
        raise FloatingPointError(
            "buzen_log_remove_node lost all precision (removed node "
            "dominates); recompute with buzen_log_normalizing_constants"
        )
    out = np.empty_like(lG)
    out[0] = lG[0]
    out[1:] = lG[1:] + np.log1p(-np.exp(d))
    if not np.all(np.isfinite(out)):
        raise FloatingPointError(
            "buzen_log_remove_node lost all precision (removed node "
            "dominates); recompute with buzen_log_normalizing_constants"
        )
    return out


def gamma_ratio(F: int, c: float) -> float:
    """The paper's Gamma(c) = P(sum_{j<=F+2} E_j <= c) / P(sum_{j<=F+1} E_j <= c).

    Erlang CDF ratio (App. D.3).  ``P(k, x) = 1 - sum_{i<k} e^-x x^i/i!``.
    """
    from scipy.stats import gamma as _gamma

    num = _gamma.cdf(c, a=F + 2)
    den = _gamma.cdf(c, a=F + 1)
    if den == 0.0:
        return 1.0
    return float(num / den)


def _tail_matrix(theta: np.ndarray, G: np.ndarray, N: int) -> np.ndarray:
    """P[i, c-1] = P(X_i >= c) = theta_i^c H_{N-c} / H_N, c = 1..N  (n, N).

    Scale-invariant: pass the rescaled thetas with their matching G.
    """
    n = theta.shape[0]
    if N == 0:
        return np.zeros((n, 0))
    pows = np.cumprod(np.tile(theta[:, None], (1, N)), axis=1)
    return pows * (G[N - 1 :: -1][:N] / G[N])


def batched_expected_delays(
    mu: np.ndarray, P: np.ndarray, C: int, normalized: bool = True
) -> tuple[np.ndarray, np.ndarray]:
    """Delay vectors m and throughputs for a batch of sampling vectors.

    ``mu`` (n,) shared service rates; ``P`` (B, n) rows on the simplex.
    Returns ``(m, lam)`` with shapes (B, n) and (B,).  One batched Buzen pass
    plus one einsum — the whole coarse grid of `optimize_two_cluster` in a
    single call.  Memory O(B*n*C).
    """
    mu = np.asarray(mu, dtype=np.float64)
    P = np.asarray(P, dtype=np.float64)
    theta = P / mu
    s = theta.max(axis=1, keepdims=True)
    th = theta / s
    G = buzen_normalizing_constants(th, C)  # (B, C+1)
    N = C - 1
    B, n = th.shape
    if N == 0:
        q = np.zeros((B, n))
    else:
        pows = np.cumprod(np.repeat(th[:, :, None], N, axis=2), axis=2)
        ratios = G[:, N - 1 :: -1][:, :N] / G[:, N][:, None]  # (B, N)
        q = np.einsum("inc,ic->in", pows, ratios)
    lam = G[:, C - 1] / G[:, C] / s[:, 0]
    m = lam[:, None] * (q + 1.0) / mu
    if normalized:
        m = m * (C - 1.0) / C
    return m, lam


@dataclass
class JacksonNetwork:
    """Exact stationary analysis of the paper's closed network.

    Parameters
    ----------
    mu : (n,) service rates (tasks/unit-time) per client.
    p  : (n,) dispatcher sampling probabilities (sum to 1).
    C  : number of circulating tasks (concurrency).
    """

    mu: np.ndarray
    p: np.ndarray
    C: int
    _G: np.ndarray = field(init=False, repr=False)
    _theta: np.ndarray = field(init=False, repr=False)
    _ql_cache: dict = field(init=False, repr=False, default_factory=dict)
    _E: np.ndarray | None = field(init=False, repr=False, default=None)

    def __post_init__(self) -> None:
        self.mu = np.asarray(self.mu, dtype=np.float64)
        self.p = np.asarray(self.p, dtype=np.float64)
        if self.mu.shape != self.p.shape:
            raise ValueError("mu and p must have the same shape")
        if abs(float(self.p.sum()) - 1.0) > 1e-8:
            raise ValueError(f"p must sum to 1, got {self.p.sum()}")
        if self.C < 1:
            raise ValueError("C must be >= 1")
        theta = self.p / self.mu
        self._theta = theta / theta.max()  # rescale: pi_C invariant
        self._G = buzen_normalizing_constants(self._theta, self.C)

    # ------------------------------------------------------------------ #
    # product-form basics
    # ------------------------------------------------------------------ #
    @property
    def n(self) -> int:
        return int(self.mu.size)

    @property
    def theta(self) -> np.ndarray:
        """Rescaled traffic intensities theta_i/max_j theta_j."""
        return self._theta

    def normalizing_constant(self, c: int | None = None) -> float:
        """H_c for the *rescaled* thetas (c defaults to C)."""
        c = self.C if c is None else c
        return float(self._G[c])

    def stationary_prob(self, x: np.ndarray) -> float:
        """pi_C(x) for a full state vector x (sum x_i must equal C)."""
        x = np.asarray(x)
        if x.sum() != self.C:
            return 0.0
        return float(np.prod(self._theta**x) / self._G[self.C])

    def queue_tail_prob(self, i: int, c: int, ntasks: int | None = None) -> float:
        """P(X_i >= c) = theta_i^c * H_{C-c} / H_C (standard closed-network identity)."""
        N = self.C if ntasks is None else ntasks
        if c <= 0:
            return 1.0
        if c > N:
            return 0.0
        return float(self._theta[i] ** c * self._G[N - c] / self._G[N])

    def mean_queue_lengths(self, ntasks: int | None = None) -> np.ndarray:
        """E[X_i] = sum_{c=1..N} P(X_i >= c), for a network with N tasks.

        ``ntasks=C-1`` gives the arrival-theorem view (Theorem 11 / MUSTA).
        One (n, N) matrix-vector product, memoized per N.
        """
        N = self.C if ntasks is None else ntasks
        cached = self._ql_cache.get(N)
        if cached is not None:
            return cached.copy()
        if N == 0:
            out = np.zeros(self.n)
        else:
            pows = np.cumprod(np.tile(self._theta[:, None], (1, N)), axis=1)
            out = pows @ (self._G[N - 1 :: -1][:N] / self._G[N])
        self._ql_cache[N] = out
        return out.copy()

    def occupancy_matrix(self) -> np.ndarray:
        """E[i, M] = E_M[X_i] for all populations M = 0..C, shape (n, C+1).

        Built in O(n*C) by the MVA-style recurrence
        ``E_M[X_i] = theta_i (H_{M-1}/H_M) (1 + E_{M-1}[X_i])`` and cached;
        the gradient machinery reads every column.
        """
        if self._E is None:
            E = np.zeros((self.n, self.C + 1))
            ratio = self._G[:-1] / self._G[1:]  # H_{M-1}/H_M, M = 1..C
            for M in range(1, self.C + 1):
                E[:, M] = self._theta * ratio[M - 1] * (1.0 + E[:, M - 1])
            E.setflags(write=False)  # shared cache: callers get a frozen view
            self._E = E
        return self._E

    def utilization(self, ntasks: int | None = None) -> np.ndarray:
        """rho_i = P(X_i > 0) = theta_i * H_{N-1}/H_N."""
        N = self.C if ntasks is None else ntasks
        return self._theta * self._G[N - 1] / self._G[N]

    def throughput(self, ntasks: int | None = None) -> float:
        """Total CS step rate Lambda(N) in *unrescaled* units.

        Lambda(N) = sum_i mu_i P(X_i>0) = sum_i mu_i theta_i H_{N-1}/H_N.
        With unrescaled theta_i = p_i/mu_i this is H_{N-1}/H_N; rescaling by
        theta_max divides theta by theta_max hence multiplies H_{N-1}/H_N
        ratio by theta_max... careful: H_c(theta/s) = H_c(theta)/s^c, so
        H_{N-1}/H_N in rescaled units equals s * (H_{N-1}/H_N) unrescaled.
        We correct for that here to return physical tasks/unit-time.
        """
        N = self.C if ntasks is None else ntasks
        s = float((self.p / self.mu).max())
        return float(self._G[N - 1] / self._G[N] / s)

    def node_throughputs(self, ntasks: int | None = None) -> np.ndarray:
        """lambda_i = p_i * Lambda(N) (flow balance on the complete graph)."""
        return self.p * self.throughput(ntasks)

    # ------------------------------------------------------------------ #
    # the paper's key quantity: m_i, expected delay in CS steps (Prop. 3)
    # ------------------------------------------------------------------ #
    def expected_sojourn_time(self, i: int) -> float:
        """Palm expectation E^{C-1}[S_i] = (E^{C-1}[X_i] + 1)/mu_i (FIFO, App. D.4)."""
        ql = self.mean_queue_lengths(ntasks=self.C - 1)
        return float((ql[i] + 1.0) / self.mu[i])

    def expected_delay_steps(self, i: int) -> float:
        """Arrival-theorem estimate of m_i (CS steps between dispatch & completion).

        Prop. 3: m_i = E^{C-1}[ int_0^{S_i} sum_j mu_j 1(X_j(s)>0) ds ].
        The integrand is the instantaneous CS step rate; replacing it by its
        stationary mean Lambda(C) gives   m̂_i = Lambda(C) * E^{C-1}[S_i].
        Matches event-driven simulation within a few % (see tests/benchmarks).
        """
        return self.throughput() * self.expected_sojourn_time(i)

    def delay_upper_bound_steps(self, i: int) -> float:
        """Prop. 5 style bound: m_i <= lambda_tot * E^{C-1}[S_i], lambda_tot=sum mu_j."""
        return float(self.mu.sum()) * self.expected_sojourn_time(i)

    def expected_delays(self, normalized: bool = True) -> np.ndarray:
        """Vector of m̂_i = Lambda(C) * E^{C-1}[S_i] for all nodes.

        With ``normalized=True`` (default) the vector is rescaled by
        (C-1)/C so that the exact Little's-law identity
        ``sum_i p_i m_i = C - 1`` holds (each completed task saw exactly
        C-1 *other* completions on average while in flight).  The raw
        estimate satisfies sum_i p_i * Lambda * E[S_i] = C by Little's law
        in physical time; the normalization removes the known +1 bias and
        is exact in the saturated regime (all nodes busy).
        """
        ql = self.mean_queue_lengths(ntasks=self.C - 1)
        m = self.throughput() * (ql + 1.0) / self.mu
        if normalized:
            m = m * (self.C - 1.0) / self.C
        return m

    def expected_delays_vjp(self, v: np.ndarray, normalized: bool = True) -> np.ndarray:
        """Exact w_j = sum_i v_i * dm_i/dtheta_j, theta_j = p_j/mu_j unrescaled.

        The full Jacobian dm/dtheta is n x n; the bound optimizer only ever
        needs its action on a cotangent v, which this computes in O(n*C) from
        the product-form identity  dH_N/dtheta_j = E_N[X_j] H_N / theta_j:

            dLambda/dtheta_j = Lambda (E_{C-1}[X_j] - E_C[X_j]) / theta_j
            dq_i/dtheta_j    = (1/theta_j) [ sum_c P_c(i)(E_{N-c}[X_j]
                               - E_N[X_j]) + delta_ij sum_c c P_c(i) ]

        with N = C-1, q_i = E^{C-1}[X_i], P_c(i) the tail probabilities, and
        m_i = kappa * Lambda (q_i + 1)/mu_i.  All sums reduce to tail/
        occupancy matrices that are invariant under the theta rescaling.
        """
        v = np.asarray(v, dtype=np.float64)
        C = self.C
        N = C - 1
        theta_unres = self.p / self.mu
        E = self.occupancy_matrix()
        q = E[:, N]
        lam = self.throughput()
        u = v / self.mu
        kappa = (C - 1.0) / C if normalized else 1.0
        if N > 0:
            Pm = _tail_matrix(self._theta, self._G, N)  # (n, N)
            a = Pm.T @ u  # a_c = sum_i u_i P_c(i), c = 1..N
            # term1_j = sum_c a_c E_{N-c}[X_j]: columns N-1..0 of E
            term1 = E[:, N - 1 :: -1][:, :N] @ a
            S = Pm @ np.arange(1, N + 1, dtype=np.float64)
            vjp_q = (term1 - E[:, N] * float(u @ q) + u * S) / theta_unres
        else:
            vjp_q = np.zeros_like(u)
        dlam = lam * (E[:, C - 1] - E[:, C]) / theta_unres
        return kappa * (dlam * float(u @ (q + 1.0)) + lam * vjp_q)

    def delay_upper_bounds(self) -> np.ndarray:
        ql = self.mean_queue_lengths(ntasks=self.C - 1)
        return float(self.mu.sum()) * (ql + 1.0) / self.mu

    # ------------------------------------------------------------------ #
    # brute-force oracle (small n, C) — used by tests
    # ------------------------------------------------------------------ #
    def brute_force_distribution(self) -> dict[tuple[int, ...], float]:
        """Enumerate all states (only for tiny n, C): exact pi_C."""
        if math.comb(self.C + self.n - 1, self.n - 1) > 200_000:
            raise ValueError("state space too large for brute force")
        states = _compositions(self.C, self.n)
        w = np.array([np.prod(self._theta**np.array(s)) for s in states])
        w = w / w.sum()
        return {tuple(s): float(v) for s, v in zip(states, w)}


def _compositions(total: int, parts: int) -> list[tuple[int, ...]]:
    """All non-negative integer vectors of length `parts` summing to `total`."""
    if parts == 1:
        return [(total,)]
    out = []
    for head in range(total + 1):
        for tail in _compositions(total - head, parts - 1):
            out.append((head,) + tail)
    return out


# ---------------------------------------------------------------------- #
# Saturated-regime closed forms (paper §4 & App. F/G)
# ---------------------------------------------------------------------- #
def two_cluster_delay_bounds(
    n: int, n_f: int, mu_f: float, mu_s: float, C: int
) -> tuple[float, float]:
    """Closed-form delay bounds for the 2-cluster saturated regime (App. F.1).

    Uniform sampling p_i=1/n, n_f fast nodes at rate mu_f, n-n_f slow at mu_s
    (mu_f > mu_s).  Returns (m_fast_bound, m_slow_bound) in CS steps:

        m_f <= lambda/mu_f * 1/(mu_f/mu_s - 1)
        m_s <= lambda/mu_s * (C/(n-n_f) - n_f/(n-n_f) * 1/(mu_f/mu_s - 1))

    (The paper specializes to n_f = n/2 giving its 5n / 195n example.)
    """
    if mu_f <= mu_s:
        raise ValueError("mu_f must exceed mu_s in the 2-cluster regime")
    lam = n_f * mu_f + (n - n_f) * mu_s
    ratio = mu_f / mu_s - 1.0
    x_f = 1.0 / ratio  # limiting scaled queue length of a fast node
    m_fast = lam / mu_f * x_f
    m_slow = lam / mu_s * (C / (n - n_f) - n_f / (n - n_f) * x_f)
    return float(m_fast), float(m_slow)


def three_cluster_delay_bounds(
    n: int,
    n_f: int,
    n_m: int,
    mu_f: float,
    mu_m: float,
    mu_s: float,
    C: int,
    p_fast_busy: float = 1.0,
) -> tuple[float, float, float]:
    """App. G closed forms for fast/medium/slow clusters (fast queues degenerate).

    lambda = n_f*P(X_f>0)*mu_f + (n_m-n_f)*mu_m + (n-n_m)*mu_s.
    Returns (m_fast, m_medium, m_slow) upper bounds in CS steps.
    """
    if not (mu_f > mu_m > mu_s):
        raise ValueError("need mu_f > mu_m > mu_s")
    lam = n_f * p_fast_busy * mu_f + (n_m - n_f) * mu_m + (n - n_m) * mu_s
    ratio_m = mu_m / mu_s - 1.0
    m_fast = lam / mu_f
    m_med = lam / mu_m / ratio_m
    m_slow = lam / mu_s * (C * (n / (n - n_m)) / n - 1.0 / ratio_m)
    # note: with equal thirds (n-n_m)=n/3 the paper writes 3C/n - 1/ratio.
    return float(m_fast), float(m_med), float(m_slow)


# --------------------------------------------------------------------------- #
# mixed open/closed analysis: serving plane coupled to the training network
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class MixedServingResult:
    """Stationary quantities of the open serving queue beside the closed network.

    All rates are in the physical (unrescaled) units of ``mu``.
    """

    lambda_train: float      # closed-network CS step throughput Lambda(C)
    serve_rate_eff: float    # nu_eff: serve rate after training interference
    rho: float               # offered load lambda_arr / nu_eff
    block_prob: float        # P(shed): arrival finds the M/M/1/K queue full
    admit_rate: float        # lambda_arr * (1 - block_prob)
    mean_queue: float        # E[Q] including the request in service
    mean_sojourn: float      # W = E[Q] / admit_rate (Little's law)
    p99_sojourn: float       # FCFS tail estimate ln(100) * W
    utilization: float       # P(server busy) = 1 - pi_0


def serving_slo(
    lambda_train: float,
    *,
    arrival_rate: float,
    serve_rate: float,
    queue_cap: int,
    update_capacity: float | None = None,
) -> MixedServingResult:
    """M/M/1/K serving-plane factor at a given training throughput.

    ``update_capacity`` models the *host* coupling that the merged CTMC
    abstracts away: the serve loop shares one host with the update scan, so
    each training step at throughput ``lambda_train`` steals
    1/update_capacity of the wall clock and the effective serve rate shrinks
    to

        nu_eff = serve_rate * max(1 - lambda_train/update_capacity, 0.05).

    With ``update_capacity=None`` the planes are independent and
    ``nu_eff = serve_rate`` — the exact law of the simulated merged chain.
    The p99 estimate is the FCFS exponential-tail approximation
    ``ln(100) * W``.
    """
    if arrival_rate <= 0 or serve_rate <= 0:
        raise ValueError("arrival_rate and serve_rate must be positive")
    if queue_cap < 1:
        raise ValueError("queue_cap must be >= 1")
    if update_capacity is not None:
        frac = max(1.0 - float(lambda_train) / float(update_capacity), 0.05)
        nu_eff = serve_rate * frac
    else:
        nu_eff = float(serve_rate)
    K = int(queue_cap)
    rho = arrival_rate / nu_eff
    if abs(rho - 1.0) < 1e-12:
        block = 1.0 / (K + 1)
        mean_q = K / 2.0
        pi0 = 1.0 / (K + 1)
    else:
        block = (1.0 - rho) * rho**K / (1.0 - rho ** (K + 1))
        mean_q = rho / (1.0 - rho) - (K + 1) * rho ** (K + 1) / (
            1.0 - rho ** (K + 1)
        )
        pi0 = (1.0 - rho) / (1.0 - rho ** (K + 1))
    admit = arrival_rate * (1.0 - block)
    W = mean_q / admit if admit > 0 else math.inf
    return MixedServingResult(
        lambda_train=float(lambda_train),
        serve_rate_eff=float(nu_eff),
        rho=float(rho),
        block_prob=float(block),
        admit_rate=float(admit),
        mean_queue=float(mean_q),
        mean_sojourn=float(W),
        p99_sojourn=float(math.log(100.0) * W),
        utilization=float(1.0 - pi0),
    )


def mixed_serving_analysis(
    mu: np.ndarray,
    p: np.ndarray,
    C: int,
    *,
    arrival_rate: float,
    serve_rate: float,
    queue_cap: int,
    update_capacity: float | None = None,
) -> MixedServingResult:
    """Product-form analysis of the merged open/closed network.

    The engine merges an open Poisson(``arrival_rate``) inference stream into
    the closed Jackson network's event race (`repro.core.serving`).  In the
    merged CTMC the serving clocks are independent of the training state, so
    the stationary law factorizes: closed product-form marginal (Prop. 2)
    x an M/M/1/K marginal with K = ``queue_cap`` for the serve queue.  This
    evaluates the closed factor with Buzen's algorithm and composes it with
    the open factor via `serving_slo` (which also carries the optional
    ``update_capacity`` host-interference model).
    `repro.core.sampling.optimize_tradeoff` drives this to trade training
    throughput against the serving SLO.
    """
    net = JacksonNetwork(mu=np.asarray(mu, float), p=np.asarray(p, float), C=C)
    return serving_slo(
        net.throughput(),
        arrival_rate=arrival_rate,
        serve_rate=serve_rate,
        queue_cap=queue_cap,
        update_capacity=update_capacity,
    )
