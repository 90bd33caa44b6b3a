"""Reproduce the paper's sampling-optimization study (Figs. 2, 3, 5, 9) on
the PyTorch port's control plane.

Sweeps the fast-client speed mu_f, computes the bound-optimal sampling
probability p (CS-step and physical-time objectives), and validates the
delay predictions against event-driven simulation of the closed network.
The control plane and the simulator are host code (numpy), so this script
touches no device:

    PYTHONPATH=src python examples/torch/optimal_sampling.py
"""
import time

import numpy as np

from repro_torch.core import (
    BoundConstants,
    JacksonNetwork,
    SimConfig,
    optimize_general,
    optimize_physical_time,
    optimize_two_cluster,
    simulate,
    two_cluster_delay_bounds,
)


def main() -> None:
    n, n_f = 100, 90
    k = BoundConstants(A=100.0, L=1.0, B=20.0, C=10, T=10_000)

    print("== Fig. 2/3: optimal p_fast and bound improvement vs speed ==")
    print(f"{'mu_f':>6s} {'p_fast*':>10s} {'p_slow*':>10s} {'improvement':>12s}")
    for mu_f in (2.0, 4.0, 8.0, 16.0):
        res = optimize_two_cluster(mu_f, 1.0, n, n_f, k)
        print(f"{mu_f:6.1f} {res.p[0]:10.2e} {res.p[-1]:10.2e} "
              f"{100*res.relative_improvement:11.1f}%")

    print("\n== App. E.2 (Fig. 9): physical-time objective ==")
    for mu_f in (2.0, 8.0):
        res = optimize_physical_time(mu_f, 1.0, n, n_f, k, U=1000.0)
        print(f"mu_f={mu_f:4.1f} p_fast*={res.p[0]:.2e} "
              f"improvement={100*res.relative_improvement:.1f}%")

    print("\n== Fig. 5: saturated delays, theory vs simulation ==")
    n2, nf2, C2 = 10, 5, 1000
    mu = np.array([1.2] * nf2 + [1.0] * (n2 - nf2))
    p = np.full(n2, 1 / n2)
    bounds = two_cluster_delay_bounds(n2, nf2, 1.2, 1.0, C2)
    net = JacksonNetwork(mu=mu, p=p, C=C2)
    est = net.expected_delays()
    sim = simulate(SimConfig(mu=mu, p=p, C=C2, T=300_000, seed=0, record_delays=True))
    sd = sim.mean_delay_per_node()
    print(f"fast: closed-form<= {bounds[0]:7.1f}  jackson-est {est[0]:7.1f}  sim {np.mean(sd[:nf2]):7.1f}")
    print(f"slow: closed-form<= {bounds[1]:7.1f}  jackson-est {est[-1]:7.1f}  sim {np.mean(sd[nf2:]):7.1f}")
    print("(paper reports ~50 fast / ~1950 slow for this configuration)")

    print("\n== Beyond-paper: general heterogeneous speeds at n=256, C=64 ==")
    rng = np.random.default_rng(0)
    mu_het = rng.uniform(0.5, 8.0, 256)
    k_big = BoundConstants(A=100.0, L=1.0, B=20.0, C=64, T=10_000)
    t0 = time.perf_counter()
    res = optimize_general(mu_het, k_big, iters=60)
    dt = time.perf_counter() - t0
    corr = np.corrcoef(mu_het, res.p)[0, 1]
    print(f"optimized 256 clients in {dt:.2f}s: improvement="
          f"{100*res.relative_improvement:.1f}%  corr(mu, p*)={corr:+.2f}")
    print("(negative correlation: slower clients are sampled more, as in Fig. 4)")


if __name__ == "__main__":
    main()
