"""Quickstart on the PyTorch port: the paper's pipeline in 60 seconds.

1. model client speeds as a closed Jackson network,
2. compute delay-aware optimal sampling probabilities (Generalized AsyncSGD),
3. train a small federated model and compare against uniform AsyncSGD.

Runs on the GPU unless ``--device cpu`` is given:

    PYTHONPATH=src python examples/torch/quickstart.py
    PYTHONPATH=src python examples/torch/quickstart.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.configs.base import FLConfig
from repro_torch.core import (
    BoundConstants,
    JacksonNetwork,
    SimConfig,
    optimize_two_cluster,
    simulate,
)
from repro_torch.fl import run_experiment


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (cpu for a host run)")
    args = ap.parse_args(argv)

    # --- 1. queueing analysis ------------------------------------------- #
    n, n_f, C = 10, 5, 10
    mu = np.array([10.0] * n_f + [1.0] * (n - n_f))   # 5 fast, 5 slow
    p = np.full(n, 1 / n)
    net = JacksonNetwork(mu=mu, p=p, C=C)
    m_hat = net.expected_delays()
    sim = simulate(SimConfig(mu=mu, p=p, C=C, T=50_000, seed=0, record_delays=True))
    print("expected delays (steps)  theory:", np.round(m_hat, 1))
    print("                        simulated:", np.round(sim.mean_delay_per_node(), 1))

    # --- 2. optimal sampling --------------------------------------------- #
    k = BoundConstants(C=C, T=10_000)
    res = optimize_two_cluster(mu_f=10.0, mu_s=1.0, n=n, n_f=n_f, k=k)
    print(f"\noptimal p_fast={res.p[0]:.4f} p_slow={res.p[-1]:.4f} "
          f"(uniform would be {1/n:.4f})")
    print(f"bound improvement vs uniform: {100*res.relative_improvement:.1f}%")

    # --- 3. train --------------------------------------------------------- #
    # engine="scan" replays the pre-simulated event stream on the device
    # (engine="python" is the per-event reference loop)
    flc = FLConfig(n_clients=20, concurrency=8, server_steps=200,
                   speed_ratio=10.0, engine="scan", device=args.device)
    print(f"\ntraining (200 server steps, 20 clients, 10x speed gap, scan engine, "
          f"{args.device}):")
    for method in ("gen_async", "async_sgd", "fedbuff"):
        r = run_experiment(flc, method, eta=0.08, eval_every=100)
        print(f"  {method:10s} final accuracy {r.eval_acc[-1]:.3f}")


if __name__ == "__main__":
    main()
