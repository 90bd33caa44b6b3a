"""Scenario matrix on the PyTorch port: many runs in one lockstep replay.

The queuing structure of asynchronous FL makes the event stream independent
of the gradients, so a grid of whole training runs (seeds x sampling
policies x heterogeneity levels) replays along one cell axis: one gather,
one vmapped gradient, one update and one scatter per event for all cells.
This sweeps the paper's §5 comparison across heterogeneity.  Runs on the
GPU unless ``--device cpu`` is given:

    PYTHONPATH=src python examples/torch/scenario_matrix.py
"""
import argparse

from repro_torch.configs.base import FLConfig
from repro_torch.fl import run_matrix


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (cpu for a host run)")
    args = ap.parse_args(argv)
    flc = FLConfig(n_clients=40, concurrency=16, server_steps=2000, device=args.device)
    seeds = (0, 1, 2)
    policies = ("uniform", "optimal", "physical_time")
    ratios = (1.0, 4.0, 16.0)
    print(f"{len(seeds)} seeds x {policies} x speed ratios {ratios} "
          f"= {len(seeds) * len(policies) * len(ratios)} runs, one lockstep replay\n")
    m = run_matrix(flc, seeds=seeds, policies=policies, speed_ratios=ratios,
                   eta=0.08, eval_every=200)

    acc = m.final_acc.mean(axis=0)          # average over seeds -> (P, H)
    print(f"final accuracy (mean over {len(seeds)} seeds):")
    print(f"{'policy':>14s} " + " ".join(f"ratio={r:<5g}" for r in ratios))
    for pi, pol in enumerate(policies):
        print(f"{pol:>14s} " + " ".join(f"{acc[pi, hi]:.3f}    " for hi in range(len(ratios))))

    # physical time to finish T steps: optimal sampling trades a slightly
    # slower clock for unbiased, lower-variance progress per step
    t_end = m.eval_times[..., -1].mean(axis=0)
    print("\nphysical time at final eval (mean over seeds):")
    for pi, pol in enumerate(policies):
        print(f"{pol:>14s} " + " ".join(f"{t_end[pi, hi]:8.1f} " for hi in range(len(ratios))))


if __name__ == "__main__":
    main()
