"""Adaptive sampling on the PyTorch port's fused device stream:
static-optimal vs adaptive.

The paper optimizes the sampling vector p *offline* from known client
speeds.  The fused engine (``stream="device"``) keeps the closed network on
the device, so p can instead be re-optimized every ``refresh_every`` CS
steps from the *observed* queue dynamics — no prior knowledge of the
speeds.  This demo runs, on a two-cluster network:

  1. uniform sampling                  (the baseline),
  2. static bound-optimal sampling     (oracle speeds, `optimize_general`),
  3. adaptive sampling from uniform    (control loop, measured speeds),

and prints the bound trajectory of the adaptive run against the static
optimum, plus the realized per-node delays of all three.  Runs on the GPU
unless ``--device cpu`` is given:

    PYTHONPATH=src python examples/torch/adaptive_sampling.py
"""
import argparse

import numpy as np
import torch

from repro_torch.core import BoundConstants, make_runner, optimize_general
from repro_torch.core.sampling import bound_for_p
from repro_torch.device import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (cpu for a host run)")
    ap.add_argument("--steps", type=int, default=20_000, help="CS steps T")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n, C, T = 32, 8, args.steps
    refresh = 500
    mu = np.array([8.0] * (n // 2) + [1.0] * (n // 2))
    k = BoundConstants(C=C, T=T)
    uniform = np.full(n, 1.0 / n)

    # oracle: static optimum from the true speeds (generous iteration budget
    # — the adaptive loop's accumulated mirror steps are a strong opponent)
    opt = optimize_general(mu, k, iters=800)
    print("== two-cluster network: n=%d, C=%d, T=%d ==" % (n, C, T))
    print(f"uniform bound        : {opt.uniform_bound:8.4f}")
    print(f"static-optimal bound : {opt.bound:8.4f}  "
          f"(p_fast={opt.p[0]:.4f}, p_slow={opt.p[-1]:.4f})")

    # adaptive: control loop over the fused device stream (no model — the
    # stream/controller runs standalone by passing a zero gradient source)
    def zero_grad(j, w, kk):
        return w * 0.0

    runs = {}
    for name, p0, adaptive_run in (("uniform", uniform, False),
                                   ("static-opt", opt.p, False),
                                   ("adaptive", uniform, True)):
        kw = dict(adaptive=True, refresh_every=refresh, bound=k) if adaptive_run else {}
        run = make_runner(zero_grad, C=C, stream="device", n=n, T=T, **kw)
        key = torch.Generator(device=dev).manual_seed(0)
        _, _, ex = run(torch.zeros(2, device=dev), mu, p0, key, 0.0)
        runs[name] = {key_: v.detach().cpu().numpy().astype(np.float64) for key_, v in ex.items()}

    print("\n== adaptive bound trajectory (per control refresh) ==")
    traj = runs["adaptive"]["p_traj"]
    print(f"{'step':>7s} {'bound':>9s} {'vs static-opt':>14s}")
    for i in range(0, traj.shape[0], max(traj.shape[0] // 10, 1)):
        p_i = np.maximum(traj[i], 1e-12)
        p_i /= p_i.sum()
        b_i = bound_for_p(mu, p_i, k)[0]
        print(f"{(i + 1) * refresh:7d} {b_i:9.4f} {100 * (b_i / opt.bound - 1):+13.2f}%")
    p_fin = np.maximum(runs["adaptive"]["p_final"], 1e-12)
    p_fin /= p_fin.sum()
    b_fin = bound_for_p(mu, p_fin, k)[0]
    print(f"final adaptive bound : {b_fin:8.4f}  "
          f"({100 * (b_fin / opt.bound - 1):+.2f}% vs static optimum)")

    print("\n== realized delays (CS steps, fast / slow cluster means) ==")
    for name, ex in runs.items():
        m_node = ex["delay_sum"] / np.maximum(ex["comp"], 1.0)
        print(f"{name:>11s}: fast {m_node[: n // 2].mean():7.2f}   "
              f"slow {m_node[n // 2 :].mean():7.2f}")
    print("\n(optimal sampling under-samples fast clients: their queues — and "
          "the slow\n clients' — drain, cutting the stale-gradient delays the "
          "bound penalizes.)")


if __name__ == "__main__":
    main()
