"""Training entry point: Generalized AsyncSGD end to end (`repro.launch.train`).

Two modes, with the reference's flags:
  * ``--mode fl`` — the paper's §5 experiment: n heterogeneous clients,
    non-iid classification, one run per method of ``--methods``.
  * ``--mode lm`` — asynchronous LM pre-training of an assigned
    architecture (reduced preset by default) with the same queueing
    engine: clients are data-parallel groups with heterogeneous speeds and
    the server applies importance-weighted updates (Alg. 1 line 10).
    ``--engine`` picks the server loop: "python" (the per-event oracle),
    "scan" (the replay engine; ``--block-size`` micro-blocks it) or
    "fused" (the scan engine on the device event stream).
    ``--ckpt-dir`` saves the final parameters there (`repro_torch.ckpt`,
    the reference's layout).

Runs on the GPU unless ``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.launch.train --mode lm --preset full \\
        --arch granite-3-2b --concurrency 4
    PYTHONPATH=src python -m repro_torch.launch.train --mode lm --preset full \\
        --arch mamba2-130m
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, smoke_config
from ..ckpt import save
from ..configs.base import FLConfig
from ..data.pipeline import SyntheticLMStream
from ..fl import LMTask, run_experiment
from ..models import api
from ..tree import tree_leaves

__all__ = ["LMClients", "lm_config", "run_lm", "run_fl", "main"]


class LMClients:
    """GradientSource: each client draws from its own synthetic LM stream.

    The legacy streaming source of the original per-event Python loop: each
    `grad` call consumes fresh host RNG state, so runs are NOT replayable
    against the compiled engine.  `LMTask` (fixed per-client shards,
    identical minibatches on every path) supersedes it for anything that
    needs parity; this stays for host-streaming experiments whose datasets
    don't fit device memory.  Client i streams `SyntheticLMStream` with
    seed ``seed * 1000 + i``, as the reference's does, so one seed gives
    the same batches in both packages; each batch goes to the parameters'
    device.
    """

    def __init__(self, cfg, n_clients: int, batch: int, seq: int, seed: int = 0):
        self.cfg = cfg
        self.streams = [
            SyntheticLMStream(cfg.vocab_size, seq, seed=seed * 1000 + i) for i in range(n_clients)
        ]
        self.batch = batch
        self._grad = torch.func.grad(lambda p, b: api.loss_fn(p, b, cfg)[0])
        self.grad_calls = 0

    def grad(self, client_id: int, params, server_step: int):
        b = self.streams[client_id].batch(self.batch)
        self.grad_calls += 1
        dev = tree_leaves(params)[0].device
        return self._grad(params, {k: torch.as_tensor(v, device=dev) for k, v in b.items()})


def lm_config(args):
    cfg = smoke_config(args.arch) if args.preset == "small" else get_config(args.arch)
    if args.preset == "100m":
        cfg = cfg.replace(num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
                          head_dim=64, d_ff=3072, vocab_size=32768, dtype="float32",
                          remat="none")
    return cfg


def run_lm(args) -> None:
    cfg = lm_config(args)
    n, C = args.clients, args.concurrency
    engine = "python" if args.engine == "python" else "scan"
    stream = "device" if args.engine == "fused" else "host"
    task = LMTask(cfg=cfg, batch_size=args.batch, seq_len=args.seq,
                  shard_size=args.shard_size)
    flc = FLConfig(n_clients=n, concurrency=C, server_steps=args.steps,
                   sampling=args.sampling, speed_ratio=args.speed_ratio,
                   seed=args.seed, engine=engine, stream=stream, block_size=args.block_size,
                   device=args.device)

    t0 = time.time()
    r = run_experiment(flc, "gen_async", eta=args.lr,
                       eval_every=args.eval_every, engine=engine, task=task)
    print(f"# lm training done in {time.time()-t0:.1f}s "
          f"(engine={args.engine}, block_size={args.block_size}); "
          f"grad calls offloaded to {n} clients")
    for s, v in zip(r.eval_steps, r.eval_acc):
        print(f"step {s:6d} eval_loss {v:.4f}")
    if r.mean_delays is not None:
        print(f"mean delay overall {np.nanmean(r.mean_delays):.1f} steps")
    if args.ckpt_dir:
        save(args.ckpt_dir, args.steps, r.final_params,
             metadata={"arch": args.arch, "mode": "lm"})
        print(f"checkpoint saved to {args.ckpt_dir}")


def run_fl(args) -> None:
    flc = FLConfig(n_clients=args.clients, concurrency=args.concurrency,
                   server_steps=args.steps, sampling=args.sampling,
                   speed_ratio=args.speed_ratio, seed=args.seed, device=args.device)
    for method in args.methods.split(","):
        t0 = time.time()
        r = run_experiment(flc, method, eta=args.lr, eval_every=args.eval_every)
        accs = ", ".join(f"{s}:{a:.3f}" for s, a in zip(r.eval_steps, r.eval_acc))
        print(f"{method:10s} final_acc={r.eval_acc[-1]:.3f}  [{accs}]  ({time.time()-t0:.1f}s)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["fl", "lm"], default="fl")
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--preset", choices=["small", "100m", "full"], default="small")
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--shard-size", type=int, default=256,
                    help="per-client LM dataset rows (device-resident)")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--speed-ratio", type=float, default=10.0)
    ap.add_argument("--sampling", default="optimal",
                    choices=["uniform", "optimal", "physical_time"])
    ap.add_argument("--methods", default="gen_async,async_sgd,fedbuff")
    ap.add_argument("--engine", choices=["python", "scan", "fused"],
                    default="scan", help="LM server loop (fused = device stream)")
    ap.add_argument("--block-size", type=int, default=1,
                    help="micro-block size E for the blocked scan engine")
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default="cuda", help="torch device (cpu for a host run)")
    args = ap.parse_args(argv)
    if args.mode == "lm":
        run_lm(args)
    else:
        run_fl(args)


if __name__ == "__main__":
    main()
