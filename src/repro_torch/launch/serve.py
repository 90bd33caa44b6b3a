"""Resilient serving driver: continual training under live inference traffic
(`repro.launch.serve`).

Two coupled planes:

1. **Training plane**: the fused device-stream engine runs async-LM
   pre-training of the requested architecture (`fl.engine.LMTask`) over the
   closed Jackson network, with an open Poisson inference stream merged
   into the event race (`core.serving.ServingConfig`): token-bucket
   admission, load shedding above the queue-depth cap, deadline timeouts
   with capped exponential-backoff retries, and reads served from the last
   known-good snapshot (guard-rejected updates are never observable).
2. **Decode plane**: the trained weights then serve a batched prefill +
   decode loop through ``api.serve_step`` (ring KV cache / SSM state / MoE
   routing, per architecture family).

Runs on the GPU unless ``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --batch 4 --steps 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
        --train-steps 200 --arrival-rate 2.0 --serve-rate 4.0

``--train-steps 0`` (default) skips the training plane and runs the plain
batched-decode driver; ``run_serve`` returns everything as a dict.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, smoke_config
from ..device import resolve_device
from ..models import api
from ..models.module import init_params
from ..tree import tree_map


def materialize_cache(spec: dict, device="cuda") -> dict:
    """Zero tensors of a cache spec (`api.init_cache`) on ``device``; the
    ring positions (1-d int32) start at -1, empty."""
    dev = resolve_device(device)

    def one(s):
        if s.dtype == torch.int32 and s.ndim == 1:  # ring positions: -1 = empty
            return torch.full(s.shape, -1, dtype=s.dtype, device=dev)
        return torch.zeros(s.shape, dtype=s.dtype, device=dev)

    return {k: one(s) for k, s in spec.items()}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--preset", choices=["small", "full"], default="small")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    # training-plane knobs (0 train steps = decode only)
    ap.add_argument("--train-steps", type=int, default=0)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--concurrency", type=int, default=4)
    ap.add_argument("--eta", type=float, default=0.05)
    # serving-plane knobs (arrival-rate 0 = train without live traffic)
    ap.add_argument("--arrival-rate", type=float, default=2.0)
    ap.add_argument("--serve-rate", type=float, default=4.0)
    ap.add_argument("--queue-cap", type=int, default=8)
    ap.add_argument("--bucket-rate", type=float, default=0.0)
    ap.add_argument("--bucket-cap", type=float, default=8.0)
    ap.add_argument("--deadline", type=float, default=2.0)
    ap.add_argument("--max-retries", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="torch device (cpu for a host run)")
    return ap


def _train_under_traffic(cfg, args) -> tuple[dict, dict]:
    """Training plane: the fused engine with the open serving stream merged.

    Returns (final_params, serve_extras): the ``serve_*`` counters of the
    merged run (arrival / served / shed / timed-out conservation, the
    staleness histogram, the sojourn sums, the known-good step).
    """
    from ..configs.base import FLConfig
    from ..core.serving import ServingConfig
    from ..fl.engine import LMTask, run_experiment

    serving = None
    if args.arrival_rate > 0:
        serving = ServingConfig(
            arrival_rate=args.arrival_rate,
            serve_rate=args.serve_rate,
            queue_cap=args.queue_cap,
            bucket_rate=args.bucket_rate,
            bucket_cap=args.bucket_cap,
            deadline=args.deadline,
            max_retries=args.max_retries,
        )
    flc = FLConfig(
        n_clients=args.clients,
        concurrency=args.concurrency,
        server_steps=args.train_steps,
        sampling="uniform",
        seed=args.seed,
        engine="scan",
        stream="device",
        sparse=False,
        device=args.device,
    )
    run = run_experiment(
        flc, "gen_async", eta=args.eta, eval_every=0,
        task=LMTask(cfg, batch_size=2, seq_len=16, shard_size=8, eval_batch=2),
        serving=serving,
    )
    extras = {k: v for k, v in run.extras.items() if k.startswith("serve_")}
    return run.final_params, extras


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def _decode(cfg, params, args) -> dict:
    """Decode plane: batched prefill + decode through ``api.serve_step``.

    The prefill runs the prompt through repeated decode steps (exercising
    the ring cache exactly).  Nothing is read back inside the loops: the
    generated ids and the logits' finiteness stay on the device until the
    end, and each phase's time closes with a device synchronize."""
    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    B = args.batch
    cache = materialize_cache(api.init_cache(cfg, B, args.prompt_len + args.steps), dev)

    def step(c, b):
        return api.serve_step(params, c, b, cfg)

    if cfg.frontend == "audio_stub":
        prompt = torch.from_numpy(
            rng.normal(size=(B, args.prompt_len, cfg.d_model)).astype(np.float32)).to(dev)
        feed = lambda t: {"embeds": prompt[:, t : t + 1]}  # noqa: E731
    else:
        prompt_ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, args.prompt_len))).to(dev)
        feed = lambda t: {"tokens": prompt_ids[:, t : t + 1]}  # noqa: E731
    _sync(dev)
    t0 = time.perf_counter()
    out = None
    for t in range(args.prompt_len):
        out, cache = step(cache, feed(t))
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    generated = []
    t0 = time.perf_counter()
    nxt = out["next_ids"][:, None]
    finite = torch.isfinite(out["logits"]).all()
    for _ in range(args.steps):
        if cfg.frontend == "audio_stub":
            batch = {"embeds": torch.zeros((B, 1, cfg.d_model), dtype=torch.float32, device=dev)}
        else:
            batch = {"tokens": nxt}
        out, cache = step(cache, batch)
        finite = finite & torch.isfinite(out["logits"]).all()
        nxt = out["next_ids"][:, None]
        generated.append(out["next_ids"])
    _sync(dev)
    t_dec = time.perf_counter() - t0
    return {
        "generated": torch.stack(generated, dim=1).cpu().numpy(),
        "prefill_s": t_prefill,
        "decode_s": t_dec,
        "tok_per_s": B * args.steps / max(t_dec, 1e-9),
        "logits_finite": bool(finite),
    }


def run_serve(argv: list[str] | None = None) -> dict:
    """The whole driver as a callable: parse ``argv``, run both planes,
    return the stats.

    The returned dict always has the decode stats; with ``--train-steps >
    0`` it also carries ``train_wall_s`` and the ``serve_*`` counters of
    the merged training run.
    """
    args = _parser().parse_args(argv)
    cfg = smoke_config(args.arch) if args.preset == "small" else get_config(args.arch)
    dev = resolve_device(args.device)
    result: dict = {"arch": cfg.name}

    if args.train_steps > 0:
        t0 = time.perf_counter()
        params, serve_extras = _train_under_traffic(cfg, args)
        _sync(dev)
        result["train_wall_s"] = time.perf_counter() - t0
        result.update(serve_extras)
        params = tree_map(lambda x: x.detach(), params)
    else:
        params = init_params(api.model_meta(cfg), args.seed, dev)

    result.update(_decode(cfg, params, args))
    return result


def main() -> None:
    r = run_serve()
    print(
        f"arch={r['arch']} prefill={r['prefill_s']*1e3:.1f}ms "
        f"decode={r['decode_s']*1e3:.1f}ms ({r['tok_per_s']:.1f} tok/s aggregate) "
        f"logits_finite={r['logits_finite']}"
    )
    if "serve_arrivals" in r:
        print(
            f"serving: arrivals={int(r['serve_arrivals'])} "
            f"served={int(r['serve_served'])} shed={int(r['serve_shed'])} "
            f"timed_out={int(r['serve_timed_out'])} "
            f"retried={int(r['serve_retried'])} "
            f"known_good_step={int(r['serve_kg_step'])}"
        )
    print("sample generation (client 0):", r["generated"][0][:16].tolist())


if __name__ == "__main__":
    main()
