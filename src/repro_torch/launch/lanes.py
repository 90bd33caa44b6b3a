"""Start the ranks of a lane-sharded replay: D processes joined by one
`torch.distributed` process group.

The blocked replay shards the E lanes of every micro-block over the D ranks
of the default process group (``FLConfig(block_size=E, devices=D)``, or
``ServerConfig(..., devices=D)``); every rank makes the same call and gets
the same result.  `run_lanes` starts those ranks on one host:

    from repro_torch.launch.lanes import run_lanes

    def train(rank, world):  # a module-level function: it is pickled
        r = run_experiment(FLConfig(engine="scan", block_size=8, devices=world),
                           "gen_async")
        return {k: v.cpu().numpy() for k, v in r.final_params.items()}

    if __name__ == "__main__":  # the spawned ranks import this script
        params_by_rank = run_lanes(train, 2)

`torchrun --nproc-per-node D` with ``init_process_group`` in the script does
the same across hosts.  With one card for each rank (D <= the cards, more
than one card) the group uses NCCL and rank r runs on card r; otherwise
(several ranks sharing a card, or no card) it uses gloo, which takes CPU and
CUDA tensors, with rank r on card r mod cards (NCCL refuses two ranks on
one device).  `placement` makes that choice.
"""
from __future__ import annotations

import socket
import time
import traceback
from datetime import timedelta
from typing import Any, Callable

__all__ = ["placement", "run_lanes"]


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def placement(world: int, cards: int, backend: str = "auto") -> tuple[str, list[int | None]]:
    """The process group's backend and each rank's card for ``world`` ranks
    on a host with ``cards`` cards: ``(backend, [card of rank r])``.

    "auto" takes NCCL with rank r on card r when every rank has a card of
    its own and there is more than one card; else gloo with rank r on card
    r mod ``cards`` (None without a card).  ``backend="nccl"`` asks for
    NCCL and raises where the ranks would share a card; ``"gloo"`` keeps
    gloo on any host.  Nothing falls back from one backend to the other.
    """
    if world < 1 or cards < 0:
        raise ValueError(f"world={world} and cards={cards}: at least one rank, cards >= 0")
    if backend == "auto":
        backend = "nccl" if 1 < cards and world <= cards else "gloo"
    if backend == "nccl":
        if world > cards:
            raise ValueError(f"NCCL needs a card for each rank: {world} ranks, {cards} card(s)")
        return "nccl", list(range(world))
    if backend != "gloo":
        raise ValueError(f"backend={backend!r} (auto | nccl | gloo)")
    return "gloo", [r % cards if cards else None for r in range(world)]


def _rank_main(rank: int, world: int, port: int, timeout: float, backend: str,
               card: int | None, fn: Callable, args: tuple, results) -> None:
    import torch
    import torch.distributed as dist

    try:
        if card is not None:  # "cuda" in fn means this rank's card
            torch.cuda.set_device(card)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=timeout))
        out = fn(rank, world, *args)
        dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_lanes(fn: Callable[..., Any], world: int, args: tuple = (), *,
              timeout: float = 300.0, backend: str = "auto") -> list:
    """``[fn(rank, world, *args) for rank in range(world)]``, each call in
    its own spawned process, all joined by one process group on 127.0.0.1
    (a free port): NCCL with one card a rank, else gloo (`placement`; each
    rank's card is its current device before ``fn`` runs).

    ``fn`` and ``args`` are pickled, so ``fn`` is a module-level function,
    and each result comes back pickled: return CPU tensors or numpy arrays.
    Processes are spawned, never forked, so a parent that has initialised
    CUDA may call this.  Raises `RuntimeError` with the rank's traceback if
    any rank fails, and `TimeoutError` if the ranks have not all returned
    within ``timeout`` seconds (a hung collective); every process is
    stopped before it returns or raises.
    """
    import queue

    import torch
    import torch.multiprocessing as mp

    backend, cards = placement(world, torch.cuda.device_count(), backend)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, timeout, backend, cards[r], fn, args, results),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out: dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"run_lanes: {world - len(out)} of {world} ranks did not "
                                   f"return within {timeout:.0f} s")
            try:
                rank, ok, val = results.get(timeout=min(left, 5.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"run_lanes: rank(s) {dead} exited without a result "
                                       f"(exit codes {[procs[r].exitcode for r in dead]})")
                continue
            if not ok:
                raise RuntimeError(f"run_lanes: rank {rank} of {world} failed:\n{val}")
            out[rank] = val
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]
