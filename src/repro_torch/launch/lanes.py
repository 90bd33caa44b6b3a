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
the same across hosts.  The group uses the gloo backend, which takes CPU and
CUDA tensors, so D ranks may share one card (NCCL refuses two ranks on one
device).
"""
from __future__ import annotations

import socket
import time
import traceback
from datetime import timedelta
from typing import Any, Callable

__all__ = ["run_lanes"]


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, timeout: float,
               fn: Callable, args: tuple, results) -> None:
    import torch.distributed as dist

    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=timeout))
        out = fn(rank, world, *args)
        dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_lanes(fn: Callable[..., Any], world: int, args: tuple = (), *,
              timeout: float = 300.0) -> list:
    """``[fn(rank, world, *args) for rank in range(world)]``, each call in
    its own spawned process, all joined by a gloo process group on
    127.0.0.1 (a free port).

    ``fn`` and ``args`` are pickled, so ``fn`` is a module-level function,
    and each result comes back pickled: return CPU tensors or numpy arrays.
    Processes are spawned, never forked, so a parent that has initialised
    CUDA may call this.  Raises `RuntimeError` with the rank's traceback if
    any rank fails, and `TimeoutError` if the ranks have not all returned
    within ``timeout`` seconds (a hung collective); every process is
    stopped before it returns or raises.
    """
    import queue

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, timeout, fn, args, results),
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
