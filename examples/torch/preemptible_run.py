"""Preemptible training on the PyTorch port: SIGKILL a faulted run
mid-flight, resume bitwise.

Long asynchronous-FL runs die — preempted VMs, OOM kills, node drains —
and the injected failure modes (client churn, crashes, stragglers) make
re-running from scratch both expensive and irreproducible.  The engine
therefore checkpoints its *full* state every ``ckpt_every`` events
(iterate, snapshot ring, queue/statistics state, sampling distribution,
eval buffer, event cursor) and `resume=True` continues from the latest
checkpoint with a bitwise-identical trajectory.

This demo runs the §5 federated experiment with churn + crashes +
timeouts and a divergence guard, in three acts:

  1. a child process starts the run and is SIGKILLed mid-flight (a real
     kill -9 — no cleanup, no atexit),
  2. the parent resumes from the surviving checkpoints to completion,
  3. an uninterrupted reference run (fresh directory) confirms the
     resumed final parameters are bitwise identical.

Runs on the GPU unless ``--device cpu`` is given:

    PYTHONPATH=src python examples/torch/preemptible_run.py
"""
import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(os.path.dirname(HERE)), "src")
sys.path.insert(0, SRC)

import torch  # noqa: E402

from repro_torch.ckpt import checkpoint as ck  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.core import FaultConfig, GuardConfig  # noqa: E402
from repro_torch.fl.engine import run_experiment  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

N, C, T = 32, 8, 2000
CKPT_EVERY = 250
SEED = 7


def _experiment(ckpt_dir: str, resume: bool, device: str):
    flc = FLConfig(n_clients=N, concurrency=C, server_steps=T, seed=SEED,
                   engine="scan", device=device)
    fault = FaultConfig(off_rate=0.2, on_rate=1.0,   # Markov on/off churn
                        crash_rate=0.05,             # crash-with-task-loss
                        timeout_rate=0.1)            # straggler timeouts
    guard = GuardConfig(max_grad_norm=1e3, stale_cutoff=25 * C)
    run = run_experiment(flc, "gen_async", eval_every=T // 4, faults=fault,
                         guard=guard, ckpt_dir=ckpt_dir,
                         ckpt_every=CKPT_EVERY, resume=resume)
    flat = torch.cat([x.reshape(-1) for x in tree_leaves(run.final_params)]).cpu().numpy()
    return run, flat


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (cpu for a host run)")
    args = ap.parse_args(argv)
    root = tempfile.mkdtemp(prefix="preemptible_")
    d_run, d_ref = os.path.join(root, "run"), os.path.join(root, "reference")
    try:
        # -- act 1: child starts the run, parent SIGKILLs it mid-flight --- #
        child_src = (
            f"import sys; sys.path.insert(0, {SRC!r}); sys.path.insert(0, {HERE!r}); "
            f"from preemptible_run import _experiment; "
            f"_experiment({d_run!r}, False, {args.device!r}); print('UNREACHED', flush=True)"
        )
        print(f"[1] starting run (T={T}, ckpt every {CKPT_EVERY} events, {args.device}) "
              "in a child process ...")
        child = subprocess.Popen([sys.executable, "-c", child_src],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        # wait for the second checkpoint to land, then kill -9
        deadline = time.time() + 300
        while time.time() < deadline:
            steps = ck.available_steps(d_run) if os.path.isdir(d_run) else []
            if len(steps) >= 2:
                break
            if child.poll() is not None:
                out, err = child.communicate()
                raise SystemExit(
                    f"child exited early (rc={child.returncode}):\n"
                    f"{err.decode()[-2000:]}"
                )
            time.sleep(0.1)
        child.kill()  # SIGKILL: no cleanup, exactly like a preemption
        child.wait()
        steps = ck.available_steps(d_run)
        print(f"    SIGKILLed at checkpoints {steps} "
              f"(event cursor {max(steps)}/{T})")
        assert steps and max(steps) < T, "child finished before the kill"

        # -- act 2: resume from the surviving checkpoints ----------------- #
        print("[2] resuming from the latest checkpoint ...")
        run_res, flat_res = _experiment(d_run, True, args.device)
        kinds = np.asarray(run_res.extras["kind_count"])
        print(f"    resumed to T={T}: kind counts "
              f"complete={kinds[0]} flip={kinds[1]} crash={kinds[2]} "
              f"timeout={kinds[3]}, guard_rejects="
              f"{int(np.asarray(run_res.extras['guard_rejects']))}, "
              f"stale_drops={int(np.asarray(run_res.extras['stale_drops']))}")

        # -- act 3: uninterrupted reference run, bitwise comparison ------- #
        print("[3] uninterrupted reference run ...")
        _, flat_ref = _experiment(d_ref, False, args.device)
        bitwise = (flat_res.view(np.uint8) == flat_ref.view(np.uint8)).all()
        print(f"    resumed == uninterrupted, bitwise: {bool(bitwise)} "
              f"({flat_ref.size} parameters)")
        if not bitwise:
            raise SystemExit("kill-and-resume diverged from the reference run")
        print("\nA preempted run and its resume are the SAME run: the "
              "checkpoint carries the\nfull engine state, and per-chunk "
              "randomness re-derives from the run's seed, so\nnothing about "
              "the interruption is visible in the final iterate.")
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
