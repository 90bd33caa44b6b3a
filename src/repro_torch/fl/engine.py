"""Federated runtime: PyTorch client gradients wired into the
Generalized-AsyncSGD server loop (`core.async_sgd`).

The counterpart of `repro.fl.engine`: the paper's §5 experiment (an MLP
classifier over non-iid federated shards, `ClassificationTask`) and async
LM pre-training of a real model config (`LMTask`), the sampling policy
(uniform / Jackson-optimal / physical-time-optimal, from `core.sampling`),
and the server algorithms (Generalized AsyncSGD, AsyncSGD, FedBuff, and the
synchronous FedAvg and FAVANO baselines), with accuracy (or eval loss)
against CS steps and physical time.

Parameters keep the JAX layout (``w1`` is ``(dim, hidden)``, the forward is
``x @ w1 + b1``), so `params_from_numpy` carries the JAX package's weights
across unchanged.  Random draws (initial weights, minibatch window offsets)
come from `torch.Generator`s; parity tests pass the JAX package's arrays in.
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass, field, replace
from functools import lru_cache
from typing import Any, Callable

import numpy as np
import torch

from ..configs.base import FLConfig
from ..core.async_sgd import (
    ServerConfig,
    run_favano,
    run_fedavg,
    run_fedbuff,
    run_generalized_async_sgd,
)
from ..core.sampling import optimize_physical_time, optimize_two_cluster
from ..core.theory import BoundConstants
from ..data.pipeline import FederatedClassification, SyntheticLMStream, make_client_speeds
from ..device import resolve_device
from ..tree import tree_leaves, tree_map

__all__ = [
    "MLPClassifier",
    "FLClients",
    "DeviceFLClients",
    "DeviceTaskClients",
    "TaskSetup",
    "ClassificationTask",
    "LMTask",
    "FLRun",
    "MatrixResult",
    "params_from_numpy",
    "run_experiment",
    "run_matrix",
    "sampling_for",
]


# ------------------------------------------------------------------ #
# the FL-scale classifier
# ------------------------------------------------------------------ #
class MLPClassifier:
    """2-hidden-layer MLP; the FL-scale model (paper used ResNet20/CIFAR).

    Functional, like the JAX model: ``init_params`` is a dict of tensors and
    ``logits`` / ``loss`` take the params explicitly, so `torch.func.grad`
    differentiates them and the engine packs them into its snapshot ring.
    """

    def __init__(self, dim: int, num_classes: int, hidden: int = 128, seed: int = 0,
                 device: str | torch.device = "cuda"):
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        s1, s2 = 1.0 / np.sqrt(dim), 1.0 / np.sqrt(hidden)
        params = {
            "w1": torch.randn((dim, hidden), generator=gen) * float(s1),
            "b1": torch.zeros((hidden,)),
            "w2": torch.randn((hidden, hidden), generator=gen) * float(s2),
            "b2": torch.zeros((hidden,)),
            "w3": torch.randn((hidden, num_classes), generator=gen) * float(s2),
            "b3": torch.zeros((num_classes,)),
        }
        self.init_params = {k: v.to(dev) for k, v in params.items()}

    @staticmethod
    def logits(params, x):
        h = torch.relu(x @ params["w1"] + params["b1"])
        h = torch.relu(h @ params["w2"] + params["b2"])
        return h @ params["w3"] + params["b3"]

    @staticmethod
    def loss(params, batch):
        lg = MLPClassifier.logits(params, batch["x"])
        lp = torch.log_softmax(lg, dim=-1)
        return -torch.mean(torch.gather(lp, -1, batch["y"][:, None]))


def _tensor_from_numpy(a) -> torch.Tensor:
    """One array as a CPU tensor, bf16 included: numpy's ``ml_dtypes``
    bfloat16 (what ``np.asarray`` of a JAX bf16 array gives) travels as its
    uint16 bits, which `torch.tensor` accepts."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.tensor(a)


def params_from_numpy(params, device):
    """A JAX parameter tree (nested dicts of arrays) as the port's tensors.

    Both packages keep the same layout, so this is a bitwise copy; it is
    the one named place tests carry weights across.  An optimizer state
    (`optim.make_optimizer`'s dict: ``count`` a 0-d int32, the moments
    trees in their state dtype) crosses the same way."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor_from_numpy(a).to(dev), params)


def _window_starts(starts, seed: int, shard_size: int, batch_size: int, block: int,
                   device: torch.device) -> torch.Tensor:
    """The (block,) table of minibatch window offsets on ``device``: the
    given array (parity tests pass the JAX package's), else a draw from
    ``torch.Generator(seed)``."""
    if batch_size > shard_size:
        raise ValueError("batch_size must be <= shard_size")
    if starts is None:
        gen = torch.Generator().manual_seed(seed)
        starts = torch.randint(0, shard_size - batch_size + 1, (block,), generator=gen)
    starts = torch.tensor(np.asarray(starts), dtype=torch.int64)
    if starts.shape != (block,):
        raise ValueError(f"starts must have shape ({block},)")
    if int(starts.min()) < 0 or int(starts.max()) > shard_size - batch_size:
        raise ValueError("window offsets must lie in [0, shard_size - batch_size]")
    return starts.to(device)


def _func_grad(fn):
    """`torch.func.grad` of ``fn``, with `torch._dynamo` imported first.

    The first `torch.func.grad` call of a process imports `torch._dynamo`;
    `torch.fx.wrap`, run by that import, keeps its own frame in a local, a
    cycle whose chain of calling frames holds the first gradient's tensors
    and its callers' locals until Python's cyclic collector runs.
    Imported here, before any gradient, it holds none.
    """
    import torch._dynamo  # noqa: F401

    return torch.func.grad(fn)


class FLClients:
    """Host gradient source for the per-event Python loop: streaming numpy
    minibatches (`FederatedClassification.client_batch`) moved to the
    device, one `torch.func.grad` call each."""

    def __init__(self, data: FederatedClassification, model: MLPClassifier,
                 batch_size: int = 128, device: str | torch.device = "cuda"):
        self.data = data
        self.model = model
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self._grad = _func_grad(model.loss)
        self.grad_calls = 0

    def grad(self, client_id: int, params, server_step: int):
        batch = self.data.client_batch(client_id, self.batch_size)
        self.grad_calls += 1
        return self._grad(params, {
            "x": torch.as_tensor(batch["x"], device=self.device),
            "y": torch.as_tensor(batch["y"], dtype=torch.int64, device=self.device),
        })


class DeviceTaskClients:
    """Device-resident gradient source for an arbitrary ``(loss_fn, params)``.

    Any loss ``loss_fn(params, batch) -> scalar`` over a dict batch, with the
    per-client datasets given as ``(n, m, ...)`` arrays and kept on the
    device as flat ``(n * m, ...)`` row tables (integer arrays as int64,
    torch's index dtype).  A minibatch is the window of B rows starting at
    a pre-drawn offset, gathered with `index_select` from 0-d device
    tensors: no host sync, and the same code runs under `torch.func.vmap`.

    ``starts`` (the (OFFSET_BLOCK,) window-offset table) defaults to a draw
    from ``torch.Generator(seed)``, where the reference draws
    ``jax.random.randint``; parity tests pass the JAX package's.  The host
    ``grad`` gives the per-event Python loop the same minibatches and
    gradients as ``device_grad``.
    """

    OFFSET_BLOCK = 8192  # pre-drawn window offsets, reused cyclically

    def __init__(self, loss_fn, shards: dict, batch_size: int, seed: int = 0,
                 starts: np.ndarray | None = None, device: str | torch.device = "cuda"):
        dev = resolve_device(device)
        arrays = {k: np.asarray(v) for k, v in shards.items()}
        first = next(iter(arrays.values()))
        self.n_clients, self.shard_size = int(first.shape[0]), int(first.shape[1])
        for k, v in arrays.items():
            if v.shape[:2] != (self.n_clients, self.shard_size):
                raise ValueError(f"shard {k!r}: leading dims must agree")
        self._starts = _window_starts(starts, seed, self.shard_size, batch_size,
                                      self.OFFSET_BLOCK, dev)

        def table(a):
            t = torch.as_tensor(a.reshape(-1, *a.shape[2:]))
            return (t.long() if not t.is_floating_point() else t).to(dev)

        self.shards = {k: table(v) for k, v in arrays.items()}
        self.batch_size = int(batch_size)
        self.loss_fn = loss_fn
        self._window = torch.arange(self.batch_size, dtype=torch.int64, device=dev)
        self._loss_grad = _func_grad(loss_fn)
        self.grad_calls = 0

    def client_batch(self, client_id, server_step) -> dict:
        dev = self._window.device
        step = torch.as_tensor(server_step, device=dev).reshape(1) % self.OFFSET_BLOCK
        start = self._starts.index_select(0, step)                 # (1,)
        rows = client_id * self.shard_size + start + self._window  # (B,)
        return {k: v.index_select(0, rows) for k, v in self.shards.items()}

    def device_grad(self, client_id, params, server_step):
        return self._loss_grad(params, self.client_batch(client_id, server_step))

    def grad(self, client_id: int, params, server_step: int):
        # per-event Python loop entry: the same computation, Python-int ids
        self.grad_calls += 1
        dev = self._window.device
        return self.device_grad(torch.tensor(client_id, device=dev), params,
                                torch.tensor(server_step, device=dev))


class DeviceFLClients(DeviceTaskClients):
    """Device-resident gradient source for the MLP: `DeviceTaskClients`
    over ``model.loss`` and the ``x`` / ``y`` shard tables of
    `FederatedClassification.device_shards` (``(n * m, dim)`` rows)."""

    def __init__(
        self,
        data: FederatedClassification,
        model: MLPClassifier,
        batch_size: int = 128,
        shard_size: int = 1024,
        seed: int = 0,
        starts: np.ndarray | None = None,
        device: str | torch.device = "cuda",
    ):
        xs, ys = data.device_shards(shard_size)
        super().__init__(model.loss, {"x": xs, "y": ys}, batch_size, seed=seed,
                         starts=starts, device=device)
        self.model = model


# ------------------------------------------------------------------ #
@lru_cache(maxsize=64)
def _two_cluster_p(policy: str, mu_f: float, mu_s: float, n: int, n_f: int, k: tuple):
    """(p_fast, p_slow) of the two-cluster optimum: a pure function of its
    scalars, memoized because every run of a configuration asks again (the
    n=256 optimum takes seconds of host time)."""
    opt = optimize_two_cluster if policy == "optimal" else optimize_physical_time
    res = opt(mu_f, mu_s, n, n_f, BoundConstants(*k))
    return float(res.p[0]), float(res.p[-1])


def sampling_for(flc: FLConfig, mu: np.ndarray, constants: BoundConstants | None = None) -> np.ndarray:
    """Sampling probabilities per the configured policy."""
    n = flc.n_clients
    if flc.sampling == "uniform":
        return np.full(n, 1.0 / n)
    k = constants or BoundConstants(C=flc.concurrency, T=flc.server_steps)
    mu_f, mu_s = float(mu.max()), float(mu.min())
    n_f = int(np.sum(mu > (mu_f + mu_s) / 2))
    if mu_f == mu_s or n_f in (0, n):
        return np.full(n, 1.0 / n)
    if flc.sampling not in ("optimal", "physical_time"):
        raise ValueError(flc.sampling)
    p_fast, p_slow = _two_cluster_p(flc.sampling, mu_f, mu_s, n, n_f,
                                    (k.A, k.L, k.B, k.C, k.T, k.rho))
    # the optimum has a fast-first layout; map onto actual fast/slow indices
    p = np.empty(n)
    p[mu > (mu_f + mu_s) / 2] = p_fast
    p[mu <= (mu_f + mu_s) / 2] = p_slow
    return p / p.sum()


@dataclass
class FLRun:
    name: str
    eval_steps: np.ndarray
    eval_acc: np.ndarray
    eval_times: np.ndarray
    mean_delays: np.ndarray | None = None
    final_params: Any = None
    extras: dict = field(default_factory=dict)


def _accuracy_fn(model: MLPClassifier, data: FederatedClassification, batch: int = 2048,
                 device: str | torch.device = "cuda"):
    """Eval-set accuracy as a device scalar (no host sync), usable both by
    the Python loop (``float(...)``) and inside the replay engine."""
    dev = resolve_device(device)
    ev = data.eval_batch(batch)
    x = torch.as_tensor(ev["x"], device=dev)
    y = torch.as_tensor(ev["y"], dtype=torch.int64, device=dev)

    def acc(params):
        return torch.mean((torch.argmax(MLPClassifier.logits(params, x), -1) == y).float())

    return acc


@dataclass
class TaskSetup:
    """What a task hands the engine: initial params, a device gradient
    source, and an eval fn returning a device scalar."""

    params: Any
    clients: Any
    eval_fn: Callable
    model: Any = None


@dataclass
class ClassificationTask:
    """The paper's §5 task: an MLP over `FederatedClassification` shards."""

    batch_size: int = 128
    shard_size: int = 1024
    hidden: int = 128

    def cache_key(self):
        return ("classification", self.batch_size, self.shard_size, self.hidden)

    def build(self, data: FederatedClassification, seed: int, n_clients: int,
              device: str | torch.device = "cuda") -> TaskSetup:
        if data is None:
            raise ValueError("ClassificationTask requires a dataset")
        model = MLPClassifier(data.dim, data.num_classes, hidden=self.hidden, seed=seed,
                              device=device)
        clients = DeviceFLClients(
            data, model, batch_size=self.batch_size, shard_size=self.shard_size,
            seed=seed, device=device,
        )
        return TaskSetup(
            params=model.init_params,
            clients=clients,
            eval_fn=_accuracy_fn(model, data, device=device),
            model=model,
        )


@dataclass
class LMTask:
    """Async-LM pre-training task: ``api.loss_fn`` over a real ModelConfig.

    Each client holds a fixed non-iid shard materialized from its own
    `SyntheticLMStream` (seed ``seed*1000 + i``, bitwise the reference's
    shards), stacked to ``(n, m, S)`` token/label tables on the device.
    The eval metric is the loss on a held-out stream (seed 9999), a device
    scalar.  Every family runs: dense, MoE, VLM, audio, SSM (Mamba2) and
    hybrid (Zamba2); with ``cfg.use_pallas`` the forward runs the
    hand-written kernels — flash attention (K3) in the attention blocks,
    the chunked SSD scan (K4) in the Mamba2 blocks, the grouped expert
    matmul (K5) in the MoE blocks under ``cfg.moe_dispatch="sort"`` — whose
    backwards are the plain reference's VJPs.
    """

    cfg: Any                      # repro_torch.configs.base.ModelConfig (hashable)
    batch_size: int = 4
    seq_len: int = 64
    shard_size: int = 256
    eval_batch: int = 16

    def cache_key(self):
        return ("lm", self.cfg, self.batch_size, self.seq_len,
                self.shard_size, self.eval_batch)

    def shards(self, seed: int, n_clients: int) -> dict:
        """The clients' (n, m, S) int32 token and label arrays (numpy)."""
        toks = np.empty((n_clients, self.shard_size, self.seq_len), np.int32)
        labs = np.empty_like(toks)
        for i in range(n_clients):
            b = SyntheticLMStream(self.cfg.vocab_size, self.seq_len,
                                  seed=seed * 1000 + i).batch(self.shard_size)
            toks[i], labs[i] = b["tokens"], b["labels"]
        return {"tokens": toks, "labels": labs}

    def build(self, data, seed: int, n_clients: int,
              device: str | torch.device = "cuda") -> TaskSetup:
        from ..models import api
        from ..models.module import init_params

        dev = resolve_device(device)
        cfg = self.cfg
        params = init_params(api.model_meta(cfg), seed, dev)

        def loss(params, batch):
            return api.loss_fn(params, batch, cfg)[0]

        clients = DeviceTaskClients(loss, self.shards(seed, n_clients),
                                    batch_size=self.batch_size, seed=seed, device=dev)
        ev = SyntheticLMStream(cfg.vocab_size, self.seq_len, seed=9999).batch(self.eval_batch)
        ev = {k: torch.as_tensor(v, dtype=torch.int64, device=dev) for k, v in ev.items()}
        return TaskSetup(params=params, clients=clients, eval_fn=lambda p: loss(p, ev))


def _setup_device(setup: TaskSetup) -> torch.device:
    return tree_leaves(setup.params)[0].device


def _takes_device(build) -> bool:
    try:
        params = inspect.signature(build).parameters
    except (TypeError, ValueError):
        return False
    return "device" in params or any(p.kind is p.VAR_KEYWORD for p in params.values())


def _cached_fl_setup(data: FederatedClassification | None, seed: int, task=None,
                     n_clients: int | None = None,
                     device: str | torch.device = "cuda") -> TaskSetup:
    """Task setup (params, device clients, eval fn) memoized per (seed, task)
    on the dataset — or, for dataset-free tasks like `LMTask`, on the task
    object — so repeated runs reuse one gradient source (and with it the
    memoized runner).

    ``task`` is any object with ``cache_key()`` and ``build(data, seed,
    n_clients) -> TaskSetup``, as in the reference; the port's own tasks
    (and any whose ``build`` takes a ``device`` keyword) are built on
    ``device``.  A cached setup on another device raises, and so does a
    task that put its tensors elsewhere."""
    task = task if task is not None else ClassificationTask()
    dev = resolve_device(device)
    owner = data if data is not None else task
    cache = owner.__dict__.setdefault("_fl_setup_cache", {})
    key = (seed, task.cache_key())
    if key not in cache:
        n = n_clients if n_clients is not None else getattr(data, "n_clients", None)
        kw = {"device": dev} if _takes_device(task.build) else {}
        cache[key] = task.build(data, seed, n, **kw)
    setup = cache[key]
    have = _setup_device(setup)
    if have.type != dev.type or (dev.index is not None and have.index != dev.index):
        raise ValueError(f"cached task setup lives on {have}, run asks for {dev}")
    return setup


def run_experiment(
    flc: FLConfig,
    method: str,
    eta: float = 0.05,
    eval_every: int = 10,
    data: FederatedClassification | None = None,
    engine: str | None = None,
    task=None,
    faults=None,
    guard=None,
    serving=None,
    ckpt_dir: str | None = None,
    ckpt_every: int = 0,
    resume: bool = False,
) -> FLRun:
    """One training run of {gen_async, async_sgd, fedbuff, fedavg, favano}
    on ``flc.device``.

    ``engine`` (default: ``flc.engine``) picks the server loop: "python" is
    the per-event reference loop over streaming host batches, "scan" the
    device-resident replay engine over the cached task setup; the
    synchronous baselines (fedavg, favano) always run their host loop, as in
    `repro`.  ``task`` picks the workload: the paper's MLP
    (`ClassificationTask`, the default), `LMTask` over a dense / VLM /
    audio / SSM / hybrid model config (``eval_acc`` then carries eval loss;
    the Python loop drives the same device gradient through its host
    ``grad`` entry), or any object with ``cache_key()`` and ``build(data,
    seed, n_clients) -> TaskSetup`` (`_cached_fl_setup`).  ``flc.block_size`` turns on the micro-blocked replay
    (an int E, or "auto"), ``flc.segmentation`` its cut placement, and
    ``flc.devices = D > 1`` shards its lanes over the D ranks of a
    `torch.distributed` process group (every rank makes the same call and
    gets the same result).

    ``flc.stream`` picks the scan engine's event source: "host" replay, or
    "device" generation (the fused runner; it implies the scan engine and
    is the only one that runs ``flc.adaptive`` sampling).

    Robustness knobs (async methods, either stream): ``faults`` injects
    client churn / crashes / straggler timeouts (`core.FaultConfig`),
    ``guard`` rejects divergent or over-stale updates (`core.GuardConfig`),
    ``flc.scenario`` swaps in a phase-type service law and modulated
    availability (per event on the device stream), ``serving`` merges an
    open inference-request stream into the device event race and serves
    from the snapshot ring (`core.ServingConfig`, requires ``flc.stream ==
    "device"``; the ``serve_*`` counters land in ``FLRun.extras``), and
    ``ckpt_dir`` + ``ckpt_every`` checkpoint the full engine state every
    ``ckpt_every`` CS steps (scan engine; on the device stream not with a
    scenario, as in the reference); ``resume=True`` restores the latest
    checkpoint and continues, bitwise.  The other keywords keep
    `repro.fl.engine.run_experiment`'s signature.
    """
    if method not in ("gen_async", "async_sgd", "fedbuff", "fedavg", "favano"):
        raise ValueError(method)
    device = resolve_device(flc.device)
    if flc.stream == "device":
        if engine == "python":
            raise ValueError("stream='device' requires the scan engine")
        engine = "scan"
    else:
        engine = flc.engine if engine is None else engine
    if engine not in ("python", "scan"):
        raise ValueError(engine)
    classification = task is None or isinstance(task, ClassificationTask)
    if classification:
        data = data or FederatedClassification(n_clients=flc.n_clients, seed=flc.seed)
    mu = make_client_speeds(flc.n_clients, flc.frac_fast, flc.speed_ratio, seed=flc.seed)

    async_method = method in ("gen_async", "async_sgd", "fedbuff")
    use_scan = engine == "scan" and async_method
    if flc.adaptive and async_method and not use_scan:
        raise ValueError("adaptive sampling requires engine='scan' with stream='device'")
    if use_scan or not classification:
        setup = _cached_fl_setup(data, flc.seed, task, n_clients=flc.n_clients,
                                 device=device)
        w0, clients, acc_fn = setup.params, setup.clients, setup.eval_fn
    else:
        # per-event Python loop for classification: streaming host batches
        model = MLPClassifier(data.dim, data.num_classes, seed=flc.seed, device=device)
        clients = FLClients(data, model, device=device)
        acc_fn = _accuracy_fn(model, data, device=device)
        w0 = model.init_params

    base = ServerConfig(
        n=flc.n_clients,
        C=flc.concurrency,
        T=flc.server_steps,
        eta=eta,
        mu=mu,
        service=flc.service,
        seed=flc.seed,
        eval_every=eval_every,
        engine="scan" if use_scan else "python",
        stream=flc.stream if use_scan else "host",
        sparse=flc.sparse,
        adaptive=flc.adaptive if use_scan else False,
        refresh_every=flc.refresh_every,
        block_size=flc.block_size if use_scan else 1,
        devices=flc.devices if use_scan else 1,
        segmentation=flc.segmentation,
        faults=faults,
        guard=guard,
        serving=serving,
        ckpt_dir=ckpt_dir,
        ckpt_every=ckpt_every,
        resume=resume,
        scenario=flc.scenario,
        device=flc.device,
    )
    if method == "gen_async":
        p = sampling_for(flc, mu)
        cfg = replace(base, p=p, weighting="importance")
        w, tr = run_generalized_async_sgd(w0, clients, cfg, eval_fn=acc_fn)
    elif method == "async_sgd":
        cfg = replace(base, weighting="plain")
        w, tr = run_generalized_async_sgd(w0, clients, cfg, eval_fn=acc_fn)
    elif method == "fedbuff":
        cfg = replace(base, weighting="plain")
        w, tr = run_fedbuff(w0, clients, cfg, Z=flc.fedbuff_Z, eval_fn=acc_fn)
    elif method == "fedavg":
        cfg = replace(base, weighting="plain")
        w, tr = run_fedavg(w0, clients, cfg, eval_fn=acc_fn)
    else:  # favano
        cfg = replace(base, weighting="plain")
        w, tr = run_favano(w0, clients, cfg, period=1.0 / float(np.median(mu)),
                           eval_fn=acc_fn)

    ev_steps = np.asarray(tr.eval_steps)
    times = (
        np.asarray([tr.times[min(s - 1, len(tr.times) - 1)] for s in tr.eval_steps])
        if len(tr.eval_steps)
        else np.array([])
    )
    delays = None
    if tr.delays is not None:
        delays = np.array([np.mean(d) if d else np.nan for d in tr.delays])
    grad_calls = flc.server_steps if use_scan else clients.grad_calls
    extras = {"grad_calls": grad_calls, "engine": "scan" if use_scan else "python"}
    extras.update(tr.extras)  # device stream: p_final, p_traj, ...
    if delays is None and "mean_delays" in extras:
        delays = extras.pop("mean_delays")
    return FLRun(
        name=method,
        eval_steps=ev_steps,
        eval_acc=np.asarray(tr.eval_values),
        eval_times=times,
        mean_delays=delays,
        final_params=w,
        extras=extras,
    )


# ------------------------------------------------------------------ #
# scenario matrix: seeds x sampling policies x heterogeneity levels
# ------------------------------------------------------------------ #
@dataclass
class MatrixResult:
    """Output of `run_matrix`: eval curves over the full scenario grid."""

    seeds: tuple[int, ...]
    policies: tuple[str, ...]
    speed_ratios: tuple[float, ...]
    eval_steps: np.ndarray    # (n_evals,) CS steps at which accuracy was taken
    eval_acc: np.ndarray      # (S, P, H, n_evals)
    eval_times: np.ndarray    # (S, P, H, n_evals) physical time at each eval
    final_acc: np.ndarray     # (S, P, H)
    p_vectors: np.ndarray     # (P, H, n) sampling vector per (policy, ratio)
    extras: dict = field(default_factory=dict)  # device stream: p_final,
                                                # mean_delays, comp, occ_mean


def _matrix_policies(flc: FLConfig, policies, speed_ratios):
    """The grid's client speeds, one (n,) vector a ratio (``flc.seed`` draws
    them), and its (P, H, n) sampling vectors, one a (policy, ratio)."""
    n = flc.n_clients
    mus = [make_client_speeds(n, flc.frac_fast, ratio, seed=flc.seed) for ratio in speed_ratios]
    p_vectors = np.empty((len(policies), len(speed_ratios), n))
    for pi, pol in enumerate(policies):
        for hi, mu in enumerate(mus):
            p_vectors[pi, hi] = sampling_for(replace(flc, sampling=pol), mu)
    return mus, p_vectors


def matrix_streams(flc: FLConfig, seeds, policies, speed_ratios, eta: float,
                   scenario=None):
    """The scenario grid's sampling vectors and event streams, as
    `run_matrix` replays them: ``(p_vectors (P, H, n), [(EventStream, (T,)
    step scales)] in seed, policy, ratio order)``.  The speeds of a ratio
    and the sampling vector of a (policy, ratio) do not depend on the seed
    (``flc.seed`` draws the speeds); each cell's stream is simulated with
    its own seed, under ``scenario`` (an enabled `ScenarioConfig`) when
    given."""
    from ..core.engine_scan import step_scales
    from ..core.queue_sim import SimConfig, export_stream

    n, C, T = flc.n_clients, flc.concurrency, flc.server_steps
    mus, p_vectors = _matrix_policies(flc, policies, speed_ratios)
    streams = []
    for seed in seeds:
        for pi in range(len(policies)):
            for hi, mu in enumerate(mus):
                p = p_vectors[pi, hi]
                es = export_stream(SimConfig(mu=mu, p=p, C=C, T=T, service=flc.service,
                                             seed=seed, scenario=scenario))
                streams.append((es, step_scales(es, eta, p, flc.weighting)))
    return p_vectors, streams


def run_matrix(
    flc: FLConfig,
    seeds: tuple[int, ...] = (0, 1, 2),
    policies: tuple[str, ...] = ("uniform", "optimal", "physical_time"),
    speed_ratios: tuple[float, ...] | None = None,
    eta: float = 0.05,
    eval_every: int = 50,
    data: FederatedClassification | None = None,
    stream: str | None = None,
    block_size: int | str | None = None,
    devices: int | None = None,
    segmentation: str | None = None,
    task=None,
    scenario: str | None = None,
    kernel: str = "jnp",
) -> MatrixResult:
    """Run the whole scenario grid (seeds x policies x speed ratios) in one
    lockstep run on ``flc.device``, along an explicit cell axis.

    ``stream`` (default ``flc.stream``) picks the event source, as in
    `repro.fl.engine.run_matrix`:

      "host"    one event stream is simulated per cell
                (`queue_sim.export_stream`), the streams are stacked — or,
                with ``block_size`` E > 1 (default ``flc.block_size``;
                ``"auto"`` picks E from all cells' slots), cut into one
                common blocked layout (`engine_scan.blocked_inputs_batch`)
                — and the replay runs every cell at once
                (`engine_scan.jit_runner(..., vmap_streams=True)`).
      "device"  no host pre-simulation: the fused runner
                (`engine_scan.jit_fused_runner(..., vmap_scenarios=True)`)
                generates every cell's events on the device in lockstep and
                replays them, per event or blocked (a scenario: per event
                only).  Exponential service or a scenario's law; runs
                ``flc.adaptive`` sampling per cell (the "uniform"
                rows then double as adaptive-from-uniform runs).  Each
                cell's generator is seeded from (seed, policy, ratio), as
                the reference folds its key; ``extras`` gains ``p_final``,
                ``mean_delays``, ``comp`` and ``occ_mean`` per cell.

    Either way each event (or block) makes one gather, one vmapped gradient
    call, one update and one scatter for all cells; ``final_acc`` is the
    eval fn vmapped over the cells.  ``scenario`` (default
    ``flc.scenario``; a registry name or a `ScenarioConfig`) runs every
    cell's stream under that service law and availability, on the host or
    on the device (there ``extras`` also carries each cell's
    ``kind_count``); its stage and flip events replay as no-ops through
    each cell's trash ring row.

    ``task`` picks the workload as in `run_experiment` (`LMTask`: ``eval_acc``
    and ``final_acc`` then carry eval loss).  The model and dataset are
    shared across cells; only the queueing clock, the sampling vector and
    the event realization differ.  Pass a persistent ``data`` (or the same
    ``task``) to reuse the cached gradient source and with it the memoized
    runner; the host replay's eval cadence is a call-time argument of the
    runner, so a sweep over ``eval_every`` does not rebuild it.

    ``kernel`` picks the host replay's update as ``ServerConfig.update``
    does for one run: "jnp" the plain versions, "pallas" the CUDA kernels
    across cells (K1 per event; K2 blocked, K6 with lanes).  The device
    stream's replay takes the plain update, as the reference's fused runner
    has no kernel option.

    ``devices=D > 1`` (default ``flc.devices``) runs in every rank of a
    `torch.distributed` process group, as the reference runs over the
    devices it sees, and every rank returns the whole grid.  The host
    stream shards each cell's E lanes over the D ranks of a group of D
    (``block_size`` a >1 multiple of D; every cell on the cell axis in every
    rank).  The device stream takes the world's W ranks as a ``shard ×
    lane`` layout: D lanes and ``shard = W // D`` scenario shards when that
    divides the B cells (else 1), on ranks 0 … shard·D−1, the ranks
    above taking no part and receiving the grid from rank 0, as the
    reference's mesh takes its first devices; without lanes the cells are
    sharded over the W ranks when W divides B (`engine_scan.jit_fused_runner`).
    W is the group's world size, 1 without a group (`engine_scan.world_size`).
    """
    from ..core.async_sgd import _auto_block_size, _pallas_update_fn, _probe_stream_slots
    from ..core.engine_scan import blocked_inputs_batch, jit_fused_runner, jit_runner, world_size
    from ..core.queue_sim import EventBlocks
    from ..core.scenario import get_scenario

    stream = flc.stream if stream is None else stream
    if stream not in ("host", "device"):
        raise ValueError(stream)
    if kernel not in ("jnp", "pallas"):
        raise ValueError(kernel)
    if stream == "device" and kernel != "jnp":
        raise ValueError("kernel= picks the host replay's update; the device stream's replay "
                         "takes the plain update")
    sc = get_scenario(scenario if scenario is not None else flc.scenario)
    if sc is not None and not sc.enabled:
        sc = None
    lane = max(int(flc.devices if devices is None else devices), 1)
    if stream == "device":
        if flc.service != "exp":
            raise ValueError("stream='device' supports exponential service only; use "
                             "stream='host' for service='det'")
    block_size = flc.block_size if block_size is None else block_size
    if block_size != "auto":
        block_size = int(block_size)
    if stream == "device" and sc is not None:
        if block_size == "auto":
            block_size = 1  # the scenario stream is per event
        elif block_size > 1:
            raise ValueError("scenario= requires block_size=1")
    segmentation = flc.segmentation if segmentation is None else segmentation
    speed_ratios = (flc.speed_ratio,) if speed_ratios is None else tuple(speed_ratios)
    seeds, policies = tuple(seeds), tuple(policies)
    device = resolve_device(flc.device)
    if task is None or isinstance(task, ClassificationTask):
        data = data or FederatedClassification(n_clients=flc.n_clients, seed=flc.seed)
    setup = _cached_fl_setup(data, flc.seed, task, n_clients=flc.n_clients, device=device)
    clients, acc_fn = setup.clients, setup.eval_fn

    n, C, T = flc.n_clients, flc.concurrency, flc.server_steps
    S, P, H = len(seeds), len(policies), len(speed_ratios)
    w0 = setup.params
    extras: dict = {"stream": stream}
    idx = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)  # noqa: E731
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)  # noqa: E731
    if stream == "device":
        mus, p_vectors = _matrix_policies(flc, policies, speed_ratios)
        mu_b = np.stack([mus[hi] for _ in seeds for _ in range(P) for hi in range(H)])
        p_b = np.stack([p_vectors[pi, hi] for _ in seeds for pi in range(P) for hi in range(H)])
        # each cell's generator from (seed, policy, ratio): the reference
        # folds the cell index pi * H + hi into the seed's key
        keys = [torch.Generator(device=device).manual_seed(
                    int(np.random.SeedSequence([seed, pi * H + hi]).generate_state(1)[0]))
                for seed in seeds for pi in range(P) for hi in range(H)]
        if block_size == "auto":
            block_size = _auto_block_size(
                _probe_stream_slots(mu_b[0], p_b[0], C, T, int(seeds[0]), device, scenario=sc),
                lane)
        # the world's ranks: lanes split each block's gradient batch, the
        # ranks left over shard the cells when they divide them
        W, B = world_size(), len(keys)
        rem = W // lane if lane > 1 else W
        shard = rem if (rem > 1 and B % rem == 0) else 1
        runner = jit_fused_runner(
            clients.device_grad, n, C, T, vmap_scenarios=True, shard_devices=shard,
            lane_devices=lane, weighting=flc.weighting, eval_fn=acc_fn, eval_every=eval_every,
            adaptive=flc.adaptive, refresh_every=flc.refresh_every, block_size=block_size,
            scenario=sc,
        )
        args = (mu_b, p_b, keys)
        if shard > 1 and lane == 1:  # a leading (shard, B / shard), as the reference's pmap
            per = B // shard
            args = (mu_b.reshape(shard, per, n), p_b.reshape(shard, per, n),
                    [keys[i * per:(i + 1) * per] for i in range(shard)])
        w_final, evals, dev_extras = runner(w0, *args, eta)
        if shard > 1 and lane == 1:
            flat = lambda x: x.reshape((B,) + x.shape[2:])  # noqa: E731
            w_final = tree_map(flat, w_final)
            evals = flat(evals)
            dev_extras = {k: flat(v) for k, v in dev_extras.items()}
        dev_extras = {k: v.detach().cpu().numpy() for k, v in dev_extras.items()}
        t_phys = np.asarray(dev_extras["t"], np.float64)
        comp = np.asarray(dev_extras["comp"], np.float64)
        cells = lambda a: np.asarray(a, np.float64).reshape(S, P, H, n)  # noqa: E731
        extras.update(p_final=cells(dev_extras["p_final"]),
                      mean_delays=cells(dev_extras["delay_sum"] / np.maximum(comp, 1.0)),
                      comp=cells(comp), occ_mean=cells(dev_extras["occ_mean"]))
        if sc is not None:  # the kinds of each cell's events, (S, P, H, N_KINDS)
            extras["kind_count"] = dev_extras["kind_count"].reshape(S, P, H, -1)
    else:
        p_vectors, streams = matrix_streams(flc, seeds, policies, speed_ratios, eta,
                                            scenario=sc)
        t_phys = np.stack([es.t for es, _ in streams])
        if block_size == "auto":
            # the single run's resolution policy, over all cells' measured slots
            block_size = _auto_block_size([es.slot for es, _ in streams], lane,
                                          cut_every=eval_every)
        if block_size > 1:
            blocks = [EventBlocks.from_stream(es, block_size, cut_every=eval_every,
                                              method=segmentation) for es, _ in streams]
            Jb, slotb, scb, kb, maskb, chunk_blocks, n_chunks = blocked_inputs_batch(
                blocks, [s for _, s in streams], eval_every)
            runner = jit_runner(clients.device_grad, C, eval_fn=acc_fn, block_size=block_size,
                                vmap_streams=True, kernel=kernel, lane_devices=lane)
            w_final, evals = runner(w0, idx(Jb), idx(slotb), f32(scb), idx(kb),
                                    torch.as_tensor(maskb, device=device),
                                    chunk_blocks=chunk_blocks, n_chunks=n_chunks)
        else:
            if lane > 1:
                raise ValueError("devices > 1 lane-shards micro-blocks and requires "
                                 "block_size > 1")
            runner = jit_runner(clients.device_grad, C, eval_fn=acc_fn, eval_every=eval_every,
                                vmap_streams=True,
                                update_fn=_pallas_update_fn() if kernel == "pallas" else None)
            w_final, evals = runner(w0, idx([es.J for es, _ in streams]),
                                    idx([es.slot for es, _ in streams]),
                                    f32([s for _, s in streams]))

    final_acc = torch.func.vmap(acc_fn)(w_final).detach().cpu().numpy()
    evals = evals.detach().cpu().numpy()
    n_evals = evals.shape[1]
    eval_steps = (np.arange(n_evals) + 1) * eval_every
    eval_times = t_phys[:, eval_every - 1 :: eval_every][:, :n_evals]
    return MatrixResult(
        seeds=seeds,
        policies=policies,
        speed_ratios=speed_ratios,
        eval_steps=eval_steps,
        eval_acc=evals.reshape(S, P, H, n_evals),
        eval_times=eval_times.reshape(S, P, H, n_evals),
        final_acc=final_acc.reshape(S, P, H),
        p_vectors=p_vectors,
        extras=extras,
    )
