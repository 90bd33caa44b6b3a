"""Federated runtime: PyTorch client gradients wired into the
Generalized-AsyncSGD server loop (`core.async_sgd`).

The counterpart of `repro.fl.engine`: the paper's §5 experiment (an MLP
classifier over non-iid federated shards, `ClassificationTask`) and async
LM pre-training of a real model config (`LMTask`), the sampling policy
(uniform / Jackson-optimal / physical-time-optimal, from `core.sampling`),
and the asynchronous server algorithms (Generalized AsyncSGD, AsyncSGD),
with accuracy (or eval loss) against CS steps and physical time.

Parameters keep the JAX layout (``w1`` is ``(dim, hidden)``, the forward is
``x @ w1 + b1``), so `params_from_numpy` carries the JAX package's weights
across unchanged.  Random draws (initial weights, minibatch window offsets)
come from `torch.Generator`s; parity tests pass the JAX package's arrays in.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable

import numpy as np
import torch

from ..configs.base import FLConfig
from ..core.async_sgd import ServerConfig, run_generalized_async_sgd
from ..core.sampling import optimize_physical_time, optimize_two_cluster
from ..core.theory import BoundConstants
from ..data.pipeline import FederatedClassification, SyntheticLMStream, make_client_speeds
from ..device import resolve_device
from ..tree import tree_leaves, tree_map
from ..unported import unported

__all__ = [
    "MLPClassifier",
    "FLClients",
    "DeviceFLClients",
    "DeviceTaskClients",
    "TaskSetup",
    "ClassificationTask",
    "LMTask",
    "FLRun",
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
    the one named place tests carry weights across."""
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
        self._grad = torch.func.grad(model.loss)
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
        self._loss_grad = torch.func.grad(loss_fn)
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
    if flc.sampling == "optimal":
        res = optimize_two_cluster(mu_f, mu_s, n, n_f, k)
    elif flc.sampling == "physical_time":
        res = optimize_physical_time(mu_f, mu_s, n, n_f, k)
    else:
        raise ValueError(flc.sampling)
    # res.p has fast-first layout; map onto actual fast/slow indices
    p = np.empty(n)
    p_fast, p_slow = res.p[0], res.p[-1]
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


def _cached_fl_setup(data: FederatedClassification | None, seed: int, task=None,
                     n_clients: int | None = None,
                     device: str | torch.device = "cuda") -> TaskSetup:
    """Task setup (params, device clients, eval fn) memoized per (seed, task)
    on the dataset — or, for dataset-free tasks like `LMTask`, on the task
    object — so repeated runs reuse one gradient source (and with it the
    memoized runner).  A cached setup on another device raises."""
    task = task if task is not None else ClassificationTask()
    dev = resolve_device(device)
    owner = data if data is not None else task
    cache = owner.__dict__.setdefault("_fl_setup_cache", {})
    key = (seed, task.cache_key())
    if key not in cache:
        n = n_clients if n_clients is not None else data.n_clients
        cache[key] = task.build(data, seed, n, device=dev)
    setup = cache[key]
    have = _setup_device(setup)
    if have.type != dev.type or (dev.index is not None and have.index != dev.index):
        raise ValueError(f"cached task setup lives on {have}, run asks for {dev}")
    return setup


def _reject_unported(flc: FLConfig, method, task, faults, guard, serving, ckpt_dir):
    if method in ("fedbuff", "fedavg", "favano"):
        raise unported(f"method={method!r}", 4)
    if method not in ("gen_async", "async_sgd"):
        raise ValueError(method)
    if task is not None and not isinstance(task, (ClassificationTask, LMTask)):
        raise unported(f"task={type(task).__name__}", "7d")
    if faults is not None or guard is not None:
        raise unported("faults= / guard=", 8)
    if ckpt_dir is not None:
        raise unported("ckpt_dir=", 8)
    if serving is not None:
        raise unported("serving=", 11)
    if flc.stream == "device":
        raise unported("stream='device'", 6)
    if flc.adaptive:
        raise unported("adaptive=True", 6)
    if flc.devices > 1:
        raise unported("devices > 1", 12)


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
    """One training run of {gen_async, async_sgd} on ``flc.device``.

    ``engine`` (default: ``flc.engine``) picks the server loop: "python" is
    the per-event reference loop over streaming host batches, "scan" the
    device-resident replay engine over the cached task setup.  ``task``
    picks the workload: the paper's MLP (`ClassificationTask`, the default)
    or `LMTask` over a dense / VLM / audio / SSM / hybrid model config
    (``eval_acc`` then carries eval loss; the Python loop drives the same device gradient
    through its host ``grad`` entry).  ``flc.block_size`` turns on the micro-blocked replay (an int E, or
    "auto"), ``flc.segmentation`` its cut placement.  The other keywords
    keep `repro.fl.engine.run_experiment`'s signature; the options the port
    does not run yet raise `NotImplementedError`.
    """
    _reject_unported(flc, method, task, faults, guard, serving, ckpt_dir)
    device = resolve_device(flc.device)
    engine = flc.engine if engine is None else engine
    if engine not in ("python", "scan"):
        raise ValueError(engine)
    classification = task is None or isinstance(task, ClassificationTask)
    if classification:
        data = data or FederatedClassification(n_clients=flc.n_clients, seed=flc.seed)
    mu = make_client_speeds(flc.n_clients, flc.frac_fast, flc.speed_ratio, seed=flc.seed)

    use_scan = engine == "scan"
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
        stream="host",
        block_size=flc.block_size if use_scan else 1,
        segmentation=flc.segmentation,
        scenario=flc.scenario,
        device=flc.device,
    )
    if method == "gen_async":
        p = sampling_for(flc, mu)
        cfg = replace(base, p=p, weighting="importance")
    else:  # async_sgd
        cfg = replace(base, weighting="plain")
    w, tr = run_generalized_async_sgd(w0, clients, cfg, eval_fn=acc_fn)

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
    extras.update(tr.extras)
    return FLRun(
        name=method,
        eval_steps=ev_steps,
        eval_acc=np.asarray(tr.eval_values),
        eval_times=times,
        mean_delays=delays,
        final_params=w,
        extras=extras,
    )


def run_matrix(flc: FLConfig, *args, **kwargs):
    """The batched scenario matrix — not ported yet."""
    raise unported("run_matrix", 5)
