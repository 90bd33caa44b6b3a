"""Data pipeline: synthetic LM stream + non-iid federated classification.

CIFAR-10 / TinyImageNet are not available offline; the federated experiments
use a synthetic classification task with the *same heterogeneity mechanism*
as the paper (each client holds a subset of classes — 7 of 10 in the paper's
CIFAR split), and the LM path uses a Zipf-distributed token stream with
Markov structure so losses are informative (not flat noise).

Everything is deterministic given a seed, streaming (no dataset
materialization), and host-side numpy feeding jitted device steps.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["SyntheticLMStream", "FederatedClassification", "make_client_speeds"]


class SyntheticLMStream:
    """Zipf unigram + first-order Markov bigram token stream.

    A random sparse transition structure makes next-token prediction
    learnable: loss decreases materially within a few hundred steps on a
    small model.
    """

    def __init__(self, vocab_size: int, seq_len: int, seed: int = 0, branch: int = 8):
        self.V, self.S = vocab_size, seq_len
        self.rng = np.random.default_rng(seed)
        # each token has `branch` likely successors (shared structure)
        self.succ = self.rng.integers(0, vocab_size, size=(vocab_size, branch))
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)

    def batch(self, batch_size: int) -> dict:
        B, S = batch_size, self.S
        toks = np.zeros((B, S + 1), dtype=np.int32)
        toks[:, 0] = self.rng.choice(self.V, size=B, p=self.unigram)
        follow = self.rng.random((B, S)) < 0.85
        nxt_choice = self.rng.integers(0, self.succ.shape[1], size=(B, S))
        rand_tok = self.rng.choice(self.V, size=(B, S), p=self.unigram)
        for t in range(S):
            markov = self.succ[toks[:, t], nxt_choice[:, t]]
            toks[:, t + 1] = np.where(follow[:, t], markov, rand_tok[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclass
class FederatedClassification:
    """Prototype-mixture classification, split non-iid across n clients.

    Each class c has a prototype vector; x = prototype[y] + noise.  Client i
    sees `classes_per_client` of the `num_classes` classes (paper: 7 of 10),
    drawn without replacement per client — heterogeneous G^2 > 0.
    """

    n_clients: int = 100
    num_classes: int = 10
    dim: int = 64
    classes_per_client: int = 7
    noise: float = 0.8
    seed: int = 0
    _protos: np.ndarray = field(init=False, repr=False)
    _client_classes: np.ndarray = field(init=False, repr=False)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._protos = rng.normal(size=(self.num_classes, self.dim))
        self._protos /= np.linalg.norm(self._protos, axis=1, keepdims=True)
        self._client_classes = np.stack(
            [
                rng.choice(self.num_classes, size=self.classes_per_client, replace=False)
                for _ in range(self.n_clients)
            ]
        )
        self._rngs = [np.random.default_rng(self.seed * 7919 + 31 * i + 1) for i in range(self.n_clients)]
        self._eval_rng = np.random.default_rng(self.seed + 10_007)

    def client_batch(self, client: int, batch_size: int) -> dict:
        rng = self._rngs[client]
        ys = rng.choice(self._client_classes[client], size=batch_size)
        xs = self._protos[ys] + self.noise * rng.normal(size=(batch_size, self.dim))
        return {"x": xs.astype(np.float32), "y": ys.astype(np.int32)}

    def eval_batch(self, batch_size: int) -> dict:
        """IID draw over all classes — the central server's validation set."""
        ys = self._eval_rng.choice(self.num_classes, size=batch_size)
        xs = self._protos[ys] + self.noise * self._eval_rng.normal(size=(batch_size, self.dim))
        return {"x": xs.astype(np.float32), "y": ys.astype(np.int32)}

    def device_shards(self, samples_per_client: int) -> tuple[np.ndarray, np.ndarray]:
        """Materialize fixed-size per-client datasets as stacked arrays.

        Returns (x, y) with shapes (n_clients, m, dim) / (n_clients, m) —
        the device-resident form the compiled scan engine gathers minibatches
        from (client axis indexed by the traced J_k).  Deterministic given the
        dataset seed and independent of the streaming `client_batch` RNG state.
        """
        m = int(samples_per_client)
        xs = np.empty((self.n_clients, m, self.dim), np.float32)
        ys = np.empty((self.n_clients, m), np.int32)
        for i in range(self.n_clients):
            rng = np.random.default_rng(self.seed * 104_729 + 613 * i + 7)
            yi = rng.choice(self._client_classes[i], size=m)
            xs[i] = self._protos[yi] + self.noise * rng.normal(size=(m, self.dim))
            ys[i] = yi
        return xs, ys


def make_client_speeds(
    n: int, frac_fast: float, speed_ratio: float, mu_slow: float = 1.0, seed: int = 0
) -> np.ndarray:
    """Paper's 2-cluster speed assignment: fast clients are `speed_ratio`x faster."""
    rng = np.random.default_rng(seed)
    n_fast = int(round(n * frac_fast))
    mu = np.full(n, mu_slow)
    fast_idx = rng.choice(n, size=n_fast, replace=False)
    mu[fast_idx] = mu_slow * speed_ratio
    return mu
