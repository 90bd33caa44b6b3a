"""Speed-class structure of the client population (numpy only).

`ClassSpec` / `build_class_spec` detect the exchangeable (mu, p) classes
of a closed Jackson network.  `core.sampling.optimize_general` uses them to
collapse a large clustered population to a few classes before it
optimizes.  The arrays stay numpy here; `ClassSpec.device` moves them to a
torch device for code that gathers from them there.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np

__all__ = ["ClassSpec", "build_class_spec"]


class ClassSpec(NamedTuple):
    """Static speed-class structure of the client population.

    Clients with identical ``(mu, p)`` are exchangeable in the closed
    Jackson network (the paper's two-cluster structure, generalized to m
    classes), so the sparse stream only tracks *which class* each idle
    node belongs to and keeps per-node identity for the C in-flight
    tasks.  ``perm`` maps compact (class-sorted) positions to global
    client ids — clients of class c occupy ``perm[offsets[c] :
    offsets[c] + counts[c]]`` — and ``inv_cls`` inverts it per global id.
    """

    counts: Any   # (m,) int32 — class sizes
    offsets: Any  # (m,) int32 — exclusive prefix sums of counts
    perm: Any     # (n,) int32 — compact position -> global client id
    inv_cls: Any  # (n,) int32 — global client id -> class index

    @property
    def n(self) -> int:
        return int(self.perm.shape[0])

    @property
    def m(self) -> int:
        return int(self.counts.shape[0])

    def device(self, device) -> "ClassSpec":
        import torch

        return ClassSpec(
            *(torch.as_tensor(np.asarray(a, np.int32), device=device) for a in self)
        )

    def cache_key(self) -> tuple:
        return (
            self.n,
            tuple(np.asarray(self.counts).tolist()),
            hash(np.asarray(self.perm, np.int32).tobytes()),
        )


def build_class_spec(mu, p=None, max_classes: int = 64):
    """Detect speed classes from per-node ``(mu, p)``.

    Returns ``(spec, mu_m, p_m)`` with class-level service rates and
    per-node dispatch probabilities.  Raises if more than ``max_classes``
    distinct ``(mu, p)`` pairs exist — the sparse path is for populations
    with cluster structure, not fully heterogeneous rates.
    """
    mu = np.asarray(mu, np.float64)
    n = mu.size
    p = np.full(n, 1.0 / n) if p is None else np.asarray(p, np.float64)
    vals, inv = np.unique(np.stack([mu, p], axis=1), axis=0, return_inverse=True)
    m = vals.shape[0]
    if m > max_classes:
        raise ValueError(
            f"{m} distinct (mu, p) classes exceed max_classes={max_classes}; "
            "the sparse stream needs cluster structure"
        )
    inv = inv.reshape(n)
    counts = np.bincount(inv, minlength=m)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    spec = ClassSpec(
        counts=counts.astype(np.int32),
        offsets=offsets.astype(np.int32),
        perm=np.argsort(inv, kind="stable").astype(np.int32),
        inv_cls=inv.astype(np.int32),
    )
    return spec, vals[:, 0].copy(), vals[:, 1].copy()
