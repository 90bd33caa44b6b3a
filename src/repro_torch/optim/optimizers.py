"""Optimizers in plain torch (`repro.optim.optimizers`): sgd, momentum, adamw.

``opt = make_optimizer(cfg)``; ``state = opt.init(params)``;
``new_params, new_state = opt.update(grads, state, params, scale=1.0)``.
The state is a dict with the reference's keys: ``count`` (a 0-d int32
tensor on the params' device), and the trees ``m`` (momentum, adamw) and
``v`` (adamw), kept in ``cfg.state_dtype`` (bf16 moments for huge models).

The math is fp32 as in the reference: every leaf is cast up, updated and
cast back to its own dtype.  ``scale`` multiplies the step: the
Generalized-AsyncSGD importance weight eta/(n p_j) with the base lr divided
out.  A Python float ``scale`` is multiplied into ``cfg.lr`` in double and
rounded to fp32 once; a tensor ``scale`` (0-d) is taken in fp32 and
multiplies the fp32-rounded lr, as a jax scalar does in the reference.  No
Pallas kernel computes an optimizer in the reference, so none is owed here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..configs.base import OptimConfig
from ..tree import tree_flatten, tree_leaves, tree_map

__all__ = ["Optimizer", "make_optimizer"]

Pytree = Any
_F32 = torch.float32


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Pytree], Pytree]
    update: Callable[..., tuple[Pytree, Pytree]]
    # update(grads, state, params, scale=1.0) -> (new_params, new_state)


def _step_size(lr: float, scale):
    """``lr * scale`` as the reference rounds it: a float stays a float (one
    rounding where it meets fp32), a tensor is fp32."""
    if isinstance(scale, torch.Tensor):
        return lr * scale.to(_F32)
    return lr * float(scale)


def _count0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


def make_optimizer(cfg: OptimConfig) -> Optimizer:
    sdt = torch.bfloat16 if cfg.state_dtype == "bfloat16" else _F32

    def zeros(params):
        return tree_map(lambda p: torch.zeros_like(p, dtype=sdt), params)

    def descend(p, d, lr):
        return (p.to(_F32) - lr * d).to(p.dtype)

    if cfg.name == "sgd":

        def init(params):
            return {"count": _count0(params)}

        def update(grads, state, params, scale=1.0):
            lr = _step_size(cfg.lr, scale)
            new = tree_map(lambda p, g: descend(p, g.to(_F32), lr), params, grads)
            return new, {"count": state["count"] + 1}

        return Optimizer(init, update)

    if cfg.name == "momentum":

        def init(params):
            return {"count": _count0(params), "m": zeros(params)}

        def update(grads, state, params, scale=1.0):
            lr = _step_size(cfg.lr, scale)
            m = tree_map(lambda m, g: (cfg.momentum * m.to(_F32) + g.to(_F32)).to(sdt),
                         state["m"], grads)
            new = tree_map(lambda p, mm: descend(p, mm.to(_F32), lr), params, m)
            return new, {"count": state["count"] + 1, "m": m}

        return Optimizer(init, update)

    if cfg.name == "adamw":

        def init(params):
            return {"count": _count0(params), "m": zeros(params), "v": zeros(params)}

        def update(grads, state, params, scale=1.0):
            lr = _step_size(cfg.lr, scale)
            c = state["count"] + 1
            b1, b2 = cfg.beta1, cfg.beta2
            bc1 = 1.0 - b1 ** c.to(_F32)
            bc2 = 1.0 - b2 ** c.to(_F32)

            def leaf(p, g, m, v):
                # one leaf at a time, the in-place operations on temporaries
                # only: each leaf's fp32 intermediates are freed before the
                # next leaf's are made (the same values as the reference's
                # out-of-place expressions)
                g32 = g.to(_F32)
                m = (b1 * m.to(_F32)).add_(g32 * (1 - b1)).to(sdt)
                v = (b2 * v.to(_F32)).add_(torch.square(g32).mul_(1 - b2)).to(sdt)
                del g32
                upd = m.to(_F32) / bc1
                upd.div_((v.to(_F32) / bc2).sqrt_().add_(cfg.eps))
                if cfg.weight_decay:
                    upd.add_(cfg.weight_decay * p.to(_F32))
                return (p.to(_F32) - upd.mul_(lr)).to(p.dtype), m, v

            out = [leaf(*x) for x in zip(tree_leaves(params), tree_leaves(grads),
                                         tree_leaves(state["m"]), tree_leaves(state["v"]))]
            new, m, v = ([o[i] for o in out] for i in range(3))
            unflat = tree_flatten(params)[1]
            return unflat(new), {"count": c, "m": unflat(m), "v": unflat(v)}

        return Optimizer(init, update)

    raise ValueError(f"unknown optimizer {cfg.name}")
