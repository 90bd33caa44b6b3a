"""Rematerialisation: the reference's ``jax.checkpoint`` under `torch.func`.

``remat(fn, policy)`` is the counterpart of the reference's three
``_remat``s (`repro.models.transformer`, `mamba2`, `hybrid`):

* ``"none"`` returns ``fn``: autograd keeps every activation of the block
  until the backward pass.
* ``"full"`` (``jax.checkpoint``) keeps only the block's inputs.  The
  forward runs the block without a graph; the backward runs it again under
  `torch.func.vjp` over its floating inputs and applies the cotangents.
* ``"dots"`` (``checkpoint_dots_with_no_batch_dims``) also keeps the
  outputs of the block's products by a 2-D weight, the ones that go
  through `dot`; the recompute takes them as recorded and recomputes the
  rest.  Under a `vmap` over per-row weights the reference's policy sees
  batched dots and keeps none of them; the port keeps them there too.

`torch.utils.checkpoint` does not compose with `torch.func.grad` (saved
tensor hooks), so the wrapper is a `torch.autograd.Function` with a
generated `vmap` rule: it runs under `grad`, `vmap(grad)` (the blocked
engine and the matrix's fold) and an eager ``.backward()`` alike.  Every
tensor the block reads enters the Function as an input (the parameters,
the activations, integer tensors such as ``positions``); non-tensor
arguments such as ``cfg`` stay in ``fn``'s closure.  The recompute runs the
same operations on the same inputs, so losses and gradients are bitwise
those of ``"none"``; under a sharding rule context (DTensor parameters)
the recompute's vjp is eager autograd (`_eager_vjp`); the kernels' forwards (K3, K4, K5) run twice a
gradient, as the reference's remat runs its Pallas kernels twice.  The
backward returns its cotangents detached, so a block's recompute is freed
before the next block's (`torch.func.grad` backpropagates with
``create_graph=True``); a second derivative through a rematerialised block
is not supported.
"""
from __future__ import annotations

import threading

import torch

from ..launch.shardings import activate_rules, active
from ..tree import tree_flatten

__all__ = ["POLICIES", "remat", "dot"]

POLICIES = ("none", "dots", "full")

_state = threading.local()


def _tape():
    return getattr(_state, "tape", None)


class _Tape:
    """The products a "dots" block records in its forward (``replay`` is
    False) and hands back, in the same order, to its recompute."""

    def __init__(self, recorded=None):
        self.replay = recorded is not None
        self.outs = [] if recorded is None else list(recorded)
        self.i = 0

    def __enter__(self):
        self.prev = _tape()
        _state.tape = self
        return self

    def __exit__(self, *exc):
        _state.tape = self.prev


def _mm_backward(g: torch.Tensor, h: torch.Tensor, w: torch.Tensor):
    """``(dL/dh, dL/dw)`` of ``h @ w`` for a 2-D ``w`` as autograd's
    ``matmul`` computes them for the row-major operands the blocks pass:
    the leading dimensions folded, one ``mm`` each, so the sums run in the
    same order."""
    hf = h.reshape(-1, h.shape[-1])
    gf = g.reshape(-1, g.shape[-1])
    return gf.mm(w.t()).reshape(h.shape), hf.t().mm(gf)


class _Recorded(torch.autograd.Function):
    """``h @ w`` given as its recorded value ``out``; the backward is the
    product's."""

    generate_vmap_rule = True

    @staticmethod
    def forward(h, w, out):
        return out.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        h, w, _ = inputs
        ctx.save_for_backward(h, w)

    @staticmethod
    def backward(ctx, g):
        return (*_mm_backward(g, *ctx.saved_tensors), None)


def dot(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w`` for a 2-D weight ``w``: the products a "dots" block keeps."""
    tape = _tape()
    if tape is None:
        return h @ w
    if tape.replay:
        out = tape.outs[tape.i]
        tape.i += 1
        return _Recorded.apply(h, w, out)
    out = h @ w
    tape.outs.append(out)
    return out


class _Spec:
    """What the Function needs beside its tensors: the block, its argument
    tree and policy, (set by the forward) its output tree, and the rule
    context the forward ran under (`launch.shardings.active`), which the
    recompute re-enters: a CUDA backward runs on autograd's device thread,
    where the forward's context variables are not set."""

    def __init__(self, fn, unflatten, n_in: int, dots: bool):
        self.fn, self.unflatten, self.n_in, self.dots = fn, unflatten, n_in, dots
        self.n_out = None
        self.out_unflatten = None
        self.rules = active()

    def run(self, leaves):
        out, self.out_unflatten = tree_flatten(self.fn(*self.unflatten(list(leaves))))
        self.n_out = len(out)
        return out


class _Remat(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(spec: _Spec, *leaves):
        if not spec.dots:
            return tuple(spec.run(leaves))
        with _Tape() as tape:
            out = spec.run(leaves)
        return (*out, *tape.outs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        spec = inputs[0]
        ctx.spec = spec
        recorded = output[spec.n_out:]
        if recorded:
            ctx.mark_non_differentiable(*recorded)
        ctx.save_for_backward(*inputs[1:], *recorded)

    @staticmethod
    def backward(ctx, *grads):
        spec = ctx.spec
        saved = ctx.saved_tensors
        leaves, recorded = list(saved[: spec.n_in]), saved[spec.n_in:]
        fl = [i for i, t in enumerate(leaves) if t.is_floating_point()]

        def block(*xs):
            args = list(leaves)
            for i, x in zip(fl, xs):
                args[i] = x
            if not spec.dots:
                return tuple(spec.run(args))
            with _Tape(recorded):
                return tuple(spec.run(args))

        if spec.rules is None:
            _, vjp_fn = torch.func.vjp(block, *[leaves[i] for i in fl])
            gin = vjp_fn(tuple(grads[: spec.n_out]))
        else:
            gin = _eager_vjp(block, [leaves[i] for i in fl], grads[: spec.n_out], spec.rules)
        # detached: under ``create_graph=True`` the cotangents would carry
        # the recompute's graph, and with it every block's activations, to
        # the end of the backward.  Grad mode stays as the caller set it
        # (not `torch.no_grad`): backward formulas such as silu's pick their
        # rounding by it
        out = [None] * len(leaves)
        for i, g in zip(fl, gin):
            out[i] = g.detach()
        return (None, *out)


def _eager_vjp(block, xs: list, grads, rules) -> list:
    """The cotangents of ``block``'s floating inputs by eager autograd,
    under the forward's rule context: inside `torch.func.vjp` a DTensor is
    wrapped, and its placements and ``redistribute`` are out of reach."""
    xs = [x.detach().requires_grad_() for x in xs]
    with torch.enable_grad(), activate_rules(*rules):
        outs = block(*xs)
        pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
        gin = torch.autograd.grad([o for o, _ in pairs], xs, [g for _, g in pairs],
                                  allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for x, g in zip(xs, gin)]


def remat(fn, policy: str):
    """``fn`` rematerialised by ``policy`` ("none", "dots" or "full")."""
    if policy not in POLICIES:
        raise ValueError(f"unknown remat {policy!r}")
    if policy == "none":
        return fn

    def wrapped(*args):
        leaves, unflatten = tree_flatten(args)
        spec = _Spec(fn, unflatten, len(leaves), policy == "dots")
        out = _Remat.apply(spec, *leaves)
        return spec.out_unflatten(list(out[: spec.n_out]))

    return wrapped
