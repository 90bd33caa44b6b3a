"""Unified model API (`repro.models.api`): every family behind the same calls.

    meta      = model_meta(cfg)                      # ParamMeta tree
    logits, _ = forward(params, batch, cfg)          # train / prefill
    loss, aux = loss_fn(params, batch, cfg)
    params, opt, metrics = train_step(params, opt_state, batch, cfg, opt,
                                      sampling_weight)   # Alg. 1 line 10 weight

    cache     = init_cache(cfg, batch, seq_len)      # cache spec (CacheSpec leaves)
    logits, c = decode_step(params, cache, batch, cfg)
    out, c    = serve_step(params, cache, batch, cfg)  # + greedy next ids

The dense, MoE, VLM and audio families (the transformer), the SSM family
(`mamba2`) and the hybrid (`hybrid`) all run.  ``sampling_weight`` is the
Generalized-AsyncSGD importance factor 1/(n p_j) (1.0 recovers plain
synchronous SGD).  With ``cfg.use_pallas`` the forward runs the hand-written
kernels (K3, K4, K5 through `kernels.ops`); their backwards are the plain
reference's VJPs.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..launch.shardings import active
from ..optim import Optimizer
from ..tree import tree_flatten, tree_leaves
from . import hybrid, mamba2, transformer
from .layers import _shard

__all__ = [
    "family_module",
    "model_meta",
    "forward",
    "init_cache",
    "cache_logical_axes",
    "decode_step",
    "loss_fn",
    "train_step",
    "serve_step",
]


def family_module(cfg: ModelConfig):
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        return transformer
    if cfg.family == "ssm":
        return mamba2
    if cfg.family == "hybrid":
        return hybrid
    raise ValueError(f"unknown family {cfg.family}")


def model_meta(cfg: ModelConfig) -> dict:
    return family_module(cfg).model_meta(cfg)


def forward(params, batch, cfg: ModelConfig):
    return family_module(cfg).forward(params, batch, cfg)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    return family_module(cfg).init_cache(cfg, batch, seq_len)


def cache_logical_axes(cfg: ModelConfig) -> dict:
    return family_module(cfg).cache_logical_axes(cfg)


def decode_step(params, cache, batch, cfg: ModelConfig):
    return family_module(cfg).decode_step(params, cache, batch, cfg)


# ------------------------------------------------------------------ #
# loss & steps
# ------------------------------------------------------------------ #
def loss_fn(params, batch, cfg: ModelConfig):
    """Next-token cross entropy (fp32), masked, + MoE aux loss."""
    logits, aux = forward(params, batch, cfg)
    labels = batch["labels"]                       # (B, S_lab)
    S_lab = labels.shape[1]
    if cfg.frontend == "vision_stub":
        # text logits start after the patch prefix; position P-1+i predicts
        # text token i (the last patch slot predicts the first text token).
        start = cfg.num_patches - 1
        logits = logits[:, start : start + S_lab]
    else:
        logits = logits[:, :S_lab]
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    mask = batch.get("loss_mask")
    if mask is None:
        loss = torch.mean(nll)
    else:
        loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    if cfg.family == "moe":
        loss = loss + cfg.router_aux_coef * aux
    return loss, aux


def _grad_and_value(params, batch, cfg: ModelConfig):
    """``(grads, (loss, aux))`` of `loss_fn`: `torch.func.grad_and_value`,
    or eager autograd under a rule context (`launch.shardings.
    activate_rules`): inside a `torch.func` transform a DTensor is wrapped,
    and its placements, ``redistribute`` and ``local_map`` are out of
    reach.  Both differentiate the same operations."""
    if active() is None:
        return torch.func.grad_and_value(loss_fn, has_aux=True)(params, batch, cfg)
    leaves, unflatten = tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    loss, aux = loss_fn(unflatten(leaves), batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    return unflatten(list(grads)), (loss.detach(), aux.detach())


def train_step(params, opt_state, batch, cfg: ModelConfig, opt: Optimizer,
               sampling_weight: torch.Tensor | float = 1.0):
    """One Generalized-AsyncSGD server step: the gradient of `loss_fn`, then
    ``opt.update`` scaled by ``sampling_weight`` = 1/(n p_j) for the
    contributing client j (Alg. 1), which keeps the estimator unbiased.

    Under a rule context the parameters are DTensors and so are the
    results (`launch.shardings`).  Returns ``(new_params, new_opt_state,
    {"loss", "moe_aux", "grad_norm"})``; ``grad_norm`` is the fp32 square root of the sum of the
    leaves' squared sums, in leaf order.
    """
    grads, (loss, aux) = _grad_and_value(params, batch, cfg)
    new_params, new_opt = opt.update(grads, opt_state, params, scale=sampling_weight)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))
    metrics = {"loss": loss, "moe_aux": aux, "grad_norm": gnorm}
    return new_params, new_opt, metrics


def serve_step(params, cache, batch, cfg: ModelConfig):
    """One batched decode step; greedy next-token ids alongside raw logits."""
    logits, new_cache = decode_step(params, cache, batch, cfg)
    # replicated, as the reference's out_shardings give them (the identity
    # outside a rule context)
    logits = _shard(logits, (None, None))
    next_ids = torch.argmax(logits, dim=-1).to(torch.int32)
    return {"logits": logits, "next_ids": next_ids}, new_cache
