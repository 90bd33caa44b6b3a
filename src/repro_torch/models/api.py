"""Unified model API (`repro.models.api`): every family behind the same calls.

    meta      = model_meta(cfg)                      # ParamMeta tree
    logits, _ = forward(params, batch, cfg)          # train / prefill
    loss, aux = loss_fn(params, batch, cfg)

The dense, MoE, VLM and audio families (the transformer), the SSM family
(`mamba2`) and the hybrid (`hybrid`) are ported; the optimizer-driven
`train_step` and decode / serving raise `NotImplementedError` naming their
ROADMAP item.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..unported import unported
from . import hybrid, mamba2, transformer

__all__ = [
    "family_module",
    "model_meta",
    "forward",
    "init_cache",
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


def train_step(*args, **kwargs):
    """One optimizer step (`repro.optim`) — not ported yet."""
    raise unported("api.train_step (optim/)", "7d")


def serve_step(*args, **kwargs):
    """One batched decode step — not ported yet."""
    raise unported("api.serve_step", 11)
