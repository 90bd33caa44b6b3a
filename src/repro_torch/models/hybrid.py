"""Zamba2-style hybrid: Mamba2 backbone + one *shared* attention+MLP block
applied every `cfg.attn_every` layers (arXiv:2411.15242).

`repro.models.hybrid`'s parameter tree and full-sequence `forward`.  The
shared block has a single parameter set reused at each of the
``num_layers // attn_every`` sites (Zamba2's weight-shared global block),
so its gradient sums over the sites; the backbone runs in segments of
``attn_every`` Mamba2 layers, plus the trailing layers.  Decode (per-layer
SSM / conv states plus one KV cache per site) belongs to the serving plane
and is not ported yet.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..unported import unported
from . import layers as L
from . import mamba2 as M
from .module import ParamMeta
from .transformer import _dt, _remat, _unstack

__all__ = ["model_meta", "forward", "init_cache", "decode_step", "num_shared_sites"]


def num_shared_sites(cfg: ModelConfig) -> int:
    return cfg.num_layers // cfg.attn_every


def model_meta(cfg: ModelConfig) -> dict:
    D, V, nL = cfg.d_model, cfg.vocab_size, cfg.num_layers
    dt = _dt(cfg)
    tree: dict[str, Any] = {
        "embed": ParamMeta((V, D), ("vocab", "embed"), dtype=dt, init="embed"),
        "blocks": M.mamba_block_meta(cfg, stacked=nL),
        "shared": {
            "attn": L.attention_meta(cfg),
            "ffn": L.ffn_meta(cfg),
        },
        "final_norm": ParamMeta((D,), ("embed",), dtype=dt, init="ones"),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = ParamMeta((D, V), ("embed", "vocab"), dtype=dt, fan_in_axes=(0,))
    return tree


def _seg_slice(layers: list[dict], lo: int, hi: int) -> list[dict]:
    """Backbone layers ``lo .. hi-1``.  The reference slices every stacked
    leaf (``p[lo:hi]``); the port unbinds each stacked leaf once
    (`transformer._unstack`) and slices that list, so the backward writes
    each stacked gradient once rather than a full-size zero tensor per
    segment."""
    return layers[lo:hi]


def forward(params: dict, batch: dict, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits (B,S,V), 0)."""
    x = F.embedding(batch["tokens"], params["embed"])
    B, S, D = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :].expand(B, S)
    ae = cfg.attn_every
    n_seg = num_shared_sites(cfg)
    layers = _unstack(params["blocks"], cfg.num_layers)
    mamba_body = _remat(lambda params_l, x: M.mamba_block(params_l, x, cfg)[0], cfg)

    for seg in range(n_seg):
        # shared attention + MLP block at the segment head (weight-shared)
        x = L.attention_block(params["shared"]["attn"], x, cfg, positions)
        x = L.ffn_block(params["shared"]["ffn"], x, cfg)
        for params_l in _seg_slice(layers, seg * ae, (seg + 1) * ae):
            x = mamba_body(params_l, x)
    # trailing backbone layers if L % attn_every != 0
    for params_l in _seg_slice(layers, n_seg * ae, cfg.num_layers):
        x = mamba_body(params_l, x)

    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head, torch.zeros((), dtype=torch.float32, device=x.device)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """SSM / conv states plus per-site KV caches — not ported yet."""
    raise unported("hybrid.init_cache", 11)


def decode_step(params: dict, cache: dict, batch: dict, cfg: ModelConfig):
    """One-token decode of the hybrid — not ported yet."""
    raise unported("hybrid.decode_step", 11)
