"""Decoder-only transformer family (dense, MoE, VLM backbone, audio backbone).

`repro.models.transformer`'s parameter tree and full-sequence `forward`
(train / prefill).  Layers are stacked along a leading 'layers' axis; the
forward unbinds each stacked leaf once and runs a Python loop over the
layers (`jax.lax.scan` in the reference), whichever ``cfg.scan_layers``
says.  The MoE aux loss is summed as the reference sums it: with
``scan_layers`` the per-layer sum over num_layers, else each layer's
share added in turn.  Decode is not ported yet; the SSM and hybrid
families live in `mamba2` and `hybrid`, which reuse this module's `_dt`,
`_unstack` and `_remat`.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..tree import tree_flatten
from ..unported import unported
from . import layers as L
from .module import ParamMeta

__all__ = ["model_meta", "forward", "init_cache", "decode_step"]


def _dt(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def model_meta(cfg: ModelConfig) -> dict:
    D, V, nL = cfg.d_model, cfg.vocab_size, cfg.num_layers
    dt = _dt(cfg)
    tree: dict[str, Any] = {}
    if cfg.frontend != "audio_stub":
        tree["embed"] = ParamMeta((V, D), ("vocab", "embed"), dtype=dt, init="embed")
    block = {"attn": L.attention_meta(cfg, stacked=nL)}
    if cfg.family in ("moe",):
        block["moe"] = L.moe_meta(cfg, stacked=nL)
    else:
        block["ffn"] = L.ffn_meta(cfg, stacked=nL)
    tree["blocks"] = block
    tree["final_norm"] = ParamMeta((D,), ("embed",), dtype=dt, init="ones")
    if not cfg.tie_embeddings:
        tree["lm_head"] = ParamMeta((D, V), ("embed", "vocab"), dtype=dt, fan_in_axes=(0,))
    return tree


def _remat(fn, cfg: ModelConfig):
    """The reference's rematerialisation policy; the port recomputes nothing.

    `torch.utils.checkpoint` does not compose with `torch.func.grad` /
    `vmap`, which the engine differentiates through, and remat changes
    memory, not numbers: every ``cfg.remat`` runs the block as it is.
    `chip_smoke.py` prints the card's peak memory to show the full-width
    slice fits without it."""
    if cfg.remat not in ("none", "dots", "full"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    return fn


def _block_apply(cfg: ModelConfig, params_l: dict, x: torch.Tensor, positions: torch.Tensor):
    x = L.attention_block(params_l["attn"], x, cfg, positions)
    if "moe" in params_l:
        x, aux = L.moe_block(params_l["moe"], x, cfg)
    else:
        x = L.ffn_block(params_l["ffn"], x, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def _embed_inputs(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Token / stub-frontend embedding.  Returns (B, S_total, D)."""
    if cfg.frontend == "audio_stub":
        # EnCodec frame embeddings arrive precomputed (spec carve-out).
        return batch["embeds"].to(_dt(cfg))
    x = F.embedding(batch["tokens"], params["embed"])  # (B, S_text, D) gather
    if cfg.frontend == "vision_stub":
        patches = batch["patch_embeds"].to(x.dtype)  # (B, P, D)
        x = torch.cat([patches, x], dim=1)
    return x


def _unstack(blocks: dict, n: int) -> list[dict]:
    """The layer-stacked ``blocks`` tree as ``n`` per-layer trees: one
    `unbind` per leaf, whose backward writes each stacked gradient once."""
    leaves, unflatten = tree_flatten(blocks)
    per_leaf = [torch.unbind(leaf, 0) for leaf in leaves]
    return [unflatten([u[i] for u in per_leaf]) for i in range(n)]


def forward(params: dict, batch: dict, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits (B,S,V), moe_aux_loss)."""
    x = _embed_inputs(params, batch, cfg)
    B, S, D = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :].expand(B, S)
    blk = _remat(_block_apply, cfg)
    nL = cfg.num_layers
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for params_l in _unstack(params["blocks"], nL):
        x, a = blk(cfg, params_l, x, positions)
        aux = aux + a if cfg.scan_layers else aux + a / nL
    if cfg.scan_layers:
        aux = aux / nL
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head, aux


# ------------------------------------------------------------------ #
# decode
# ------------------------------------------------------------------ #
def init_cache(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """Ring-buffer KV cache spec — not ported yet."""
    raise unported("transformer.init_cache", 11)


def decode_step(params: dict, cache: dict, batch: dict, cfg: ModelConfig):
    """One-token decode against the KV cache — not ported yet."""
    raise unported("transformer.decode_step", 11)
