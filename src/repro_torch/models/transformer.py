"""Decoder-only transformer family (dense, MoE, VLM backbone, audio backbone).

`repro.models.transformer`'s parameter tree and full-sequence `forward`
(train / prefill).  Layers are stacked along a leading 'layers' axis; the
forward unbinds each stacked leaf once and runs a Python loop over the
layers (`jax.lax.scan` in the reference), whichever ``cfg.scan_layers``
says.  The MoE aux loss is summed as the reference sums it: with
``scan_layers`` the per-layer sum over num_layers, else each layer's
share added in turn.  `init_cache` / `decode_step` serve one token at a
time against a ring-buffer KV cache.  Under a rule context
(`launch.shardings.activate_rules`) the forward and decode gather the
weights' FSDP shards first (`layers._gather`) and take the reference's
activation hints (`layers._shard`).  The SSM and hybrid families live in
`mamba2` and `hybrid`, which reuse this module's `_dt`, `_unstack`,
`_remat` and `cache_len_for`.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..tree import tree_flatten
from . import layers as L
from .module import CacheSpec, ParamMeta
from .remat import remat

__all__ = ["model_meta", "forward", "init_cache", "cache_logical_axes", "decode_step"]


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
    """The block rematerialised by ``cfg.remat`` (`remat.remat`): "none"
    keeps its activations, "full" only its inputs, "dots" its inputs and
    its products by a 2-D weight.  Every tensor the block reads is one of
    ``fn``'s arguments; ``cfg`` stays in its closure."""
    return remat(fn, cfg.remat)


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
    x = L.embed_lookup(params["embed"], batch["tokens"])  # (B, S_text, D) gather
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
    params = L._gather(params)
    x = _embed_inputs(params, batch, cfg)
    B, S, D = x.shape
    x = L._shard(x, ("batch", "seq", "embed"))
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :].expand(B, S)
    blk = _remat(functools.partial(_block_apply, cfg), cfg)
    nL = cfg.num_layers
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for params_l in _unstack(params["blocks"], nL):
        x, a = blk(params_l, x, positions)
        aux = aux + a if cfg.scan_layers else aux + a / nL
    if cfg.scan_layers:
        aux = aux / nL
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = L._shard(x @ head, ("batch", "seq", "vocab"))
    return logits, aux


# ------------------------------------------------------------------ #
# decode
# ------------------------------------------------------------------ #
def cache_len_for(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.sliding_window:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """The cache spec (`CacheSpec` leaves): per layer a ring-buffer KV cache
    of ``cache_len_for`` slots, the positions each slot holds (shared by the
    layers) and the next position."""
    W = cache_len_for(cfg, seq_len)
    nL, K, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    dt = _dt(cfg)
    return {
        "k": CacheSpec((nL, batch, W, K, Dh), dt),
        "v": CacheSpec((nL, batch, W, K, Dh), dt),
        "positions": CacheSpec((W,), torch.int32),
        "pos": CacheSpec((), torch.int32),
    }


def cache_logical_axes(cfg: ModelConfig) -> dict:
    return {
        "k": ("layers", "batch", "cache_seq", "cache_kv_heads", "cache_head_dim"),
        "v": ("layers", "batch", "cache_seq", "cache_kv_heads", "cache_head_dim"),
        "positions": (None,),
        "pos": (),
    }


def decode_step(params: dict, cache: dict, batch: dict, cfg: ModelConfig
                ) -> tuple[torch.Tensor, dict]:
    """One-token decode.  batch: {"tokens": (B,1)} or {"embeds": (B,1,D)}.

    Returns (logits (B, V), new_cache).  The layers run in a Python loop
    (the reference's ``lax.scan``), one positions vector carried through
    them; an MoE layer runs `layers.moe_block` on the B tokens (K5 under
    ``cfg.use_pallas`` and the sort dispatch)."""
    params = L._gather(params)
    if cfg.frontend == "audio_stub":
        x = batch["embeds"].to(_dt(cfg))
    else:
        x = L.embed_lookup(params["embed"], batch["tokens"])
    x = L._shard(x, ("batch", None, "embed"))
    pos = cache["pos"]
    positions = cache["positions"]
    ks, vs = [], []
    layers = _unstack(params["blocks"], cfg.num_layers)
    for params_l, ck, cv in zip(layers, cache["k"], cache["v"]):
        x, (ck, cv), positions = L.decode_attention_block(
            params_l["attn"], x, cfg, (ck, cv), positions, pos)
        if "moe" in params_l:
            x, _ = L.moe_block(params_l["moe"], x, cfg)
        else:
            x = L.ffn_block(params_l["ffn"], x, cfg)
        ks.append(ck)
        vs.append(cv)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head)[:, 0]
    new_cache = {"k": torch.stack(ks), "v": torch.stack(vs), "positions": positions,
                 "pos": pos + 1}
    return logits, new_cache
