"""Zamba2-style hybrid: Mamba2 backbone + one *shared* attention+MLP block
applied every `cfg.attn_every` layers (arXiv:2411.15242).

`repro.models.hybrid`'s parameter tree and full-sequence `forward`.  The
shared block has a single parameter set reused at each of the
``num_layers // attn_every`` sites (Zamba2's weight-shared global block),
so its gradient sums over the sites; the backbone runs in segments of
``attn_every`` Mamba2 layers, plus the trailing layers.  Decode carries
per-layer SSM / conv states plus one KV cache per shared-block site.
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ModelConfig
from . import layers as L
from . import mamba2 as M
from .module import CacheSpec, ParamMeta
from .remat import remat
from .transformer import _dt, _unstack, cache_len_for

__all__ = ["model_meta", "forward", "init_cache", "cache_logical_axes", "decode_step",
           "num_shared_sites"]


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
    params = L._gather(params)
    x = L.embed_lookup(params["embed"], batch["tokens"])
    B, S, D = x.shape
    x = L._shard(x, ("batch", "seq", "embed"))
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :].expand(B, S)
    ae = cfg.attn_every
    n_seg = num_shared_sites(cfg)
    layers = _unstack(params["blocks"], cfg.num_layers)
    # the reference checkpoints the Mamba2 body whole under "dots" and
    # "full" alike, and leaves the shared block alone
    mamba_body = remat(lambda params_l, x: M.mamba_block(params_l, x, cfg)[0],
                       "full" if cfg.remat == "dots" else cfg.remat)

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
    """The decode cache spec (`CacheSpec` leaves): the backbone's per-layer
    SSM / conv states, one ring-buffer KV cache per shared-block site, the
    positions the ring slots hold and the next position."""
    d_inner = cfg.d_inner
    H, N = cfg.ssm_heads, cfg.ssm_state
    conv_ch = d_inner + 2 * cfg.ssm_groups * N
    nL, nseg = cfg.num_layers, num_shared_sites(cfg)
    W = cache_len_for(cfg, seq_len)
    K, Dh = cfg.num_kv_heads, cfg.head_dim
    dt = _dt(cfg)
    return {
        "ssm": CacheSpec((nL, batch, H, N, cfg.ssm_head_dim), torch.float32),
        "conv": CacheSpec((nL, batch, cfg.ssm_conv - 1, conv_ch), dt),
        "k": CacheSpec((nseg, batch, W, K, Dh), dt),
        "v": CacheSpec((nseg, batch, W, K, Dh), dt),
        "positions": CacheSpec((W,), torch.int32),
        "pos": CacheSpec((), torch.int32),
    }


def cache_logical_axes(cfg: ModelConfig) -> dict:
    return {
        "ssm": ("layers", "batch", "heads", "state", None),
        "conv": ("layers", "batch", None, "mlp"),
        "k": ("layers", "batch", "cache_seq", "cache_kv_heads", "cache_head_dim"),
        "v": ("layers", "batch", "cache_seq", "cache_kv_heads", "cache_head_dim"),
        "positions": (None,),
        "pos": (),
    }


def decode_step(params: dict, cache: dict, batch: dict, cfg: ModelConfig):
    """One-token decode.  Each site attends from the cache's positions as
    they were before the step (every site writes the same ring slot), as
    the reference does.  Returns (logits (B, V), new_cache)."""
    params = L._gather(params)
    x = L.embed_lookup(params["embed"], batch["tokens"])
    pos = cache["pos"]
    ae = cfg.attn_every
    n_seg = num_shared_sites(cfg)
    layers = _unstack(params["blocks"], cfg.num_layers)
    new_ssm, new_conv, new_k, new_v = [], [], [], []
    positions = cache["positions"]

    def mamba_seg(x, lo, hi):
        x, ssm, conv = M._decode_layers(_seg_slice(layers, lo, hi), x, cfg,
                                        cache["ssm"][lo:hi], cache["conv"][lo:hi])
        new_ssm.extend(ssm)
        new_conv.extend(conv)
        return x

    for seg in range(n_seg):
        x, (kc, vc), positions = L.decode_attention_block(
            params["shared"]["attn"], x, cfg, (cache["k"][seg], cache["v"][seg]),
            cache["positions"], pos)
        x = L.ffn_block(params["shared"]["ffn"], x, cfg)
        new_k.append(kc)
        new_v.append(vc)
        x = mamba_seg(x, seg * ae, (seg + 1) * ae)
    if cfg.num_layers % ae:
        x = mamba_seg(x, n_seg * ae, cfg.num_layers)

    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head)[:, 0]
    new_cache = {
        "ssm": torch.stack(new_ssm),
        "conv": torch.stack(new_conv),
        "k": torch.stack(new_k),
        "v": torch.stack(new_v),
        "positions": positions,
        "pos": pos + 1,
    }
    return logits, new_cache
