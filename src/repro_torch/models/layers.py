"""Transformer building blocks: norms, RoPE, GQA attention, dense FFN.

Pure functions over explicit parameter dicts, as in `repro.models.layers`.
Attention has two data paths: the plain PyTorch reference (`_sdpa`) and,
with ``cfg.use_pallas``, the hand-written flash-attention kernel
(`kernels.ops.flash_attention`, the CUDA counterpart of the TPU kernel).
The reference's activation-sharding hints are the identity here: one card,
no mesh.  Products keep JAX's dtype flow: bf16 x bf16 gives bf16 (fp32
accumulation inside the matmul), and norms and RoPE compute in fp32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..unported import unported
from .module import ParamMeta

__all__ = [
    "rms_norm",
    "layer_norm",
    "make_rope",
    "apply_rope",
    "attention_meta",
    "attention_block",
    "decode_attention_block",
    "ffn_meta",
    "ffn_block",
    "moe_meta",
    "moe_block",
]


def _dt(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class _GradCast(torch.autograd.Function):
    """Identity that casts the cotangent to the primal dtype (bf16 barrier).

    In the reference it keeps tensor-parallel backward all-reduces in bf16;
    here it only fixes the cotangent's dtype, as the reference does."""

    @staticmethod
    def forward(x):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dtype = inputs[0].dtype

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)

    @staticmethod
    def vmap(info, in_dims, x):
        return _GradCast.apply(x), in_dims[0]


def _maybe_grad_cast(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return _GradCast.apply(x) if cfg.force_bf16_grads else x


# --------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------- #
def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def layer_norm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    m = torch.mean(x, dim=-1, keepdim=True)
    v = torch.mean((x - m) ** 2, dim=-1, keepdim=True)
    y = (x - m) * torch.rsqrt(v + eps)
    return (y * scale.float() + bias.float()).to(dt)


# --------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------- #
def make_rope(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (..., S) int -> (cos, sin) of shape (..., S, head_dim//2).

    The frequency table is computed in numpy float32, as the reference does."""
    freqs = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    ang = positions.float()[..., None] * torch.from_numpy(freqs).to(positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D).  cos/sin: (S, D/2) or (B, S, D/2)."""
    dt = x.dtype
    x = x.float()
    x1, x2 = torch.chunk(x, 2, dim=-1)
    if cos.ndim == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


# --------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------- #
def attention_meta(cfg: ModelConfig, stacked: int | None = None) -> dict:
    """ParamMeta tree for one attention block (optionally layer-stacked)."""
    H, K, Dh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    dt = _dt(cfg)

    def P(shape, axes, **kw):
        if stacked is not None:
            shape, axes = (stacked, *shape), ("layers", *axes)
        return ParamMeta(shape, axes, dtype=dt, **kw)

    tree = {
        "wq": P((D, H * Dh), ("embed", "heads_x_dim"), fan_in_axes=(-2,)),
        "wk": P((D, K * Dh), ("embed", "kv_x_dim"), fan_in_axes=(-2,)),
        "wv": P((D, K * Dh), ("embed", "kv_x_dim"), fan_in_axes=(-2,)),
        "wo": P((H * Dh, D), ("heads_x_dim", "embed"), fan_in_axes=(-2,)),
        "pre_norm": P((D,), ("embed",), init="ones"),
    }
    if cfg.qkv_bias:
        tree["bq"] = P((H * Dh,), ("heads_x_dim",), init="zeros")
        tree["bk"] = P((K * Dh,), ("kv_x_dim",), init="zeros")
        tree["bv"] = P((K * Dh,), ("kv_x_dim",), init="zeros")
    return tree


def _sdpa(q, k, v, mask, cfg: ModelConfig):
    """Reference grouped-query attention.

    q: (B, S, H, Dh); k, v: (B, T, K, Dh); mask: (B or 1, 1, S, T) bool.
    Scores are q·k in the input dtype, then fp32 times 1/sqrt(Dh).
    """
    B, S, H, Dh = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    q = q.reshape(B, S, K, G, Dh)
    scale = float(1.0 / np.sqrt(Dh))
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).float() * scale
    scores = torch.where(mask[:, :, None], scores, -1e30)  # mask (B,1,S,T)->(B,1,1,S,T)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(B, S, H, Dh)


def _flash_or_ref(q, k, v, positions, cfg: ModelConfig, causal_offset: int):
    if cfg.use_pallas:
        from ..kernels import ops as kops

        return kops.flash_attention(
            q, k, v, causal=True, window=cfg.sliding_window, q_offset=causal_offset
        )
    # causal (+ sliding window) mask, only the reference path reads it
    pq = positions if positions.ndim == 2 else positions[None, :]
    rel = pq[:, :, None] - pq[:, None, :]          # (B?, S, S) q_pos - k_pos
    mask = rel >= 0
    if cfg.sliding_window:
        mask = mask & (rel < cfg.sliding_window)
    return _sdpa(q, k, v, mask[:, None], cfg)      # (B?, 1, S, S)


def attention_block(params: dict, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence (train / prefill) attention with residual."""
    B, S, D = x.shape
    H, K, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = _maybe_grad_cast(rms_norm(params["pre_norm"], x, cfg.norm_eps), cfg)
    q = h @ params["wq"]
    k = h @ params["wk"]
    v = h @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, S, H, Dh)
    k = k.reshape(B, S, K, Dh)
    v = v.reshape(B, S, K, Dh)
    cos, sin = make_rope(positions, Dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = _flash_or_ref(q, k, v, positions, cfg, 0)
    return x + out.reshape(B, S, H * Dh) @ params["wo"]


def decode_attention_block(*args, **kwargs):
    """Single-token decode against a ring-buffer KV cache — not ported yet."""
    raise unported("decode_attention_block", 11)


# --------------------------------------------------------------------- #
# dense FFN
# --------------------------------------------------------------------- #
def ffn_meta(cfg: ModelConfig, d_ff: int | None = None, stacked: int | None = None) -> dict:
    D = cfg.d_model
    F_ = d_ff if d_ff is not None else cfg.d_ff
    dt = _dt(cfg)

    def P(shape, axes, **kw):
        if stacked is not None:
            shape, axes = (stacked, *shape), ("layers", *axes)
        return ParamMeta(shape, axes, dtype=dt, **kw)

    tree = {
        "w_up": P((D, F_), ("embed", "mlp"), fan_in_axes=(-2,)),
        "w_down": P((F_, D), ("mlp", "embed"), fan_in_axes=(-2,)),
        "pre_norm": P((D,), ("embed",), init="ones"),
    }
    if cfg.ffn_gated:
        tree["w_gate"] = P((D, F_), ("embed", "mlp"), fan_in_axes=(-2,))
    return tree


def ffn_block(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = _maybe_grad_cast(rms_norm(params["pre_norm"], x, cfg.norm_eps), cfg)
    u = h @ params["w_up"]
    if cfg.ffn_gated:
        a = F.silu(h @ params["w_gate"]) * u
    else:
        a = F.gelu(u, approximate="tanh")  # jax.nn.gelu is the tanh form by default
    return x + a @ params["w_down"]


# --------------------------------------------------------------------- #
# MoE FFN
# --------------------------------------------------------------------- #
def moe_meta(*args, **kwargs):
    """Routed-expert FFN parameters — not ported yet."""
    raise unported("moe_meta", "7c")


def moe_block(*args, **kwargs):
    """Routed-expert FFN (K5 `moe_gmm`) — not ported yet."""
    raise unported("moe_block", "7c")
