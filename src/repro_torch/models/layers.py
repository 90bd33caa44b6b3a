"""Transformer building blocks: norms, RoPE, GQA attention, dense and MoE FFN.

Pure functions over explicit parameter dicts, as in `repro.models.layers`.
Attention has two data paths: the plain PyTorch reference (`_sdpa`) and,
with ``cfg.use_pallas``, the hand-written flash-attention kernel
(`kernels.ops.flash_attention`, the CUDA counterpart of the TPU kernel);
likewise the MoE FFN's expert products under the sort dispatch
(`kernels.ops.moe_gmm`).  The activation-sharding hints (`_shard`, at the
reference's places) are the identity outside a rule context
(`launch.shardings.activate_rules`); under one, on DTensors, they
redistribute to the rules' placements, the attention runs on each rank's
local batch rows and heads (`_local_attention`, K3 there under
``cfg.use_pallas``) and the vocab-sharded embedding looks up each rank's
rows (`embed_lookup`).  Products keep JAX's dtype flow:
bf16 x bf16 gives bf16 (fp32 accumulation inside the matmul), and norms,
RoPE and the MoE router compute in fp32.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..launch import shardings as SH
from ..launch.shardings import _is_dtensor, logical_to_pspec, placements, shard_index
from .module import ParamMeta
from .remat import dot

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
    "embed_lookup",
]


# the hints and the rule context (`launch.shardings`), each the identity
# without a context
_shard = SH.shard_activation          # redistribute to the rules' placements
_sharded = SH.active                  # ``(rules, mesh)`` of the context, else None
_gather = SH.gather_weights           # the weights with their FSDP shards gathered
_keep_grad = SH.keep_grad_placements  # the gradient back at the value's placements


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
    ctx = _sharded()
    if ctx is not None and _is_dtensor(q):
        return _local_attention(q, k, v, positions, cfg, causal_offset, *ctx)
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


def _heads(t: torch.Tensor, B: int, S: int, n: int, Dh: int, name: str) -> torch.Tensor:
    """(B, S, n * Dh) -> (B, S, n, Dh).  Under a rule context the flat
    dimension is first split as its ``n`` heads are (`_shard` with
    ``shape=(B, S, n)``): DTensor reshapes a sharded dimension only where
    the heads divide its mesh axes (GSPMD pads)."""
    t = _shard(t, ("batch", "seq", name), shape=(B, S, n))
    return t.reshape(B, S, n, Dh)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the cotangent contiguous.  A local
    gradient leaves `local_map` as a DTensor whose global strides are the
    contiguous ones; an attention backward's permuted local layout would
    then fail the next ``view``."""

    @staticmethod
    def forward(x):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _local_attention(q, k, v, positions, cfg: ModelConfig, causal_offset: int, rules, mesh):
    """`_flash_or_ref` on each rank's batch rows and heads
    (`torch.distributed.tensor.experimental.local_map`): K3 under
    ``cfg.use_pallas`` (a DTensor cannot enter a kernel called through
    ``ctypes``), else the plain attention.

    The q heads are sharded as the rules shard them.  The kv heads are
    sharded alike where they split alike (the local GQA groups are the
    global ones); where they do not divide the mesh axes (Yi-6B's 4 kv
    heads on a model axis of 16) each rank takes them whole and attends
    with the ones its q heads read, so their gradient is a partial sum over
    those axes; where neither fits, the heads are replicated."""
    from torch.distributed.tensor import Partial, Shard

    B, S, H, Dh = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    sq = logical_to_pspec(("batch", "seq", "heads", None), rules, (B, S, H, Dh), mesh)
    sk = logical_to_pspec(("batch", "seq", "kv_heads", None), rules, (B, T, K, Dh), mesh)
    sliced = None  # the mesh dims the q heads split while the kv heads stay whole
    if sq[2] != sk[2]:
        sk = sk[:2] + (None, None)
        dims = [i for i, p in enumerate(placements(sq, mesh)) if p == Shard(2)]
        Hl = H // math.prod(mesh.size(i) for i in dims)
        if dims and (G % Hl == 0 or Hl % G == 0):
            sliced = dims
        else:
            sq = sq[:2] + (None, None)
    pq, pk = placements(sq, mesh), placements(sk, mesh)
    gk = pk if sliced is None else tuple(Partial() if i in sliced else p
                                         for i, p in enumerate(pk))
    pos = positions if positions.ndim == 2 else positions[None, :].expand(B, S)
    ppos = placements(sq[:2], mesh)
    k0 = nk = 0
    if sliced is not None:
        k0 = shard_index(mesh, sliced) * Hl // G
        nk = max(1, Hl // G)

    def local(q, k, v, pos):
        q, k, v = _ContiguousGrad.apply(q), _ContiguousGrad.apply(k), _ContiguousGrad.apply(v)
        if nk:
            k, v = k[:, :, k0:k0 + nk], v[:, :, k0:k0 + nk]
        return _flash_or_ref(q, k, v, pos, cfg, causal_offset)

    return SH.local(local, (pq, pk, pk, ppos), (pq,), (pq, gk, gk, ppos))(q, k, v, pos)


def attention_block(params: dict, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence (train / prefill) attention with residual."""
    B, S, D = x.shape
    H, K, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = _maybe_grad_cast(rms_norm(params["pre_norm"], x, cfg.norm_eps), cfg)
    q = dot(h, params["wq"])
    k = dot(h, params["wk"])
    v = dot(h, params["wv"])
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = _heads(q, B, S, H, Dh, "heads")
    k = _heads(k, B, S, K, Dh, "kv_heads")
    v = _heads(v, B, S, K, Dh, "kv_heads")
    q = _shard(q, ("batch", "seq", "heads", None))
    k = _shard(k, ("batch", "seq", "kv_heads", None))
    cos, sin = make_rope(positions, Dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = _flash_or_ref(q, k, v, positions, cfg, 0)
    out = dot(_keep_grad(out.reshape(B, S, H * Dh)), params["wo"])
    out = _shard(out, ("batch", "seq", "embed"))
    return x + out


def decode_attention_block(
    params: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    kv_cache: tuple[torch.Tensor, torch.Tensor],
    cache_positions: torch.Tensor,
    pos: torch.Tensor,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Single-token decode against a ring-buffer KV cache.

    x: (B, 1, D).  kv_cache: (k, v) each (B, W, K, Dh) holding RoPE'd keys.
    cache_positions: (W,) int32, the absolute position stored in each slot
    (-1 = empty).  pos: 0-d int32, the position of the current token.  The
    new token is written at slot pos % W (ring eviction); the new cache and
    positions are returned (new tensors, the inputs are left as they were).
    Plain torch: the reference's decode attention has no TPU kernel.
    """
    B, _, D = x.shape
    H, K, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = rms_norm(params["pre_norm"], x, cfg.norm_eps)
    q = h @ params["wq"]
    k = h @ params["wk"]
    v = h @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = _heads(q, B, 1, H, Dh, "heads")
    k = _heads(k, B, 1, K, Dh, "kv_heads")
    v = _heads(v, B, 1, K, Dh, "kv_heads")
    posv = pos.reshape(1)
    cos, sin = make_rope(posv, Dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    ctx = _sharded()
    if ctx is not None and _is_dtensor(q):
        out, (ck, cv), new_positions = _local_decode(q, k, v, kv_cache, cache_positions, pos,
                                                     cfg, *ctx)
    else:
        out, (ck, cv), new_positions = _decode_attend(q, k, v, kv_cache, cache_positions,
                                                      pos, cfg)
    return x + out @ params["wo"], (ck, cv), new_positions


def _decode_attend(q, k, v, kv_cache, cache_positions, pos, cfg: ModelConfig):
    """The ring write and the attention of one decode step: ``(out (B, 1,
    H * Dh), (k cache, v cache), positions)``."""
    B, _, H, Dh = q.shape
    K = k.shape[2]
    W = kv_cache[0].shape[1]
    posv = pos.reshape(1)
    slot = torch.remainder(posv, W).to(torch.int64)
    ck = kv_cache[0].index_copy(1, slot, k)
    cv = kv_cache[1].index_copy(1, slot, v)
    new_positions = cache_positions.index_copy(0, slot, posv.to(cache_positions.dtype))
    # attend over the whole ring buffer; mask invalid / out-of-window slots
    valid = (new_positions >= 0) & (new_positions <= pos)
    if cfg.sliding_window:
        valid = valid & (new_positions > pos - cfg.sliding_window)
    mask = valid[None, None, None, :]              # (1,1,1,W)
    G = H // K
    qg = q.reshape(B, 1, K, G, Dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, ck).float() / float(np.sqrt(Dh))
    scores = torch.where(mask[:, :, None], scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(cv.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, cv).reshape(B, 1, H * Dh)
    return out, (ck, cv), new_positions


def _local_decode(q, k, v, kv_cache, cache_positions, pos, cfg: ModelConfig, rules, mesh):
    """`_decode_attend` on each rank's batch rows and heads (``local_map``):
    the heads sharded where the q and kv heads split alike, else replicated.
    A cache laid out otherwise by the rules (on its head dim or its ring
    slots) is redistributed to that layout for the step and back after it
    (the reference's GSPMD keeps it in place: a cost the dry run's records
    of those rules carry)."""
    from torch.distributed.tensor import Replicate

    B, _, H, Dh = q.shape
    K = k.shape[2]
    W = kv_cache[0].shape[1]
    sq = logical_to_pspec(("batch", None, "heads", None), rules, (B, 1, H, Dh), mesh)
    sk = logical_to_pspec(("batch", None, "kv_heads", None), rules, (B, W, K, Dh), mesh)
    if sq[2] != sk[2]:
        sq, sk = sq[:2] + (None, None), sk[:2] + (None, None)
    pq, pk = placements(sq, mesh), placements(sk, mesh)
    pout = placements(sq[:3], mesh)            # (B, 1, H * Dh), heads major
    rep = (Replicate(),) * mesh.ndim
    out, (ck, cv), new_positions = SH.local(
        lambda q, k, v, ck, cv, cp, p: _decode_attend(q, k, v, (ck, cv), cp, p, cfg),
        (pq, pk, pk, pk, pk, rep, rep), (pout, pk, pk, rep))(
            q, k, v, kv_cache[0], kv_cache[1], cache_positions, pos)
    axes = ("batch", "cache_seq", "cache_kv_heads", "cache_head_dim")
    return out, (_shard(ck, axes), _shard(cv, axes)), new_positions


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
    u = dot(h, params["w_up"])
    if cfg.ffn_gated:
        a = F.silu(dot(h, params["w_gate"])) * u
    else:
        a = F.gelu(u, approximate="tanh")  # jax.nn.gelu is the tanh form by default
    a = _shard(a, ("batch", "seq", "mlp"))
    out = dot(a, params["w_down"])
    out = _shard(out, ("batch", "seq", "embed"))
    return x + out


# --------------------------------------------------------------------- #
# MoE FFN (top-k routed experts + optional shared experts / dense residual)
# --------------------------------------------------------------------- #
def moe_meta(cfg: ModelConfig, stacked: int | None = None) -> dict:
    D, E, F_ = cfg.d_model, cfg.num_experts, cfg.d_ff_expert
    dt = _dt(cfg)

    def P(shape, axes, **kw):
        if stacked is not None:
            shape, axes = (stacked, *shape), ("layers", *axes)
        return ParamMeta(shape, axes, dtype=dt, **kw)

    tree = {
        "router": P((D, E), ("embed", "experts"), init="small"),
        "we_gate": P((E, D, F_), ("experts", "embed", "mlp_expert"), fan_in_axes=(-2,)),
        "we_up": P((E, D, F_), ("experts", "embed", "mlp_expert"), fan_in_axes=(-2,)),
        "we_down": P((E, F_, D), ("experts", "mlp_expert", "embed"), fan_in_axes=(-2,)),
        "pre_norm": P((D,), ("embed",), init="ones"),
    }
    if cfg.num_shared_experts:
        Fs = cfg.num_shared_experts * F_
        tree["ws_gate"] = P((D, Fs), ("embed", "mlp"), fan_in_axes=(-2,))
        tree["ws_up"] = P((D, Fs), ("embed", "mlp"), fan_in_axes=(-2,))
        tree["ws_down"] = P((Fs, D), ("mlp", "embed"), fan_in_axes=(-2,))
    if cfg.moe_dense_residual:
        Fd = cfg.d_ff
        tree["wd_gate"] = P((D, Fd), ("embed", "mlp"), fan_in_axes=(-2,))
        tree["wd_up"] = P((D, Fd), ("embed", "mlp"), fan_in_axes=(-2,))
        tree["wd_down"] = P((Fd, D), ("mlp", "embed"), fan_in_axes=(-2,))
    return tree


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    cap = int(np.ceil(cfg.num_experts_per_tok * n_tokens / cfg.num_experts * cfg.capacity_factor))
    return max(4, int(np.ceil(cap / 4) * 4))


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot``: fp32 rows, all zero where ``idx`` lies outside
    [0, n) (`F.one_hot` raises there, and has no `vmap` rule)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _router(params, xg: torch.Tensor, cfg: ModelConfig):
    """fp32 router: ``(probs (N,E), gate_vals (N,k) renormalised, idx (N,k))``.
    Under a rule context the logits take every expert on each rank (the
    top-k of a sharded dimension would gather candidates from every shard)."""
    logits = _shard(dot(xg.float(), params["router"].float()), ("batch", None))
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.topk(probs, cfg.num_experts_per_tok, dim=-1, sorted=True)
    return probs, gate_vals / gate_vals.sum(dim=-1, keepdim=True), idx


def _aux(probs: torch.Tensor, idx: torch.Tensor, E: int) -> torch.Tensor:
    """Switch load-balance loss E * sum_e f_e * P_e."""
    frac_tokens = _one_hot(idx, E).sum(dim=1).mean(dim=0)
    return E * torch.sum(frac_tokens * probs.mean(dim=0))


def _route_group(params, xg: torch.Tensor, cfg: ModelConfig):
    """Dispatch/FFN/combine for one token group (GShard one-hot einsums).
    xg: (N, D) -> (N, D), aux."""
    N, D = xg.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    cap = _capacity(N, cfg)
    probs, gate_vals, idx = _router(params, xg, cfg)
    sel = _one_hot(idx, E)                                        # (N, k, E)
    # priority: expert slot 0 of every token first, then slot 1, ... (GShard):
    # the running count over the k-major order is the count within the
    # slot plus the earlier slots' totals (integers, exact in fp32; the
    # tokens' dimension, which a mesh may shard, is never flattened with k)
    sel_k = sel.transpose(0, 1)                                   # (k, N, E)
    within = torch.cumsum(sel_k, dim=1)
    before = torch.cumsum(within[:, -1], dim=0) - within[:, -1]   # (k, E)
    pos_in_e = (within + before[:, None]) * sel_k - 1.0           # (k, N, E)
    keep = (pos_in_e >= 0) & (pos_in_e < cap)
    disp = (sel_k * keep)[..., None] * _one_hot(pos_in_e.long(), cap)
    disp = disp.permute(1, 0, 2, 3)                               # (N, k, E, cap)
    disp_tok = disp.sum(dim=1)                                    # (N, E, cap) 0/1
    xin = _expert_einsum("nec,nd->ecd", disp_tok.to(xg.dtype), xg, params["we_gate"])
    h = torch.einsum("ecd,edf->ecf", xin, params["we_gate"])
    u = torch.einsum("ecd,edf->ecf", xin, params["we_up"])
    a = F.silu(h) * u
    a = _shard(a, ("experts", None, "mlp_expert"))
    y = torch.einsum("ecf,efd->ecd", a, params["we_down"])        # (E, cap, D)
    comb = torch.einsum("nkec,nk->nec", disp, gate_vals).to(y.dtype)
    out = _expert_einsum("nec,ecd->nd", comb, y, y)               # (N, D)
    return out, _aux(probs, idx, E)


def _expert_einsum(eq: str, route: torch.Tensor, x: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, route, x)``: ``route`` (N, E, cap) the dispatch or
    combine weights, ``x`` the tokens' rows (N, D) and the result the
    experts' slots (E, cap, D), or the other way round.  Under a rule
    context each rank contracts its tokens' rows with the experts it holds
    (those of ``w``, an (E, ...) expert tensor) through ``local_map``: the
    result, and x's gradient, is a partial sum over the mesh dimensions that
    the contraction runs across.  DTensor's own einsum would flatten the
    (experts, capacity) pair, whose strided split it materialises index by
    index."""
    ctx = _sharded()
    if ctx is None or not _is_dtensor(x):
        return torch.einsum(eq, route, x)
    from torch.distributed.tensor import Partial, Replicate, Shard

    def summed(p):  # a side that the contraction runs across
        return Partial() if p == Replicate() else p

    tokens_in = x.ndim == 2
    rows = []  # a mesh dim's (route, x, result, x's gradient) placements
    for r_pl, x_pl, w_pl in zip(route.placements, x.placements, w.placements):
        if w_pl == Shard(0):                                # the experts
            r, side = Shard(1), (Replicate(), Shard(0))     # (tokens' rows, experts' slots)
        elif (x_pl if tokens_in else r_pl) == Shard(0):     # the tokens
            r, side = Shard(0), (Shard(0), Replicate())
        else:
            rows.append((Replicate(),) * 4)
            continue
        xi, oi = side if tokens_in else side[::-1]
        rows.append((r, xi, summed(oi), summed(xi)))
    pr, px, po, gx = zip(*rows)
    return SH.local(lambda a, b: torch.einsum(eq, a, b), (pr, px), (po,), (pr, gx))(route, x)


def _route_group_sorted(params, xg: torch.Tensor, cfg: ModelConfig):
    """Sort-based dispatch: argsort + scatter/gather instead of the one-hot
    einsums, the same token->slot assignment (k-major priority, capacity
    drop) as `_route_group`.  With ``cfg.use_pallas`` the three expert
    products run K5 (`kernels.ops.moe_gmm`), else bf16 `torch.einsum`.

    Static shapes only (no ``nonzero``, no ``.item()``), so `torch.func`
    transforms compose with it.  The dispatch buffer's rows are unique
    except the trash row E*cap, so ``index_add`` is exact; the combine adds
    each token's k contributions in k order, in y's dtype, as XLA's
    scatter-add applies them (an ``index_add`` on the card would add bf16
    with atomics in no fixed order).  For the same reason each token's k
    copies come from ``repeat``, whose backward sums them in k order, not
    from an ``index_select`` over ``arange(N).repeat(k)`` (the reference's
    ``xg[tok_f]``), whose backward would add them with atomics."""
    N, D = xg.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    cap = _capacity(N, cfg)
    dev = xg.device
    if _sharded() is not None and _is_dtensor(xg):
        raise NotImplementedError("the sort dispatch has no sharded form yet (DTensor has no "
                                  "rule for searchsorted; K5 under local_map is queued): "
                                  "use moe_dispatch='einsum' on a mesh")
    probs, gate_vals, idx = _router(params, xg, cfg)
    # k-major flattening (same priority order as the einsum path)
    idx_f = idx.T.reshape(N * k)                                  # (k*N,)
    gates_f = gate_vals.T.reshape(N * k)
    # position within expert via stable sort over expert ids
    order = torch.argsort(idx_f, stable=True)
    sorted_e = torch.gather(idx_f, 0, order)
    pos_sorted = torch.arange(N * k, device=dev) - torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = torch.zeros(N * k, dtype=torch.int64, device=dev).scatter(0, order, pos_sorted)
    keep = pos < cap
    slot = torch.where(keep, idx_f * cap + pos, E * cap)          # overflow -> dropped row
    # scatter tokens into the dispatch buffer (E*cap+1, D); last row = trash
    src = xg.repeat(k, 1) * keep[:, None]                          # token of row i: i % N
    buf = torch.zeros((E * cap + 1, D), dtype=xg.dtype, device=dev).index_add(0, slot, src)
    xin = buf[: E * cap].reshape(E, cap, D)
    if cfg.use_pallas:
        from ..kernels import ops as kops

        h = kops.moe_gmm(xin, params["we_gate"])
        u = kops.moe_gmm(xin, params["we_up"])
        y = kops.moe_gmm(F.silu(h) * u, params["we_down"])
    else:
        h = torch.einsum("ecd,edf->ecf", xin, params["we_gate"])
        u = torch.einsum("ecd,edf->ecf", xin, params["we_up"])
        a = _shard(F.silu(h) * u, ("experts", None, "mlp_expert"))
        y = torch.einsum("ecf,efd->ecd", a, params["we_down"])  # (E, cap, D)
    y_flat = torch.cat([y.reshape(E * cap, D), torch.zeros((1, D), dtype=y.dtype, device=dev)])
    per_slot = y_flat.index_select(0, slot) * (gates_f * keep).to(y.dtype)[:, None]
    per_slot = per_slot.reshape(k, N, D)                          # (k, N, D)
    out = per_slot[0]
    for j in range(1, k):
        out = out + per_slot[j]
    return out, _aux(probs, idx, E)


def moe_block(params: dict, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss).  Tokens dispatched in groups along S
    (a Python loop where the reference has `lax.scan`, aux averaged over the
    groups), then the shared experts and the dense residual, if any."""
    B, S, D = x.shape
    h = _maybe_grad_cast(rms_norm(params["pre_norm"], x, cfg.norm_eps), cfg)
    Sg = min(cfg.moe_group_size, S)
    n_groups = max(S // Sg, 1)
    if S % Sg:
        raise ValueError(f"seq {S} not divisible by moe group {Sg}")
    hg = _keep_grad(h.reshape(B, n_groups, Sg, D).transpose(0, 1).reshape(n_groups, B * Sg, D))

    # a group's tokens keep the batch's layout (under a rule context: the
    # experts' partial sums reduced before the groups are stacked)
    def route(params, xg, cfg):
        y, aux = dispatch(params, xg, cfg)
        return _shard(y, ("batch", "embed")), aux

    dispatch = _route_group_sorted if cfg.moe_dispatch == "sort" else _route_group
    if n_groups == 1:
        out, aux_total = route(params, hg[0], cfg)
        out = out.reshape(1, B, Sg, D)
    else:
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        outs = []
        for g in range(n_groups):
            y, aux = route(params, hg[g], cfg)
            aux_total = aux_total + aux
            outs.append(y)
        aux_total = aux_total / n_groups
        out = torch.stack(outs).reshape(n_groups, B, Sg, D)
    out = _keep_grad(out.transpose(0, 1).reshape(B, S, D))

    if cfg.num_shared_experts:
        g = dot(h, params["ws_gate"])
        u = dot(h, params["ws_up"])
        out = out + dot(F.silu(g) * u, params["ws_down"])
    if cfg.moe_dense_residual:
        g = dot(h, params["wd_gate"])
        u = dot(h, params["wd_up"])
        out = out + dot(F.silu(g) * u, params["wd_down"])
    out = _shard(out, ("batch", "seq", "embed"))
    return x + out, aux_total


# --------------------------------------------------------------------- #
# embedding
# --------------------------------------------------------------------- #
def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, table)``.  Under a rule context, a table whose
    vocab rows are sharded is looked up on each rank's rows
    (`torch.distributed.tensor.experimental.local_map`): a token outside
    them gives zeros, and the output is a partial sum over those mesh
    dimensions, which the next hint reduces (the vocab-parallel embedding;
    DTensor's own masked lookup is not used)."""
    ctx = _sharded()
    if ctx is None or not _is_dtensor(table) or not any(
            p.is_shard(0) for p in table.placements):
        return F.embedding(tokens, table)
    from torch.distributed.tensor import Partial, Replicate

    _, mesh = ctx
    vdims = [i for i, p in enumerate(table.placements) if p.is_shard(0)]
    tok_pl = tokens.placements if _is_dtensor(tokens) else (Replicate(),) * mesh.ndim
    ptok = tuple(Replicate() if i in vdims else p for i, p in enumerate(tok_pl))
    pout = tuple(Partial() if i in vdims else p for i, p in enumerate(ptok))
    n_local = table.to_local().shape[0]
    lo = shard_index(mesh, vdims) * n_local  # the rank's first row

    def local(tbl, tok):
        idx = tok.to(torch.int64) - lo
        ok = (idx >= 0) & (idx < n_local)
        out = F.embedding(torch.where(ok, idx, 0), tbl)
        return out * ok[..., None].to(out.dtype)

    # each rank's table gradient holds its own tokens' rows only: a partial
    # sum over the mesh dimensions that shard the tokens
    gtab = tuple(Partial() if p.is_shard() else t for t, p in zip(table.placements, ptok))
    return SH.local(local, (table.placements, ptok), (pout,), (gtab, ptok))(table, tokens)
