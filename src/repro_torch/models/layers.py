"""Transformer building blocks: norms, RoPE, GQA attention, dense and MoE FFN.

Pure functions over explicit parameter dicts, as in `repro.models.layers`.
Attention has two data paths: the plain PyTorch reference (`_sdpa`) and,
with ``cfg.use_pallas``, the hand-written flash-attention kernel
(`kernels.ops.flash_attention`, the CUDA counterpart of the TPU kernel);
likewise the MoE FFN's expert products under the sort dispatch
(`kernels.ops.moe_gmm`).  The reference's activation-sharding hints are
the identity here: one card, no mesh.  Products keep JAX's dtype flow:
bf16 x bf16 gives bf16 (fp32 accumulation inside the matmul), and norms,
RoPE and the MoE router compute in fp32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
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
    q = dot(h, params["wq"])
    k = dot(h, params["wk"])
    v = dot(h, params["wv"])
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, S, H, Dh)
    k = k.reshape(B, S, K, Dh)
    v = v.reshape(B, S, K, Dh)
    cos, sin = make_rope(positions, Dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = _flash_or_ref(q, k, v, positions, cfg, 0)
    return x + dot(out.reshape(B, S, H * Dh), params["wo"])


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
    W = kv_cache[0].shape[1]
    h = rms_norm(params["pre_norm"], x, cfg.norm_eps)
    q = h @ params["wq"]
    k = h @ params["wk"]
    v = h @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, 1, H, Dh)
    k = k.reshape(B, 1, K, Dh)
    v = v.reshape(B, 1, K, Dh)
    posv = pos.reshape(1)
    cos, sin = make_rope(posv, Dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
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
    return x + out @ params["wo"], (ck, cv), new_positions


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
    return x + dot(a, params["w_down"])


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
    """fp32 router: ``(probs (N,E), gate_vals (N,k) renormalised, idx (N,k))``."""
    logits = dot(xg.float(), params["router"].float())
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
    # priority: expert slot 0 of every token first, then slot 1, ... (GShard)
    sel_f = sel.transpose(0, 1).reshape(N * k, E)                 # (k*N, E)
    pos_in_e = torch.cumsum(sel_f, dim=0) * sel_f - 1.0           # (k*N, E)
    keep = (pos_in_e >= 0) & (pos_in_e < cap)
    disp = (sel_f * keep)[..., None] * _one_hot(pos_in_e.long(), cap)
    disp = disp.reshape(k, N, E, cap).permute(1, 0, 2, 3)         # (N, k, E, cap)
    disp_tok = disp.sum(dim=1)                                    # (N, E, cap) 0/1
    xin = torch.einsum("nec,nd->ecd", disp_tok.to(xg.dtype), xg)  # (E, cap, D)
    h = torch.einsum("ecd,edf->ecf", xin, params["we_gate"])
    u = torch.einsum("ecd,edf->ecf", xin, params["we_up"])
    a = F.silu(h) * u
    y = torch.einsum("ecf,efd->ecd", a, params["we_down"])        # (E, cap, D)
    comb = torch.einsum("nkec,nk->nec", disp, gate_vals).to(y.dtype)
    out = torch.einsum("nec,ecd->nd", comb, y)                    # (N, D)
    return out, _aux(probs, idx, E)


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
        y = torch.einsum("ecf,efd->ecd", F.silu(h) * u, params["we_down"])  # (E, cap, D)
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
    hg = h.reshape(B, n_groups, Sg, D).transpose(0, 1).reshape(n_groups, B * Sg, D)

    route = _route_group_sorted if cfg.moe_dispatch == "sort" else _route_group

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
    out = out.transpose(0, 1).reshape(B, S, D)

    if cfg.num_shared_experts:
        g = dot(h, params["ws_gate"])
        u = dot(h, params["ws_up"])
        out = out + dot(F.silu(g) * u, params["ws_down"])
    if cfg.moe_dense_residual:
        g = dot(h, params["wd_gate"])
        u = dot(h, params["wd_up"])
        out = out + dot(F.silu(g) * u, params["wd_down"])
    return x + out, aux_total
