"""Mamba2 (state-space duality / SSD) blocks: the chunked parallel form and
decode.

`repro.models.mamba2`, after "Transformers are SSDs" (arXiv:2405.21060):
  h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t,      y_t = C_t h_t + D x_t
with per-head scalar A and B/C shared across heads (ssm_groups=1).  Training
and prefill use the chunked dual form (O(S Q) with chunk Q); decode is the
O(1) recurrence (`ssd_recurrent_step`) against an fp32 SSM state and a conv
ring of the last ssm_conv - 1 inputs; all decay and exp math is fp32.  With
``cfg.use_pallas`` the chunked scan runs the hand-written CUDA kernel
(`kernels.ops.ssd_scan`, K4), else `ssd_chunked`; the recurrence is plain
torch, as it is plain jnp in the reference.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..launch import shardings as SH
from . import layers as L
from .module import CacheSpec, ParamMeta
from .remat import dot
from .transformer import _dt, _remat, _unstack

__all__ = [
    "mamba_block_meta",
    "model_meta",
    "ssd_chunked",
    "ssd_recurrent_step",
    "mamba_block",
    "mamba_decode_block",
    "forward",
    "init_cache",
    "cache_logical_axes",
    "decode_step",
]


def _dims(cfg: ModelConfig):
    d_inner = cfg.d_inner
    H = cfg.ssm_heads
    N = cfg.ssm_state
    G = cfg.ssm_groups
    conv_ch = d_inner + 2 * G * N
    return d_inner, H, N, G, conv_ch


def mamba_block_meta(cfg: ModelConfig, stacked: int | None = None) -> dict:
    D = cfg.d_model
    d_inner, H, N, G, conv_ch = _dims(cfg)
    d_in_proj = 2 * d_inner + 2 * G * N + H
    dt = _dt(cfg)

    def P(shape, axes, **kw):
        if stacked is not None:
            shape, axes = (stacked, *shape), ("layers", *axes)
        return ParamMeta(shape, axes, dtype=dt, **kw)

    return {
        "in_proj": P((D, d_in_proj), ("embed", "mlp"), fan_in_axes=(-2,)),
        "conv_w": P((cfg.ssm_conv, conv_ch), ("conv", "mlp"), init="normal", fan_in_axes=(0,)),
        "conv_b": P((conv_ch,), ("mlp",), init="zeros"),
        "A_log": P((H,), ("state",), init="ssm_a"),
        "D": P((H,), ("state",), init="ones"),
        "dt_bias": P((H,), ("state",), init="ssm_dt"),
        "norm": P((d_inner,), ("mlp",), init="ones"),
        "out_proj": P((d_inner, D), ("mlp", "embed"), fan_in_axes=(-2,)),
        "pre_norm": P((D,), ("embed",), init="ones"),
    }


def model_meta(cfg: ModelConfig) -> dict:
    D, V, nL = cfg.d_model, cfg.vocab_size, cfg.num_layers
    dt = _dt(cfg)
    tree: dict[str, Any] = {
        "embed": ParamMeta((V, D), ("vocab", "embed"), dtype=dt, init="embed"),
        "blocks": mamba_block_meta(cfg, stacked=nL),
        "final_norm": ParamMeta((D,), ("embed",), dtype=dt, init="ones"),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = ParamMeta((D, V), ("embed", "vocab"), dtype=dt, fan_in_axes=(0,))
    return tree


# ------------------------------------------------------------------ #
# SSD math
# ------------------------------------------------------------------ #
def _segsum(a: torch.Tensor, cs: torch.Tensor | None = None) -> torch.Tensor:
    """a: (..., Q) -> (..., Q, Q) with out[i,j] = sum_{j < l <= i} a_l (i>=j), -inf else.

    ``cs``, a's cumsum along its last axis, is taken as given when the
    caller has it.  The upper triangle is selected, never exponentiated
    from the difference: there cs_i - cs_j > 0, and its exp can overflow."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1) if cs is None else cs
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(
    x: torch.Tensor,   # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)  fp32, post-softplus
    A: torch.Tensor,   # (H,) or per row (B, H), fp32, negative
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    chunk: int,
    init_state: torch.Tensor | None = None,  # (B, H, N, P)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  Returns (y (B,S,H,P), final_state (B,H,N,P) fp32).

    ``A`` per row is the form the kernel's autograd Function passes (one A
    per (b, h), so a `vmap` over snapshots can fold its lanes into B)."""
    Bsz, S, H, Pd = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"S={S} not divisible by chunk={Q}")
    nc = S // Q
    xc = x.reshape(Bsz, nc, Q, H, Pd)
    dtc = dt.reshape(Bsz, nc, Q, H).float()
    Bc = Bm.reshape(Bsz, nc, Q, N).float()
    Cc = Cm.reshape(Bsz, nc, Q, N).float()
    A = A.float()
    a = dtc * (A[None, None, None, :] if A.ndim == 1 else A[:, None, None, :])  # (B,nc,Q,H)
    cs = torch.cumsum(a, dim=2)                          # within-chunk cumsum

    # --- intra-chunk (diagonal) term --------------------------------- #
    # L from this cs (the reference recomputes the same cumsum inside
    # _segsum): on the card a cumsum along dim 2 is a sequential fp32 loop,
    # one along the last dim a parallel scan, and at |cs| ~ 100s the order
    # shows in exp(cs_i - cs_j); the kernel sums in the first order
    Lmat = torch.exp(_segsum(a.transpose(2, 3), cs.transpose(2, 3)))  # (B,nc,H,Q,Q)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)     # (B,nc,Q,Q)
    xw = xc.float() * dtc[..., None]                     # dt_j * x_j
    y_diag = torch.einsum("bcij,bchij,bcjhp->bcihp", scores, Lmat, xw)

    # --- chunk states -------------------------------------------------- #
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)      # (B,nc,Q,H)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchnp", Bc, dtc * decay_to_end, xc.float())

    # --- inter-chunk recurrence (the reference's lax.scan) ------------- #
    chunk_decay = torch.exp(cs[:, :, -1, :])             # (B,nc,H)
    h = (torch.zeros((Bsz, H, N, Pd), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                # (B,nc,H,N,P)

    # --- inter-chunk output term -------------------------------------- #
    y_off = torch.einsum("bcin,bchnp,bcih->bcihp", Cc, h_prevs, torch.exp(cs))

    y = (y_diag + y_off).reshape(Bsz, S, H, Pd).to(x.dtype)
    return y, h


def ssd_recurrent_step(
    h: torch.Tensor,   # (B, H, N, P) fp32 state
    x: torch.Tensor,   # (B, H, P)
    dt: torch.Tensor,  # (B, H) fp32
    A: torch.Tensor,   # (H,)
    Bm: torch.Tensor,  # (B, N)
    Cm: torch.Tensor,  # (B, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  Returns (y (B,H,P), new_state)."""
    dA = torch.exp(dt * A[None, :])                      # (B,H)
    dBx = torch.einsum("bn,bh,bhp->bhnp", Bm.float(), dt, x.float())
    h = h * dA[:, :, None, None] + dBx
    y = torch.einsum("bn,bhnp->bhp", Cm.float(), h)
    return y.to(x.dtype), h


def _recurrent_step(h, x, dt, A, Bm, Cm):
    """`ssd_recurrent_step`; under a rule context on each rank's batch rows
    (``local_map``; DTensor's einsum may split the 24 heads of Mamba2-130M
    over a model axis of 16, which its reshapes then refuse)."""
    if L._sharded() is None or not L._is_dtensor(x):
        return ssd_recurrent_step(h, x, dt, A, Bm, Cm)
    rows = SH.axis_placements(("batch",), (x.shape[0],))
    rep = SH.axis_placements((None,), A.shape)  # replicated
    return SH.local(ssd_recurrent_step, (rows, rows, rows, rep, rows, rows),
                    (rows, rows))(h, x, dt, A, Bm, Cm)


# ------------------------------------------------------------------ #
# blocks
# ------------------------------------------------------------------ #
def _split_proj(proj: torch.Tensor, cfg: ModelConfig):
    d_inner, H, N, G, conv_ch = _dims(cfg)
    z, xBC, dt = torch.split(proj, [d_inner, conv_ch, H], dim=-1)
    return z, xBC, dt


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  xBC: (B,S,Ch), w: (W,Ch).  The W taps are
    summed in fp32 in order, then the bias is added, as the reference does."""
    W, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = pad[:, 0:S, :].float() * w[0].float()
    for i in range(1, W):
        out = out + pad[:, i : i + S, :].float() * w[i].float()
    return (out + b.float()).to(xBC.dtype)


def mamba_block(params: dict, x: torch.Tensor, cfg: ModelConfig,
                init_state: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence Mamba2 block with residual.  Returns (y, final_ssm_state)."""
    B, S, D = x.shape
    d_inner, H, N, G, conv_ch = _dims(cfg)
    Pd = cfg.ssm_head_dim
    h = L._maybe_grad_cast(L.rms_norm(params["pre_norm"], x, cfg.norm_eps), cfg)
    proj = dot(h, params["in_proj"])
    z, xBC, dt_raw = _split_proj(proj, cfg)
    xBC = F.silu(_causal_conv(xBC, params["conv_w"], params["conv_b"]))
    xs, Bm, Cm = torch.split(xBC, [d_inner, G * N, G * N], dim=-1)
    xs = L._heads(xs, B, S, H, Pd, "heads")
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    if cfg.use_pallas:
        from ..kernels import ops as kops

        y, hT = kops.ssd_scan(xs, dt, A, Bm, Cm, chunk=cfg.ssm_chunk, init_state=init_state)
    else:
        y, hT = ssd_chunked(xs, dt, A, Bm, Cm, cfg.ssm_chunk, init_state)
    y = y + xs * params["D"].to(y.dtype)[None, None, :, None]
    y = L._keep_grad(y.reshape(B, S, d_inner)) * F.silu(z)
    y = L.rms_norm(params["norm"], y, cfg.norm_eps)
    out = L._shard(dot(y, params["out_proj"]), ("batch", "seq", "embed"))
    return x + out, hT


def mamba_decode_block(
    params: dict,
    x: torch.Tensor,                    # (B, 1, D)
    cfg: ModelConfig,
    ssm_state: torch.Tensor,            # (B, H, N, P) fp32
    conv_state: torch.Tensor,           # (B, W-1, conv_ch)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token Mamba2 block with residual.  Returns (y, new_ssm_state,
    new_conv_state): the conv ring is the last W - 1 inputs, the new one
    concatenated at its end."""
    B, _, D = x.shape
    d_inner, H, N, G, conv_ch = _dims(cfg)
    Pd = cfg.ssm_head_dim
    h = L.rms_norm(params["pre_norm"], x, cfg.norm_eps)
    proj = h @ params["in_proj"]
    z, xBC, dt_raw = _split_proj(proj, cfg)
    xBC = xBC[:, 0]                                       # (B, conv_ch)
    # conv ring: taps = [conv_state, new]
    full = torch.cat([conv_state, xBC[:, None, :]], dim=1)  # (B, W, ch)
    conv_out = torch.einsum("bwc,wc->bc", full.float(), params["conv_w"].float())
    conv_out = conv_out + params["conv_b"].float()
    xBC_c = F.silu(conv_out).to(x.dtype)
    new_conv_state = full[:, 1:, :]
    xs, Bm, Cm = torch.split(xBC_c, [d_inner, G * N, G * N], dim=-1)
    xs = L._shard(xs, ("batch", "heads"), shape=(B, H)).reshape(B, H, Pd)
    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    y, new_state = _recurrent_step(ssm_state, xs, dt, A, Bm, Cm)
    y = y + xs * params["D"].to(y.dtype)[None, :, None]
    y = y.reshape(B, 1, d_inner) * F.silu(z)
    y = L.rms_norm(params["norm"], y, cfg.norm_eps)
    return x + y @ params["out_proj"], new_state, new_conv_state


# ------------------------------------------------------------------ #
# whole-model entry points
# ------------------------------------------------------------------ #
def forward(params: dict, batch: dict, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward over the unbound stacked layers (the
    reference's ``lax.scan``).  Returns (logits (B,S,V), 0)."""
    params = L._gather(params)
    x = L.embed_lookup(params["embed"], batch["tokens"])
    x = L._shard(x, ("batch", "seq", "embed"))
    blk = _remat(functools.partial(_call_block, cfg), cfg)
    for params_l in _unstack(params["blocks"], cfg.num_layers):
        x = blk(params_l, x)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head, torch.zeros((), dtype=torch.float32, device=x.device)


def _call_block(cfg, params_l, x):
    return mamba_block(params_l, x, cfg)[0]


def init_cache(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """The decode cache spec (`CacheSpec` leaves): per layer the fp32 SSM
    state and the conv ring, and the next position."""
    d_inner, H, N, G, conv_ch = _dims(cfg)
    nL = cfg.num_layers
    return {
        "ssm": CacheSpec((nL, batch, H, N, cfg.ssm_head_dim), torch.float32),
        "conv": CacheSpec((nL, batch, cfg.ssm_conv - 1, conv_ch), _dt(cfg)),
        "pos": CacheSpec((), torch.int32),
    }


def cache_logical_axes(cfg: ModelConfig) -> dict:
    return {
        "ssm": ("layers", "batch", "heads", "state", None),
        "conv": ("layers", "batch", None, "mlp"),
        "pos": (),
    }


def _decode_layers(layers: list, x: torch.Tensor, cfg: ModelConfig, ssm, conv):
    """`mamba_decode_block` over ``layers`` and their cache slices: ``(x,
    [ssm states], [conv rings])``."""
    ssm_out, conv_out = [], []
    for params_l, h, c in zip(layers, ssm, conv):
        x, h, c = mamba_decode_block(params_l, x, cfg, h, c)
        ssm_out.append(h)
        conv_out.append(c)
    return x, ssm_out, conv_out


def decode_step(params: dict, cache: dict, batch: dict, cfg: ModelConfig):
    """One-token decode.  Returns (logits (B, V), new_cache)."""
    params = L._gather(params)
    x = L.embed_lookup(params["embed"], batch["tokens"])
    x, ssm, conv = _decode_layers(_unstack(params["blocks"], cfg.num_layers), x, cfg,
                                  cache["ssm"], cache["conv"])
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head)[:, 0]
    return logits, {"ssm": torch.stack(ssm), "conv": torch.stack(conv), "pos": cache["pos"] + 1}
