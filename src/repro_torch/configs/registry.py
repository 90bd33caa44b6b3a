"""Architecture registry + input specs, the counterpart of `repro.configs.registry`.

Each ``configs/<id>.py`` exports ``get_config() -> ModelConfig`` with the
exact assigned architecture (the files are `repro`'s, copied); this module
maps ids to configs, builds reduced smoke variants, and produces meta-device
tensors (shape and dtype, no storage) as stand-ins for every (arch × input
shape) pair, where the reference returns ``ShapeDtypeStruct``.
"""
from __future__ import annotations

import importlib

import torch

from .base import SHAPES, ModelConfig, ShapeConfig

__all__ = ["ARCH_IDS", "ALIASES", "get_config", "smoke_config", "for_shape",
           "input_specs", "batch_logical_axes", "all_pairs"]

ARCH_IDS = [
    "internvl2_26b",
    "starcoder2_7b",
    "musicgen_medium",
    "arctic_480b",
    "qwen2_5_32b",
    "mamba2_130m",
    "qwen2_moe_a2_7b",
    "yi_6b",
    "granite_3_2b",
    "zamba2_2_7b",
]

# CLI aliases with dashes/dots as given in the assignment
ALIASES = {
    "internvl2-26b": "internvl2_26b",
    "starcoder2-7b": "starcoder2_7b",
    "musicgen-medium": "musicgen_medium",
    "arctic-480b": "arctic_480b",
    "qwen2.5-32b": "qwen2_5_32b",
    "mamba2-130m": "mamba2_130m",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "yi-6b": "yi_6b",
    "granite-3-2b": "granite_3_2b",
    "zamba2-2.7b": "zamba2_2_7b",
}


def get_config(arch: str) -> ModelConfig:
    key = ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ALIASES)}")
    mod = importlib.import_module(f"{__package__}.{key}")
    return mod.get_config()


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family variant: 2 layers, d_model<=512, <=4 experts."""
    cfg = get_config(arch)
    upd: dict = dict(
        num_layers=2,
        d_model=256,
        d_ff=512,
        vocab_size=512,
        dtype="float32",
        remat="none",
        moe_group_size=128,
    )
    if cfg.num_heads:
        upd.update(num_heads=4, num_kv_heads=2, head_dim=64)
    if cfg.family == "moe":
        upd.update(
            num_experts=4,
            num_experts_per_tok=min(cfg.num_experts_per_tok, 2),
            num_shared_experts=min(cfg.num_shared_experts, 1),
            d_ff_expert=128,
        )
    if cfg.family in ("ssm", "hybrid"):
        upd.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=16)
    if cfg.family == "hybrid":
        upd.update(attn_every=1, num_layers=2)
    if cfg.family == "vlm":
        upd.update(num_patches=16)
    if cfg.sliding_window:
        upd.update(sliding_window=64)
    return cfg.replace(**upd)


def for_shape(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """Shape-dependent config tweaks (the long-context sliding-window variant)."""
    if shape.name == "long_500k":
        if cfg.family in ("ssm",):
            return cfg
        # dense/moe/vlm/audio (and the hybrid's shared attention) switch to
        # the sliding-window variant for sub-quadratic long-context decode.
        return cfg.replace(sliding_window=4096 if cfg.sliding_window == 0 else cfg.sliding_window)
    return cfg


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig, dtype=torch.bfloat16) -> dict:
    """Meta-tensor stand-ins for every model input (no allocation)."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "audio_stub":
            batch = {
                "embeds": _spec((B, S, cfg.d_model), dtype),
                "labels": _spec((B, S), i32),
            }
        elif cfg.frontend == "vision_stub":
            s_text = S - cfg.num_patches
            batch = {
                "tokens": _spec((B, s_text), i32),
                "patch_embeds": _spec((B, cfg.num_patches, cfg.d_model), dtype),
                "labels": _spec((B, s_text), i32),
            }
        else:
            batch = {
                "tokens": _spec((B, S), i32),
                "labels": _spec((B, S), i32),
            }
        if shape.kind == "prefill":
            batch.pop("labels")
        return batch
    # decode: ONE new token against a seq_len KV cache
    if cfg.frontend == "audio_stub":
        return {"embeds": _spec((B, 1, cfg.d_model), dtype)}
    return {"tokens": _spec((B, 1), i32)}


def batch_logical_axes(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    spec = input_specs(cfg, shape)
    out = {}
    for k, v in spec.items():
        if k in ("tokens", "labels", "loss_mask"):
            out[k] = ("batch", "seq") if v.ndim == 2 else ("batch",)
        elif k in ("embeds", "patch_embeds"):
            out[k] = ("batch", "seq", "embed")
        else:
            out[k] = tuple([None] * v.ndim)
    return out


def all_pairs() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCH_IDS for s in SHAPES]
