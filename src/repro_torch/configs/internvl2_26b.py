"""InternVL2-26B backbone: InternViT frontend (stub) + InternLM2-20B decoder.

[arXiv:2404.16821] — 48L, d_model 6144, 48 heads (GQA kv=8), d_ff 16384,
vocab 92553.  The ViT + MLP projector frontend is stubbed per the spec
carve-out: input_specs provides precomputed patch embeddings (256 patches).
"""
from .base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2_26b",
        family="vlm",
        num_layers=48,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=92553,
        rope_theta=1_000_000.0,
        frontend="vision_stub",
        num_patches=256,
    )
