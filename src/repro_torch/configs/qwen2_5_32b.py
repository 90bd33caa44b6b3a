"""Qwen2.5-32B: dense, GQA, QKV bias. [hf:Qwen/Qwen2.5-0.5B model-card family]

64L, d_model 5120, 40 heads (GQA kv=8), d_ff 27648, vocab 152064.
"""
from .base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2_5_32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=27648,
        vocab_size=152064,
        rope_theta=1_000_000.0,
        qkv_bias=True,
    )
