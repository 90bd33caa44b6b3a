"""Granite-3.0-2B: dense GQA. [hf:ibm-granite/granite-3.0-2b-base]

40L, d_model 2048, 32 heads (GQA kv=8), d_ff 8192, vocab 49155.
"""
from .base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="granite_3_2b",
        family="dense",
        num_layers=40,
        d_model=2048,
        num_heads=32,
        num_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab_size=49155,
        tie_embeddings=True,
    )
