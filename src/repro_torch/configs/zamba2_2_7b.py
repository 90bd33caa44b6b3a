"""Zamba2-2.7B: Mamba2 backbone + shared attention blocks. [arXiv:2411.15242]

54 Mamba2 layers, d_model 2560 (d_inner 5120, ssm_state 64, head_dim 64),
one weight-shared attention+MLP block (32 heads MHA, d_ff 10240) applied
every 6 layers, vocab 32000.
"""
from .base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2_2_7b",
        family="hybrid",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        head_dim=80,
        d_ff=10240,
        vocab_size=32000,
        ssm_state=64,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_chunk=64,
        attn_every=6,
    )
