"""Mamba2-130M: attention-free SSD. [arXiv:2405.21060]

24L, d_model 768, ssm_state 128, expand 2 (d_inner 1536, 24 heads of dim 64),
vocab 50280, tied embeddings.
"""
from .base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2_130m",
        family="ssm",
        num_layers=24,
        d_model=768,
        vocab_size=50280,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_chunk=64,
        tie_embeddings=True,
    )
