"""StarCoder2-7B: dense code LM, GQA, RoPE. [arXiv:2402.19173]

32L, d_model 4608, 36 heads (GQA kv=4), d_ff 18432, vocab 49152.
(StarCoder2 uses a 4k sliding window in alternating layers; we expose the
window only for the long_500k variant per the assignment's shape policy.)
"""
from .base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2_7b",
        family="dense",
        num_layers=32,
        d_model=4608,
        num_heads=36,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18432,
        vocab_size=49152,
        rope_theta=100_000.0,
        qkv_bias=True,
        ffn_gated=False,
    )
