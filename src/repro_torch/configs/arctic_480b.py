"""Snowflake Arctic (480B): dense-MoE hybrid. [hf:Snowflake/snowflake-arctic-base]

35L, d_model 7168, 56 heads (GQA kv=8), 128 experts top-2 (d_ff 4864 each)
with a parallel dense residual FFN, vocab 32000.
"""
from .base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="arctic_480b",
        family="moe",
        num_layers=35,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=4864,            # dense residual branch width
        vocab_size=32000,
        num_experts=128,
        num_experts_per_tok=2,
        d_ff_expert=4864,
        moe_dense_residual=True,
        moe_group_size=512,
    )
