"""Qwen1.5/2-MoE-A2.7B: fine-grained MoE. [hf:Qwen/Qwen1.5-MoE-A2.7B]

24L, d_model 2048, 16 heads (MHA kv=16), 60 routed experts top-4 (d_ff 1408)
plus 4 shared experts, vocab 151936.
"""
from .base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2_moe_a2_7b",
        family="moe",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=151936,
        num_experts=60,
        num_experts_per_tok=4,
        num_shared_experts=4,
        d_ff_expert=1408,
        qkv_bias=True,
        moe_group_size=1024,
    )
