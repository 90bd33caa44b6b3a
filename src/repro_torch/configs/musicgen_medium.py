"""MusicGen-medium backbone: decoder-only over EnCodec tokens. [arXiv:2306.05284]

48L, d_model 1536, 24 heads (MHA: kv=24), d_ff 6144, vocab 2048.
The EnCodec codec frontend is stubbed: input_specs provides precomputed
frame embeddings (B, S, d_model); the decoder predicts code ids.
"""
from .base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen_medium",
        family="audio",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        head_dim=64,
        d_ff=6144,
        vocab_size=2048,
        frontend="audio_stub",
        ffn_gated=False,
    )
