"""Batched serving on the PyTorch port: prefill + decode with the unified
serve_step, after training under live request traffic.

Works for every assigned architecture family (dense KV cache, MoE routing,
Mamba2 SSM state, Zamba2 hybrid, audio/VLM stubs); runs on the GPU unless
``--device cpu`` is given:

    PYTHONPATH=src python examples/torch/serve_batched.py --arch mamba2-130m
    PYTHONPATH=src python examples/torch/serve_batched.py --arch qwen2-moe-a2.7b --steps 16
"""
from repro_torch.launch.serve import main as serve_main

if __name__ == "__main__":
    serve_main()
