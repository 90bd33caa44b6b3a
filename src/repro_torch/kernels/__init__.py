"""Hand-written CUDA kernels (`csrc/`), their wrappers, and plain PyTorch
versions.  Nothing is compiled at import: `kernels.build` compiles a
kernel's source at its first launch."""
