"""PyTorch / CUDA port of the `repro` package (asynchronous FL queuing dynamics).

It grows beside the JAX package, which stays the reference, and imports
nothing of it (nor JAX).  Subpackages mirror `repro`'s layout: `core`
(control plane, event simulator, replay engine), `data`, `configs`,
`kernels` (hand-written CUDA kernels and their plain PyTorch versions),
`models` (the transformer family), `fl` (the federated runtime) and
`launch` (the training command line).  Entry points run on ``device="cuda"`` unless
the caller asks for the CPU.
"""
