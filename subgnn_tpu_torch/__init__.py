"""PyTorch port of subgnn_tpu for NVIDIA Hopper GPUs.

Mirrors the JAX package's module paths (config, data, precompute, ops,
sampling, models, train, cli) and imports nothing from it. Entry points run
on ``cuda`` unless the caller asks for ``device="cpu"``; hand-written CUDA
kernels live under ``csrc/`` and build at first use into ``build/kernels/``.
"""
