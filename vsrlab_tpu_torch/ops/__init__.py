"""Tensor ops of the port: resizes, warps, pixel shuffle, pooling and the
fused residual conv pair (hand-written CUDA kernels)."""
