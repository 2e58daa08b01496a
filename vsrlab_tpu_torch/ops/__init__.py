"""Tensor ops of the port: resizes, warps, pixel shuffle, pooling, the
deformable convolution and the wrappers of the hand-written CUDA kernels
(the fused residual conv pair, the bilinear sampler, the packed row
gather)."""
