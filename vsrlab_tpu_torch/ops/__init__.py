"""Tensor ops of the port: resizes, warps, pixel shuffle, pooling, the
deformable convolution and the wrappers of the hand-written CUDA kernels
(the fused residual conv pair, the bilinear sampler, the packed row
gather, the fused window attention).

Importing this package registers those kernels as the custom ops
``torch.ops.vsrlab.{residual_conv_pair, residual_conv_pair_im2col,
bilinear_sample, packed_row_gather, window_attention}``, which an exported program
(:mod:`vsrlab_tpu_torch.evaluation.export`) calls: import it before
loading one.
"""

from vsrlab_tpu_torch.ops import (  # noqa: F401
    bilinear_sample,
    packed_gather,
    residual_pair,
    window_attention,
)
