"""Correlation and cost volumes of optical-flow networks, channels-last
(port of ``vsrlab_tpu/ops/correlation.py``).

* :func:`all_pairs_correlation`: RAFT's all-pairs volume, one batched fp32
  product (``torch.matmul``, as the JAX package leaves it to XLA).
* :func:`cost_volume`: PWC's mean-over-channels correlation in a
  ``(2d+1)^2`` shift window, row-major over ``(dy, dx)``.
* :func:`spatial_correlation_sample`: the patch correlation sampler
  (kernel size 1): channel sums at each patch displacement.

The window products are shifted elementwise products in plain PyTorch; no
TPU kernel stands behind them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def all_pairs_correlation(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """``(N, H, W, C)`` x2 -> ``(N, H, W, H, W)`` fp32, over ``sqrt(C)``."""
    n, h, w, c = fmap1.shape
    a = fmap1.reshape(n, h * w, c).float()
    b = fmap2.reshape(n, h * w, c).float()
    corr = torch.matmul(a, b.transpose(1, 2)) / math.sqrt(c)
    return corr.reshape(n, h, w, h, w)


def _pad_hw(x: torch.Tensor, p: int) -> torch.Tensor:
    """Zero-pad the H and W axes of ``(N, H, W, C)`` by ``p``."""
    return F.pad(x, (0, 0, p, p, p, p)) if p else x


def cost_volume(feat1: torch.Tensor, feat2: torch.Tensor, max_disp: int) -> torch.Tensor:
    """``(N, H, W, C)`` x2 -> ``(N, H, W, (2*max_disp+1)**2)``: ``feat2``
    zero-padded by ``max_disp`` and shifted over the window, the product
    with ``feat1`` averaged over channels."""
    _, h, w, _ = feat1.shape
    d = max_disp
    f2 = _pad_hw(feat2, d)
    costs = [(feat1 * f2[:, i:i + h, j:j + w]).mean(-1)
             for i in range(2 * d + 1) for j in range(2 * d + 1)]
    return torch.stack(costs, -1)


def spatial_correlation_sample(input1: torch.Tensor, input2: torch.Tensor, patch_size: int = 1,
                               stride: int = 1, padding: int = 0,
                               dilation_patch: int = 1) -> torch.Tensor:
    """``(N, H, W, C)`` x2 -> ``(N, patch, patch, H', W')``, ``H' =
    ceil((H + 2 padding) / stride)``: the channel sum of ``input1`` times
    ``input2`` shifted by each patch displacement (odd ``patch_size``)."""
    if patch_size % 2 != 1:
        raise ValueError("only odd patch sizes are supported")
    input1, input2 = _pad_hw(input1, padding), _pad_hw(input2, padding)
    md = dilation_patch * (patch_size - 1) // 2
    _, h, w, _ = input1.shape
    in2 = _pad_hw(input2, md)
    in1_s = input1[:, ::stride, ::stride]
    rows = []
    for i in range(0, 2 * md + 1, dilation_patch):
        row = [(in1_s * in2[:, i:i + h, j:j + w][:, ::stride, ::stride]).sum(-1)
               for j in range(0, 2 * md + 1, dilation_patch)]
        rows.append(torch.stack(row, 1))
    return torch.stack(rows, 1)
