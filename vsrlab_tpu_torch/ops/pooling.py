"""Pooling on channels-last tensors (port of ``vsrlab_tpu/ops/pooling.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def avg_pool2d(x: torch.Tensor, kernel_size: int = 2, stride: int | None = None) -> torch.Tensor:
    """Average pooling on ``(..., H, W, C)``, summed in fp32 and cast back.

    No padding: trailing rows/columns that do not fill a window are dropped,
    as in torch.
    """
    *lead, h, w, c = x.shape
    x4 = x.reshape(-1, h, w, c).permute(0, 3, 1, 2).float()
    out = F.avg_pool2d(x4, kernel_size, stride or kernel_size)
    return out.permute(0, 2, 3, 1).reshape(*lead, *out.shape[2:], c).to(x.dtype)
