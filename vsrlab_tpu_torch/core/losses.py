"""Pixel losses (port of ``vsrlab_tpu/core/losses.py:17-35``).

Each takes two tensors of one shape, computes in fp32 and returns a 0-d
fp32 tensor. The GAN and optical-flow losses belong to later slices.
"""

from __future__ import annotations

import torch


def charbonnier_loss(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Charbonnier (smooth L1) loss: ``mean(sqrt((x-y)^2 + eps))`` (eps inside
    the square root, not squared)."""
    diff = x.float() - y.float()
    return torch.sqrt(diff * diff + eps).mean()


def l1_loss(x: torch.Tensor, y: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """Weighted mean absolute error."""
    return (x.float() - y.float()).abs().mean() * weight


def rmse_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Root-mean-square error."""
    diff = x.float() - y.float()
    return torch.sqrt((diff * diff).mean())
