"""Spectral-norm U-Net discriminator for GAN fine-tuning (port of
``vsrlab_tpu/models/unet_discriminator.py``).

Three stride-2 downsamplings and three bilinear 2x upsamplings with
additive skips, spectral-normalised convolutions in between
(:class:`~vsrlab_tpu_torch.nn.blocks.SpectralConv`), LeakyReLU(0.2), and
one logit a pixel. The spectral-norm power-iteration state is each
``conv_i``'s ``u`` / ``sigma`` buffers; ``update_stats=True`` (the
discriminator's own training step) stores it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vsrlab_tpu_torch.nn.blocks import Conv2d, SpectralConv
from vsrlab_tpu_torch.ops.resize import resize_bilinear


def _up2(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[1:3]
    return resize_bilinear(x, (h * 2, w * 2), align_corners=False)


class UNetDiscriminator(nn.Module):
    """``forward(img, update_stats=False)``: RGB frames ``(N, H, W, 3)`` (H, W
    multiples of 8) -> logits ``(N, H, W, 1)`` in the compute type.
    ``dtype`` may also be given by name (``"bfloat16"``), as a config does."""

    def __init__(self, mid_channels: int = 64, dtype: torch.dtype | str | None = None):
        super().__init__()
        dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        m = mid_channels
        self.conv_0 = Conv2d(3, m, 3, 1, 1, dtype=dtype)
        specs = ((m, 2 * m, 4, 2), (2 * m, 4 * m, 4, 2), (4 * m, 8 * m, 4, 2),
                 (8 * m, 4 * m, 3, 1), (4 * m, 2 * m, 3, 1), (2 * m, m, 3, 1), (m, m, 3, 1),
                 (m, m, 3, 1))
        for i, (cin, cout, k, s) in enumerate(specs, start=1):
            self.add_module(f"conv_{i}", SpectralConv(cin, cout, k, s, 1, dtype=dtype))
        self.conv_9 = Conv2d(m, 1, 3, 1, 1, dtype=dtype)

    def forward(self, img: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        def sconv(i, x):
            return F.leaky_relu(getattr(self, f"conv_{i}")(x, update_stats), 0.2)

        feat_0 = F.leaky_relu(self.conv_0(img), 0.2)
        feat_1 = sconv(1, feat_0)
        feat_2 = sconv(2, feat_1)
        feat_3 = _up2(sconv(3, feat_2))
        feat_4 = _up2(sconv(4, feat_3) + feat_2)
        feat_5 = _up2(sconv(5, feat_4) + feat_1)
        feat_6 = sconv(6, feat_5) + feat_0
        out = sconv(8, sconv(7, feat_6))
        return self.conv_9(out)
