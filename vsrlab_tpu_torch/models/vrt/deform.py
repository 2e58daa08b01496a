"""Flow-guided modulated deformable alignment (port of
``vsrlab_tpu/models/vrt/deform.py``).

* a 4-layer conv stack predicts, from [warped features, current frame
  features, flow], per-tap offset residues and modulation masks;
* offsets = ``max_residue_magnitude * tanh(residue)`` + the (dy, dx) flow
  prior tiled over taps and groups; masks = sigmoid;
* the deformable 3x3 conv is
  :func:`vsrlab_tpu_torch.ops.deform.modulated_deform_conv2d`: per-tap
  bilinear sampling through the packed-gather kernels plus one matmul.

Channels-last: features (N, H, W, C), flows (N, H, W, 2) in (dx, dy).
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from vsrlab_tpu_torch.nn.blocks import Conv2d
from vsrlab_tpu_torch.ops.deform import modulated_deform_conv2d


class FlowGuidedDeformAlign(nn.Module):
    """``sampler_impl`` picks the sampler's formulation: ``"fused"`` (the
    default), ``"take"`` or ``"plain"``."""

    TAPS = 9

    def __init__(self, channels: int, deformable_groups: int = 16,
                 max_residue_magnitude: float = 10.0, pa_frames: int = 2, dtype=None):
        super().__init__()
        self.deformable_groups = deformable_groups
        self.max_residue_magnitude = max_residue_magnitude
        self.sampler_impl = "fused"
        n_in = (1 + pa_frames // 2) * channels + pa_frames
        self.conv_offset_0 = Conv2d(n_in, channels, 3, 1, 1, dtype=dtype)
        self.conv_offset_1 = Conv2d(channels, channels, 3, 1, 1, dtype=dtype)
        self.conv_offset_2 = Conv2d(channels, channels, 3, 1, 1, dtype=dtype)
        # the offset / mask head starts at zero: alignment starts as the
        # plain flow-guided warp
        self.conv_offset_3 = Conv2d(channels, 3 * self.TAPS * deformable_groups, 3, 1, 1,
                                    dtype=dtype, zero_init=True)
        self.weight = nn.Parameter(torch.empty(3, 3, channels, channels))  # HWIO
        self.bias = nn.Parameter(torch.zeros(channels))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[2] * self.TAPS)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.zero_()

    def forward(self, x, x_flow_warpeds: List[torch.Tensor], x_current,
                flows: List[torch.Tensor]):
        feat = torch.cat([*x_flow_warpeds, x_current, *(f.to(x_current.dtype) for f in flows)],
                         -1)
        for conv in (self.conv_offset_0, self.conv_offset_1, self.conv_offset_2):
            feat = F.leaky_relu(conv(feat), 0.1)
        o1, o2, mask = self.conv_offset_3(feat).chunk(3, -1)
        offset = self.max_residue_magnitude * torch.tanh(torch.cat([o1, o2], -1))
        flow_yx = flows[0].flip(-1).to(offset.dtype)  # (dx, dy) -> (dy, dx)
        offset = offset + flow_yx.repeat(1, 1, 1, self.TAPS * self.deformable_groups)
        return modulated_deform_conv2d(x, offset, torch.sigmoid(mask), self.weight, self.bias,
                                       stride=1, padding=1, impl=self.sampler_impl)
