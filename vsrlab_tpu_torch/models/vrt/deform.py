"""Flow-guided modulated deformable alignment (port of
``vsrlab_tpu/models/vrt/deform.py``), and BasicVSR++'s second-order
alignment beside it.

* a 4-layer conv stack predicts, from the warped features, the current
  frame's features and the flows, per-tap offset residues and modulation
  masks;
* offsets = ``max_residue_magnitude * tanh(residue)`` + the (dy, dx) flow
  prior tiled over taps and groups; masks = sigmoid;
* the deformable 3x3 conv is
  :func:`vsrlab_tpu_torch.ops.deform.modulated_deform_conv2d`: per-tap
  bilinear sampling through the sampler kernels plus one matmul.

:class:`FlowGuidedDeformAlign` (VRT) adds ``flows[0]`` to every group's
offsets. :class:`SecondOrderDeformableAlignment` (BasicVSR++, Chan et al.,
arXiv:2104.13371) aligns the states of the two steps before over
``2 * C`` channels: the first half of the offset groups takes the flow to
frame n-1 as its prior, the second half the composed flow to frame n-2.

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
from vsrlab_tpu_torch.utils.graphs import GraphedCall


class _DeformAlign(nn.Module):
    """The offset head (three 3x3 convs with LeakyReLU 0.1, then a zero-
    initialised conv to ``3 * 9 * groups`` channels) and the deformable
    conv's HWIO weight ``(3, 3, in_channels, out_channels)`` and bias.
    ``sampler_impl`` picks the sampler's formulation: ``"fused"`` (the
    default), ``"take"`` or ``"plain"``."""

    TAPS = 9

    def __init__(self, in_channels: int, out_channels: int, cond_channels: int,
                 deformable_groups: int, max_residue_magnitude: float, dtype=None):
        super().__init__()
        self.deformable_groups = deformable_groups
        self.max_residue_magnitude = max_residue_magnitude
        self.sampler_impl = "fused"
        self.conv_offset_0 = Conv2d(cond_channels, out_channels, 3, 1, 1, dtype=dtype)
        self.conv_offset_1 = Conv2d(out_channels, out_channels, 3, 1, 1, dtype=dtype)
        self.conv_offset_2 = Conv2d(out_channels, out_channels, 3, 1, 1, dtype=dtype)
        # the offset / mask head starts at zero: alignment starts as the
        # plain flow-guided warp
        self.conv_offset_3 = Conv2d(out_channels, 3 * self.TAPS * deformable_groups, 3, 1, 1,
                                    dtype=dtype, zero_init=True)
        self.weight = nn.Parameter(torch.empty(3, 3, in_channels, out_channels))  # HWIO
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[2] * self.TAPS)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.zero_()

    def residues(self, feat):
        """``(max_residue_magnitude * tanh(residue), mask logits)`` of the
        offset head on ``feat``, in the compute type."""
        for conv in (self.conv_offset_0, self.conv_offset_1, self.conv_offset_2):
            feat = F.leaky_relu(conv(feat), 0.1)
        o1, o2, mask = self.conv_offset_3(feat).chunk(3, -1)
        return self.max_residue_magnitude * torch.tanh(torch.cat([o1, o2], -1)), mask

    def deform(self, x, offset, mask):
        return modulated_deform_conv2d(x, offset, torch.sigmoid(mask), self.weight, self.bias,
                                       stride=1, padding=1, impl=self.sampler_impl)


class FlowGuidedDeformAlign(_DeformAlign):
    """VRT's alignment of ``channels`` features: the condition is the
    warped neighbours, the current frame and ``pa_frames`` flow channels;
    every group's offsets take ``flows[0]`` as their prior (added in the
    compute type)."""

    def __init__(self, channels: int, deformable_groups: int = 16,
                 max_residue_magnitude: float = 10.0, pa_frames: int = 2, dtype=None):
        n_in = (1 + pa_frames // 2) * channels + pa_frames
        super().__init__(channels, channels, n_in, deformable_groups, max_residue_magnitude,
                         dtype)

    def forward(self, x, x_flow_warpeds: List[torch.Tensor], x_current,
                flows: List[torch.Tensor]):
        feat = torch.cat([*x_flow_warpeds, x_current, *(f.to(x_current.dtype) for f in flows)],
                         -1)
        offset, mask = self.residues(feat)
        flow_yx = flows[0].flip(-1).to(offset.dtype)  # (dx, dy) -> (dy, dx)
        offset = offset + flow_yx.repeat(1, 1, 1, self.TAPS * self.deformable_groups)
        return self.deform(x, offset, mask)


class SecondOrderDeformableAlignment(_DeformAlign):
    """BasicVSR++'s alignment: ``x`` is ``[state n-1, state n-2]``
    (``in_channels`` = 2 * C), ``cond`` is ``[state n-1 warped by flow_1,
    the current frame's features, state n-2 warped by flow_2]`` (3 * C),
    ``flow_1`` the flow to frame n-1 and ``flow_2`` the composed flow to
    frame n-2 (fp32). The offsets of the first half of the groups take
    ``flow_1`` as their prior, the second half ``flow_2``; the prior is
    added in fp32 to the residues of the compute type. Returns
    ``out_channels`` features.

    On a card without a gradient the alignment replays a CUDA graph of its
    call (:class:`vsrlab_tpu_torch.utils.graphs.GraphedCall`: a graph a
    shape, the same kernels and bits as the eager call), so that the host
    does not pace BasicVSR++'s chain of 4 x (T - 1) alignments.
    """

    def __init__(self, in_channels: int = 128, out_channels: int = 64,
                 deformable_groups: int = 16, max_residue_magnitude: float = 10.0, dtype=None):
        if deformable_groups % 2:
            raise ValueError("the two flow priors need an even number of offset groups")
        super().__init__(in_channels, out_channels, 3 * out_channels + 4, deformable_groups,
                         max_residue_magnitude, dtype)
        self._graphed = GraphedCall(self._align, self)

    def forward(self, x, cond, flow_1, flow_2):
        return self._graphed(x, cond, flow_1, flow_2, extra=self.sampler_impl)

    def _align(self, x, cond, flow_1, flow_2):
        feat = torch.cat([cond, flow_1.to(cond.dtype), flow_2.to(cond.dtype)], -1)
        offset, mask = self.residues(feat)
        tiles = self.TAPS * self.deformable_groups // 2
        prior = torch.cat([flow_1.flip(-1).float().repeat(1, 1, 1, tiles),
                           flow_2.flip(-1).float().repeat(1, 1, 1, tiles)], -1)
        return self.deform(x, offset.float() + prior, mask)
