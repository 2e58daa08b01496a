"""SpyNet coarse-to-fine optical-flow pyramid (port of ``vsrlab_tpu/models/spynet.py``).

A 6-level image pyramid (2x2 average pooling of ImageNet-normalised
frames); at each level the flow is upsampled x2 (bilinear,
``align_corners=True``, values doubled), the support frame is warped by
it (border padding) and a five-conv 7x7 head predicts a residual flow.
Inputs are bilinearly resized to a multiple of 32 and the output flow is
resized and rescaled back.

Frames are ``(N, H, W, 3)`` in [0, 1]; flows ``(N, H, W, 2)`` in ``(dx, dy)``.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
from torch import nn

from vsrlab_tpu_torch.nn.blocks import Conv2d
from vsrlab_tpu_torch.ops.pooling import avg_pool2d
from vsrlab_tpu_torch.ops.resize import resize_bilinear
from vsrlab_tpu_torch.ops.warp import flow_warp

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class SpyNetBasicModule(nn.Module):
    """Per-level flow head: five 7x7 convs 8->32->64->32->16->2, ReLU between."""

    CHANNELS = ((8, 32), (32, 64), (64, 32), (32, 16), (16, 2))

    def __init__(self, dtype=None):
        super().__init__()
        self.convs = nn.ModuleList(Conv2d(ci, co, 7, 1, 3, dtype=dtype) for ci, co in self.CHANNELS)

    def forward(self, x):
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if i < len(self.convs) - 1:
                x = torch.relu(x)
        return x


class SpyNet(nn.Module):
    """6-level SpyNet pyramid.

    ``return_levels``: the pyramid levels to emit; level 5 is full
    resolution, level ``k`` is 1/2^(5-k) scale. One level returns one
    tensor, several a list ordered fine to coarse.
    """

    def __init__(self, return_levels: Sequence[int] = (5,), levels: int = 6, dtype=None):
        super().__init__()
        self.return_levels = tuple(return_levels)
        self.levels = levels
        self.basic_module = nn.ModuleList(SpyNetBasicModule(dtype) for _ in range(levels))

    def _build_pyramid(self, x, h_up: int, w_up: int) -> List[torch.Tensor]:
        """Resize to the /32 multiple, normalise, pool ``levels - 1`` times.
        Returns coarse to fine."""
        if (h_up, w_up) != tuple(x.shape[1:3]):
            x = resize_bilinear(x, (h_up, w_up), align_corners=False)
        mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
        std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
        pyr = [(x - mean) / std]
        for _ in range(self.levels - 1):
            pyr.append(avg_pool2d(pyr[-1], 2, 2))
        return pyr[::-1]

    def _flows(self, ref_pyr, supp_pyr, h: int, w: int, h_up: int, w_up: int):
        """Coarse-to-fine refinement over prebuilt pyramids."""
        n = ref_pyr[0].shape[0]
        flows_out: List[torch.Tensor] = []
        flow = ref_pyr[0].new_zeros((n, h_up // 32, w_up // 32, 2))
        for level in range(self.levels):
            if level == 0:
                # zero flow and border padding: the warp is an exact identity
                flow_up, warped = flow, supp_pyr[0]
            else:
                lh, lw = ref_pyr[level].shape[1:3]
                flow_up = resize_bilinear(flow, (lh, lw), align_corners=True) * 2.0
                warped = flow_warp(supp_pyr[level], flow_up, padding_mode="border")
            residue = self.basic_module[level](torch.cat([ref_pyr[level], warped, flow_up], -1))
            flow = flow_up + residue

            if level in self.return_levels:
                scale = 2 ** (self.levels - 1 - level)
                out = resize_bilinear(flow, (h // scale, w // scale), align_corners=False)
                sx = float(w // scale) / float(w_up // scale)
                sy = float(h // scale) / float(h_up // scale)
                out = out * torch.tensor([sx, sy], dtype=out.dtype, device=out.device)
                flows_out.insert(0, out)
        return flows_out[0] if len(flows_out) == 1 else flows_out

    @staticmethod
    def _up32(h: int, w: int):
        return int(math.ceil(h / 32.0) * 32), int(math.ceil(w / 32.0) * 32)

    def forward(self, ref, supp):
        """Flow from ``ref`` to ``supp``, both ``(N, H, W, 3)``."""
        n, h, w, _ = ref.shape
        h_up, w_up = self._up32(h, w)
        # one pyramid for both stacks: every pyramid op is per-plane
        pyr = self._build_pyramid(torch.cat([ref, supp], 0), h_up, w_up)
        return self._flows([p[:n] for p in pyr], [p[n:] for p in pyr], h, w, h_up, w_up)

    def adjacent_pairs(self, frames, t: int, backward: slice = slice(None),
                       forward: slice = slice(None)):
        """Both-direction flows for adjacent frame pairs of clips.

        ``frames`` is ``(B*t, H, W, 3)`` (clips flattened row-major). The
        pyramid is built once on the unique frames. Output layout matches
        ``forward(cat([f[:-1], f[1:]]), cat([f[1:], f[:-1]]))``: the first
        half are backward flows (ref = earlier frame), the second half
        forward flows. ``backward`` and ``forward`` pick the pairs (pair i
        is frames i, i+1 of each clip) whose flow of that direction is
        computed: all by default.
        """
        bt, h, w, _ = frames.shape
        b = bt // t
        h_up, w_up = self._up32(h, w)
        ref_pyr, supp_pyr = [], []
        for p in self._build_pyramid(frames, h_up, w_up):
            pb = p.reshape(b, t, *p.shape[1:])
            earlier, later = pb[:, :-1], pb[:, 1:]

            def flat(clips):
                return clips.reshape(-1, *p.shape[1:])

            ref_pyr.append(torch.cat([flat(earlier[:, backward]), flat(later[:, forward])], 0))
            supp_pyr.append(torch.cat([flat(later[:, backward]), flat(earlier[:, forward])], 0))
        return self._flows(ref_pyr, supp_pyr, h, w, h_up, w_up)
