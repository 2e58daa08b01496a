"""Trainable progressive SpyNet (port of
``vsrlab_tpu/models/flow/spynet_progressive.py``).

A stack of per-level :class:`~vsrlab_tpu_torch.models.spynet.SpyNetBasicModule`
heads: level ``k`` sees the frame pair resized to ``GConf(k)`` size
(``24*2^k x 32*2^k``) in curriculum training, or to ``full / 2^(levels-k)``
at inference, warps the second frame by the previous level's flow
(upsampled x2, values x2; border padding, ``align_corners``) and predicts a
residual. The warps run through the sampler of ``sampler_impl``
(``"fused"``: the hand-written kernel, with a gradient).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch
from torch import nn

from vsrlab_tpu_torch.models.spynet import SpyNetBasicModule
from vsrlab_tpu_torch.ops.resize import resize_bilinear
from vsrlab_tpu_torch.ops.warp import flow_warp

MAX_G = 5
BASE_SIZE = (24, 32)


class GConf:
    """Level ``k``'s training image size, ``(24*2^k, 32*2^k)``."""

    def __init__(self, level: int):
        if not 0 <= level <= MAX_G:
            raise ValueError(f"level {level} outside [0, {MAX_G}]")
        self.scale = 2**level

    @property
    def image_size(self) -> Tuple[int, int]:
        return (BASE_SIZE[0] * self.scale, BASE_SIZE[1] * self.scale)


class SpyNetProgressive(nn.Module):
    """``k``-level trainable pyramid; ``units[i]`` is level ``i``'s head.

    ``forward((f1, f2), train=True, limit_k=-1)``: with ``train`` every
    level resizes the pair to its GConf size, else to ``full /
    2^(k-1-level)``; ``limit_k`` runs only the first ``limit_k`` levels.
    Returns the flow of each level in ``return_levels``, finest first (one
    tensor for one level), ``(dx, dy)`` channels-last."""

    def __init__(self, k: int = 6, return_levels: Sequence[int] = (2, 3, 4), dtype=None):
        super().__init__()
        self.k, self.return_levels = k, tuple(return_levels)
        self.sampler_impl = "fused"
        self.units = nn.ModuleList(SpyNetBasicModule(dtype) for _ in range(k))

    def forward(self, frames, train: bool = True,
                limit_k: int = -1) -> Union[torch.Tensor, List[torch.Tensor]]:
        f1, f2 = frames
        _, h, w, _ = f1.shape
        levels = self.k - 1
        flow_list: List[torch.Tensor] = []
        v_prev = None
        for k in range(self.k if limit_k == -1 else limit_k):
            size = GConf(k).image_size if train else (h // 2 ** (levels - k), w // 2 ** (levels - k))
            x1 = resize_bilinear(f1, size, align_corners=True)
            x2 = resize_bilinear(f2, size, align_corners=True)
            if v_prev is not None:
                v_prev = resize_bilinear(v_prev, size, align_corners=True) * 2.0
                warped = flow_warp(x2, v_prev, padding_mode="border", impl=self.sampler_impl)
                inp = torch.cat([x1, warped, v_prev], -1)
            else:
                inp = torch.cat([x1, x2, x1.new_zeros(x1.shape[:3] + (2,))], -1)
            vk = self.units[k](inp)
            v_prev = vk + v_prev if v_prev is not None else vk
            if k in self.return_levels:
                flow_list.insert(0, v_prev)
        return flow_list[0] if len(self.return_levels) == 1 else flow_list
