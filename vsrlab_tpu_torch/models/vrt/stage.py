"""VRT Stage: TMSA groups + parallel flow-guided warping (port of
``vsrlab_tpu/models/vrt/stage.py``).

* reshape = space-to-channel (down) / channel-to-space (up) reshapes
  + LayerNorm + Linear;
* the parallel warping is batched: all T-1 frame alignments of a direction
  run as one flow_warp and one flow-guided deformable conv over a
  ``B*(T-1)`` batch, or, with ``align_chunks``, both directions as chunks
  of the ``2*B*(T-1)`` batch in a Python loop (same numerics, less memory);
* everything stays (B, D, H, W, C).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from vsrlab_tpu_torch.models.vrt.deform import FlowGuidedDeformAlign
from vsrlab_tpu_torch.models.vrt.tmsa import TMSAG
from vsrlab_tpu_torch.models.vrt.window_attention import MlpGEGLU
from vsrlab_tpu_torch.nn.blocks import LayerNorm, Linear
from vsrlab_tpu_torch.ops.warp import flow_warp


def flat_frames(clip: torch.Tensor) -> torch.Tensor:
    """(B, T, ...) -> (B*T, ...)."""
    return clip.reshape(-1, *clip.shape[2:])


class Stage(nn.Module):
    def __init__(self, in_dim: int, dim: int, depth: int, num_heads: int,
                 window_size: Sequence[int], mul_attn_ratio: float = 0.75,
                 mlp_ratio: float = 2.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop_path=0.0, pa_frames: int = 2,
                 deformable_groups: int = 16, reshape: str = "none",
                 max_residue_magnitude: float = 10.0, align_chunks: int = 0, dtype=None,
                 head_shard_axis: Optional[str] = None):
        super().__init__()
        self.reshape, self.align_chunks = reshape, align_chunks
        if reshape == "none":
            self.reshape_norm = LayerNorm(dim, dtype=dtype)
        elif reshape == "down":
            self.reshape_norm = LayerNorm(4 * in_dim, dtype=dtype)
            self.reshape_linear = Linear(4 * in_dim, dim, True, dtype)
        elif reshape == "up":
            self.reshape_norm = LayerNorm(in_dim // 4, dtype=dtype)
            self.reshape_linear = Linear(in_dim // 4, dim, True, dtype)
        else:
            raise ValueError(f"unknown reshape: {reshape}")
        depth1 = int(depth * mul_attn_ratio)
        dp_list = list(drop_path) if isinstance(drop_path, (list, tuple)) else [drop_path] * depth
        self.residual_group1 = TMSAG(
            dim, depth1, num_heads, (2, window_size[1], window_size[2]), None, True, mlp_ratio,
            qkv_bias, qk_scale, dp_list[:depth1], dtype, head_shard_axis)
        self.linear1 = Linear(dim, dim, True, dtype)
        self.residual_group2 = TMSAG(
            dim, depth - depth1, num_heads, tuple(window_size), None, False, mlp_ratio,
            qkv_bias, qk_scale, dp_list[depth1:], dtype, head_shard_axis)
        self.linear2 = Linear(dim, dim, True, dtype)
        self.pa_deform = FlowGuidedDeformAlign(dim, deformable_groups, max_residue_magnitude,
                                               pa_frames, dtype)
        self.pa_fuse = MlpGEGLU(3 * dim, 3 * dim, dim, dtype)

    def forward(self, x, flows_backward: List[torch.Tensor], flows_forward: List[torch.Tensor],
                deterministic: bool = True, generator: Optional[torch.Generator] = None):
        b, d, h, w, c = x.shape
        if self.reshape == "down":
            # space-to-channel 2x2, channel order (w-offset, h-offset, c)
            x = x.reshape(b, d, h // 2, 2, w // 2, 2, c).permute(0, 1, 2, 4, 5, 3, 6)
            x = x.reshape(b, d, h // 2, w // 2, 4 * c)
        elif self.reshape == "up":
            # channel-to-space 2x2
            x = x.reshape(b, d, h, w, 2, 2, c // 4).permute(0, 1, 2, 5, 3, 4, 6)
            x = x.reshape(b, d, 2 * h, 2 * w, c // 4)
        x = self.reshape_norm(x)
        if self.reshape != "none":
            x = self.reshape_linear(x)

        x = self.linear1(self.residual_group1(x, deterministic, generator)) + x
        x = self.linear2(self.residual_group2(x, deterministic, generator)) + x

        x_backward, x_forward = self._aligned_features(x, flows_backward[0], flows_forward[0])
        return self.pa_fuse(torch.cat([x, x_backward, x_forward], -1))

    def _warp_align(self, frames, flows, currents):
        return self.pa_deform(frames, [flow_warp(frames, flows)], currents, [flows])

    def _aligned_features(self, x, flow_backward, flow_forward):
        """Align neighbour frames with flow + deformable conv: backward is
        frame i+1 aligned towards i (i = 0..T-2), forward frame i-1
        towards i (i = 1..T-1)."""
        b, t, h, w, c = x.shape
        later, earlier = flat_frames(x[:, 1:]), flat_frames(x[:, :-1])
        if self.align_chunks > 1:
            # both directions share pa_deform, so they run as ONE batch cut
            # into chunks; every op is per sample
            frames = torch.cat([later, earlier], 0)
            flows = torch.cat([flat_frames(flow_backward), flat_frames(flow_forward)], 0)
            currents = torch.cat([earlier, later], 0)
            n = frames.shape[0]
            size = -(-n // min(self.align_chunks, n))
            aligned = torch.cat([
                self._warp_align(frames[s:s + size], flows[s:s + size], currents[s:s + size])
                for s in range(0, n, size)], 0).reshape(2, b, t - 1, h, w, c)
            aligned_b, aligned_f = aligned[0], aligned[1]
        else:
            aligned_b = self._warp_align(later, flat_frames(flow_backward), earlier)
            aligned_b = aligned_b.reshape(b, t - 1, h, w, c)
            aligned_f = self._warp_align(earlier, flat_frames(flow_forward), later)
            aligned_f = aligned_f.reshape(b, t - 1, h, w, c)
        x_backward = torch.cat([aligned_b, torch.zeros_like(x[:, -1:])], 1)
        x_forward = torch.cat([torch.zeros_like(x[:, :1]), aligned_f], 1)
        return x_backward, x_forward
