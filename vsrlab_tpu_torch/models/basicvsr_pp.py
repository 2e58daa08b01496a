"""BasicVSR++: second-order grid propagation with flow-guided deformable
alignment (Chan et al., CVPR 2022, arXiv:2104.13371; mmagic's
``basicvsr_plusplus_net.py``, its ``basicvsr-pp_c64n7`` configuration by
default).

* **Features.** ``spatial[i]`` = a :class:`~vsrlab_tpu_torch.nn.blocks.ResidualBlock`
  (3 -> C, 5 units) of each LR frame, batched over frames.
* **Flows.** Both directions of SpyNet between adjacent frames in one
  batched call (:func:`~vsrlab_tpu_torch.models.basicvsr.adjacent_flows`,
  BasicVSR's), kept in fp32, detached unless ``train_flow``.
* **Grid propagation.** Four branches in turn, ``backward_1``,
  ``forward_1``, ``backward_2``, ``forward_2``, each over the frames in its
  order. At step k >= 1 the state of the step before is warped by the
  flow of this step (``c1``); from k >= 2 the branch's output two steps
  back is warped by the composed flow ``f2 = f1 + warp(f_prev, f1)``
  (``c2``; zeros at k = 1). A
  :class:`~vsrlab_tpu_torch.models.vrt.deform.SecondOrderDeformableAlignment`
  aligns ``[state n-1, state n-2]`` under ``[c1, spatial, c2]`` and both
  flows; then ``state += ResidualBlock((2 + j) * C -> C, num_blocks)`` of
  ``[spatial, the earlier branches' outputs of this frame, state]``.
* **Reconstruction**, batched over frames: a ResidualBlock (5C -> C, 5
  units), ``log2(upscale)`` rounds of LeakyReLU(PixelShufflePack x2),
  LeakyReLU(``conv_hr``), ``conv_last`` and the bilinear upscale of the
  LR frame (corners not aligned) added.

Precision: bf16 compute (``dtype``) over fp32 parameters, fp32 flows;
the warps and the deformable conv's sampling run through the sampler of
``sampler_impl`` (``"fused"``: the hand-written kernel on a card, its plain
version on the CPU).

Departures from mmagic, with the same outputs: no ``cpu_cache`` (mmagic
turns it on only above 100 frames); no mirror-extension shortcut (it saves
one SpyNet pass on a clip that reads the same backwards, and needs a
blocking host read to find one). Streaming (``stream_state``,
``return_state``) and frames split over a mesh axis (``time_shard_axis``)
are refused.

Clips are ``(B, T, H, W, 3)`` in [0, 1]; the output is ``(B, T, sH, sW, 3)``.
While a profiler collects, the forward's stages are the spans
``model.extract``, ``model.flow``, ``model.propagate`` (with one
``model.propagate.<branch>`` a branch) and ``model.upsample``, and the
alignments count their calls in ``align.calls``
(:mod:`vsrlab_tpu_torch.utils.profiler`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vsrlab_tpu_torch.models.basicvsr import adjacent_flows
from vsrlab_tpu_torch.models.spynet import SpyNet
from vsrlab_tpu_torch.models.vrt.deform import SecondOrderDeformableAlignment
from vsrlab_tpu_torch.nn.blocks import Conv2d, PixelShufflePack, ResidualBlock
from vsrlab_tpu_torch.ops.resize import resize_bilinear
from vsrlab_tpu_torch.ops.warp import flow_warp
from vsrlab_tpu_torch.utils.profiler import annotate, count

BRANCHES = ("backward_1", "forward_1", "backward_2", "forward_2")


class BasicVSRPlusPlus(nn.Module):
    """BasicVSR++ at ``mid_channels`` C, ``num_blocks`` residual units a
    branch, ``deform_groups`` offset groups. ``train_flow=False`` detaches
    the flows (SpyNet frozen)."""

    def __init__(self, mid_channels: int = 64, num_blocks: int = 7,
                 max_residue_magnitude: float = 10.0, deform_groups: int = 16, upscale: int = 4,
                 train_flow: bool = False, time_shard_axis: Optional[str] = None, dtype=None):
        super().__init__()
        if time_shard_axis is not None:
            raise ValueError("BasicVSR++ does not split its frames over a mesh axis "
                             f"(time_shard_axis={time_shard_axis!r})")
        rounds = int(math.log2(upscale))
        if upscale < 2 or 2 ** rounds != upscale:
            raise ValueError(f"upscale must be a power of two, got {upscale}")
        self.mid_channels, self.upscale, self.train_flow = mid_channels, upscale, train_flow
        self.dtype = dtype
        self.sampler_impl = "fused"
        self.spynet = SpyNet(dtype=dtype)
        self.feat_extract = ResidualBlock(3, mid_channels, 5, dtype)
        self.deform_align = nn.ModuleDict({
            name: SecondOrderDeformableAlignment(2 * mid_channels, mid_channels, deform_groups,
                                                 max_residue_magnitude, dtype)
            for name in BRANCHES})
        self.backbone = nn.ModuleDict({
            name: ResidualBlock((2 + j) * mid_channels, mid_channels, num_blocks, dtype)
            for j, name in enumerate(BRANCHES)})
        self.reconstruction = ResidualBlock(5 * mid_channels, mid_channels, 5, dtype)
        self.upsample = nn.ModuleList(
            PixelShufflePack(mid_channels, mid_channels, 2, dtype) for _ in range(rounds))
        self.conv_hr = Conv2d(mid_channels, 64, 3, 1, 1, dtype=dtype)
        self.conv_last = Conv2d(64, 3, 3, 1, 1, dtype=dtype)

    def _warp(self, x, flow):
        return flow_warp(x, flow, impl=self.sampler_impl)

    def _propagate(self, name: str, spatial: List[torch.Tensor], earlier: List[List],
                   flows: Optional[torch.Tensor]) -> List[torch.Tensor]:
        """One branch over the frames in its order: each frame's state."""
        t = len(spatial)
        backward = name.startswith("backward")
        order = range(t - 1, -1, -1) if backward else range(t)
        align, backbone = self.deform_align[name], self.backbone[name]
        out: List[Optional[torch.Tensor]] = [None] * t
        state = torch.zeros_like(spatial[0])
        flow_prev = None
        for k, i in enumerate(order):
            if k > 0:
                flow = flows[:, i] if backward else flows[:, i - 1]
                cond_1 = self._warp(state, flow)
                if k > 1:
                    state_2 = out[order[k - 2]]
                    flow_2 = flow + self._warp(flow_prev, flow)
                    cond_2 = self._warp(state_2, flow_2)
                else:
                    state_2, flow_2 = torch.zeros_like(state), torch.zeros_like(flow)
                    cond_2 = torch.zeros_like(cond_1)
                state = align(torch.cat([state, state_2], -1),
                              torch.cat([cond_1, spatial[i], cond_2], -1), flow, flow_2)
                flow_prev = flow
            feat = torch.cat([spatial[i], *(e[i] for e in earlier), state], -1)
            state = state + backbone(feat)
            out[i] = state
        count("align.calls", t - 1)
        return out

    def forward(self, lrs, stream_state=None, return_state: bool = False):
        """Super-resolve whole clips ``(B, T, H, W, 3)``."""
        if stream_state is not None or return_state:
            raise ValueError("BasicVSR++ serves whole clips: its backward branches need every "
                             "frame, so it carries no streaming state")
        b, t, h, w, c = lrs.shape
        with annotate("model.extract"):
            spatial = self.feat_extract(lrs.reshape(b * t, h, w, c))
            frames = list(spatial.reshape(b, t, h, w, -1).unbind(1))
        flows_forward = flows_backward = None
        if t > 1:
            with annotate("model.flow"):
                flows_forward, flows_backward = adjacent_flows(self.spynet, lrs, self.train_flow)

        feats: Dict[str, List[torch.Tensor]] = {}
        with annotate("model.propagate"):
            for name in BRANCHES:
                with annotate(f"model.propagate.{name}"):
                    flows = flows_backward if name.startswith("backward") else flows_forward
                    feats[name] = self._propagate(name, frames, list(feats.values()), flows)

        with annotate("model.upsample"):
            out = torch.cat([spatial.reshape(b, t, h, w, -1),
                             *(torch.stack(feats.pop(n), 1) for n in BRANCHES)], -1)
            out = self.reconstruction(out.reshape(b * t, h, w, -1))
            for up in self.upsample:
                out = F.leaky_relu(up(out), 0.1)
            out = F.leaky_relu(self.conv_hr(out), 0.1)
            out = self.conv_last(out)
            s = self.upscale
            base = resize_bilinear(lrs.reshape(b * t, h, w, c), (h * s, w * s),
                                   align_corners=False)
            return (out + base).reshape(b, t, h * s, w * s, 3)
