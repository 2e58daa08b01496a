"""BasicVSR: bidirectional recurrent video super-resolution
(port of ``vsrlab_tpu/models/basicvsr.py``).

* Both flow directions come from one batched SpyNet call over all
  adjacent pairs (``SpyNet.adjacent_pairs``).
* The backward, then the forward recurrence run as Python loops over
  time. Each step warps the hidden state by the flow (bilinear, zero
  padding), concatenates ``[lr_t, warped]`` and runs a
  :class:`~vsrlab_tpu_torch.nn.blocks.ResidualBlock`. The first step of
  each direction warps a zero state by a zero flow, which gives zeros, so
  every step has the same body.
* Fusion and upsampling (1x1 ``point_conv``, 2x ``PixelShufflePack``,
  ``conv_hr``, ``conv_last``, plus the bilinear base) run batched over
  all frames.
* ``time_shard_axis`` (sequence-parallel training): inside
  ``parallel.use_mesh`` of a mesh with that axis, each rank holds its
  block of every clip's frames (``parallel.shard_batch_sp``). Its
  neighbours on the axis hand it their edge frames, so that its flows
  reach across the block's edges, and the recurrences run rank after
  rank: the backward one takes its carry from the next rank and hands its
  last to the previous one, the forward one the other way (the JAX
  package leaves these exchanges to XLA's partitioner). The first and
  last ranks keep the zero flows and zero carries of the clip's ends, so
  the outputs and, through the exchanges' backward, the gradients are one
  process's.

Clips are ``(B, T, H, W, 3)`` in [0, 1]; the output is ``(B, T, sH, sW, 3)``.
While a profiler collects, the forward's stages are the spans ``model.flow``,
``model.propagate`` and ``model.upsample`` (``utils.profiler.annotate``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vsrlab_tpu_torch.models.spynet import SpyNet
from vsrlab_tpu_torch.nn.blocks import Conv2d, PixelShufflePack, ResidualBlock
from vsrlab_tpu_torch.ops.resize import resize_bilinear
from vsrlab_tpu_torch.ops.warp import flow_warp
from vsrlab_tpu_torch.parallel import active_links
from vsrlab_tpu_torch.utils.profiler import annotate


def adjacent_flows(spynet: SpyNet, lrs, train_flow: bool = False, prev=None, next_frame=None):
    """``(flows_forward, flows_backward)``, each ``(B, T-1, H, W, 2)``:
    ``flows_backward[:, i]`` is the flow from frame ``i`` to ``i + 1``,
    ``flows_forward[:, i]`` from ``i + 1`` to ``i``, both directions from one
    batched call of ``spynet``; detached unless ``train_flow``.

    With ``prev`` (streaming: the previous window's last frame; split
    over time: the previous rank's, ``(B, H, W, 3)``) the forward flows
    gain the ``prev -> frame0`` flow as their first entry (``T``
    entries). With ``next_frame`` (the next rank's first frame) the
    backward flows gain the ``frame[-1] -> next_frame`` flow as their
    last. The pairs' other directions are the neighbours' and dropped.
    """
    b, t, h, w, c = lrs.shape
    frames = [lrs]
    if prev is not None:
        frames.insert(0, prev[:, None])
    if next_frame is not None:
        frames.append(next_frame[:, None])
    frames = torch.cat(frames, 1) if len(frames) > 1 else lrs
    t = frames.shape[1]
    flows = spynet.adjacent_pairs(frames.reshape(-1, h, w, c), t)
    if not train_flow:
        flows = flows.detach()
    fb, ff = flows.chunk(2, 0)
    flows_backward = fb.reshape(b, t - 1, h, w, 2)
    flows_forward = ff.reshape(b, t - 1, h, w, 2)
    if prev is not None:
        flows_backward = flows_backward[:, 1:]
    if next_frame is not None:
        flows_forward = flows_forward[:, :-1]
    return flows_forward, flows_backward


class BasicVSR(nn.Module):
    """Bidirectional recurrent VSR network.

    ``train_flow=False`` detaches the flows (SpyNet frozen). ``remat``,
    ``fuse_directions``, ``block_unroll`` and ``time_unroll`` are the JAX
    package's TPU levers; they are accepted and have no numeric effect.
    ``time_shard_axis`` names the mesh axis that splits the frames inside
    ``parallel.use_mesh`` (outside one, or where the axis has one rank,
    the forward is the unsplit one).
    """

    def __init__(self, mid_channels: int = 64, res_blocks: int = 30, upscale: int = 4,
                 train_flow: bool = False, remat: bool = False, fuse_directions: bool = True,
                 block_unroll: int = 0, time_unroll: int = 0,
                 time_shard_axis: Optional[str] = None, dtype=None):
        super().__init__()
        self.mid_channels, self.upscale, self.train_flow = mid_channels, upscale, train_flow
        self.time_shard_axis = time_shard_axis
        self.dtype = dtype
        self.spynet = SpyNet(dtype=dtype)
        self.backward_resblocks = ResidualBlock(3 + mid_channels, mid_channels, res_blocks, dtype)
        self.forward_resblocks = ResidualBlock(3 + mid_channels, mid_channels, res_blocks, dtype)
        self.point_conv = Conv2d(2 * mid_channels, mid_channels, 1, 1, 0, dtype=dtype)
        self.upsample = nn.ModuleList(
            PixelShufflePack(mid_channels, mid_channels, 2, dtype) for _ in range(upscale // 2))
        # 64 outputs whatever mid_channels is, as in the JAX model
        self.conv_hr = Conv2d(mid_channels, 64, 3, 1, 1, dtype=dtype)
        self.conv_last = Conv2d(64, 3, 3, 1, 1, dtype=dtype)

    def compute_flow(self, lrs, prev=None, next_frame=None):
        """``(flows_forward, flows_backward)`` of :func:`adjacent_flows`
        through this model's SpyNet."""
        return adjacent_flows(self.spynet, lrs, self.train_flow, prev, next_frame)

    @staticmethod
    def _step(block, feat, lr_t, flow_t):
        warped = flow_warp(feat, flow_t)
        return block(torch.cat([lr_t, warped], -1))

    def _propagate(self, lrs, bwd_flows, fwd_flows, stream_state, links):
        """The backward, then the forward recurrence: ``(last forward
        carry, [B, H, W, 2 * mid] features of each frame)``."""
        b, t, h, w, _ = lrs.shape
        feat0 = lrs.new_zeros((b, h, w, self.mid_channels), dtype=self.dtype or lrs.dtype)
        feat = feat0 if links is None else links.receive("backward", feat0)
        outputs_backward = [None] * t
        for i in range(t - 1, -1, -1):
            feat = self._step(self.backward_resblocks, feat, lrs[:, i], bwd_flows[:, i])
            if i == 0 and links is not None:
                feat = links.send("backward", feat)
            outputs_backward[i] = feat

        feat = feat0 if stream_state is None else stream_state[1].to(feat0.dtype)
        if links is not None:
            feat = links.receive("forward", feat0)
        outputs = []
        for i in range(t):
            feat = self._step(self.forward_resblocks, feat, lrs[:, i], fwd_flows[:, i])
            if i == t - 1 and links is not None:
                feat = links.send("forward", feat)
            outputs.append(torch.cat([outputs_backward[i], feat], -1))
            outputs_backward[i] = None  # free as we go
        return feat, outputs

    def forward(self, lrs, stream_state=None, return_state: bool = False):
        """Super-resolve a clip.

        ``stream_state = (last_input_frame, forward_carry)`` from the
        previous window seeds the forward recurrence, so its hidden states
        equal a full-clip run's; the backward recurrence restarts per
        window. ``return_state`` also returns this window's state. Neither
        combines with frames split over ``time_shard_axis``.
        """
        b, t, h, w, c = lrs.shape
        links = active_links(self.time_shard_axis)
        prev = next_frame = None
        if links is not None:
            if stream_state is not None or return_state:
                raise ValueError("streaming state does not combine with frames split over "
                                 f"{self.time_shard_axis!r}")
            links.wait()
            prev, next_frame = links.halo(lrs[:, 0], lrs[:, -1])
        elif stream_state is not None:
            prev = stream_state[0]
        with annotate("model.flow"):
            flows_forward, flows_backward = self.compute_flow(lrs, prev, next_frame)
        zero_flow = flows_forward.new_zeros((b, 1, h, w, 2))
        # step i of each recurrence uses [:, i]
        bwd_flows = flows_backward if next_frame is not None else \
            torch.cat([flows_backward, zero_flow], 1)
        fwd_flows = flows_forward if prev is not None else torch.cat([zero_flow, flows_forward], 1)

        with annotate("model.propagate"):
            feat, outputs = self._propagate(lrs, bwd_flows, fwd_flows, stream_state, links)
        with annotate("model.upsample"):
            out = torch.stack(outputs, 1).reshape(b * t, h, w, -1)
            del outputs
            out = F.leaky_relu(self.point_conv(out), 0.1)
            for up in self.upsample:
                out = up(out)
            out = F.leaky_relu(self.conv_hr(out), 0.1)
            out = self.conv_last(out)
            s = self.upscale
            base = resize_bilinear(lrs.reshape(b * t, h, w, c), (h * s, w * s),
                                   align_corners=False)
            out = (out + base).reshape(b, t, h * s, w * s, 3)
        if links is not None:
            links.wait()
        if return_state:
            return out, (lrs[:, -1], feat)
        return out
