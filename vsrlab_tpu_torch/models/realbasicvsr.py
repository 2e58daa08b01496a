"""RealBasicVSR: cleaning module + BasicVSR (port of ``vsrlab_tpu/models/realbasicvsr.py``).

An :class:`~vsrlab_tpu_torch.nn.blocks.IterativeRefinement` cleaner
removes compression artifacts from the low-res clip, then
:class:`~vsrlab_tpu_torch.models.basicvsr.BasicVSR` super-resolves it.
Returns ``(sr, lq)``, where ``lq`` is the cleaned input. The cleaning
passes are the span ``model.clean`` while a profiler collects.

With ``time_shard_axis`` (sequence-parallel training) the cleaner stays
per frame and local; BasicVSR's halo exchange hands the neighbours
cleaned frames, and their gradients reach the owner's cleaner.
"""

from __future__ import annotations

from typing import Optional

from torch import nn

from vsrlab_tpu_torch.models.basicvsr import BasicVSR
from vsrlab_tpu_torch.nn.blocks import IterativeRefinement
from vsrlab_tpu_torch.utils.profiler import annotate


class RealBasicVSR(nn.Module):
    """``frame_pack`` (and the BasicVSR TPU levers) are accepted and have no
    numeric effect: in the JAX package packing changes only the last ulp."""

    def __init__(self, mid_channels: int = 64, res_blocks: int = 30, cleaning_blocks: int = 20,
                 cleaning_steps: int = 3, upscale: int = 4, train_flow: bool = False,
                 remat: bool = False, fuse_directions: bool = True, block_unroll: int = 0,
                 time_unroll: int = 0, frame_pack: bool = True,
                 time_shard_axis: Optional[str] = None, dtype=None):
        super().__init__()
        self.cleaner = IterativeRefinement(mid_channels, cleaning_blocks, cleaning_steps,
                                           dtype=dtype)
        self.basicvsr = BasicVSR(mid_channels, res_blocks, upscale, train_flow, remat,
                                 fuse_directions, block_unroll, time_unroll, time_shard_axis,
                                 dtype=dtype)

    def forward(self, lr, stream_state=None, return_state: bool = False):
        """``(sr, lq)``; with ``return_state`` also the streaming state, whose
        frame is the CLEANED last frame (flows are computed on cleaned input)."""
        b, t, h, w, c = lr.shape
        with annotate("model.clean"):
            lq = self.cleaner(lr.reshape(b * t, h, w, c)).reshape(b, t, h, w, c)
        out = self.basicvsr(lq, stream_state=stream_state, return_state=return_state)
        if return_state:
            sr, state = out
            return sr, lq, state
        return out, lq
