"""VRT / TinyVRT (port of ``vsrlab_tpu/models/vrt/vrt.py``).

Multi-scale SpyNet flows, nearest4-warped neighbour frames concatenated
onto the input (9*C channels), a U-shaped stack of Stages with skip
connections, an RTMSA reconstruction trunk, and a pixel-shuffle
upsampling ladder with a bilinear input residual.

* clips are (B, T, H, W, C);
* (1, 3, 3) Conv3d layers are 2-D convs over ``B*T`` flattened frames;
* both flow directions come from ONE batched SpyNet call;
* full VRT uses 4 SpyNet levels, TinyVRT 3.

``forward(x, deterministic=True, generator=None)`` returns ``(sr, lq)``
as the JAX package does; outside deterministic mode the stochastic depth
(``drop_path_rate``, spread over the blocks by ``np.linspace``) draws from
``generator``. The deformable alignment's sampler runs on the hand-written
kernels under a gradient too; its formulation is set with
:func:`vsrlab_tpu_torch.nn.blocks.set_sampler_impl` (``"fused"`` by
default). SpyNet's flows carry no gradient unless ``optical_flow_train``
(the JAX package's stop-gradient). ``remat`` recomputes each Stage and
each trunk RTMSA in the backward pass (``torch.utils.checkpoint``,
non-reentrant), the units the JAX package rematerialises: its kernels
then launch again in the backward, and each launch counts.
``head_shard_axis`` reaches every ``WindowAttention``: inside
``parallel.use_mesh`` of a mesh with that axis the heads are split over
its ranks (every rank loads the whole ``state_dict``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vsrlab_tpu_torch.models.spynet import SpyNet
from vsrlab_tpu_torch.models.vrt.stage import Stage, flat_frames
from vsrlab_tpu_torch.models.vrt.tmsa import RTMSA
from vsrlab_tpu_torch.nn.blocks import Conv2d, LayerNorm, Linear
from vsrlab_tpu_torch.ops.pixel_shuffle import pixel_shuffle
from vsrlab_tpu_torch.ops.resize import resize_bilinear
from vsrlab_tpu_torch.ops.warp import flow_warp

NUM_FEAT = 64  # reconstruction width


class _VRTBase(nn.Module):
    """Shared VRT implementation; VRT and TinyVRT fix the U-shape
    (``reshapes``, ``scales``, ``flow_levels``, and which flow scale and
    skip connection each stage takes)."""

    reshapes: Sequence[str] = ()
    scales: Sequence[int] = ()
    flow_levels: Sequence[int] = ()

    def __init__(self, upscale: int = 4, in_chans: int = 3, out_chans: int = 3,
                 img_size: Sequence[int] = (6, 64, 64), window_size: Sequence[int] = (6, 8, 8),
                 depths: Sequence[int] = (8, 8, 8, 8, 8, 4, 4),
                 indep_reconsts: Sequence[int] = (-2, -1),
                 embed_dims: Sequence[int] = (64, 64, 64, 64, 64, 80, 80),
                 num_heads: Sequence[int] = (6, 6, 6, 6, 6, 6, 6), mul_attn_ratio: float = 0.75,
                 mlp_ratio: float = 2.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop_path_rate: float = 0.2,
                 optical_flow_train: bool = False, pa_frames: int = 2,
                 deformable_groups: int = 16, head_shard_axis: Optional[str] = None,
                 remat: bool = False, align_chunks: int = 0, dtype=None):
        super().__init__()
        del img_size  # the parameters do not depend on the clip's shape
        self.upscale, self.dtype = upscale, dtype
        self.optical_flow_train, self.remat = optical_flow_train, remat
        depths, dims = list(depths), list(embed_dims)
        ns = len(self.scales)
        dpr = list(np.linspace(0, drop_path_rate, sum(depths)))
        self.optical_flow = SpyNet(return_levels=tuple(self.flow_levels), dtype=dtype)
        self.conv_first = Conv2d(in_chans * (1 + 2 * 4), dims[0], 3, 1, 1, dtype=dtype)
        for i in range(ns):
            self.add_module(f"stage{i + 1}", Stage(
                in_dim=dims[i - 1], dim=dims[i], depth=depths[i], num_heads=num_heads[i],
                window_size=window_size, mul_attn_ratio=mul_attn_ratio, mlp_ratio=mlp_ratio,
                qkv_bias=qkv_bias, qk_scale=qk_scale,
                drop_path=dpr[sum(depths[:i]):sum(depths[:i + 1])], pa_frames=pa_frames,
                deformable_groups=deformable_groups, reshape=self.reshapes[i],
                max_residue_magnitude=10.0 / self.scales[i], align_chunks=align_chunks,
                dtype=dtype, head_shard_axis=head_shard_axis))
        self.trunk_norm_in = LayerNorm(dims[ns - 1], dtype=dtype)
        self.trunk_linear_in = Linear(dims[ns - 1], dims[ns], True, dtype)
        indep = [i % len(depths) for i in indep_reconsts]
        self.trunk_ids = list(range(ns, len(depths)))
        for i in self.trunk_ids:
            ws = (1, window_size[1], window_size[2]) if i in indep else tuple(window_size)
            self.add_module(f"trunk_rtmsa_{i}", RTMSA(
                dims[i], depths[i], num_heads[i], ws, mlp_ratio, qkv_bias, qk_scale,
                dpr[sum(depths[:i]):sum(depths[:i + 1])], dtype, head_shard_axis))
        self.norm = LayerNorm(dims[-1], dtype=dtype)
        self.conv_after_body = Linear(dims[-1], dims[0], True, dtype)
        self.conv_before_upsample = Conv2d(dims[0], NUM_FEAT, 3, 1, 1, dtype=dtype)
        self.n_ups = int(math.log2(upscale))
        for i in range(self.n_ups):
            self.add_module(f"up_conv_{i}", Conv2d(NUM_FEAT, 4 * NUM_FEAT, 3, 1, 1, dtype=dtype))
        self.up_conv_out = Conv2d(NUM_FEAT, NUM_FEAT, 3, 1, 1, dtype=dtype)
        self.conv_last = Conv2d(NUM_FEAT, out_chans, 3, 1, 1, dtype=dtype)

    def stage(self, i: int) -> Stage:
        """Stage ``i`` (0-based)."""
        return getattr(self, f"stage{i + 1}")

    @staticmethod
    def _frame_conv(conv, x):
        """(1,3,3) Conv3d as a per-frame 3x3 conv over flattened frames."""
        b, t = x.shape[:2]
        y = conv(flat_frames(x))
        return y.reshape(b, t, *y.shape[1:])

    def _get_flows(self, x) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Multi-scale flows, fine to coarse, both directions in one SpyNet
        batch; without ``optical_flow_train`` SpyNet runs without a
        gradient (its parameters get none: the JAX stop-gradient)."""
        b, t, h, w, c = x.shape
        with torch.set_grad_enabled(torch.is_grad_enabled() and self.optical_flow_train):
            flows = self.optical_flow.adjacent_pairs(x.reshape(-1, h, w, c), t)
        if not isinstance(flows, list):
            flows = [flows]
        backward, forward = [], []
        for i, f in enumerate(flows):
            fb, ff = f.chunk(2, 0)
            s = 2 ** i
            backward.append(fb.reshape(b, t - 1, h // s, w // s, 2))
            forward.append(ff.reshape(b, t - 1, h // s, w // s, 2))
        return backward, forward

    @staticmethod
    def _aligned_image(x, flow_backward, flow_forward):
        """nearest4 neighbour warping, batched over frames."""
        b, t, h, w, c = x.shape
        zeros = x.new_zeros((b, 1, h, w, 4 * c))
        wb = flow_warp(flat_frames(x[:, 1:]), flat_frames(flow_backward), "nearest4")
        wf = flow_warp(flat_frames(x[:, :-1]), flat_frames(flow_forward), "nearest4")
        return (torch.cat([wb.reshape(b, t - 1, h, w, 4 * c), zeros], 1),
                torch.cat([zeros, wf.reshape(b, t - 1, h, w, 4 * c)], 1))

    def _forward_features(self, x, fb, ff, det, gen):
        raise NotImplementedError

    def _unit(self, module, *args, deterministic: bool, generator):
        """Call a Stage or a trunk RTMSA, through a non-reentrant checkpoint
        where ``remat`` is set and a gradient is recorded. A stochastic
        call draws a seed for the unit from ``generator`` here, outside the
        checkpoint, and the unit draws its paths from a generator of that
        seed: the recompute drops the same paths, with or without remat."""
        seed = None
        if not deterministic and generator is not None:
            seed = int(torch.randint(2**62, (), generator=generator, device=generator.device))

        def run(*a):
            gen = None if seed is None else torch.Generator().manual_seed(seed)
            return module(*a, deterministic=deterministic, generator=gen)

        if self.remat and torch.is_grad_enabled():
            return checkpoint(run, *args, use_reentrant=False)
        return run(*args)

    def _stage_call(self, i, x, fb, ff, det, gen):
        return self._unit(self.stage(i), x, fb, ff, deterministic=det, generator=gen)

    def _trunk(self, x, det, gen):
        """LN + Linear, then the RTMSA blocks and the final norm."""
        x = self.trunk_linear_in(self.trunk_norm_in(x))
        for i in self.trunk_ids:
            x = self._unit(getattr(self, f"trunk_rtmsa_{i}"), x, deterministic=det,
                           generator=gen)
        return self.norm(x)

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        b, t, h, w, c = x.shape
        x_lq = x
        flows_backward, flows_forward = self._get_flows(x)
        x_b, x_f = self._aligned_image(x, flows_backward[0], flows_forward[0])
        feat = self._frame_conv(self.conv_first, torch.cat([x, x_b, x_f], -1))
        body = self._forward_features(feat, flows_backward, flows_forward, deterministic,
                                      generator)
        feat = feat + self.conv_after_body(body)

        y = F.leaky_relu(self._frame_conv(self.conv_before_upsample, feat), 0.01)
        for i in range(self.n_ups):
            y = self._frame_conv(getattr(self, f"up_conv_{i}"), y)
            bt, tt, hh, ww, cc = y.shape
            y = pixel_shuffle(y.reshape(bt * tt, hh, ww, cc), 2)
            y = F.leaky_relu(y.reshape(bt, tt, hh * 2, ww * 2, NUM_FEAT), 0.1)
        y = self._frame_conv(self.conv_last, self._frame_conv(self.up_conv_out, y))

        s = self.upscale
        base = resize_bilinear(x_lq.reshape(b * t, h, w, c), (h * s, w * s), align_corners=False)
        return y + base.reshape(b, t, h * s, w * s, c), x_lq


class VRT(_VRTBase):
    """Full 7-stage VRT (scales 1, 2, 4, 8, 4, 2, 1), the paper configuration
    by default: 120 x 7 + 180 x 6 channels, 6 heads, 12 offset groups."""

    reshapes = ("none", "down", "down", "down", "up", "up", "up")
    scales = (1, 2, 4, 8, 4, 2, 1)
    flow_levels = (2, 3, 4, 5)  # 4 scales: 1, 1/2, 1/4, 1/8

    def __init__(self, upscale: int = 4, depths: Sequence[int] = (8,) * 7 + (4,) * 6,
                 embed_dims: Sequence[int] = (120,) * 7 + (180,) * 6,
                 num_heads: Sequence[int] = (6,) * 13, deformable_groups: int = 12, **kw):
        super().__init__(upscale=upscale, depths=depths, embed_dims=embed_dims,
                         num_heads=num_heads, deformable_groups=deformable_groups, **kw)

    def _forward_features(self, x, fb, ff, det, gen):
        x1 = self._stage_call(0, x, fb[0::4], ff[0::4], det, gen)
        x2 = self._stage_call(1, x1, fb[1::4], ff[1::4], det, gen)
        x3 = self._stage_call(2, x2, fb[2::4], ff[2::4], det, gen)
        x4 = self._stage_call(3, x3, fb[3::4], ff[3::4], det, gen)
        x = self._stage_call(4, x4, fb[2::4], ff[2::4], det, gen)
        x = self._stage_call(5, x + x3, fb[1::4], ff[1::4], det, gen)
        x = self._stage_call(6, x + x2, fb[0::4], ff[0::4], det, gen)
        return self._trunk(x + x1, det, gen)


class TinyVRT(_VRTBase):
    """5-stage VRT (scales 1, 2, 4, 2, 1)."""

    reshapes = ("none", "down", "down", "up", "up")
    scales = (1, 2, 4, 2, 1)
    flow_levels = (3, 4, 5)  # 3 scales: 1, 1/2, 1/4

    def __init__(self, upscale: int = 4, depths: Sequence[int] = (4,) * 7,
                 embed_dims: Sequence[int] = (32,) * 7, num_heads: Sequence[int] = (4,) * 7,
                 deformable_groups: int = 4, **kw):
        super().__init__(upscale=upscale, depths=depths, embed_dims=embed_dims,
                         num_heads=num_heads, deformable_groups=deformable_groups, **kw)

    def _forward_features(self, x, fb, ff, det, gen):
        x1 = self._stage_call(0, x, fb[0::3], ff[0::3], det, gen)
        x2 = self._stage_call(1, x1, fb[1::3], ff[1::3], det, gen)
        x3 = self._stage_call(2, x2, fb[2::3], ff[2::3], det, gen)
        x = self._stage_call(3, x3, fb[1::3], ff[1::3], det, gen)
        x = self._stage_call(4, x + x2, fb[0::3], ff[0::3], det, gen)
        return self._trunk(x + x1, det, gen)
