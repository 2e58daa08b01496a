"""Plain reference of BasicVSR++ (Chan et al., arXiv:2104.13371; mmagic's
``basicvsr_plusplus_net.py``) as the program computes it, in float32,
written from the published equations:

* features: a 3x3 conv 3 -> C, LeakyReLU 0.1 and 5 residual units
  ``x + conv(relu(conv(x)))`` of each LR frame;
* SpyNet flows between adjacent frames, both directions;
* four propagation branches in turn (backward_1, forward_1, backward_2,
  forward_2), each over the frames in its order. At step k >= 1 the state
  of the step before is warped by the step's flow ``f1`` (bilinear, zeros
  outside); from k >= 2 the branch's output two steps back is warped by
  the composed flow ``f2 = f1 + warp(f_prev, f1)`` (zeros at k = 1). The
  second-order alignment: four 3x3 convs (LeakyReLU 0.1 between) of
  ``[c1, spatial, c2, f1, f2]`` give ``(o1, o2, m)``; the offsets are
  ``10 * tanh([o1, o2])``, the first half plus ``f1`` in (dy, dx) tiled
  over taps and groups, the second half plus ``f2``; a modulated
  deformable 3x3 conv (``sigmoid(m)``) of ``[state, state two back]``
  gives the aligned state. Then ``state += residual_block((2 + j) * C ->
  C, num_blocks)`` of ``[spatial, the earlier branches' outputs, state]``;
* reconstruction: a residual block 5C -> C of five units, LeakyReLU 0.1
  after each pixel shuffle x2 and after ``conv_hr``, ``conv_last``, and the
  bilinear x4 of the LR frame (corners not aligned) added.

Departures from mmagic, none of which changes an output: the whole clip
is propagated at once (no ``cpu_cache``), the mirror-extension shortcut
(one SpyNet pass saved on a clip that reads the same backwards) is not
taken, and the reconstruction runs in blocks of ``RECON_FRAMES`` frames so
that a 100-frame clip fits one card beside nothing else. The deformable
conv samples with ``grid_sample`` (``vrt.modulated_deform_conv``); its
weights are HWIO ``(3, 3, 2C, C)``.

BasicVSR++ has no cleaning module, so ``forward`` returns ``(sr, lr)``
with ``lr`` the input itself: the training loss's second term is then a
constant that adds nothing to any gradient. Clips ``(B, T, H, W, 3)``
outside, parameters by the program's names.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from port_bench.reference.layers import Params, Quant, adjacent_flows, conv, exact, flow_warp
from port_bench.reference.realbasicvsr import (_conv_shape, _resblock_shapes, residual_block,
                                               spynet_shapes)
from port_bench.reference.vrt import modulated_deform_conv

BRANCHES = ("backward_1", "forward_1", "backward_2", "forward_2")
EXTRACT_BLOCKS = RECON_BLOCKS = 5
RECON_FRAMES = 10


def param_shapes(mid_channels: int = 64, num_blocks: int = 7, deform_groups: int = 16,
                 upscale: int = 4, **_) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's name and shape, in the program's order."""
    c = mid_channels
    s: Dict[str, Tuple[int, ...]] = {}
    spynet_shapes(s, "spynet")
    _resblock_shapes(s, "feat_extract", 3, c, EXTRACT_BLOCKS)
    for name in BRANCHES:
        a = f"deform_align.{name}"
        s[f"{a}.weight"] = (3, 3, 2 * c, c)
        s[f"{a}.bias"] = (c,)
        _conv_shape(s, f"{a}.conv_offset_0", 3 * c + 4, c)
        _conv_shape(s, f"{a}.conv_offset_1", c, c)
        _conv_shape(s, f"{a}.conv_offset_2", c, c)
        _conv_shape(s, f"{a}.conv_offset_3", c, 27 * deform_groups)
    for j, name in enumerate(BRANCHES):
        _resblock_shapes(s, f"backbone.{name}", (2 + j) * c, c, num_blocks)
    _resblock_shapes(s, "reconstruction", 5 * c, c, RECON_BLOCKS)
    for i in range(int(math.log2(upscale))):
        _conv_shape(s, f"upsample.{i}.conv", c, 4 * c)
    _conv_shape(s, "conv_hr", c, 64)
    _conv_shape(s, "conv_last", 64, 3)
    return s


def fan_in(name: str, shape: Sequence[int]) -> int:
    """The deformable convs' weights (``deform_align.<branch>.weight``) are
    HWIO (kh, kw, Cin, Cout)."""
    if name.startswith("deform_align.") and name.endswith(".weight") and name.count(".") == 2:
        return int(shape[0] * shape[1] * shape[2])
    return int(math.prod(shape[1:]))


def frozen(name: str, train_flow: bool = False, **_) -> bool:
    """Whether training leaves this parameter where it is (SpyNet, unless trained)."""
    return not train_flow and name.startswith("spynet.")


def second_order_align(p: Params, name: str, x, cond, f1, f2, max_mag: float, q: Quant):
    """The aligned state (N, C, H, W) of ``x`` = [state n-1, state n-2]
    (N, 2C, H, W) under ``cond`` (N, 3C, H, W) and the flows (N, 2, H, W)."""
    feat = torch.cat([cond, f1, f2], 1)
    for i in range(3):
        feat = F.leaky_relu(conv(p, f"{name}.conv_offset_{i}", feat, q), 0.1)
    o1, o2, m = conv(p, f"{name}.conv_offset_3", feat, q).chunk(3, 1)
    off_1, off_2 = (max_mag * torch.tanh(torch.cat([o1, o2], 1))).chunk(2, 1)
    off_1 = off_1 + f1.flip(1).repeat(1, off_1.shape[1] // 2, 1, 1)
    off_2 = off_2 + f2.flip(1).repeat(1, off_2.shape[1] // 2, 1, 1)
    return modulated_deform_conv(x, torch.cat([off_1, off_2], 1), torch.sigmoid(m),
                                 p[f"{name}.weight"], p[f"{name}.bias"], q)


def propagate(p: Params, name: str, spatial: List[torch.Tensor], earlier: List[List],
              flows, num_blocks: int, max_mag: float, q: Quant) -> List[torch.Tensor]:
    """One branch: each frame's state (N, C, H, W), by frame index."""
    t = len(spatial)
    backward = name.startswith("backward")
    order = list(range(t))[::-1] if backward else list(range(t))
    out: List = [None] * t
    state = torch.zeros_like(spatial[0])
    flow_prev = None
    for k, i in enumerate(order):
        if k > 0:
            f1 = flows[:, i] if backward else flows[:, i - 1]
            c1 = flow_warp(state, f1)
            state_2, f2, c2 = torch.zeros_like(state), torch.zeros_like(f1), torch.zeros_like(c1)
            if k > 1:
                state_2 = out[order[k - 2]]
                f2 = f1 + flow_warp(flow_prev, f1)
                c2 = flow_warp(state_2, f2)
            state = second_order_align(p, f"deform_align.{name}", torch.cat([state, state_2], 1),
                                       torch.cat([c1, spatial[i], c2], 1), f1, f2, max_mag, q)
            flow_prev = f1
        feat = torch.cat([spatial[i], *(e[i] for e in earlier), state], 1)
        state = state + residual_block(p, f"backbone.{name}", feat, num_blocks, q)
        out[i] = state
    return out


def forward(p: Params, lr: torch.Tensor, q: Quant = exact, mid_channels: int = 64,
            num_blocks: int = 7, max_residue_magnitude: float = 10.0, upscale: int = 4,
            train_flow: bool = False, **_) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sr, lr)`` of clips ``lr`` (B, T, H, W, 3)."""
    b, t, h, w, c = lr.shape
    clips = lr.permute(0, 1, 4, 2, 3)
    spatial = residual_block(p, "feat_extract", clips.reshape(b * t, c, h, w), EXTRACT_BLOCKS, q)
    frames = list(spatial.reshape(b, t, -1, h, w).unbind(1))
    bwd = fwd = None
    if t > 1:
        bwd, fwd = (f[0] for f in adjacent_flows(p, "spynet", clips, q))
        if not train_flow:
            bwd, fwd = bwd.detach(), fwd.detach()
    feats: Dict[str, List] = {}
    for name in BRANCHES:
        flows = bwd if name.startswith("backward") else fwd
        feats[name] = propagate(p, name, frames, list(feats.values()), flows, num_blocks,
                                max_residue_magnitude, q)

    out = []
    for s in range(0, t, RECON_FRAMES):
        e = min(t, s + RECON_FRAMES)
        y = torch.cat([torch.stack(frames[s:e], 1),
                       *(torch.stack(feats[n][s:e], 1) for n in BRANCHES)], 2)
        y = residual_block(p, "reconstruction", y.reshape(b * (e - s), -1, h, w), RECON_BLOCKS, q)
        for i in range(int(math.log2(upscale))):
            y = F.leaky_relu(F.pixel_shuffle(conv(p, f"upsample.{i}.conv", y, q), 2), 0.1)
        y = F.leaky_relu(conv(p, "conv_hr", y, q), 0.1)
        y = conv(p, "conv_last", y, q)
        base = F.interpolate(clips[:, s:e].reshape(b * (e - s), c, h, w),
                             size=(h * upscale, w * upscale), mode="bilinear",
                             align_corners=False)
        out.append((y + base).reshape(b, e - s, c, h * upscale, w * upscale))
    sr = torch.cat(out, 1).permute(0, 1, 3, 4, 2)
    return sr, lr
