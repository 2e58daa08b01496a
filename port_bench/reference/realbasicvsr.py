"""Plain reference of RealBasicVSR (Chan et al., arXiv:2111.12704) as the
program computes it: a cleaning module of ``cleaning_steps`` x (x += conv(
residual block(x))), then BasicVSR: SpyNet flows in both directions, a
backward and a forward recurrence that each warp the hidden state by the
flow (bilinear, zeros outside) and run [frame, warped state] through a
conv head and ``res_blocks`` residual units, a 1x1 fusion, two pixel
shuffles without an activation between them, two convs, and the
bilinear x4 of the cleaned input added. Returns ``(sr, lq)``.

Float32 NCHW inside; clips ``(B, T, H, W, 3)`` outside. Written apart
from the program, from its documented equations; parameters by the
program's names.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from port_bench.reference.layers import Params, Quant, adjacent_flows, conv, exact, flow_warp

SPYNET_CHANNELS = ((8, 32), (32, 64), (64, 32), (32, 16), (16, 2))


def _conv_shape(shapes: Dict, name: str, cin: int, cout: int, k: int = 3) -> None:
    shapes[f"{name}.weight"] = (cout, cin, k, k)
    shapes[f"{name}.bias"] = (cout,)


def _resblock_shapes(shapes: Dict, prefix: str, cin: int, mid: int, blocks: int) -> None:
    _conv_shape(shapes, f"{prefix}.head.conv", cin, mid)
    for i in range(blocks):
        _conv_shape(shapes, f"{prefix}.res_blocks.{i}.conv1", mid, mid)
        _conv_shape(shapes, f"{prefix}.res_blocks.{i}.conv2", mid, mid)


def spynet_shapes(shapes: Dict, prefix: str, levels: int = 6) -> None:
    for lv in range(levels):
        for i, (ci, co) in enumerate(SPYNET_CHANNELS):
            _conv_shape(shapes, f"{prefix}.basic_module.{lv}.convs.{i}", ci, co, 7)


def param_shapes(mid_channels: int = 64, res_blocks: int = 20, cleaning_blocks: int = 20,
                 upscale: int = 4, **_) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's name and shape, in the program's order."""
    s: Dict[str, Tuple[int, ...]] = {}
    _resblock_shapes(s, "cleaner.resblock", 3, mid_channels, cleaning_blocks)
    _conv_shape(s, "cleaner.conv", mid_channels, 3)
    spynet_shapes(s, "basicvsr.spynet")
    _resblock_shapes(s, "basicvsr.backward_resblocks", 3 + mid_channels, mid_channels,
                     res_blocks)
    _resblock_shapes(s, "basicvsr.forward_resblocks", 3 + mid_channels, mid_channels,
                     res_blocks)
    _conv_shape(s, "basicvsr.point_conv", 2 * mid_channels, mid_channels, 1)
    for i in range(upscale // 2):
        _conv_shape(s, f"basicvsr.upsample.{i}.conv", mid_channels, 4 * mid_channels)
    _conv_shape(s, "basicvsr.conv_hr", mid_channels, 64)
    _conv_shape(s, "basicvsr.conv_last", 64, 3)
    return s


def frozen(name: str, train_flow: bool = False, **_) -> bool:
    """Whether training leaves this parameter where it is (SpyNet, unless trained)."""
    return not train_flow and name.startswith("basicvsr.spynet.")


def residual_block(p: Params, prefix: str, x: torch.Tensor, blocks: int, q: Quant):
    x = F.leaky_relu(conv(p, f"{prefix}.head.conv", x, q), 0.1)
    for i in range(blocks):
        u = f"{prefix}.res_blocks.{i}"
        x = x + conv(p, f"{u}.conv2", torch.relu(conv(p, f"{u}.conv1", x, q)), q)
    return x


def forward(p: Params, lr: torch.Tensor, q: Quant = exact, mid_channels: int = 64,
            res_blocks: int = 20, cleaning_blocks: int = 20, cleaning_steps: int = 3,
            upscale: int = 4, train_flow: bool = False, **_) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sr, lq)`` of clips ``lr`` (B, T, H, W, 3)."""
    b, t, h, w, c = lr.shape
    x = lr.reshape(b * t, h, w, c).permute(0, 3, 1, 2)
    for _ in range(cleaning_steps):
        x = x + conv(p, "cleaner.conv", residual_block(p, "cleaner.resblock", x,
                                                       cleaning_blocks, q), q)
    lq = x.reshape(b, t, c, h, w)

    bwd, fwd = adjacent_flows(p, "basicvsr.spynet", lq, q)
    bwd, fwd = bwd[0], fwd[0]
    if not train_flow:
        bwd, fwd = bwd.detach(), fwd.detach()
    feat = lq.new_zeros((b, mid_channels, h, w))
    back = [None] * t
    for i in range(t - 1, -1, -1):
        if i < t - 1:
            feat = flow_warp(feat, bwd[:, i])
        feat = residual_block(p, "basicvsr.backward_resblocks", torch.cat([lq[:, i], feat], 1),
                              res_blocks, q)
        back[i] = feat
    feat = lq.new_zeros((b, mid_channels, h, w))
    outs = []
    for i in range(t):
        if i > 0:
            feat = flow_warp(feat, fwd[:, i - 1])
        feat = residual_block(p, "basicvsr.forward_resblocks", torch.cat([lq[:, i], feat], 1),
                              res_blocks, q)
        outs.append(torch.cat([back[i], feat], 1))
    y = torch.stack(outs, 1).reshape(b * t, 2 * mid_channels, h, w)
    y = F.leaky_relu(conv(p, "basicvsr.point_conv", y, q), 0.1)
    for i in range(upscale // 2):
        y = F.pixel_shuffle(conv(p, f"basicvsr.upsample.{i}.conv", y, q), 2)
    y = F.leaky_relu(conv(p, "basicvsr.conv_hr", y, q), 0.1)
    y = conv(p, "basicvsr.conv_last", y, q)
    base = F.interpolate(lq.reshape(b * t, c, h, w), size=(h * upscale, w * upscale),
                         mode="bilinear", align_corners=False)
    sr = (y + base).reshape(b, t, c, h * upscale, w * upscale).permute(0, 1, 3, 4, 2)
    return sr, lq.permute(0, 1, 3, 4, 2)
