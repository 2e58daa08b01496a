"""IRR-PWC: PWC-Net with iterative residual refinement, channels-last
(port of ``vsrlab_tpu/models/flow/irr.py``).

A 6-level feature pyramid shared by both frames, bidirectional cost
volumes (:func:`~vsrlab_tpu_torch.ops.correlation.cost_volume`), one dense
flow estimator and one dilated context network shared by every level, and
a learned 3x3 local-kernel refinement of the flow. Between levels the flow
is kept in ``div_flow`` units, rescaled at the boundaries. Each warp is one
call of the sampler of ``sampler_impl`` (``"fused"``: the hand-written
kernel; 18 a forward at ``output_level = 4``: two at level 0, four at
levels 1 to 4), zeroed where its bilinear window leaves the image.
Submodules keep the JAX package's names.

The window mask is exact here: a pixel is kept where every corner that
carries weight lies in the image, the intent of the reference's ``mask >=
1`` on a warped image of ones. That test reads a rounded sum of four
weights, which lands 1 ulp below 1 at some pixels whose window lies inside
the image, and where it does depends on the order of the sum (the JAX
package's packed sampler sums in another order than this one): each such
pixel is zeroed there and kept here.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vsrlab_tpu_torch.nn.blocks import Conv2d
from vsrlab_tpu_torch.ops.correlation import cost_volume
from vsrlab_tpu_torch.ops.resize import resize_bilinear
from vsrlab_tpu_torch.ops.warp import flow_warp

NUM_CHS = (3, 16, 32, 64, 96, 128, 196)


def _conv(cin: int, cout: int, k: int = 3, stride: int = 1, dilation: int = 1, dtype=None):
    return Conv2d(cin, cout, k, stride, ((k - 1) * dilation) // 2, dtype=dtype, dilation=dilation)


def _leaky(x):
    return F.leaky_relu(x, 0.1)


class FeatureExtractor(nn.Module):
    """Six stride-2 stages of two convs; returns the features coarsest first."""

    def __init__(self, num_chs: Sequence[int] = NUM_CHS, dtype=None):
        super().__init__()
        self.n = len(num_chs) - 1
        for i, (ci, ch) in enumerate(zip(num_chs[:-1], num_chs[1:])):
            setattr(self, f"conv{i}_0", _conv(ci, ch, 3, 2, dtype=dtype))
            setattr(self, f"conv{i}_1", _conv(ch, ch, 3, 1, dtype=dtype))

    def forward(self, x) -> List[torch.Tensor]:
        pyramid = []
        for i in range(self.n):
            x = _leaky(getattr(self, f"conv{i}_1")(_leaky(getattr(self, f"conv{i}_0")(x))))
            pyramid.append(x)
        return pyramid[::-1]


class FlowEstimatorDense(nn.Module):
    """Densely connected flow head: returns the features and the flow."""

    CHS = (128, 128, 96, 64, 32)

    def __init__(self, cin: int, dtype=None):
        super().__init__()
        for i, ch in enumerate(self.CHS):
            setattr(self, f"conv{i + 1}", _conv(cin, ch, dtype=dtype))
            cin += ch
        self.conv_last = _conv(cin, 2, dtype=dtype)
        self.out_channels = cin

    def forward(self, x):
        for i in range(len(self.CHS)):
            x = torch.cat([_leaky(getattr(self, f"conv{i + 1}")(x)), x], -1)
        return x, self.conv_last(x)


class ContextNetwork(nn.Module):
    """Dilated context refinement."""

    SPEC = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1))

    def __init__(self, cin: int, dtype=None):
        super().__init__()
        for i, (ch, dil) in enumerate(self.SPEC):
            setattr(self, f"conv{i}", _conv(cin, ch, 3, 1, dil, dtype=dtype))
            cin = ch
        self.conv_out = _conv(cin, 2, dtype=dtype)

    def forward(self, x):
        for i in range(len(self.SPEC)):
            x = _leaky(getattr(self, f"conv{i}")(x))
        return self.conv_out(x)


class RefineFlow(nn.Module):
    """Learned 3x3 local-kernel smoothing of the flow: a conv stack predicts
    a kernel a pixel (softmax of ``-k^2``), applied to the edge-padded flow."""

    CHS = (128, 128, 64, 64, 32, 32)

    def __init__(self, cin: int, dtype=None):
        super().__init__()
        for i, ch in enumerate(self.CHS):
            setattr(self, f"conv{i}", _conv(cin, ch, dtype=dtype))
            cin = ch
        self.conv_out = _conv(cin, 9, dtype=dtype)

    def forward(self, flow, diff_img, feature):
        flow_m = flow - flow.mean((1, 2), keepdim=True)
        norm2 = torch.sqrt((diff_img**2).sum(-1, keepdim=True) + 1e-12)
        x = torch.cat([flow_m, norm2, feature], -1)
        for i in range(len(self.CHS)):
            x = _leaky(getattr(self, f"conv{i}")(x))
        kernel = torch.softmax(-(self.conv_out(x).float() ** 2), -1)
        h, w = flow.shape[1:3]
        padded = F.pad(flow.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate").permute(0, 2, 3, 1)
        taps = torch.stack([padded[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)],
                           -1)
        return (taps * kernel[..., None, :]).sum(-1).to(flow.dtype)


def window_inside(flow: torch.Tensor) -> torch.Tensor:
    """``(N, H, W, 1)`` bool: whether every corner with nonzero weight of the
    bilinear window at ``p + flow[p]`` lies in the image (NaN: no)."""
    h, w = flow.shape[1:3]
    ys, xs = torch.meshgrid(torch.arange(h, device=flow.device, dtype=torch.float32),
                            torch.arange(w, device=flow.device, dtype=torch.float32),
                            indexing="ij")
    inside = None
    for grid, d, size in ((xs, flow[..., 0], w), (ys, flow[..., 1], h)):
        v = grid + d.float()
        f = torch.floor(v)
        w1 = v - f  # the sampler's weights: corner f gets 1 - w1, corner f + 1 gets w1
        ok = (((f >= 0) & (f <= size - 1)) | (1.0 - w1 == 0)) & (
            ((f + 1 >= 0) & (f + 1 <= size - 1)) | (w1 == 0))
        inside = ok if inside is None else inside & ok
    return inside[..., None]


class IRRPWCNet(nn.Module):
    """Bidirectional IRR-PWC. ``forward(ref, supp)`` returns ``(flows_f,
    flows_b)``, the levels ``return_levels`` (indices into the 7-entry list
    of levels, finest last), in pixels at each level's resolution."""

    def __init__(self, return_levels: Sequence[int] = (-1, -2, -3, -4), div_flow: float = 0.05,
                 search_range: int = 4, output_level: int = 4, dtype=None):
        super().__init__()
        self.return_levels = tuple(return_levels)
        self.div_flow, self.search_range, self.output_level = div_flow, search_range, output_level
        self.sampler_impl = "fused"
        pyr_chs = NUM_CHS[1:][::-1]
        corr_chs = (2 * search_range + 1) ** 2
        self.feature_pyramid_extractor = FeatureExtractor(dtype=dtype)
        self.flow_estimators = FlowEstimatorDense(corr_chs + 32 + 2, dtype)
        self.context_networks = ContextNetwork(self.flow_estimators.out_channels + 2, dtype)
        self.refine_flow = RefineFlow(2 + 1 + 32, dtype)
        for i in range(4):
            setattr(self, f"conv_1x1_{i}", _conv(pyr_chs[i], 32, 1, dtype=dtype))

    def _warp_units(self, x, flow_units, h_im: int, w_im: int):
        """Warp by a ``div_flow``-unit flow (one sampler call), zeroed where
        the window leaves the image (:func:`window_inside`)."""
        hh, ww = x.shape[1:3]
        scale = torch.tensor([(ww - 1) / max(w_im - 1, 1), (hh - 1) / max(h_im - 1, 1)],
                             dtype=flow_units.dtype, device=x.device)
        fpix = flow_units / self.div_flow * scale
        warped = flow_warp(x, fpix, padding_mode="zeros", impl=self.sampler_impl)
        return warped * window_inside(fpix).to(warped.dtype)

    def _rescale(self, flow, to_local: bool, h_im: int, w_im: int):
        """Pixels at this level <-> ``div_flow`` units."""
        hh, ww = flow.shape[1:3]
        if to_local:
            s = [ww / w_im / self.div_flow, hh / h_im / self.div_flow]
        else:
            s = [w_im * self.div_flow / ww, h_im * self.div_flow / hh]
        return flow * torch.tensor(s, dtype=flow.dtype, device=flow.device)

    def forward(self, ref, supp) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        x1_raw, x2_raw = supp, ref
        b, h_im, w_im, _ = x1_raw.shape
        pyr = self.feature_pyramid_extractor(torch.cat([x1_raw, x2_raw], 0))
        x1_pyr = [p[:b] for p in pyr] + [x1_raw]
        x2_pyr = [p[b:] for p in pyr] + [x2_raw]
        est, ctx, refine = self.flow_estimators, self.context_networks, self.refine_flow

        flows_f: List[torch.Tensor] = []
        flows_b: List[torch.Tensor] = []
        flow_f = x1_pyr[0].new_zeros(x1_pyr[0].shape[:3] + (2,), dtype=torch.float32)
        flow_b = torch.zeros_like(flow_f)
        for level, (x1, x2) in enumerate(zip(x1_pyr, x2_pyr)):
            hh, ww = x1.shape[1:3]
            if level <= self.output_level:
                if level == 0:
                    x2_warp, x1_warp = x2, x1
                else:
                    flow_f = resize_bilinear(flow_f, (hh, ww), align_corners=True)
                    flow_b = resize_bilinear(flow_b, (hh, ww), align_corners=True)
                    x2_warp = self._warp_units(x2, flow_f, h_im, w_im)
                    x1_warp = self._warp_units(x1, flow_b, h_im, w_im)
                corr_f = _leaky(cost_volume(x1, x2_warp, self.search_range))
                corr_b = _leaky(cost_volume(x2, x1_warp, self.search_range))
                if level != self.output_level:
                    conv = getattr(self, f"conv_1x1_{level}")
                    x1_1by1, x2_1by1 = _leaky(conv(x1)), _leaky(conv(x2))
                else:
                    x1_1by1, x2_1by1 = x1, x2
                flow_f = self._rescale(flow_f, True, h_im, w_im)
                flow_b = self._rescale(flow_b, True, h_im, w_im)
                xi_f, res_f = est(torch.cat([corr_f, x1_1by1, flow_f], -1))
                xi_b, res_b = est(torch.cat([corr_b, x2_1by1, flow_b], -1))
                est_f, est_b = flow_f + res_f, flow_b + res_b
                cont_f = est_f + ctx(torch.cat([xi_f, est_f], -1))
                cont_b = est_b + ctx(torch.cat([xi_b, est_b], -1))
                img1_rs = resize_bilinear(x1_raw, (hh, ww), align_corners=True)
                img2_rs = resize_bilinear(x2_raw, (hh, ww), align_corners=True)
                img2_warp = self._warp_units(img2_rs, self._rescale(cont_f, False, h_im, w_im),
                                             h_im, w_im)
                img1_warp = self._warp_units(img1_rs, self._rescale(cont_b, False, h_im, w_im),
                                             h_im, w_im)
                flow_f = refine(cont_f.detach(), img1_rs - img2_warp, x1_1by1)
                flow_b = refine(cont_b.detach(), img2_rs - img1_warp, x2_1by1)
                flow_f = self._rescale(flow_f, False, h_im, w_im)
                flow_b = self._rescale(flow_b, False, h_im, w_im)
            else:
                flow_f = resize_bilinear(flow_f, (hh, ww), align_corners=True)
                flow_b = resize_bilinear(flow_b, (hh, ww), align_corners=True)
            flows_f.append(flow_f)
            flows_b.append(flow_b)
        return [flows_f[i] for i in self.return_levels], [flows_b[i] for i in self.return_levels]
