"""RAFT optical flow, channels-last (port of ``vsrlab_tpu/models/flow/raft.py``).

Feature and context encoders at 1/8 resolution, the all-pairs correlation
(one fp32 product) pooled into a 4-level pyramid, and an iterative ConvGRU
update that refines pixel coordinates from bilinear radius-window lookups
into the pyramid. The lookups are the sampler of
:mod:`vsrlab_tpu_torch.ops.bilinear_sample` (``sampler_impl = "fused"``:
the hand-written kernel; ``"plain"`` the gather in torch): 4 levels a
GRU iteration, ``(2r+1)^2`` samples of one channel for each 1/8-scale
pixel, and a gradient to the pyramid through ``BilinearSample``.

Submodules carry the reference's torch names (``fnet.layer1.0.conv1``,
``update_block.gru.convz``, ...), so a reference checkpoint loads with
:func:`load_raft_state_dict`. ``norm_fn="batch"`` normalises with
per-sample statistics, as the JAX package does (no running statistics).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch
from torch import nn

from vsrlab_tpu_torch.nn.blocks import Conv2d
from vsrlab_tpu_torch.ops.pooling import avg_pool2d
from vsrlab_tpu_torch.ops.resize import resize_bilinear
from vsrlab_tpu_torch.ops.warp import sample_pixel_coords


class InstanceNorm(nn.Module):
    """``InstanceNorm2d(affine=False)``: each sample's channels normalised
    over (H, W), biased variance, eps 1e-5."""

    def forward(self, x):
        mean = x.mean((1, 2), keepdim=True)
        var = x.var((1, 2), keepdim=True, unbiased=False)
        return (x - mean) * torch.rsqrt(var + 1e-5)


def _norm(kind: str) -> nn.Module:
    if kind in ("instance", "batch"):
        return InstanceNorm()
    if kind == "none":
        return nn.Identity()
    raise ValueError(kind)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 residual."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "instance", stride: int = 1,
                 dtype=None):
        super().__init__()
        p4 = planes // 4
        self.conv1 = Conv2d(in_planes, p4, 1, 1, 0, dtype=dtype)
        self.conv2 = Conv2d(p4, p4, 3, stride, 1, dtype=dtype)
        self.conv3 = Conv2d(p4, planes, 1, 1, 0, dtype=dtype)
        self.norm1, self.norm2, self.norm3 = _norm(norm_fn), _norm(norm_fn), _norm(norm_fn)
        self.downsample = (nn.Sequential(Conv2d(in_planes, planes, 1, stride, 0, dtype=dtype),
                                         _norm(norm_fn)) if stride != 1 else None)

    def forward(self, x):
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        y = torch.relu(self.norm3(self.conv3(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class ResidualBlock(nn.Module):
    """3x3 -> 3x3 residual."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "instance", stride: int = 1,
                 dtype=None):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 3, stride, 1, dtype=dtype)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, dtype=dtype)
        self.norm1, self.norm2 = _norm(norm_fn), _norm(norm_fn)
        self.downsample = (nn.Sequential(Conv2d(in_planes, planes, 1, stride, 0, dtype=dtype),
                                         _norm(norm_fn)) if stride != 1 else None)

    def forward(self, x):
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class Encoder(nn.Module):
    """1/8-scale encoder: a 7x7 stride-2 conv, three stages of two blocks
    (the second and third at stride 2), a 1x1 projection. ``small`` uses
    bottleneck blocks at 32 / 64 / 96 channels, else residual blocks at
    64 / 96 / 128."""

    def __init__(self, output_dim: int, norm_fn: str, small: bool, dtype=None):
        super().__init__()
        block = BottleneckBlock if small else ResidualBlock
        dims = (32, 64, 96) if small else (64, 96, 128)
        self.conv1 = Conv2d(3, dims[0], 7, 2, 3, dtype=dtype)
        self.norm1 = _norm(norm_fn)
        layers, prev = [], dims[0]
        for dim, stride in zip(dims, (1, 2, 2)):
            layers.append(nn.Sequential(block(prev, dim, norm_fn, stride, dtype),
                                        block(dim, dim, norm_fn, 1, dtype)))
            prev = dim
        self.layer1, self.layer2, self.layer3 = layers
        self.conv2 = Conv2d(prev, output_dim, 1, 1, 0, dtype=dtype)

    def forward(self, x):
        x = torch.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class FlowHead(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, dtype=None):
        super().__init__()
        self.conv1 = Conv2d(input_dim, hidden_dim, 3, 1, 1, dtype=dtype)
        self.conv2 = Conv2d(hidden_dim, 2, 3, 1, 1, dtype=dtype)

    def forward(self, x):
        return self.conv2(torch.relu(self.conv1(x)))


def _gru(h, x, convz, convr, convq):
    hx = torch.cat([h, x], -1)
    z = torch.sigmoid(convz(hx))
    r = torch.sigmoid(convr(hx))
    q = torch.tanh(convq(torch.cat([r * h, x], -1)))
    return (1 - z) * h + z * q


class ConvGRU(nn.Module):
    def __init__(self, hidden_dim: int, input_dim: int, dtype=None):
        super().__init__()
        cin = hidden_dim + input_dim
        self.convz, self.convr, self.convq = (Conv2d(cin, hidden_dim, 3, 1, 1, dtype=dtype)
                                              for _ in range(3))

    def forward(self, h, x):
        return _gru(h, x, self.convz, self.convr, self.convq)


class SepConvGRU(nn.Module):
    """A 1x5 GRU, then a 5x1 one."""

    def __init__(self, hidden_dim: int, input_dim: int, dtype=None):
        super().__init__()
        cin = hidden_dim + input_dim
        for i, (ks, pad) in ((1, ((1, 5), (0, 2))), (2, ((5, 1), (2, 0)))):
            for gate in ("z", "r", "q"):
                setattr(self, f"conv{gate}{i}", Conv2d(cin, hidden_dim, ks, 1, pad, dtype=dtype))

    def forward(self, h, x):
        h = _gru(h, x, self.convz1, self.convr1, self.convq1)
        return _gru(h, x, self.convz2, self.convr2, self.convq2)


class SmallMotionEncoder(nn.Module):
    def __init__(self, corr_planes: int, dtype=None):
        super().__init__()
        self.convc1 = Conv2d(corr_planes, 96, 1, 1, 0, dtype=dtype)
        self.convf1 = Conv2d(2, 64, 7, 1, 3, dtype=dtype)
        self.convf2 = Conv2d(64, 32, 3, 1, 1, dtype=dtype)
        self.conv = Conv2d(128, 80, 3, 1, 1, dtype=dtype)

    def forward(self, flow, corr):
        cor = torch.relu(self.convc1(corr))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        return torch.cat([torch.relu(self.conv(torch.cat([cor, flo], -1))), flow], -1)


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_planes: int, dtype=None):
        super().__init__()
        self.convc1 = Conv2d(corr_planes, 256, 1, 1, 0, dtype=dtype)
        self.convc2 = Conv2d(256, 192, 3, 1, 1, dtype=dtype)
        self.convf1 = Conv2d(2, 128, 7, 1, 3, dtype=dtype)
        self.convf2 = Conv2d(128, 64, 3, 1, 1, dtype=dtype)
        self.conv = Conv2d(256, 126, 3, 1, 1, dtype=dtype)

    def forward(self, flow, corr):
        cor = torch.relu(self.convc2(torch.relu(self.convc1(corr))))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        return torch.cat([torch.relu(self.conv(torch.cat([cor, flo], -1))), flow], -1)


class UpdateBlock(nn.Module):
    """Motion encoder, GRU, flow head: the small (ConvGRU, 96 hidden) or
    the basic (SepConvGRU, 128 hidden) form."""

    def __init__(self, corr_planes: int, hidden_dim: int, context_dim: int, small: bool,
                 dtype=None):
        super().__init__()
        if small:
            self.encoder = SmallMotionEncoder(corr_planes, dtype)
            self.gru = ConvGRU(hidden_dim, context_dim + 82, dtype)
            self.flow_head = FlowHead(hidden_dim, 128, dtype)
        else:
            self.encoder = BasicMotionEncoder(corr_planes, dtype)
            self.gru = SepConvGRU(hidden_dim, context_dim + 128, dtype)
            self.flow_head = FlowHead(hidden_dim, 256, dtype)

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], -1))
        return net, self.flow_head(net)


def corr_pyramid(fmap1, fmap2, num_levels: int) -> List[torch.Tensor]:
    """The all-pairs correlation as ``B*H*W`` one-channel images ``(h, w)``
    and its 2x2 average pools: ``num_levels`` tensors ``(B*H*W, h/2^i,
    w/2^i, 1)``, fp32."""
    b, h, w, c = fmap1.shape
    f1 = fmap1.reshape(b, h * w, c).float()
    f2 = fmap2.reshape(b, h * w, c).float()
    corr = (torch.matmul(f1, f2.transpose(1, 2)) / c**0.5).reshape(b * h * w, h, w, 1)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        corr = avg_pool2d(corr, 2, 2)
        pyramid.append(corr)
    return pyramid


def corr_lookup(pyramid, coords, radius: int, impl: Optional[str] = "fused"):
    """The ``(2r+1)^2`` window around each pixel's coordinates ``coords``
    ``(B, H1, W1, 2)`` at every level, bilinear with zeros outside, one
    sampler call a level: ``(B, H1, W1, levels*(2r+1)^2)``. As in the
    reference, the first window axis offsets x and the second y."""
    b, h1, w1, _ = coords.shape
    lin = torch.linspace(-radius, radius, 2 * radius + 1, device=coords.device)
    d0, d1 = lin[:, None].expand(-1, 2 * radius + 1), lin[None, :].expand(2 * radius + 1, -1)
    out = []
    for i, corr in enumerate(pyramid):
        centroid = coords.reshape(b * h1 * w1, 1, 1, 2) / (2**i)
        px = centroid[..., 0] + d0[None]
        py = centroid[..., 1] + d1[None]
        sampled = sample_pixel_coords(corr, px, py, "bilinear", "zeros", True, impl=impl)
        out.append(sampled.reshape(b, h1, w1, -1))
    return torch.cat(out, -1)


class RAFT(nn.Module):
    """RAFT flow estimator. ``forward(ref, supp)``: features of (supp, ref),
    context of supp, flow from supp to ref at 1/8 scale refined ``iters``
    times, upsampled x``scale_factor`` (bilinear, align_corners, values
    scaled). Frames ``(B, H, W, 3)``, H and W divisible by 8; the flow
    ``(B, H/8*s, W/8*s, 2)`` fp32."""

    def __init__(self, small: bool = True, scale_factor: int = 2, iters: int = 12, dtype=None):
        super().__init__()
        self.small, self.scale_factor, self.iters = small, scale_factor, iters
        self.sampler_impl = "fused"
        if small:
            self.hidden_dim, self.context_dim, self.corr_levels, self.corr_radius = 96, 64, 4, 3
            self.fnet = Encoder(128, "instance", True, dtype)
            self.cnet = Encoder(self.hidden_dim + self.context_dim, "none", True, dtype)
        else:
            self.hidden_dim, self.context_dim, self.corr_levels, self.corr_radius = 128, 128, 4, 4
            self.fnet = Encoder(256, "instance", False, dtype)
            self.cnet = Encoder(self.hidden_dim + self.context_dim, "batch", False, dtype)
        planes = self.corr_levels * (2 * self.corr_radius + 1) ** 2
        self.update_block = UpdateBlock(planes, self.hidden_dim, self.context_dim, small, dtype)

    def forward(self, ref, supp, iters: Optional[int] = None):
        iters = iters or self.iters
        b, h, w, _ = supp.shape
        fmap1, fmap2 = self.fnet(torch.cat([supp, ref], 0)).chunk(2)
        net, inp = self.cnet(supp).split([self.hidden_dim, self.context_dim], -1)
        net, inp = torch.tanh(net), torch.relu(inp)

        h8, w8 = h // 8, w // 8
        gy, gx = torch.meshgrid(torch.arange(h8, device=supp.device),
                                torch.arange(w8, device=supp.device), indexing="ij")
        coords0 = torch.stack([gx, gy], -1).float()[None].expand(b, h8, w8, 2)
        coords1 = coords0
        pyramid = corr_pyramid(fmap1, fmap2, self.corr_levels)
        for _ in range(iters):
            coords1 = coords1.detach()
            corr = corr_lookup(pyramid, coords1, self.corr_radius, self.sampler_impl)
            flow = coords1 - coords0
            net, delta = self.update_block(net, inp, corr.to(net.dtype), flow.to(net.dtype))
            coords1 = coords1 + delta.float()

        s = self.scale_factor
        return resize_bilinear(coords1 - coords0, (h8 * s, w8 * s), align_corners=True) * s


def strip_module_prefix(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """Keys without a leading ``module.`` (a DataParallel save)."""
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in state_dict.items()}


def load_raft_state_dict(model: RAFT, state_dict: Mapping) -> RAFT:
    """Load a reference RAFT checkpoint's ``state_dict`` (such as
    ``raft-small.pth``; ``module.``-prefixed keys are stripped) into
    ``model``. Every parameter of ``model`` must be in it; its other entries
    (batch-norm statistics, the basic model's upsampling mask head) are
    the ones the JAX importer skips too. Returns ``model``."""
    sd = strip_module_prefix(state_dict)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"RAFT checkpoint lacks {missing[:5]}{' ...' if len(missing) > 5 else ''}")
    model.load_state_dict({k: torch.as_tensor(sd[k]) for k in own})
    return model
