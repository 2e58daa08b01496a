"""Plain PyTorch building blocks of the references, in float32 NCHW.

Every reference takes and returns channels-last clips ``(B, T, H, W, C)``
as the program does, and computes inside in NCHW with ``torch.nn.functional``
(conv2d, interpolate, grid_sample, pixel_shuffle, avg_pool2d): an
implementation of the same mathematics written apart from the program.

``q`` is the rounding of every product's operands and result (convolution,
linear, matmul): :func:`exact` for the reference itself, :func:`fp8` for
the control, which computes in float8 (e4m3) where the configurations
state bf16: both operands of each product and its result are rounded to
float8 with one scale per tensor, as the program keeps each layer's
operands and output in its compute type.

Parameters are plain tensors in a dict keyed by the program's parameter
names (``Params``), so that the benchmark hands both sides the same
weights by name.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Quant = Callable[[torch.Tensor], torch.Tensor]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FP8_MAX = 448.0  # largest finite float8 e4m3fn


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale (amax to 448),
    back in float32; the gradient passes straight through."""
    amax = x.detach().abs().amax().float().clamp_min(1e-12)
    scale = FP8_MAX / amax
    if x.device.type == "meta":
        return x
    r = (x.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (r - x).detach()


class NoTF32:
    """Context: float32 products in IEEE float32 (TF32 off) for the reference."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
        return False


def conv(p: Params, name: str, x: torch.Tensor, q: Quant, padding: int | None = None,
         stride: int = 1) -> torch.Tensor:
    """``name``'s conv (OIHW weight, bias) on NCHW ``x``; 'same' padding by default."""
    w = p[f"{name}.weight"]
    pad = w.shape[-1] // 2 if padding is None else padding
    return q(F.conv2d(q(x), q(w), p.get(f"{name}.bias"), stride, pad))


def linear(p: Params, name: str, x: torch.Tensor, q: Quant) -> torch.Tensor:
    return q(F.linear(q(x), q(p[f"{name}.weight"]), p.get(f"{name}.bias")))


def layer_norm(p: Params, name: str, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], eps)


def resize(x: torch.Tensor, size: Sequence[int], align_corners: bool) -> torch.Tensor:
    """Bilinear resize of NCHW ``x`` (torch's interpolate, no antialias)."""
    if tuple(size) == tuple(x.shape[-2:]):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=align_corners)


def flow_warp(x: torch.Tensor, flow: torch.Tensor, padding_mode: str = "zeros") -> torch.Tensor:
    """Warp NCHW ``x`` by ``flow`` (N, 2, H, W) in pixels (dx, dy): output pixel
    p samples x at p + flow[p], bilinear, corners aligned."""
    n, _, h, w = x.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=x.device, dtype=x.dtype),
                            torch.arange(w, device=x.device, dtype=x.dtype), indexing="ij")
    gx = 2.0 * (xs + flow[:, 0]) / max(w - 1, 1) - 1.0
    gy = 2.0 * (ys + flow[:, 1]) / max(h - 1, 1) - 1.0
    return F.grid_sample(x, torch.stack([gx, gy], -1), mode="bilinear",
                         padding_mode=padding_mode, align_corners=True)


def sample_nearest(x: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Nearest sample of NCHW ``x`` at integer pixel coordinates ``px``, ``py``
    (N, H, W), zero outside the image."""
    n, c, h, w = x.shape
    valid = (px >= 0) & (px <= w - 1) & (py >= 0) & (py <= h - 1)
    idx = (py.clamp(0, h - 1) * w + px.clamp(0, w - 1)).long().reshape(n, 1, -1)
    out = torch.gather(x.reshape(n, c, h * w), 2, idx.expand(-1, c, -1)).reshape(n, c, *px.shape[1:])
    return out * valid[:, None].to(x.dtype)


def warp_nearest4(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The four nearest taps of ``x`` at p + flow[p] stacked on channels in
    the order (floor, floor), (floor, ceil), (ceil, floor), (ceil, ceil) of
    (x, y); zeros outside."""
    n, _, h, w = x.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=x.device, dtype=x.dtype),
                            torch.arange(w, device=x.device, dtype=x.dtype), indexing="ij")
    vx, vy = xs + flow[:, 0], ys + flow[:, 1]
    taps = ((vx.floor(), vy.floor()), (vx.floor(), vy.ceil()),
            (vx.ceil(), vy.floor()), (vx.ceil(), vy.ceil()))
    return torch.cat([sample_nearest(x, tx, ty) for tx, ty in taps], 1)


def spynet(p: Params, prefix: str, ref: torch.Tensor, supp: torch.Tensor, q: Quant,
           return_levels: Sequence[int] = (5,), levels: int = 6) -> List[torch.Tensor]:
    """SpyNet flow from NCHW frames ``ref`` to ``supp`` in [0, 1]: a 6-level
    pyramid of the ImageNet-normalised frames resized to a multiple of 32,
    refined coarse to fine by five 7x7 convs a level. Returns the flows
    (N, 2, H / 2^(5-l), W / 2^(5-l)) of ``return_levels``, fine to coarse."""
    n, _, h, w = ref.shape
    h_up, w_up = int(math.ceil(h / 32.0) * 32), int(math.ceil(w / 32.0) * 32)
    mean = torch.tensor(IMAGENET_MEAN, device=ref.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=ref.device).view(1, 3, 1, 1)

    def pyramid(x):
        x = (resize(x, (h_up, w_up), False) - mean) / std
        pyr = [x]
        for _ in range(levels - 1):
            pyr.append(F.avg_pool2d(pyr[-1], 2, 2))
        return pyr[::-1]

    ref_p, supp_p = pyramid(ref), pyramid(supp)
    flow = ref.new_zeros((n, 2, h_up // 32, w_up // 32))
    out: List[torch.Tensor] = []
    for level in range(levels):
        if level == 0:
            flow_up, warped = flow, supp_p[0]
        else:
            flow_up = resize(flow, ref_p[level].shape[-2:], True) * 2.0
            warped = flow_warp(supp_p[level], flow_up, "border")
        x = torch.cat([ref_p[level], warped, flow_up], 1)
        for i in range(5):
            x = conv(p, f"{prefix}.basic_module.{level}.convs.{i}", x, q)
            if i < 4:
                x = torch.relu(x)
        flow = flow_up + x
        if level in return_levels:
            s = 2 ** (levels - 1 - level)
            f = resize(flow, (h // s, w // s), False)
            scale = torch.tensor([(w // s) / (w_up // s), (h // s) / (h_up // s)],
                                 device=f.device).view(1, 2, 1, 1)
            out.insert(0, f * scale)
    return out


def adjacent_flows(p: Params, prefix: str, clips: torch.Tensor, q: Quant,
                   return_levels: Sequence[int] = (5,)):
    """``(backward, forward)`` flows of NCHW clips (B, T, 3, H, W): backward[i]
    is the flow from frame i to i+1, forward[i] from frame i+1 to i, each a
    list over ``return_levels`` of (B, T-1, 2, h, w)."""
    b, t = clips.shape[:2]
    earlier = clips[:, :-1].reshape(-1, *clips.shape[2:])
    later = clips[:, 1:].reshape(-1, *clips.shape[2:])
    bwd = spynet(p, prefix, earlier, later, q, return_levels)
    fwd = spynet(p, prefix, later, earlier, q, return_levels)
    shape = lambda f: f.reshape(b, t - 1, *f.shape[1:])  # noqa: E731
    return [shape(f) for f in bwd], [shape(f) for f in fwd]
