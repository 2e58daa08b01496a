"""PixelShuffle on channels-last tensors (port of ``vsrlab_tpu/ops/pixel_shuffle.py``).

Torch channel order: channels are ``(C_out, r, r)`` blocks, i.e.
``out[.., h*r+i, w*r+j, c] = in[.., h, w, c*r*r + i*r + j]``.
"""

from __future__ import annotations

import torch


def pixel_shuffle(x: torch.Tensor, upscale_factor: int) -> torch.Tensor:
    """``(..., H, W, C*r^2) -> (..., H*r, W*r, C)``."""
    r = upscale_factor
    *lead, h, w, c = x.shape
    if c % (r * r):
        raise ValueError(f"channels {c} not divisible by r^2={r * r}")
    x = x.reshape(*lead, h, w, c // (r * r), r, r)
    nd = x.dim()
    # (..., h, w, c, rh, rw) -> (..., h, rh, w, rw, c)
    x = x.permute(*range(nd - 5), nd - 5, nd - 2, nd - 4, nd - 1, nd - 3)
    return x.reshape(*lead, h * r, w * r, c // (r * r))


def pixel_unshuffle(x: torch.Tensor, downscale_factor: int) -> torch.Tensor:
    """Inverse of :func:`pixel_shuffle`: ``(..., H*r, W*r, C) -> (..., H, W, C*r^2)``."""
    r = downscale_factor
    *lead, hr, wr, c = x.shape
    if hr % r or wr % r:
        raise ValueError(f"spatial size {(hr, wr)} not divisible by {r}")
    x = x.reshape(*lead, hr // r, r, wr // r, r, c)
    nd = x.dim()
    # (..., h, rh, w, rw, c) -> (..., h, w, c, rh, rw)
    x = x.permute(*range(nd - 5), nd - 5, nd - 3, nd - 1, nd - 4, nd - 2)
    return x.reshape(*lead, hr // r, wr // r, c * r * r)
