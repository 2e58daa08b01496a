"""Torch-exact resizes as interpolation-matrix products
(port of ``vsrlab_tpu/ops/resize.py``).

1-D interpolation along an axis is a linear map: the ``(out, in)`` weight
matrix is built once per shape (numpy, cached) and contracted with the
image in fp32, one product per resized axis.

* ``align_corners=True``:  ``src = dst * (in - 1) / (out - 1)``
* ``align_corners=False``: ``src = (dst + 0.5) * in / out - 0.5``, clamped
  at 0 for linear and unclamped for cubic.
* cubic convolution uses torch's ``a = -0.75`` with border-clamped taps.

No antialiasing.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _linear_weights(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """Dense (out, in) linear-interpolation matrix with torch semantics."""
    if out_size == in_size:
        return np.eye(out_size, dtype=np.float32)
    dst = np.arange(out_size, dtype=np.float64)
    if align_corners:
        scale = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        src = dst * scale
    else:
        src = np.clip((dst + 0.5) * (in_size / out_size) - 0.5, 0.0, in_size - 1)
    x0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    x1 = np.clip(x0 + 1, 0, in_size - 1)
    frac = src - x0
    w = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    np.add.at(w, (rows, x0), 1.0 - frac)
    np.add.at(w, (rows, x1), frac)
    return w.astype(np.float32)


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    t = np.abs(t)
    return np.where(
        t <= 1.0,
        ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0,
        np.where(t < 2.0, (((t - 5.0) * t + 8.0) * t - 4.0) * a, 0.0),
    )


@functools.lru_cache(maxsize=256)
def _cubic_weights(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """Dense (out, in) bicubic matrix with torch semantics (4 taps, border clamp)."""
    if out_size == in_size:
        return np.eye(out_size, dtype=np.float32)
    dst = np.arange(out_size, dtype=np.float64)
    if align_corners:
        scale = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        src = dst * scale
    else:
        src = (dst + 0.5) * (in_size / out_size) - 0.5
    x0 = np.floor(src).astype(np.int64)
    frac = src - x0
    w = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    for tap in range(-1, 3):
        np.add.at(w, (rows, np.clip(x0 + tap, 0, in_size - 1)), _cubic_kernel(tap - frac))
    return w.astype(np.float32)


_WEIGHTS = {
    "bilinear": _linear_weights,
    "linear": _linear_weights,
    "trilinear": _linear_weights,
    "bicubic": _cubic_weights,
}


def _weights_tensor(method: str, in_size: int, out_size: int, align_corners: bool,
                    device: torch.device) -> torch.Tensor:
    """The transposed (in, out) matrix as an fp32 tensor on ``device``; a
    normal tensor even when first asked for in inference mode, so that a
    training step may save it for its backward."""
    w = _WEIGHTS[method](in_size, out_size, align_corners)
    with torch.inference_mode(False):
        return torch.from_numpy(np.ascontiguousarray(w.T)).to(device)


_weights_on = functools.lru_cache(maxsize=256)(_weights_tensor)


def _apply_axis(x: torch.Tensor, wt: torch.Tensor, axis: int) -> torch.Tensor:
    """Contract ``axis`` of x with the (in, out) matrix in fp32; keep x.dtype."""
    out = torch.matmul(x.float().movedim(axis, -1), wt)
    return out.movedim(-1, axis).to(x.dtype)


def resize(
    x: torch.Tensor,
    size: Sequence[int],
    method: str = "bilinear",
    align_corners: bool = False,
) -> torch.Tensor:
    """Resize the spatial dims of a channels-last tensor: ``(..., H, W, C)``,
    or ``(..., T, H, W, C)`` when ``len(size) == 3``."""
    if method not in _WEIGHTS:
        raise ValueError(f"unknown resize method: {method}")
    n_sp = len(size)
    for axis, out_size in zip(range(x.dim() - 1 - n_sp, x.dim() - 1), size):
        in_size = x.shape[axis]
        if in_size != out_size:
            # while torch.export traces, a constant of the graph, never a cached tracing tensor
            weights = _weights_tensor if torch.compiler.is_exporting() else _weights_on
            wt = weights(method, in_size, out_size, align_corners, x.device)
            x = _apply_axis(x, wt, axis)
    return x


def resize_bilinear(x, size, align_corners: bool = False):
    """``F.interpolate(mode='bilinear')`` on ``(..., H, W, C)``."""
    return resize(x, size, "bilinear", align_corners)


def resize_bicubic(x, size, align_corners: bool = False):
    """``F.interpolate(mode='bicubic')`` on ``(..., H, W, C)``."""
    return resize(x, size, "bicubic", align_corners)


def resize_trilinear(x, size, align_corners: bool = False):
    """``F.interpolate(mode='trilinear')`` on ``(..., T, H, W, C)``."""
    return resize(x, size, "trilinear", align_corners)


def scale_by(x, factor: float, method: str = "bilinear", align_corners: bool = False):
    """Resize the 2-D spatial dims by a scale factor (torch ``scale_factor=``)."""
    h, w = x.shape[-3], x.shape[-2]
    return resize(x, (int(h * factor), int(w * factor)), method, align_corners)


def bicubic_down(clip: np.ndarray, scale: int) -> np.ndarray:
    """Bicubic /``scale`` of numpy frames ``(..., H, W, C)`` to ``(H // scale,
    W // scale)``, clipped to [0, 1], in fp32: OpenCV's ``INTER_CUBIC``
    (a = -0.75, half-pixel centres, border-clamped taps) as the product of
    the rows' matrix, then the columns', without OpenCV."""
    clip = np.asarray(clip, np.float32)
    *lead, h, w, c = clip.shape
    ho, wo = h // scale, w // scale
    frames = clip.reshape(-1, h, w * c)
    rows = np.matmul(_cubic_weights(h, ho, False), frames).reshape(-1, ho, w, c)
    out = np.matmul(_cubic_weights(w, wo, False), rows.reshape(-1, w, c))
    return np.clip(out.reshape(*lead, ho, wo, c), 0.0, 1.0)
