"""Image-quality metrics: PSNR and SSIM on channels-last tensors
(port of ``vsrlab_tpu/core/metrics.py``).

Both take ``(B, H, W, C)`` frames in [0, 1]; clips ``(B, T, H, W, C)``
are flattened to frames first. Each returns a 0-d fp32 tensor on the
input's device, so a training loop can sum them without reading them back.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch


def _flatten_frames(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B*T, H, W, C); pass 4-D through."""
    return x.reshape(-1, *x.shape[2:]) if x.dim() == 5 else x


def psnr(sr: torch.Tensor, hr: torch.Tensor, value_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio averaged over frames (per-frame MSE over
    H, W and C, then the mean of the per-frame PSNRs)."""
    sr, hr = _flatten_frames(sr).float(), _flatten_frames(hr).float()
    mse = ((sr - hr) ** 2).mean((1, 2, 3))
    return (10.0 * torch.log10(value_range**2 / mse.clamp_min(1e-12))).mean()


def rgb_to_y(x: torch.Tensor) -> torch.Tensor:
    """RGB [0,1] -> BT.601 limited-range luma (matlab ``rgb2ycbcr``:
    Y in [16/255, 235/255]), keeping a trailing singleton channel."""
    r, g, b = x[..., 0:1], x[..., 1:2], x[..., 2:3]
    return (65.481 * r + 128.553 * g + 24.966 * b + 16.0) / 255.0


def psnr_y(sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
    """PSNR on the BT.601 luma channel (Vimeo / Vid4 protocol)."""
    return psnr(rgb_to_y(_flatten_frames(sr)), rgb_to_y(_flatten_frames(hr)))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(coords**2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _filter2d_valid(x: torch.Tensor, k1d: np.ndarray) -> torch.Tensor:
    """Separable valid-mode filter of ``(B, H, W, C)`` by ``k1d`` along H,
    then W, as a sum of shifted slices in the JAX package's order."""
    size = len(k1d)

    def conv_axis(arr, axis):
        n = arr.shape[axis]
        out = None
        for i in range(size):
            term = arr.narrow(axis, i, n - size + 1) * float(k1d[i])
            out = term if out is None else out + term
        return out

    return conv_axis(conv_axis(x, 1), 2)


def ssim(sr: torch.Tensor, hr: torch.Tensor, value_range: float = 1.0, kernel_size: int = 11,
         sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Structural similarity: Gaussian 11x11 window, sigma 1.5, valid
    filtering, per channel, then the mean (piqa's SSIM defaults)."""
    sr, hr = _flatten_frames(sr).float(), _flatten_frames(hr).float()
    c1, c2 = (k1 * value_range) ** 2, (k2 * value_range) ** 2
    k = _gaussian_kernel(kernel_size, sigma)
    mu_x, mu_y = _filter2d_valid(sr, k), _filter2d_valid(hr, k)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_xx = _filter2d_valid(sr * sr, k) - mu_xx
    sigma_yy = _filter2d_valid(hr * hr, k) - mu_yy
    sigma_xy = _filter2d_valid(sr * hr, k) - mu_xy
    num = (2.0 * mu_xy + c1) * (2.0 * sigma_xy + c2)
    den = (mu_xx + mu_yy + c1) * (sigma_xx + sigma_yy + c2)
    return (num / den).mean()


def ssim_y(sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
    """SSIM on the BT.601 luma channel (Vimeo / Vid4 protocol)."""
    return ssim(rgb_to_y(_flatten_frames(sr)), rgb_to_y(_flatten_frames(hr)))


class MetricCollection:
    """Named bundle of metric functions.

    ``metrics`` maps display names to ``f(sr, hr) -> scalar`` or is a
    sequence of built-in names (the config surface ``metrics: [PSNR,
    SSIM]``). Calling the collection clamps both inputs to [0, 1] and
    returns ``{name: 0-d tensor}``.
    """

    BUILTIN: Dict[str, Callable] = {}  # filled below

    def __init__(self, metrics=None, prefix: str | None = None, postfix: str | None = None):
        if metrics is None:
            self.metrics = {"PSNR": psnr, "SSIM": ssim}
        elif isinstance(metrics, dict):
            self.metrics = dict(metrics)
        else:
            self.metrics = {name: self.BUILTIN[name] for name in resolve_metric_names(metrics)}
        self.prefix, self.postfix = prefix, postfix

    def _name(self, base: str) -> str:
        name = base if self.prefix is None else self.prefix + base
        return name if self.postfix is None else name + self.postfix

    def __call__(self, sr: torch.Tensor, hr: torch.Tensor) -> Dict[str, torch.Tensor]:
        sr, hr = sr.clamp(0.0, 1.0), hr.clamp(0.0, 1.0)
        return {self._name(k): m(sr, hr) for k, m in self.metrics.items()}

    def clone(self, prefix: str | None = None, postfix: str | None = None):
        return MetricCollection(self.metrics, prefix or self.prefix, postfix or self.postfix)


MetricCollection.BUILTIN = {"PSNR": psnr, "SSIM": ssim, "PSNR_Y": psnr_y, "SSIM_Y": ssim_y}


def resolve_metric_names(names) -> tuple:
    """Validate a sequence of built-in metric names up front (a bare string
    is one name); raises with the list of valid names."""
    names = (names,) if isinstance(names, str) else tuple(names)
    unknown = [n for n in names if n not in MetricCollection.BUILTIN]
    if unknown:
        raise ValueError(f"unknown metric(s) {unknown}; built-ins: "
                         f"{sorted(MetricCollection.BUILTIN)}")
    return names


def running_metrics(acc: Dict[str, float], metric: MetricCollection, sr, hr) -> Dict[str, float]:
    """Add one batch's metrics to the running sums ``acc`` (keys in both)."""
    out = metric(sr, hr)
    return {k: acc[k] + float(out[k]) for k in set(acc) & set(out)}
