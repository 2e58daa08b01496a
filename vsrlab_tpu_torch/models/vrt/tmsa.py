"""TMSA / TMSAG / RTMSA blocks (port of ``vsrlab_tpu/models/vrt/tmsa.py``).

* TMSA: LayerNorm -> pad to a window multiple -> cyclic roll -> window
  partition -> WindowAttention -> reverse -> un-roll -> crop, with residuals
  and a GEGLU FFN;
* TMSAG: a stack of TMSA blocks with alternating zero / half-window
  shifts, sharing one cached shift mask;
* RTMSA: residual TMSAG + linear (the reconstruction trunk).

Everything is (B, D, H, W, C). Each block's two residual branches go
through :class:`DropPath` (stochastic depth), which is the identity in
deterministic mode, the default and the trainer's, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch.nn.functional as F
import torch
from torch import nn

from vsrlab_tpu_torch.models.vrt.window_attention import (
    MlpGEGLU,
    WindowAttention,
    compute_mask_factored,
    get_window_size,
    window_partition,
    window_reverse,
)
from vsrlab_tpu_torch.nn.blocks import LayerNorm, Linear


class DropPath(nn.Module):
    """Per-sample stochastic depth: the identity where ``deterministic`` or
    ``rate == 0``; otherwise each sample is kept whole with probability
    ``1 - rate`` and scaled by ``1 / keep``, or zeroed, its draw taken from
    ``generator`` (required then)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        if deterministic or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("DropPath outside deterministic mode needs a torch.Generator")
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = torch.rand(shape, generator=generator, device=generator.device) < keep
        return torch.where(mask.to(x.device), x / keep, 0.0).to(x.dtype)


class TMSA(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: Sequence[int] = (6, 8, 8),
                 shift_size: Sequence[int] = (0, 0, 0), mut_attn: bool = True,
                 mlp_ratio: float = 2.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop_path: float = 0.0, dtype=None):
        super().__init__()
        self.window_size, self.shift_size = tuple(window_size), tuple(shift_size)
        self.drop_path = DropPath(drop_path)
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = WindowAttention(dim, self.window_size, num_heads, qkv_bias, qk_scale,
                                    mut_attn, dtype=dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp = MlpGEGLU(dim, int(dim * mlp_ratio), dim, dtype=dtype)

    def forward(self, x, mask_matrix=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        b, d, h, w, c = x.shape
        window_size, shift_size = get_window_size((d, h, w), self.window_size, self.shift_size)
        shortcut = x
        x = self.norm1(x)
        pad_d, pad_b, pad_r = ((-s) % ws for s, ws in zip((d, h, w), window_size))
        if pad_d or pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b, 0, pad_d))
        dp, hp, wp = x.shape[1:4]
        shifted = any(s > 0 for s in shift_size)
        if shifted:
            x = torch.roll(x, tuple(-s for s in shift_size), (1, 2, 3))
        attn = self.attn(window_partition(x, window_size), mask_matrix if shifted else None)
        x = window_reverse(attn, window_size, b, dp, hp, wp)
        if shifted:
            x = torch.roll(x, shift_size, (1, 2, 3))
        if pad_d or pad_b or pad_r:
            x = x[:, :d, :h, :w]
        x = shortcut + self.drop_path(x, deterministic, generator)
        return x + self.drop_path(self.mlp(self.norm2(x)), deterministic, generator)


class TMSAG(nn.Module):
    """Group of TMSA blocks with alternating shifts."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: Sequence[int] = (6, 8, 8),
                 shift_size: Optional[Sequence[int]] = None, mut_attn: bool = True,
                 mlp_ratio: float = 2.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop_path=0.0, dtype=None):
        super().__init__()
        self.depth, self.window_size = depth, tuple(window_size)
        self.base_shift = (tuple(i // 2 for i in window_size) if shift_size is None
                           else tuple(shift_size))
        for i in range(depth):
            rate = drop_path[i] if isinstance(drop_path, (list, tuple)) else drop_path
            self.add_module(f"block_{i}", TMSA(
                dim, num_heads, self.window_size,
                (0, 0, 0) if i % 2 == 0 else self.base_shift, mut_attn, mlp_ratio, qkv_bias,
                qk_scale, float(rate), dtype))

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        _, d, h, w, _ = x.shape
        window_size, shift_size = get_window_size((d, h, w), self.window_size, self.base_shift)
        dp, hp, wp = (-(-s // ws) * ws for s, ws in zip((d, h, w), window_size))
        # the factored mask: the dense (nW, N, N) one is 1.8 GB for full
        # VRT at 16x256x256
        mask = compute_mask_factored(dp, hp, wp, tuple(window_size), tuple(shift_size))
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x, mask, deterministic, generator)
        return x


class RTMSA(nn.Module):
    """``x + Linear(TMSAG(x))``, self attention only."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: Sequence[int],
                 mlp_ratio: float = 2.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop_path=0.0, dtype=None):
        super().__init__()
        self.residual_group = TMSAG(dim, depth, num_heads, window_size, None, False, mlp_ratio,
                                    qkv_bias, qk_scale, drop_path, dtype)
        self.linear = Linear(dim, dim, True, dtype)

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        return x + self.linear(self.residual_group(x, deterministic, generator))
