"""MLP-Mixer over the (time, patches, channels) axes (port of ``vsrlab_tpu/nn/mlp.py``).

Each :class:`MixerBlock` adds a residual MLP along the channel axis, then
the patch axis, then the time axis of a ``(B, T, P, C)`` token tensor.
Submodules keep flax's names (``Dense_{i}``, ``Mlp_{i}``, ``block_{i}``),
so :func:`vsrlab_tpu_torch.convert.module_state_dict` maps the JAX
params onto them.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from vsrlab_tpu_torch.nn.blocks import Linear


class Dense(nn.Module):
    """The JAX package's torch-initialised ``Dense``: one :class:`Linear`,
    ``Dense_0``, over the last axis."""

    def __init__(self, in_features: int, features: int, dtype=None):
        super().__init__()
        self.Dense_0 = Linear(in_features, features, dtype=dtype)

    def forward(self, x):
        return self.Dense_0(x)


class Mlp(nn.Module):
    """Linear -> exact GELU -> Linear along the last axis (``dim`` wide)."""

    def __init__(self, dim: int, hidden_dim: int, dtype=None):
        super().__init__()
        self.Dense_0 = Dense(dim, hidden_dim, dtype)
        self.Dense_1 = Dense(hidden_dim, dim, dtype)

    def forward(self, x):
        return self.Dense_1(F.gelu(self.Dense_0(x)))


class MixerBlock(nn.Module):
    """Residual channel -> patch -> time mixing on ``(B, T, P, C)``, with the
    JAX block's transposes."""

    def __init__(self, patches_dim: int, channels_dim: int, time_dim: int, exp: int = 2,
                 dtype=None):
        super().__init__()
        self.Mlp_0 = Mlp(channels_dim, exp * channels_dim, dtype)
        self.Mlp_1 = Mlp(patches_dim, exp * patches_dim, dtype)
        self.Mlp_2 = Mlp(time_dim, exp * time_dim, dtype)

    def forward(self, x):
        x = self.Mlp_0(x) + x
        x = x.transpose(2, 3)  # (B, T, C, P)
        x = self.Mlp_1(x) + x
        x = x.permute(0, 2, 3, 1)  # (B, C, P, T)
        x = self.Mlp_2(x) + x
        return x.permute(0, 3, 2, 1)  # (B, T, P, C)


class MlpMixer(nn.Module):
    """``blocks`` x :class:`MixerBlock` (``block_{i}``)."""

    def __init__(self, patches_dim: int, channels_dim: int, time_dim: int, exp: int = 2,
                 blocks: int = 4, dtype=None):
        super().__init__()
        self.blocks = blocks
        for i in range(blocks):
            self.add_module(f"block_{i}",
                            MixerBlock(patches_dim, channels_dim, time_dim, exp, dtype))

    def forward(self, x):
        for i in range(self.blocks):
            x = getattr(self, f"block_{i}")(x)
        return x
