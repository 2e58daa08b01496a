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

With ``links`` (a :class:`~vsrlab_tpu_torch.parallel.TimeLinks`: the
frames split over a ``time`` axis, ``D`` the rank's ``L`` of the clip's
``L * links.size``) the window geometry is the whole clip's: the window
size, the temporal padding and the shift mask read the clip's length, and
each rank fetches the frames of the windows that hold its own
(:meth:`TimeLinks.window_frames`, the block's ``norm1`` output: cheaper
than keys and values, which the rank's own linear layers then compute)
and computes attention rows for its own frames only.

Where ``head_shard_axis`` also splits the heads over a ``model`` axis of
the same mesh, each model rank's time line fetches the window frames on
its own line (the same frames cross each line once, at full channels) and
:meth:`WindowAttention.forward_rows` then splits the heads: the rank's
heads' q, k, v and rows, its part of the projection, one all-reduce over
the model group. Every rank issues the two groups' collectives in one
order: in the forward a block's window frames (the time line's two-rank
groups) come before its attention's all-reduces (the model group); in the
backward each attention's input gradient is summed over the model group
before the frames' gradients return on the time line, since those
gradients are made of them. The ranks of a model group run the same
graph (the same time index, the same plans), so autograd's engine runs
their nodes, and their all-reduces, in the same order, and each time
line's messages travel in groups of their own, posted without blocking.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
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
                 qk_scale: Optional[float] = None, drop_path: float = 0.0, dtype=None,
                 head_shard_axis: Optional[str] = None):
        super().__init__()
        self.window_size, self.shift_size = tuple(window_size), tuple(shift_size)
        self.drop_path = DropPath(drop_path)
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = WindowAttention(dim, self.window_size, num_heads, qkv_bias, qk_scale,
                                    mut_attn, head_shard_axis, dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp = MlpGEGLU(dim, int(dim * mlp_ratio), dim, dtype=dtype)

    def forward(self, x, mask_matrix=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None, links=None):
        if links is None:
            x = x + self.drop_path(self._attention(x, mask_matrix), deterministic, generator)
        else:
            x = x + self.drop_path(self._split_attention(x, mask_matrix, links), deterministic,
                                   generator)
        return x + self.drop_path(self.mlp(self.norm2(x)), deterministic, generator)

    def _attention(self, x, mask_matrix):
        b, d, h, w, c = x.shape
        window_size, shift_size = get_window_size((d, h, w), self.window_size, self.shift_size)
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
        return x

    def _split_attention(self, x, mask_matrix, links):
        """The attention branch of this rank's ``L`` frames of a clip split
        over ``links``: the windows that hold them, assembled from its own
        frames, the frames fetched from their owners and zeros for padding
        (:meth:`TimeLinks.window_frames`), attend with queries of its own
        frames only; the rows go back to their frames. Under a head shard
        ``forward_rows`` computes this rank's heads and sums the group's
        parts (the module docstring gives the collectives' order)."""
        b, l, h, w, c = x.shape
        frames = l * links.size
        (wd, wh, ww), shift = get_window_size((frames, h, w), self.window_size, self.shift_size)
        plan = links.window_plan(frames, wd, shift[0])
        x = links.window_frames(self.norm1(x), plan)
        pad_b, pad_r = (-h) % wh, (-w) % ww
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        if shift[1] or shift[2]:
            x = torch.roll(x, (-shift[1], -shift[2]), (2, 3))
        nw, nwh, nww = len(plan.windows), hp // wh, wp // ww
        # (B, windows, spatial windows, tokens, C): window_partition's order
        x = x.reshape(b, nw, wd, nwh, wh, nww, ww, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
        x = x.reshape(b, nw, nwh * nww, wd * wh * ww, c)
        mask = mask_matrix if any(shift) else None
        types = None
        if mask is not None:
            types = torch.from_numpy(mask.type_ids.reshape(-1, nwh * nww)).to(x.device).long()
            types = types[list(plan.windows)]
        outs = []
        for wins, own in plan.rows:
            tid = None if types is None else types[list(wins)].reshape(-1).repeat(b)
            out = self.attn.forward_rows(x[:, list(wins)].reshape(-1, wd * wh * ww, c), wd, own,
                                         mask, tid)
            outs.append(out.reshape(b, len(wins), nwh * nww, len(own), wh * ww, c))
        x = torch.stack([outs[g][:, i, :, p] for g, i, p in plan.place], 1)
        x = x.reshape(b, l, nwh, nww, wh, ww, c).permute(0, 1, 2, 4, 3, 5, 6)
        x = x.reshape(b, l, hp, wp, c)
        if shift[1] or shift[2]:
            x = torch.roll(x, (shift[1], shift[2]), (2, 3))
        if pad_b or pad_r:
            x = x[:, :, :h, :w]
        return x


class TMSAG(nn.Module):
    """Group of TMSA blocks with alternating shifts."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: Sequence[int] = (6, 8, 8),
                 shift_size: Optional[Sequence[int]] = None, mut_attn: bool = True,
                 mlp_ratio: float = 2.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop_path=0.0, dtype=None,
                 head_shard_axis: Optional[str] = None):
        super().__init__()
        self.depth, self.window_size = depth, tuple(window_size)
        self.base_shift = (tuple(i // 2 for i in window_size) if shift_size is None
                           else tuple(shift_size))
        for i in range(depth):
            rate = drop_path[i] if isinstance(drop_path, (list, tuple)) else drop_path
            self.add_module(f"block_{i}", TMSA(
                dim, num_heads, self.window_size,
                (0, 0, 0) if i % 2 == 0 else self.base_shift, mut_attn, mlp_ratio, qkv_bias,
                qk_scale, float(rate), dtype, head_shard_axis))

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None, links=None):
        _, d, h, w, _ = x.shape
        if links is not None:  # the clip's length, split over the line
            d *= links.size
        window_size, shift_size = get_window_size((d, h, w), self.window_size, self.base_shift)
        dp, hp, wp = (-(-s // ws) * ws for s, ws in zip((d, h, w), window_size))
        # the factored mask: the dense (nW, N, N) one is 1.8 GB for full
        # VRT at 16x256x256
        mask = compute_mask_factored(dp, hp, wp, tuple(window_size), tuple(shift_size))
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x, mask, deterministic, generator, links)
        return x


class RTMSA(nn.Module):
    """``x + Linear(TMSAG(x))``, self attention only."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: Sequence[int],
                 mlp_ratio: float = 2.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop_path=0.0, dtype=None,
                 head_shard_axis: Optional[str] = None):
        super().__init__()
        self.residual_group = TMSAG(dim, depth, num_heads, window_size, None, False, mlp_ratio,
                                    qkv_bias, qk_scale, drop_path, dtype, head_shard_axis)
        self.linear = Linear(dim, dim, True, dtype)

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None, links=None):
        return x + self.linear(self.residual_group(x, deterministic, generator, links))
