"""3-D shifted-window attention with mutual attention (port of
``vsrlab_tpu/models/vrt/window_attention.py``).

* window partition / reverse are reshapes and permutes;
* the shift mask is computed in numpy once per (padded shape, window,
  shift) and cached, in its factored form (at most 8 distinct window
  masks plus a type id per window);
* self attention and both mutual-attention directions run as batched
  matmuls over a chunk of windows at a time, with fp32 logits and softmax;
* mutual attention splits each temporal-window-2 token block into its two
  frames and cross-attends them both ways;
* ``head_shard_axis`` splits the heads over an axis of the active mesh
  (``parallel.use_mesh``), as Megatron splits them: every rank holds the
  whole parameters, computes a contiguous range of the heads (the q, k, v
  rows and bias-table columns of those heads: column-parallel) and its
  part of the output projection (those heads' input columns:
  row-parallel), and one all-reduce sums the parts. Outside such a mesh
  the module runs unsharded.
"""

from __future__ import annotations

import math
from functools import lru_cache, reduce
from operator import mul
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from vsrlab_tpu_torch.nn.blocks import Linear
from vsrlab_tpu_torch.parallel import active_mesh, all_reduce_mean, all_reduce_sum

# fp32 logits of one chunk of windows: above this the windows are processed
# in chunks. Unchunked, full VRT at 16x256x256 has (3072, 6, 384, 384) fp32
# logits in one block: 10.9 GB.
LOGITS_BUDGET = 1 << 30


def window_partition(x: torch.Tensor, window_size: Sequence[int]) -> torch.Tensor:
    """(B, D, H, W, C) -> (B*nW, wd*wh*ww, C)."""
    b, d, h, w, c = x.shape
    wd, wh, ww = window_size
    x = x.reshape(b, d // wd, wd, h // wh, wh, w // ww, ww, c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wd * wh * ww, c)


def window_reverse(windows: torch.Tensor, window_size: Sequence[int], b: int, d: int, h: int,
                   w: int) -> torch.Tensor:
    """Inverse of :func:`window_partition`."""
    wd, wh, ww = window_size
    x = windows.reshape(b, d // wd, h // wh, w // ww, wd, wh, ww, -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def get_window_size(
    x_size: Sequence[int],
    window_size: Sequence[int],
    shift_size: Optional[Sequence[int]] = None,
):
    """Shrink window (and zero shift) along dims where input ≤ window
    (reference :43-58)."""
    ws = list(window_size)
    ss = list(shift_size) if shift_size is not None else None
    for i, xs in enumerate(x_size):
        if xs <= window_size[i]:
            ws[i] = xs
            if ss is not None:
                ss[i] = 0
    if ss is None:
        return tuple(ws)
    return tuple(ws), tuple(ss)


@lru_cache(maxsize=64)
def compute_mask(
    dp: int, hp: int, wp: int, window_size: Tuple[int, ...], shift_size: Tuple[int, ...]
) -> np.ndarray:
    """Shift-attention mask (nW, N, N) with 0 / -100 entries
    (reference :60-77). Pure numpy, cached per shape."""
    ws, ss = window_size, shift_size
    img = np.zeros((dp, hp, wp), np.int32)
    cnt = 0
    for d in (slice(-ws[0]), slice(-ws[0], -ss[0] or None), slice(-ss[0] or dp, None)):
        for h in (slice(-ws[1]), slice(-ws[1], -ss[1] or None), slice(-ss[1] or hp, None)):
            for w in (slice(-ws[2]), slice(-ws[2], -ss[2] or None), slice(-ss[2] or wp, None)):
                img[d, h, w] = cnt
                cnt += 1
    # partition into windows
    img = img.reshape(dp // ws[0], ws[0], hp // ws[1], ws[1], wp // ws[2], ws[2])
    img = img.transpose(0, 2, 4, 1, 3, 5).reshape(-1, reduce(mul, ws))
    diff = img[:, None, :] - img[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class FactoredMask(NamedTuple):
    """Window-type factorisation of the shift-attention mask.

    The dense ``compute_mask`` tensor is ``(nW, N, N)``: 1.8 GB for full
    VRT at 16x256x256 (window (6,8,8): 3072 windows x 384^2 entries). But
    the Swin region structure admits only a handful of DISTINCT window
    masks: along each axis,
    every window except the LAST sees one uniform region (the region
    boundaries live at ``size-ws`` and ``size-ss``, both inside the last
    window), so a window's mask depends only on which axes it is last
    along — at most 2³ = 8 distinct ``(N, N)`` masks. We ship those
    (``masks``: (n_types, N, N), ≤ 4.7 MB at N=384) plus a per-window
    type id (``type_ids``: (nW,)), and the attention add becomes a
    type-id gather over one chunk of windows at a time.

    ``labels`` keeps the raw per-axis region labels ((nW_a, ws_a) each)
    for tests.
    """

    masks: np.ndarray
    type_ids: np.ndarray
    labels: Tuple[np.ndarray, np.ndarray, np.ndarray]


@lru_cache(maxsize=64)
def compute_mask_factored(
    dp: int, hp: int, wp: int, window_size: Tuple[int, ...], shift_size: Tuple[int, ...]
) -> FactoredMask:
    """Window-type masks matching ``compute_mask``'s slices
    (reference window_attention.py:61-77): per-axis region 0 =
    ``[0, size-ws)``, region 1 = ``[size-ws, size-ss)``, region 2 =
    ``[size-ss, size)``; cells may attend iff every axis label agrees."""
    labels = []
    for size, ws, ss in zip((dp, hp, wp), window_size, shift_size):
        lab = np.zeros(size, np.int32)
        lab[size - ws :] = 1
        if ss:
            lab[size - ss :] = 2
        labels.append(lab.reshape(size // ws, ws))

    # per axis: row 0 = interior windows (uniform), row 1 = last window
    nws = [l.shape[0] for l in labels]
    axis_rows = [
        np.stack([np.zeros_like(l[0]), l[-1]]) if l.shape[0] > 1 else l[-1:]
        for l in labels
    ]
    n_types = [r.shape[0] for r in axis_rows]
    # combined label per type over window positions (d-major flatten)
    combos = []
    for td in range(n_types[0]):
        for th in range(n_types[1]):
            for tw in range(n_types[2]):
                lab3 = (
                    axis_rows[0][td][:, None, None] * 9
                    + axis_rows[1][th][None, :, None] * 3
                    + axis_rows[2][tw][None, None, :]
                ).reshape(-1)
                combos.append(lab3)
    combos = np.stack(combos)  # (n_types_total, N)
    masks = np.where(
        combos[:, :, None] != combos[:, None, :], -100.0, 0.0
    ).astype(np.float32)

    # per-window type id: is-last flag per axis
    def is_last(nw):
        f = np.zeros(nw, np.int64)
        f[-1] = 1 if nw > 1 else 0
        return f

    fd, fh, fw = (is_last(n) for n in nws)
    sh = (n_types[1] * n_types[2], n_types[2], 1)
    type_ids = (
        fd[:, None, None] * sh[0] + fh[None, :, None] * sh[1] + fw[None, None, :]
    ).reshape(-1).astype(np.int32)
    return FactoredMask(masks, type_ids, tuple(labels))


@lru_cache(maxsize=32)
def relative_position_index(window_size: Tuple[int, ...]) -> np.ndarray:
    """(N, N) index into the relative-position bias table
    (reference :190-209). numpy, cached."""
    wd, wh, ww = window_size
    coords = np.stack(
        np.meshgrid(np.arange(wd), np.arange(wh), np.arange(ww), indexing="ij")
    ).reshape(3, -1)
    rel = coords[:, :, None] - coords[:, None, :]  # 3, N, N
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[..., 0] += wd - 1
    rel[..., 1] += wh - 1
    rel[..., 2] += ww - 1
    rel[..., 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[..., 1] *= 2 * ww - 1
    return rel.sum(-1)


@lru_cache(maxsize=32)
def sine_position_encoding(
    hw: Tuple[int, int], num_pos_feats: int, temperature: float = 10000.0
) -> np.ndarray:
    """Normalised 2-D sine encoding, (1, H*W, 2*num_pos_feats)
    (reference :211-238, normalize=True)."""
    h, w = hw
    scale = 2 * math.pi
    y = np.cumsum(np.ones((h, w)), 0)
    x = np.cumsum(np.ones((h, w)), 1)
    eps = 1e-6
    y = y / (y[-1:, :] + eps) * scale
    x = x / (x[:, -1:] + eps) * scale
    dim_t = np.arange(num_pos_feats, dtype=np.float64)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)
    px = x[:, :, None] / dim_t
    py = y[:, :, None] / dim_t
    px = np.stack([np.sin(px[..., 0::2]), np.cos(px[..., 1::2])], -1).reshape(h, w, -1)
    py = np.stack([np.sin(py[..., 0::2]), np.cos(py[..., 1::2])], -1).reshape(h, w, -1)
    pos = np.concatenate([py, px], -1)  # (H, W, C)
    return pos.reshape(1, h * w, -1).astype(np.float32)


def head_range(num_heads: int, parts: int, index: int) -> Tuple[int, int]:
    """``[start, stop)`` of part ``index`` of ``num_heads`` heads cut into
    ``parts`` contiguous ranges whose sizes differ by at most one (the
    first ``num_heads % parts`` ranges take one head more)."""
    base, extra = divmod(num_heads, parts)
    start = index * base + min(index, extra)
    return start, start + base + (index < extra)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; backward sums the input's gradient over the group
    (each rank's heads give a part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _group_sum(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """Forward sums the ranks' partial outputs over the group; identity
    backward (every rank's part gets the whole output's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        return _group_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` in a new tensor, added in fp32 (a bf16
    sum is rounded once, at the end) and returned in ``x``'s dtype."""
    out = x.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(out, group=group)
    return out.to(x.dtype)


def _qkv_heads(lin: Linear, x: torch.Tensor, lo: int, hi: int, hd: int) -> torch.Tensor:
    """The q, k and v features of heads ``[lo, hi)`` of ``lin(x)`` (a fused
    q | k | v projection): column-parallel."""
    dt = lin.dtype or torch.promote_types(x.dtype, lin.weight.dtype)
    heads = slice(lo * hd, hi * hd)
    w = lin.weight.view(3, -1, lin.weight.shape[1])[:, heads].reshape(-1, lin.weight.shape[1])
    b = None if lin.bias is None else lin.bias.view(3, -1)[:, heads].reshape(-1).to(dt)
    return F.linear(x.to(dt), w.to(dt), b)


def _proj_heads(lin: Linear, x: torch.Tensor, lo: int, hi: int, hd: int, halves: int,
                bias: bool) -> torch.Tensor:
    """What heads ``[lo, hi)`` contribute to ``lin`` of the whole input, from
    their features ``x`` in each of the input's ``halves`` (mutual | self):
    row-parallel; the bias where ``bias``."""
    dt = lin.dtype or torch.promote_types(x.dtype, lin.weight.dtype)
    out = lin.weight.shape[0]
    w = lin.weight.view(out, halves, -1)[:, :, lo * hd:hi * hd].reshape(out, -1)
    return F.linear(x.to(dt), w.to(dt), lin.bias.to(dt) if bias else None)


class MlpGEGLU(nn.Module):
    """Gated-GELU MLP: ``fc2(gelu(fc11(x)) * fc12(x))``, exact (erf) GELU."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int, dtype=None):
        super().__init__()
        self.fc11 = Linear(in_features, hidden_features, dtype=dtype)
        self.fc12 = Linear(in_features, hidden_features, dtype=dtype)
        self.fc2 = Linear(hidden_features, out_features, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc11(x)) * self.fc12(x))


class WindowAttention(nn.Module):
    """Multi-head self attention (+ optional mutual attention) within
    windows. Input ``x``: (B*nW, N, C); ``mask``: a :class:`FactoredMask`,
    a dense ``(nW, N, N)`` tensor or array, or None.

    ``window_size`` is the DECLARED window: it sizes the relative-position
    bias table, which is indexed ``[:N, :N]`` when the input's window is
    smaller, so the same parameters serve every input size.
    ``head_shard_axis`` names the mesh axis that splits the heads (tensor
    parallelism) inside ``parallel.use_mesh`` of a mesh with that axis;
    elsewhere it has no effect. A sharded backward leaves each rank the
    gradient of its own heads' parameters: :func:`all_reduce_head_grads`
    sums them into the whole gradient and makes the ranks' other gradients
    agree.
    """

    def __init__(self, dim: int, window_size: Sequence[int], num_heads: int,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None, mut_attn: bool = True,
                 head_shard_axis: Optional[str] = None, dtype=None):
        super().__init__()
        self.dim, self.num_heads, self.mut_attn = dim, num_heads, mut_attn
        self.head_shard_axis = head_shard_axis
        self.window_size = tuple(window_size)
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        wd, wh, ww = self.window_size
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1), num_heads))
        self.register_buffer(
            "rpi", torch.from_numpy(relative_position_index(self.window_size)), persistent=False)
        self.qkv_self = Linear(dim, 3 * dim, qkv_bias, dtype)
        if mut_attn:
            pos = torch.from_numpy(sine_position_encoding((wh, ww), dim // 2))
            self.register_buffer("pos2", pos.repeat(1, 2, 1), persistent=False)
            self.qkv_mut = Linear(dim, 3 * dim, qkv_bias, dtype)
        self.proj = Linear(2 * dim if mut_attn else dim, dim, True, dtype)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        with torch.no_grad():
            # normal(0, 0.02) truncated at two standard deviations
            self.relative_position_bias_table.normal_(0.0, 0.02, generator=generator)
            self.relative_position_bias_table.clamp_(-0.04, 0.04)

    def _core(self, q, k, v, masks, tid, bias):
        """Windowed attention on one chunk: ``q``, ``k``, ``v`` (Bc, nH, nq, hd)."""
        nq = q.shape[2]
        attn = torch.matmul((q * self.scale).float(), k.float().transpose(-1, -2))
        if bias is not None:
            attn = attn + bias
        if masks is not None:
            attn = attn + masks[tid, :nq, :nq][:, None]
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v)
        return out.transpose(1, 2).reshape(out.shape[0], nq, -1)

    def _block(self, q, k, v, qkv_m, masks, tid, bias):
        """Self (+ mutual) attention for one chunk of windows; returns the
        pre-projection concat (Bc, N, C or 2C), ``[mutual, self]`` on channels."""
        x_out = self._core(q, k, v, masks, tid, bias)
        if not self.mut_attn:
            return x_out
        qm, km, vm = qkv_m
        half = q.shape[2] // 2
        x1 = self._core(qm[:, :, half:], km[:, :, :half], vm[:, :, :half], masks, tid, None)
        x2 = self._core(qm[:, :, :half], km[:, :, half:], vm[:, :, half:], masks, tid, None)
        return torch.cat([torch.cat([x1, x2], 1), x_out], -1)

    def head_shard(self):
        """``(group, start, stop)``: this rank's heads under the active mesh,
        or None where it does not shard them (no ``head_shard_axis``, no
        active mesh, or one without that axis or with it of size 1)."""
        mesh = active_mesh()
        axis = self.head_shard_axis
        if axis is None or mesh is None or mesh.shape.get(axis, 1) == 1:
            return None
        start, stop = head_range(self.num_heads, mesh.shape[axis], mesh.axis_index(axis))
        return mesh.axis_group(axis), start, stop

    def forward(self, x, mask=None):
        b_, n, c = x.shape
        hd = c // self.num_heads
        shard = self.head_shard()
        if shard is None:
            lo, nh = 0, self.num_heads
            qkv_self = self.qkv_self(x)
            qkv_mut = self.qkv_mut(x + self.pos2.to(x.dtype)) if self.mut_attn else None
        else:
            group, lo, hi = shard
            nh = hi - lo
            x = _CopyToGroup.apply(x, group)
            qkv_self = _qkv_heads(self.qkv_self, x, lo, hi, hd)
            qkv_mut = (_qkv_heads(self.qkv_mut, x + self.pos2.to(x.dtype), lo, hi, hd)
                       if self.mut_attn else None)

        def heads(t):
            return t.reshape(b_, n, nh, hd).transpose(1, 2)  # B_, nH, N, hd

        q, k, v = (heads(t) for t in qkv_self.chunk(3, -1))
        qkv_m = None if qkv_mut is None else tuple(heads(t) for t in qkv_mut.chunk(3, -1))
        rpi = self.rpi[:n, :n].reshape(-1)
        table = self.relative_position_bias_table[:, lo:lo + nh]
        bias = table[rpi].reshape(n, n, nh).permute(2, 0, 1)[None]

        masks = tid = None
        if isinstance(mask, FactoredMask):
            masks = torch.from_numpy(mask.masks).to(x.device)
            tid = torch.from_numpy(mask.type_ids).to(x.device).long()
            tid = tid.repeat(b_ // tid.shape[0])
        elif mask is not None:
            masks = torch.as_tensor(mask, dtype=torch.float32, device=x.device)
            tid = torch.arange(b_, device=x.device) % masks.shape[0]

        chunk = max(1, LOGITS_BUDGET // (max(nh, 1) * n * n * 4))
        outs = []
        for s in range(0, b_, chunk):
            sl = slice(s, s + chunk)
            outs.append(self._block(
                q[sl], k[sl], v[sl], None if qkv_m is None else tuple(t[sl] for t in qkv_m),
                masks, None if tid is None else tid[sl], bias))
        out = outs[0] if len(outs) == 1 else torch.cat(outs, 0)
        if shard is None:
            return self.proj(out)
        # the bias once, on the group's first rank, then the sum over the group
        part = _proj_heads(self.proj, out, lo, lo + nh, hd, 2 if self.mut_attn else 1, lo == 0)
        return _ReduceFromGroup.apply(part, group)


def all_reduce_head_grads(model: nn.Module) -> None:
    """Make every rank of each head-sharding group hold the same, unsharded
    gradient (inside the ``use_mesh`` of the backward). The head-sharded
    attention modules' parameters are summed over the group: each rank's
    backward gave only its heads' part of them (a gradient it did not
    reach is taken as zeros). Every other parameter's gradient is averaged
    over the group: each rank computed the whole of it, but on the card
    the ranks' sums differ by rounding (cuDNN's and the sampler's
    backwards add in no fixed order), and replicas stepped on them would
    drift apart."""
    by_group, sharded = {}, set()
    for m in model.modules():
        if isinstance(m, WindowAttention) and (shard := m.head_shard()) is not None:
            for p in m.parameters():
                if p.grad is None:  # the projection's bias, on the ranks that skip it
                    p.grad = torch.zeros_like(p)
                by_group.setdefault(shard[0], []).append(p.grad)
                sharded.add(p)
    rest = [p.grad for p in model.parameters() if p not in sharded and p.grad is not None]
    for group, grads in by_group.items():
        all_reduce_sum(grads, group)
        all_reduce_mean(rest, group)
