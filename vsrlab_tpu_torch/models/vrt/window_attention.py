"""3-D shifted-window attention with mutual attention (port of
``vsrlab_tpu/models/vrt/window_attention.py``).

* window partition / reverse are reshapes and permutes;
* the shift mask is computed in numpy once per (padded shape, window,
  shift) and cached, in its factored form (at most 8 distinct window
  masks plus a type id per window);
* self attention and both mutual-attention directions run through
  :func:`vsrlab_tpu_torch.ops.window_attention.window_attention`: on the
  card one fused kernel launch a call over every window (logits, bias,
  mask and softmax kept on chip), each head's rows written into its
  channel slice of the pre-projection buffer; on the CPU batched matmuls
  with fp32 logits over chunks of windows;
* mutual attention splits each temporal-window-2 token block into its two
  frames and cross-attends them both ways;
* :meth:`WindowAttention.forward_rows` computes the output rows of some
  frames of each window only (sequence-parallel attention: a rank's own
  frames, against every frame of the window);
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
from vsrlab_tpu_torch.ops.window_attention import window_attention
from vsrlab_tpu_torch.parallel import active_mesh


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
    gradient of its own heads' parameters:
    ``parallel.all_reduce_sharded_grads`` (which the train step runs) sums
    them into the whole gradient and makes the ranks' other gradients
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

    def _block(self, q, k, v, qkv_m, masks, tid, bias):
        """Self (+ mutual) attention of the windows ``q``, ``k``, ``v``
        (B_, nH, N, hd), ``bias`` (nH, N, N), the window types' ``masks``
        (types, N, N) and ``tid`` (B_,); returns the pre-projection concat
        (B_, N, C or 2C), ``[mutual, self]`` on channels, each attention
        writing its rows into its slice."""
        if not self.mut_attn:
            return window_attention(q, k, v, self.scale, bias, masks, tid)
        b, nh, n, hd = q.shape
        c, half = nh * hd, n // 2
        out = q.new_empty((b, n, 2 * c))
        qm, km, vm = qkv_m
        # both directions read the first frame's mask (the JAX package's slice)
        m = None if masks is None else masks[:, :half, :half]
        window_attention(qm[:, :, half:], km[:, :, :half], vm[:, :, :half], self.scale, None, m,
                         tid, out[:, :n - half, :c])
        window_attention(qm[:, :, :half], km[:, :, half:], vm[:, :, half:], self.scale, None, m,
                         tid, out[:, n - half:, :c])
        window_attention(q, k, v, self.scale, bias, masks, tid, out[:, :, c:])
        return out

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
        bias = table[rpi].reshape(n, n, nh).permute(2, 0, 1)

        masks = tid = None
        if isinstance(mask, FactoredMask):
            masks = torch.from_numpy(mask.masks).to(x.device)
            tid = torch.from_numpy(mask.type_ids).to(x.device).long()
            tid = tid.repeat(b_ // tid.shape[0])
        elif mask is not None:
            masks = torch.as_tensor(mask, dtype=torch.float32, device=x.device)
            tid = torch.arange(b_, device=x.device) % masks.shape[0]

        out = self._block(q, k, v, qkv_m, masks, tid, bias)
        if shard is None:
            return self.proj(out)
        # the bias once, on the group's first rank, then the sum over the group
        part = _proj_heads(self.proj, out, lo, lo + nh, hd, 2 if self.mut_attn else 1, lo == 0)
        return _ReduceFromGroup.apply(part, group)

    def forward_rows(self, x, slots: int, positions: Sequence[int], mask=None, tid=None):
        """The output rows of the tokens at temporal ``positions`` of each
        window only, against every token of the window: ``x`` (B*nW, N, C)
        holds whole windows of ``slots`` frames, ``mask`` a
        :class:`FactoredMask` (or None) and ``tid`` the windows' types.
        Returns (B*nW, len(positions) * N / slots, C), the rows in
        ``positions``' order. The projections run over the whole window, as
        in :meth:`forward`; the logits, the softmax and the output rows only
        for those rows. Mutual attention (``slots`` 2) reads the partner
        frame's query for the rows at a frame's positions, as
        :meth:`forward` does. Sequence-parallel attention: a rank computes
        the rows of its own frames. Under :meth:`head_shard` the rank
        computes its heads only, as :meth:`forward` does: their q, k and v
        rows and bias-table columns, their logits and rows, their part of
        the projection, and one all-reduce over the group sums the parts
        (the input's gradient is summed over it in the backward)."""
        b_, n, c = x.shape
        hd = c // self.num_heads
        shard = self.head_shard()
        lo, hi = (0, self.num_heads) if shard is None else shard[1:]
        nh = hi - lo
        s = n // slots
        dev = x.device
        x = x.to(self.qkv_self.dtype or torch.promote_types(x.dtype, self.qkv_self.weight.dtype))
        if shard is not None:
            x = _CopyToGroup.apply(x, shard[0])

        def qkv(lin, t):
            return lin(t) if shard is None else _qkv_heads(lin, t, lo, hi, hd)

        def span(ps):
            return torch.cat([torch.arange(p * s, (p + 1) * s, device=dev) for p in ps])

        def heads(t):
            return t.reshape(b_, t.shape[1], nh, hd).transpose(1, 2)

        rows = span(positions)
        nq = rows.numel()
        q, k, v = qkv(self.qkv_self, x).chunk(3, -1)
        q, k, v = heads(q[:, rows]), heads(k), heads(v)
        rpi = self.rpi[:n, :n][rows].reshape(-1)
        table = self.relative_position_bias_table[:, lo:hi]
        bias = table[rpi].reshape(nq, n, nh).permute(2, 0, 1)
        masks = mut_masks = None
        if mask is not None:
            full = torch.from_numpy(mask.masks).to(dev)
            masks, mut_masks = full[:, rows], full[:, :s, :s]
        if self.mut_attn:
            if slots != 2:
                raise ValueError(f"mutual attention pairs 2 frames a window, not {slots}")
            qm, km, vm = qkv(self.qkv_mut, x + self.pos2.to(x.dtype)).chunk(3, -1)
            qm = heads(qm[:, span([1 - p for p in positions])])
            km, vm = heads(km[:, rows]), heads(vm[:, rows])

        if not self.mut_attn:
            out = window_attention(q, k, v, self.scale, bias, masks, tid)
        else:
            c = nh * hd
            out = q.new_empty((b_, nq, 2 * c))
            for i in range(len(positions)):
                rs = slice(i * s, (i + 1) * s)
                window_attention(qm[:, :, rs], km[:, :, rs], vm[:, :, rs], self.scale, None,
                                 mut_masks, tid, out[:, rs, :c])
            window_attention(q, k, v, self.scale, bias, masks, tid, out[:, :, c:])
        if shard is None:
            return self.proj(out)
        part = _proj_heads(self.proj, out, lo, hi, hd, 2 if self.mut_attn else 1, lo == 0)
        return _ReduceFromGroup.apply(part, shard[0])
