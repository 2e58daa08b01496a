"""Plain reference of VRT (Liang et al., arXiv:2201.12288) as the program
computes it, in float32, written from the published equations and the
program's documented conventions:

* SpyNet flows between adjacent frames at 4 scales, both directions;
* the input concatenated with its neighbours warped by the flow (the four
  nearest taps of each, zero outside): ``3 * 9`` channels, a 3x3 conv;
* seven Stages at scales 1, 2, 4, 8, 4, 2, 1 (a 2x2 space-to-channel or
  channel-to-space reshape, LayerNorm and linear; a group of TMSA blocks
  with temporal window 2 and mutual attention, a linear and residual; a
  group with window (6, 8, 8), a linear and residual; the neighbours
  aligned by flow-guided modulated deformable convolution and fused by a
  GEGLU MLP); skip connections 3 -> 5, 2 -> 6, 1 -> trunk;
* a trunk of six RTMSA groups (the last two with window (1, 8, 8)), a
  LayerNorm, a linear back to the first width added to the features;
* a conv, two (conv, pixel shuffle, LeakyReLU 0.1) steps, two convs, and
  the bilinear x4 of the input added.

TMSA: LayerNorm, zero padding to whole windows, a cyclic shift of half a
window on odd blocks with the Swin mask (-100 between regions), window
attention with a learned relative-position bias (fp32 logits and
softmax), mutual attention between the two frames of a temporal-2 window
(queries of one frame against keys of the other, a sine position code
added to the input of its q, k, v), a projection; then a GEGLU MLP, each
with a residual. Windows and shifts shrink where the input is not larger.

The shift mask is built from each window's region labels, chunk by chunk,
not from a cache of window types; the deformable convolution samples with
``grid_sample``. Clips ``(B, T, H, W, 3)`` outside, parameters by the
program's names.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from port_bench.reference.layers import (Params, Quant, adjacent_flows, conv, exact,
                                         flow_warp, layer_norm, linear, warp_nearest4)
from port_bench.reference.realbasicvsr import spynet_shapes

NUM_FEAT = 64
RESHAPES = ("none", "down", "down", "down", "up", "up", "up")
SCALES = (1, 2, 4, 8, 4, 2, 1)
FLOW_LEVELS = (2, 3, 4, 5)
INDEP_RECONSTS = (-2, -1)
LOGITS_ELEMENTS = 1 << 28  # fp32 logits of one chunk of windows: 1 GiB


# -- parameters ---------------------------------------------------------

def _lin(s: Dict, name: str, cin: int, cout: int) -> None:
    s[f"{name}.weight"] = (cout, cin)
    s[f"{name}.bias"] = (cout,)


def _norm(s: Dict, name: str, c: int) -> None:
    s[f"{name}.weight"] = (c,)
    s[f"{name}.bias"] = (c,)


def _conv(s: Dict, name: str, cin: int, cout: int) -> None:
    s[f"{name}.weight"] = (cout, cin, 3, 3)
    s[f"{name}.bias"] = (cout,)


def _tmsa(s: Dict, name: str, dim: int, heads: int, window, mut: bool, mlp_ratio: float):
    wd, wh, ww = window
    _norm(s, f"{name}.norm1", dim)
    s[f"{name}.attn.relative_position_bias_table"] = ((2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1),
                                                      heads)
    _lin(s, f"{name}.attn.qkv_self", dim, 3 * dim)
    if mut:
        _lin(s, f"{name}.attn.qkv_mut", dim, 3 * dim)
    _lin(s, f"{name}.attn.proj", 2 * dim if mut else dim, dim)
    _norm(s, f"{name}.norm2", dim)
    hidden = int(dim * mlp_ratio)
    _lin(s, f"{name}.mlp.fc11", dim, hidden)
    _lin(s, f"{name}.mlp.fc12", dim, hidden)
    _lin(s, f"{name}.mlp.fc2", hidden, dim)


def param_shapes(upscale: int = 4, depths: Sequence[int] = (8,) * 7 + (4,) * 6,
                 embed_dims: Sequence[int] = (120,) * 7 + (180,) * 6,
                 num_heads: Sequence[int] = (6,) * 13, window_size: Sequence[int] = (6, 8, 8),
                 pa_frames: int = 2, deformable_groups: int = 12,
                 mul_attn_ratio: float = 0.75, mlp_ratio: float = 2.0,
                 **_) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's name and shape, in the program's order."""
    depths, dims, heads, ns = list(depths), list(embed_dims), list(num_heads), len(SCALES)
    s: Dict[str, Tuple[int, ...]] = {}
    spynet_shapes(s, "optical_flow")
    _conv(s, "conv_first", 3 * (1 + 2 * 4), dims[0])
    for i in range(ns):
        st, dim, in_dim = f"stage{i + 1}", dims[i], dims[i - 1]
        if RESHAPES[i] == "none":
            _norm(s, f"{st}.reshape_norm", dim)
        elif RESHAPES[i] == "down":
            _norm(s, f"{st}.reshape_norm", 4 * in_dim)
            _lin(s, f"{st}.reshape_linear", 4 * in_dim, dim)
        else:
            _norm(s, f"{st}.reshape_norm", in_dim // 4)
            _lin(s, f"{st}.reshape_linear", in_dim // 4, dim)
        d1 = int(depths[i] * mul_attn_ratio)
        for b in range(d1):
            _tmsa(s, f"{st}.residual_group1.block_{b}", dim, heads[i],
                  (2, window_size[1], window_size[2]), True, mlp_ratio)
        _lin(s, f"{st}.linear1", dim, dim)
        for b in range(depths[i] - d1):
            _tmsa(s, f"{st}.residual_group2.block_{b}", dim, heads[i], tuple(window_size), False,
                  mlp_ratio)
        _lin(s, f"{st}.linear2", dim, dim)
        pa = f"{st}.pa_deform"
        s[f"{pa}.weight"] = (3, 3, dim, dim)
        s[f"{pa}.bias"] = (dim,)
        _conv(s, f"{pa}.conv_offset_0", (1 + pa_frames // 2) * dim + pa_frames, dim)
        _conv(s, f"{pa}.conv_offset_1", dim, dim)
        _conv(s, f"{pa}.conv_offset_2", dim, dim)
        _conv(s, f"{pa}.conv_offset_3", dim, 3 * 9 * deformable_groups)
        _lin(s, f"{st}.pa_fuse.fc11", 3 * dim, 3 * dim)
        _lin(s, f"{st}.pa_fuse.fc12", 3 * dim, 3 * dim)
        _lin(s, f"{st}.pa_fuse.fc2", 3 * dim, dim)
    _norm(s, "trunk_norm_in", dims[ns - 1])
    _lin(s, "trunk_linear_in", dims[ns - 1], dims[ns])
    indep = [i % len(depths) for i in INDEP_RECONSTS]
    for i in range(ns, len(depths)):
        ws = (1, window_size[1], window_size[2]) if i in indep else tuple(window_size)
        for b in range(depths[i]):
            _tmsa(s, f"trunk_rtmsa_{i}.residual_group.block_{b}", dims[i], heads[i], ws, False,
                  mlp_ratio)
        _lin(s, f"trunk_rtmsa_{i}.linear", dims[i], dims[i])
    _norm(s, "norm", dims[-1])
    _lin(s, "conv_after_body", dims[-1], dims[0])
    _conv(s, "conv_before_upsample", dims[0], NUM_FEAT)
    for i in range(int(math.log2(upscale))):
        _conv(s, f"up_conv_{i}", NUM_FEAT, 4 * NUM_FEAT)
    _conv(s, "up_conv_out", NUM_FEAT, NUM_FEAT)
    _conv(s, "conv_last", NUM_FEAT, 3)
    return s


def fan_in(name: str, shape: Sequence[int]) -> int:
    """The deformable convs' weights are HWIO (kh, kw, Cin, Cout)."""
    if name.endswith("pa_deform.weight"):
        return int(shape[0] * shape[1] * shape[2])
    return int(math.prod(shape[1:]))


def frozen(name: str, optical_flow_train: bool = False, **_) -> bool:
    return not optical_flow_train and name.startswith("optical_flow.")


# -- window attention ----------------------------------------------------

def window_size_for(x_size, window, shift):
    ws, ss = list(window), list(shift)
    for i, n in enumerate(x_size):
        if n <= window[i]:
            ws[i], ss[i] = n, 0
    return tuple(ws), tuple(ss)


def partition(x: torch.Tensor, ws) -> torch.Tensor:
    """(B, D, H, W, C) -> (B * windows, wd*wh*ww, C), windows in (d, h, w) order."""
    b, d, h, w, c = x.shape
    x = x.reshape(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, ws[0] * ws[1] * ws[2], c)


def unpartition(x: torch.Tensor, ws, b: int, d: int, h: int, w: int) -> torch.Tensor:
    x = x.reshape(b, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1], ws[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def region_labels(dp: int, hp: int, wp: int, ws, ss, device) -> torch.Tensor:
    """(windows, tokens) Swin region label of each token of a shifted layout."""
    img = torch.zeros((1, dp, hp, wp, 1), device=device)
    cnt = 0
    for d in (slice(-ws[0]), slice(-ws[0], -ss[0] or None), slice(-ss[0] or dp, None)):
        for h in (slice(-ws[1]), slice(-ws[1], -ss[1] or None), slice(-ss[1] or hp, None)):
            for w in (slice(-ws[2]), slice(-ws[2], -ss[2] or None), slice(-ss[2] or wp, None)):
                img[:, d, h, w] = cnt
                cnt += 1
    return partition(img, ws)[..., 0]


def relative_index(ws, device) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid(*[torch.arange(n, device=device) for n in ws],
                                        indexing="ij")).reshape(3, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + torch.tensor([ws[0] - 1, ws[1] - 1, ws[2] - 1], device=device)
    return (rel[..., 0] * (2 * ws[1] - 1) * (2 * ws[2] - 1) + rel[..., 1] * (2 * ws[2] - 1)
            + rel[..., 2])


def sine_code(h: int, w: int, feats: int, device, temperature: float = 10000.0):
    """Normalised 2-D sine position code, (h*w, 2*feats): y then x, sin/cos interleaved."""
    y = torch.arange(1, h + 1, device=device, dtype=torch.float64)[:, None].expand(h, w)
    x = torch.arange(1, w + 1, device=device, dtype=torch.float64)[None, :].expand(h, w)
    scale, eps = 2 * math.pi, 1e-6
    y, x = y / (h + eps) * scale, x / (w + eps) * scale
    k = torch.arange(feats, device=device, dtype=torch.float64)
    dim_t = temperature ** (2 * torch.div(k, 2, rounding_mode="floor") / feats)

    def code(v):
        v = v[..., None] / dim_t
        return torch.stack([v[..., 0::2].sin(), v[..., 1::2].cos()], -1).reshape(h, w, -1)

    return torch.cat([code(y), code(x)], -1).reshape(h * w, -1).float()


def _attend(q, k, v, scale, bias, mask, q_):
    """softmax((q*scale) k^T + bias + mask) v per head; q (Bw, nH, n, hd)."""
    logits = q_(torch.matmul(q_(q * scale), q_(k).transpose(-1, -2)))
    if bias is not None:
        logits = logits + bias
    if mask is not None:
        logits = logits + mask[:, None]
    return q_(torch.matmul(q_(torch.softmax(logits, -1)), q_(v)))


def window_attention(p: Params, name: str, x: torch.Tensor, heads: int, declared, mut: bool,
                     labels, q_: Quant) -> torch.Tensor:
    """Attention within windows ``x`` (Bw, n, C); ``labels`` (Bw, n) region
    labels of a shifted layout or None."""
    bw, n, c = x.shape
    hd = c // heads
    scale = hd ** -0.5

    def split(t):
        return t.reshape(bw, n, heads, hd).transpose(1, 2)

    q, k, v = (split(t) for t in linear(p, f"{name}.qkv_self", x, q_).chunk(3, -1))
    rel = relative_index(declared, x.device)[:n, :n].reshape(-1)
    bias = p[f"{name}.relative_position_bias_table"][rel].reshape(n, n, heads).permute(2, 0, 1)
    if mut:
        wh, ww = declared[1], declared[2]
        pos = sine_code(wh, ww, c // 2, x.device).repeat(2, 1)
        qm, km, vm = (split(t) for t in
                      linear(p, f"{name}.qkv_mut", x + pos[None], q_).chunk(3, -1))
    chunk = max(1, LOGITS_ELEMENTS // (heads * n * n))
    outs = []
    for s in range(0, bw, chunk):
        sl = slice(s, s + chunk)
        mask = None
        if labels is not None:
            lab = labels[sl]
            mask = torch.where(lab[:, :, None] != lab[:, None, :], -100.0, 0.0)
        o = _attend(q[sl], k[sl], v[sl], scale, bias, mask, q_)
        o = o.transpose(1, 2).reshape(-1, n, c)
        if mut:
            half = n // 2
            mm = None if mask is None else mask[:, :half, :half]
            x1 = _attend(qm[sl, :, half:], km[sl, :, :half], vm[sl, :, :half], scale, None, mm,
                         q_)
            x2 = _attend(qm[sl, :, :half], km[sl, :, half:], vm[sl, :, half:], scale, None, mm,
                         q_)
            mo = torch.cat([x1, x2], 2).transpose(1, 2).reshape(-1, n, c)
            o = torch.cat([mo, o], -1)
        outs.append(o)
    return linear(p, f"{name}.proj", torch.cat(outs, 0), q_)


def geglu(p: Params, name: str, x: torch.Tensor, q_: Quant) -> torch.Tensor:
    return linear(p, f"{name}.fc2", F.gelu(linear(p, f"{name}.fc11", x, q_))
                  * linear(p, f"{name}.fc12", x, q_), q_)


def tmsa_group(p: Params, name: str, x: torch.Tensor, depth: int, heads: int, window,
               mut: bool, q_: Quant) -> torch.Tensor:
    """TMSA blocks ``{name}.block_{i}`` with alternating shifts on (B, D, H, W, C)."""
    b, d, h, w, c = x.shape
    base_shift = tuple(n // 2 for n in window)
    for i in range(depth):
        blk = f"{name}.block_{i}"
        ws, ss = window_size_for((d, h, w), window, base_shift if i % 2 else (0, 0, 0))
        y = layer_norm(p, f"{blk}.norm1", x)
        pads = [(-n) % m for n, m in zip((d, h, w), ws)]
        y = F.pad(y, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        dp, hp, wp = y.shape[1:4]
        labels = None
        if any(ss):
            y = torch.roll(y, tuple(-s for s in ss), (1, 2, 3))
            labels = region_labels(dp, hp, wp, ws, ss, x.device).repeat(b, 1)
        y = window_attention(p, f"{blk}.attn", partition(y, ws), heads, window, mut, labels, q_)
        y = unpartition(y, ws, b, dp, hp, wp)
        if any(ss):
            y = torch.roll(y, ss, (1, 2, 3))
        x = x + y[:, :d, :h, :w]
        x = x + geglu(p, f"{blk}.mlp", layer_norm(p, f"{blk}.norm2", x), q_)
    return x


# -- alignment -----------------------------------------------------------

def modulated_deform_conv(x, offset, mask, weight, bias, q_: Quant):
    """DCNv2 3x3, padding 1, on NCHW ``x`` (N, C, H, W); ``offset`` (N, 2*G*9, H, W)
    with (dy, dx) of group g and tap k at channels 2*(g*9+k) and +1; ``mask``
    (N, G*9, H, W); ``weight`` HWIO (3, 3, C, Cout)."""
    n, c, h, w = x.shape
    groups = offset.shape[1] // 18
    cg = c // groups
    xg = x.reshape(n * groups, cg, h, w)
    off = offset.reshape(n, groups, 9, 2, h, w)
    ys = torch.arange(h, device=x.device, dtype=x.dtype)[:, None]
    xs = torch.arange(w, device=x.device, dtype=x.dtype)[None, :]
    out = 0.0
    for k in range(9):
        ky, kx = divmod(k, 3)
        py = (ys - 1 + ky) + off[:, :, k, 0].reshape(n * groups, h, w)
        px = (xs - 1 + kx) + off[:, :, k, 1].reshape(n * groups, h, w)
        grid = torch.stack([2.0 * px / max(w - 1, 1) - 1.0, 2.0 * py / max(h - 1, 1) - 1.0], -1)
        s = F.grid_sample(xg, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
        s = s.reshape(n, groups, cg, h, w) * mask.reshape(n, groups, 9, h, w)[:, :, k, None]
        out = out + torch.einsum("nchw,co->nohw", q_(s.reshape(n, c, h, w)), q_(weight[ky, kx]))
    return q_(out + bias.view(1, -1, 1, 1))


def align(p: Params, name: str, frames, currents, flows, groups: int, max_mag: float,
          q_: Quant):
    """Flow-guided deformable alignment of NCHW ``frames`` towards ``currents``."""
    warped = flow_warp(frames, flows)
    feat = torch.cat([warped, currents, flows], 1)
    for i in range(3):
        feat = F.leaky_relu(conv(p, f"{name}.conv_offset_{i}", feat, q_), 0.1)
    o1, o2, m = conv(p, f"{name}.conv_offset_3", feat, q_).chunk(3, 1)
    offset = max_mag * torch.tanh(torch.cat([o1, o2], 1))
    offset = offset + flows.flip(1).repeat(1, 9 * groups, 1, 1)
    return modulated_deform_conv(frames, offset, torch.sigmoid(m), p[f"{name}.weight"],
                                 p[f"{name}.bias"], q_)


def frames_nchw(x):  # (B, T, H, W, C) -> (B*T, C, H, W)
    return x.reshape(-1, *x.shape[2:]).permute(0, 3, 1, 2)


def clip_nhwc(x, b):  # (B*T, C, H, W) -> (B, T, H, W, C)
    return x.permute(0, 2, 3, 1).reshape(b, -1, *x.shape[2:], x.shape[1])


def stage(p: Params, i: int, x, fb, ff, depth: int, dim: int, heads: int, window,
          mul_attn_ratio: float, groups: int, q_: Quant):
    st = f"stage{i + 1}"
    b, d, h, w, c = x.shape
    if RESHAPES[i] == "down":
        x = x.reshape(b, d, h // 2, 2, w // 2, 2, c).permute(0, 1, 2, 4, 5, 3, 6)
        x = x.reshape(b, d, h // 2, w // 2, 4 * c)
    elif RESHAPES[i] == "up":
        x = x.reshape(b, d, h, w, 2, 2, c // 4).permute(0, 1, 2, 5, 3, 4, 6)
        x = x.reshape(b, d, 2 * h, 2 * w, c // 4)
    x = layer_norm(p, f"{st}.reshape_norm", x)
    if RESHAPES[i] != "none":
        x = linear(p, f"{st}.reshape_linear", x, q_)
    d1 = int(depth * mul_attn_ratio)
    x = linear(p, f"{st}.linear1", tmsa_group(p, f"{st}.residual_group1", x, d1, heads,
                                               (2, window[1], window[2]), True, q_), q_) + x
    x = linear(p, f"{st}.linear2", tmsa_group(p, f"{st}.residual_group2", x, depth - d1, heads,
                                               tuple(window), False, q_), q_) + x
    b, t = x.shape[:2]
    mag = 10.0 / SCALES[i]
    back = align(p, f"{st}.pa_deform", frames_nchw(x[:, 1:]), frames_nchw(x[:, :-1]),
                 fb.reshape(-1, *fb.shape[2:]), groups, mag, q_)
    fwd = align(p, f"{st}.pa_deform", frames_nchw(x[:, :-1]), frames_nchw(x[:, 1:]),
                ff.reshape(-1, *ff.shape[2:]), groups, mag, q_)
    zeros = torch.zeros_like(x[:, :1])
    xb = torch.cat([clip_nhwc(back, b), zeros], 1)
    xf = torch.cat([zeros, clip_nhwc(fwd, b)], 1)
    return geglu(p, f"{st}.pa_fuse", torch.cat([x, xb, xf], -1), q_)


def _frame_conv(p, name, x, q_):
    b = x.shape[0]
    return clip_nhwc(conv(p, name, frames_nchw(x), q_), b)


def forward(p: Params, x: torch.Tensor, q: Quant = exact, upscale: int = 4,
            depths: Sequence[int] = (8,) * 7 + (4,) * 6,
            embed_dims: Sequence[int] = (120,) * 7 + (180,) * 6,
            num_heads: Sequence[int] = (6,) * 13, window_size: Sequence[int] = (6, 8, 8),
            deformable_groups: int = 12, mul_attn_ratio: float = 0.75,
            optical_flow_train: bool = False, **_):
    """``(sr, lq)`` of clips ``x`` (B, T, H, W, 3)."""
    depths, dims, heads, ns = list(depths), list(embed_dims), list(num_heads), len(SCALES)
    b, t, h, w, c = x.shape
    clips = x.permute(0, 1, 4, 2, 3)
    fb, ff = adjacent_flows(p, "optical_flow", clips, q, FLOW_LEVELS)
    if not optical_flow_train:
        fb, ff = [f.detach() for f in fb], [f.detach() for f in ff]
    # neighbours warped by the finest flows, four nearest taps each
    nb = warp_nearest4(frames_nchw(x[:, 1:]), fb[0].reshape(-1, 2, h, w))
    nf = warp_nearest4(frames_nchw(x[:, :-1]), ff[0].reshape(-1, 2, h, w))
    zeros = x.new_zeros((b, 1, h, w, 4 * c))
    xb = torch.cat([clip_nhwc(nb, b), zeros], 1)
    xf = torch.cat([zeros, clip_nhwc(nf, b)], 1)
    feat = _frame_conv(p, "conv_first", torch.cat([x, xb, xf], -1), q)

    def st(i, y, level):
        return stage(p, i, y, fb[level], ff[level], depths[i], dims[i], heads[i], window_size,
                     mul_attn_ratio, deformable_groups, q)

    x1 = st(0, feat, 0)
    x2 = st(1, x1, 1)
    x3 = st(2, x2, 2)
    x4 = st(3, x3, 3)
    y = st(4, x4, 2)
    y = st(5, y + x3, 1)
    y = st(6, y + x2, 0)
    y = linear(p, "trunk_linear_in", layer_norm(p, "trunk_norm_in", y + x1), q)
    indep = [i % len(depths) for i in INDEP_RECONSTS]
    for i in range(ns, len(depths)):
        ws = (1, window_size[1], window_size[2]) if i in indep else tuple(window_size)
        r = f"trunk_rtmsa_{i}"
        y = y + linear(p, f"{r}.linear",
                       tmsa_group(p, f"{r}.residual_group", y, depths[i], heads[i], ws, False, q),
                       q)
    y = layer_norm(p, "norm", y)
    feat = feat + linear(p, "conv_after_body", y, q)

    z = F.leaky_relu(conv(p, "conv_before_upsample", frames_nchw(feat), q), 0.01)
    for i in range(int(math.log2(upscale))):
        z = F.leaky_relu(F.pixel_shuffle(conv(p, f"up_conv_{i}", z, q), 2), 0.1)
    z = conv(p, "conv_last", conv(p, "up_conv_out", z, q), q)
    base = F.interpolate(frames_nchw(x), size=(h * upscale, w * upscale), mode="bilinear",
                         align_corners=False)
    return clip_nhwc(z + base, b), x
