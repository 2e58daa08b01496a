"""Grid sampling and optical-flow warping on channels-last tensors
(port of ``vsrlab_tpu/ops/warp.py``).

Samples at PIXEL coordinates: :func:`flow_warp` adds the flow to the
integer pixel grid and samples there directly, so an integer flow warps
bit-exactly (a normalise / ``F.grid_sample`` round trip costs an ulp).
The bilinear taps have three formulations (``impl``): ``"plain"`` is a
gather of the four window corners in torch; ``"fused"`` is one
hand-written kernel that reads the four corners straight from the
channels-last image (:mod:`vsrlab_tpu_torch.ops.bilinear_sample`);
``"take"`` is the JAX package's packed-window sampler, which packs the
image into a table of ``2 x 2gp x C`` windows and reads ONE table row for
each output pixel through the row gather kernel of
:mod:`vsrlab_tpu_torch.ops.packed_gather`, with the weights and the fold
in torch, as the JAX package ships it.

Conventions: images ``(N, H, W, C)``, grids ``(N, Ho, Wo, 2)`` with
normalised ``(x, y)`` in [-1, 1], flows ``(N, H, W, 2)`` with pixel
displacements ``(dx, dy)``. Compute is fp32; results come back in
``x.dtype``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vsrlab_tpu_torch.ops.bilinear_sample import bilinear_sample
from vsrlab_tpu_torch.ops.packed_gather import fold_window, packed_row_gather

SAMPLER_IMPLS = ("plain", "take", "fused")


def _unnormalize(coord, size: int, align_corners: bool):
    """[-1, 1] -> pixel coordinates, torch convention."""
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _reflect(coord, low: float, high: float):
    """Reflect coordinates into [low, high] (torch grid_sampler reflection)."""
    span = high - low
    if span <= 0:
        return torch.full_like(coord, low)
    coord = torch.remainder(torch.abs(coord - low), 2.0 * span)
    return torch.where(coord > span, 2.0 * span - coord, coord) + low


def _pad_coords(ix, iy, h: int, w: int, padding_mode: str, align_corners: bool):
    """Apply the padding mode to continuous sample coordinates."""
    if padding_mode == "border":
        ix = ix.clamp(0.0, w - 1)
        iy = iy.clamp(0.0, h - 1)
    elif padding_mode == "reflection":
        if align_corners:
            ix = _reflect(ix, 0.0, float(w - 1))
            iy = _reflect(iy, 0.0, float(h - 1))
        else:
            ix = _reflect(ix, -0.5, w - 0.5)
            iy = _reflect(iy, -0.5, h - 0.5)
        # torch clips reflected coords to the border as a final step
        ix = ix.clamp(0.0, w - 1)
        iy = iy.clamp(0.0, h - 1)
    elif padding_mode != "zeros":
        raise ValueError(f"unknown padding_mode: {padding_mode}")
    return ix, iy


def _window_group(c: int, n_idx: int = 0, itemsize: int = 4) -> int:
    """x-positions packed into one table row: about 32 elements of
    ``4*gp*C`` a row, and ``gp`` halves until the gathered-window tensor
    (``n_idx`` rows) fits 1 GiB (the JAX package's heuristic)."""
    gp = max(1, min(8, 32 // max(c, 1)))
    while gp > 1 and n_idx * 4 * gp * c * itemsize > 1 << 30:
        gp //= 2
    return gp


def packed_table(x: torch.Tensor, gp: int) -> torch.Tensor:
    """The packed-window table of ``x`` ``(N, H, W, C)``: ``(N, (Hp-1)*(Wg-1),
    4*gp*C)`` in ``x.dtype``, ``Hp = max(H, 2)``, ``Wg = max(ceil(W/gp), 2)``.
    Row ``(y, g)`` holds image rows ``y, y+1`` x x-groups ``g, g+1`` as
    ``(2, 2gp, C)``; rows past ``H`` and columns past ``W`` are zero, so an
    image too small for one window is padded up to one."""
    n, h, w, c = x.shape
    hp, wp = max(h, 2), max(-(-w // gp), 2) * gp
    if (hp, wp) != (h, w):
        x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
    xp = x.reshape(n, hp, wp // gp, gp * c)
    xp2 = torch.cat([xp[:, :, :-1], xp[:, :, 1:]], -1)
    xp4 = torch.cat([xp2[:, :-1], xp2[:, 1:]], -1)
    return xp4.reshape(n, -1, 4 * gp * c)


def packed_fields(ix, iy, h: int, w: int, gp: int, padding_mode: str):
    """Per-pixel operands of the packed sampler for padded fp32 coordinates
    ``ix``, ``iy`` ``(N, ...)``: ``(idx, rx0, py0, wx0, wx1, wy0, wy1)``,
    each ``(N, P)``. ``idx`` names the table row, ``rx0`` / ``py0`` the
    slot of the first corner inside its window (int32), the weights are
    per axis (fp32). In ``zeros`` mode an axis weight is zero where its
    corner lies outside the image: the valid region is a box, so per-axis
    masks equal per-corner masks. The table's zero padding (see
    :func:`packed_table`) is only ever addressed with zero weight."""
    n = ix.shape[0]
    wg = max(-(-w // gp), 2)
    x0f, y0f = torch.floor(ix), torch.floor(iy)
    wx1, wy1 = ix - x0f, iy - y0f
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    if padding_mode == "zeros":
        zero = torch.zeros_like(wx0)
        wx0 = torch.where((x0f >= 0) & (x0f <= w - 1), wx0, zero)
        wx1 = torch.where((x0f + 1 >= 0) & (x0f + 1 <= w - 1), wx1, zero)
        wy0 = torch.where((y0f >= 0) & (y0f <= h - 1), wy0, zero)
        wy1 = torch.where((y0f + 1 >= 0) & (y0f + 1 <= h - 1), wy1, zero)
    # the float clamp bounds the int cast; a corner outside its window's
    # slots carries exactly zero weight
    x0c = x0f.clamp(-1.0, w).int()
    y0c = y0f.clamp(-1.0, h).int()
    y0i = y0c.clamp(0, max(h - 2, 0))
    g0 = torch.clamp(torch.div(x0c.clamp(0, max(w - 2, 0)), gp, rounding_mode="floor"),
                     max=wg - 2)
    fields = (y0i * (wg - 1) + g0, x0c - g0 * gp, y0c - y0i, wx0, wx1, wy0, wy1)
    return tuple(f.reshape(n, -1).contiguous() for f in fields)


def _bilinear_packed(x, ix, iy, padding_mode: str, window_group: int | None):
    """Bilinear sampling through the packed-window table, the row gather
    kernel of :mod:`~vsrlab_tpu_torch.ops.packed_gather` and the fold in
    torch, in ``x.dtype``. Every shape goes through the kernel: where the
    JAX package gives an image of fewer than 2 rows or 2 x-groups to its
    four-corner gather, the table here is zero-padded to one window
    instead. Under a gradient the gather runs as
    :class:`~vsrlab_tpu_torch.ops.packed_gather.PackedRowGather`."""
    n, h, w, c = x.shape
    gp = window_group or _window_group(c, ix.numel(), x.element_size())
    xf = packed_table(x, gp)
    fields = packed_fields(ix, iy, h, w, gp, padding_mode)
    out = fold_window(packed_row_gather(xf, fields[0]), *fields[1:], c)
    return out.reshape(*ix.shape, c)


def sample_pixel_coords(
    x: torch.Tensor,
    ix: torch.Tensor,
    iy: torch.Tensor,
    mode: str = "bilinear",
    padding_mode: str = "zeros",
    align_corners: bool = False,
    window_group: int | None = None,
    impl: str | None = None,
) -> torch.Tensor:
    """Sample ``x`` ``(N, H, W, C)`` at continuous pixel coordinates
    ``ix``, ``iy`` ``(N, Ho, Wo)`` (no [-1, 1] round trip).

    ``impl`` picks the bilinear formulation: ``"plain"`` / ``None`` the
    four-corner gather in torch; ``"fused"`` the sampler kernel on the
    image itself, the one to serve with; ``"take"`` the packed-window
    sampler with ``window_group`` x-positions a table row (``None``: the
    heuristic), kept as the counterpart of the formulation the JAX package
    ships (row gather kernel, weights and fold in torch) and slower than
    either of the others. Both have a gradient, the kernel forward and
    PyTorch ops backward (:class:`~vsrlab_tpu_torch.ops.bilinear_sample.BilinearSample`;
    :class:`~vsrlab_tpu_torch.ops.packed_gather.PackedRowGather`, whose
    table, weights and fold are torch ops, so the gradient reaches the
    image and the coordinates). Both take every image size;
    ``window_group`` affects ``"take"`` only.
    """
    n, h, w, c = x.shape
    if impl not in (None, *SAMPLER_IMPLS):
        raise ValueError(f"unknown sampler formulation: {impl}")
    ix, iy = _pad_coords(ix.float(), iy.float(), h, w, padding_mode, align_corners)
    if mode == "bilinear" and impl == "fused":
        out = bilinear_sample(x.contiguous(), ix.reshape(n, -1).contiguous(),
                              iy.reshape(n, -1).contiguous(), padding_mode == "zeros")
        return out.reshape(*ix.shape, c)
    if mode == "bilinear" and impl == "take":
        return _bilinear_packed(x.contiguous(), ix, iy, padding_mode, window_group)
    x_flat = x.reshape(n, h * w, c).float()

    def corner(idx_y, idx_x, weight):
        """One corner's values times its weight; zero weight outside in zeros mode."""
        if padding_mode == "zeros":
            valid = (idx_x >= 0) & (idx_x <= w - 1) & (idx_y >= 0) & (idx_y <= h - 1)
            weight = torch.where(valid, weight, torch.zeros_like(weight))
        # the float clamp bounds the int cast (zeros mode can give any coordinate);
        # a NaN coordinate reads pixel 0, as XLA's clamped gather does
        yi = idx_y.nan_to_num(0.0).clamp(0, h - 1).long()
        xi = idx_x.nan_to_num(0.0).clamp(0, w - 1).long()
        lin = (yi * w + xi).reshape(n, -1, 1).expand(-1, -1, c)
        vals = torch.gather(x_flat, 1, lin).reshape(*idx_y.shape, c)
        return vals * weight[..., None]

    if mode == "bilinear":
        x0 = torch.floor(ix)
        y0 = torch.floor(iy)
        wx1 = ix - x0
        wy1 = iy - y0
        wx0 = 1.0 - wx1
        wy0 = 1.0 - wy1
        out = (
            corner(y0, x0, wy0 * wx0)
            + corner(y0, x0 + 1.0, wy0 * wx1)
            + corner(y0 + 1.0, x0, wy1 * wx0)
            + corner(y0 + 1.0, x0 + 1.0, wy1 * wx1)
        )
    elif mode == "nearest":
        # torch rounds with nearbyint (round half to even), as torch.round does
        out = corner(torch.round(iy), torch.round(ix), torch.ones_like(ix))
    else:
        raise ValueError(f"unknown mode: {mode}")
    return out.to(x.dtype)


def grid_sample(
    x: torch.Tensor,
    grid: torch.Tensor,
    mode: str = "bilinear",
    padding_mode: str = "zeros",
    align_corners: bool = False,
) -> torch.Tensor:
    """Torch-exact ``grid_sample`` on channels-last images:
    ``x`` ``(N, H, W, C)``, ``grid`` ``(N, Ho, Wo, 2)`` -> ``(N, Ho, Wo, C)``."""
    _, h, w, _ = x.shape
    ix = _unnormalize(grid[..., 0].float(), w, align_corners)
    iy = _unnormalize(grid[..., 1].float(), h, align_corners)
    return sample_pixel_coords(x, ix, iy, mode, padding_mode, align_corners)


def flow_warp(
    x: torch.Tensor,
    flow: torch.Tensor,
    interpolation: str = "bilinear",
    padding_mode: str = "zeros",
    align_corners: bool = True,
    impl: str | None = None,
) -> torch.Tensor:
    """Warp ``x`` ``(N, H, W, C)`` by ``flow`` ``(N, H, W, 2)``: output
    pixel ``p`` samples ``x`` at ``p + flow[p]``. ``impl`` is the bilinear
    formulation of :func:`sample_pixel_coords` (default: the plain gather;
    the flow models pass ``"fused"``).

    With ``align_corners=False`` the torch reference's normalise (size-1
    convention) / unnormalise (align_corners=False) round trip is not an
    identity, so it is reproduced; with ``True`` it is, and is skipped.
    ``nearest4`` returns the four nearest taps stacked on channels,
    ``(N, H, W, 4*C)``, in the order (floor, floor), (floor, ceil),
    (ceil, floor), (ceil, ceil) of (x, y); ``ceil`` equals ``floor`` at an
    exact integer, and in ``zeros`` mode each tap has its own validity.
    """
    _, h, w, _ = x.shape
    ys, xs = torch.meshgrid(
        torch.arange(h, device=x.device, dtype=torch.float32),
        torch.arange(w, device=x.device, dtype=torch.float32),
        indexing="ij",
    )
    vx = xs + flow[..., 0].float()
    vy = ys + flow[..., 1].float()
    if not align_corners:
        vx = _unnormalize(2.0 * vx / max(w - 1, 1) - 1.0, w, False)
        vy = _unnormalize(2.0 * vy / max(h - 1, 1) - 1.0, h, False)
    if interpolation == "nearest4":
        taps = ((torch.floor(vx), torch.floor(vy)), (torch.floor(vx), torch.ceil(vy)),
                (torch.ceil(vx), torch.floor(vy)), (torch.ceil(vx), torch.ceil(vy)))
        return torch.cat([sample_pixel_coords(x, tx, ty, "nearest", padding_mode, align_corners)
                          for tx, ty in taps], -1)
    return sample_pixel_coords(x, vx, vy, interpolation, padding_mode, align_corners, impl=impl)
