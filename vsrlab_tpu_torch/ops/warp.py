"""Grid sampling and optical-flow warping on channels-last tensors
(port of ``vsrlab_tpu/ops/warp.py``).

Samples at PIXEL coordinates: :func:`flow_warp` adds the flow to the
integer pixel grid and samples there directly, so an integer flow warps
bit-exactly (a normalise / ``F.grid_sample`` round trip costs an ulp).
The bilinear taps are a plain gather of the four window corners; the JAX
package's packed-window gather is a TPU layout of the same function.

Conventions: images ``(N, H, W, C)``, grids ``(N, Ho, Wo, 2)`` with
normalised ``(x, y)`` in [-1, 1], flows ``(N, H, W, 2)`` with pixel
displacements ``(dx, dy)``. Compute is fp32; results come back in
``x.dtype``.
"""

from __future__ import annotations

import torch


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


def sample_pixel_coords(
    x: torch.Tensor,
    ix: torch.Tensor,
    iy: torch.Tensor,
    mode: str = "bilinear",
    padding_mode: str = "zeros",
    align_corners: bool = False,
) -> torch.Tensor:
    """Sample ``x`` ``(N, H, W, C)`` at continuous pixel coordinates
    ``ix``, ``iy`` ``(N, Ho, Wo)`` (no [-1, 1] round trip)."""
    n, h, w, c = x.shape
    ix, iy = _pad_coords(ix.float(), iy.float(), h, w, padding_mode, align_corners)
    x_flat = x.reshape(n, h * w, c).float()

    def corner(idx_y, idx_x, weight):
        """One corner's values times its weight; zero weight outside in zeros mode."""
        if padding_mode == "zeros":
            valid = (idx_x >= 0) & (idx_x <= w - 1) & (idx_y >= 0) & (idx_y <= h - 1)
            weight = torch.where(valid, weight, torch.zeros_like(weight))
        # the float clamp bounds the int cast (zeros mode can give any coordinate)
        yi = idx_y.clamp(0, h - 1).long()
        xi = idx_x.clamp(0, w - 1).long()
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
) -> torch.Tensor:
    """Warp ``x`` ``(N, H, W, C)`` by ``flow`` ``(N, H, W, 2)``: output
    pixel ``p`` samples ``x`` at ``p + flow[p]``.

    With ``align_corners=False`` the torch reference's normalise (size-1
    convention) / unnormalise (align_corners=False) round trip is not an
    identity, so it is reproduced; with ``True`` it is, and is skipped.
    ``nearest4`` is not ported yet.
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
    return sample_pixel_coords(x, vx, vy, interpolation, padding_mode, align_corners)
