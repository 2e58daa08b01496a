"""Spatially-tiled video SR inference with overlap blending (port of
``vsrlab_tpu/evaluation/tiled.py``).

The VRT test protocol processes large inputs as overlapping spatial tiles
and averages the overlap regions with uniform weights. This is the serving
path for inputs whose single-pass activations exceed the card's memory.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch


def _tile_starts(size: int, tile: int, stride: int) -> Sequence[int]:
    """The tiling grid: stride steps plus a final border-snapped tile so
    the whole extent is covered."""
    if tile >= size:
        return [0]
    starts = list(range(0, size - tile, stride))
    starts.append(size - tile)
    return starts


def tiled_forward(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    lr: torch.Tensor,
    tile: Tuple[int, int],
    overlap: int = 16,
    scale: Optional[int] = None,
) -> torch.Tensor:
    """Run ``apply_fn`` ``(B, T, th, tw, C) -> (B, T, s*th, s*tw, C)`` (for
    example the ``forward`` of :func:`~vsrlab_tpu_torch.evaluation.harness.make_forward`)
    over overlapping spatial tiles of ``lr`` ``(B, T, H, W, C)`` and blend.

    ``tile`` is the tile size ``(th, tw)``, clipped to the input; ``overlap``
    the tile overlap in input pixels; ``scale`` the upscale factor, read
    from the first tile's output when ``None``. Returns ``(B, T, scale*H,
    scale*W, C)`` in fp32 on the device of ``apply_fn``'s outputs, where
    the tiles accumulate.
    """
    b, t, h, w, c = lr.shape
    th, tw = min(tile[0], h), min(tile[1], w)
    if (th < h and th <= overlap) or (tw < w and tw <= overlap):
        raise ValueError(
            f"tile {th}x{tw} must exceed overlap {overlap} when smaller than the input "
            "(stride would degenerate to 1 px)")
    ys_all = _tile_starts(h, th, max(th - overlap, 1))
    xs_all = _tile_starts(w, tw, max(tw - overlap, 1))
    acc = weight = None
    for ys in ys_all:
        for xs in xs_all:
            sr = apply_fn(lr[:, :, ys:ys + th, xs:xs + tw])
            if acc is None:
                scale = scale or sr.shape[2] // th
                acc = torch.zeros((b, t, h * scale, w * scale, sr.shape[-1]),
                                  dtype=torch.float32, device=sr.device)
                weight = torch.zeros((h * scale, w * scale), dtype=torch.float32,
                                     device=sr.device)
            oy, ox = ys * scale, xs * scale
            acc[:, :, oy:oy + th * scale, ox:ox + tw * scale] += sr.float()
            weight[oy:oy + th * scale, ox:ox + tw * scale] += 1.0
    return acc / weight[None, None, :, :, None]
