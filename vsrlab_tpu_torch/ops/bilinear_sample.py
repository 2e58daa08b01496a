"""Bilinear sampling of channels-last images at fp32 pixel coordinates.

:func:`bilinear_sample` samples ``x`` ``(N, H, W, C)`` at ``ix``, ``iy``
``(N, P)`` and returns ``(N, P, C)`` in ``x.dtype``: the four corners of
each sample, weighted per axis (``x0 = floor(ix)``, ``wx1 = ix - x0``,
``wx0 = 1 - wx1``, the same for y), summed in fp32 in the order (y0, x0),
(y0, x1), (y1, x0), (y1, x1) and rounded once. With ``zeros`` each per-axis
weight is zeroed where its corner lies outside the image, as
``vsrlab_tpu/ops/warp.py:102-175`` does, and such a corner is never read;
without it (coordinates the caller has clamped into the image, for border
or reflection padding) a corner's index is clamped into the image. The
clamp bounds every index, so ``inf``, ``NaN`` and huge coordinates read
nothing out of range; in ``zeros`` mode they give 0.

It is the counterpart of ``pallas_fused`` of
``scripts/bench_pallas_deform_gather.py`` and the sampler's
``impl="fused"``: a hand-written CUDA kernel for Hopper in
``csrc/bilinear_sample.cu`` that reads the image directly, where the TPU
kernel reads a packed-window table and seven per-pixel fields.
:func:`bilinear_sample_plain` is the plain PyTorch version. The wrapper
given a CPU tensor returns the plain version; given a CUDA tensor it
launches the kernel or raises. It is forward-only and raises on an input
that requires grad. It counts its kernel launches in
``bilinear_sample.launches``, and by shape in ``launches_by_shape`` (a
``Counter`` of ``(N, H, W, C, P)``); :func:`reset_launch_counts` zeroes
both.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

_DTYPES = {torch.bfloat16: "bf16", torch.float32: "fp32"}


def _axis(coord, size: int, zeros: bool):
    """One axis: the two corners' clamped indices, weights and validity
    (``None``: every corner is read)."""
    f = torch.floor(coord)
    w1 = coord - f
    w0 = 1.0 - w1
    valid = None
    if zeros:
        valid = ((f >= 0) & (f <= size - 1), (f + 1 >= 0) & (f + 1 <= size - 1))
        w0 = torch.where(valid[0], w0, 0.0)
        w1 = torch.where(valid[1], w1, 0.0)
    # the clamp bounds the int cast: NaN reads index 0, as fmaxf(NaN, 0) does
    idx = tuple(torch.nan_to_num(g, nan=0.0).clamp(0, size - 1).long() for g in (f, f + 1))
    return idx, (w0, w1), valid


def bilinear_sample_plain(x: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor,
                          zeros: bool) -> torch.Tensor:
    """Plain PyTorch version: four gathers of whole pixels, weighted and
    summed in fp32, rounded to ``x.dtype`` once."""
    n, h, w, c = x.shape
    xf = x.reshape(n, h * w, c).float()
    xi, wx, vx = _axis(ix.float(), w, zeros)
    yi, wy, vy = _axis(iy.float(), h, zeros)
    out = torch.zeros((n, ix.shape[1], c), device=x.device)
    for r in range(2):
        for k in range(2):
            lin = (yi[r] * w + xi[k])[..., None].expand(-1, -1, c)
            term = (wy[r] * wx[k])[..., None] * torch.gather(xf, 1, lin)
            if zeros:
                term = torch.where((vy[r] & vx[k])[..., None], term, 0.0)
            out = out + term
    return out.to(x.dtype)


def _check(x, ix, iy) -> None:
    name = "bilinear_sample"
    tensors = (x, ix, iy)
    if any(t.requires_grad for t in tensors):
        raise ValueError(f"{name} is forward-only: an input requires grad")
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C), got {tuple(x.shape)}")
    if ix.dim() != 2 or ix.shape[0] != x.shape[0]:
        raise ValueError(f"ix must be (N, P) with N={x.shape[0]}, got {tuple(ix.shape)}")
    if iy.shape != ix.shape:
        raise ValueError(f"{name}: per-pixel fields must all be {tuple(ix.shape)}")
    if ix.dtype != torch.float32 or iy.dtype != torch.float32:
        raise ValueError(f"{name}: coordinates must be fp32")
    if x.numel() == 0 or ix.numel() == 0:
        raise ValueError(f"{name}: empty input")
    if x.device.type == "cpu" and all(t.device.type == "cpu" for t in tensors):
        return
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: all operands must be on one CUDA device")
    if x.dtype not in _DTYPES:
        raise ValueError(f"the CUDA kernel takes bf16 or fp32, got {x.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    if max(*x.shape, ix.shape[1]) >= 2**31:
        raise ValueError(f"{name}: a dimension does not fit 32 bits")


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library (built at first use), its signatures declared."""
    from vsrlab_tpu_torch.build import load

    lib = load("bilinear_sample").lib
    for name in _DTYPES.values():
        fn = getattr(lib, f"vsr_bilinear_sample_{name}")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.vsr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vsr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def bilinear_sample(x: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor,
                    zeros: bool) -> torch.Tensor:
    """Sample ``x`` ``(N, H, W, C)`` (bf16 or fp32) at fp32 pixel
    coordinates ``ix``, ``iy`` ``(N, P)`` -> ``(N, P, C)`` in ``x.dtype``
    (CUDA ``bilinear_sample_kernel``)."""
    _check(x, ix, iy)
    if x.device.type == "cpu":
        return bilinear_sample_plain(x, ix, iy, zeros)
    n, h, w, c = x.shape
    p = ix.shape[1]
    out = torch.empty((n, p, c), dtype=x.dtype, device=x.device)
    fn = getattr(_lib(), f"vsr_bilinear_sample_{_DTYPES[x.dtype]}")
    rc = fn(x.data_ptr(), ix.data_ptr(), iy.data_ptr(), out.data_ptr(), n, h, w, c, p,
            int(zeros), x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        msg = _lib().vsr_cuda_error_string(rc).decode()
        raise RuntimeError(f"bilinear_sample launch failed: {msg}")
    bilinear_sample.launches += 1
    bilinear_sample.launches_by_shape[(n, h, w, c, p)] += 1
    return out


def reset_launch_counts() -> None:
    """Zero ``bilinear_sample.launches`` and ``launches_by_shape``."""
    bilinear_sample.launches = 0
    bilinear_sample.launches_by_shape = collections.Counter()


reset_launch_counts()
