"""Packed-row gather and fused packed bilinear sampling.

The bilinear sampler of the deformable alignment
(:func:`vsrlab_tpu_torch.ops.warp.sample_pixel_coords` with ``impl="take"``
or ``"fused"``) packs each image into a table ``xf`` ``(N, R, Wrow)`` whose
row holds one ``2 x 2gp x C`` interpolation window (``Wrow = 4*gp*C``), so
every output pixel needs ONE table row, named by ``idx`` ``(N, P)``.

* :func:`packed_row_gather` — ``out[i, p, :] = xf[i, idx[i, p], :]``.
  Counterpart of ``pallas_loop``, ``pallas_blk`` and ``pallas_take`` of
  ``scripts/bench_pallas_deform_gather.py``: three ways round the TPU
  compiler's limits on one function, which one CUDA kernel computes.
* :func:`packed_bilinear` — that gather times the bilinear one-hot
  weights, folded over the window's ``2 x 2gp`` slots to ``(N, P, C)``.
  Counterpart of ``pallas_fused`` and of ``vsrlab_tpu/ops/warp.py:157-175``:
  the window is upcast to fp32, weighted and folded in fp32, and rounded
  to ``xf.dtype`` once.

Both are hand-written CUDA kernels for Hopper in ``csrc/packed_gather.cu``;
:func:`packed_row_gather_plain` and :func:`packed_bilinear_plain` are the
plain PyTorch versions. A wrapper given a CPU tensor returns the plain
version; given a CUDA tensor it launches its kernel or raises. Both are
forward-only and raise on an input that requires grad. An index outside
``[0, R)`` is clamped into it. Each wrapper counts its kernel launches in
its ``launches`` attribute, and by shape in ``launches_by_shape`` (a
``Counter`` of ``(N, R, Wrow, P)``); :func:`reset_launch_counts` zeroes
both.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

_DTYPES = {torch.bfloat16: "bf16", torch.float32: "fp32"}


def packed_row_gather_plain(xf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one ``torch.gather`` of whole rows."""
    n, r, wrow = xf.shape
    lin = idx.long().clamp(0, r - 1)[..., None].expand(-1, -1, wrow)
    return torch.gather(xf, 1, lin)


def fold_window(g, rx0, py0, wx0, wx1, wy0, wy1, channels: int) -> torch.Tensor:
    """Bilinear fold of gathered windows ``g`` ``(N, P, 4*gp*C)``: the
    one-hot weights of ``vsrlab_tpu/ops/warp.py:166-175`` in fp32, summed
    over the ``2 x 2gp`` slots, rounded to ``g.dtype`` once. A corner
    whose slot lies outside the window matches no one-hot position and
    contributes nothing."""
    n, p, wrow = g.shape
    two_gp = wrow // (2 * channels)
    k = torch.arange(two_gp, device=g.device, dtype=torch.int32)
    ky = torch.arange(2, device=g.device, dtype=torch.int32)
    selx = (wx0[..., None] * (k == rx0[..., None])
            + wx1[..., None] * (k == (rx0 + 1)[..., None]))
    sely = (wy0[..., None] * (ky == py0[..., None])
            + wy1[..., None] * (ky == (py0 + 1)[..., None]))
    w2 = (sely[..., :, None] * selx[..., None, :]).reshape(n, p, 2 * two_gp, 1)
    out = (g.reshape(n, p, 2 * two_gp, channels).float() * w2).sum(-2)
    return out.to(g.dtype)


def packed_bilinear_plain(xf, idx, rx0, py0, wx0, wx1, wy0, wy1, channels: int):
    """Plain PyTorch version: gather the rows, then :func:`fold_window`."""
    return fold_window(packed_row_gather_plain(xf, idx), rx0, py0, wx0, wx1, wy0, wy1,
                       channels)


def _check(name, xf, ints, floats=(), channels=None):
    tensors = (xf, *ints, *floats)
    if any(t.requires_grad for t in tensors):
        raise ValueError(f"{name} is forward-only: an input requires grad")
    if xf.dim() != 3:
        raise ValueError(f"xf must be (N, R, Wrow), got {tuple(xf.shape)}")
    idx = ints[0]
    if idx.dim() != 2 or idx.shape[0] != xf.shape[0]:
        raise ValueError(f"idx must be (N, P) with N={xf.shape[0]}, got {tuple(idx.shape)}")
    for t in (*ints, *floats):
        if t.shape != idx.shape:
            raise ValueError(f"{name}: per-pixel fields must all be {tuple(idx.shape)}")
    if any(t.dtype != torch.int32 for t in ints):
        raise ValueError(f"{name}: index fields must be int32")
    if any(t.dtype != torch.float32 for t in floats):
        raise ValueError(f"{name}: weight fields must be fp32")
    if channels is not None and (channels < 1 or xf.shape[2] % (4 * channels)):
        raise ValueError(
            f"row width {xf.shape[2]} is not 4*gp*C for C={channels}")
    if xf.numel() == 0 or idx.numel() == 0:
        raise ValueError(f"{name}: empty input")
    if xf.device.type == "cpu":
        return
    if xf.device.type != "cuda" or any(t.device != xf.device for t in tensors):
        raise ValueError(f"{name}: all operands must be on one CUDA device")
    if xf.dtype not in _DTYPES:
        raise ValueError(f"the CUDA kernels take bf16 or fp32, got {xf.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    if max(xf.shape[1], idx.shape[1], xf.shape[2]) >= 2**31:
        raise ValueError(f"{name}: a dimension does not fit 32 bits")


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library (built at first use), its signatures declared."""
    from vsrlab_tpu_torch.build import load

    lib = load("packed_gather").lib
    lib.vsr_packed_row_gather.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.vsr_packed_row_gather.restype = ctypes.c_int
    for name in _DTYPES.values():
        fn = getattr(lib, f"vsr_packed_bilinear_{name}")
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.vsr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vsr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launched(wrapper, rc: int, xf, idx) -> None:
    if rc != 0:
        msg = _lib().vsr_cuda_error_string(rc).decode()
        raise RuntimeError(f"{wrapper.__name__} launch failed: {msg}")
    wrapper.launches += 1
    wrapper.launches_by_shape[(*xf.shape, idx.shape[1])] += 1


def packed_row_gather(xf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i, p, :] = xf[i, idx[i, p], :]`` for ``xf`` ``(N, R, Wrow)``
    (bf16 or fp32) and ``idx`` ``(N, P)`` int32 (CUDA ``packed_row_gather_kernel``)."""
    _check("packed_row_gather", xf, (idx,))
    if xf.device.type == "cpu":
        return packed_row_gather_plain(xf, idx)
    n, r, wrow = xf.shape
    p = idx.shape[1]
    out = torch.empty((n, p, wrow), dtype=xf.dtype, device=xf.device)
    rc = _lib().vsr_packed_row_gather(
        xf.data_ptr(), idx.data_ptr(), out.data_ptr(), n, r, p, wrow, xf.element_size(),
        xf.device.index, torch.cuda.current_stream(xf.device).cuda_stream)
    _launched(packed_row_gather, rc, xf, idx)
    return out


def packed_bilinear(xf, idx, rx0, py0, wx0, wx1, wy0, wy1, channels: int) -> torch.Tensor:
    """Fused gather and bilinear fold: ``xf`` ``(N, R, 4*gp*C)``, ``idx``,
    ``rx0``, ``py0`` ``(N, P)`` int32 (table row and the x / y slot of the
    window's first corner), ``wx0``, ``wx1``, ``wy0``, ``wy1`` ``(N, P)``
    fp32 per-axis weights -> ``(N, P, C)`` in ``xf.dtype`` (CUDA
    ``packed_bilinear_kernel``)."""
    ints, floats = (idx, rx0, py0), (wx0, wx1, wy0, wy1)
    _check("packed_bilinear", xf, ints, floats, channels)
    if xf.device.type == "cpu":
        return packed_bilinear_plain(xf, *ints, *floats, channels)
    n, r, wrow = xf.shape
    p = idx.shape[1]
    out = torch.empty((n, p, channels), dtype=xf.dtype, device=xf.device)
    fn = getattr(_lib(), f"vsr_packed_bilinear_{_DTYPES[xf.dtype]}")
    rc = fn(xf.data_ptr(), *(t.data_ptr() for t in ints + floats), out.data_ptr(),
            n, r, p, wrow // (4 * channels), channels, xf.device.index,
            torch.cuda.current_stream(xf.device).cuda_stream)
    _launched(packed_bilinear, rc, xf, idx)
    return out


_WRAPPERS = (packed_row_gather, packed_bilinear)


def reset_launch_counts() -> None:
    """Zero every wrapper's ``launches`` and ``launches_by_shape``."""
    for wrapper in _WRAPPERS:
        wrapper.launches = 0
        wrapper.launches_by_shape = collections.Counter()


reset_launch_counts()
