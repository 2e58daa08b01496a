"""Packed-row gather.

The sampler's ``impl="take"``
(:func:`vsrlab_tpu_torch.ops.warp.sample_pixel_coords`) packs each image
into a table ``xf`` ``(N, R, Wrow)`` whose row holds one ``2 x 2gp x C``
interpolation window (``Wrow = 4*gp*C``), so every output pixel needs ONE
table row, named by ``idx`` ``(N, P)``.

* :func:`packed_row_gather` — ``out[i, p, :] = xf[i, idx[i, p], :]``.
  Counterpart of ``pallas_loop``, ``pallas_blk`` and ``pallas_take`` of
  ``scripts/bench_pallas_deform_gather.py``: three ways round the TPU
  compiler's limits on one function, which one CUDA kernel computes.
* :func:`fold_window` — the bilinear fold of the gathered windows in
  torch, as ``vsrlab_tpu/ops/warp.py:157-175`` ships it.

The kernel is hand-written CUDA for Hopper in ``csrc/packed_gather.cu``;
:func:`packed_row_gather_plain` is the plain PyTorch version. The wrapper
given a CPU tensor returns the plain version; given a CUDA tensor it
launches its kernel or raises. It is forward-only and raises on an input
that requires grad. An index outside ``[0, R)`` is clamped into it. The
wrapper counts its kernel launches in its ``launches`` attribute, and by
shape in ``launches_by_shape`` (a ``Counter`` of ``(N, R, Wrow, P)``);
:func:`reset_launch_counts` zeroes both.
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


def _check_shapes(name, xf, idx):
    if xf.dim() != 3:
        raise ValueError(f"xf must be (N, R, Wrow), got {tuple(xf.shape)}")
    if idx.dim() != 2 or idx.shape[0] != xf.shape[0]:
        raise ValueError(f"idx must be (N, P) with N={xf.shape[0]}, got {tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise ValueError(f"{name}: idx must be int32")
    if xf.numel() == 0 or idx.numel() == 0:
        raise ValueError(f"{name}: empty input")


def _check(name, xf, idx):
    tensors = (xf, idx)
    if any(t.requires_grad for t in tensors):
        raise ValueError(f"{name} is forward-only: an input requires grad")
    _check_shapes(name, xf, idx)
    if xf.device.type == "cpu":
        return
    if xf.device.type != "cuda" or any(t.device != xf.device for t in tensors):
        raise ValueError(f"{name}: all operands must be on one CUDA device")
    if xf.dtype not in _DTYPES:
        raise ValueError(f"the CUDA kernel takes bf16 or fp32, got {xf.dtype}")
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
    lib.vsr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vsr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def packed_row_gather(xf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i, p, :] = xf[i, idx[i, p], :]`` for ``xf`` ``(N, R, Wrow)``
    (bf16 or fp32) and ``idx`` ``(N, P)`` int32 (CUDA ``packed_row_gather_kernel``;
    in an exported graph the custom op ``vsrlab::packed_row_gather``)."""
    if torch.compiler.is_exporting():
        return torch.ops.vsrlab.packed_row_gather(xf, idx)
    return _gather(xf, idx)


def _gather(xf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    _check("packed_row_gather", xf, idx)
    if xf.device.type == "cpu":
        return packed_row_gather_plain(xf, idx)
    n, r, wrow = xf.shape
    p = idx.shape[1]
    out = torch.empty((n, p, wrow), dtype=xf.dtype, device=xf.device)
    rc = _lib().vsr_packed_row_gather(
        xf.data_ptr(), idx.data_ptr(), out.data_ptr(), n, r, p, wrow, xf.element_size(),
        xf.device.index, torch.cuda.current_stream(xf.device).cuda_stream)
    if rc != 0:
        msg = _lib().vsr_cuda_error_string(rc).decode()
        raise RuntimeError(f"packed_row_gather launch failed: {msg}")
    packed_row_gather.launches += 1
    packed_row_gather.launches_by_shape[(n, r, wrow, p)] += 1
    return out


# the kernel as a custom op, so that torch.export keeps it in its graph; its
# implementation is the wrapper's (the kernel on a CUDA tensor, counted)
@torch.library.custom_op("vsrlab::packed_row_gather", mutates_args=())
def _gather_op(xf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return _gather(xf, idx)


@_gather_op.register_fake
def _(xf, idx):
    _check_shapes("packed_row_gather", xf, idx)
    return xf.new_empty((xf.shape[0], idx.shape[1], xf.shape[2]))


def reset_launch_counts() -> None:
    """Zero ``packed_row_gather.launches`` and ``launches_by_shape``."""
    packed_row_gather.launches = 0
    packed_row_gather.launches_by_shape = collections.Counter()


reset_launch_counts()
