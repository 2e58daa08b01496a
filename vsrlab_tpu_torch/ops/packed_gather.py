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
  torch (``vsrlab_tpu/ops/warp.py:157-175``), in the plain sampler's
  arithmetic.

The kernel is hand-written CUDA for Hopper in ``csrc/packed_gather.cu``;
:func:`packed_row_gather_plain` is the plain PyTorch version. The wrapper
given a CPU tensor returns the plain version; given a CUDA tensor it
launches its kernel or raises. Where ``xf`` requires grad (and grad mode
is on), a CUDA call runs as :class:`PackedRowGather`: the same kernel
launch forward and :func:`gather_grads`, PyTorch ops, backward; a CPU
call is autograd through the plain version. An index outside ``[0, R)``
is clamped into it. The wrapper counts its kernel launches in its
``launches`` attribute, and by shape in ``launches_by_shape`` (a
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
    """Bilinear fold of gathered windows ``g`` ``(N, P, 4*gp*C)``: the four
    corners read from their ``2 x 2gp`` slots, weighted by the products of
    the per-axis weights in fp32 and added in the order (y0, x0), (y0, x1),
    (y1, x0), (y1, x1), rounded to ``g.dtype`` once: the plain sampler's
    arithmetic, so the route agrees with it bit for bit (the JAX package
    folds with one-hot weights, ``vsrlab_tpu/ops/warp.py:166-175``, whose
    sum XLA orders its own way). A corner whose slot lies outside the
    window contributes nothing."""
    n, p, wrow = g.shape
    two_gp = wrow // (2 * channels)
    rows = g.reshape(n, p, 2 * two_gp, channels)
    out = None
    for dy, wy in ((0, wy0), (1, wy1)):
        for dx, wx in ((0, wx0), (1, wx1)):
            sy, sx = py0 + dy, rx0 + dx
            inside = (sy >= 0) & (sy <= 1) & (sx >= 0) & (sx < two_gp)
            slot = (sy.clamp(0, 1) * two_gp + sx.clamp(0, two_gp - 1)).long()
            vals = torch.gather(rows, 2, slot[..., None, None].expand(n, p, 1, channels))
            term = vals[:, :, 0].float() * torch.where(inside, wy * wx, 0.0)[..., None]
            out = term if out is None else out + term
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
    if torch.is_grad_enabled() and xf.requires_grad:
        _check("packed_row_gather", xf, idx)
        if xf.device.type == "cpu":
            return packed_row_gather_plain(xf, idx)
        return PackedRowGather.apply(xf, idx)
    return _gather(xf, idx)


def _gather(xf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    _check("packed_row_gather", xf, idx)
    if xf.device.type == "cpu":
        return packed_row_gather_plain(xf, idx)
    return _launch(xf, idx)


def _launch(xf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel on checked CUDA operands, counted."""
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


def gather_grads(g: torch.Tensor, idx: torch.Tensor, rows: int) -> torch.Tensor:
    """The gather's vector-Jacobian product, plain PyTorch: for the output
    gradient ``g`` ``(N, P, Wrow)``, ``dxf`` ``(N, rows, Wrow)`` in
    ``g.dtype``: each output row's gradient scatter-added (``index_add_``)
    into the table row its clamped index named, summed in fp32 and
    rounded once."""
    n, p, wrow = g.shape
    base = (torch.arange(n, device=g.device) * rows)[:, None]
    lin = (base + idx.long().clamp(0, rows - 1)).reshape(-1)
    dxf = torch.zeros((n * rows, wrow), dtype=torch.float32, device=g.device)
    dxf.index_add_(0, lin, g.reshape(-1, wrow).float())
    return dxf.reshape(n, rows, wrow).to(g.dtype)


class PackedRowGather(torch.autograd.Function):
    """The row gather with a gradient: ``forward`` is the kernel launch of
    inference (counted as one), ``backward`` is :func:`gather_grads`; the
    index gets none. The JAX package differentiates its XLA gather and has
    no backward kernel, so the backward is PyTorch ops here too."""

    @staticmethod
    def forward(ctx, xf, idx):
        ctx.rows = xf.shape[1]
        ctx.save_for_backward(idx)
        return _launch(xf.detach(), idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return gather_grads(g.contiguous(), idx, ctx.rows), None


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
