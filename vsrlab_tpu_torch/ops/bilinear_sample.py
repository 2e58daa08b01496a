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
launches the kernel or raises. Where an input requires grad (and grad mode
is on), a CUDA call runs as :class:`BilinearSample`: the same kernel
launch forward, and :func:`sample_grads`, PyTorch ops, backward; a CPU call
is autograd through the plain version. It counts its kernel launches in
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
    summed in fp32 (fp64 for an fp64 image: the exact reference that the
    gradient checks hold :func:`sample_grads` against), rounded to
    ``x.dtype`` once."""
    n, h, w, c = x.shape
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.reshape(n, h * w, c).to(acc)
    xi, wx, vx = _axis(ix.to(acc), w, zeros)
    yi, wy, vy = _axis(iy.to(acc), h, zeros)
    out = torch.zeros((n, ix.shape[1], c), dtype=acc, device=x.device)
    for r in range(2):
        for k in range(2):
            lin = (yi[r] * w + xi[k])[..., None].expand(-1, -1, c)
            term = (wy[r] * wx[k])[..., None] * torch.gather(xf, 1, lin)
            if zeros:
                term = torch.where((vy[r] & vx[k])[..., None], term, 0.0)
            out = out + term
    return out.to(x.dtype)


def _check_shapes(x, ix, iy) -> None:
    name = "bilinear_sample"
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


def _check(x, ix, iy) -> None:
    name = "bilinear_sample"
    tensors = (x, ix, iy)
    _check_shapes(x, ix, iy)
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
    (CUDA ``bilinear_sample_kernel``; in an exported graph the custom op
    ``vsrlab::bilinear_sample``)."""
    if torch.compiler.is_exporting():
        return torch.ops.vsrlab.bilinear_sample(x, ix, iy, zeros)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, ix, iy)):
        _check(x, ix, iy)
        if x.device.type == "cpu":
            return bilinear_sample_plain(x, ix, iy, zeros)
        return BilinearSample.apply(x, ix, iy, zeros)
    return _sample(x, ix, iy, zeros)


def _sample(x, ix, iy, zeros: bool) -> torch.Tensor:
    _check(x, ix, iy)
    if x.device.type == "cpu":
        return bilinear_sample_plain(x, ix, iy, zeros)
    return _launch(x, ix, iy, zeros)


def _launch(x, ix, iy, zeros: bool) -> torch.Tensor:
    """One launch of the kernel on checked CUDA operands, counted."""
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


def sample_grads(x: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor, zeros: bool,
                 g: torch.Tensor, need_coords: bool = True):
    """The sampler's vector-Jacobian product, plain PyTorch: for the output
    gradient ``g`` ``(N, P, C)``, ``(dx, dix, diy)`` with ``dx`` ``(N, H, W,
    C)`` in ``x.dtype`` and ``dix``, ``diy`` ``(N, P)`` fp32 (None without
    ``need_coords``: the corners' values are then not read). It is
    autograd's through :func:`bilinear_sample_plain`: each corner's weight
    times ``g`` is scatter-added (``index_add_``) into its pixel; ``floor``
    has zero gradient, so ``d wx1 / d ix = 1`` and ``d wx0 / d ix = -1``
    and the coordinate gradients are the per-axis weight derivatives
    against the corners' values; a corner masked in zeros mode contributes
    nothing. A sample with a NaN or +-inf coordinate contributes nothing
    either, so its gradients are 0 where autograd would give NaN in border
    mode. ``dx`` is accumulated in fp64 and rounded once: thousands of
    samples may land on one pixel (border-clamped coordinates pile onto the
    edge), and an fp32 sum of them in the atomics' varying order would move
    a cancelling pixel's gradient by a few 1e-4."""
    n, h, w, c = x.shape
    p = ix.shape[1]
    gf = g.float()
    gd = gf.double()
    xf = x.detach().reshape(n * h * w, c).float() if need_coords else None
    finite = torch.isfinite(ix) & torch.isfinite(iy)
    xi, wx, vx = _axis(ix.detach().float(), w, zeros)
    yi, wy, vy = _axis(iy.detach().float(), h, zeros)
    wx = tuple(torch.where(finite, t, 0.0) for t in wx)
    wy = tuple(torch.where(finite, t, 0.0) for t in wy)
    base = (torch.arange(n, device=x.device) * (h * w))[:, None]
    dxd = torch.zeros((n * h * w, c), dtype=torch.float64, device=x.device)
    dwx, dwy = [0.0, 0.0], [0.0, 0.0]
    for r in range(2):
        for k in range(2):
            live = finite if not zeros else finite & vy[r] & vx[k]
            lin = (base + yi[r] * w + xi[k]).reshape(-1)
            wgt = torch.where(live, wy[r] * wx[k], 0.0)
            dxd.index_add_(0, lin, (wgt.double()[..., None] * gd).reshape(-1, c))
            if need_coords:
                # <g, corner value> of each sample, zero where the corner is masked
                s = torch.where(live, (gf * xf.index_select(0, lin).reshape(n, p, c)).sum(-1),
                                0.0)
                dwx[k] = dwx[k] + wy[r] * s
                dwy[r] = dwy[r] + wx[k] * s
    dx = dxd.reshape(n, h, w, c).to(x.dtype)
    if not need_coords:
        return dx, None, None
    return dx, dwx[1] - dwx[0], dwy[1] - dwy[0]


class BilinearSample(torch.autograd.Function):
    """The sampler with a gradient: ``forward`` is the kernel launch of
    inference (counted as one), ``backward`` is :func:`sample_grads`. The
    JAX package differentiates its XLA gather and has no backward kernel,
    so the backward is PyTorch ops here too."""

    @staticmethod
    def forward(ctx, x, ix, iy, zeros: bool):
        ctx.zeros = zeros
        ctx.save_for_backward(x, ix, iy)
        return _launch(x.detach(), ix.detach(), iy.detach(), zeros)

    @staticmethod
    def backward(ctx, g):
        x, ix, iy = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dix, diy = sample_grads(x, ix, iy, ctx.zeros, g, need_coords=need[1] or need[2])
        return (dx if need[0] else None, dix if need[1] else None,
                diy if need[2] else None, None)


# the kernel as a custom op, so that torch.export keeps it in its graph; its
# implementation is the wrapper's (the kernel on a CUDA tensor, counted)
@torch.library.custom_op("vsrlab::bilinear_sample", mutates_args=())
def _sample_op(x: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor, zeros: bool) -> torch.Tensor:
    return _sample(x, ix, iy, zeros)


@_sample_op.register_fake
def _(x, ix, iy, zeros):
    _check_shapes(x, ix, iy)
    return x.new_empty((x.shape[0], ix.shape[1], x.shape[3]))


def reset_launch_counts() -> None:
    """Zero ``bilinear_sample.launches`` and ``launches_by_shape``."""
    bilinear_sample.launches = 0
    bilinear_sample.launches_by_shape = collections.Counter()


reset_launch_counts()
