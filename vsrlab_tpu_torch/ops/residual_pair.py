"""Fused residual conv pair ``x + conv2(relu(conv1(x) + b1)) + b2``.

Counterpart of ``vsrlab_tpu/ops/pallas_conv.py``. The unit is the
``ResidualConv`` of every ``ResidualBlock`` (3×3, zero padding, C=64),
which carries nearly all FLOPs of RealBasicVSR inference. Two
formulations, as in the JAX package:

* :func:`residual_conv_pair` — nine shifted K=64 products per conv
  (Pallas ``residual_conv_pair``);
* :func:`residual_conv_pair_im2col` — one K=576 product per conv over a
  staged patch tile (Pallas ``residual_conv_pair_im2col``);

both hand-written CUDA kernels for Hopper in ``csrc/residual_pair.cu``,
and :func:`residual_conv_pair_plain`, the plain PyTorch version
(``residual_conv_pair_xla``).

Layout is the JAX package's: ``x`` is ``(B, H, W, C)``, weights are HWIO
``(3, 3, C, C)``, biases ``(C,)``. Compute follows ``x.dtype`` with fp32
accumulation; the residual add is in ``x.dtype``.

A wrapper given a CPU tensor returns the plain version; given a CUDA
tensor it launches its kernel or raises. Both are forward-only and raise
on an input that requires grad. Each wrapper counts its kernel launches
in its ``launches`` attribute, and by input shape in ``launches_by_shape``
(a ``Counter`` of ``(B, H, W, C)``); :func:`reset_launch_counts` zeroes
both.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

C = 64  # the kernels are compiled for 64 channels
_FUNCS = {
    ("taps", torch.bfloat16): "vsr_residual_pair_taps_bf16",
    ("im2col", torch.bfloat16): "vsr_residual_pair_im2col_bf16",
    # fp32 (parity checks with TF32 off) has one FMA kernel for both
    ("taps", torch.float32): "vsr_residual_pair_fp32",
    ("im2col", torch.float32): "vsr_residual_pair_fp32",
}


def residual_conv_pair_plain(x, w1, b1, w2, b2):
    """Plain PyTorch version: ``x + (conv2(relu(conv1(x) + b1)) + b2)``.

    Operands are rounded to ``x.dtype`` and each conv accumulates in fp32
    (the products of bf16 values are exact in fp32), as
    ``residual_conv_pair_xla`` does with ``preferred_element_type=fp32``.
    """
    dt = x.dtype
    xc = x.permute(0, 3, 1, 2).float()

    def conv(v, w, b):
        k = w.to(dt).float().permute(3, 2, 0, 1)  # HWIO -> OIHW
        return F.conv2d(v, k, b.float(), padding=1)

    y = torch.relu(conv(xc, w1, b1)).to(dt)
    z = conv(y.float(), w2, b2).to(dt)
    return x + z.permute(0, 2, 3, 1)


def _check(x, w1, b1, w2, b2):
    tensors = (x, w1, b1, w2, b2)
    if any(t.requires_grad for t in tensors):
        raise ValueError("residual_conv_pair is forward-only: an input requires grad")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    c = x.shape[-1]
    for name, w in (("w1", w1), ("w2", w2)):
        if tuple(w.shape) != (3, 3, c, c):
            raise ValueError(f"{name} must be (3, 3, {c}, {c}), got {tuple(w.shape)}")
    for name, b in (("b1", b1), ("b2", b2)):
        if tuple(b.shape) != (c,):
            raise ValueError(f"{name} must be ({c},), got {tuple(b.shape)}")
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError("residual_conv_pair: all operands must be on one CUDA device")
    if c != C:
        raise ValueError(f"the CUDA kernels take C={C}, got C={c}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the CUDA kernels take bf16 or fp32, got {x.dtype}")
    if w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise ValueError("weights must be in x.dtype (pre-laid out by the caller)")
    if b1.dtype != torch.float32 or b2.dtype != torch.float32:
        raise ValueError("biases must be fp32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("residual_conv_pair: operands must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("residual_conv_pair: operands must be 16-byte aligned")
    if x.numel() == 0:
        raise ValueError("residual_conv_pair: empty input")


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library (built at first use), its signatures declared."""
    from vsrlab_tpu_torch.build import load

    lib = load("residual_pair").lib
    for name in set(_FUNCS.values()):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.vsr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vsr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(formulation, x, w1, b1, w2, b2):
    lib = _lib()
    out = torch.empty_like(x)
    b, h, w, _ = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = getattr(lib, _FUNCS[(formulation, x.dtype)])(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), out.data_ptr(), b, h, w, x.device.index, stream,
    )
    if rc != 0:
        msg = lib.vsr_cuda_error_string(rc).decode()
        raise RuntimeError(f"residual_conv_pair ({formulation}) launch failed: {msg}")
    wrapper = _WRAPPERS[formulation]
    wrapper.launches += 1
    wrapper.launches_by_shape[tuple(x.shape)] += 1
    return out


def residual_conv_pair(x, w1, b1, w2, b2):
    """Fused pair, nine shifted K=64 products per conv (CUDA ``taps`` kernel)."""
    _check(x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return residual_conv_pair_plain(x, w1, b1, w2, b2)
    return _launch("taps", x, w1, b1, w2, b2)


def residual_conv_pair_im2col(x, w1, b1, w2, b2):
    """Fused pair, one K=576 product per conv (CUDA ``im2col`` kernel)."""
    _check(x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return residual_conv_pair_plain(x, w1, b1, w2, b2)
    return _launch("im2col", x, w1, b1, w2, b2)


_WRAPPERS = {"taps": residual_conv_pair, "im2col": residual_conv_pair_im2col}


def reset_launch_counts() -> None:
    """Zero every wrapper's ``launches`` and ``launches_by_shape``."""
    for wrapper in _WRAPPERS.values():
        wrapper.launches = 0
        wrapper.launches_by_shape = collections.Counter()


reset_launch_counts()

PAIR_IMPLS = {
    "taps": residual_conv_pair,
    "im2col": residual_conv_pair_im2col,
    "plain": residual_conv_pair_plain,
}
