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
on an input that requires grad; :class:`ResidualPair` (through
:func:`residual_pair`) is the route with a gradient: its forward is the
same wrapper's launch, its backward PyTorch convolutions (the JAX package
has no backward kernel: training there differentiates the XLA lowering).
Each wrapper counts its kernel launches
in its ``launches`` attribute, and by input shape in ``launches_by_shape``
(a ``Counter`` of ``(B, H, W, C)``); :func:`reset_launch_counts` zeroes
both.

The bf16 kernels run a persistent grid, one CTA a streaming multiprocessor
at most, each walking over image tiles; :func:`pair_launch_plan` asks the
library which tile and grid a launch gets. The bf16 ``taps`` kernel keeps
the weights in registers and takes them in its own order
(:func:`pack_weight_fragments`): :func:`residual_conv_pair` lays them out
on every call unless the caller hands them in as ``fragments``, as
``ResidualConv`` does from the cache that holds its operands.

fp32 operands go to one kernel for both formulations: IEEE fp32 FFMAs on
the CUDA cores (no TF32), each thread a register tile of pixels x 8 output
channels, the weights staged a tap at a time in shared memory, one CTA a
12x16 output tile. It serves the flow trainer's cleaner, ``precision:
fp32`` serving and training, and the fp32 parity checks.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

C = 64  # the kernels are compiled for 64 channels
_FUNCS = {
    ("taps", torch.bfloat16): "vsr_residual_pair_taps_bf16",
    ("im2col", torch.bfloat16): "vsr_residual_pair_im2col_bf16",
    # fp32 (IEEE products: the cleaner, precision fp32, parity checks) has one
    # register-tiled FFMA kernel for both
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


def _check_shapes(x, w1, b1, w2, b2):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    c = x.shape[-1]
    for name, w in (("w1", w1), ("w2", w2)):
        if tuple(w.shape) != (3, 3, c, c):
            raise ValueError(f"{name} must be (3, 3, {c}, {c}), got {tuple(w.shape)}")
    for name, b in (("b1", b1), ("b2", b2)):
        if tuple(b.shape) != (c,):
            raise ValueError(f"{name} must be ({c},), got {tuple(b.shape)}")


def _check(x, w1, b1, w2, b2, grad_ok=False):
    tensors = (x, w1, b1, w2, b2)
    if not grad_ok and any(t.requires_grad for t in tensors):
        raise ValueError("residual_conv_pair is forward-only: an input requires grad "
                         "(residual_pair differentiates it)")
    _check_shapes(x, w1, b1, w2, b2)
    c = x.shape[-1]
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


def pack_weight_fragments(w):
    """HWIO bf16 weights ``(3, 3, 64, 64)`` in the order the ``taps`` kernel
    loads them: int32 ``(36, 4, 32, 4)``.

    The kernel computes each tap transposed, ``W_tap^T`` (output channel x
    input channel) times the pixels, and keeps ``W_tap^T`` in registers as
    the tensor cores' A operand, 16 input channels (one ``step = tap*4 +
    kc``) at a time. Element ``[step, wq, 4*g + t, r]`` is what register
    ``r`` of lane ``4*g + t`` of warp ``wq`` holds at that step: the pair
    ``w[tap, ci, co], w[tap, ci + 1, co]`` (low half first) with
    ``co = 16*wq + g + 8*(r & 1)`` and ``ci = 16*kc + 2*t + 8*(r >> 1)``.
    """
    if tuple(w.shape) != (3, 3, C, C) or w.dtype != torch.bfloat16:
        raise ValueError(f"expected bf16 (3, 3, {C}, {C}) weights, got {w.dtype} {tuple(w.shape)}")
    # ci = 16*kc + 8*r1 + 2*t + e, co = 16*wq + 8*r0 + g, r = 2*r1 + r0
    v = w.reshape(9, 4, 2, 4, 2, 4, 2, 8)  # tap, kc, r1, t, e, wq, r0, g
    v = v.permute(0, 1, 5, 7, 3, 2, 6, 4).contiguous()  # tap, kc, wq, g, t, r1, r0, e
    return v.view(torch.int32).reshape(36, 4, 32, 4)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library (built at first use), its signatures declared."""
    from vsrlab_tpu_torch.build import load

    lib = load("residual_pair").lib
    for name in set(_FUNCS.values()):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.vsr_residual_pair_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    lib.vsr_residual_pair_plan.restype = ctypes.c_int
    lib.vsr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vsr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def pair_launch_plan(formulation: str, shape, device, dtype=torch.bfloat16) -> dict:
    """The tiling a launch of ``formulation`` on ``(B, H, W, 64)`` in
    ``dtype`` gets on CUDA ``device``, as the library's entry would choose
    it: the output tile ``(rows, columns)``, the number of tiles, the CTAs
    that run at once (bf16: the persistent grid; fp32: one CTA a tile, one
    an SM at a time) and the rounds the busiest SM makes. Launches
    nothing."""
    if formulation not in ("taps", "im2col"):
        raise ValueError(f"no kernel for formulation {formulation!r}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"no kernel for {dtype}")
    kernel = 2 if dtype == torch.float32 else int(formulation == "im2col")
    lib = _lib()
    b, h, w, _ = shape
    plan = (ctypes.c_int * 4)()
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    rc = lib.vsr_residual_pair_plan(kernel, b, h, w, index, plan)
    if rc != 0:
        raise RuntimeError(f"no launch plan for {tuple(shape)}: "
                           f"{lib.vsr_cuda_error_string(rc).decode()}")
    th, tw, tiles, ctas = plan
    return {"tile": (th, tw), "tiles": tiles, "ctas": ctas, "rounds": -(-tiles // ctas)}


def _launch(formulation, x, w1, b1, w2, b2, fragments=None):
    lib = _lib()
    out = torch.empty_like(x)
    b, h, w, _ = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if (formulation, x.dtype) == ("taps", torch.bfloat16):  # the kernel's register order
        w1, w2 = fragments or (pack_weight_fragments(w1), pack_weight_fragments(w2))
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


def _pair(formulation, x, w1, b1, w2, b2, fragments=None, grad_ok=False):
    _check(x, w1, b1, w2, b2, grad_ok)
    if x.device.type == "cpu":
        return residual_conv_pair_plain(x, w1, b1, w2, b2)
    return _launch(formulation, x, w1, b1, w2, b2, fragments)


def residual_conv_pair(x, w1, b1, w2, b2, *, fragments=None):
    """Fused pair, nine shifted K=64 products per conv (CUDA ``taps`` kernel).

    ``fragments``, where given, is ``(pack_weight_fragments(w1),
    pack_weight_fragments(w2))`` as the caller laid them out from these very
    weights; the bf16 kernel then reads them and the call lays out nothing.
    While ``torch.export`` traces, the call goes into the graph as the
    custom op ``vsrlab::residual_conv_pair``.
    """
    if torch.compiler.is_exporting():
        f1, f2 = fragments or (None, None)
        return torch.ops.vsrlab.residual_conv_pair(x, w1, b1, w2, b2, f1, f2)
    return _pair("taps", x, w1, b1, w2, b2, fragments)


def residual_conv_pair_im2col(x, w1, b1, w2, b2):
    """Fused pair, one K=576 product per conv (CUDA ``im2col`` kernel); in
    an exported graph the custom op ``vsrlab::residual_conv_pair_im2col``."""
    if torch.compiler.is_exporting():
        return torch.ops.vsrlab.residual_conv_pair_im2col(x, w1, b1, w2, b2)
    return _pair("im2col", x, w1, b1, w2, b2)


# The kernels as custom ops, so that torch.export keeps them in its graph (a
# ctypes call cannot be traced). An exported program calls the op, whose
# implementation is the wrapper's: the kernel on a CUDA tensor (counted in
# the wrapper's launches), the plain version on a CPU one. Eager code calls
# the wrappers directly: the op's dispatch costs the host some 12-14 us a
# launch more (PERF.md), on a path that is bound by the host.
@torch.library.custom_op("vsrlab::residual_conv_pair", mutates_args=())
def _taps_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
             b2: torch.Tensor, f1: Optional[torch.Tensor] = None,
             f2: Optional[torch.Tensor] = None) -> torch.Tensor:
    # an exported program hands its parameters in as they are (requiring grad)
    return _pair("taps", x, w1, b1, w2, b2, None if f1 is None else (f1, f2), grad_ok=True)


@torch.library.custom_op("vsrlab::residual_conv_pair_im2col", mutates_args=())
def _im2col_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
               b2: torch.Tensor) -> torch.Tensor:
    return _pair("im2col", x, w1, b1, w2, b2, grad_ok=True)


@_taps_op.register_fake
def _(x, w1, b1, w2, b2, f1=None, f2=None):
    _check_shapes(x, w1, b1, w2, b2)
    return torch.empty_like(x)


@_im2col_op.register_fake
def _(x, w1, b1, w2, b2):
    _check_shapes(x, w1, b1, w2, b2)
    return torch.empty_like(x)


def _conv_grads(gout, inp, w, need_input=True):
    """``(d input, d weight)`` of ``conv(inp, w)`` (3x3, padding 1) at the
    upstream gradient ``gout``, all NCHW views / OIHW in their own dtype:
    with bf16 operands cuDNN accumulates in fp32 and rounds each result to
    bf16 once."""
    d_in, d_w, _ = torch.ops.aten.convolution_backward.default(
        gout, inp, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [need_input, True, False])
    return d_in, d_w


def pair_grads(x, w1, b1, w2, b2, g, need_dx: bool = True):
    """``(dx, dw1, db1, dw2, db2)`` of the pair at the upstream gradient
    ``g``, at the plain version's rounding points (compute type ``dt`` =
    ``x.dtype``): ``a = conv1(x) + b1`` recomputed in fp32 as the plain
    version has it, ``y = relu(a)`` in ``dt`` gives ``dW2``; ``dy`` in ``dt``
    and ``da = dy * [a > 0]`` (``dt`` values) give ``db1``, ``dW1`` and
    ``dx = g + conv1^T(da)``. Weight gradients come back HWIO in ``dt``, bias
    gradients in fp32. Every product but the recomputed conv1 takes operands
    in ``dt`` and rounds its result to ``dt`` once, so a bf16 unit's
    backward runs on the tensor cores; the fp32 conv1 may use TF32 where it
    is allowed, which holds bf16 values exactly. Written in as few tensor
    ops as it takes: each costs the host more than a small one costs the
    card."""
    xc, gc = x.permute(0, 3, 1, 2), g.contiguous().permute(0, 3, 1, 2)  # NCHW views
    k1, k2 = w1.permute(3, 2, 0, 1), w2.permute(3, 2, 0, 1)  # HWIO -> OIHW views
    a = F.conv2d(xc.float(), k1.float(), b1.float(), padding=1)
    off = a <= 0
    dy, dk2 = _conv_grads(gc, a.relu_().to(x.dtype), k2)
    da = dy.masked_fill_(off, 0)
    dx, dk1 = _conv_grads(da, xc, k1, need_dx)
    db1, db2 = (torch.sum(t, (0, 2, 3), dtype=torch.float32) for t in (da, gc))
    dx = None if dx is None else dx.add_(gc).permute(0, 2, 3, 1)
    return dx, dk1.permute(2, 3, 1, 0), db1, dk2.permute(2, 3, 1, 0), db2


class ResidualPair(torch.autograd.Function):
    """The pair with a gradient. ``forward`` launches exactly what inference
    launches (``formulation`` ``"taps"`` or ``"im2col"``, with ``fragments``
    as :func:`residual_conv_pair` takes them; the plain version on a CPU
    tensor) and keeps only ``x`` and the operands, so a unit holds one
    activation tensor for its backward; ``backward`` is :func:`pair_grads`.
    """

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, formulation, fragments):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return _pair(formulation, x, w1, b1, w2, b2, fragments, grad_ok=True)

    @staticmethod
    def backward(ctx, g):
        return (*pair_grads(*ctx.saved_tensors, g, ctx.needs_input_grad[0]), None, None)


def residual_pair(x, w1, b1, w2, b2, formulation: str = "taps", fragments=None):
    """:class:`ResidualPair` of the operands: the pair by ``formulation``
    (``"taps"`` or ``"im2col"``) with a gradient for each operand."""
    if formulation not in _WRAPPERS:
        raise ValueError(f"no kernel for formulation {formulation!r}")
    return ResidualPair.apply(x, w1, b1, w2, b2, formulation, fragments)


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
