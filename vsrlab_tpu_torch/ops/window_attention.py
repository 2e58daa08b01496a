"""Fused window attention.

* :func:`window_attention` — ``softmax(scale * q k^T + bias + masks[tid]) v``
  for every (window, head), each head's rows in its channel slice of the
  result: the core of VRT's
  :class:`~vsrlab_tpu_torch.models.vrt.window_attention.WindowAttention`
  (self attention, both directions of mutual attention, the rows of
  ``forward_rows``, the heads of a head-sharded rank).

The kernel is hand-written CUDA for Hopper in ``csrc/window_attention.cu``
(the JAX package has no kernel here: XLA compiles its einsums and softmax);
:func:`window_attention_plain` is the plain PyTorch version, batched
matmuls with fp32 logits over chunks of windows of at most
``LOGITS_BUDGET`` bytes of logits. The wrapper given a CPU tensor returns
the plain version; given a CUDA tensor it launches its kernel or raises.
Where q, k, v or the bias require grad (and grad mode is on), a CUDA call
runs as :class:`FusedAttention`: the same launch forward and, backward,
autograd through the plain version recomputed from the saved operands;
a CPU call is autograd through the plain version. The wrapper counts its
kernel launches in its ``launches`` attribute, and by shape in
``launches_by_shape`` (a ``Counter`` of ``(B, H, nq, nk, hd, bias, masks)``,
the last two whether each was given), and under a running profiler in the
program's counter ``window_attention.launches`` (a traced benchmark run
lists it among its counters); :func:`reset_launch_counts` zeroes the first
two.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch

from vsrlab_tpu_torch.utils.profiler import count

_DTYPES = (torch.bfloat16, torch.float32)
MAX_HEAD_DIM = 64

# fp32 logits of one chunk of windows in the plain version: above this the
# windows are processed in chunks. Unchunked, full VRT at 16x256x256 has
# (3072, 6, 384, 384) fp32 logits in one block: 10.9 GB.
LOGITS_BUDGET = 1 << 30


def _attend(q, k, v, scale, bias, masks, tid):
    attn = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    if bias is not None:
        attn = attn + bias
    if masks is not None:
        attn = attn + masks[tid][:, None]
    attn = torch.softmax(attn, dim=-1).to(v.dtype)
    out = torch.matmul(attn, v)
    return out.transpose(1, 2).reshape(out.shape[0], q.shape[2], -1)


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                           bias: Optional[torch.Tensor] = None,
                           masks: Optional[torch.Tensor] = None,
                           tid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: ``q * scale`` in q's type, fp32 logits, bias
    and mask added, fp32 softmax rounded to v's type, then ``P @ v``; the
    windows in chunks of at most ``LOGITS_BUDGET`` bytes of logits."""
    b, h, nq, _ = q.shape
    chunk = max(1, LOGITS_BUDGET // max(1, h * nq * k.shape[2] * 4))
    outs = [_attend(q[s:s + chunk], k[s:s + chunk], v[s:s + chunk], scale, bias, masks,
                    None if tid is None else tid[s:s + chunk])
            for s in range(0, b, chunk)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, 0)


def _check_shapes(q, k, v, bias, masks, tid, out):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, H, n, hd)")
    b, h, nq, hd = q.shape
    nk = k.shape[2]
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != hd:
        raise ValueError(f"k and v must be (B, H, nk, hd) with q {tuple(q.shape)}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if bias is not None and tuple(bias.shape) != (h, nq, nk):
        raise ValueError(f"bias must be (H, nq, nk) = {(h, nq, nk)}, got {tuple(bias.shape)}")
    if masks is not None and tid is None:
        raise ValueError("masks need the windows' types tid")
    if masks is not None and (masks.dim() != 3 or tuple(masks.shape[1:]) != (nq, nk)
                              or tuple(tid.shape) != (b,)):
        raise ValueError(f"masks must be (T, nq, nk) and tid (B,) with (B, nq, nk) = "
                         f"{(b, nq, nk)}, got {tuple(masks.shape)} and {tuple(tid.shape)}")
    if out is not None and tuple(out.shape) != (b, nq, h * hd):
        raise ValueError(f"out must be (B, nq, H*hd) = {(b, nq, h * hd)}, got {tuple(out.shape)}")


def _check_cuda(q, k, v, bias, masks, tid, out):
    tensors = [t for t in (q, k, v, bias, masks, out) if t is not None]
    tensors += [tid] if masks is not None else []
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("window_attention: all operands must be on one CUDA device")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v)):
        raise ValueError(f"the CUDA kernel takes bf16 or fp32 q, k and v of one type, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if out is not None and out.dtype != q.dtype:
        raise ValueError(f"out must be {q.dtype}, got {out.dtype}")
    if any(t.stride(-1) != 1 for t in (q, k, v) + ((out,) if out is not None else ())):
        raise ValueError("window_attention: q, k, v and out need a feature stride of 1")
    if q.shape[3] > MAX_HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes a head dim up to {MAX_HEAD_DIM}, got {q.shape[3]}")


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library (built at first use), its signatures declared."""
    from vsrlab_tpu_torch.build import load

    lib = load("window_attention").lib
    lib.vsr_window_attention.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.vsr_window_attention.restype = ctypes.c_int
    lib.vsr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vsr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                     bias: Optional[torch.Tensor] = None, masks: Optional[torch.Tensor] = None,
                     tid: Optional[torch.Tensor] = None,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``softmax(scale * q k^T + bias + masks[tid]) v`` for every (window,
    head): ``q`` ``(B, H, nq, hd)``, ``k``, ``v`` ``(B, H, nk, hd)`` in any
    strides (a feature stride of 1 on the card), ``bias`` ``(H, nq, nk)``,
    ``masks`` ``(T, nq, nk)`` with the windows' types ``tid`` ``(B,)``
    (read only with masks); returns ``(B, nq, H*hd)``, head-major on
    channels, in q's type, written into ``out`` where given (a slice of a
    wider buffer will do). CUDA ``window_attention_kernel``, bf16 or fp32
    (a window whose type id lies outside ``[0, T)`` gets NaN rows there,
    where the plain version fails on the index); in an exported graph the
    custom op ``vsrlab::window_attention``."""
    _check_shapes(q, k, v, bias, masks, tid, out)
    if torch.compiler.is_exporting():
        y = torch.ops.vsrlab.window_attention(q, k, v, scale, bias, masks, tid)
    elif q.device.type == "cpu" or q.numel() == 0 or k.numel() == 0:
        # a CPU tensor, or nothing to launch (a head-sharded rank with no heads)
        y = window_attention_plain(q, k, v, scale, bias, masks, tid)
    else:
        _check_cuda(q, k, v, bias, masks, tid, out)
        bias = None if bias is None else bias.float().contiguous()
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (q, k, v, bias)):
            y = FusedAttention.apply(q, k, v, bias, masks, tid, scale)
        else:
            return _launch(q, k, v, scale, bias, masks, tid, out)
    return y if out is None else out.copy_(y)


def _launch(q, k, v, scale, bias, masks, tid, out=None) -> torch.Tensor:
    """One launch of the kernel on checked CUDA operands, counted."""
    b, h, nq, hd = q.shape
    nk = k.shape[2]
    if out is None:
        out = torch.empty((b, nq, h * hd), dtype=q.dtype, device=q.device)
    tid = None if masks is None else tid
    if masks is not None:
        masks = masks.float()
        masks = masks if masks.stride(-1) == 1 else masks.contiguous()
        tid = tid.long().contiguous()
    shape = (ctypes.c_int64 * 6)(b, h, nq, nk, hd, 0 if masks is None else masks.shape[0])
    strides = (ctypes.c_int64 * 16)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], out.stride(0), hd, out.stride(1),
        *(bias.stride()[:2] if bias is not None else (0, 0)),
        *(masks.stride()[:2] if masks is not None else (0, 0)))
    ptr = [None if t is None else t.data_ptr() for t in (bias, masks, tid)]
    rc = _lib().vsr_window_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *ptr, shape, strides, scale,
        q.element_size(), q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        msg = _lib().vsr_cuda_error_string(rc).decode()
        raise RuntimeError(f"window_attention launch failed at (B, H, nq, nk, hd) = "
                           f"{(b, h, nq, nk, hd)}, {q.dtype}: {msg}")
    window_attention.launches += 1
    window_attention.launches_by_shape[(b, h, nq, nk, hd, bias is not None,
                                        masks is not None)] += 1
    count("window_attention.launches", 1)
    return out


class FusedAttention(torch.autograd.Function):
    """The fused attention with a gradient: ``forward`` is the kernel launch
    of inference (counted as one), ``backward`` recomputes the plain
    version from the saved q, k, v and bias and differentiates it (a
    backward kernel is later work); masks and types get none."""

    @staticmethod
    def forward(ctx, q, k, v, bias, masks, tid, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, bias, masks, tid)
        return _launch(q.detach(), k.detach(), v.detach(), scale,
                       None if bias is None else bias.detach(), masks, tid)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, masks, tid = ctx.saved_tensors
        inputs = [None if t is None else t.detach().requires_grad_(ctx.needs_input_grad[i])
                  for i, t in enumerate((q, k, v, bias))]
        with torch.enable_grad():
            y = window_attention_plain(*inputs[:3], ctx.scale, inputs[3], masks, tid)
        wanted = [i for i, t in enumerate(inputs) if t is not None and t.requires_grad]
        grads = torch.autograd.grad(y, [inputs[i] for i in wanted], g)
        result = [None] * 7
        for i, gr in zip(wanted, grads):
            result[i] = gr
        return tuple(result)


# the kernel as a custom op, so that torch.export keeps it in its graph; its
# implementation is the wrapper's (the kernel on a CUDA tensor, counted)
@torch.library.custom_op("vsrlab::window_attention", mutates_args=())
def _attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                  bias: Optional[torch.Tensor], masks: Optional[torch.Tensor],
                  tid: Optional[torch.Tensor]) -> torch.Tensor:
    return window_attention(q, k, v, scale, bias, masks, tid)


@_attention_op.register_fake
def _(q, k, v, scale, bias, masks, tid):
    _check_shapes(q, k, v, bias, masks, tid, None)
    b, h, nq, hd = q.shape
    return q.new_empty((b, nq, h * hd))


def reset_launch_counts() -> None:
    """Zero ``window_attention.launches`` and ``launches_by_shape``."""
    window_attention.launches = 0
    window_attention.launches_by_shape = collections.Counter()


reset_launch_counts()
