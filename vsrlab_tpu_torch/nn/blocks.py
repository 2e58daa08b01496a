"""Conv building blocks on channels-last tensors (port of ``vsrlab_tpu/nn/blocks.py``).

Every block takes and returns ``(N, H, W, C)`` tensors, the 3-D ones
(``ConvST``, ``ConvSTBlock``, ``PixelShufflePack3D``) ``(B, T, H, W, C)``;
a conv views its input as a ``channels_last`` NCHW (NCDHW) tensor for
``F.conv2d`` (``F.conv3d``) and views the result back, so no copy is made.
Parameters are fp32 in torch's OIHW (OIDHW) layout; ``dtype`` (for example ``torch.bfloat16``) is the compute type,
as the JAX package threads it through its modules.

Initialisation is torch's ``nn.Conv2d`` / ``nn.Linear`` default
(kaiming_uniform with ``a=sqrt(5)``, i.e. ``U(-1/sqrt(fan_in),
1/sqrt(fan_in))`` for weight and bias), drawn from an explicit
``torch.Generator`` (:func:`init_weights`); a ``zero_init`` conv (the
offset head of a deformable conv) stays zero.

The ``ResidualConv`` units of a :class:`ResidualBlock` run through the
fused residual pair (:mod:`vsrlab_tpu_torch.ops.residual_pair`): on a CUDA
tensor a hand-written kernel, on a CPU tensor its plain version. Under a
gradient the same kernel runs inside
:class:`~vsrlab_tpu_torch.ops.residual_pair.ResidualPair`, whose backward
is PyTorch convolutions.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.optim.optimizer import register_optimizer_step_post_hook

from vsrlab_tpu_torch.ops.deform import deform_conv2d
from vsrlab_tpu_torch.ops.pixel_shuffle import pixel_shuffle
from vsrlab_tpu_torch.ops.residual_pair import (
    C as PAIR_C,
    PAIR_IMPLS,
    pack_weight_fragments,
    residual_conv_pair,
    residual_conv_pair_im2col,
    residual_pair,
)
from vsrlab_tpu_torch.ops.warp import SAMPLER_IMPLS


class Conv2d(nn.Module):
    """2-D conv with torch-default init, on ``(N, H, W, C)``; ``kernel_size``
    and ``padding`` an int or an ``(h, w)`` pair."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3,
                 stride: int = 1, padding=1, dtype: torch.dtype | None = None,
                 zero_init: bool = False, dilation: int = 1):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.dilation = dilation
        self.zero_init = zero_init
        kh, kw = (kernel_size, kernel_size) if isinstance(kernel_size, int) else kernel_size
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kh, kw))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        bound = 0.0 if self.zero_init else 1.0 / math.sqrt(self.weight[0].numel())
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def compute_dtype(self, x: torch.Tensor) -> torch.dtype:
        """``dtype`` if set, else the promotion of input and params (flax's rule)."""
        return self.dtype or torch.promote_types(x.dtype, self.weight.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype(x)
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), self.bias.to(dt),
                     self.stride, self.padding, self.dilation)
        return y.permute(0, 2, 3, 1)


class Conv3d(nn.Module):
    """3-D conv with torch-default init, on ``(B, T, H, W, C)``: the input is
    viewed as a ``channels_last_3d`` NCDHW tensor for ``F.conv3d``, so no copy
    is made. ``kernel_size``, ``stride`` and ``padding`` are ``(t, h, w)``
    triples, the padding symmetric as flax's ``[(p, p)] * 3``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=(3, 3, 3),
                 stride=(1, 1, 1), padding=(1, 1, 1), bias: bool = True, dtype=None):
        super().__init__()
        self.stride, self.padding, self.dtype = tuple(stride), tuple(padding), dtype
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, *kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            if self.bias is not None:
                self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        y = F.conv3d(x.to(dt).permute(0, 4, 1, 2, 3), self.weight.to(dt), bias, self.stride,
                     self.padding)
        return y.permute(0, 2, 3, 4, 1)


class Linear(nn.Module):
    """Dense layer over the last axis with torch-default init; ``weight`` is
    ``(out, in)`` in fp32, ``dtype`` the compute type."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            if self.bias is not None:
                self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis as flax computes it: statistics and
    the affine map in fp32, ``eps`` 1e-6, the result in the compute type."""

    def __init__(self, features: int, eps: float = 1e-6, dtype=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(), self.bias.float(),
                         self.eps)
        return y.to(dt)


class ConvReLU(nn.Module):
    """conv -> ReLU on ``(N, H, W, C)``; the conv is ``Conv2d_0`` (flax's name)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 1, dtype=None):
        super().__init__()
        self.Conv2d_0 = Conv2d(in_channels, features, kernel_size, stride, padding, dtype=dtype)

    def forward(self, x):
        return torch.relu(self.Conv2d_0(x))


class ConvLeaky(nn.Module):
    """conv -> LeakyReLU(0.1)."""

    def __init__(self, in_channels: int, out_channels: int, dtype=None):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, 3, 1, 1, dtype=dtype)

    def forward(self, x):
        return F.leaky_relu(self.conv(x), 0.1)


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + 1e-12)  # flax SpectralNorm's epsilon


class SpectralConv(nn.Module):
    """Spectral-normalised conv without bias, on ``(N, H, W, C)``, with flax
    ``nn.SpectralNorm``'s semantics (written out: torch's
    ``spectral_norm`` differs in each point below).

    * Every call makes one power iteration from the stored ``u`` (buffer
      ``(1, out)``) over the kernel as a matrix (flax's HWIO ``(kh*kw*in,
      out)``; the OIHW ``(out, in*kh*kw)`` used here is its transpose with
      the columns permuted, which gives the same ``u`` and ``sigma``). With
      ``update_stats`` the new ``u`` and ``sigma`` are stored; without, they
      are used and dropped (torch skips the iteration in eval mode).
    * A vector is normalised as ``x * rsqrt(sum(x^2) + 1e-12)``.
    * ``u`` and ``v`` carry no gradient, ``sigma`` does (through the kernel).
    * The iteration and the division run in fp32 (``u`` and ``sigma`` are
      fp32 buffers); the normalised kernel is then cast to the compute type.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, dtype: torch.dtype | None = None):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size))
        self.register_buffer("u", torch.empty(1, out_channels))
        self.register_buffer("sigma", torch.ones(()))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.u.normal_(generator=generator)
            self.sigma.fill_(1.0)

    def normalized_weight(self, update_stats: bool = False) -> torch.Tensor:
        """The kernel over its spectral norm, in fp32, OIHW."""
        w = self.weight.float()
        mat = w.reshape(w.shape[0], -1)
        with torch.no_grad():
            v = _l2_normalize(self.u.float() @ mat)
            u = _l2_normalize(v @ mat.t())
        sigma = ((v @ mat.t()) @ u.t())[0, 0]
        if update_stats:
            # u is a new tensor, so the graph holds no view of the buffer
            # that a second pass in the same step would write again
            self.u.copy_(u)
            self.sigma.copy_(sigma.detach())
        return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, torch.float32)
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.normalized_weight(update_stats).to(dt),
                     None, self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


# torch.optim steps taken in this process, counted by a global post-step hook
_OPTIMIZER_STEPS = [0]


@functools.cache
def _watch_optimizer_steps() -> None:
    """Register the step counter once (at the first ``ResidualConv``): a
    fused optimizer writes the parameters without bumping their version
    counters, so the operand cache keys on this count as well."""
    def count(optimizer, args, kwargs):
        _OPTIMIZER_STEPS[0] += 1

    register_optimizer_step_post_hook(count)


class ResidualConv(nn.Module):
    """``x + conv2(relu(conv1(x)))``, computed by the fused residual pair.

    Without a gradient the pair's operands (HWIO weights in the compute
    type, fp32 biases, and for the bf16 ``taps`` kernel its own order of the
    weights) are laid out once and reused. The cache is keyed on the
    parameters' storage and version counters (in-place writes bump them)
    and on the process's count of optimizer steps (a fused optimizer's step
    does not bump them), and it is dropped by ``load_state_dict``, by
    ``.to()`` and the other ``_apply`` moves, and by ``train()`` /
    ``eval()``. A write through ``p.data`` is invisible to all of these:
    call :func:`refresh_pair_caches` after one (the serving entry points
    call it).

    Where a gradient is wanted (grad mode on and ``x`` or a parameter
    requiring grad), the operands and the kernel's weight order are built
    anew from the parameters on each call, so the forward and the backward
    see the same weights; the pair runs as ``ResidualPair``: the same
    kernel, then a gradient for every operand. ``impl="plain"`` is autograd
    through the plain version on those same operands. While
    ``torch.export`` traces the module, the same layout ops go into the
    graph and the pair into it as the ``vsrlab::`` custom op, so that an
    exported program launches the kernel.
    """

    def __init__(self, features: int = 64, dtype=None):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3, 1, 1, dtype=dtype)
        self.conv2 = Conv2d(features, features, 3, 1, 1, dtype=dtype)
        self._pair_cache: list | None = None  # [key, operands, fragments]
        _watch_optimizer_steps()

    def _params(self):
        return self.conv1.weight, self.conv1.bias, self.conv2.weight, self.conv2.bias

    def _load_from_state_dict(self, *args, **kwargs):
        self._pair_cache = None
        super()._load_from_state_dict(*args, **kwargs)

    def _apply(self, fn, recurse=True):
        self._pair_cache = None
        return super()._apply(fn, recurse)

    def train(self, mode: bool = True):
        self._pair_cache = None
        return super().train(mode)

    def pair_operands(self, dtype: torch.dtype):
        """``(w1, b1, w2, b2)`` in the kernel's layout for compute ``dtype``."""
        params = self._params()
        key = (dtype, _OPTIMIZER_STEPS[0]) + tuple((p.data_ptr(), p._version) for p in params)
        if self._pair_cache is None or self._pair_cache[0] != key:
            with torch.no_grad():
                ops = tuple(t.detach() for t in self.grad_operands(dtype))
            self._pair_cache = [key, ops, None]
        return self._pair_cache[1]

    def pair_fragments(self):
        """The bf16 operands' weights in the ``taps`` kernel's order, cached
        with the operands they are laid out from."""
        w1, _, w2, _ = self.pair_operands(torch.bfloat16)
        if self._pair_cache[2] is None:
            self._pair_cache[2] = (pack_weight_fragments(w1), pack_weight_fragments(w2))
        return self._pair_cache[2]

    def grad_operands(self, dtype: torch.dtype):
        """``(w1, b1, w2, b2)`` as :meth:`pair_operands` lays them out, made
        from the parameters on this call with the graph kept."""
        # one copy where the type changes (to() keeps a view where it does not)
        w1, w2 = (c.weight.permute(2, 3, 1, 0).to(dtype, memory_format=torch.contiguous_format)
                  for c in (self.conv1, self.conv2))
        return w1.contiguous(), self.conv1.bias.float(), w2.contiguous(), self.conv2.bias.float()

    def forward(self, x, impl: str = "taps"):
        dt = self.conv1.compute_dtype(x)
        x = x.to(dt).contiguous()
        taps = impl == "taps" and x.is_cuda and dt == torch.bfloat16 and x.shape[-1] == PAIR_C
        exporting = torch.compiler.is_exporting()
        if exporting or (torch.is_grad_enabled()
                         and (x.requires_grad or any(p.requires_grad for p in self._params()))):
            ops = self.grad_operands(dt)
            if impl == "plain":
                return PAIR_IMPLS[impl](x, *ops)
            # the kernel's weight order laid out from this call's operands
            fragments = (tuple(pack_weight_fragments(w.detach()) for w in ops[::2])
                         if taps else None)
            if exporting:  # the wrappers trace as the vsrlab:: custom ops
                return (residual_conv_pair(x, *ops, fragments=fragments) if impl == "taps"
                        else residual_conv_pair_im2col(x, *ops))
            return residual_pair(x, *ops, impl, fragments)
        ops = self.pair_operands(dt)
        if taps:
            # the cache now holds the bf16 operands: their fragments lie beside them
            return residual_conv_pair(x, *ops,
                                      fragments=self._pair_cache[2] or self.pair_fragments())
        return PAIR_IMPLS[impl](x, *ops)


class ResidualBlock(nn.Module):
    """ConvLeaky head then ``blocks`` x :class:`ResidualConv`.

    ``pair_impl`` picks the residual pair's formulation: ``"taps"`` (nine
    K=64 products per conv, the default), ``"im2col"`` (one K=576 product)
    or ``"plain"`` (the plain PyTorch version, on any device).
    """

    def __init__(self, in_channels: int, features: int = 64, blocks: int = 30, dtype=None):
        super().__init__()
        self.head = ConvLeaky(in_channels, features, dtype=dtype)
        self.res_blocks = nn.ModuleList(ResidualConv(features, dtype) for _ in range(blocks))
        self.pair_impl = "taps"

    def forward(self, x):
        x = self.head(x)
        for unit in self.res_blocks:
            x = unit(x, self.pair_impl)
        return x


class ConvST(nn.Module):
    """Factorised spatio-temporal 3-D conv on ``(B, T, H, W, C)``: a bias-free
    ``(1, kh, kw)`` conv over space (``Conv_0``), then a bias-free
    ``(kt, 1, 1)`` conv over time (``Conv_1``), each with its axes' share of
    ``strides`` and ``padding``."""

    def __init__(self, in_channels: int, features: int, kernel_size=(3, 3, 3),
                 strides=(1, 1, 1), padding=(1, 1, 1), dtype=None):
        super().__init__()
        (kt, kh, kw), (st, sh, sw), (pt, ph, pw) = kernel_size, strides, padding
        self.Conv_0 = Conv3d(in_channels, features, (1, kh, kw), (1, sh, sw), (0, ph, pw),
                             bias=False, dtype=dtype)
        self.Conv_1 = Conv3d(features, features, (kt, 1, 1), (st, 1, 1), (pt, 0, 0),
                             bias=False, dtype=dtype)

    def forward(self, x):
        return self.Conv_1(self.Conv_0(x))


class ConvSTBlock(nn.Module):
    """A 3x3x3 conv head with bias (``Conv_0``), then ``blocks`` x
    :class:`ConvST` (``st_{i}``), on ``(B, T, H, W, C)``."""

    def __init__(self, in_channels: int, features: int, blocks: int, dtype=None):
        super().__init__()
        self.blocks = blocks
        self.Conv_0 = Conv3d(in_channels, features, dtype=dtype)
        for i in range(blocks):
            self.add_module(f"st_{i}", ConvST(features, features, dtype=dtype))

    def forward(self, x):
        x = self.Conv_0(x)
        for i in range(self.blocks):
            x = getattr(self, f"st_{i}")(x)
        return x


class PixelShufflePack(nn.Module):
    """conv to ``features * r^2`` channels, then depth-to-space x r."""

    def __init__(self, in_channels: int, features: int, upscale_factor: int = 2, dtype=None):
        super().__init__()
        self.r = upscale_factor
        self.conv = Conv2d(in_channels, features * upscale_factor**2, 3, 1, 1, dtype=dtype)

    def forward(self, x):
        return pixel_shuffle(self.conv(x), self.r)


class PixelShufflePack3D(nn.Module):
    """:class:`ConvST` to ``features * r^2`` channels (``ConvST_0``), then
    depth-to-space x r on each frame of ``(B, T, H, W, C)``."""

    def __init__(self, in_channels: int, features: int, upscale_factor: int = 2, dtype=None):
        super().__init__()
        self.r = upscale_factor
        self.ConvST_0 = ConvST(in_channels, features * upscale_factor**2, dtype=dtype)

    def forward(self, x):
        x = self.ConvST_0(x)
        b, t, h, w, c = x.shape
        return pixel_shuffle(x.reshape(b * t, h, w, c), self.r).reshape(b, t, h * self.r,
                                                                        w * self.r, -1)


class IterativeRefinement(nn.Module):
    """RealBasicVSR cleaning module: ``steps`` x (``x += conv(resblock(x))``)
    over frames ``(N, H, W, out_channels)``."""

    def __init__(self, mid_channels: int = 64, blocks: int = 20, steps: int = 3,
                 out_channels: int = 3, dtype=None):
        super().__init__()
        self.steps = steps
        self.resblock = ResidualBlock(out_channels, mid_channels, blocks, dtype=dtype)
        self.conv = Conv2d(mid_channels, out_channels, 3, 1, 1, dtype=dtype)

    def forward(self, x):
        for _ in range(self.steps):
            x = x + self.conv(self.resblock(x))
        return x


class DeformConvPack(nn.Module):
    """Deformable 3x3 conv with learned offsets: a zero-initialised conv
    over the input predicts them, then
    :func:`vsrlab_tpu_torch.ops.deform.deform_conv2d`. ``weight`` is HWIO
    ``(k, k, Cin, Cout)``; ``sampler_impl`` is the sampler's formulation."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3, padding: int = 1,
                 deformable_groups: int = 1, dtype=None):
        super().__init__()
        k = kernel_size
        self.padding = padding
        self.sampler_impl = "fused"
        self.offset_conv = Conv2d(in_channels, deformable_groups * 2 * k * k, k, 1, padding,
                                  dtype=dtype, zero_init=True)
        self.weight = nn.Parameter(torch.empty(k, k, in_channels, features))
        self.bias = nn.Parameter(torch.empty(features))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        k, _, cin, _ = self.weight.shape
        bound = 1.0 / math.sqrt(k * k * cin)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x):
        return deform_conv2d(x, self.offset_conv(x), self.weight, self.bias, stride=1,
                             padding=self.padding, impl=self.sampler_impl)


class DeformBlock(nn.Module):
    """conv_in -> ``blocks`` x :class:`DeformConvPack` -> conv_out."""

    def __init__(self, in_features: int, mid_features: int, blocks: int, dtype=None):
        super().__init__()
        self.conv_in = Conv2d(in_features, mid_features, 3, 1, 1, dtype=dtype)
        self.dcs = nn.ModuleList(DeformConvPack(mid_features, mid_features, dtype=dtype)
                                 for _ in range(blocks))
        self.conv_out = Conv2d(mid_features, in_features, 3, 1, 1, dtype=dtype)

    def forward(self, x):
        x = self.conv_in(x)
        for dc in self.dcs:
            x = dc(x)
        return self.conv_out(x)


def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw the parameters of every module under ``module`` that has a
    ``reset_parameters(generator)`` (convs, dense layers, deformable convs,
    attention bias tables) from ``generator``, in module order
    (reproducible for a seeded generator)."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator)
    return module


def refresh_pair_caches(module: nn.Module) -> nn.Module:
    """Drop the cached pair operands of every :class:`ResidualConv` under
    ``module``. Needed after a write through ``p.data`` (which no version
    counter sees); loads, moves, mode switches and optimizer steps drop
    the caches themselves."""
    for m in module.modules():
        if isinstance(m, ResidualConv):
            m._pair_cache = None
    return module


def set_pair_impl(module: nn.Module, impl: str) -> nn.Module:
    """Set ``pair_impl`` on every :class:`ResidualBlock` under ``module``."""
    if impl not in PAIR_IMPLS:
        raise ValueError(f"unknown residual pair formulation: {impl}")
    for m in module.modules():
        if isinstance(m, ResidualBlock):
            m.pair_impl = impl
    return module


def set_sampler_impl(module: nn.Module, impl: str) -> nn.Module:
    """Set ``sampler_impl`` (``"fused"``, ``"take"`` or ``"plain"``) on
    every deformable conv under ``module``."""
    if impl not in SAMPLER_IMPLS:
        raise ValueError(f"unknown sampler formulation: {impl}")
    for m in module.modules():
        if hasattr(m, "sampler_impl"):
            m.sampler_impl = impl
    return module
