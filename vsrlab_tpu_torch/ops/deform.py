"""Modulated deformable convolution (DCNv2) as per-tap bilinear sampling
plus one matmul per tap (port of ``vsrlab_tpu/ops/deform.py``).

For each of the ``kh*kw`` kernel taps the input is sampled at the tap's
position plus its learned offset
(:func:`vsrlab_tpu_torch.ops.warp.sample_pixel_coords`), modulated by the
mask, and multiplied by that tap's ``(Cin, Cout)`` weight slice; the taps
accumulate in fp32. Offset groups are folded into the batch axis, so one
tap is ONE sampler call over ``N*G`` images of ``Cin/G`` channels: the
shape the sampler kernels serve.

Offset layout follows torchvision: ``offset[..., 2*(g*kh*kw + k)]`` is the
**y** displacement and ``... + 1`` the **x** displacement of offset group
``g`` and kernel tap ``k`` (row-major over ``(kh, kw)``). ``mask`` is the
DCNv2 modulation scalar for each tap and offset group.

While a profiler collects, each call adds its sampled values,
``N * Ho * Wo * Cin * kh * kw``, to the counter ``deform.samples``
(:func:`vsrlab_tpu_torch.utils.profiler.count`): with ``Cout`` they give
the call's products (``2 * samples * Cout`` FLOPs) and the sampler's reads.
"""

from __future__ import annotations

import torch

from vsrlab_tpu_torch.ops.warp import sample_pixel_coords
from vsrlab_tpu_torch.utils.profiler import count


def deform_conv2d(
    x: torch.Tensor,
    offset: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    stride: int = 1,
    padding: int = 0,
    dilation: int = 1,
    mask: torch.Tensor | None = None,
    impl: str | None = None,
) -> torch.Tensor:
    """Deformable conv on channels-last tensors.

    ``x`` ``(N, H, W, Cin)``; ``offset`` ``(N, Ho, Wo, 2*G*kh*kw)`` in
    torchvision's (dy, dx) order; ``weight`` ``(kh, kw, Cin, Cout)`` (HWIO);
    ``bias`` ``(Cout,)``; ``mask`` ``(N, Ho, Wo, G*kh*kw)``. Returns
    ``(N, Ho, Wo, Cout)`` in ``x.dtype``. ``impl`` is the sampler's
    formulation (``"plain"``, ``"take"``, ``"fused"``).

    Precision contract: sampling and modulation run in ``x.dtype`` with
    fp32 coordinates and weights (a wider mask is rounded to ``x.dtype``);
    the tap products accumulate in fp32, the bias is added in fp32, and the
    result is cast once.
    """
    n, h, w, cin = x.shape
    kh, kw, wc_in, cout = weight.shape
    taps = kh * kw
    if wc_in != cin:
        raise ValueError("grouped weight (conv groups > 1) is not supported")
    if offset.shape[-1] % (2 * taps):
        raise ValueError("offset channels are not a multiple of 2*kh*kw")
    groups = offset.shape[-1] // (2 * taps)
    if cin % groups:
        raise ValueError("Cin must be divisible by the offset groups")
    cg = cin // groups
    ho, wo = offset.shape[1], offset.shape[2]
    count("deform.samples", n * ho * wo * cin * taps)

    # fold the offset groups into the batch axis, group-major within a sample
    xg = x.reshape(n, h, w, groups, cg).permute(0, 3, 1, 2, 4).reshape(n * groups, h, w, cg)
    off_b = (offset.reshape(n, ho, wo, groups, taps, 2).permute(0, 3, 1, 2, 4, 5)
             .reshape(n * groups, ho, wo, taps, 2))
    if mask is not None:
        m_b = (mask.reshape(n, ho, wo, groups, taps).permute(0, 3, 1, 2, 4)
               .reshape(n * groups, ho, wo, taps))

    ys = torch.arange(ho, device=x.device, dtype=torch.float32)[:, None] * stride - padding
    xs = torch.arange(wo, device=x.device, dtype=torch.float32)[None, :] * stride - padding
    # operands rounded to x.dtype, products accumulated in fp32
    w_k = weight.to(x.dtype).reshape(taps, cin, cout).float()
    out = None
    for k in range(taps):
        ky, kx = divmod(k, kw)
        py = (ys + ky * dilation)[None] + off_b[..., k, 0].float()
        px = (xs + kx * dilation)[None] + off_b[..., k, 1].float()
        s = sample_pixel_coords(
            xg, px, py, mode="bilinear", padding_mode="zeros",
            # take: two x-positions a table row for 8 to 16 channels a
            # group, the JAX package's choice at the alignment shape
            window_group=2 if 8 <= cg <= 16 else None, impl=impl,
        )  # (N*G, Ho, Wo, Cg) in x.dtype
        if mask is not None:
            s = s * m_b[..., k][..., None].to(x.dtype)
        s = s.reshape(n, groups, ho, wo, cg).permute(0, 2, 3, 1, 4).reshape(n, ho, wo, cin)
        contrib = torch.matmul(s.float(), w_k[k])
        out = contrib if out is None else out + contrib
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def modulated_deform_conv2d(x, offset, mask, weight, bias=None, stride=1, padding=0,
                            dilation=1, impl: str | None = None):
    """DCNv2: :func:`deform_conv2d` with a modulation mask."""
    return deform_conv2d(x, offset, weight, bias, stride, padding, dilation, mask, impl)
