"""The bf16 gate that holds the fused window attention to its plain version,
and a float64 emulation of the kernel's bf16 rounding points to show what
the gate lets through and what it refuses.

Gate (``bf16_gate_ratios(got, want) <= (1, 1)``), both parts scaled to the
output, not to v:

* each element within ``2^-7 |want| + 2^-8 max|want|``: one bf16 ulp at the
  element's own scale (kernel and plain version round outputs that differ
  slightly, so they may land one ulp apart: up to 2^-7 of the value), and a
  quarter of that at the row's scale for P's rounding, which each side does
  at its own point (the kernel the unnormalised P, the plain version the
  normalised one);
* the rms of the difference within ``2^-8`` of the output's rms.

On q and k of std ``QK_STD`` (logits of std ~4: a trained model's
attention is peaked, and the rounding of a logit grows with its size) the
kernel's arithmetic reads about half of either bound, and a kernel that
rounded its logits to bf16 reads 1.3-6 times them (the CPU test in
``tests/test_torch_window_attention.py``). A bf16 row sum is an error of
2^-9, the output's own rounding, and passes.
"""

import torch

QK_STD = 2.0


def bf16_gate_ratios(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """``(elementwise, rms)``: the largest share of each bound that
    ``|got - want|`` takes; the gate holds where both are at most 1."""
    got, want = got.double(), want.double()
    d = (got - want).abs()
    elem = d / (2 ** -7 * want.abs() + 2 ** -8 * want.abs().max())
    rms = d.pow(2).mean().sqrt() / (2 ** -8 * want.pow(2).mean().sqrt())
    return float(elem.max()), float(rms)


def emulate_kernel(q, k, v, scale, bias=None, masks=None, tid=None, logits_bf16=False):
    """The kernel's bf16 arithmetic in float64 on the CPU: ``q * scale``
    rounded to bf16, exact products summed (fp32's rounding of the sum is
    below everything here), bias and mask added in fp32, the softmax's
    ``exp(s - m)`` rounded to bf16 unnormalised, ``P.V`` exact, divided by
    the row sum of the unrounded ``exp(s - m)`` and rounded to bf16 once.
    ``logits_bf16`` rounds the logits to bf16 before the softmax: a kernel
    below the configuration's precision. Returns ``(B, nq, H*hd)`` bf16."""
    qs = (q.float() * scale).to(torch.bfloat16).double()
    s = torch.einsum("bhqd,bhkd->bhqk", qs, k.double()).float()
    if bias is not None:
        s = s + bias.float()
    if masks is not None:
        s = s + masks.float()[tid][:, None]
    if logits_bf16:
        s = s.to(torch.bfloat16).float()
    p = torch.exp((s - s.amax(-1, keepdim=True)).double())
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(torch.bfloat16).double(), v.double())
    o = (o / p.sum(-1, keepdim=True)).to(torch.bfloat16)
    return o.transpose(1, 2).reshape(o.shape[0], q.shape[2], -1)
