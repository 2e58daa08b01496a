"""Plain reference of the supervised training step: the Charbonnier loss of
the SR frames against the HR frames plus that of the cleaned frames
against the HR frames resized (bilinear, no antialias) to the LR grid;
the global gradient norm clipped to ``grad_clip`` (every parameter
counted, a frozen one with a zero gradient); Adam with PyTorch's update
rule (bias-corrected moments, ``eps`` outside the root). Written from the
equations, on plain tensors in float32."""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F


def charbonnier(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    d = x - y
    return torch.sqrt(d * d + eps).mean()


def supervised_loss(out, hr: torch.Tensor) -> torch.Tensor:
    """``out`` is ``(sr, lq)`` clips (B, T, H, W, 3); ``hr`` (B, T, sH, sW, 3)."""
    sr, lq = out
    b, t, h, w, c = lq.shape
    hr_n = hr.reshape(b * t, *hr.shape[2:]).permute(0, 3, 1, 2)
    small = F.interpolate(hr_n, size=(h, w), mode="bilinear", align_corners=False)
    small = small.permute(0, 2, 3, 1).reshape(b, t, h, w, c)
    return charbonnier(sr, hr) + charbonnier(lq, small)


class Adam:
    """Adam over a list of tensors, after clipping the global norm."""

    def __init__(self, params: List[torch.Tensor], lr: float, betas: Sequence[float],
                 eps: float = 1e-8, grad_clip: float | None = None):
        self.params, self.lr, self.eps, self.grad_clip = params, lr, eps, grad_clip
        self.b1, self.b2 = betas
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Apply one update; returns the gradients as the moments took them."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        if self.grad_clip and norm >= self.grad_clip:
            grads = [g * (self.grad_clip / norm) for g in grads]
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))
        return grads


def accumulated_grads(forward: Callable, params: Dict[str, torch.Tensor], names: List[str],
                      lr: torch.Tensor, hr: torch.Tensor, rows: int):
    """The loss of the whole batch and every named parameter's gradient,
    computed over blocks of ``rows`` clips (the loss is a mean over equal
    blocks, so the blocks' losses and gradients average to the batch's)."""
    n = lr.shape[0]
    blocks = math.ceil(n / rows)
    if n % blocks:
        raise ValueError(f"batch {n} does not split into equal blocks of at most {rows}")
    size = n // blocks
    grads = [torch.zeros_like(params[k]) for k in names]
    total = 0.0
    leaves = [params[k] for k in names]
    for s in range(0, n, size):
        loss = supervised_loss(forward(params, lr[s:s + size]), hr[s:s + size]) / blocks
        got = torch.autograd.grad(loss, [x for x in leaves if x.requires_grad],
                                  allow_unused=True)
        it = iter(got)
        for i, x in enumerate(leaves):
            if x.requires_grad:
                g = next(it)
                if g is not None:
                    grads[i] += g
        total += float(loss.detach())
    return total, grads
