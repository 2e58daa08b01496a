"""Loss functions (port of ``vsrlab_tpu/core/losses.py:17-191``).

Each pixel loss takes two tensors of one shape, computes in fp32 and
returns a 0-d fp32 tensor. The perceptual VGG loss, which carries
parameters, lives in :mod:`vsrlab_tpu_torch.core.perceptual`. The
optical-flow losses (``epe_loss``, ``OpticalFlowConsistency``) belong to
the flow slice.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from vsrlab_tpu_torch.ops.resize import resize_bilinear


def charbonnier_loss(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Charbonnier (smooth L1) loss: ``mean(sqrt((x-y)^2 + eps))`` (eps inside
    the square root, not squared)."""
    diff = x.float() - y.float()
    return torch.sqrt(diff * diff + eps).mean()


def l1_loss(x: torch.Tensor, y: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """Weighted mean absolute error."""
    return (x.float() - y.float()).abs().mean() * weight


def rmse_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Root-mean-square error."""
    diff = x.float() - y.float()
    return torch.sqrt((diff * diff).mean())


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Binary cross entropy with logits, mean reduction, in fp32:
    ``max(l, 0) - l*t + log1p(exp(-|l|))``."""
    logits, targets = logits.float(), targets.float()
    loss = logits.clamp_min(0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    return loss.mean()


def adversarial_loss(logits: torch.Tensor, target: float, is_disc: bool = False,
                     weight: float = 2e-5) -> torch.Tensor:
    """GAN BCE against a constant ``target``: scaled by ``weight`` for the
    generator, the raw BCE for the discriminator (``is_disc``)."""
    loss = bce_with_logits(logits, torch.full_like(logits, target, dtype=torch.float32))
    return loss if is_disc else loss * weight


def compute_loss(loss_fn: Callable, sr: torch.Tensor, hr: torch.Tensor,
                 lq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``loss_fn(sr, hr)``, plus ``loss_fn(lq, resize(hr))`` on the LR grid
    where the model returns its cleaned clip ``lq``; clips ``(B, T, H, W, C)``."""
    loss = loss_fn(sr, hr)
    if lq is not None:
        loss = loss + loss_fn(lq, resize_bilinear(hr, lq.shape[-3:-1]))
    return loss


class LossPipeline:
    """Config-driven sum of losses. ``losses`` maps names to ``f(pred, gt)
    -> scalar``; ``pipeline`` is a list of one-entry dicts ``{name: {"x":
    key, "y": key}}`` evaluated over a dict of tensors. A key prefixed
    ``match_`` is resized (bilinear) to the other operand's spatial size
    first. The result is the input dict plus each loss's total under its
    name and their sum under ``loss`` (with ``prefix`` / ``postfix``)."""

    def __init__(self, losses: Dict[str, Callable], pipeline: List[Dict],
                 prefix: str | None = None, postfix: str | None = None):
        self.losses = dict(losses)
        self.pipeline = list(pipeline)
        self.prefix, self.postfix = prefix, postfix

    def _name(self, base: str) -> str:
        name = base if self.prefix is None else self.prefix + base
        return name if self.postfix is None else name + self.postfix

    def __call__(self, args: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        args = dict(args)
        for key in (*self.losses, "loss"):
            args[self._name(key)] = torch.zeros(())
        for cfg in self.pipeline:
            (name, spec), = cfg.items()
            pred_key, gt_key = spec["x"], spec["y"]
            if pred_key.startswith("match_"):
                pred, gt = self._match(args[pred_key.removeprefix("match_")], args[gt_key])
            elif gt_key.startswith("match_"):
                gt, pred = self._match(args[gt_key.removeprefix("match_")], args[pred_key])
            else:
                pred, gt = args[pred_key], args[gt_key]
            loss = self.losses[name](pred, gt)
            args[self._name(name)] = args[self._name(name)] + loss
            args[self._name("loss")] = args[self._name("loss")] + loss
        return args

    @staticmethod
    def _match(matching, target):
        return resize_bilinear(matching, target.shape[-3:-1]), target
