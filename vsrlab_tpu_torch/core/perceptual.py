"""VGG19 perceptual loss (port of ``vsrlab_tpu/core/perceptual.py``).

The L1 distance between VGG19 feature maps of prediction and target at
torchvision's ``features`` indices {2, 7, 16, 25, 34} (conv1_2 ... conv5_4)
with layer weights {0.1, 0.1, 0.8, 0.9, 1.0}, summed and scaled. Frames in
[0, 1] go in as they are (no ImageNet normalisation), as in the JAX
package and the reference.

Weights: nothing is downloaded. :func:`load_torch_vgg19` takes a
torchvision ``state_dict`` where one is at hand; otherwise the VGG is drawn
from a seeded ``torch.Generator`` with a He-normal init truncated at two
standard deviations (flax's ``he_normal``: variance 2 / fan_in), biases
zero. The JAX package draws the same distribution from ``PRNGKey(0)``,
a stream PyTorch cannot reproduce: the two default VGGs differ, and parity
between the packages holds for weights carried across
(:func:`vsrlab_tpu_torch.convert.vgg19_state_dict`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vsrlab_tpu_torch.nn.blocks import Conv2d, init_weights

# torchvision vgg19.features: (module index, out channels); "M" = 2x2 max pool
VGG19_FEATURES: List = [
    (0, 64), (2, 64), "M",
    (5, 128), (7, 128), "M",
    (10, 256), (12, 256), (14, 256), (16, 256), "M",
    (19, 512), (21, 512), (23, 512), (25, 512), "M",
    (28, 512), (30, 512), (32, 512), (34, 512), "M",
]

LAYER_WEIGHTS = {2: 0.1, 7: 0.1, 16: 0.8, 25: 0.9, 34: 1.0}

# the standard deviation of N(0, 1) truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


class _HeConv(Conv2d):
    """A 3x3 conv with flax's ``he_normal`` init: truncated normal, variance
    ``2 / fan_in``; zero bias."""

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        std = math.sqrt(2.0 / self.weight[0].numel()) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            self.bias.zero_()


class VGG19Features(nn.Module):
    """VGG19's ``features`` trunk up to the deepest tap, on ``(N, H, W, 3)``;
    ``forward`` returns the maps at ``tap_layers`` by index. Each tap is
    taken after its ReLU (torchvision's in-place ReLUs overwrite the stored
    conv outputs in the reference), except the deepest, whose ReLU lies
    past the cut and so stays before it. Parameters ``conv_{i}.weight`` /
    ``.bias``, fp32; ``dtype`` is the compute type."""

    def __init__(self, tap_layers: Sequence[int] = tuple(LAYER_WEIGHTS), dtype=None):
        super().__init__()
        self.tap_layers = tuple(tap_layers)
        deepest, in_ch = max(self.tap_layers), 3
        for item in VGG19_FEATURES:
            if item != "M":
                idx, ch = item
                if idx > deepest:
                    break
                self.add_module(f"conv_{idx}", _HeConv(in_ch, ch, 3, 1, 1, dtype=dtype))
                in_ch = ch

    def forward(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:
        taps: Dict[int, torch.Tensor] = {}
        deepest = max(self.tap_layers)
        for item in VGG19_FEATURES:
            if item == "M":
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
                continue
            idx, _ = item
            x = getattr(self, f"conv_{idx}")(x)
            if idx == deepest:
                taps[idx] = x
                break
            x = F.relu(x)
            if idx in self.tap_layers:
                taps[idx] = x
        return taps


class PerceptualLoss(nn.Module):
    """The weighted multi-layer L1 between the VGG features of ``yhat`` and
    ``y``, times ``weight``. Frames in [0, 1]; clips ``(B, T, H, W, 3)``
    are flattened to frames. The VGG is frozen (``requires_grad`` off) and
    the target branch runs without a gradient. ``state_dict`` (the port's
    layout, e.g. from :func:`load_torch_vgg19`) gives the weights, else
    they are drawn from a generator seeded with ``rng``."""

    def __init__(self, weight: float = 1e-2, layer_weights: Mapping[int, float] | None = None,
                 state_dict: Mapping[str, torch.Tensor] | None = None, rng: int = 0,
                 dtype=None):
        super().__init__()
        self.weight = float(weight)
        self.layer_weights = {int(k): float(v) for k, v in (layer_weights or LAYER_WEIGHTS).items()}
        self.model = VGG19Features(tuple(self.layer_weights), dtype=dtype)
        if state_dict is None:
            init_weights(self.model, torch.Generator().manual_seed(int(rng)))
        else:
            self.model.load_state_dict(state_dict)
        self.model.requires_grad_(False)

    def forward(self, yhat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if yhat.dim() == 5:
            yhat, y = yhat.flatten(0, 1), y.flatten(0, 1)
        f_pred = self.model(yhat)
        with torch.no_grad():
            f_gt = self.model(y)
        loss = torch.zeros((), device=yhat.device)
        for k, w in self.layer_weights.items():
            loss = loss + w * (f_pred[k].float() - f_gt[k].float()).abs().mean()
        return loss * self.weight


def load_torch_vgg19(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A torchvision ``vgg19().features`` ``state_dict`` (or a whole vgg19's,
    with ``features.`` prefixes) -> :class:`VGG19Features`' ``state_dict``
    (the layout is OIHW in both: the keys are picked out)."""
    out = {}
    for item in VGG19_FEATURES:
        if item == "M":
            continue
        idx, _ = item
        for key in (f"features.{idx}.weight", f"{idx}.weight"):
            if key in state_dict:
                out[f"conv_{idx}.weight"] = torch.as_tensor(state_dict[key]).float()
                out[f"conv_{idx}.bias"] = torch.as_tensor(
                    state_dict[key.replace("weight", "bias")]).float()
                break
    return out
