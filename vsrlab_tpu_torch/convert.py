"""Map a flax parameter tree of the JAX package to the port's ``state_dict``.

The tree is given as nested dicts of numpy arrays (``jax.tree.map(np.asarray,
params)``), with the paths that ``vsrlab_tpu``'s ``init`` produces:

* a conv is ``{..}/Conv_0/{kernel, bias}`` with an HWIO kernel, which
  becomes an OIHW ``weight``;
* a ``ResidualBlock`` keeps its ``nn.scan``-stacked units under
  ``res_blocks/Conv2d_{0,1}/Conv_0`` with a leading block axis
  (``(n, 3, 3, C, C)`` kernels, ``(n, C)`` biases); slice ``i`` of that
  axis is unit ``res_blocks.i``.

Each ``*_state_dict`` function returns a flat ``{name: tensor}`` dict for
``load_state_dict(..., strict=True)`` of the matching port module.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

Tree = Mapping[str, object]


def conv_state_dict(p: Tree, prefix: str = "") -> dict:
    """``{kernel (HWIO), bias}`` -> ``{prefix}weight`` (OIHW), ``{prefix}bias``."""
    kernel = np.asarray(p["kernel"], np.float32)
    return {
        f"{prefix}weight": torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))),
        f"{prefix}bias": torch.from_numpy(np.array(p["bias"], np.float32)),
    }


def residual_block_state_dict(p: Tree, prefix: str = "") -> dict:
    """A ``ResidualBlock`` subtree (``ConvLeaky_0`` head, scanned ``res_blocks``)."""
    out = conv_state_dict(p["ConvLeaky_0"]["Conv2d_0"]["Conv_0"], f"{prefix}head.conv.")
    rb = p["res_blocks"]
    stacked = [rb[f"Conv2d_{j}"]["Conv_0"] for j in (0, 1)]
    for i in range(np.asarray(stacked[0]["kernel"]).shape[0]):
        for j, leaf in enumerate(stacked):
            unit = {k: np.asarray(v)[i] for k, v in leaf.items()}
            out.update(conv_state_dict(unit, f"{prefix}res_blocks.{i}.conv{j + 1}."))
    return out


def iterative_refinement_state_dict(p: Tree, prefix: str = "") -> dict:
    """The RealBasicVSR cleaner (``ResidualBlock_0`` + ``Conv2d_0``)."""
    out = residual_block_state_dict(p["ResidualBlock_0"], f"{prefix}resblock.")
    out.update(conv_state_dict(p["Conv2d_0"]["Conv_0"], f"{prefix}conv."))
    return out


def spynet_state_dict(p: Tree, prefix: str = "") -> dict:
    """``basic_module_{i}/conv_{j}/Conv_0`` -> ``basic_module.i.convs.j``."""
    out = {}
    i = 0
    while f"basic_module_{i}" in p:
        head = p[f"basic_module_{i}"]
        for j in range(len(head)):
            out.update(conv_state_dict(head[f"conv_{j}"]["Conv_0"],
                                       f"{prefix}basic_module.{i}.convs.{j}."))
        i += 1
    return out


def basicvsr_state_dict(p: Tree, prefix: str = "") -> dict:
    out = spynet_state_dict(p["spynet"], f"{prefix}spynet.")
    for d in ("backward", "forward"):
        out.update(residual_block_state_dict(
            p[f"{d}_resblocks"]["ResidualBlock_0"], f"{prefix}{d}_resblocks."))
    out.update(conv_state_dict(p["point_conv"]["Conv_0"], f"{prefix}point_conv."))
    u = 0
    while f"upsample_{u}" in p:
        out.update(conv_state_dict(p[f"upsample_{u}"]["Conv2d_0"]["Conv_0"],
                                   f"{prefix}upsample.{u}.conv."))
        u += 1
    for name in ("conv_hr", "conv_last"):
        out.update(conv_state_dict(p[name]["Conv_0"], f"{prefix}{name}."))
    return out


def realbasicvsr_state_dict(p: Tree) -> dict:
    out = iterative_refinement_state_dict(p["cleaner"], "cleaner.")
    out.update(basicvsr_state_dict(p["basicvsr"], "basicvsr."))
    return out
