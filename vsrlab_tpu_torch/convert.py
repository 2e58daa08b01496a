"""Map a flax parameter tree of the JAX package to the port's ``state_dict``.

The tree is given as nested dicts of numpy arrays (``jax.tree.map(np.asarray,
params)``), with the paths that ``vsrlab_tpu``'s ``init`` produces:

* a conv is ``{..}/Conv_0/{kernel, bias}`` with an HWIO kernel, which
  becomes an OIHW ``weight``;
* a ``ResidualBlock`` keeps its ``nn.scan``-stacked units under
  ``res_blocks/Conv2d_{0,1}/Conv_0`` with a leading block axis
  (``(n, 3, 3, C, C)`` kernels, ``(n, C)`` biases); slice ``i`` of that
  axis is unit ``res_blocks.i``.

* the VRT family keeps flax's names (:func:`vrt_state_dict`): a ``Dense``
  kernel ``(in, out)`` becomes a ``weight`` ``(out, in)``, a ``LayerNorm``
  ``scale`` a ``weight``; the attention bias tables and the deformable
  conv's HWIO ``weight`` go over as they are.

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


def module_state_dict(p: Tree, prefix: str = "") -> dict:
    """A subtree of the VRT family, whose port modules keep flax's names:
    ``X/Conv_0`` and a bare 4-D ``kernel`` are convs (HWIO -> OIHW), a 2-D
    ``kernel`` is a ``Dense`` (transposed), ``scale`` a LayerNorm weight;
    every other leaf keeps its name and layout."""
    out = {}
    for name, sub in p.items():
        if name == "Conv_0":
            out.update(conv_state_dict(sub, prefix))
        elif isinstance(sub, Mapping):
            out.update(module_state_dict(sub, f"{prefix}{name}."))
        else:
            leaf = np.array(sub, np.float32)
            if name == "kernel":
                name = "weight"
                leaf = leaf.transpose(3, 2, 0, 1) if leaf.ndim == 4 else leaf.T
            elif name == "scale":
                name = "weight"
            out[f"{prefix}{name}"] = torch.from_numpy(np.ascontiguousarray(leaf))
    return out


def vrt_state_dict(p: Tree) -> dict:
    """``VRT`` / ``TinyVRT`` params -> the port model's ``state_dict``."""
    out = spynet_state_dict(p["optical_flow"], "optical_flow.")
    out.update(module_state_dict({k: v for k, v in p.items() if k != "optical_flow"}))
    return out


def _adam_leaves(opt_state):
    """The ``(mu, nu, count)`` of the first Adam state inside ``opt_state``
    (a mapping with those keys, or optax's nested state tuples)."""
    if isinstance(opt_state, Mapping) and "mu" in opt_state:
        return opt_state["mu"], opt_state["nu"], opt_state["count"]
    if all(hasattr(opt_state, k) for k in ("mu", "nu", "count")):
        return opt_state.mu, opt_state.nu, opt_state.count
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _adam_leaves(sub)
            if found is not None:
                return found
    return None


def adam_state_dict(opt_state, params: Tree) -> dict:
    """An optax Adam state (``mu``, ``nu`` under the params' tree, ``count``;
    numpy leaves, alone or inside optax's chain / ``apply_if_finite``
    states) -> ``{name: {"step", "exp_avg", "exp_avg_sq"}}`` for
    ``torch.optim.Adam``, keyed as :func:`realbasicvsr_state_dict` keys
    ``params`` (the moments transposed as the weights are)."""
    found = _adam_leaves(opt_state)
    if found is None:
        raise ValueError("no Adam state (mu, nu, count) in opt_state")
    mu, nu, count = found
    mu, nu = realbasicvsr_state_dict(mu), realbasicvsr_state_dict(nu)
    names = realbasicvsr_state_dict(params).keys()
    if mu.keys() != names or nu.keys() != names:
        raise ValueError("the Adam moments do not have the params' tree")
    step = torch.tensor(float(np.asarray(count)))
    return {n: {"step": step.clone(), "exp_avg": mu[n], "exp_avg_sq": nu[n]} for n in names}
