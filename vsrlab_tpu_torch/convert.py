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
* the GAN's discriminator (:func:`unet_discriminator_state_dict`) takes
  its spectral-norm state from the ``batch_stats`` collection into each
  conv's ``u`` / ``sigma`` buffers; the perceptual VGG19
  (:func:`vgg19_state_dict`) is a list of ``conv_{i}`` convs.
* the flow models: RAFT (:func:`raft_state_dict`) takes the reference
  checkpoint's names, IRR-PWC keeps flax's, the progressive SpyNet's
  ``unit_{k}`` become ``units.{k}``.

Each ``*_state_dict`` function returns a flat ``{name: tensor}`` dict for
``load_state_dict(..., strict=True)`` of the matching port module.
:func:`write_run_dir` writes a JAX-trained param tree as a run directory
of the port, which :func:`vsrlab_tpu_torch.evaluation.harness.load_test_model`
serves (orbax checkpoints are not read here: that needs ``jax``).
"""

from __future__ import annotations

from pathlib import Path
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


def unet_discriminator_state_dict(params: Tree, batch_stats: Tree) -> dict:
    """``UNetDiscriminator`` params and ``batch_stats`` -> the port module's
    ``state_dict``: ``conv_0`` / ``conv_9`` with their biases, and for each
    spectral-norm ``conv_i`` the bias-free kernel (HWIO -> OIHW) and its
    ``batch_stats['conv_i']['SpectralNorm_0']['Conv_0/kernel/{u,sigma}']``."""
    out = {}
    for name, sub in params.items():
        conv = sub["Conv_0"]
        if "bias" in conv:
            out.update(conv_state_dict(conv, f"{name}."))
            continue
        kernel = np.asarray(conv["kernel"], np.float32).transpose(3, 2, 0, 1)
        stats = batch_stats[name]["SpectralNorm_0"]
        out[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel))
        out[f"{name}.u"] = torch.from_numpy(np.array(stats["Conv_0/kernel/u"], np.float32))
        out[f"{name}.sigma"] = torch.tensor(float(np.asarray(stats["Conv_0/kernel/sigma"])))
    return out


def vgg19_state_dict(params: Tree) -> dict:
    """``VGG19Features`` params (``conv_{i}/{kernel, bias}``) -> the port
    module's ``state_dict``."""
    out = {}
    for name, conv in params.items():
        out.update(conv_state_dict(conv, f"{name}."))
    return out


def _conv_tree_state_dict(p: Tree, prefix: str = "", rename=lambda name: name) -> dict:
    """A tree whose leaves are flax ``nn.Conv`` nodes (``{kernel, bias}``)
    -> ``{path.weight, path.bias}``, each path component through ``rename``."""
    out = {}
    for name, sub in p.items():
        if "kernel" in sub:
            out.update(conv_state_dict(sub, f"{prefix}{rename(name)}."))
        else:
            out.update(_conv_tree_state_dict(sub, f"{prefix}{rename(name)}.", rename))
    return out


def _raft_name(name: str) -> str:
    """flax's ``layer1_0`` / ``downsample`` -> the reference's ``layer1.0`` /
    ``downsample.0``."""
    if name.startswith("layer") and "_" in name:
        return name.replace("_", ".")
    return "downsample.0" if name == "downsample" else name


def raft_state_dict(params: Tree) -> dict:
    """``RAFT`` params (small or basic) -> the port's ``state_dict``, whose
    names are the reference checkpoint's (``fnet.layer1.0.conv1.weight``,
    ``update_block.gru.convz.weight``, ...)."""
    return _conv_tree_state_dict(params, rename=_raft_name)


def irr_pwc_state_dict(params: Tree) -> dict:
    """``IRRPWCNet`` params -> the port's ``state_dict`` (flax's names)."""
    return _conv_tree_state_dict(params)


def spynet_progressive_state_dict(params: Tree) -> dict:
    """``SpyNetProgressive`` params (``unit_{k}/conv_{j}/Conv_0``) -> the
    port's ``state_dict`` (``units.{k}.convs.{j}``); the units present."""
    out = {}
    for name, unit in params.items():
        out.update(spynet_unit_state_dict(unit, f"units.{int(name.split('_')[1])}."))
    return out


def spynet_unit_state_dict(params: Tree, prefix: str = "") -> dict:
    """One ``SpyNetBasicModule`` (``conv_{j}/Conv_0``) -> ``{prefix}convs.{j}``."""
    out = {}
    for j in range(len(params)):
        out.update(conv_state_dict(params[f"conv_{j}"]["Conv_0"], f"{prefix}convs.{j}."))
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


def _conv_params(sd: Mapping, prefix: str) -> dict:
    """``{prefix}weight`` (OIHW), ``{prefix}bias`` -> ``{kernel (HWIO), bias}``."""
    kernel = np.asarray(sd[f"{prefix}weight"]).transpose(2, 3, 1, 0)
    return {"kernel": np.ascontiguousarray(kernel), "bias": np.array(sd[f"{prefix}bias"])}


def _residual_block_params(sd: Mapping, prefix: str) -> dict:
    n = sum(1 for k in sd if k.startswith(f"{prefix}res_blocks.") and k.endswith("conv1.weight"))
    units = [[_conv_params(sd, f"{prefix}res_blocks.{i}.conv{j}.") for j in (1, 2)]
             for i in range(n)]
    stacked = {f"Conv2d_{j}": {"Conv_0": {k: np.stack([u[j][k] for u in units])
                                          for k in ("kernel", "bias")}} for j in (0, 1)}
    return {"ConvLeaky_0": {"Conv2d_0": {"Conv_0": _conv_params(sd, f"{prefix}head.conv.")}},
            "res_blocks": stacked}


def realbasicvsr_params(state_dict: Mapping) -> dict:
    """The inverse of :func:`realbasicvsr_state_dict`: a RealBasicVSR
    ``state_dict`` of the port (tensors on the CPU) -> the JAX package's
    param tree of numpy arrays (OIHW -> HWIO, units stacked back on a
    leading block axis)."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in state_dict.items()}
    spynet, i = {}, 0
    while f"basicvsr.spynet.basic_module.{i}.convs.0.weight" in sd:
        head, j = {}, 0
        while f"basicvsr.spynet.basic_module.{i}.convs.{j}.weight" in sd:
            head[f"conv_{j}"] = {"Conv_0": _conv_params(
                sd, f"basicvsr.spynet.basic_module.{i}.convs.{j}.")}
            j += 1
        spynet[f"basic_module_{i}"] = head
        i += 1
    vsr = {"spynet": spynet, "point_conv": {"Conv_0": _conv_params(sd, "basicvsr.point_conv.")}}
    for d in ("backward", "forward"):
        vsr[f"{d}_resblocks"] = {"ResidualBlock_0": _residual_block_params(
            sd, f"basicvsr.{d}_resblocks.")}
    u = 0
    while f"basicvsr.upsample.{u}.conv.weight" in sd:
        vsr[f"upsample_{u}"] = {"Conv2d_0": {"Conv_0": _conv_params(
            sd, f"basicvsr.upsample.{u}.conv.")}}
        u += 1
    for name in ("conv_hr", "conv_last"):
        vsr[name] = {"Conv_0": _conv_params(sd, f"basicvsr.{name}.")}
    cleaner = {"ResidualBlock_0": _residual_block_params(sd, "cleaner.resblock."),
               "Conv2d_0": {"Conv_0": _conv_params(sd, "cleaner.conv.")}}
    return {"cleaner": cleaner, "basicvsr": vsr}


def _mapper(config: Mapping):
    """The ``*_state_dict`` function of the model a run config names."""
    from vsrlab_tpu_torch.core.config import ALIASES

    target = config["train"]["model"]["_target_"]
    name = ALIASES.get(target, target).rsplit(".", 1)[-1]
    mappers = {"RealBasicVSR": realbasicvsr_state_dict, "BasicVSR": basicvsr_state_dict,
               "VRT": vrt_state_dict, "TinyVRT": vrt_state_dict}
    if name not in mappers:
        raise ValueError(f"no parameter mapping for model {target!r}")
    return mappers[name]


def write_run_dir(run_dir, params: Tree, config: Mapping, ema_params: Tree | None = None,
                  key: int = 0) -> None:
    """Write a run directory of the port from a JAX param tree (numpy
    leaves): the mapped ``state_dict`` at checkpoint ``key`` with the
    ``config`` snapshot (its ``train.model._target_`` picks the mapping),
    and ``ema_params``, where given, as the EMA sidecar ``<run>/ema`` at the
    same key."""
    from vsrlab_tpu_torch.core.checkpoint import CheckpointManager

    to_state_dict = _mapper(config)
    CheckpointManager(str(run_dir)).save(key, to_state_dict(params), config=dict(config))
    if ema_params is not None:
        CheckpointManager(str(Path(run_dir) / "ema")).save(key, to_state_dict(ema_params))
