"""Checkpoints of the reference vsrlab (PyTorch) into the port's models
(port of ``vsrlab_tpu/core/torch_import.py``).

* :func:`load_reference_checkpoint` reads a reference checkpoint and
  unwraps its ``model_state_dict`` / ``state_dict`` / ``params``;
* :func:`load_torch_spynet` takes the SpyNet pyramid in any of the
  family's layouts;
* :func:`load_torch_realbasicvsr` takes a whole RealBasicVSR (the
  reference ``checkpoint.tar``'s ``model_state_dict``);
* :func:`load_torch_vrt` takes a VRT / TinyVRT (the reference's
  ``src/vsr/models/VRT/vrt.py`` module layout, the published
  ``002_VRT_videosr_bi_REDS_16frames.pth`` among them).

Each returns the ``state_dict`` of the port's ``SpyNet`` / ``RealBasicVSR``
/ ``VRT`` or ``TinyVRT`` (fp32 CPU tensors) for ``load_state_dict(...,
strict=True)``: the reference's names are read into the JAX package's
param tree (numpy; OIHW -> HWIO, as the JAX importers do), which
:mod:`vsrlab_tpu_torch.convert` maps onto the port, so the result is the
JAX importer's composed with ``convert``. A DDP ``module.`` prefix is
stripped; keys the port computes itself (SpyNet's ``mean`` / ``std``,
attention's ``relative_position_index`` and ``position_bias``) are not
read. Torch tensors and numpy arrays are both accepted.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

from vsrlab_tpu_torch import convert


def load_reference_checkpoint(path) -> dict:
    """``torch.load`` on the CPU; the state dict under ``model_state_dict``,
    ``state_dict`` or ``params`` (the first that holds a dict), else the
    loaded object itself."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("model_state_dict", "state_dict", "params"):
        if isinstance(sd, dict) and isinstance(sd.get(key), dict):
            return sd[key]
    return sd


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        t = t.float() if t.is_floating_point() else t
        return t.numpy()
    return np.asarray(t)


def _strip_module(state_dict) -> dict:
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in state_dict.items()}


def _conv(sd, key) -> Dict[str, np.ndarray]:
    """torch ``Conv2d`` (OIHW) -> flax ``{kernel (HWIO), bias}``."""
    leaf = {"kernel": _np(sd[f"{key}.weight"]).transpose(2, 3, 1, 0)}
    if f"{key}.bias" in sd:
        leaf["bias"] = _np(sd[f"{key}.bias"])
    return leaf


def _conv3d_133(sd, key) -> Dict[str, np.ndarray]:
    """torch ``Conv3d`` ``(O, I, 1, kh, kw)`` -> flax 2-D ``{kernel (HWIO), bias}``."""
    leaf = {"kernel": _np(sd[f"{key}.weight"])[:, :, 0].transpose(2, 3, 1, 0)}
    if f"{key}.bias" in sd:
        leaf["bias"] = _np(sd[f"{key}.bias"])
    return leaf


def _linear(sd, key) -> Dict[str, np.ndarray]:
    """torch ``Linear`` ``(out, in)`` -> flax ``Dense`` ``{kernel (in, out), bias}``."""
    leaf = {"kernel": _np(sd[f"{key}.weight"]).T}
    if f"{key}.bias" in sd:
        leaf["bias"] = _np(sd[f"{key}.bias"])
    return leaf


def _layernorm(sd, key) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[f"{key}.weight"]), "bias": _np(sd[f"{key}.bias"])}


def _spynet_params(state_dict) -> dict:
    """The SpyNet pyramid in any of the family's layouts, a ``params.``
    prefix stripped, level by level:

    * ``basic_module.{i}.basic_module.{2j}``: a Sequential with ReLUs
      between the convs (the VRT variant);
    * ``basic_module.{i}.basic_module.{j}.0``: ConvReLU (the reference's
      remap of the sintel checkpoint);
    * ``basic_module.{i}.basic_module.{j}.conv`` and ``.conv.0``: the
      mmedit sintel ConvModule forms.
    """
    sd = {k[len("params."):] if k.startswith("params.") else k: v
          for k, v in state_dict.items()}
    pat = re.compile(r"basic_module\.(\d)\.basic_module\.")
    levels = sorted({int(m.group(1)) for k in sd if (m := pat.match(k))})
    if not levels:
        raise ValueError("unrecognised SpyNet state dict layout")
    params: Dict[str, Any] = {}
    for i in levels:
        base = f"basic_module.{i}.basic_module"
        head = {}
        for j in range(5):
            candidates = (f"{base}.{2 * j}", f"{base}.{j}.0", f"{base}.{j}.conv",
                          f"{base}.{j}.conv.0")
            src = next((c for c in candidates if f"{c}.weight" in sd), None)
            if src is None:
                raise ValueError(f"unrecognised SpyNet layout at level {i} conv {j}; "
                                 f"tried {candidates}")
            head[f"conv_{j}"] = {"Conv_0": _conv(sd, src)}
        params[f"basic_module_{i}"] = head
    return params


def _sub_spynet(sd, prefix: str) -> dict:
    """The SpyNet keys under ``prefix``, without its ``mean`` / ``std`` buffers."""
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix) and not k.endswith(("mean", "std"))}


def load_torch_spynet(state_dict) -> dict:
    """A reference SpyNet state dict -> the port's ``SpyNet`` ``state_dict``."""
    return convert.spynet_state_dict(_spynet_params(state_dict))


def _realbasicvsr_params(state_dict) -> dict:
    sd = _strip_module(state_dict)

    def residual_block(prefix: str) -> dict:
        """conv head, then the ``res_block.{i}`` units stacked on a leading axis."""
        units = []
        while f"{prefix}.res_block.{len(units)}.conv1.weight" in sd:
            units.append([_conv(sd, f"{prefix}.res_block.{len(units)}.conv{j}") for j in (1, 2)])
        out = {"ConvLeaky_0": {"Conv2d_0": {"Conv_0": _conv(sd, f"{prefix}.conv.0")}}}
        if units:
            out["res_blocks"] = {
                f"Conv2d_{j}": {"Conv_0": {k: np.stack([u[j][k] for u in units])
                                           for k in ("kernel", "bias")}} for j in (0, 1)}
        return out

    bv: Dict[str, Any] = {
        "backward_resblocks": {"ResidualBlock_0": residual_block("basicvsr.backward_resblocks")},
        "forward_resblocks": {"ResidualBlock_0": residual_block("basicvsr.forward_resblocks")},
        "point_conv": {"Conv_0": _conv(sd, "basicvsr.point_conv.0")},
    }
    i = 0
    while f"basicvsr.upsample.{i}.upconv.weight" in sd:
        bv[f"upsample_{i}"] = {"Conv2d_0": {"Conv_0": _conv(sd, f"basicvsr.upsample.{i}.upconv")}}
        i += 1
    # conv_last: Sequential(conv 64, lrelu, conv 3)
    bv["conv_hr"] = {"Conv_0": _conv(sd, "basicvsr.conv_last.0")}
    bv["conv_last"] = {"Conv_0": _conv(sd, "basicvsr.conv_last.2")}
    spynet = _sub_spynet(sd, "basicvsr.spynet.")
    if spynet:
        bv["spynet"] = _spynet_params(spynet)
    cleaner = {"ResidualBlock_0": residual_block("cleaner.resblock"),
               "Conv2d_0": {"Conv_0": _conv(sd, "cleaner.conv")}}
    return {"cleaner": cleaner, "basicvsr": bv}


def load_torch_realbasicvsr(state_dict) -> dict:
    """A reference RealBasicVSR ``model_state_dict`` (``cleaner.{resblock,
    conv}``, ``basicvsr.{backward_resblocks, forward_resblocks, point_conv,
    upsample, conv_last, spynet}``) -> the port's ``RealBasicVSR``
    ``state_dict``."""
    return convert.realbasicvsr_state_dict(_realbasicvsr_params(state_dict))


def _vrt_params(state_dict, n_scale_stages: int) -> dict:
    sd = _strip_module(state_dict)

    def attention(prefix: str) -> dict:
        out = {"relative_position_bias_table": _np(sd[f"{prefix}.relative_position_bias_table"]),
               "qkv_self": _linear(sd, f"{prefix}.qkv_self"),
               "proj": _linear(sd, f"{prefix}.proj")}
        if f"{prefix}.qkv_mut.weight" in sd:
            out["qkv_mut"] = _linear(sd, f"{prefix}.qkv_mut")
        return out

    def mlp(prefix: str) -> dict:
        return {name: _linear(sd, f"{prefix}.{name}") for name in ("fc11", "fc12", "fc2")}

    def tmsag(prefix: str) -> dict:
        out, j = {}, 0
        while f"{prefix}.blocks.{j}.norm1.weight" in sd:
            block = f"{prefix}.blocks.{j}"
            out[f"block_{j}"] = {"norm1": _layernorm(sd, f"{block}.norm1"),
                                 "attn": attention(f"{block}.attn"),
                                 "norm2": _layernorm(sd, f"{block}.norm2"),
                                 "mlp": mlp(f"{block}.mlp")}
            j += 1
        return out

    def pa_deform(prefix: str) -> dict:
        out: Dict[str, Any] = {"weight": _np(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0),
                               "bias": _np(sd[f"{prefix}.bias"])}
        # the conv_offset Sequential's convs sit at torch indices 0, 2, 4, 6
        for ours, theirs in enumerate((0, 2, 4, 6)):
            leaf = _conv(sd, f"{prefix}.conv_offset.{theirs}")
            out[f"conv_offset_{ours}"] = {"Conv_0": leaf} if ours < 3 else leaf
        return out

    params: Dict[str, Any] = {}
    for i in range(1, n_scale_stages + 1):
        sp = f"stage{i}"
        stage: Dict[str, Any] = {"reshape_norm": _layernorm(sd, f"{sp}.reshape.1")}
        if f"{sp}.reshape.2.weight" in sd:  # down / up: LayerNorm at .1, Linear at .2
            stage["reshape_linear"] = _linear(sd, f"{sp}.reshape.2")
        stage["residual_group1"] = tmsag(f"{sp}.residual_group1")
        stage["residual_group2"] = tmsag(f"{sp}.residual_group2")
        stage["linear1"] = _linear(sd, f"{sp}.linear1")
        stage["linear2"] = _linear(sd, f"{sp}.linear2")
        stage["pa_deform"] = pa_deform(f"{sp}.pa_deform")
        stage["pa_fuse"] = mlp(f"{sp}.pa_fuse")
        params[sp] = stage

    # the trunk ModuleList: stage8 for VRT, stage6 for TinyVRT
    tp = f"stage{n_scale_stages + 1}"
    params["trunk_norm_in"] = _layernorm(sd, f"{tp}.0.1")
    params["trunk_linear_in"] = _linear(sd, f"{tp}.0.2")
    k = 1
    while f"{tp}.{k}.linear.weight" in sd:
        params[f"trunk_rtmsa_{n_scale_stages + k - 1}"] = {
            "residual_group": tmsag(f"{tp}.{k}.residual_group"),
            "linear": _linear(sd, f"{tp}.{k}.linear")}
        k += 1

    params["norm"] = _layernorm(sd, "norm")
    params["conv_after_body"] = _linear(sd, "conv_after_body")
    params["conv_first"] = {"Conv_0": _conv3d_133(sd, "conv_first")}
    params["conv_before_upsample"] = {"Conv_0": _conv3d_133(sd, "conv_before_upsample.0")}
    # the upsample ladder's convs at torch Sequential indices 0, 5, 10 (x4)
    up_idx = [i for i in range(0, 11, 5) if f"upsample.{i}.weight" in sd]
    for ours, theirs in enumerate(up_idx[:-1]):
        params[f"up_conv_{ours}"] = {"Conv_0": _conv3d_133(sd, f"upsample.{theirs}")}
    params["up_conv_out"] = {"Conv_0": _conv3d_133(sd, f"upsample.{up_idx[-1]}")}
    params["conv_last"] = {"Conv_0": _conv3d_133(sd, "conv_last")}
    spynet = _sub_spynet(sd, "optical_flow.")
    if spynet:
        params["optical_flow"] = _spynet_params(spynet)
    return params


def load_torch_vrt(state_dict, n_scale_stages: int) -> dict:
    """A reference VRT / TinyVRT state dict -> the port model's
    ``state_dict``. ``n_scale_stages`` is the number of U-shaped stages: 7
    for VRT (trunk ``stage8``), 5 for TinyVRT (trunk ``stage6``)."""
    return convert.vrt_state_dict(_vrt_params(state_dict, n_scale_stages))
