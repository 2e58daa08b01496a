"""Hydra-style YAML configs without hydra (port of ``vsrlab_tpu/core/config.py``).

The same user surface over the same ``conf/`` tree: config groups,
``+experiment=X`` overlays, ``a.b=v`` dotted overrides, ``${a.b}`` and
``${oc.env:VAR,default}`` interpolation, and ``_target_`` specs that
resolve through :data:`REGISTRY` (filled by
:mod:`vsrlab_tpu_torch.components`), an alias table for the reference's
torch target strings, or a dotted path inside ``vsrlab_tpu_torch``.

Reading YAML needs PyYAML; a :class:`Config` built in Python does not.
"""

from __future__ import annotations

import importlib
import os
import re
from pathlib import Path
from typing import Any, Callable, Dict, List, Sequence, Union


def _yaml():
    try:
        import yaml
    except ImportError as e:
        raise ImportError("reading YAML configs needs PyYAML (import yaml failed); build the "
                          "Config in Python with Config.from_dict instead") from e
    return yaml


class Config(dict):
    """dict with attribute access and deep merge / get / set by dotted path."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key, value):
        self[key] = value

    @staticmethod
    def _wrap(value):
        if isinstance(value, dict) and not isinstance(value, Config):
            return Config({k: Config._wrap(v) for k, v in value.items()})
        if isinstance(value, list):
            return [Config._wrap(v) for v in value]
        return value

    @classmethod
    def from_dict(cls, d: dict | None) -> "Config":
        return cls._wrap(d or {})

    def get_path(self, dotted: str, default=None):
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, dotted: str, value):
        parts = dotted.split(".")
        node = self
        for part in parts[:-1]:
            nxt = node.get(part)
            if not isinstance(nxt, dict):
                nxt = Config()
                node[part] = nxt
            node = nxt
        node[parts[-1]] = Config._wrap(value)

    def merge(self, other: dict) -> "Config":
        """Deep-merge ``other`` into self (other wins; lists replace)."""
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), dict):
                self[k].merge(v)
            else:
                self[k] = Config._wrap(v)
        return self

    def to_dict(self) -> dict:
        return {k: (v.to_dict() if isinstance(v, Config) else v) for k, v in self.items()}


_INTERP = re.compile(r"\$\{([^}]+)\}")


def _resolve_interpolations(root: Config) -> None:
    """Resolve ``${a.b.c}`` and ``${oc.env:VAR[,default]}`` in place."""

    def resolve_value(v, depth=0):
        if depth > 10:
            raise ValueError("interpolation cycle")
        if isinstance(v, str):
            m = _INTERP.fullmatch(v.strip())
            if m:  # a whole-string interpolation keeps the referent's type
                return resolve_ref(m.group(1), depth)
            return _INTERP.sub(lambda mm: str(resolve_ref(mm.group(1), depth)), v)
        return v

    def resolve_ref(expr: str, depth: int):
        expr = expr.strip()
        if expr.startswith("oc.env:"):
            name, _, default = expr[len("oc.env:"):].partition(",")
            val = os.environ.get(name.strip())
            if val is None:
                return _yaml().safe_load(default) if default else ""
            return val
        return resolve_value(root.get_path(expr), depth + 1)

    def walk(node):
        if isinstance(node, dict):
            for k in list(node.keys()):
                node[k] = walk(node[k])
            return node
        if isinstance(node, list):
            return [walk(v) for v in node]
        return resolve_value(node)

    walk(root)


def _load_yaml(path: Path) -> tuple[Config, bool]:
    """One YAML file: ``(config, is_global_package)``."""
    text = path.read_text()
    is_global = bool(re.search(r"^#\s*@package\s+_global_", text, re.M))
    return Config.from_dict(_yaml().safe_load(text) or {}), is_global


def _apply_defaults(cfg: Config, cfg_dir: Path):
    """Process a hydra-style ``defaults`` list: each ``{group: option}``
    loads ``<dir>/<group>/<option>.yaml`` into ``cfg[group]``, recursively;
    ``override /path: option`` entries are returned for the caller."""
    defaults = cfg.pop("defaults", None)
    if not defaults:
        return []
    overrides = []
    for entry in defaults:
        if isinstance(entry, str):
            continue  # _self_ and the like
        ((key, option),) = entry.items()
        if option is None:
            continue
        key = str(key)
        if key.startswith("override "):
            overrides.append((key[len("override "):].lstrip("/").replace("/", "."), option))
            continue
        group_path = cfg_dir / key.replace(".", "/")
        f = group_path / f"{option}.yaml"
        if not f.exists():
            raise FileNotFoundError(f"config group file not found: {f}")
        sub, is_global = _load_yaml(f)
        overrides.extend(_apply_defaults(sub, group_path))
        if is_global:
            cfg.merge(sub)
        else:
            existing = cfg.get_path(key.replace("/", "."))
            if isinstance(existing, Config):
                existing.merge(sub)
            else:
                cfg.set_path(key.replace("/", "."), sub)
    return overrides


def _load_group(config_dir: Path, path: str, option: str) -> Config:
    f = config_dir / path.replace(".", "/") / f"{option}.yaml"
    loaded, _ = _load_yaml(f)
    _apply_defaults(loaded, f.parent)
    return loaded


def load_config(config_dir: Union[str, Path, None] = None, name: str = "default",
                overrides: Sequence[str] = ()) -> Config:
    """Compose a config: root file, its ``defaults`` groups, experiment
    overlays (``+experiment=basic`` merges ``conf/experiment/basic.yaml``
    at the root), dotted overrides (``train.data.batch_size=4``, the value
    read as YAML), then interpolation. ``config_dir`` defaults to the
    repository's ``conf/``."""
    config_dir = Path(config_dir) if config_dir else Path(__file__).resolve().parents[2] / "conf"
    cfg, _ = _load_yaml(config_dir / f"{name}.yaml")
    group_overrides = _apply_defaults(cfg, config_dir)

    dotted: List[str] = []
    for ov in overrides:
        if ov.startswith("+experiment="):
            exp = ov.split("=", 1)[1]
            sub, _ = _load_yaml(config_dir / "experiment" / f"{exp}.yaml")
            for path, option in _apply_defaults(sub, config_dir):
                cfg.set_path(path, _load_group(config_dir, path, option))
            cfg.merge(sub)
            cfg.set_path("experiment", exp)
        else:
            dotted.append(ov)
    for path, option in group_overrides:
        cfg.set_path(path, _load_group(config_dir, path, option))
    for ov in dotted:
        if "=" not in ov:
            raise ValueError(f"bad override (expected key=value): {ov}")
        key, _, val = ov.partition("=")
        cfg.set_path(key.lstrip("+"), _yaml().safe_load(val))
    _resolve_interpolations(cfg)
    return cfg


REGISTRY: Dict[str, Callable] = {}

# the reference's `_target_` strings, accepted for config compatibility
ALIASES = {
    "vsrlab.vsr.models.RealBasicVSR.realbasicvsr.RealBasicVSR": "RealBasicVSR",
    "vsrlab.vsr.models.RealBasicVSR.modules.basicvsr.BasicVSR": "BasicVSR",
    "vsrlab.vsr.models.VRT.vrt.VRT": "VRT",
    "vsrlab.vsr.models.VRT.vrt.TinyVRT": "TinyVRT",
    "vsrlab.vsr.models.VRT.modules.spynet.SpyNet": "SpyNet",
    "vsrlab.vsr.dataset.DatasetVSR": "DatasetVSR",
    "vsrlab.vsr.dataset.ValDatasetVSR": "ValDatasetVSR",
    "vsrlab.core.metrics.MetricCollection": "MetricCollection",
    "torch.optim.Adam": "adam",
    "torch.optim.AdamW": "adamw",
    "torch.optim.lr_scheduler.CosineAnnealingLR": "cosine",
    "vsrlab.core.schedulers.CosineAnnealingLinearWarmup": "cosine_warmup",
}

# names the JAX package's configs use that a later slice of the port brings
NOT_PORTED: Dict[str, str] = {}


def register(name: str, fn: Callable = None):
    """Register a component under ``name`` (decorator or direct call)."""
    if fn is None:
        return lambda f: register(name, f)
    REGISTRY[name] = fn
    return fn


def resolve_target(target: str) -> Callable:
    name = ALIASES.get(target, target)
    if name in REGISTRY:
        return REGISTRY[name]
    if name in NOT_PORTED:
        raise KeyError(f"_target_ {target!r} is not ported to vsrlab_tpu_torch yet: "
                       f"{NOT_PORTED[name]}")
    if target.startswith("vsrlab_tpu_torch."):
        module, _, attr = target.rpartition(".")
        return getattr(importlib.import_module(module), attr)
    raise KeyError(f"unknown _target_ {target!r}: register it or use a vsrlab_tpu_torch path")


def instantiate(cfg: Union[Config, dict, None], /, **kwargs):
    """Build the component ``cfg['_target_']`` names, with the other keys
    (not starting with ``_``) and ``kwargs`` as arguments."""
    if cfg is None:
        return None
    cfg = dict(cfg)
    fn = resolve_target(cfg.pop("_target_"))
    args = {k: v for k, v in cfg.items() if not k.startswith("_")}
    args.update(kwargs)
    return fn(**args)
