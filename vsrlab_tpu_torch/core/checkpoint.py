"""Checkpoints as ``torch.save`` files (port of ``vsrlab_tpu/core/checkpoint.py``).

A checkpoint is one key (an epoch, or a global step in step-granular
runs) holding the model ``state_dict``, optionally the optimizer's state,
and any extra entries, in ``<dir>/<key>/checkpoint.pt``. Semantics follow
the JAX manager's: versioned keys, the newest ``max_to_keep`` kept,
``meta_<key>.json`` sidecars (step-granular resume) pruned with them and
cleared by a meta-less save of their key, and a config snapshot
(``config.json``) beside them for test-time reloads.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Optional, Tuple

import torch

_FILE = "checkpoint.pt"


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def save(self, epoch: int, params: Any, opt_state: Any = None, extra: Optional[dict] = None,
             config: Optional[dict] = None, meta: Optional[dict] = None):
        """Save ``params`` (a ``state_dict``), ``opt_state`` and ``extra``
        under key ``epoch``; ``meta`` (a small JSON dict) goes to the
        ``meta_<key>.json`` sidecar, ``config`` to the snapshot."""
        payload = {"params": params}
        if opt_state is not None:
            payload["opt_state"] = opt_state
        if extra:
            payload["extra"] = extra
        key_dir = self.directory / str(int(epoch))
        key_dir.mkdir(exist_ok=True)
        tmp = key_dir / f"{_FILE}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, key_dir / _FILE)  # a cut save never leaves a torn checkpoint
        sidecar = self.directory / f"meta_{epoch}.json"
        if meta is not None:
            sidecar.write_text(json.dumps(meta))
        else:
            # a meta-less save must not inherit a stale sidecar of a reused key
            sidecar.unlink(missing_ok=True)
        keys = self.all_keys()
        if self.max_to_keep:
            for key in keys[: -self.max_to_keep]:
                shutil.rmtree(self.directory / str(key))
            keys = keys[-self.max_to_keep:]
        live = set(keys)
        for p in self.directory.glob("meta_*.json"):
            stem = p.stem.split("_", 1)[1]
            if stem.isdigit() and int(stem) not in live:
                p.unlink(missing_ok=True)
        if config is not None:
            (self.directory / "config.json").write_text(json.dumps(config, indent=1))

    def load_meta(self, key: int) -> Optional[dict]:
        """The ``meta_<key>.json`` sidecar, or None if that save had none."""
        path = self.directory / f"meta_{key}.json"
        return json.loads(path.read_text()) if path.exists() else None

    def latest_epoch(self) -> Optional[int]:
        keys = self.all_keys()
        return keys[-1] if keys else None

    def all_keys(self) -> list:
        """All stored keys (epochs or global steps), ascending."""
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / _FILE).exists())

    def restore(self, epoch: Optional[int] = None, map_location="cpu") -> Tuple[int, dict]:
        """``(key, payload)`` of key ``epoch`` (the latest when None), its
        tensors on ``map_location``."""
        key = epoch if epoch is not None else self.latest_epoch()
        if key is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        path = self.directory / str(int(key)) / _FILE
        if not path.exists():
            raise FileNotFoundError(f"no checkpoint @ key {key} under {self.directory}")
        return int(key), torch.load(path, map_location=map_location, weights_only=True)

    def close(self):
        """Nothing to release: every save is complete when it returns."""


def load_config_snapshot(directory: str) -> dict:
    return json.loads((Path(directory) / "config.json").read_text())
