"""Experiment logging (port of ``vsrlab_tpu/core/loggers.py:33-136, 205-214``).

:class:`JsonlLogger` writes scalars to ``<save_dir>/<project>/<id>/metrics.jsonl``
and image grids (frames, or flows as :func:`flow_to_image` colours them) to
PNGs under ``media/`` (with OpenCV; without it the grids are skipped). :func:`build_logger` gives it for ``backend: auto``
and ``jsonl``; the wandb backend is not ported.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np


def flow_to_image(flow: np.ndarray) -> np.ndarray:
    """A ``(H, W, 2)`` flow as an RGB uint8 image on the HSV wheel: hue the
    direction, value the magnitude over the largest (OpenCV's HSV -> RGB;
    without OpenCV the grey value image)."""
    dx, dy = flow[..., 0], flow[..., 1]
    mag = np.sqrt(dx * dx + dy * dy)
    ang = (np.arctan2(dy, dx) + np.pi) / (2 * np.pi)
    maxmag = max(float(mag.max()), 1e-6)
    hsv = np.stack([ang * 179.0, np.full_like(ang, 255.0),
                    np.clip(mag / maxmag, 0, 1) * 255.0], axis=-1).astype(np.uint8)
    try:
        import cv2
    except ImportError:  # no OpenCV: the value channel as grey
        return np.repeat(hsv[..., 2:3], 3, axis=-1)
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)


def _make_grid(frames: np.ndarray, nrow: int = 8, pad: int = 2) -> np.ndarray:
    """``(N, H, W, C)`` float [0, 1] -> one ``(gh, gw, C)`` uint8 grid image."""
    n, h, w, c = frames.shape
    if n == 0:
        return np.zeros((pad * 2, pad * 2, c), np.uint8)
    ncol = min(nrow, n)
    nrows = (n + ncol - 1) // ncol
    grid = np.zeros((nrows * (h + pad) + pad, ncol * (w + pad) + pad, c), np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        y, x = pad + r * (h + pad), pad + col * (w + pad)
        grid[y : y + h, x : x + w] = frames[i]
    return np.clip(np.rint(grid * 255.0), 0, 255).astype(np.uint8)


class JsonlLogger:
    """Local logger: scalars to ``metrics.jsonl``, images to ``media/*.png``."""

    def __init__(self, save_dir: str = "./logs", project: str = "vsrlab_tpu",
                 id: Optional[str] = None, name: Optional[str] = None, tags=None, **_):
        self.dir = Path(save_dir) / project / (id or "run")
        (self.dir / "media").mkdir(parents=True, exist_ok=True)
        self._f = open(self.dir / "metrics.jsonl", "a")
        self.name = name
        self._log_raw({"event": "init", "project": project, "id": id, "name": name,
                       "tags": tags})

    def _log_raw(self, record: dict):
        record.setdefault("ts", time.time())
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def log_dict(self, metrics: Dict[str, float], epoch: int, stage: str = "Train"):
        record = {f"{k}/{stage}": float(v) for k, v in metrics.items()}
        record["epoch"] = epoch
        self._log_raw(record)

    def log_images(self, epoch: int, stage: str = "Val", **clips):
        """``clips``: name -> ``(B, T, H, W, C)`` or ``(N, H, W, C)`` float
        arrays, each written as one grid."""
        try:
            import cv2
        except ImportError:  # no OpenCV: no grids
            return
        for key, clip in clips.items():
            if clip is None:
                continue
            arr = np.asarray(clip, np.float32)
            if arr.ndim == 5:
                arr = arr.reshape((-1,) + arr.shape[2:])
            cv2.imwrite(str(self.dir / "media" / f"{key}_{stage}_{epoch}.png"),
                        _make_grid(arr)[..., ::-1])

    def log_flow(self, epoch: int, stage: str = "Train", **flows):
        """``flows``: name -> ``(N, H, W, 2)`` or ``(B, T, H, W, 2)`` flows,
        each written as one grid of :func:`flow_to_image` images."""
        try:
            import cv2
        except ImportError:  # no OpenCV: no grids
            return
        for key, flow in flows.items():
            if flow is None:
                continue
            arr = np.asarray(flow, np.float32)
            if arr.ndim == 5:
                arr = arr.reshape((-1,) + arr.shape[2:])
            imgs = np.stack([flow_to_image(f) for f in arr]).astype(np.float32) / 255.0
            cv2.imwrite(str(self.dir / "media" / f"{key}_{stage}_{epoch}.png"),
                        _make_grid(imgs)[..., ::-1])

    def save(self, path: str):
        """Note a checkpoint artifact."""
        self._log_raw({"event": "artifact", "path": str(path)})

    def close(self):
        self._log_raw({"event": "close"})
        self._f.close()


def build_logger(cfg: Optional[dict]) -> Optional[JsonlLogger]:
    """The configured logger: ``backend: auto`` or ``jsonl`` gives a
    :class:`JsonlLogger`; ``wandb`` raises (not ported)."""
    if cfg is None:
        return None
    kw = {k: v for k, v in dict(cfg).items() if not k.startswith("_")}
    backend = kw.pop("backend", "auto")
    if backend not in ("auto", "jsonl"):
        raise NotImplementedError(f"logger backend {backend!r} is not ported to "
                                  "vsrlab_tpu_torch (jsonl only)")
    return JsonlLogger(**kw)
