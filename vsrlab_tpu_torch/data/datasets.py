"""VSR datasets (port of ``vsrlab_tpu/data/datasets.py:53-120, 222-287``).

* :class:`DatasetVSR`: a directory of videos, each a folder of frames; a
  random ``seq``-frame window a sample; LR is a bicubic /scale downscale;
  train / val split by fraction.
* :class:`ValDatasetVSR`: paired pre-made HR / LR folders, one window.
* :class:`SyntheticVSR`: procedural moving-pattern clips, deterministic
  per (seed, index), no disk.

Samples are ``(lr, hr)`` float32 numpy clips ``(T, H, W, C)`` in [0, 1].
Frames are decoded and downscaled with OpenCV where it is importable. The
JAX package tries its native C++ library first; a native data library for
the port is later work, so a LR clip here can differ from the JAX one in
the last bits. Without OpenCV, :class:`SyntheticVSR` takes the box mean
over ``scale x scale`` blocks (as the JAX one does without it) and the
folder datasets, which must decode image files, raise. Degradation
pipelines are not ported yet: only ``None`` is accepted.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

try:
    import cv2
except ImportError:  # the card's machine has no OpenCV
    cv2 = None


def build_pipeline(specs: Optional[Sequence]):
    """``None`` (no augmentation); any augmentation raises: the degradation
    pipeline is not ported yet."""
    if specs:
        raise NotImplementedError("augmentation pipelines (JPEG / video-codec degradation, "
                                  "crops, flips) are not ported to vsrlab_tpu_torch yet")
    return None


def _need_cv2(what: str):
    if cv2 is None:
        raise ImportError(f"{what} needs OpenCV (cv2), which is not importable here")
    return cv2


def load_frame(path) -> np.ndarray:
    """Decode one image file to float32 RGB ``(H, W, 3)`` in [0, 1]."""
    img = _need_cv2("decoding frames").imread(str(path), cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"cannot decode image: {path}")
    return img[..., ::-1].astype(np.float32) / 255.0


def load_clip(paths) -> np.ndarray:
    """Decode frame files to ``(T, H, W, 3)`` float32."""
    return np.stack([load_frame(p) for p in paths])


def _bicubic_down(clip: np.ndarray, scale: int) -> np.ndarray:
    """Bicubic /scale of ``(T, H, W, C)`` (OpenCV ``INTER_CUBIC``), clipped to [0, 1]."""
    t, h, w, c = clip.shape
    resize = _need_cv2("the bicubic downscale").resize
    frames = [resize(f, (w // scale, h // scale), interpolation=cv2.INTER_CUBIC) for f in clip]
    return np.clip(np.stack(frames), 0.0, 1.0)


class DatasetVSR:
    """Folder-of-videos dataset; the window and its randomness are drawn
    from ``(seed, epoch, index)``."""

    def __init__(self, path: str, split: str = "train", seq: int = 6, train_size: float = 0.8,
                 scale: int = 4, hr_augmentation: Optional[Sequence] = None,
                 lr_augmentation: Optional[Sequence] = None, seed: int = 0, **_):
        self.videos = sorted(p for p in Path(path).glob("*") if p.is_dir())
        split_point = int(len(self.videos) * train_size)
        if split == "train":
            self.videos = self.videos[:split_point]
        elif split == "val":
            self.videos = self.videos[split_point:]
        self.seq, self.scale, self.seed = seq, scale, seed
        build_pipeline(hr_augmentation), build_pipeline(lr_augmentation)
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self) -> int:
        return len(self.videos)

    def __getitem__(self, index: int):
        rng = np.random.default_rng((self.seed, self._epoch, index))
        frames = sorted(x for x in self.videos[index].glob("*") if x.is_file())
        start = int(rng.integers(0, max(len(frames) - self.seq, 0) + 1))
        hr = load_clip(frames[start : start + self.seq])
        return _bicubic_down(hr, self.scale), hr


class ValDatasetVSR:
    """Paired HR / LR folders; the same random window of both."""

    def __init__(self, path_hr: str, path_lr: str, seq: int = 6,
                 hr_augmentation: Optional[Sequence] = None,
                 lr_augmentation: Optional[Sequence] = None, seed: int = 0, **_):
        self.videos_hr = sorted(p for p in Path(path_hr).glob("*") if p.is_dir())
        self.videos_lr = sorted(p for p in Path(path_lr).glob("*") if p.is_dir())
        self.seq, self.seed = seq, seed
        build_pipeline(hr_augmentation), build_pipeline(lr_augmentation)
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self) -> int:
        return len(self.videos_hr)

    def __getitem__(self, index: int):
        rng = np.random.default_rng((self.seed, self._epoch, index))
        hr_frames = sorted(x for x in self.videos_hr[index].glob("*") if x.is_file())
        lr_frames = sorted(x for x in self.videos_lr[index].glob("*") if x.is_file())
        start = int(rng.integers(0, max(len(hr_frames) - self.seq, 0) + 1))
        hr = load_clip(hr_frames[start : start + self.seq])
        lr = load_clip(lr_frames[start : start + self.seq])
        return lr, hr


class SyntheticVSR:
    """Procedural moving-gradient clips, deterministic per (seed, index);
    LR is a bicubic downscale of HR (the box mean without OpenCV)."""

    def __init__(self, num_videos: int = 32, seq: int = 6, height: int = 64, width: int = 64,
                 scale: int = 4, lr_augmentation: Optional[Sequence] = None, seed: int = 0,
                 split: str = "train", freq_max: float = 0.2, **_):
        self.n, self.seq, self.h, self.w, self.scale = num_videos, seq, height, width, scale
        build_pipeline(lr_augmentation)
        self.seed = seed + (1000 if split == "val" else 0)
        # 0.2 exceeds the 4x LR Nyquist (0.125): some clips carry aliased
        # gratings, fine for smoke runs; band-limit (0.11) to make SR learnable
        self.freq_max = freq_max
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, index: int):
        rng = np.random.default_rng((self.seed, index))
        t, h, w = self.seq, self.h, self.w
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        fx, fy = rng.uniform(0.02, self.freq_max, 2)
        phase = rng.uniform(0, 2 * np.pi, 3)
        vx, vy = rng.uniform(-2, 2, 2)
        frames = []
        for i in range(t):
            base = np.stack([np.sin(2 * np.pi * (fx * (xx + vx * i)) + phase[c])
                             * np.cos(2 * np.pi * (fy * (yy + vy * i)) + phase[2 - c])
                             for c in range(3)], axis=-1)
            frames.append((base * 0.5 + 0.5).astype(np.float32))
        hr = np.stack(frames)
        if cv2 is not None:
            lr = _bicubic_down(hr, self.scale)
        else:
            s = self.scale
            lr = hr.reshape(t, h // s, s, w // s, s, 3).mean((2, 4))
        return lr, hr
