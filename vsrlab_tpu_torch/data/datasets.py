"""VSR datasets (port of ``vsrlab_tpu/data/datasets.py``).

* :class:`DatasetVSR`: a directory of videos, each a folder of frames; a
  random ``seq``-frame window a sample; the HR pipeline, then LR from the
  LR pipeline applied to HR (which must downscale) or a bicubic /scale
  downscale; train / val split by fraction.
* :class:`ValDatasetVSR`: paired pre-made HR / LR folders, one window;
  each pipeline on its own side, both from one seed so that geometric
  draws stay aligned.
* :class:`SyntheticVSR`: procedural moving-pattern clips, deterministic
  per (seed, index), no disk; the LR pipeline degrades the bicubic LR.
* :class:`VideoDatasetVSR`: :class:`DatasetVSR` over video files, decoding
  only the sampled window.

Samples are ``(lr, hr)`` float32 numpy clips ``(T, H, W, C)`` in [0, 1].
The bicubic LR is OpenCV's ``INTER_CUBIC``: through the port's host
library (:func:`vsrlab_tpu_torch.data.native.bicubic_resize`) where its
OpenCV half is built, else :func:`~vsrlab_tpu_torch.ops.resize.bicubic_down`
in numpy (they agree to about 3e-7), so it is the same with or without
OpenCV. A clip's frames are decoded by the host library's threaded decode
where built, else one by one with OpenCV; the folder datasets raise
without either, as do the JPEG and Resize stages of a pipeline
(:mod:`vsrlab_tpu_torch.data.augmentations`).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from vsrlab_tpu_torch.data import native
from vsrlab_tpu_torch.data.augmentations import build_pipeline
from vsrlab_tpu_torch.data.video_io import _need_cv2, read_video_window, video_frame_count
from vsrlab_tpu_torch.ops.resize import bicubic_down


def load_frame(path) -> np.ndarray:
    """Decode one image file to float32 RGB ``(H, W, 3)`` in [0, 1]."""
    cv = _need_cv2("decoding frames")
    img = cv.imread(str(path), cv.IMREAD_COLOR)
    if img is None:
        raise IOError(f"cannot decode image: {path}")
    return img[..., ::-1].astype(np.float32) / 255.0


def load_clip(paths) -> np.ndarray:
    """Decode frame files to ``(T, H, W, 3)`` float32: the host library's
    threaded decode where built, OpenCV frame by frame otherwise."""
    clip = native.decode_clip(paths)
    if clip is not None:
        return clip
    return np.stack([load_frame(p) for p in paths])


def bicubic_lr(clip: np.ndarray, scale: int) -> np.ndarray:
    """The ``1/scale`` bicubic LR of ``(T, H, W, 3)``, clamped to [0, 1]."""
    t, h, w, _ = clip.shape
    out = native.bicubic_resize(clip, h // scale, w // scale)
    return out if out is not None else bicubic_down(clip, scale)


class DatasetVSR:
    """Folder-of-videos dataset; the window and its randomness are drawn
    from ``(seed, epoch, index)``."""

    def __init__(self, path: str, split: str = "train", seq: int = 6, train_size: float = 0.8,
                 scale: int = 4, hr_augmentation: Optional[Sequence] = None,
                 lr_augmentation: Optional[Sequence] = None, seed: int = 0, **_):
        self.videos = self._list_videos(path)
        split_point = int(len(self.videos) * train_size)
        if split == "train":
            self.videos = self.videos[:split_point]
        elif split == "val":
            self.videos = self.videos[split_point:]
        self.seq, self.scale, self.seed = seq, scale, seed
        self.hr_aug, self.lr_aug = build_pipeline(hr_augmentation), build_pipeline(lr_augmentation)
        self._epoch = 0

    def _list_videos(self, path):
        """One entry per video (a frame folder here)."""
        return sorted(p for p in Path(path).glob("*") if p.is_dir())

    def _read_window(self, index: int, rng: np.random.Generator) -> np.ndarray:
        """A random ``seq``-frame HR window of video ``index``."""
        frames = sorted(x for x in self.videos[index].glob("*") if x.is_file())
        start = int(rng.integers(0, max(len(frames) - self.seq, 0) + 1))
        return load_clip(frames[start : start + self.seq])

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self) -> int:
        return len(self.videos)

    def __getitem__(self, index: int):
        rng = np.random.default_rng((self.seed, self._epoch, index))
        hr = self._read_window(index, rng)
        if self.hr_aug:
            hr = self.hr_aug(hr, rng)
        # the LR pipeline degrades HR, so it has to downscale it too
        lr = self.lr_aug(hr, rng) if self.lr_aug else bicubic_lr(hr, self.scale)
        return lr, hr


class VideoDatasetVSR(DatasetVSR):
    """:class:`DatasetVSR` over a folder of video FILES: one file a video,
    and only the sampled window is decoded (a container seek,
    :func:`~vsrlab_tpu_torch.data.video_io.read_video_window`)."""

    EXTS = {".mp4", ".avi", ".mkv", ".mov", ".webm"}

    def __init__(self, *args, **kwargs):
        self._counts: dict = {}
        super().__init__(*args, **kwargs)

    def _list_videos(self, path):
        return sorted(p for p in Path(path).glob("*")
                      if p.is_file() and p.suffix.lower() in self.EXTS)

    def _read_window(self, index: int, rng: np.random.Generator) -> np.ndarray:
        path = self.videos[index]
        if path not in self._counts:
            self._counts[path] = video_frame_count(path)
        start = int(rng.integers(0, max(self._counts[path] - self.seq, 0) + 1))
        return read_video_window(path, start, self.seq)


class ValDatasetVSR:
    """Paired HR / LR folders; the same random window of both."""

    def __init__(self, path_hr: str, path_lr: str, seq: int = 6,
                 hr_augmentation: Optional[Sequence] = None,
                 lr_augmentation: Optional[Sequence] = None, seed: int = 0, **_):
        self.videos_hr = sorted(p for p in Path(path_hr).glob("*") if p.is_dir())
        self.videos_lr = sorted(p for p in Path(path_lr).glob("*") if p.is_dir())
        self.seq, self.seed = seq, seed
        self.hr_aug, self.lr_aug = build_pipeline(hr_augmentation), build_pipeline(lr_augmentation)
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
        # one seed for both sides: a random flip or crop must hit LR and HR alike
        seeds = (self.seed, self._epoch, index, 1)
        if self.hr_aug:
            hr = self.hr_aug(hr, np.random.default_rng(seeds))
        if self.lr_aug:
            lr = self.lr_aug(lr, np.random.default_rng(seeds))
        return lr, hr


class SyntheticVSR:
    """Procedural moving-gradient clips, deterministic per (seed, index);
    LR is a bicubic downscale of HR."""

    def __init__(self, num_videos: int = 32, seq: int = 6, height: int = 64, width: int = 64,
                 scale: int = 4, lr_augmentation: Optional[Sequence] = None, seed: int = 0,
                 split: str = "train", freq_max: float = 0.2, **_):
        self.n, self.seq, self.h, self.w, self.scale = num_videos, seq, height, width, scale
        self.lr_aug = build_pipeline(lr_augmentation)
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
        lr = bicubic_lr(hr, self.scale)
        if self.lr_aug:
            lr = self.lr_aug(lr, np.random.default_rng((self.seed, self._epoch, index)))
        return lr, hr
