"""Optical-flow training data: teacher-flow datasets and joint transforms
(port of ``vsrlab_tpu/data/flow_dataset.py``).

* :class:`FlowDataset`: teacher-flow files named
  ``<video>_<frame1>_<frame2>.<ext>``, the frame pair resolved from the
  name under ``frames_root/<video>/``; one geometric transform moves the
  frames and the flow together, codec compression touches the frames only.
* Joint transforms on ``(frames (2, H, W, 3), flow (H, W, 2))`` numpy
  arrays, each drawing from the ``numpy.random.Generator`` it is handed in
  the JAX package's order. As in the reference, a geometric transform
  moves the flow FIELD and leaves its VECTORS as they are (a flip does not
  negate them, a rotation does not turn them).
* :class:`SyntheticFlowDataset`: pairs with an exact integer shift as
  ground truth, so the trainer runs with no data on disk.

Resize, rotation, the synthetic pairs' blur and frame decoding go through
OpenCV and raise where it is missing.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from vsrlab_tpu_torch.data.augmentations import RandomVideoCompression
from vsrlab_tpu_torch.data.datasets import load_frame
from vsrlab_tpu_torch.data.video_io import _need_cv2


class FlowCompose:
    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, frames, flow, rng):
        for t in self.transforms:
            frames, flow = t(frames, flow, rng)
        return frames, flow


class FlowResize:
    """Bilinear resize (OpenCV) of the frames and of the flow field; the
    flow values are not rescaled."""

    def __init__(self, height: int, width: int):
        self.size = (height, width)

    def __call__(self, frames, flow, rng):
        cv = _need_cv2("FlowResize")
        h, w = self.size
        frames = np.stack([cv.resize(f, (w, h), interpolation=cv.INTER_LINEAR) for f in frames])
        return frames, cv.resize(flow, (w, h), interpolation=cv.INTER_LINEAR)


class FlowRandomRotation:
    """With probability ``p``, a rotation by an integer angle drawn from
    ``[-minmax, minmax]`` (or the pair given) about the centre."""

    def __init__(self, minmax, p: float = 0.5):
        self.minmax = (-minmax, minmax) if isinstance(minmax, int) else tuple(minmax)
        self.p = p

    def __call__(self, frames, flow, rng):
        if rng.random() > 1 - self.p:
            cv = _need_cv2("FlowRandomRotation")
            angle = float(rng.integers(self.minmax[0], self.minmax[1] + 1))
            h, w = frames.shape[1:3]
            m = cv.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
            frames = np.stack([cv.warpAffine(f, m, (w, h)) for f in frames])
            flow = cv.warpAffine(flow, m, (w, h))
        return frames, flow


class FlowRandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, frames, flow, rng):
        if rng.random() > 1 - self.p:
            frames = np.ascontiguousarray(frames[:, :, ::-1])
            flow = np.ascontiguousarray(flow[:, ::-1])
        return frames, flow


class FlowRandomVerticalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, frames, flow, rng):
        if rng.random() > 1 - self.p:
            frames = np.ascontiguousarray(frames[:, ::-1])
            flow = np.ascontiguousarray(flow[::-1])
        return frames, flow


class FlowVideoCompression:
    """The codec emulator's round trip on the frames only."""

    def __init__(self, codec=("libx264",), crf=(34, 34), fps=(12, 12)):
        self.inner = RandomVideoCompression(codec, crf, fps)

    def __call__(self, frames, flow, rng):
        return self.inner(frames, rng), flow


def load_flow_file(path) -> np.ndarray:
    """A teacher flow ``(H, W, 2)`` float32 from ``.npz`` (key ``flow``),
    ``.npy`` or a torch ``.pt`` / ``.pth`` tensor (``(2, H, W)`` is moved to
    channels-last)."""
    path = Path(path)
    if path.suffix == ".npz":
        return np.load(path)["flow"].astype(np.float32)
    if path.suffix == ".npy":
        return np.load(path).astype(np.float32)
    if path.suffix in (".pt", ".pth"):
        import torch

        t = torch.load(path, map_location="cpu", weights_only=True)
        arr = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        if arr.ndim == 3 and arr.shape[0] == 2:
            arr = arr.transpose(1, 2, 0)
        return arr.astype(np.float32)
    raise ValueError(f"unknown flow file type: {path}")


class FlowDataset:
    """Teacher-flow dataset: ``(frame1, frame2, flow)`` float32 numpy,
    channels-last; the first ``size`` share of the sorted files is the train
    split, the rest val. Item ``i``'s draws come from ``(seed, epoch, i)``."""

    def __init__(self, path: str, frames_root: str, split: str = "train", size: float = 0.9,
                 augmentation: Optional[Callable] = None, compression: Optional[Callable] = None,
                 seed: int = 0):
        self.items = sorted(Path(path).glob("*"))
        split_point = int(len(self.items) * size)
        if split == "train":
            self.items = self.items[:split_point]
        elif split == "val":
            self.items = self.items[split_point:]
        self.frames_root = Path(frames_root)
        self.augmentation, self.compression = augmentation, compression
        self.seed, self._epoch = seed, 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self):
        return len(self.items)

    def _resolve(self, flow_path: Path) -> Tuple[Path, Path]:
        parts = flow_path.stem.split("_")
        video = self.frames_root / "_".join(parts[:-2])
        f1 = next(iter(video.glob(f"{parts[-2]}.*")))
        f2 = next(iter(video.glob(f"{Path(parts[-1]).stem}.*")))
        return f1, f2

    def __getitem__(self, idx: int):
        rng = np.random.default_rng((self.seed, self._epoch, idx))
        flow = load_flow_file(self.items[idx])
        p1, p2 = self._resolve(self.items[idx])
        frames = np.stack([load_frame(p1), load_frame(p2)])
        if self.augmentation:
            frames, flow = self.augmentation(frames, flow, rng)
        if self.compression:
            frames, flow = self.compression(frames, flow, rng)
        return frames[0], frames[1], flow


class SyntheticFlowDataset:
    """``(frame1, frame2, flow)`` with exact ground truth: frame 2 is frame
    1 (blurred uniform noise) shifted by an integer ``(dx, dy)`` drawn per
    sample, so ``frame2[p + flow] == frame1[p]`` away from the border. The
    val split draws from ``seed + 5000``."""

    def __init__(self, num_samples: int = 32, height: int = 48, width: int = 64,
                 max_shift: int = 3, augmentation: Optional[Callable] = None,
                 compression: Optional[Callable] = None, split: str = "train", seed: int = 0,
                 **_):
        self.n = num_samples
        self.h, self.w = height, width
        self.max_shift = max_shift
        self.augmentation, self.compression = augmentation, compression
        self.seed = seed + (5000 if split == "val" else 0)
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self):
        return self.n

    def __getitem__(self, idx: int):
        cv = _need_cv2("SyntheticFlowDataset")
        rng = np.random.default_rng((self.seed, idx))
        pad = self.max_shift
        big = rng.random((self.h + 2 * pad, self.w + 2 * pad, 3)).astype(np.float32)
        big = cv.GaussianBlur(big, (0, 0), 1.5)
        dx = int(rng.integers(-self.max_shift, self.max_shift + 1))
        dy = int(rng.integers(-self.max_shift, self.max_shift + 1))
        f1 = big[pad:pad + self.h, pad:pad + self.w]
        f2 = big[pad - dy:pad - dy + self.h, pad - dx:pad - dx + self.w]
        flow = np.full((self.h, self.w, 2), (dx, dy), np.float32)
        frames = np.stack([f1, f2])
        rng2 = np.random.default_rng((self.seed, self._epoch, idx))
        if self.augmentation:
            frames, flow = self.augmentation(frames, flow, rng2)
        if self.compression:
            frames, flow = self.compression(frames, flow, rng2)
        return frames[0], frames[1], flow
