"""Degradation and geometric augmentations of host clips (port of
``vsrlab_tpu/data/augmentations.py``).

Every transform takes and returns a float32 clip ``(T, H, W, C)`` in
[0, 1] and draws its severity on each call from the
``numpy.random.Generator`` it is handed, in the JAX package's order, so
that one seed gives one clip in both packages. JPEG and Resize need
OpenCV and raise where it is missing (the JAX package returns the clip
untouched there); the JPEG round trip runs in the port's host library
(:mod:`vsrlab_tpu_torch.data.native`) where its OpenCV half is built.
Video compression is the codec emulator
(:mod:`vsrlab_tpu_torch.data.codec_emulator`), native where built.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

from vsrlab_tpu_torch.data import native
from vsrlab_tpu_torch.data.codec_emulator import crf_to_quality, dct_codec_roundtrip
from vsrlab_tpu_torch.data.video_io import _need_cv2, to_uint8


class RandomJPEGCompression:
    """JPEG encode / decode of every frame at one quality drawn per call
    from ``[quality[0], quality[1]]`` (or the one quality given)."""

    def __init__(self, quality: Sequence[int] = (30, 95)):
        self.quality = tuple(quality)

    def __call__(self, clip: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        cv = _need_cv2("RandomJPEGCompression")
        q = (int(rng.integers(self.quality[0], self.quality[1] + 1)) if len(self.quality) == 2
             else int(self.quality[0]))
        fast = native.jpeg_degrade(clip, q)
        if fast is not None:
            return fast
        out = []
        for frame in clip:
            ok, buf = cv.imencode(".jpg", to_uint8(frame)[..., ::-1], [cv.IMWRITE_JPEG_QUALITY, q])
            if not ok:
                raise RuntimeError(f"JPEG encode failed at quality {q}")
            out.append(cv.imdecode(buf, cv.IMREAD_COLOR)[..., ::-1].astype(np.float32) / 255.0)
        return np.stack(out)


class RandomVideoCompression:
    """Inter-frame codec degradation: a CRF and an fps drawn per call (each
    from ``[lo, hi]`` for two integers, else one of the values given); the
    fps sets the GOP (keyframe cadence, clipped to 4-32), the CRF the
    quantiser. ``codec`` is accepted for config compatibility: the emulator
    is one codec."""

    def __init__(self, codec: Sequence[str] = ("libx264",), crf: Sequence[int] = (18, 35),
                 fps: Sequence[int] = (10, 30)):
        self.codec, self.crf, self.fps = tuple(codec), tuple(crf), tuple(fps)

    @staticmethod
    def _sample(rng, choices):
        vals = tuple(choices)
        if len(vals) == 2 and all(isinstance(v, (int, np.integer)) for v in vals):
            return int(rng.integers(vals[0], vals[1] + 1))
        return vals[int(rng.integers(len(vals)))]

    def __call__(self, clip: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        crf = self._sample(rng, self.crf)
        gop = int(np.clip(self._sample(rng, self.fps), 4, 32))
        return dct_codec_roundtrip(clip, crf_to_quality(crf), gop=gop)


class RandomCrop:
    """A random spatial crop of the whole clip."""

    def __init__(self, size: int | Sequence[int]):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, clip: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        th, tw = self.size
        _, h, w, _ = clip.shape
        y = int(rng.integers(0, max(h - th, 0) + 1))
        x = int(rng.integers(0, max(w - tw, 0) + 1))
        return clip[:, y : y + th, x : x + tw]


class RandomFlip:
    """Random horizontal / vertical flip of the whole clip."""

    def __init__(self, horizontal: bool = True, vertical: bool = False, p: float = 0.5):
        self.horizontal, self.vertical, self.p = horizontal, vertical, p

    def __call__(self, clip: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if self.horizontal and rng.random() < self.p:
            clip = clip[:, :, ::-1]
        if self.vertical and rng.random() < self.p:
            clip = clip[:, ::-1]
        return np.ascontiguousarray(clip)


class Mirroring:
    """Temporal reflection: the clip followed by its reverse."""

    def __call__(self, clip: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        return np.concatenate([clip, clip[::-1]], axis=0)


class Resize:
    """Bicubic resize of every frame (OpenCV ``INTER_CUBIC``) to ``size``
    ``(h, w)`` or by ``scale``, clipped to [0, 1]."""

    def __init__(self, size: Sequence[int] | None = None, scale: float | None = None):
        self.size = tuple(size) if size else None
        self.scale = scale

    def __call__(self, clip: np.ndarray, rng=None) -> np.ndarray:
        cv = _need_cv2("Resize")
        _, h, w, _ = clip.shape
        th, tw = self.size or (int(round(h * self.scale)), int(round(w * self.scale)))
        out = [cv.resize(f, (tw, th), interpolation=cv.INTER_CUBIC) for f in clip]
        return np.clip(np.stack(out), 0.0, 1.0)


_AUG_REGISTRY = {
    "RandomJPEGCompression": RandomJPEGCompression,
    "RandomVideoCompression": RandomVideoCompression,
    "RandomCrop": RandomCrop,
    "RandomFlip": RandomFlip,
    "Mirroring": Mirroring,
    "Resize": Resize,
    # the reference's target strings, for config compatibility
    "vsrlab.core.augmentations.RandomJPEGCompression": RandomJPEGCompression,
    "vsrlab.core.augmentations.RandomVideoCompression": RandomVideoCompression,
    "vsrlab.core.augmentations.Mirroring": Mirroring,
}


def build_pipeline(specs: Optional[Sequence]) -> Optional[Callable]:
    """A list of ``{_target_: name, **kwargs}`` specs (or callables) ->
    ``pipeline(clip, rng)`` applying them in order; ``None`` for no specs. A
    dotted target resolves by its last component."""
    if not specs:
        return None
    stages: List[Callable] = []
    for spec in specs:
        if callable(spec):
            stages.append(spec)
            continue
        spec = dict(spec)
        target = spec.pop("_target_")
        cls = _AUG_REGISTRY.get(target) or _AUG_REGISTRY.get(target.rsplit(".", 1)[-1])
        if cls is None:
            raise KeyError(f"unknown augmentation {target!r}: one of {sorted(_AUG_REGISTRY)}")
        stages.append(cls(**{k: v for k, v in spec.items() if not k.startswith("_")}))

    def pipeline(clip: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        for stage in stages:
            clip = stage(clip, rng)
        return clip

    return pipeline
