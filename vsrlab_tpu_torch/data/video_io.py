"""Video file read / write over OpenCV (port of ``vsrlab_tpu/data/video_io.py:29-158``).

Frames are float32 RGB ``(T, H, W, 3)`` in [0, 1]. Every function needs
OpenCV and raises ImportError where it is missing; the serving loop
(:func:`vsrlab_tpu_torch.evaluation.upscale.upscale_frames`) also takes
frames as arrays. Requested
H.264 codecs map onto mp4v, as in the JAX package. The compression helpers
(``compress_video*``) need the codec emulator and come with the
degradation slice.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # each function raises without it
    cv2 = None

_FOURCC = {"mp4v": "mp4v", "xvid": "XVID", "libx264": "mp4v", "h264": "mp4v"}


def _cv2():
    if cv2 is None:
        raise ImportError("video I/O needs OpenCV (cv2), which is not importable here")
    return cv2


def _open(path):
    cap = _cv2().VideoCapture(str(path))
    if not cap.isOpened():
        raise IOError(f"not a video: {path}")
    return cap


def _to_rgb(img: np.ndarray) -> np.ndarray:
    return img[..., ::-1].astype(np.float32) / 255.0


def read_video(path) -> Tuple[np.ndarray, str, float, int, int]:
    """Decode a video file: ``(frames (T, H, W, 3), codec, fps, height, width)``."""
    cap = _open(path)
    fps = cap.get(cv2.CAP_PROP_FPS)
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    fourcc = int(cap.get(cv2.CAP_PROP_FOURCC))
    codec = "".join(chr((fourcc >> (8 * i)) & 0xFF) for i in range(4)).strip()
    frames: List[np.ndarray] = []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        frames.append(_to_rgb(img))
    cap.release()
    return np.stack(frames), codec, fps, h, w


def video_frame_count(path) -> int:
    """Frame count from the container header (no decode)."""
    cap = _open(path)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return n


def read_video_window(path, start: int, count: int) -> np.ndarray:
    """Decode ``count`` frames from frame ``start`` (a container seek, so
    only the window is decoded). A seek past the last decodable frame (a
    header that over-reports) walks back toward 0; a short read at the end
    repeats the last frame."""
    cap = _open(path)
    try:
        s = int(start)
        while True:
            if s:
                cap.set(cv2.CAP_PROP_POS_FRAMES, s)
            frames: List[np.ndarray] = []
            for _ in range(count):
                ok, img = cap.read()
                if not ok:
                    break
                frames.append(_to_rgb(img))
            if frames or s == 0:
                break
            s //= 2
    finally:
        cap.release()
    if not frames:
        raise IOError(f"no decodable frames in {path}")
    frames += [frames[-1]] * (count - len(frames))
    return np.stack(frames)


class SequentialVideoReader:
    """Decode a video window by window from one open container (no seek):
    O(window) host memory for any length."""

    def __init__(self, path):
        self._cap = _open(path)
        self.fps = self._cap.get(cv2.CAP_PROP_FPS)
        self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))

    def read(self, count: int) -> np.ndarray:
        """The next ``count`` frames ``(k, H, W, 3)``; ``k < count`` at the
        end (possibly 0)."""
        frames: List[np.ndarray] = []
        for _ in range(count):
            ok, img = self._cap.read()
            if not ok:
                break
            frames.append(_to_rgb(img))
        if not frames:
            return np.zeros((0, self.height, self.width, 3), np.float32)
        return np.stack(frames)

    def close(self):
        self._cap.release()


def open_video_writer(path, width: int, height: int, codec: str = "mp4v",
                      fps: float = 24.0, crf: int = 23):
    """An encoder for frames appended as they are produced."""
    cv = _cv2()
    fourcc = cv.VideoWriter_fourcc(*_FOURCC.get(codec.lower(), "mp4v"))
    writer = cv.VideoWriter(str(path), fourcc, float(fps), (width, height))
    if not writer.isOpened():
        raise IOError(f"cannot open encoder for: {path}")
    writer.set(cv.VIDEOWRITER_PROP_QUALITY, max(1.0, 100.0 - crf * 2.0))
    return writer


def to_uint8(frames: np.ndarray) -> np.ndarray:
    """Float RGB in [0, 1] -> uint8 RGB, rounded to nearest."""
    return np.clip(np.rint(np.clip(frames, 0, 1) * 255), 0, 255).astype(np.uint8)


def write_frames(writer, frames: np.ndarray):
    """Append ``(T, H, W, 3)`` float RGB frames in [0, 1] to an open writer."""
    for f in to_uint8(frames):
        writer.write(f[..., ::-1])


def write_video(path, frames: np.ndarray, codec: str = "mp4v", fps: float = 24.0,
                crf: int = 23):
    """Encode ``(T, H, W, 3)`` float frames to a video file; ``crf`` maps to
    the encoder's quality."""
    _, h, w, _ = frames.shape
    writer = open_video_writer(path, w, h, codec, fps, crf)
    write_frames(writer, frames)
    writer.release()
