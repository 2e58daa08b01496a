"""ctypes bindings of the port's host data core (``csrc/vsrio.cpp``; port of
``vsrlab_tpu/data/native.py``).

The C++ library does the host's hot work with a thread pool, straight into
preallocated numpy buffers: the codec emulator's round trip (plain C++,
always built) and, where OpenCV's headers were found at build time, the
threaded frame decode, the batch bicubic resize and the JPEG round trip.
It is built by :func:`vsrlab_tpu_torch.build.load_host` at first use,
never at import: with its OpenCV half where OpenCV's headers are found.
Every entry point returns None where the library could not be built (a
warning says why), or was built without the OpenCV half it needs: the
caller then takes its python path. :func:`counts` says how many calls of
each entry point took the native path and how many did not.
"""

from __future__ import annotations

import collections
import ctypes
import threading
import warnings
from typing import Dict, Optional, Sequence

import numpy as np

_lib: Optional[ctypes.CDLL] = None
_tried = False
_load_lock = threading.Lock()
_counts_lock = threading.Lock()
_counts: Dict[str, collections.Counter] = collections.defaultdict(collections.Counter)

_F = ctypes.POINTER(ctypes.c_float)
_I = ctypes.c_int
_SIGNATURES = {
    "vsrio_codec_degrade": (None, [_F, _I, _I, _I, ctypes.c_float, _I, _I, _F, _I]),
    "vsrio_decode_clip": (_I, [ctypes.POINTER(ctypes.c_char_p), _I, _F, _I, _I, _I]),
    "vsrio_bicubic_resize": (None, [_F, _I, _I, _I, _F, _I, _I, _I]),
    "vsrio_jpeg_degrade": (None, [_F, _I, _I, _I, _I, _F, _I]),
}


def _load() -> Optional[ctypes.CDLL]:
    """The library, built and loaded once under a lock (a loader's worker
    threads may ask at once); None where it cannot be built."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _load_lock:
        if _lib is not None or _tried:  # another thread won the race
            return _lib
        _tried = True
        from vsrlab_tpu_torch.build import load_host

        try:
            lib = load_host("vsrio").lib
        except (RuntimeError, OSError) as e:
            warnings.warn(f"the host data core is not built, its callers take the python "
                          f"paths: {e}", RuntimeWarning, stacklevel=2)
            return None
        for name, (restype, argtypes) in _SIGNATURES.items():
            if hasattr(lib, name):  # the OpenCV entry points only where built
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
        return _lib


def _entry(name: str):
    """``vsrio_<name>`` where built, else None; counts the call either way."""
    lib = _load()
    fn = getattr(lib, f"vsrio_{name}", None) if lib is not None else None
    with _counts_lock:  # the loaders' worker threads count at once
        _counts[name]["native" if fn is not None else "python"] += 1
    return fn


def available() -> bool:
    return _load() is not None


def has_opencv() -> bool:
    """Whether the library's OpenCV half (decode, resize, JPEG) was built."""
    lib = _load()
    return lib is not None and hasattr(lib, "vsrio_decode_clip")


def counts() -> Dict[str, Dict[str, int]]:
    """Per entry point, the calls that took the native path and those that
    returned None (``{"codec_degrade": {"native": n, "python": m}, ...}``)."""
    with _counts_lock:
        return {k: {"native": v["native"], "python": v["python"]} for k, v in _counts.items()}


def reset_counts() -> None:
    with _counts_lock:
        _counts.clear()


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_F)


def decode_clip(paths: Sequence, height: int = 0, width: int = 0,
                threads: int = 8) -> Optional[np.ndarray]:
    """Decode image files into ``(T, H, W, 3)`` float32 RGB in one native call
    (``height`` / ``width`` 0: the first frame's size, which every frame must
    have). None where the OpenCV half is not built; raises on a failed
    decode."""
    fn = _entry("decode_clip")
    if fn is None:
        return None
    n = len(paths)
    if height <= 0 or width <= 0:
        import cv2

        probe = cv2.imread(str(paths[0]), cv2.IMREAD_COLOR)
        if probe is None:
            raise IOError(f"cannot decode image: {paths[0]}")
        height, width = probe.shape[:2]
    out = np.empty((n, height, width, 3), np.float32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    rc = fn(arr, n, _fptr(out), height, width, threads)
    if rc:
        raise IOError(f"cannot decode image: {paths[rc - 1]}")
    return out


def bicubic_resize(clip: np.ndarray, out_h: int, out_w: int,
                   threads: int = 8) -> Optional[np.ndarray]:
    """``(T, H, W, 3)`` float32 -> ``(T, out_h, out_w, 3)`` by OpenCV's
    ``INTER_CUBIC``, clamped to [0, 1]; None where not built."""
    fn = _entry("bicubic_resize")
    if fn is None:
        return None
    clip = np.ascontiguousarray(clip, np.float32)
    t, h, w, _ = clip.shape
    out = np.empty((t, out_h, out_w, 3), np.float32)
    fn(_fptr(clip), t, h, w, _fptr(out), out_h, out_w, threads)
    return out


def jpeg_degrade(clip: np.ndarray, quality: int, threads: int = 8) -> Optional[np.ndarray]:
    """JPEG round trip of every frame of a ``(T, H, W, 3)`` float32 clip at
    ``quality``; None where not built."""
    fn = _entry("jpeg_degrade")
    if fn is None:
        return None
    clip = np.ascontiguousarray(np.clip(clip, 0.0, 1.0), np.float32)
    t, h, w, _ = clip.shape
    out = np.empty_like(clip)
    fn(_fptr(clip), t, h, w, int(quality), _fptr(out), threads)
    return out


def codec_degrade(clip: np.ndarray, quality: float, gop: int = 8,
                  subsample_chroma: bool = True, threads: int = 4) -> Optional[np.ndarray]:
    """The codec emulator's round trip (the native form of
    :func:`vsrlab_tpu_torch.data.codec_emulator.dct_codec_roundtrip`); None
    where the library is not built."""
    fn = _entry("codec_degrade")
    if fn is None:
        return None
    clip = np.ascontiguousarray(clip, np.float32)
    t, h, w, _ = clip.shape
    out = np.empty_like(clip)
    fn(_fptr(clip), t, h, w, float(quality), max(1, int(gop)), 1 if subsample_chroma else 0,
       _fptr(out), threads)
    return out
