"""The port's host data core (``vsrlab_tpu_torch/csrc/vsrio.cpp`` through
``vsrlab_tpu_torch.data.native``) on the CPU.

* The codec emulator's native round trip against the port's numpy path
  (``force_numpy=True``) at the JAX package's three ``(quality, gop,
  subsample)`` settings on a smooth ``(5, 21, 35, 3)`` clip, atol 1e-5
  (``tests/test_codec_emulator.py:92``'s tolerance), and against the JAX
  package's ``native.codec_degrade`` on the same clip, atol 1e-5.
* Where the OpenCV half is built (the ``opencv4`` headers here):
  ``decode_clip``, ``bicubic_resize`` and ``jpeg_degrade`` against
  OpenCV in python within ``tests/test_native.py``'s tolerances (1e-6,
  1e-6, 1e-2); a failed decode raises; a frame of another size fails the
  native-size mode.
* The build: keyed on the source and flags under ``build/host``, the
  variant without OpenCV holds the codec alone; the path counters; the
  python paths where the library is switched off.
"""

import numpy as np
import pytest

pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from vsrlab_tpu.data import native as jnative  # noqa: E402
from vsrlab_tpu_torch import build  # noqa: E402
from vsrlab_tpu_torch.data import augmentations, codec_emulator, datasets, native  # noqa: E402
from vsrlab_tpu_torch.ops.resize import bicubic_down  # noqa: E402

CODEC_TOL = 1e-5
SETTINGS = [(30.0, 4, True), (85.0, 8, False), (5.0, 2, True)]
needs_opencv = pytest.mark.skipif(not native.has_opencv(),
                                  reason="the library's OpenCV half is not built here")


def _clip(seed=0, t=5, h=21, w=35):
    """Smooth content (pure noise defeats any codec), as the JAX test's."""
    rng = np.random.default_rng(seed)
    base = rng.random((t, h // 4, w // 4, 3)).astype(np.float32)
    return np.stack([cv2.resize(f, (w, h), interpolation=cv2.INTER_CUBIC)
                     for f in base]).clip(0, 1)


def _frames(tmp_path, n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        p = tmp_path / f"{i}.png"
        cv2.imwrite(str(p), (rng.random((h, w, 3)) * 255).astype(np.uint8))
        paths.append(p)
    return paths


def test_the_library_builds():
    assert native.available()
    lib = build.load_host("vsrio")
    assert lib is build.load_host("vsrio")  # loaded once a process
    assert lib.path.parent == build.HOST_BUILD_DIR and lib.path.name.startswith("libvsrio-")
    assert hasattr(lib.lib, "vsrio_codec_degrade")


@pytest.mark.parametrize("quality,gop,subsample", SETTINGS)
def test_codec_matches_numpy_path(quality, gop, subsample):
    clip = _clip()
    native.reset_counts()
    got = codec_emulator.dct_codec_roundtrip(clip, quality, gop, subsample)
    assert native.counts()["codec_degrade"] == {"native": 1, "python": 0}
    want = codec_emulator.dct_codec_roundtrip(clip, quality, gop, subsample, force_numpy=True)
    assert native.counts()["codec_degrade"] == {"native": 1, "python": 0}
    assert got.shape == clip.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=CODEC_TOL, rtol=0)
    assert np.abs(got - clip).mean() > 1e-4  # it degrades


@pytest.mark.parametrize("quality,gop,subsample", SETTINGS)
def test_codec_matches_jax_native(quality, gop, subsample):
    clip = _clip(1)
    want = jnative.codec_degrade(clip, quality, gop, subsample)
    if want is None:
        pytest.skip("the JAX package's native library is not built")
    np.testing.assert_allclose(native.codec_degrade(clip, quality, gop, subsample), want,
                               atol=CODEC_TOL, rtol=0)


def test_codec_clamps_gop_zero():
    clip = _clip(2, t=3)
    np.testing.assert_allclose(native.codec_degrade(clip, 50.0, 0),
                               codec_emulator.dct_codec_roundtrip(clip, 50.0, 1, force_numpy=True),
                               atol=CODEC_TOL, rtol=0)


def test_without_opencv_the_library_holds_the_codec(monkeypatch):
    """The build without the OpenCV flags (what a host without its headers
    gets): the codec, none of the OpenCV entry points, another file."""
    monkeypatch.setattr(build, "opencv_include", lambda: None)
    lib = build._load_host.__wrapped__("vsrio")
    assert hasattr(lib.lib, "vsrio_codec_degrade")
    assert not any(hasattr(lib.lib, f"vsrio_{n}") for n in ("decode_clip", "bicubic_resize",
                                                            "jpeg_degrade"))
    if native.has_opencv():
        assert lib.path != build.load_host("vsrio").path


def test_a_failed_build_raises_and_the_bindings_warn(monkeypatch, tmp_path):
    """A host whose OpenCV build fails gets an error, not a quiet build
    without OpenCV; the bindings then warn and take the python paths."""
    monkeypatch.setattr(build, "opencv_include", lambda: str(tmp_path))  # no headers there
    monkeypatch.setattr(build, "OPENCV_LIBS", ("-lvsrio_no_such_library",))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        build._load_host.__wrapped__("vsrio")

    def fail(name):
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(build, "load_host", fail)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    with pytest.warns(RuntimeWarning, match="not built.*g\\+\\+ failed"):
        assert native._load() is None
    native.reset_counts()
    assert native.codec_degrade(_clip(4, t=2, h=16, w=24), 50.0) is None
    assert native.counts()["codec_degrade"] == {"native": 0, "python": 1}


def test_switched_off_every_entry_takes_the_python_path(monkeypatch, tmp_path):
    """With no library each entry point returns None and counts a python
    call; the callers then give the numpy / OpenCV results."""
    monkeypatch.setattr(native, "_load", lambda: None)
    native.reset_counts()
    clip = _clip(3, t=2, h=16, w=24)
    assert native.codec_degrade(clip, 50.0) is None
    assert native.bicubic_resize(clip, 4, 6) is None
    assert native.jpeg_degrade(clip, 50) is None
    paths = _frames(tmp_path, 2, 8, 12)
    assert native.decode_clip(paths) is None
    np.testing.assert_array_equal(codec_emulator.dct_codec_roundtrip(clip, 50.0),
                                  codec_emulator.dct_codec_roundtrip(clip, 50.0, force_numpy=True))
    np.testing.assert_array_equal(datasets.bicubic_lr(clip, 4), bicubic_down(clip, 4))
    np.testing.assert_array_equal(datasets.load_clip(paths),
                                  np.stack([datasets.load_frame(p) for p in paths]))
    counts = native.counts()
    assert {k: v["python"] for k, v in counts.items()} == {
        "codec_degrade": 2, "bicubic_resize": 2, "jpeg_degrade": 1, "decode_clip": 2}
    assert not any(v["native"] for v in counts.values())


@needs_opencv
def test_decode_matches_cv2(tmp_path):
    paths = _frames(tmp_path, 4, 24, 32)
    native.reset_counts()
    clip = datasets.load_clip(paths)
    assert native.counts()["decode_clip"] == {"native": 1, "python": 0}
    want = np.stack([cv2.imread(str(p))[..., ::-1].astype(np.float32) / 255.0 for p in paths])
    assert clip.shape == (4, 24, 32, 3)
    np.testing.assert_allclose(clip, want, atol=1e-6, rtol=0)
    assert native.decode_clip(paths[:2], height=12, width=16).shape == (2, 12, 16, 3)


@needs_opencv
def test_decode_failure_raises(tmp_path):
    bad = tmp_path / "nope.png"
    bad.write_bytes(b"not an image")
    with pytest.raises(IOError, match="cannot decode"):
        native.decode_clip([bad])
    good = _frames(tmp_path, 1, 8, 8)
    with pytest.raises(IOError, match="nope.png"):
        native.decode_clip([good[0], bad], height=8, width=8)


@needs_opencv
def test_native_size_mode_rejects_mixed_resolutions(tmp_path):
    """The C entry's contract: with out_h / out_w 0 every frame must have
    frame 0's size; a frame that differs fails (its 1-based index) rather
    than being written at its own size past the buffer."""
    import ctypes

    for d in ("a", "b"):
        (tmp_path / d).mkdir()
    a, b = _frames(tmp_path / "a", 1, 8, 8), _frames(tmp_path / "b", 1, 16, 16)
    out = np.empty((2, 8, 8, 3), np.float32)
    arr = (ctypes.c_char_p * 2)(str(a[0]).encode(), str(b[0]).encode())
    assert native._load().vsrio_decode_clip(arr, 2, native._fptr(out), 0, 0, 2) == 2


@needs_opencv
def test_bicubic_matches_cv2():
    clip = np.random.default_rng(4).random((3, 32, 40, 3)).astype(np.float32)
    native.reset_counts()
    got = datasets.bicubic_lr(clip, 4)
    assert native.counts()["bicubic_resize"] == {"native": 1, "python": 0}
    want = np.clip(np.stack([cv2.resize(f, (10, 8), interpolation=cv2.INTER_CUBIC)
                             for f in clip]), 0.0, 1.0)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, bicubic_down(clip, 4), atol=1e-6, rtol=0)


@needs_opencv
def test_jpeg_matches_cv2_roundtrip():
    clip = np.random.default_rng(5).random((2, 32, 32, 3)).astype(np.float32)
    native.reset_counts()
    got = augmentations.RandomJPEGCompression([50])(clip, np.random.default_rng(0))
    assert native.counts()["jpeg_degrade"] == {"native": 1, "python": 0}

    def py_jpeg(frame):
        u8 = np.clip(np.rint(np.clip(frame, 0, 1) * 255), 0, 255).astype(np.uint8)
        ok, buf = cv2.imencode(".jpg", u8[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 50])
        return cv2.imdecode(buf, cv2.IMREAD_COLOR)[..., ::-1].astype(np.float32) / 255.0

    np.testing.assert_allclose(got, np.stack([py_jpeg(f) for f in clip]), atol=1e-2, rtol=0)
    assert np.abs(got - clip).mean() > 1e-3  # it degrades
