"""The port's degradation pipeline against vsrlab_tpu's on the CPU.

* ``dct_codec_roundtrip`` / ``crf_to_quality`` against the JAX numpy path
  (``force_numpy=True``), atol 1e-6, at sizes that are no multiple of 16,
  GOP 0, 1 and 8, with and without chroma subsampling.
* Every augmentation against JAX's on a generator of the same seed: the
  same output (exactly: crop, flip, mirror, Resize and JPEG through
  OpenCV; atol 1e-6 for the codec emulator) and the same draws (the
  generators agree afterwards). Both packages' native libraries are
  switched off (``vsrlab_tpu.data.native._load`` and
  ``vsrlab_tpu_torch.data.native._load``), so that JPEG and the codec take
  the OpenCV and numpy paths in both; ``test_torch_native.py`` holds the
  native paths.
* ``build_pipeline`` over the reference's target names; the three
  datasets with augmentation against the JAX datasets; ``compress_video``
  and ``compress_video_folder`` against JAX.
"""

import numpy as np
import pytest

pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from vsrlab_tpu.data import augmentations as jaug  # noqa: E402
from vsrlab_tpu.data import codec_emulator as jcodec  # noqa: E402
from vsrlab_tpu.data import datasets as jdatasets  # noqa: E402
from vsrlab_tpu.data import native as jnative  # noqa: E402
from vsrlab_tpu_torch.data import native as pnative  # noqa: E402
from vsrlab_tpu.data import video_io as jvideo_io  # noqa: E402
from vsrlab_tpu_torch.data import augmentations as aug  # noqa: E402
from vsrlab_tpu_torch.data import codec_emulator as codec  # noqa: E402
from vsrlab_tpu_torch.data import datasets, video_io  # noqa: E402
from vsrlab_tpu_torch.ops.resize import bicubic_down  # noqa: E402


@pytest.fixture(autouse=True)
def no_native(monkeypatch):
    monkeypatch.setattr(jnative, "_load", lambda: None)
    monkeypatch.setattr(pnative, "_load", lambda: None)


def _clip(seed, t=4, h=21, w=35):
    """Smooth content with some texture (noise alone defeats any codec)."""
    rng = np.random.default_rng(seed)
    base = rng.random((t, max(h // 4, 1), max(w // 4, 1), 3)).astype(np.float32)
    smooth = np.stack([cv2.resize(f, (w, h), interpolation=cv2.INTER_CUBIC) for f in base])
    return np.clip(smooth + 0.05 * rng.standard_normal(smooth.shape).astype(np.float32), 0, 1)


@pytest.mark.parametrize("gop", [0, 1, 8])
@pytest.mark.parametrize("shape", [(3, 21, 35), (5, 16, 32), (2, 9, 50)])
@pytest.mark.parametrize("chroma", [True, False], ids=["420", "444"])
def test_codec_roundtrip_matches_jax(gop, shape, chroma):
    clip = _clip(sum(shape) + gop, *shape)
    for crf in (18, 27, 40):
        q = codec.crf_to_quality(crf)
        assert q == jcodec.crf_to_quality(crf)
        got = codec.dct_codec_roundtrip(clip, q, gop=gop, subsample_chroma=chroma)
        want = jcodec.dct_codec_roundtrip(clip, q, gop=gop, subsample_chroma=chroma,
                                          force_numpy=True)
        assert got.shape == clip.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_crf_to_quality_and_tables_match_jax():
    for crf in np.linspace(0, 60, 61):
        assert codec.crf_to_quality(crf) == jcodec.crf_to_quality(crf)
    np.testing.assert_array_equal(codec._Q_LUMA, jcodec._Q_LUMA)
    np.testing.assert_array_equal(codec._Q_CHROMA, jcodec._Q_CHROMA)
    for q in (1, 10, 49.5, 50, 99, 100):
        np.testing.assert_array_equal(codec._scale_table(codec._Q_CHROMA, q),
                                      jcodec._scale_table(jcodec._Q_CHROMA, q))


# name -> (kwargs, exact): one config of each transform
AUGS = {
    "jpeg": ("RandomJPEGCompression", {"quality": [30, 95]}, True),
    "jpeg_fixed": ("RandomJPEGCompression", {"quality": [55]}, True),
    "video": ("RandomVideoCompression", {"crf": [18, 35], "fps": [10, 30]}, False),
    "video_choices": ("RandomVideoCompression", {"crf": [20, 24, 30], "fps": [5, 25, 60]}, False),
    "crop": ("RandomCrop", {"size": 12}, True),
    "crop_rect": ("RandomCrop", {"size": [8, 20]}, True),
    "flip": ("RandomFlip", {"horizontal": True, "vertical": True, "p": 0.5}, True),
    "mirror": ("Mirroring", {}, True),
    "resize_scale": ("Resize", {"scale": 0.25}, True),
    "resize_size": ("Resize", {"size": [30, 17]}, True),
}


@pytest.mark.parametrize("name", sorted(AUGS))
def test_augmentation_matches_jax(name):
    cls, kw, exact = AUGS[name]
    clip = _clip(3, 4, 24, 40)
    for seed in range(4):
        rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
        got = getattr(aug, cls)(**kw)(clip, rng)
        want = getattr(jaug, cls)(**kw)(clip, jrng)
        assert got.shape == want.shape and got.dtype == want.dtype == np.float32
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        assert rng.random() == jrng.random()  # the same draws were made


REFERENCE_SPECS = [
    {"_target_": "vsrlab.core.augmentations.Mirroring"},
    {"_target_": "RandomCrop", "size": [16, 16]},
    {"_target_": "vsrlab.core.augmentations.RandomVideoCompression", "codec": ["libx264"],
     "crf": [18, 35], "fps": [10, 30]},
    {"_target_": "vsrlab.core.augmentations.RandomJPEGCompression", "quality": [30, 95]},
    {"_target_": "some.module.RandomFlip", "vertical": True},
]


def test_build_pipeline_over_the_reference_names():
    assert aug.build_pipeline(None) is None and aug.build_pipeline([]) is None
    clip = _clip(5, 3, 24, 24)
    mine, theirs = aug.build_pipeline(REFERENCE_SPECS), jaug.build_pipeline(REFERENCE_SPECS)
    for seed in range(3):
        got = mine(clip, np.random.default_rng(seed))
        want = theirs(clip, np.random.default_rng(seed))
        assert got.shape == (6, 16, 16, 3)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    double = aug.build_pipeline([aug.Mirroring(), {"_target_": "Mirroring"}])
    assert double(clip, None).shape[0] == 12
    with pytest.raises(KeyError, match="unknown augmentation"):
        aug.build_pipeline([{"_target_": "vsrlab.core.augmentations.RandomRotation"}])


def _write_frames(root, n, frames, h, w, seed):
    rng = np.random.default_rng(seed)
    for v in range(n):
        d = root / f"video{v:02d}"
        d.mkdir(parents=True)
        for f in range(frames):
            small = rng.integers(0, 256, (h // 4, w // 4, 3), dtype=np.uint8)
            cv2.imwrite(str(d / f"{f:04d}.png"), cv2.resize(small, (w, h)))


def _same(mine, theirs, epochs=(0, 1), atol=0.0):
    assert len(mine) == len(theirs)
    for epoch in epochs:
        mine.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for i in range(len(mine)):
            (lr, hr), (jlr, jhr) = mine[i], theirs[i]
            np.testing.assert_array_equal(hr, jhr)
            assert lr.shape == jlr.shape and lr.dtype == np.float32
            np.testing.assert_allclose(lr, jlr, atol=atol, rtol=0)


def test_dataset_vsr_degrades_hr_as_jax(tmp_path):
    """``lr_augmentation`` runs on HR, so its pipeline downscales first."""
    _write_frames(tmp_path, 4, 5, 32, 48, 0)
    kw = dict(path=str(tmp_path), split="train", seq=3, train_size=1.0, scale=4, seed=2,
              hr_augmentation=[{"_target_": "RandomCrop", "size": [24, 32]},
                               {"_target_": "RandomFlip"}],
              lr_augmentation=[{"_target_": "Resize", "scale": 0.25},
                               {"_target_": "RandomJPEGCompression", "quality": [40, 90]}])
    mine, theirs = datasets.DatasetVSR(**kw), jdatasets.DatasetVSR(**kw)
    assert mine[0][0].shape == (3, 6, 8, 3) and mine[0][1].shape == (3, 24, 32, 3)
    _same(mine, theirs)


def test_val_dataset_vsr_degrades_lr_as_jax(tmp_path):
    _write_frames(tmp_path / "hr", 3, 4, 32, 32, 1)
    _write_frames(tmp_path / "lr", 3, 4, 8, 8, 2)
    kw = dict(path_hr=str(tmp_path / "hr"), path_lr=str(tmp_path / "lr"), seq=3, seed=4,
              hr_augmentation=[{"_target_": "RandomFlip", "vertical": True}],
              lr_augmentation=[{"_target_": "RandomFlip", "vertical": True},
                               {"_target_": "RandomVideoCompression", "crf": [18, 35]}])
    _same(datasets.ValDatasetVSR(**kw), jdatasets.ValDatasetVSR(**kw), atol=1e-6)


@pytest.mark.parametrize("split", ["train", "val"])
def test_synthetic_vsr_degrades_lr_as_jax(split, monkeypatch):
    """The bicubic LR itself agrees to ~3e-7 (``test_torch_bicubic_down.py``),
    which JPEG's rounding to 8 bits could turn into a step of 1/255: the
    JAX dataset is handed the port's bicubic, so that the degradation's
    wiring (which seed, which clip) is held exactly."""
    monkeypatch.setattr(jdatasets, "_bicubic_down", bicubic_down)
    kw = dict(num_videos=3, seq=4, height=48, width=64, scale=4, split=split, seed=6,
              lr_augmentation=[{"_target_": "RandomJPEGCompression", "quality": [30, 95]},
                               {"_target_": "RandomVideoCompression", "crf": [18, 35],
                                "fps": [10, 30]}])
    mine = datasets.SyntheticVSR(**kw)
    _same(mine, jdatasets.SyntheticVSR(**kw), atol=1e-6)
    clean = datasets.SyntheticVSR(**{**kw, "lr_augmentation": None})
    assert np.abs(mine[0][0] - clean[0][0]).mean() > 1e-3  # the pipeline degraded the LR


@pytest.mark.parametrize("crf", [0, 28])
def test_compress_video_matches_jax(tmp_path, crf):
    frames = _clip(7, 6, 32, 48)
    (tmp_path / "hr").mkdir()
    src = tmp_path / "hr" / "clip.mp4"
    video_io.write_video(src, frames, fps=12.0)
    video_io.compress_video(src, tmp_path / "mine.mp4", crf, 4)
    jvideo_io.compress_video(str(src), str(tmp_path / "theirs.mp4"), crf, 4)
    got, _, fps, h, w = video_io.read_video(tmp_path / "mine.mp4")
    want = jvideo_io.read_video(tmp_path / "theirs.mp4")[0]
    assert (h, w, got.shape[0]) == (8, 12, 6) and fps == 12.0
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="divide"):
        video_io.compress_video(src, tmp_path / "bad.mp4", crf, 5)


def test_compress_video_folder_matches_jax(tmp_path):
    for root in ("mine", "theirs"):
        (tmp_path / root / "hr").mkdir(parents=True)
        for i in range(2):
            video_io.write_video(tmp_path / root / "hr" / f"v{i}.mp4", _clip(i, 3, 16, 16))
    video_io.compress_video_folder(tmp_path / "mine", 30, 2)
    jvideo_io.compress_video_folder(str(tmp_path / "theirs"), 30, 2)
    for i in range(2):
        got = video_io.read_video(tmp_path / "mine" / "lr_crf_30" / f"v{i}.mp4")[0]
        want = jvideo_io.read_video(tmp_path / "theirs" / "lr_crf_30" / f"v{i}.mp4")[0]
        assert got.shape == (3, 8, 8, 3)
        np.testing.assert_array_equal(got, want)
    video_io.compress_video_folder(tmp_path / "mine", 30, 2)  # made again in place
