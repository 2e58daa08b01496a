"""The port's bicubic downscale without OpenCV, against OpenCV and the JAX
package's datasets, on the CPU.

``bicubic_down`` is OpenCV's ``INTER_CUBIC`` (a = -0.75, half-pixel
centres, border-clamped taps) as two fp32 matrix products; it must agree
with ``cv2.resize`` within 1e-6 (fp32 rounding of a 4-tap sum: measured
about 2.4e-7), also where H or W is not a multiple of the scale. The
port's ``SyntheticVSR`` and ``DatasetVSR`` make their LR with it, with or
without OpenCV, within 1e-6 of the JAX datasets (its native library or
OpenCV).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from vsrlab_tpu.data import DatasetVSR as JDatasetVSR  # noqa: E402
from vsrlab_tpu.data import SyntheticVSR as JSyntheticVSR  # noqa: E402
from vsrlab_tpu_torch.data import DatasetVSR, SyntheticVSR, datasets  # noqa: E402
from vsrlab_tpu_torch.ops.resize import bicubic_down  # noqa: E402

ATOL = 1e-6


def opencv_down(clip, scale):
    t, h, w, _ = clip.shape
    frames = [cv2.resize(f, (w // scale, h // scale), interpolation=cv2.INTER_CUBIC)
              for f in clip]
    return np.clip(np.stack(frames), 0.0, 1.0)


@pytest.mark.parametrize("h,w,scale", [(64, 64, 4), (180, 320, 4), (70, 90, 4), (30, 42, 2)])
def test_bicubic_down_matches_opencv(h, w, scale):
    clip = np.random.default_rng(h * w).random((3, h, w, 3), np.float32)
    got = bicubic_down(clip, scale)
    assert got.shape == (3, h // scale, w // scale, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, opencv_down(clip, scale), atol=ATOL, rtol=0)


def test_bicubic_down_takes_leading_axes():
    clip = np.random.default_rng(3).random((2, 3, 16, 24, 3), np.float32)
    np.testing.assert_array_equal(bicubic_down(clip, 4)[1], bicubic_down(clip[1], 4))


@pytest.mark.parametrize("opencv", [True, False], ids=["with_cv2", "without_cv2"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_synthetic_lr_matches_jax_and_opencv(split, opencv, monkeypatch):
    if not opencv:
        monkeypatch.setattr(datasets, "cv2", None)
    kw = dict(num_videos=2, seq=3, height=48, width=64, scale=4, split=split, seed=11)
    mine, theirs = SyntheticVSR(**kw), JSyntheticVSR(**kw)
    for i in range(2):
        (lr, hr), (jlr, jhr) = mine[i], theirs[i]
        np.testing.assert_array_equal(hr, jhr)
        np.testing.assert_allclose(lr, jlr, atol=ATOL, rtol=0)
        np.testing.assert_allclose(lr, opencv_down(hr, 4), atol=ATOL, rtol=0)


def test_folder_dataset_lr_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    for v in range(2):
        d = tmp_path / f"vid{v}"
        d.mkdir()
        for i in range(4):
            cv2.imwrite(str(d / f"{i:05d}.png"), (rng.random((32, 40, 3)) * 255).astype(np.uint8))
    kw = dict(path=str(tmp_path), split="all", seq=3, scale=4, seed=2)
    mine, theirs = DatasetVSR(**kw), JDatasetVSR(**kw)
    for i in range(2):
        (lr, hr), (jlr, jhr) = mine[i], theirs[i]
        # the JAX package's native decode divides by 255 its own way: 6e-8
        np.testing.assert_allclose(hr, jhr, atol=1e-7, rtol=0)
        np.testing.assert_allclose(lr, jlr, atol=ATOL, rtol=0)
