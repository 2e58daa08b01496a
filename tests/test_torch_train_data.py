"""The port's training infrastructure on the CPU: config composition, the
component registry, datasets, the loader's batch stream, checkpoints and
the JSONL logger, against vsrlab_tpu where it has the same function."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vsrlab_tpu.core.config import load_config as j_load_config  # noqa: E402
from vsrlab_tpu.data import DataLoader as JDataLoader  # noqa: E402
from vsrlab_tpu.data import SyntheticVSR as JSyntheticVSR  # noqa: E402
from vsrlab_tpu_torch import components  # noqa: E402,F401
from vsrlab_tpu_torch.core.checkpoint import CheckpointManager, load_config_snapshot  # noqa: E402
from vsrlab_tpu_torch.core.config import Config, instantiate, load_config  # noqa: E402
from vsrlab_tpu_torch.core.loggers import build_logger  # noqa: E402
from vsrlab_tpu_torch.data import DataLoader, DatasetVSR, SyntheticVSR, ValDatasetVSR  # noqa: E402
from vsrlab_tpu_torch.data.loader import to_device  # noqa: E402
from vsrlab_tpu_torch.core.perceptual import PerceptualLoss  # noqa: E402
from vsrlab_tpu_torch.models import RealBasicVSR, TinyVRT, UNetDiscriminator  # noqa: E402

OVERRIDES = [
    ["+experiment=synthetic"],
    ["+experiment=basic", "train.data.batch_size=8", "train.optimizer.lr=3e-4"],
    ["+experiment=synthetic", "core.storage_dir=/tmp/x", "train.ema_decay=0.99"],
]


@pytest.mark.parametrize("overrides", OVERRIDES, ids=lambda o: o[0][12:])
def test_config_composes_as_jax(overrides, monkeypatch):
    monkeypatch.delenv("LOGGING_DIR", raising=False)
    assert load_config(overrides=overrides).to_dict() == \
        j_load_config(overrides=overrides).to_dict()


def test_config_env_interpolation(monkeypatch):
    monkeypatch.setenv("LOGGING_DIR", "/somewhere")
    cfg = load_config(overrides=["+experiment=synthetic"])
    assert cfg.core.storage_dir == "/somewhere" and cfg.train.logger.save_dir == "/somewhere"
    assert cfg.train.model.upscale == 4  # ${train.data.datasets.train.scale} keeps its type


def test_registry_builds_this_slice_and_names_the_slice_of_the_rest():
    model = instantiate({"_target_": "RealBasicVSR", "mid_channels": 8, "res_blocks": 1,
                         "cleaning_blocks": 1})
    assert isinstance(model, RealBasicVSR)
    alias = instantiate({"_target_": "vsrlab.vsr.models.RealBasicVSR.realbasicvsr.RealBasicVSR",
                         "mid_channels": 8, "res_blocks": 1, "cleaning_blocks": 1})
    assert isinstance(alias, RealBasicVSR)
    assert instantiate({"_target_": "torch.optim.AdamW", "lr": 1e-3}) == ("adamw", {"lr": 1e-3})
    assert instantiate({"_target_": "cosine", "T_max": 5}) == ("cosine", {"T_max": 5})
    assert isinstance(instantiate({"_target_": "SyntheticVSR", "num_videos": 2}), SyntheticVSR)
    # VRT serves from a run's snapshot (its training waits for a sampler backward)
    vrt = instantiate({"_target_": "TinyVRT", "window_size": [2, 4, 4], "depths": [1] * 7,
                       "embed_dims": [8] * 7, "num_heads": [2] * 7, "deformable_groups": 2})
    assert isinstance(vrt, TinyVRT)
    # the GAN slice's names build, and the flow slice's; wandb is named as not ported
    assert isinstance(instantiate({"_target_": "UNetDiscriminator", "mid_channels": 8}),
                      UNetDiscriminator)
    assert isinstance(instantiate({"_target_": "vsrlab.core.losses.PerceptualLoss"}),
                      PerceptualLoss)
    from vsrlab_tpu_torch.core.losses import OpticalFlowConsistency, epe_loss
    from vsrlab_tpu_torch.models.flow import RAFT
    assert isinstance(instantiate({"_target_": "RAFT", "iters": 2}), RAFT)
    assert instantiate({"_target_": "EPELoss"}) is epe_loss
    assert isinstance(instantiate({"_target_": "OpticalFlowConsistency"}), OpticalFlowConsistency)
    for name in ("WandbLogger", "vsrlab.core.loggers.WandbLogger"):
        with pytest.raises(KeyError, match="wandb is not ported"):
            instantiate({"_target_": name})
    with pytest.raises(KeyError, match="unknown _target_"):
        instantiate({"_target_": "NoSuchThing"})


@pytest.mark.parametrize("split", ["train", "val"])
def test_synthetic_samples_match_jax(split):
    """HR exactly; LR within 1e-6 (the JAX package downscales with its
    native library where built, else OpenCV's bicubic; the port computes
    OpenCV's bicubic in numpy: they agree to about 3e-7)."""
    kw = dict(num_videos=3, seq=3, height=32, width=40, scale=4, split=split, seed=5)
    mine, theirs = SyntheticVSR(**kw), JSyntheticVSR(**kw)
    assert len(mine) == len(theirs) == 3
    for i in range(3):
        (lr, hr), (jlr, jhr) = mine[i], theirs[i]
        np.testing.assert_array_equal(hr, jhr)
        assert lr.shape == jlr.shape == (3, 8, 10, 3) and lr.dtype == np.float32
        np.testing.assert_allclose(lr, jlr, atol=1e-6)


def test_synthetic_without_opencv_takes_the_box_mean(monkeypatch):
    """The box mean is gone: without OpenCV the LR is the same bicubic
    downscale as with it."""
    from vsrlab_tpu_torch.data import video_io

    with_cv2 = SyntheticVSR(num_videos=1, seq=2, height=8, width=12, scale=4)[0][0]
    monkeypatch.setattr(video_io, "cv2", None)
    lr, hr = SyntheticVSR(num_videos=1, seq=2, height=8, width=12, scale=4)[0]
    np.testing.assert_array_equal(lr, with_cv2)
    assert not np.allclose(lr, hr.reshape(2, 2, 4, 3, 4, 3).mean((2, 4)), rtol=1e-6)


def test_augmentations_are_refused(monkeypatch):
    """The degradation pipeline is ported: an augmentation it does not know
    is refused when the dataset is built, and JPEG without OpenCV raises
    where the JAX package would return the clip untouched."""
    from vsrlab_tpu_torch.data import video_io

    with pytest.raises(KeyError, match="unknown augmentation"):
        SyntheticVSR(lr_augmentation=[{"_target_": "RandomRotation"}])
    ds = SyntheticVSR(num_videos=1, seq=2, height=16, width=16,
                      lr_augmentation=[{"_target_": "RandomJPEGCompression"}])
    monkeypatch.setattr(video_io, "cv2", None)
    with pytest.raises(ImportError, match="RandomJPEGCompression needs OpenCV"):
        ds[0]


def _write_videos(root, n, frames, h, w, seed):
    import cv2

    rng = np.random.default_rng(seed)
    for v in range(n):
        d = root / f"video{v:02d}"
        d.mkdir(parents=True)
        for f in range(frames):
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            cv2.imwrite(str(d / f"{f:04d}.png"), img)


def test_folder_datasets_read_windows(tmp_path):
    _write_videos(tmp_path / "hr", 5, 4, 16, 20, 0)
    _write_videos(tmp_path / "lr", 5, 4, 4, 5, 1)
    train = DatasetVSR(str(tmp_path / "hr"), split="train", seq=3, train_size=0.8, scale=4)
    val = DatasetVSR(str(tmp_path / "hr"), split="val", seq=3, train_size=0.8, scale=4)
    assert (len(train), len(val)) == (4, 1)
    lr, hr = train[2]
    assert hr.shape == (3, 16, 20, 3) and lr.shape == (3, 4, 5, 3)
    assert 0.0 <= hr.min() and hr.max() <= 1.0
    again = DatasetVSR(str(tmp_path / "hr"), split="train", seq=3, scale=4)[2]
    np.testing.assert_array_equal(again[1], hr)  # the window follows (seed, epoch, index)
    paired = ValDatasetVSR(str(tmp_path / "hr"), str(tmp_path / "lr"), seq=2)
    plr, phr = paired[1]
    assert plr.shape == (2, 4, 5, 3) and phr.shape == (2, 16, 20, 3)


class _Indices:
    """A dataset whose sample is its index, to read a loader's order."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((1,), i, np.float32), np.full((1,), i, np.float32)


@pytest.mark.parametrize("kw", [dict(batch_size=4), dict(batch_size=3, drop_last=False),
                                dict(batch_size=4, num_shards=2, shard_index=1),
                                dict(batch_size=2, shuffle=False)])
def test_loader_batch_order_matches_jax(kw):
    """One seed, two epochs and a skip of two batches: the same index stream."""
    def stream(cls):
        dl = cls(_Indices(11), seed=3, num_workers=2, **kw)
        out = []
        for epoch in (0, 1):
            dl.set_epoch(epoch)
            if epoch == 1:
                dl.skip_next(2)
            out.append([b["lr"][:, 0].astype(int).tolist() for b in dl])
        return len(dl), out

    assert stream(DataLoader) == stream(JDataLoader)


def test_loader_puts_batches_on_the_device_and_surfaces_errors():
    dl = DataLoader(_Indices(4), batch_size=2, num_workers=1, device_put=to_device("cpu"))
    batch = next(iter(dl))
    assert isinstance(batch["hr"], torch.Tensor) and batch["hr"].shape == (2, 1)

    class Broken(_Indices):
        def __getitem__(self, i):
            raise RuntimeError("bad sample")

    with pytest.raises(RuntimeError, match="bad sample"):
        list(DataLoader(Broken(4), batch_size=2))


def _state_dict(seed):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(3, 4, generator=g), "b": torch.randn(4, generator=g)}


def test_checkpoint_round_trip_and_config_snapshot(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    params, opt = _state_dict(0), {"state": {0: {"step": torch.tensor(3.0)}}, "lr": 1e-3}
    mgr.save(3, params, opt, config={"a": 1, "b": {"c": [1, 2]}})
    key, payload = CheckpointManager(str(tmp_path / "ckpt")).restore()
    assert key == 3 and payload["opt_state"]["lr"] == 1e-3
    assert all(torch.equal(payload["params"][k], params[k]) for k in params)
    assert load_config_snapshot(str(tmp_path / "ckpt")) == {"a": 1, "b": {"c": [1, 2]}}
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


def test_checkpoint_rotation_prunes_keys_and_sidecars(tmp_path):
    d = tmp_path / "ckpt"
    mgr = CheckpointManager(str(d), max_to_keep=2)
    for k in (1, 2, 3):
        mgr.save(k, _state_dict(k), meta={"epoch": 0, "batch_in_epoch": k, "steps_per_epoch": 4})
    assert mgr.all_keys() == [2, 3] and mgr.latest_epoch() == 3
    assert not (d / "1").exists() and not (d / "meta_1.json").exists()
    assert mgr.load_meta(1) is None and mgr.load_meta(3)["batch_in_epoch"] == 3
    mgr.save(4, _state_dict(4))  # a meta-less save
    assert mgr.all_keys() == [3, 4] and not (d / "meta_4.json").exists()
    mgr.save(3, _state_dict(5))  # a re-saved key drops its stale sidecar
    assert mgr.load_meta(3) is None
    assert torch.equal(mgr.restore(3)[1]["params"]["w"], _state_dict(5)["w"])


def test_jsonl_logger_writes_scalars_and_grids(tmp_path):
    logger = build_logger({"_target_": "Logger", "backend": "auto", "save_dir": str(tmp_path),
                           "project": "p", "id": "r"})
    logger.log_dict({"Loss": torch.tensor(0.5), "PSNR": 20.0}, 1, "Val")
    logger.log_images(1, "Val", sr=np.zeros((1, 2, 4, 4, 3), np.float32))
    logger.save(tmp_path / "ckpt")
    logger.close()
    rows = [json.loads(x) for x in (tmp_path / "p" / "r" / "metrics.jsonl").read_text().splitlines()]
    assert rows[0]["event"] == "init" and rows[-1]["event"] == "close"
    assert {"Loss/Val": 0.5, "PSNR/Val": 20.0, "epoch": 1}.items() <= rows[1].items()
    assert (tmp_path / "p" / "r" / "media" / "sr_Val_1.png").exists()
    with pytest.raises(NotImplementedError):
        build_logger({"backend": "wandb"})
    assert build_logger(None) is None


def test_config_from_python_needs_no_yaml(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_yaml(name, *a, **kw):
        if name == "yaml":
            raise ImportError("no yaml")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    cfg = Config.from_dict({"train": {"data": {"batch_size": 2}}})
    assert cfg.train.data.batch_size == 2 and cfg.get_path("train.data.batch_size") == 2
    with pytest.raises(ImportError, match="PyYAML"):
        load_config(overrides=["+experiment=synthetic"])


def test_seeding_gives_a_generator_that_draws_the_weights():
    from vsrlab_tpu_torch.nn.blocks import init_weights
    from vsrlab_tpu_torch.utils import seed_everything, seed_index_everything

    a = init_weights(RealBasicVSR(8, 1, 1), seed_index_everything(Config.from_dict(
        {"seed_index": 3})))
    b = init_weights(RealBasicVSR(8, 1, 1), seed_everything(3))
    c = init_weights(RealBasicVSR(8, 1, 1), seed_index_everything({}))  # the sanity seed 42
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    assert not torch.equal(a.state_dict()["cleaner.conv.weight"], c.state_dict()["cleaner.conv.weight"])
    assert seed_everything(42).initial_seed() == 42
