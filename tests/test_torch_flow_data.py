"""The port's flow data against vsrlab_tpu on the CPU: each joint
transform and their composition (outputs and the generators' states
after), the synthetic and the file datasets, ``load_flow_file``, and
``create_flow_dataset.main`` with one surrogate RAFT checkpoint in both
packages.

Both packages' native libraries are switched off
(``vsrlab_tpu.data.native._load``, ``vsrlab_tpu_torch.data.native._load``),
so that the codec round trip is the numpy emulator in both. Tolerances: the transforms and datasets
exactly (the same OpenCV and numpy calls on the same draws); the teacher
flows within 1e-4 px (two fp32 RAFT forwards, 12 GRU iterations).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from vsrlab_tpu.data import create_flow_dataset as jcreate  # noqa: E402
from vsrlab_tpu.data import flow_dataset as jfd  # noqa: E402
from vsrlab_tpu.data import native as jnative  # noqa: E402
from vsrlab_tpu_torch.data import native as pnative  # noqa: E402
from vsrlab_tpu_torch.data import create_flow_dataset, flow_dataset as fd  # noqa: E402
from vsrlab_tpu_torch.models.flow import RAFT  # noqa: E402
from vsrlab_tpu_torch.nn.blocks import init_weights  # noqa: E402


@pytest.fixture(autouse=True)
def no_native(monkeypatch):
    monkeypatch.setattr(jnative, "_load", lambda: None)
    monkeypatch.setattr(pnative, "_load", lambda: None)


def _pair(rng, h=24, w=32):
    return (rng.random((2, h, w, 3)).astype(np.float32),
            (rng.standard_normal((h, w, 2)) * 2).astype(np.float32))


def _both(name, *args):
    return getattr(fd, name)(*args), getattr(jfd, name)(*args)


TRANSFORMS = [("FlowResize", (40, 56)), ("FlowRandomRotation", (17, 1.0)),
              ("FlowRandomRotation", ((-5, 9), 0.5)), ("FlowRandomHorizontalFlip", (1.0,)),
              ("FlowRandomHorizontalFlip", (0.5,)), ("FlowRandomVerticalFlip", (1.0,)),
              ("FlowRandomVerticalFlip", (0.5,)), ("FlowVideoCompression", (("libx264",),
                                                                           (20, 30), (10, 12)))]


@pytest.mark.parametrize("name,args", TRANSFORMS, ids=str)
def test_flow_transform_matches_jax(rng, name, args):
    mine, theirs = _both(name, *args)
    for seed in range(3):
        frames, flow = _pair(rng)
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        got = mine(frames.copy(), flow.copy(), r1)
        want = theirs(frames.copy(), flow.copy(), r2)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        assert r1.bit_generator.state == r2.bit_generator.state


def test_flips_move_the_field_and_keep_the_vectors(rng):
    """The reference's quirk, kept: a flip moves the flow field and does
    not negate its vectors."""
    frames, flow = _pair(rng)
    _, out = fd.FlowRandomHorizontalFlip(1.0)(frames, flow, np.random.default_rng(0))
    np.testing.assert_array_equal(out, flow[:, ::-1])


def test_flow_compose_matches_jax(rng):
    spec = lambda m: m.FlowCompose([m.FlowResize(48, 64), m.FlowRandomRotation(17, 0.5),  # noqa
                                    m.FlowRandomHorizontalFlip(0.5),
                                    m.FlowRandomVerticalFlip(0.5),
                                    m.FlowVideoCompression(crf=(30, 30), fps=(12, 12))])
    mine, theirs = spec(fd), spec(jfd)
    for seed in range(4):
        frames, flow = _pair(rng)
        got = mine(frames, flow, np.random.default_rng(seed))
        want = theirs(frames, flow, np.random.default_rng(seed))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("split", ["train", "val"])
def test_synthetic_flow_dataset_matches_jax(split):
    kw = dict(num_samples=3, height=24, width=32, split=split, seed=2,
              compression=None)
    for comp in (None, "codec"):
        mine = fd.SyntheticFlowDataset(**{**kw, "compression": comp and fd.FlowVideoCompression()})
        theirs = jfd.SyntheticFlowDataset(
            **{**kw, "compression": comp and jfd.FlowVideoCompression()})
        assert len(mine) == len(theirs) == 3
        for epoch in (0, 1):
            mine.set_epoch(epoch)
            theirs.set_epoch(epoch)
            for i in range(3):
                for g, w in zip(mine[i], theirs[i]):
                    assert g.shape == w.shape and g.dtype == np.float32
                    np.testing.assert_array_equal(g, w)
    f1, f2, flow = fd.SyntheticFlowDataset(num_samples=1, height=24, width=32)[0]
    dx, dy = int(flow[0, 0, 0]), int(flow[0, 0, 1])
    np.testing.assert_array_equal(f1[3:21, 3:29], f2[3 + dy:21 + dy, 3 + dx:29 + dx])


def _write_flow(path, flow):
    if path.suffix == ".npz":
        np.savez(path, flow=flow)
    elif path.suffix == ".npy":
        np.save(path, flow)
    else:
        torch.save(torch.from_numpy(np.ascontiguousarray(flow.transpose(2, 0, 1))), path)


@pytest.mark.parametrize("suffix", [".npz", ".npy", ".pt"])
def test_load_flow_file_matches_jax(tmp_path, rng, suffix):
    flow = rng.standard_normal((6, 7, 2)).astype(np.float32)
    path = tmp_path / f"flow{suffix}"
    _write_flow(path, flow)
    got, want = fd.load_flow_file(path), jfd.load_flow_file(path)
    np.testing.assert_array_equal(got, flow)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown flow file"):
        fd.load_flow_file(tmp_path / "flow.txt")


def _frames_on_disk(root, rng, videos=("vidA", "vid_B"), n=3, h=24, w=32):
    for v in videos:
        (root / v).mkdir(parents=True)
        for i in range(n):
            img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
            cv2.imwrite(str(root / v / f"{i:04d}.png"), img)


def test_flow_dataset_matches_jax(tmp_path, rng):
    """Files of each kind named ``<video>_<f1>_<f2>.<ext>`` (video names
    with an underscore too), the train / val split, the augmentation and
    the compression, over two epochs."""
    frames_root, flows = tmp_path / "frames", tmp_path / "flows"
    flows.mkdir()
    _frames_on_disk(frames_root, rng)
    for k, (v, suffix) in enumerate((("vidA", ".npz"), ("vidA", ".npy"), ("vid_B", ".pt"),
                                     ("vid_B", ".npz"))):
        i = k % 2
        _write_flow(flows / f"{v}_{i:04d}_{i + 1:04d}.png{suffix}",
                    rng.standard_normal((24, 32, 2)).astype(np.float32))
    aug = lambda m: m.FlowCompose([m.FlowResize(32, 48), m.FlowRandomRotation(17, 0.5),  # noqa
                                   m.FlowRandomHorizontalFlip(0.5)])
    for split, size in (("train", 0.75), ("val", 0.75), ("all", 0.5)):
        mine = fd.FlowDataset(str(flows), str(frames_root), split, size, augmentation=aug(fd),
                              compression=fd.FlowVideoCompression(crf=(26, 26)), seed=1)
        theirs = jfd.FlowDataset(str(flows), str(frames_root), split, size,
                                 augmentation=aug(jfd),
                                 compression=jfd.FlowVideoCompression(crf=(26, 26)), seed=1)
        assert len(mine) == len(theirs) == {"train": 3, "val": 1, "all": 4}[split]
        for epoch in (0, 1):
            mine.set_epoch(epoch)
            theirs.set_epoch(epoch)
            for i in range(len(mine)):
                for g, w in zip(mine[i], theirs[i]):
                    assert g.shape == w.shape
                    np.testing.assert_array_equal(g, w)


def test_create_flow_dataset_matches_jax(tmp_path, rng):
    """One surrogate ``raft-small`` checkpoint (a seeded port RAFT's state
    dict, reference layout) through both CLIs on the CPU: the same files,
    flows within 1e-4 px; then FlowDataset reads them back."""
    frames_root = tmp_path / "frames"
    _frames_on_disk(frames_root, rng, videos=("vidA",), h=48, w=40)
    ckpt = tmp_path / "raft-small.pth"
    model = init_weights(RAFT(small=True, scale_factor=8), torch.Generator().manual_seed(5))
    torch.save({f"module.{k}": v for k, v in model.state_dict().items()}, ckpt)
    args = ["--frames", str(frames_root), "--height", "64", "--width", "64", "--raft-ckpt",
            str(ckpt)]
    create_flow_dataset.main(args + ["--out", str(tmp_path / "mine"), "--device", "cpu"])
    jcreate.main(args + ["--out", str(tmp_path / "theirs")])
    mine = sorted(p.name for p in (tmp_path / "mine").iterdir())
    assert mine == sorted(p.name for p in (tmp_path / "theirs").iterdir())
    assert mine == ["vidA_0000_0001.png.npz", "vidA_0001_0002.png.npz"]
    for name in mine:
        got = np.load(tmp_path / "mine" / name)["flow"]
        want = np.load(tmp_path / "theirs" / name)["flow"]
        assert got.shape == (64, 64, 2) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    ds = fd.FlowDataset(str(tmp_path / "mine"), str(frames_root), "all")
    f1, f2, flow = ds[1]
    assert f1.shape == (48, 40, 3) and flow.shape == (64, 64, 2)


def test_create_flow_dataset_refuses_a_missing_card_and_needs_a_checkpoint(tmp_path,
                                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ckpt = tmp_path / "raft-small.pth"
    torch.save(RAFT(small=True).state_dict(), ckpt)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        create_flow_dataset.main(["--frames", str(tmp_path), "--out", str(tmp_path / "o"),
                                  "--raft-ckpt", str(ckpt)])
    with pytest.raises(SystemExit):
        create_flow_dataset.main(["--frames", str(tmp_path), "--out", str(tmp_path / "o")])
