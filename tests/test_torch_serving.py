"""The port's serving entry points against the JAX package's, on the CPU:
``load_test_model`` (raw, EMA and stale-EMA run directories), tiled
``make_forward`` and ``windowed_inference``, the fps x crf sweep
(``run_test_matrix``, untiled, tiled, and TinyVRT with ``align_chunks``)
and its CLI, video I/O, ``VideoDatasetVSR`` and ``upscale`` (mp4 -> mp4,
folder -> folder, ``--stream``), and the upscale loop's helpers.

JAX run directories are written by the JAX ``CheckpointManager``, the
port's by ``convert.write_run_dir`` from the same numpy params.
RealBasicVSR at mid 8, one block; TinyVRT at one block a stage, 8
channels. Gate: fp32 atol 5e-4 on SR pixels, as tests/test_torch_models.py;
metrics within 2e-3 (PSNR in dB: a 5e-4 pixel deviation moves it by less);
PNG frames within one step of 255 (rounding near a half).
"""

import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from vsrlab_tpu.core.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from vsrlab_tpu.data import SyntheticVSR as JSyntheticVSR  # noqa: E402
from vsrlab_tpu.data import video_io as jvideo_io  # noqa: E402
from vsrlab_tpu.data.datasets import VideoDatasetVSR as JVideoDatasetVSR  # noqa: E402
from vsrlab_tpu.evaluation import harness as jh  # noqa: E402
from vsrlab_tpu.evaluation import upscale as jup  # noqa: E402
from vsrlab_tpu.models import RealBasicVSR as JRealBasicVSR  # noqa: E402
from vsrlab_tpu.models import TinyVRT as JTinyVRT  # noqa: E402
from vsrlab_tpu_torch import convert  # noqa: E402
from vsrlab_tpu_torch.data import VideoDatasetVSR, video_io  # noqa: E402
from vsrlab_tpu_torch.evaluation import harness as th  # noqa: E402
from vsrlab_tpu_torch.evaluation import upscale as tup  # noqa: E402

ATOL = 5e-4
METRIC_ATOL = 2e-3
RBV = {"_target_": "RealBasicVSR", "mid_channels": 8, "res_blocks": 1, "cleaning_blocks": 1}
VRT_KW = dict(upscale=4, window_size=[2, 4, 4], depths=[1] * 7, embed_dims=[8] * 7,
              num_heads=[2] * 7, deformable_groups=2, drop_path_rate=0.0)


def _draw(shapes, seed):
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        elif name in ("kernel", "weight"):
            bound = 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
            v = rng.uniform(-bound, bound, leaf.shape)
        else:
            v = 0.05 * rng.standard_normal(leaf.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_run(d, params, cfg, ema=None, key=0, ema_key=0):
    mgr = JCheckpointManager(str(d))
    mgr.save(key, params, config=cfg)
    mgr.close()
    if ema is not None:
        mgr = JCheckpointManager(str(d / "ema"))
        mgr.save(ema_key, ema)
        mgr.close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """RealBasicVSR params, an EMA that differs, and run directories of
    both packages: ``raw`` (no sidecar), ``ema`` (sidecar at the main key)
    and ``stale`` (main key 1, sidecar at key 0)."""
    root = tmp_path_factory.mktemp("runs")
    jmodel = JRealBasicVSR(mid_channels=8, res_blocks=1, cleaning_blocks=1)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 2, 16, 16, 3)))["params"]
    params, ema = _draw(shapes, 0), _draw(shapes, 1)
    cfg = {"train": {"model": RBV, "precision": "fp32"}}
    out = {"params_tree": params, "ema_tree": ema}
    for name, kw in {"raw": {}, "ema": {"ema": ema}, "stale": {"ema": ema, "key": 1}}.items():
        jd, td = root / f"jax_{name}", root / f"torch_{name}"
        _jax_run(jd, params, cfg, kw.get("ema"), kw.get("key", 0))
        if name == "stale":
            convert.write_run_dir(td, params, cfg, ema_params=ema, key=0)
            convert.write_run_dir(td, params, cfg, key=1)
        else:
            convert.write_run_dir(td, params, cfg, ema_params=kw.get("ema"))
        out[name] = (str(jd), str(td))
    vshapes = jax.eval_shape(JTinyVRT(**VRT_KW).init, jax.random.PRNGKey(0),
                             jnp.zeros((1, 2, 16, 16, 3)))["params"]
    vparams = _draw(vshapes, 2)
    vcfg = {"train": {"model": {"_target_": "TinyVRT", **VRT_KW}, "precision": "fp32"}}
    jd, td = root / "jax_vrt", root / "torch_vrt"
    _jax_run(jd, vparams, vcfg)
    convert.write_run_dir(td, vparams, vcfg)
    out["vrt"] = (str(jd), str(td))
    return out


@pytest.fixture(scope="module")
def matrix(tmp_path_factory):
    """``<root>/{lr,hr}/fps=6_crf={30,32}/{frames,video}/vid0`` of a 5-frame
    64x48 clip (LR 16x12), as tests/test_evaluation.py builds it."""
    root = tmp_path_factory.mktemp("matrix")
    lr_clip, hr_clip = JSyntheticVSR(num_videos=1, seq=5, height=64, width=48, scale=4)[0]

    def write(base, clip, size):
        frames_dir, video_dir = base / "frames" / "vid0", base / "video"
        frames_dir.mkdir(parents=True)
        video_dir.mkdir(parents=True)
        for i, f in enumerate(clip):
            cv2.imwrite(str(frames_dir / f"{i:05d}.png"),
                        (np.clip(f, 0, 1) * 255).round().astype(np.uint8)[..., ::-1])
        (video_dir / "vid0").write_bytes(b"x" * size)

    for crf, size in ((30, 1000), (32, 700)):
        write(root / "lr" / f"fps=6_crf={crf}", lr_clip, size)
    write(root / "hr" / "fps=6_crf=5", hr_clip, 4000)
    return root


def _sr(model, x):
    return th.make_forward(model, device="cpu")(x).numpy()


def _jsr(jmodel, params, x):
    return np.asarray(jh.make_forward(jmodel)(params, jnp.asarray(x)))


def _clip(t, h, w, seed=3):
    return np.random.default_rng(seed).random((1, t, h, w, 3), np.float32)


@pytest.mark.parametrize("use_ema", [True, False], ids=["ema", "raw_weights"])
@pytest.mark.parametrize("run", ["raw", "ema", "stale"])
def test_load_test_model_serves_the_weights_jax_serves(runs, run, use_ema):
    jd, td = runs[run]
    log = io.StringIO()
    with redirect_stdout(log):
        model, cfg = th.load_test_model(td, use_ema=use_ema, device="cpu")
    jmodel, jparams, _ = jh.load_test_model(jd, use_ema=use_ema)
    served = "ema_tree" if run == "ema" and use_ema else "params_tree"
    want_sd = convert.realbasicvsr_state_dict(runs[served])
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, want_sd[k], rtol=0, atol=0)
    assert not model.training and cfg.train.model.mid_channels == 8
    assert ("WARNING" in log.getvalue()) == (run == "stale" and use_ema)
    x = _clip(3, 16, 12)
    np.testing.assert_allclose(_sr(model, x), _jsr(jmodel, jparams, x), atol=ATOL)


def test_realbasicvsr_params_inverts_the_mapping(runs):
    tree = runs["params_tree"]
    back = convert.realbasicvsr_params(convert.realbasicvsr_state_dict(tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    jax.tree.map(np.testing.assert_array_equal, back, tree)


def test_load_test_model_refuses_missing_cuda(runs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        th.load_test_model(runs["raw"][1])


@pytest.mark.parametrize("tile,overlap", [(8, 4), (10, 2)])
def test_tiled_make_forward_and_windowed_match_jax(runs, tile, overlap):
    jd, td = runs["raw"]
    model, _ = th.load_test_model(td, device="cpu")
    jmodel, jparams, _ = jh.load_test_model(jd)
    x = _clip(5, 16, 20)
    want, jn = jh.windowed_inference(jh.make_forward(jmodel, tile, overlap), jparams, x, 2)
    got, n = th.windowed_inference(th.make_forward(model, tile, overlap, device="cpu"), x, 2)
    assert n == jn == 3 and got.shape == (1, 5, 64, 80, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _rows_match(rows, df):
    assert [list(r) for r in rows] == [list(df.columns)] * len(rows)
    for row, (_, jrow) in zip(rows, df.iterrows()):
        for k, v in row.items():
            assert v == pytest.approx(float(jrow[k]), abs=METRIC_ATOL), k


@pytest.mark.parametrize("case", ["untiled", "tiled", "vrt_align_chunks"])
def test_run_test_matrix_matches_jax(runs, matrix, tmp_path, case):
    run, kw = {"untiled": ("raw", {}), "tiled": ("raw", {"tile": 8, "tile_overlap": 4}),
               "vrt_align_chunks": ("vrt", {"align_chunks": 2})}[case]
    jd, td = runs[run]
    common = dict(lr_dir=str(matrix / "lr"), hr_dir=str(matrix / "hr"), window_size=3,
                  fps_list=(6,), crf_list=(30, 32), **kw)
    df = jh.run_test_matrix(jd, out_dir=str(tmp_path / "jax"), **common)
    rows = th.run_test_matrix(td, out_dir=str(tmp_path / "torch"), device="cpu", **common)
    assert len(rows) == 2 and [r["crf"] for r in rows] == [30, 32]
    _rows_match(rows, df)
    assert rows[1]["cf"] == pytest.approx(700 / 4000) and rows[0]["bpp"] > 0
    out = tmp_path / "torch" / f"torch_{run}"
    with open(out / f"torch_{run}.csv") as fh:
        header = fh.readline().strip().split(",")
    assert header == list(df.columns) == ["cf", "bpp", "fps", "crf", "PSNR", "SSIM"]
    mine = sorted((out / "fps=6_crf=30" / "vid0").glob("img*.png"))
    theirs = sorted((tmp_path / "jax" / f"jax_{run}" / "fps=6_crf=30" / "vid0").glob("*.png"))
    assert [p.name for p in mine] == [p.name for p in theirs] == [f"img{i:05d}.png"
                                                                 for i in range(5)]
    for a, b in zip(mine, theirs):
        diff = np.abs(cv2.imread(str(a)).astype(int) - cv2.imread(str(b)).astype(int))
        assert diff.max() <= 1


def test_run_test_matrix_refuses_unknown_metric_before_decoding(runs, tmp_path):
    with pytest.raises((KeyError, ValueError)):
        th.run_test_matrix(runs["raw"][1], str(tmp_path / "nope"), str(tmp_path / "nope"),
                           str(tmp_path / "out"), metrics=["NoSuchMetric"], device="cpu")


def test_harness_cli(runs, matrix, tmp_path):
    td = runs["ema"][1]
    rows = th.main(["--cfg-dir", td, "--lr-dir", str(matrix / "lr"), "--hr-dir",
                    str(matrix / "hr"), "--out-dir", str(tmp_path), "--window-size", "5",
                    "--raw-weights", "--device", "cpu"])
    assert len(rows) == 3 * 3  # the default fps x crf lists; only fps=6 has videos
    assert (tmp_path / "torch_ema" / "torch_ema.csv").exists()
    found = [r for r in rows if r["fps"] == 6 and r["crf"] == 30][0]
    assert np.isfinite(found["PSNR"]) and 0 <= found["SSIM"] <= 1


def test_evaluate_video_scores_on_the_device(runs):
    model, _ = th.load_test_model(runs["raw"][1], device="cpu")
    lr, hr = _clip(4, 16, 12), _clip(4, 64, 48, seed=9)
    sr, vals = th.evaluate_video(th.make_forward(model, device="cpu"), lr, hr, 3,
                                 ("PSNR", "SSIM"))
    assert sr.shape == (1, 4, 64, 48, 3) and float(sr.min()) >= 0 and float(sr.max()) <= 1
    jmodel, jparams, _ = jh.load_test_model(runs["raw"][0])
    jsr, _ = jh.windowed_inference(jh.make_forward(jmodel), jparams, lr, 3)
    from vsrlab_tpu.core.metrics import MetricCollection as JMetrics

    for k in ("PSNR", "SSIM"):
        want = float(JMetrics.BUILTIN[k](jnp.clip(jsr, 0, 1), jnp.asarray(hr)))
        assert vals[k] == pytest.approx(want, abs=METRIC_ATOL)


def test_video_io_round_trip_matches_jax(tmp_path):
    frames = np.random.default_rng(4).random((6, 32, 48, 3), np.float32)
    mine, theirs = tmp_path / "mine.mp4", tmp_path / "theirs.mp4"
    video_io.write_video(mine, frames, fps=12, crf=10)
    jvideo_io.write_video(theirs, frames, fps=12, crf=10)
    assert mine.read_bytes() == theirs.read_bytes()
    back, codec, fps, h, w = video_io.read_video(mine)
    jback, jcodec, jfps, jh_, jw = jvideo_io.read_video(mine)
    np.testing.assert_array_equal(back, jback)
    assert (codec, fps, h, w) == (jcodec, jfps, jh_, jw) and back.shape == (6, 32, 48, 3)
    assert video_io.video_frame_count(mine) == 6
    np.testing.assert_array_equal(video_io.read_video_window(mine, 2, 3), back[2:5])
    np.testing.assert_array_equal(video_io.read_video_window(mine, 50, 3),
                                  jvideo_io.read_video_window(mine, 50, 3))
    reader = video_io.SequentialVideoReader(mine)
    try:
        parts = [reader.read(4), reader.read(4), reader.read(4)]
    finally:
        reader.close()
    assert [len(p) for p in parts] == [4, 2, 0]
    np.testing.assert_array_equal(np.concatenate(parts), back)


def test_video_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(6)
    for v in range(3):
        video_io.write_video(tmp_path / f"v{v}.mp4", rng.random((5, 32, 40, 3), np.float32))
    (tmp_path / "notes.txt").write_text("not a video")
    kw = dict(path=str(tmp_path), split="train", train_size=0.7, seq=3, scale=4, seed=1)
    mine, theirs = VideoDatasetVSR(**kw), JVideoDatasetVSR(**kw)
    assert len(mine) == len(theirs) == 2
    for epoch in (0, 1):
        mine.set_epoch(epoch), theirs.set_epoch(epoch)
        for i in range(2):
            (lr, hr), (jlr, jhr) = mine[i], theirs[i]
            np.testing.assert_array_equal(hr, jhr)
            np.testing.assert_allclose(lr, jlr, atol=1e-6, rtol=0)
            assert lr.shape == (3, 8, 10, 3)


@pytest.fixture(scope="module")
def frames_in(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(8)
    for i in range(5):
        cv2.imwrite(str(d / f"f{i:03d}.png"), (rng.random((16, 12, 3)) * 255).astype(np.uint8))
    return d


def _pngs(folder):
    return np.stack([cv2.imread(str(p)) for p in sorted(folder.glob("img*.png"))]).astype(int)


@pytest.mark.parametrize("mode", ["windowed", "tiled", "stream"])
def test_upscale_folder_to_folder_matches_jax(runs, frames_in, tmp_path, mode):
    jd, td = runs["raw"]
    kw = {"windowed": {}, "tiled": {"tile": 8, "tile_overlap": 4}, "stream": {"stream": True}}[mode]
    shape, _ = tup.upscale(td, str(frames_in), str(tmp_path / "mine"), window_size=2,
                           device="cpu", **kw)
    jshape, _ = jup.upscale(jd, str(frames_in), str(tmp_path / "theirs"), window_size=2, **kw)
    assert shape == tuple(jshape) == (5, 64, 48, 3)
    assert np.abs(_pngs(tmp_path / "mine") - _pngs(tmp_path / "theirs")).max() <= 1


def test_upscale_stream_carries_the_recurrence(runs, frames_in, tmp_path):
    """--stream equals a first / rest chain over the same windows."""
    td = runs["raw"][1]
    clip = np.stack([cv2.imread(str(p))[..., ::-1].astype(np.float32) / 255.0
                     for p in sorted(frames_in.iterdir())])
    model, _ = th.load_test_model(td, device="cpu")
    sink = tup.ArraySink()
    n = tup.upscale_frames(tup.array_source(clip), sink, 2,
                           stream=th.make_stream_forward(model, device="cpu"))
    first, rest = th.make_stream_forward(model, device="cpu")
    padded = np.concatenate([clip, clip[-1:]])[None]
    sr, state = first(padded[:, :2])
    outs = [sr]
    for s in (2, 4):
        sr, state = rest(padded[:, s:s + 2], state)
        outs.append(sr)
    want = torch.cat(outs, 1)[0, :5].clamp(0, 1).numpy()
    assert n == 5
    np.testing.assert_array_equal(sink.frames(), want)


def test_upscale_mp4_to_mp4_matches_jax(runs, tmp_path):
    jd, td = runs["ema"]
    src = tmp_path / "in.mp4"
    video_io.write_video(src, np.random.default_rng(7).random((5, 16, 16, 3), np.float32),
                         fps=10)
    shape, _ = tup.upscale(td, str(src), str(tmp_path / "mine.mp4"), window_size=3,
                           device="cpu")
    jshape, _ = jup.upscale(jd, str(src), str(tmp_path / "theirs.mp4"), window_size=3)
    assert shape == tuple(jshape) == (5, 64, 64, 3)
    mine, _, fps, h, w = video_io.read_video(tmp_path / "mine.mp4")
    theirs = video_io.read_video(tmp_path / "theirs.mp4")[0]
    assert (h, w) == (64, 64) and abs(fps - 10) < 0.5
    # lossy re-encodes of SR frames that agree to 5e-4: equal but for a
    # rare one-step rounding difference that the codec may spread
    assert np.abs(mine - theirs).mean() < 1.0 / 255


def test_upscale_refuses_bad_flags(runs, tmp_path):
    td = runs["raw"][1]
    with pytest.raises(ValueError, match="mutually exclusive"):
        tup.upscale(td, "x", str(tmp_path / "o"), stream=True, tile=8, device="cpu")
    with pytest.raises(ValueError, match="unrecognised output extension"):
        tup.upscale(td, "x", str(tmp_path / "o.xyz"), device="cpu")
    with pytest.raises(ValueError, match="recurrent model"):
        tup.upscale(runs["vrt"][1], "x", str(tmp_path / "o"), stream=True, device="cpu")


def test_iter_windows_pads_the_last_window():
    frames = np.arange(5, dtype=np.float32)[:, None, None, None] * np.ones((5, 2, 3, 3),
                                                                           np.float32)
    wins = list(tup._iter_windows(tup.array_source(frames), 2))
    assert [k for _, k in wins] == [2, 2, 1]
    assert all(w.shape == (1, 2, 2, 3, 3) for w, _ in wins)
    np.testing.assert_array_equal(wins[-1][0][0, :, 0, 0, 0], [4.0, 4.0])
    jwins = list(jup._iter_windows(tup.array_source(frames), 2))
    for (w, k), (jw, jk) in zip(wins, jwins):
        np.testing.assert_array_equal(w, jw)
        assert k == jk


def test_prefetch_raises_the_source_error_and_joins_on_close():
    import threading

    def failing():
        yield 1
        raise IOError("decode failed")

    gen = tup._prefetch(failing())
    assert next(gen) == 1
    with pytest.raises(IOError, match="decode failed"):
        next(gen)

    before = threading.active_count()
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    gen = tup._prefetch(endless(), depth=1)
    assert [next(gen) for _ in range(3)] == [0, 1, 2]
    gen.close()  # stops and joins the worker before returning
    assert threading.active_count() == before
    n = len(produced)
    assert len(produced) == n  # nothing runs after close
