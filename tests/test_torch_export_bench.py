"""The port's export, parameter / speed bench and profiler against the JAX
package's, on the CPU.

The exported ``.pt2`` program (RealBasicVSR at mid 8, one block, a 3-frame
8x8 window) must equal the eager forward exactly (on the CPU both run the
plain versions of the same ops), keep the pair as the ``vsrlab::`` custom
op, and lie within fp32 atol 5e-4 of the JAX artifact's output for the
same params. The custom ops pass ``torch.library.opcheck``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from vsrlab_tpu.core.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from vsrlab_tpu.evaluation import export as jexport  # noqa: E402
from vsrlab_tpu.evaluation.params_bench import param_count as jparam_count  # noqa: E402
from vsrlab_tpu.models import RealBasicVSR as JRealBasicVSR  # noqa: E402
from vsrlab_tpu_torch import convert  # noqa: E402
from vsrlab_tpu_torch.evaluation import export, params_bench  # noqa: E402
from vsrlab_tpu_torch.evaluation import upscale as tup  # noqa: E402
from vsrlab_tpu_torch.evaluation.harness import load_test_model, make_forward  # noqa: E402
from vsrlab_tpu_torch.ops import bilinear_sample, packed_gather, residual_pair  # noqa: E402
from vsrlab_tpu_torch.utils import profiler  # noqa: E402

ATOL = 5e-4
SHAPE = (1, 3, 8, 8, 3)


class Upsample(torch.nn.Module):
    def forward(self, clip):
        return clip.repeat_interleave(4, 2).repeat_interleave(4, 3)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX and port run directories of the same params, both artifacts (the
    port's written by the CLI), and the port's loaded once."""
    root = tmp_path_factory.mktemp("export")
    jmodel = JRealBasicVSR(mid_channels=8, res_blocks=1, cleaning_blocks=1)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                                             jnp.zeros(SHAPE))["params"])
    cfg = {"train": {"model": {"_target_": "RealBasicVSR", "mid_channels": 8, "res_blocks": 1,
                               "cleaning_blocks": 1}, "precision": "fp32"}}
    mgr = JCheckpointManager(str(root / "jax"))
    mgr.save(0, params, config=cfg)
    mgr.close()
    convert.write_run_dir(root / "torch", params, cfg)
    jart, art = root / "m.jaxexp", root / "m.pt2"
    jexport.export_model(str(root / "jax"), str(jart), window_size=3, height=8, width=8)
    n = export.main(["--cfg-dir", str(root / "torch"), "--output", str(art), "--window-size",
                     "3", "--height", "8", "--width", "8", "--device", "cpu"])
    forward, shape = export.load_exported_forward(str(art))
    return {"params": params, "art": art, "jart": jart, "size": n, "dir": str(root / "torch"),
            "forward": forward, "shape": shape, "program": torch.export.load(str(art))}


def test_export_round_trip_equals_eager_and_jax(run):
    assert run["shape"] == SHAPE
    clip = np.random.default_rng(0).random(SHAPE, np.float32)
    got = run["forward"](clip)
    model, _ = load_test_model(run["dir"], device="cpu")
    torch.testing.assert_close(got, make_forward(model, device="cpu")(clip), rtol=0, atol=0)
    want = np.asarray(jexport.load_exported(str(run["jart"]))(jnp.asarray(clip)))
    assert got.shape == want.shape == (1, 3, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_exported_graph_calls_the_custom_op(run):
    targets = [str(n.target) for n in run["program"].graph.nodes if n.op == "call_function"]
    # one taps pair a unit: 2 directions x 3 frames x 1 block, and the cleaner's
    # 3 steps x 1 block over the 3 frames as one batch
    assert targets.count("vsrlab.residual_conv_pair.default") == 2 * 3 + 3
    residual_pair.reset_launch_counts()
    run["forward"](np.zeros(SHAPE, np.float32))
    assert residual_pair.residual_conv_pair.launches == 0  # the CPU runs the plain version


def test_upscale_artifact_equals_cfg_dir(run, tmp_path):
    rng = np.random.default_rng(1)
    frames = tmp_path / "frames"
    frames.mkdir()
    for i in range(4):
        cv2.imwrite(str(frames / f"f{i:03d}.png"), (rng.random((8, 8, 3)) * 255).astype(np.uint8))
    shape_a, _ = tup.upscale(None, str(frames), str(tmp_path / "art"), window_size=2,
                             artifact=str(run["art"]), device="cpu")
    shape_m, _ = tup.upscale(run["dir"], str(frames), str(tmp_path / "mdl"), window_size=3,
                             device="cpu")
    assert shape_a == shape_m == (4, 32, 32, 3)
    for i in range(4):
        a = cv2.imread(str(tmp_path / "art" / f"img{i:05d}.png"))
        m = cv2.imread(str(tmp_path / "mdl" / f"img{i:05d}.png"))
        np.testing.assert_array_equal(a, m)


def test_artifact_refuses_incompatible_flags_and_shapes(run, tmp_path):
    for flags in ({"stream": True}, {"tile": 4}, {"align_chunks": 2}):
        with pytest.raises(ValueError, match="fixed-shape"):
            tup.upscale(None, "x", str(tmp_path / "o"), artifact=str(run["art"]), device="cpu",
                        **flags)
    frames = tmp_path / "wrong_size"
    frames.mkdir()
    cv2.imwrite(str(frames / "f0.png"), np.zeros((16, 16, 3), np.uint8))
    with pytest.raises(ValueError, match="exported at 8x8"):
        tup.upscale(None, str(frames), str(tmp_path / "o2"), artifact=str(run["art"]),
                    device="cpu")
    batched = tmp_path / "b2.pt2"  # a stand-in model: only the input shape matters
    export.export_module(Upsample(), str(batched), (2, 3, 8, 8, 3), "cpu")
    with pytest.raises(ValueError, match="batch=2"):
        tup.upscale(None, str(frames), str(tmp_path / "o3"), artifact=str(batched),
                    device="cpu")


def test_export_cli(run):
    """The fixture's artifact is the CLI's: its size is what the CLI returned."""
    assert run["art"].stat().st_size == run["size"] > 0


def _pair_args(c=8, fragments=False):
    rng = np.random.default_rng(2)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s, np.float32))  # noqa: E731
    args = [t(2, 5, 6, c), t(3, 3, c, c), t(c), t(3, 3, c, c), t(c)]
    if fragments:
        args += [torch.zeros(36, 4, 32, 4, dtype=torch.int32)] * 2
    return tuple(args)


@pytest.mark.parametrize("case", ["taps", "taps_fragments", "im2col", "sampler_zeros",
                                  "sampler_border", "gather"])
def test_custom_ops_pass_opcheck(case):
    rng = np.random.default_rng(3)
    if case.startswith("taps"):
        op, args = residual_pair._taps_op, _pair_args(fragments=case == "taps_fragments")
    elif case == "im2col":
        op, args = residual_pair._im2col_op, _pair_args()
    elif case.startswith("sampler"):
        x = torch.from_numpy(rng.random((2, 5, 7, 3), np.float32))
        ix = torch.from_numpy(rng.uniform(-2, 8, (2, 11)).astype(np.float32))
        iy = torch.from_numpy(rng.uniform(-2, 6, (2, 11)).astype(np.float32))
        op, args = bilinear_sample._sample_op, (x, ix, iy, case == "sampler_zeros")
    else:
        xf = torch.from_numpy(rng.random((2, 9, 16), np.float32))
        idx = torch.from_numpy(rng.integers(0, 9, (2, 13)).astype(np.int32))
        op, args = packed_gather._gather_op, (xf, idx)
    torch.library.opcheck(op, args)


def test_custom_ops_equal_the_wrappers_on_the_cpu():
    args = _pair_args()
    torch.testing.assert_close(torch.ops.vsrlab.residual_conv_pair(*args),
                               residual_pair.residual_conv_pair(*args), rtol=0, atol=0)
    torch.testing.assert_close(torch.ops.vsrlab.residual_conv_pair_im2col(*args),
                               residual_pair.residual_conv_pair_im2col(*args), rtol=0, atol=0)


def test_param_count_matches_jax(run):
    model, _ = load_test_model(run["dir"], device="cpu")
    assert params_bench.param_count(model) == jparam_count(run["params"])


def test_speed_bench_and_run(run, tmp_path):
    model, _ = load_test_model(run["dir"], device="cpu")
    stats = params_bench.speed_bench(model, (1, 2, 8, 8, 3), n_iters=1, device="cpu")
    assert set(stats) == {"avg_time", "frames_per_sec", "params"}
    assert stats["avg_time"] > 0 and stats["frames_per_sec"] == pytest.approx(2 / stats["avg_time"])
    out = tmp_path / "bench.csv"
    rows = params_bench.main([run["dir"], "--out", str(out), "--batch", "2", "--window-size",
                              "2", "--height", "8", "--width", "8", "--device", "cpu"])
    assert rows[0]["batch"] == 2 and rows[0]["params"] == stats["params"]
    assert out.read_text().splitlines()[0] == "model,batch,avg_time,frames_per_sec,params"


def test_timer_and_best_time():
    calls, seen = [], []
    best = profiler.best_time(lambda n: calls.append(n), n_iters=4, repeats=2, on_best=seen.append)
    assert calls == [1, 4, 4] and len(seen) == 3 and best >= 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiler.trace(str(tmp_path)) as prof:
        with profiler.annotate("vsr_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    assert "vsr::vsr_span" in json.dumps(json.loads(files[0].read_text()))
