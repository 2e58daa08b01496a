"""BasicVSR++ in the port (``vsrlab_tpu_torch.models.basicvsr_pp``) on the
CPU, held against the benchmark's plain float32 reference
(``port_bench/reference/basicvsr_pp.py``, which imports nothing of the
port) on seeded random weights: the forward, the second-order alignment
alone, one supervised train step's gradients, the serving entry points
built from ``conf/train/model/basicvsr_pp.yaml``, the published widths'
parameters, the spans and counters, and the benchmark cell's comparison.

Small size: 32 channels, 2 units a branch, 16 offset groups, 5 frames of
32x48, so that every branch runs its second-order step (k >= 2).
Tolerance: fp32 on both sides; they part only by the order of fp32 sums
(PyTorch's convolutions against the program's, the per-tap products
against one einsum a tap, the plain sampler against ``grid_sample``),
carried through four recurrent branches: ~2e-7 of outputs near 1, so
atol 2e-5 (the RealBasicVSR reference test's) leaves a hundredfold room.
"""

import copy
import math
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from port_bench.common import load_cell, seeded_params  # noqa: E402
from port_bench.harness import Ranks, hooked_classes, run_cell  # noqa: E402
from port_bench.reference import basicvsr_pp as ref  # noqa: E402
from port_bench.reference import train as ref_train  # noqa: E402
from port_bench.reference.layers import exact  # noqa: E402
from vsrlab_tpu_torch.models import BasicVSRPlusPlus  # noqa: E402
from vsrlab_tpu_torch.models.vrt.deform import SecondOrderDeformableAlignment  # noqa: E402
from vsrlab_tpu_torch.utils import profiler  # noqa: E402

ATOL = 2e-5
SMALL = dict(mid_channels=32, num_blocks=2, deform_groups=16, upscale=4,
             max_residue_magnitude=10.0)
CLIP = (1, 5, 32, 48, 3)
SEED = 2**35 + 11


def _model(widths=SMALL, seed=SEED, dtype=None):
    model = BasicVSRPlusPlus(**widths, dtype=dtype)
    p = seeded_params(ref.param_shapes(**widths), seed, "cpu", ref.fan_in)
    model.load_state_dict(p)
    return model, p


def _clip(shape=CLIP, seed=0):
    return torch.rand(shape, generator=torch.Generator().manual_seed(seed))


def test_forward_matches_the_reference():
    model, p = _model()
    x = _clip()
    with torch.no_grad():
        sr = model(x)
        want, lq = ref.forward(p, x, **SMALL)
    assert sr.shape == want.shape == (1, 5, 128, 192, 3)
    assert torch.equal(lq, x)
    assert torch.allclose(sr, want, atol=ATOL, rtol=0), float((sr - want).abs().max())


def test_a_single_frame_propagates_without_alignment():
    model, p = _model()
    x = _clip((1, 1, 32, 48, 3), 1)
    with torch.no_grad():
        assert torch.allclose(model(x), ref.forward(p, x, **SMALL)[0], atol=ATOL, rtol=0)


def _align_case():
    g = torch.Generator().manual_seed(4)
    c, h, w = 32, 12, 16
    mod = SecondOrderDeformableAlignment(2 * c, c, 16, 10.0)
    shapes = {k: tuple(v.shape) for k, v in mod.state_dict().items()}
    p = seeded_params(shapes, SEED + 1, "cpu", ref.fan_in)
    mod.load_state_dict(p)
    x, cond = torch.rand(2, h, w, 2 * c, generator=g), torch.rand(2, h, w, 3 * c, generator=g)
    f1 = 3.0 * torch.randn(2, h, w, 2, generator=g)
    f2 = 3.0 * torch.randn(2, h, w, 2, generator=g)
    return mod, {f"a.{k}": v for k, v in p.items()}, x, cond, f1, f2


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def test_second_order_alignment_matches_the_reference_and_splits_its_priors():
    mod, p, x, cond, f1, f2 = _align_case()
    with torch.no_grad():
        got = mod(x, cond, f1, f2)
        want = ref.second_order_align(p, "a", _nchw(x), _nchw(cond), _nchw(f1), _nchw(f2), 10.0,
                                      exact)
        swapped = mod(x, cond, f2, f1)
    assert got.shape == (2, 12, 16, 32)
    assert torch.allclose(got, want.permute(0, 2, 3, 1), atol=ATOL, rtol=0)
    # the first half of the groups takes f1 and the second f2: swapping them moves the output
    assert float((swapped - got).abs().max()) > 0.05


def test_the_offset_head_starts_at_zero():
    mod = SecondOrderDeformableAlignment(64, 32, 16, 10.0)
    assert mod.conv_offset_3.weight.abs().max() == 0 and mod.conv_offset_3.bias.abs().max() == 0
    assert mod.weight.shape == (3, 3, 64, 32)


def test_train_step_gradients_match_the_reference_with_spynet_frozen():
    from vsrlab_tpu_torch.train.builders import build_tx
    from vsrlab_tpu_torch.train.state import create_train_state
    from vsrlab_tpu_torch.train.step import make_supervised_train_step

    widths = dict(SMALL, mid_channels=16, num_blocks=1, deform_groups=4)
    model, p0 = _model(widths)
    model.train()
    tx = build_tx(model.parameters(), ("adam", {"lr": 1e-3, "betas": (0.9, 0.99)}), None,
                  grad_clip=1e9)
    state = create_train_state(model, tx)
    step = make_supervised_train_step(model, compute_metrics=False)
    g = torch.Generator().manual_seed(5)
    hr = torch.rand(2, 4, 64, 64, 3, generator=g)
    lr = torch.rand(2, 4, 16, 16, 3, generator=g)
    _, metrics = step(state, {"lr": lr, "hr": hr})
    grads = {n: (q.grad if q.grad is not None else torch.zeros_like(q))
             for n, q in model.named_parameters()}

    params = {k: v.clone().requires_grad_(not ref.frozen(k, **widths)) for k, v in p0.items()}
    names = list(params)
    loss, want = ref_train.accumulated_grads(lambda q, x: ref.forward(q, x, **widths), params,
                                             names, lr, hr, rows=2)
    # the reference's loss adds a constant, the cleaning term of its lq (the input itself)
    const = float(ref_train.supervised_loss((hr, lr), hr) - ref_train.charbonnier(hr, hr))
    assert abs(float(metrics["Loss"]) - (loss - const)) < 1e-5 * loss
    scale = max(float(g.abs().max()) for g in want)
    for name, w in zip(names, want):
        if ref.frozen(name, **widths):
            assert float(grads[name].abs().max()) == 0.0, name
            continue
        assert torch.allclose(grads[name], w, atol=1e-5 * scale, rtol=1e-4), name
    assert any(float(grads[n].abs().max()) > 0 for n in names if n.startswith("deform_align"))


def _yaml_model_config(**over):
    from pathlib import Path

    from vsrlab_tpu_torch.core.config import _load_yaml, _resolve_interpolations

    cfg, _ = _load_yaml(Path(__file__).resolve().parents[1] / "conf/train/model/basicvsr_pp.yaml")
    root = type(cfg).from_dict({"train": {"model": cfg, "precision": "fp32",
                                          "data": {"datasets": {"train": {"scale": 4}}}}})
    _resolve_interpolations(root)
    root.train.model.update(over)
    return root


def test_the_config_names_the_published_widths():
    m = _yaml_model_config().train.model
    assert (m["_target_"], m["mid_channels"], m["num_blocks"], m["deform_groups"],
            m["max_residue_magnitude"], m["upscale"], m["train_flow"]) == \
        ("BasicVSRPlusPlus", 64, 7, 16, 10, 4, False)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A run directory of the small model built from the config file."""
    import vsrlab_tpu_torch.components  # noqa: F401
    from vsrlab_tpu_torch.core.checkpoint import CheckpointManager
    from vsrlab_tpu_torch.train.builders import build_model

    cfg = _yaml_model_config(mid_channels=32, num_blocks=2)
    model = build_model(cfg.train.model, "fp32")
    assert isinstance(model, BasicVSRPlusPlus)
    p = seeded_params(ref.param_shapes(**SMALL), SEED, "cpu", ref.fan_in)
    model.load_state_dict(p)
    d = tmp_path_factory.mktemp("bvpp_run")
    CheckpointManager(str(d)).save(0, model.state_dict(), config=cfg.to_dict())
    return str(d), p


def test_make_forward_and_windowed_inference_serve_it(run_dir):
    from vsrlab_tpu_torch.evaluation import harness

    d, p = run_dir
    model, _ = harness.load_test_model(d, device="cpu")
    forward = harness.make_forward(model, device="cpu")
    x = _clip((1, 6, 32, 48, 3), 2)
    with torch.no_grad():
        want = torch.cat([ref.forward(p, x[:, s:s + 3], **SMALL)[0] for s in (0, 3)], 1)
        assert torch.allclose(forward(x), ref.forward(p, x, **SMALL)[0], atol=ATOL, rtol=0)
    sr, n = harness.windowed_inference(forward, x.numpy(), 3)
    assert n == 2 and torch.allclose(sr, want, atol=ATOL, rtol=0)
    _, scores = harness.evaluate_video(forward, x.numpy(), want.clamp(0, 1).numpy(), 3, ("PSNR",))
    assert scores["PSNR"] > 80


def test_the_upscale_cli_serves_it_and_refuses_streaming(run_dir, tmp_path):
    cv2 = pytest.importorskip("cv2")
    from vsrlab_tpu_torch.evaluation import upscale

    d, p = run_dir
    frames = tmp_path / "in"
    frames.mkdir()
    rng = np.random.default_rng(6)
    clip = (rng.random((4, 32, 48, 3)) * 255).astype(np.uint8)
    for i, f in enumerate(clip):
        cv2.imwrite(str(frames / f"f{i:03d}.png"), f[..., ::-1])
    out = tmp_path / "out"
    upscale.main(["--cfg-dir", d, "--input", str(frames), "--output", str(out),
                  "--window-size", "4", "--device", "cpu"])
    got = np.stack([cv2.imread(str(f))[..., ::-1] for f in sorted(out.glob("img*.png"))])
    with torch.no_grad():
        want = ref.forward(p, torch.from_numpy(clip[None].astype(np.float32) / 255.0),
                           **SMALL)[0][0]
    want = (want.clamp(0, 1) * 255).round().numpy()
    assert got.shape == (4, 128, 192, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    with pytest.raises(ValueError, match="streaming state"):
        upscale.main(["--cfg-dir", d, "--input", str(frames), "--output", str(tmp_path / "s"),
                      "--stream", "--device", "cpu"])


def test_refused_modes():
    model, _ = _model()
    x = _clip()
    with pytest.raises(ValueError, match="streaming state"):
        model(x, return_state=True)
    with pytest.raises(ValueError, match="streaming state"):
        model(x, stream_state=(x[:, -1], None))
    with pytest.raises(ValueError, match="time_shard_axis"):
        BasicVSRPlusPlus(**SMALL, time_shard_axis="time")


def test_published_widths_count_7_3m_parameters_by_the_programs_names():
    widths = load_cell("bvpp.serve.c100").config["model"]
    shapes = ref.param_shapes(**widths)
    model = BasicVSRPlusPlus(**widths)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == shapes
    assert list(model.state_dict()) == list(shapes)
    assert sum(math.prod(s) for s in shapes.values()) == 7_322_927
    assert ref.fan_in("deform_align.forward_2.weight", shapes["deform_align.forward_2.weight"]) \
        == 3 * 3 * 128
    assert all(ref.frozen(k) == k.startswith("spynet.") for k in shapes)


def _spans(prof):
    out = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(profiler.SPAN_PREFIX):
            out.setdefault(ev.name()[len(profiler.SPAN_PREFIX):], []).append(
                (ev.start_ns(), ev.end_ns()))
    return out


def test_a_profiled_forward_opens_each_span_once_and_counts_the_alignments():
    from torch.profiler import ProfilerActivity, profile

    model, _ = _model()
    x = _clip()
    t = x.shape[1]
    before = profiler.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.no_grad():
        model(x)
    spans = _spans(prof)
    stages = ("model.extract", "model.flow", "model.propagate", "model.upsample")
    branches = tuple(f"model.propagate.{b}" for b in ("backward_1", "forward_1", "backward_2",
                                                       "forward_2"))
    for name in stages + branches:
        assert len(spans[name]) == 1, (name, spans.get(name))
    (ps, pe), = spans["model.propagate"]
    assert all(ps <= spans[b][0][0] and spans[b][0][1] <= pe for b in branches)
    after = profiler.counters()
    calls = 4 * (t - 1)
    assert after.get("align.calls", 0) - before.get("align.calls", 0) == calls
    h, w = x.shape[2:4]
    samples = calls * h * w * 2 * SMALL["mid_channels"] * 9
    assert after.get("deform.samples", 0) - before.get("deform.samples", 0) == samples


def test_with_no_profiler_nothing_is_counted():
    model, _ = _model()
    before = profiler.counters()
    with torch.no_grad():
        model(_clip())
    assert profiler.counters() == before


def _small_cell(name="bvpp.serve.c100", precision="bf16"):
    cell = load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["precision"] = precision
    cell.config["model"].update(mid_channels=32, num_blocks=2)
    cell.traffic = {**cell.traffic, "frames": 5, "height": 32, "width": 48}
    return cell


@pytest.mark.parametrize("fault", ["none", "alter", "control"])
def test_the_cells_comparison_fails_the_fp8_control_and_alter(fault):
    """The cell's own limits at the small size, the program in bf16: a sound
    run passes, the reference in float8 in the program's place and a shifted
    frame do not."""
    torch.manual_seed(0)
    out = run_cell(_small_cell(), Ranks(0, 1, torch.device("cpu")), 2**33 + 23, 0.2, False,
                   time.perf_counter(), fault)
    checks = {k: (v["value"], v["limit"]) for k, v in out["checks"].items()}
    assert set(checks) == {"rel_rms", "max_abs"}
    assert out["correct"] == (fault == "none"), checks


def test_the_traced_run_hooks_the_pair_and_the_alignment():
    cell = load_cell("bvpp.serve.c100")
    assert hooked_classes(cell) == ("ResidualConv", "SecondOrderDeformableAlignment")
    assert [m.name for m in cell.metrics] == [
        "frames_per_s", "setup_s", "dispatch_ms.serve", "pair_roofline.serve",
        "idle_share.serve", "peak_gib.serve", "mfu.serve", "align_ms.bvpp"]
    b96 = load_cell("rbvsr.train.b96")
    assert b96.traffic["batch"] == 96 and hooked_classes(b96) == ("ResidualConv",)


def test_the_reference_counts_its_work_on_meta():
    from port_bench import work

    one = work.forward_flops(ref, SMALL, (1, 5, 32, 48, 3))
    two = work.forward_flops(ref, SMALL, (2, 5, 32, 48, 3))
    assert one > 0 and math.isclose(two, 2 * one, rel_tol=1e-9)
    # one more unit a branch: one residual pair at every frame of each of the four branches
    more = work.forward_flops(ref, {**SMALL, "num_blocks": 3}, (1, 5, 32, 48, 3))
    pair = work.pair_work((5, 32, 48, SMALL["mid_channels"]), "float32")[0]
    assert math.isclose(more - one, 4 * pair, rel_tol=1e-9)


def test_the_graphed_alignment_runs_eagerly_off_the_card_and_copies_without_graphs():
    """On the CPU the alignment's graph helper calls the eager alignment
    itself and keeps nothing; a deep copy or a pickle of the model has a
    helper of its own, bound to the copy's alignment."""
    import pickle

    model, _ = _model()
    x = _clip((1, 3, 16, 24, 3))
    with torch.no_grad():
        want = model(x)
        for twin in (copy.deepcopy(model), pickle.loads(pickle.dumps(model))):
            align = twin.deform_align["forward_1"]
            assert align._graphed.owner is align and align._graphed.fn.__self__ is align
            assert torch.equal(twin(x), want)
    assert all(len(m._graphed) == 0 for m in model.deform_align.values())


def test_recording_collects_counts_with_no_profiler():
    before = profiler.counters()
    with profiler.recording() as outer:
        profiler.count("test.outer", 2)
        with profiler.recording() as inner:
            profiler.count("test.inner", 3)
    profiler.count("test.after", 1)
    assert outer == {"test.outer": 2, "test.inner": 3} and inner == {"test.inner": 3}
    assert profiler.counters() == before
