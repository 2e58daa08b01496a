"""The port's spans and counters (``vsrlab_tpu_torch.utils.profiler``) on
the CPU: with no profiler running a span is one shared no-op and a count
changes nothing; under ``torch.profiler`` the serving entry points, the
models and the train step record their ``vsr::`` spans, each child inside
its parent, and the windows' gather counts its broadcasts' bytes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from vsrlab_tpu_torch.evaluation import harness  # noqa: E402
from vsrlab_tpu_torch.models import RealBasicVSR, TinyVRT  # noqa: E402
from vsrlab_tpu_torch.utils import profiler  # noqa: E402

SERVE_SPANS = {  # child -> parent
    "harness.split": "harness.windowed_inference",
    "harness.forward": "harness.windowed_inference",
    "harness.upload": "harness.forward",
    "model.clean": "harness.forward",
    "model.flow": "harness.forward",
    "model.propagate": "harness.forward",
    "model.upsample": "harness.forward",
}
VRT_SPANS = {
    "harness.upload": "harness.forward",
    "model.flow": "harness.forward",
    "model.align": "harness.forward",
    "model.stages": "harness.forward",
    "model.upsample": "harness.forward",
}
STEP_SPANS = {
    "step.forward": "step",
    "step.backward": "step",
    "step.metrics": "step",
    "step.grad_reduce": "step",
    "step.update": "step",
    "step.ema": "step",
    "model.clean": "step.forward",
    "model.flow": "step.forward",
    "model.propagate": "step.forward",
    "model.upsample": "step.forward",
}


def spans_of(prof):
    """``{name: [(start, end), ...]}`` of the capture's ``vsr::`` spans."""
    out = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(profiler.SPAN_PREFIX):
            out.setdefault(ev.name()[len(profiler.SPAN_PREFIX):], []).append(
                (ev.start_ns(), ev.end_ns()))
    return out


def assert_nested(spans, tree, roots):
    assert set(tree) | set(roots) <= set(spans), sorted(spans)
    for child, parent in tree.items():
        for s, e in spans[child]:
            assert any(ps <= s and e <= pe for ps, pe in spans[parent]), (child, parent)
    return spans


def tiny_realbasicvsr():
    torch.manual_seed(0)
    return RealBasicVSR(mid_channels=8, res_blocks=1, cleaning_blocks=1)


def test_a_span_with_no_profiler_is_a_shared_noop(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    span = profiler.annotate("harness.forward")
    assert span is profiler.annotate("step")
    with span:
        pass
    before = profiler.counters()
    profiler.count("comm_bytes", 1 << 20)
    assert profiler.counters() == before


def test_windowed_inference_records_the_harness_and_model_spans():
    forward = harness.make_forward(tiny_realbasicvsr(), device="cpu")
    clip = np.random.default_rng(0).random((1, 5, 16, 16, 3)).astype(np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sr, n = harness.windowed_inference(forward, clip, 2)
    assert n == 3 and sr.shape == (1, 5, 64, 64, 3)
    spans = assert_nested(spans_of(prof), SERVE_SPANS, ["harness.windowed_inference"])
    assert len(spans["harness.windowed_inference"]) == 1
    assert len(spans["harness.forward"]) == len(spans["model.flow"]) == 1
    # the same call with no profiler: no span, and the same frames
    sr_off, _ = harness.windowed_inference(forward, clip, 2)
    assert torch.equal(sr, sr_off)


def test_vrt_forward_records_its_stages():
    torch.manual_seed(0)
    model = TinyVRT(upscale=4, window_size=(2, 4, 4), depths=(1,) * 7, embed_dims=(8,) * 7,
                    num_heads=(2,) * 7, deformable_groups=2)
    forward = harness.make_forward(model, device="cpu")
    clip = np.random.default_rng(1).random((1, 2, 16, 16, 3)).astype(np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sr = forward(clip)
    assert sr.shape == (1, 2, 64, 64, 3)
    assert_nested(spans_of(prof), VRT_SPANS, ["harness.forward"])


def test_train_step_records_its_phases():
    from vsrlab_tpu_torch.train.builders import build_tx
    from vsrlab_tpu_torch.train.state import create_train_state
    from vsrlab_tpu_torch.train.step import make_supervised_train_step

    model = tiny_realbasicvsr().train()
    tx = build_tx(model.parameters(), ("adam", {"lr": 1e-4}), None, grad_clip=1.0)
    state = create_train_state(model, tx, ema_decay=0.999)
    step = make_supervised_train_step(model, ema_decay=0.999)
    g = torch.Generator().manual_seed(2)
    batch = {"lr": torch.rand(2, 3, 8, 8, 3, generator=g),
             "hr": torch.rand(2, 3, 32, 32, 3, generator=g)}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, metrics = step(state, batch)
    assert state.step == 1 and bool(torch.isfinite(metrics["Loss"]))
    spans = assert_nested(spans_of(prof), STEP_SPANS, ["step"])
    assert len(spans["step"]) == 1


def test_gather_counts_its_bytes_while_a_profiler_collects(tmp_path):
    import torch.distributed as dist

    from vsrlab_tpu_torch.parallel import Mesh

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = Mesh(("time",), (1,), 0, {"time": dist.group.WORLD})
        local = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)
        before = profiler.counters().get("comm_bytes", 0)
        assert torch.equal(harness._gather_windows(local, mesh), local)
        assert profiler.counters().get("comm_bytes", 0) == before
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            full = harness._gather_windows(local, mesh)
        assert torch.equal(full, local)
        assert profiler.counters()["comm_bytes"] - before == local.numel() * 4
        assert "harness.gather" in spans_of(prof)
    finally:
        dist.destroy_process_group()
