"""Reading the program's spans and counters (``port_bench/spans.py``) on
synthetic captures: the program's ``vsr::`` spans leave every number of
``trace.summarize`` as it was; kernels go to the spans open at their
launch, whichever thread launched them; blocking runtime calls are those
the program makes (not the benchmark's waits), a pageable copy counted
and a pinned one not; idle gaps are named by the innermost program span.
On the card: one traced w4 run whose summary has every key."""

import json
import subprocess
import sys

import pytest

from port_bench import common, readers, spans, trace
from port_bench.harness import Run, Window


class Event:
    def __init__(self, name, device, start, end, corr=0, linked=0, thread=1):
        self._n, self._d, self._s, self._e = name, device, start, end
        self._c, self._l, self._t = corr, linked, thread

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def start_thread_id(self):
        return self._t


class Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda _self: events})()
        self.profiler = type("K", (), {"kineto_results": results})()


# test_pb_trace's capture: a pair kernel in pb::ResidualConv, an add, an
# NCCL broadcast with c10d's host range and its device mirror
EVENTS = [
    Event("pb::ResidualConv", 0, 0, 1000, corr=1),
    Event("cudaLaunchKernel", 0, 100, 200, corr=7),
    Event("aten::add", 0, 1500, 1600, corr=2),
    Event("nccl:broadcast", 0, 1700, 1800, corr=3),
    Event("cudaStreamSynchronize", 0, 1900, 5000, corr=9),
    Event("pair_kernel", 1, 1000, 3000, corr=7),
    Event("pb::ResidualConv", 1, 1000, 3000),
    Event("add_kernel", 1, 2500, 3500, linked=2),
    Event("ncclDevKernel_Broadcast", 1, 4000, 4500, corr=8, linked=3),
    Event("nccl:broadcast", 1, 3500, 4600),
]
# the program's spans over test_pb_trace's capture, and their device mirrors
PROGRAM_SPANS = [
    Event("vsr::harness.forward", 0, 0, 2000, corr=101),
    Event("vsr::model.propagate", 0, 50, 1200, corr=102),
    Event("vsr::harness.forward", 1, 1000, 3600),
    Event("vsr::model.propagate", 1, 1000, 3000),
]


def test_program_spans_leave_the_summary_as_it_was():
    calls = {"ResidualConv": [((1, 8, 8, 64), "bfloat16")]}
    plain = trace.summarize(Prof(EVENTS), 10e-6, 2, calls)
    spanned = trace.summarize(Prof(EVENTS + PROGRAM_SPANS), 10e-6, 2, calls)
    for key in ("busy_s", "window_s", "calls", "nccl_s", "module_s", "module_calls",
                "device_ops", "device_events"):
        assert spanned[key] == plain[key], key
    win = Window(starts=[0.0, 1.0], dispatched=[0.25, 1.5], done=[0.5, 2.0], end=2.0)
    runs = [Run(kind="serve", units=10, chips=1, setup_s=1.0, window=win, traces=[s],
                flops_per_call=1e12, peak_window_bytes=2**31) for s in (plain, spanned)]
    for read in (lambda r: readers.idle_share(r, "serve"),
                 lambda r: readers.pair_roofline(r, "serve"),
                 lambda r: readers.per_call_ms(r, "serve", lambda t: t["nccl_s"]),
                 lambda r: readers.module_ms(r, "serve", "ResidualConv"),
                 lambda r: readers.mfu(r, "serve"), lambda r: readers.peak_gib(r, "serve")):
        assert read(runs[1]) == read(runs[0])


def test_span_seconds_follow_the_launch_across_threads():
    events = [
        Event("vsr::step", 0, 0, 10_000, corr=1),
        Event("vsr::step.backward", 0, 1000, 5000, corr=2),
        # launched by the autograd thread (2) while the caller's thread sits
        # in step.backward; the kernel itself runs after the span closed
        Event("cudaLaunchKernel", 0, 2000, 2100, corr=50, thread=2),
        Event("grad_kernel", 1, 4000, 6000, corr=50),
        Event("cudaLaunchKernel", 0, 7000, 7100, corr=51),
        Event("adam_kernel", 1, 7200, 7700, corr=51),
        Event("cudaLaunchKernel", 0, 11_000, 11_100, corr=52),
        Event("outside_kernel", 1, 11_200, 11_300, corr=52),
    ]
    s = spans.summarize_spans(Prof(events), {})
    assert s["span_s"] == {"step": pytest.approx(2500e-9),
                           "step.backward": pytest.approx(2000e-9)}
    assert s["span_roots"] == ["vsr::step"]


def test_blocking_calls_are_the_programs_and_pageable_copies_count_once():
    events = [
        Event("pb::dispatch", 0, 0, 10_000),
        Event("vsr::model.flow", 0, 100, 5000, corr=1),
        # a blocking copy of a host list: pageable copy, then PyTorch's wait
        Event("cudaMemcpyAsync", 0, 200, 300, corr=10),
        Event("Memcpy HtoD (Pageable -> Device)", 1, 250, 260, corr=10),
        Event("cudaStreamSynchronize", 0, 310, 1310, corr=11),
        # a pinned copy does not block
        Event("cudaMemcpyAsync", 0, 1400, 1420, corr=12),
        Event("Memcpy HtoD (Pinned -> Device)", 1, 1500, 1510, corr=12),
        Event("cudaLaunchKernel", 0, 1430, 1440, corr=13),
        # a wait the program makes on its own
        Event("cudaStreamSynchronize", 0, 2000, 2500, corr=14),
        Event("pb::collect", 0, 10_100, 12_000),
        Event("cudaStreamSynchronize", 0, 10_200, 11_900, corr=15),  # the benchmark's
        Event("cudaStreamSynchronize", 0, 12_500, 12_600, corr=16),  # outside any span
    ]
    s = spans.summarize_spans(Prof(events), {})
    assert s["syncs"] == 2  # the copy with its wait, and the program's own wait
    assert s["sync_s"] == pytest.approx((100 + 1000 + 500) * 1e-9)
    win = Window(starts=[0.0], dispatched=[0.1], done=[0.2], end=0.2)
    run = Run(kind="serve", units=1, chips=1, setup_s=1.0, window=win,
              traces=[{**s, "calls": 2}])
    assert spans.host_syncs(run, "serve") == 1.0
    assert spans.sync_ms(run, "serve") == pytest.approx(0.8e-3)
    assert spans.host_syncs(run, "train") is None


def test_idle_gaps_named_by_the_innermost_program_span():
    events = [
        Event("pb::dispatch", 0, 0, 10_000),
        Event("vsr::harness.windowed_inference", 0, 10, 9000, corr=1),
        Event("vsr::harness.forward", 0, 20, 8000, corr=2),
        Event("vsr::model.flow", 0, 30, 2000, corr=3),
        Event("pb::ResidualConv", 0, 3000, 4000),
        Event("k1", 1, 0, 1000, corr=90),
        Event("k2", 1, 1500, 3500, corr=91),  # gap of 500 from 1000: in model.flow
        Event("k3", 1, 3700, 5000, corr=92),  # gap of 200 from 3500: pb::ResidualConv only
        Event("k4", 1, 8500, 8600, corr=93),  # gap of 3500 from 5000: harness.forward
        Event("k5", 1, 9500, 9600, corr=94),  # gap of 900 from 8600: the entry span
        Event("pb::collect", 0, 10_100, 12_000),
        Event("k6", 1, 11_000, 11_100, corr=95),  # gap of 1400 from 9600: pb::dispatch
        Event("k7", 1, 13_000, 13_100, corr=96),  # gap of 1900 from 11_100: pb::collect
    ]
    s = spans.summarize_spans(Prof(events), {})
    assert s["span_idle_s"] == {
        "vsr::harness.forward": pytest.approx(3700e-9),
        "pb::collect": pytest.approx(1900e-9),
        "pb::dispatch": pytest.approx(1400e-9),
        "vsr::harness.windowed_inference": pytest.approx(900e-9),
        "vsr::model.flow": pytest.approx(500e-9),
    }
    inside, below = spans.dispatch_idle(s)
    assert inside == pytest.approx(6500e-9) and below == pytest.approx(4200e-9)
    assert spans.idle_line(s).startswith("idle by span: vsr::harness.forward 0.000004")


def test_counters_and_a_program_without_spans(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    from vsrlab_tpu_torch.utils import profiler

    before = spans.program_counters()
    assert spans.summarize_spans(Prof(EVENTS), before) == {"counters": {}}
    with profile(activities=[ProfilerActivity.CPU]):
        profiler.count("comm_bytes", 4_000_000)
    s = spans.summarize_spans(Prof(EVENTS), before)
    assert s == {"counters": {"comm_bytes": 4_000_000}}
    run = Run(kind="serve", units=1, chips=1, setup_s=1.0,
              window=Window(starts=[0.0], dispatched=[0.1], done=[0.2], end=0.2),
              traces=[{**s, "calls": 2, "nccl_s": 0.002}])
    assert spans.comm_gbps(run, "serve") == pytest.approx(2.0)
    for name, (_, read) in spans.READINGS.items():
        if not name.startswith("comm_gbps"):
            assert read(run) is None, name
    # a program with no counter registry (the parent's, say): no key, no reading
    monkeypatch.setattr(spans, "program_counters", lambda: None)
    s = spans.summarize_spans(Prof(EVENTS), None)
    assert s == {}
    run.traces = [{**s, "calls": 2, "nccl_s": 0.002}]
    assert all(read(run) is None for _, read in spans.READINGS.values())


@pytest.mark.cuda
def test_a_traced_w4_run_has_every_key(card):
    out = subprocess.run([sys.executable, str(common.BENCH_DIR / "spans.py"), "--workload",
                          "rbvsr.serve.w4", "--seed", str(2**31 + 7), "--seconds", "2"],
                         capture_output=True, text=True, cwd=str(common.ROOT), timeout=900,
                         check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    summary = got["summaries"][0]
    for key in ("span_s", "sync_s", "syncs", "counters", "span_idle_s", "span_roots"):
        assert key in summary, key
    assert "idle by span: vsr::" in out.stderr
    assert all(v is not None for v in got["readings"].values()), got["readings"]
