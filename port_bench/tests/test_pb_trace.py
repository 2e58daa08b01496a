"""Reading a profiler capture: busy time as a union, the device-side copies
of host ranges left out, kernels given to the module whose range holds
their launch, idle gaps named by the host span open when they begin."""

import pytest

from port_bench import readers, trace
from port_bench.harness import Run, Window


class Event:
    def __init__(self, name, device, start, end, corr=0, linked=0):
        self._n, self._d, self._s, self._e = name, device, start, end
        self._c, self._l = corr, linked

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


class Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda _self: events})()
        self.profiler = type("K", (), {"kineto_results": results})()


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


def test_summary():
    s = trace.summarize(Prof(EVENTS), 10e-6, 2, {"ResidualConv": [((1, 8, 8, 64), "bfloat16")]})
    assert s["busy_s"] == pytest.approx(3000e-9)  # [1000, 3500) and [4000, 4500)
    assert s["nccl_s"] == pytest.approx(500e-9)  # the kernel, not the mirror
    assert s["module_s"] == {"ResidualConv": pytest.approx(2000e-9)}
    assert [op for op, _ in s["device_ops"]] == ["pair_kernel", "add_kernel",
                                                 "ncclDevKernel_Broadcast"]
    assert s["idle_gaps"] == [("cudaStreamSynchronize", pytest.approx(500e-9))]


def test_readers_on_a_summary():
    s = trace.summarize(Prof(EVENTS), 10e-6, 2, {"ResidualConv": [((1, 8, 8, 64), "bfloat16")]})
    win = Window(starts=[0.0, 1.0], dispatched=[0.25, 1.5], done=[0.5, 2.0], end=2.0)
    run = Run(kind="serve", units=10, chips=1, setup_s=1.0, window=win, traces=[s],
              flops_per_call=989e12 * 0.1, peak_window_bytes=2**31)
    assert readers.rate(run, "serve") == pytest.approx(10.0)
    assert readers.rate(run, "train") is None
    assert readers.dispatch_ms(run, "serve") == pytest.approx(375.0)
    assert readers.latency_ms(run, 90.0) == pytest.approx(950.0)
    assert readers.idle_share(run, "serve") == pytest.approx(70.0)
    assert readers.per_call_ms(run, "serve", lambda t: t["nccl_s"]) == pytest.approx(250e-6)
    assert readers.mfu(run, "serve") == pytest.approx(10.0)
    assert readers.peak_gib(run, "serve") == pytest.approx(2.0)
    from port_bench.work import least_seconds, pair_work

    least = least_seconds(*pair_work((1, 8, 8, 64), "bfloat16"), "bfloat16")
    assert readers.pair_roofline(run, "serve") == pytest.approx(100 * least / 2000e-9)


def test_a_reader_with_nothing_to_read_returns_none():
    s = trace.summarize(Prof([]), 1.0, 1, {})
    run = Run(kind="serve", units=1, chips=1, setup_s=1.0,
              window=Window(starts=[0.0], dispatched=[0.1], done=[0.2], end=0.2), traces=[s])
    assert readers.pair_roofline(run, "serve") is None
    assert readers.module_ms(run, "serve", "WindowAttention") is None
    assert readers.idle_share(run, "serve") is None
    assert readers.mfu(run, "serve") is None
