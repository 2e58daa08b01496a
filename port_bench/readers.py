"""Arithmetic the metric readers share. Each reader takes the run's record
(:class:`port_bench.harness.Run`) and returns a number, or None where the
run has nothing for it to read."""

from __future__ import annotations

from typing import Optional

from port_bench.common import percentile
from port_bench.work import PEAK_FLOPS, least_seconds, pair_work


def rate(run, kind: str) -> Optional[float]:
    """Units delivered over the whole window's seconds."""
    if run.kind != kind or not run.window.calls:
        return None
    return run.units * run.window.calls / run.window.seconds


def latency_ms(run, pct: float) -> Optional[float]:
    """A percentile of every request's latency in the window."""
    if run.kind != "serve" or not run.window.calls:
        return None
    w = run.window
    return 1e3 * percentile([d - s for s, d in zip(w.starts, w.done)], pct)


def dispatch_ms(run, kind: str) -> Optional[float]:
    """Mean host ms inside the program's call, before the benchmark waits."""
    if run.kind != kind or not run.window.calls:
        return None
    w = run.window
    return 1e3 * sum(d - s for s, d in zip(w.starts, w.dispatched)) / w.calls


def idle_share(run, kind: str) -> Optional[float]:
    """Percent of the captured wall in which the device ran nothing, averaged
    over the ranks."""
    if run.kind != kind or not run.traces:
        return None
    shares = [1.0 - t["busy_s"] / t["window_s"] for t in run.traces if t["device_events"]]
    return 100.0 * sum(shares) / len(shares) if shares else None


def per_call_ms(run, kind: str, seconds_of) -> Optional[float]:
    """Device ms a call of ``seconds_of(trace)``, averaged over the ranks;
    None where no rank recorded any."""
    if run.kind != kind or not run.traces:
        return None
    vals = [seconds_of(t) / t["calls"] for t in run.traces if t["calls"]]
    if not vals or not any(vals):
        return None
    return 1e3 * sum(vals) / len(vals)


def module_ms(run, kind: str, cls: str) -> Optional[float]:
    return per_call_ms(run, kind, lambda t: t["module_s"].get(cls, 0.0))


def pair_roofline(run, kind: str) -> Optional[float]:
    """Percent: the residual pair calls' least time at the card's peaks over
    the device time of the kernels inside their ranges, all ranks together."""
    if run.kind != kind or not run.traces:
        return None
    least = spent = 0.0
    for t in run.traces:
        for shape, dtype in t["module_calls"].get("ResidualConv", []):
            least += least_seconds(*pair_work(shape, dtype), dtype)
        spent += t["module_s"].get("ResidualConv", 0.0)
    if spent <= 0.0 or least <= 0.0:
        return None
    return 100.0 * least / spent


def peak_gib(run, kind: str) -> Optional[float]:
    if run.kind != kind or run.peak_window_bytes <= 0:
        return None
    return run.peak_window_bytes / 2**30


def mfu(run, kind: str) -> Optional[float]:
    """Percent of the chips' bf16 peak: the reference's FLOPs of the window's
    calls over the window's seconds."""
    if run.kind != kind or not run.flops_per_call or not run.window.calls:
        return None
    w = run.window
    return 100.0 * run.flops_per_call * w.calls / (w.seconds * PEAK_FLOPS["bfloat16"] * run.chips)
