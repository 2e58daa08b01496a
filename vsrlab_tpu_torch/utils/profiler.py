"""Profiling hooks (port of ``vsrlab_tpu/utils/profiler.py``).

* :func:`trace`: a ``torch.profiler`` capture of the enclosed region (the
  card's kernels where one is present, the host's ops always), written as
  a Chrome trace (Perfetto, ``chrome://tracing``);
* :func:`annotate`: the program's span, ``vsr::<name>`` on that trace's
  timeline while a profiler collects, nothing otherwise;
* :func:`count` / :func:`counters`: the program's counters, counted only
  while a profiler collects (tracing has one switch: a running profiler);
  :func:`recording` also collects the counts made inside it, whatever the
  switch (a CUDA graph's capture records what each replay counts);
* :func:`best_time`: best-of-repeats seconds a call, with one sync each.

The spans sit at the layer boundaries of the entry points, the models and
the train step (a few tens a request or a step, none inside a per-block
loop), so each lies in the same capture, on the same clock, as the
kernels launched inside it. One caller runs at a time, so the entry
point's span is the root of each call's tree.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import Counter
from pathlib import Path
from typing import Dict, Iterator

import torch

SPAN_PREFIX = "vsr::"

_OFF = contextlib.nullcontext()
_counts: Counter = Counter()
_recorders: list = []


def collecting() -> bool:
    """Whether a profiler is collecting in this process."""
    return torch._C._autograd._profiler_enabled()


@contextlib.contextmanager
def trace(log_dir: str = "./profile") -> Iterator[torch.profiler.profile]:
    """Profile the enclosed region and write
    ``<log_dir>/trace_<pid>_<ms>.json`` when it ends (also on an error);
    yields the profiler (``key_averages()`` for sums by op and kernel)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        out = Path(log_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))


def annotate(name: str):
    """The span ``vsr::<name>`` while a profiler collects; otherwise one
    shared no-op context (a flag read, no profiler call)."""
    if collecting():
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler collects, and to
    every open :func:`recording`."""
    if collecting():
        _counts[name] += int(n)
    for rec in _recorders:
        rec[name] += int(n)


@contextlib.contextmanager
def recording() -> Iterator[Counter]:
    """Yield a ``Counter`` of the counts made inside the block, whether or
    not a profiler collects."""
    rec: Counter = Counter()
    _recorders.append(rec)
    try:
        yield rec
    finally:
        _recorders.remove(rec)


def counters() -> Dict[str, int]:
    """A copy of every counter's total in this process."""
    return dict(_counts)


def best_time(call_and_sync, n_iters: int = 5, repeats: int = 3, on_best=None) -> float:
    """Best-of-``repeats`` seconds a call. ``call_and_sync(n)`` issues ``n``
    calls and waits for the device once at the end (for example with
    ``torch.cuda.synchronize()``); one warm call precedes the timing.
    ``on_best(seconds)``, where given, receives the best time so far after
    the warm call and after every repeat."""
    t0 = time.perf_counter()
    call_and_sync(1)
    if on_best is not None:
        on_best(time.perf_counter() - t0)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        call_and_sync(n_iters)
        best = min(best, (time.perf_counter() - t0) / n_iters)
        if on_best is not None:
            on_best(best)
    return best
