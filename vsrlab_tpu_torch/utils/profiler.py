"""Profiling and timing hooks (port of ``vsrlab_tpu/utils/profiler.py``).

* :func:`trace`: a ``torch.profiler`` capture of the enclosed region (the
  card's kernels where one is present, the host's ops always), written as
  a Chrome trace (Perfetto, ``chrome://tracing``);
* :func:`annotate`: a named range on that trace's timeline;
* :class:`Timer`: an accumulating wall-clock timer of named phases;
* :func:`best_time`: best-of-repeats seconds a call, with one sync each.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator

import torch


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
    """A named range that shows on the trace's timeline."""
    return torch.profiler.record_function(name)


class Timer:
    """Accumulating wall-clock timer: ``with timer("data"): ...``."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": self.totals[k], "count": self.counts[k],
                    "mean_s": self.totals[k] / max(self.counts[k], 1)} for k in self.totals}


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
