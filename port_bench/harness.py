"""The run of one cell: set-up, the measured window, the traced calls, the
comparison that decides ``correct``, and the result line.

An entry (``entries/<kind>.py``) gives an ``Entry(cell, ranks, seed,
fault)`` with:

* ``kind``: ``"serve"`` (each call is a request that ends when its frames
  are in host memory) or ``"train"`` (each call is a step; the window ends
  with one synchronize);
* ``units``: what one call delivers (frames, clips);
* ``setup()``: the program built from the seed, its shapes warmed up;
* ``dispatch(i)``: call ``i`` into the program; ``collect(i, out, keep)``:
  the benchmark's own wait and copy of what it returned (``keep``: hold it
  for the comparison); ``drop(i)``: let a held call go; ``finish()``: the
  wait that closes a stretch of calls;
* ``model``: the module whose layers the traced run hooks (the classes
  that the cell's per-layer metric readers name in their ``HOOKS``);
* ``release()``: free the program's state; ``check()``: the compared
  numbers, ``{name: (value, limit)}``, each correct while ``value <= limit``;
* ``work()``: the reference's FLOPs of one call, for ``mfu``.
"""

from __future__ import annotations

import random
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

from port_bench.common import Cell, derive_seed, load_module
from port_bench.trace import ModuleRanges, summarize

TRACE_MIN_CALLS, TRACE_MIN_S, TRACE_MAX_CALLS = 2, 1.5, 8


@dataclass
class Window:
    """Host-clock record of the calls of one stretch."""

    starts: List[float] = field(default_factory=list)
    dispatched: List[float] = field(default_factory=list)
    done: List[float] = field(default_factory=list)
    end: float = 0.0

    @property
    def calls(self) -> int:
        return len(self.starts)

    @property
    def seconds(self) -> float:
        return self.end - self.starts[0]


@dataclass
class Run:
    """What the metric readers read."""

    kind: str
    units: float  # per call
    chips: int
    setup_s: float
    window: Window
    peak_window_bytes: int = 0
    traces: List[dict] = field(default_factory=list)  # one summary a rank
    flops_per_call: Optional[float] = None


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device, reset: bool = False) -> int:
    """The device's peak of allocated memory (0 off the card); ``reset`` starts
    a new peak after reading."""
    import torch

    if device.type != "cuda":
        return 0
    peak = torch.cuda.max_memory_allocated(device)
    if reset:
        torch.cuda.reset_peak_memory_stats(device)
    return peak


class Ranks:
    """This process's place among the cell's ranks: its device and, with more
    than one, the process group of the program (NCCL) and a gloo group the
    benchmark keeps the ranks in step with."""

    def __init__(self, rank: int, world: int, device):
        self.rank, self.world, self.device = rank, world, device
        self.step_group = None
        if world > 1:
            import torch.distributed as dist

            self.step_group = dist.new_group(backend="gloo")

    @property
    def root(self) -> bool:
        return self.rank == 0

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank."""
        if self.world == 1:
            return flag
        import torch
        import torch.distributed as dist

        t = torch.tensor([int(flag)])
        dist.broadcast(t, 0, group=self.step_group)
        return bool(t.item())

    def gather(self, obj) -> list:
        if self.world == 1:
            return [obj]
        import torch.distributed as dist

        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.step_group)
        return out


def _measure(entry, ranks: Ranks, seconds: float, sampler, first: int = 0,
             min_calls: int = 1, max_calls: Optional[int] = None) -> Window:
    """Closed-loop calls until ``seconds`` have passed (at least ``min_calls``,
    at most ``max_calls``), decided on rank 0."""
    import torch

    win = Window()
    t0 = time.perf_counter()
    i = first
    while True:
        n = i - first
        go = (n < min_calls or time.perf_counter() - t0 < seconds) and \
            (max_calls is None or n < max_calls)
        if not ranks.agree(go):
            break
        start = time.perf_counter()
        with torch.profiler.record_function("pb::dispatch"):
            out = entry.dispatch(i)
        dispatched = time.perf_counter()
        keep, evict = sampler(i) if sampler else (False, None)
        with torch.profiler.record_function("pb::collect"):
            entry.collect(i, out, keep)
        del out
        if evict is not None:
            entry.drop(evict)
        win.starts.append(start)
        win.dispatched.append(dispatched)
        win.done.append(time.perf_counter())
        i += 1
    with torch.profiler.record_function("pb::finish"):
        entry.finish()
    win.end = time.perf_counter()
    return win


class Reservoir:
    """A sample of ``size`` of the window's calls, drawn from the seed
    (reservoir sampling: each call is kept with the same chance)."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng, self.seen = size, random.Random(derive_seed(seed, "sample")), 0
        self.kept: List[int] = []

    def __call__(self, i: int):
        """``(keep call i, the kept call it displaces or None)``."""
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append(i)
            return True, None
        j = self.rng.randrange(self.seen)
        if j < self.size:
            evicted, self.kept[j] = self.kept[j], i
            return True, evicted
        return False, None


def run_cell(cell: Cell, ranks: Ranks, seed: int, seconds: float, trace: bool,
             t0: float, fault: str = "none") -> dict:
    """One run of ``cell`` on this rank; on rank 0 the result's fields."""
    import torch

    entry = cell.entry_module().Entry(cell, ranks, seed, fault)
    t_setup = time.perf_counter()
    entry.setup()
    sync(ranks.device)
    setup_s = ranks.gather(time.perf_counter() - t0)[0]
    if ranks.root:
        phases = {"before_entry_s": t_setup - t0, **getattr(entry, "phases", {})}
        print("setup: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()), file=sys.stderr)
    setup_peak = peak_bytes(ranks.device, reset=True)

    sampler = Reservoir(int(cell.traffic.get("compare", 1)), seed)
    window = _measure(entry, ranks, seconds, sampler)
    summary = None
    if trace:
        summary = _traced(entry, ranks, window.calls, hooked_classes(cell))
    peak = peak_bytes(ranks.device)
    peaks = ranks.gather(peak)
    memory_peak = max(ranks.gather(max(peak, setup_peak)))
    traces = ranks.gather(summary) if trace else []

    entry.release()
    if ranks.device.type == "cuda":
        torch.cuda.empty_cache()
    checks = entry.check(sampler.kept)
    run = Run(kind=entry.kind, units=entry.units, chips=ranks.world, setup_s=setup_s,
              window=window, peak_window_bytes=max(peaks), traces=traces)
    if not ranks.root:
        return {}
    metrics = {}
    wanted = [m for m in cell.metrics if (m.kind == "per_layer") == trace]
    if trace:
        run.flops_per_call = entry.work()
    for m in wanted:
        value = load_module(m.reader).read(run)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    out = {
        "correct": all(v <= lim for v, lim in checks.values()),
        "attempted": window.calls,
        "failed": 0,
        "metrics": metrics,
        "device": {
            "platform": "gpu",
            "kind": (torch.cuda.get_device_name(ranks.device) if ranks.device.type == "cuda"
                     else "cpu"),
            "count": ranks.world,
            "memory_peak_bytes": int(memory_peak),
        },
    }
    if trace:
        out["device"]["busy_s"] = sum(t["busy_s"] for t in traces) / len(traces)
        out["device"]["window_s"] = sum(t["window_s"] for t in traces) / len(traces)
        out["breakdown"] = {"device_ops": [list(kv) for kv in traces[0]["device_ops"]],
                            "idle_gaps": [list(kv) for kv in traces[0]["idle_gaps"]]}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return out


def hooked_classes(cell: Cell) -> tuple:
    """The module classes whose calls the traced run puts in ranges: the
    union of what the cell's per-layer metric readers declare in ``HOOKS``."""
    out: List[str] = []
    for m in cell.metrics:
        if m.kind == "per_layer":
            out += [c for c in getattr(load_module(m.reader), "HOOKS", ()) if c not in out]
    return tuple(out)


def _traced(entry, ranks: Ranks, first: int, classes: tuple) -> dict:
    """A profiler capture of a few steady calls after the window, with the
    ranges of the modules of ``classes`` hooked on; the summary of this
    rank's capture."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    hooks = ModuleRanges(entry.model, classes)
    activities = [ProfilerActivity.CPU]
    if ranks.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    sync(ranks.device)
    try:
        with profile(activities=activities) as prof:
            sync(ranks.device)
            t0 = time.perf_counter()
            win = _measure(entry, ranks, TRACE_MIN_S, None, first, TRACE_MIN_CALLS,
                           TRACE_MAX_CALLS)
            sync(ranks.device)
            wall = time.perf_counter() - t0
    finally:
        hooks.remove()
    summary = summarize(prof, wall, win.calls, hooks.calls)
    if summary["device_events"] == 0:
        print("trace: the profiler recorded no device operation", file=sys.stderr)
    return summary
