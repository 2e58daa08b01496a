#!/usr/bin/env python3
"""Reading the program's own spans and counters in a profiler capture,
beside what :func:`port_bench.trace.summarize` reads.

``vsrlab_tpu_torch.utils.profiler`` opens a span ``vsr::<name>`` at each
layer boundary of the entry points, the models and the train step while a
profiler collects, and counts (``comm_bytes``: the bytes of the windows'
gather broadcasts) under the same switch. :func:`summarize_spans` adds to
a rank's summary:

* ``span_s``: device seconds of the operations whose launch lies inside
  any instance of a ``vsr::`` span, by span name (the launch-time rule of
  ``trace.summarize``: a kernel launched by the autograd engine's thread
  belongs to the span open on the caller's thread at that time). Nested
  spans each count their children's operations.
* ``sync_s`` and ``syncs``: host seconds and number of the program's
  blocking runtime calls, those started inside a ``vsr::`` span and not
  inside the benchmark's own waits (``pb::collect``, ``pb::finish``):
  ``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
  ``cudaEventSynchronize``, ``cudaMemcpy``, and a ``cudaMemcpyAsync``
  whose device copy reads or writes pageable host memory. PyTorch follows
  such a copy with a ``cudaStreamSynchronize`` on the same thread (a
  blocking ``copy_``); that wait is counted with its copy, as one call.
* ``counters``: the program's counters' change over the capture.
* ``span_idle_s``: idle seconds of the device by the span open when each
  gap began: the innermost ``vsr::`` span, else the innermost of the
  benchmark's ``pb::`` spans, else ``outside any span``; and
  ``span_roots``, the ``vsr::`` spans that opened with none around them
  (the entry points).

The keys are left out where the capture holds no ``vsr::`` span (a
program without spans) or, for ``counters``, where the program keeps no
counter registry, so the readers below return None there.

Run as a script, it makes one cell's run with its capture read both ways:

    python3 port_bench/spans.py --workload <cell> --seed <n> --seconds <s>

set-up, an untraced window of ``--seconds``, then the traced calls of
``harness`` with the cell's hooks; the last line of standard output is
one JSON object with the window's and the traced calls' rates, each
rank's summary with these keys, and the numbers the readers below give.
Rank 0 prints ``idle by span:`` on standard error.
"""

from __future__ import annotations

import bisect
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

if __package__ in (None, ""):  # run as a script: the checkout's root on the path
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench import readers  # noqa: E402
from port_bench.trace import RANGE_PREFIX, RUNTIME_CALL, _is_device, _union  # noqa: E402

SPAN_PREFIX = "vsr::"
OUTSIDE = "outside any span"
BENCH_WAITS = ("pb::collect", "pb::finish")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")
ASYNC_COPY = "cudaMemcpyAsync"


def program_counters() -> Optional[Dict[str, int]]:
    """The program's counters now; None where it keeps none."""
    try:
        from vsrlab_tpu_torch.utils import profiler
    except ImportError:
        return None
    counters = getattr(profiler, "counters", None)
    return None if counters is None else dict(counters())


def _inside(merged: List[Tuple[int, int]], t: int) -> bool:
    """Whether ``t`` lies in one of the disjoint sorted intervals ``merged``."""
    i = bisect.bisect_right(merged, (t, float("inf"))) - 1
    return i >= 0 and merged[i][0] <= t <= merged[i][1]


def _innermost_at(spans: List[Tuple[int, int, str]], times: List[int]) -> List[Optional[str]]:
    """The innermost span (latest start) open at each of ``times``
    (ascending), over ``spans`` sorted by start, with a stack of the spans
    open so far."""
    out: List[Optional[str]] = []
    stack: List[Tuple[int, int, str]] = []
    j = 0
    for t in times:
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        name = None
        for s, e, n in reversed(stack):
            if s <= t <= e:
                name = n
                break
        out.append(name)
    return out


def summarize_spans(prof, counters_before: Optional[Dict[str, int]] = None) -> dict:
    """The keys above from a ``torch.profiler`` capture; ``counters_before``
    is :func:`program_counters` from just before it."""
    events = prof.profiler.kineto_results.events()
    host_names = {ev.name() for ev in events if not _is_device(ev)}
    spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    program: List[Tuple[int, int, str]] = []
    bench: List[Tuple[int, int, str]] = []
    waits: List[Tuple[int, int]] = []
    runtime: List[Tuple[int, int, int, str, int]] = []  # (thread, start, end, name, corr)
    launch_at: Dict[int, int] = {}
    op_at: Dict[int, int] = {}
    device = []
    copy_kind: Dict[int, str] = {}  # correlation id -> the device copy's name
    for ev in events:
        s, e, name = ev.start_ns(), ev.end_ns(), ev.name()
        if _is_device(ev):
            if name not in host_names:
                device.append((s, e, ev.correlation_id(), ev.linked_correlation_id()))
                if name.startswith("Memcpy"):
                    copy_kind[ev.correlation_id()] = name
            continue
        if RUNTIME_CALL.match(name):
            launch_at[ev.correlation_id()] = s
            runtime.append((ev.start_thread_id(), s, e, name, ev.correlation_id()))
        else:
            op_at.setdefault(ev.correlation_id(), s)
        if name.startswith(SPAN_PREFIX):
            spans[name[len(SPAN_PREFIX):]].append((s, e))
            program.append((s, e, name))
        elif name.startswith(RANGE_PREFIX):
            bench.append((s, e, name))
            if name in BENCH_WAITS:
                waits.append((s, e))
    out: dict = {}
    after = program_counters()
    if counters_before is not None and after is not None:
        keys = set(after) | set(counters_before)
        out["counters"] = {k: after.get(k, 0) - counters_before.get(k, 0) for k in sorted(keys)
                           if after.get(k, 0) != counters_before.get(k, 0)}
    if not program:
        return out

    merged = {k: _union(v) for k, v in spans.items()}
    span_ns: Dict[str, int] = defaultdict(int)
    for s, e, corr, linked in device:
        t = launch_at.get(corr) or (op_at.get(linked) if linked else None)
        if t is None:
            continue
        for name, iv in merged.items():
            if _inside(iv, t):
                span_ns[name] += e - s

    all_program = _union((s, e) for s, e, _ in program)
    waits = _union(waits)
    sync_ns = syncs = 0
    copy_open: Dict[int, bool] = defaultdict(bool)  # thread -> a counted blocking copy just ran
    for thread, s, e, name, corr in sorted(runtime):
        folded = name == "cudaStreamSynchronize" and copy_open[thread]
        pageable = name == ASYNC_COPY and "Pageable" in copy_kind.get(corr, "")
        copy_open[thread] = False
        if not (name in SYNC_CALLS or pageable):
            continue
        if not _inside(all_program, s) or _inside(waits, s):
            continue
        sync_ns += e - s
        if not folded:
            syncs += 1
        copy_open[thread] = pageable or name == "cudaMemcpy"

    busy = _union((s, e) for s, e, *_ in device)
    gap_at = [e0 for (_, e0), _ in zip(busy, busy[1:])]
    inner_program = _innermost_at(sorted(program), gap_at)
    inner_bench = _innermost_at(sorted(bench), gap_at)
    idle: Dict[str, float] = defaultdict(float)
    for (_, e0), (s1, _), p, b in zip(busy, busy[1:], inner_program, inner_bench):
        idle[p or b or OUTSIDE] += (s1 - e0) / 1e9
    roots, depth_end = set(), -1
    for s, e, name in sorted(program):
        if s > depth_end:
            roots.add(name)
            depth_end = e
        else:
            depth_end = max(depth_end, e)
    out.update({
        "span_s": {k: v / 1e9 for k, v in span_ns.items()},
        "sync_s": sync_ns / 1e9,
        "syncs": syncs,
        "span_idle_s": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        "span_roots": sorted(roots),
    })
    return out


def idle_line(summary: dict) -> str:
    """``idle by span: <span> <s>, ...`` of a summary with ``span_idle_s``."""
    items = summary.get("span_idle_s", {})
    return "idle by span: " + (", ".join(f"{k} {v:.6f}" for k, v in items.items())
                               if items else "no program span in the capture")


def dispatch_idle(summary: dict) -> Tuple[float, float]:
    """``(idle seconds that began inside pb::dispatch, of which under a
    vsr:: span below the entry span)``."""
    idle = summary.get("span_idle_s", {})
    roots = set(summary.get("span_roots", ()))
    inside = sum(v for k, v in idle.items() if k.startswith(SPAN_PREFIX) or k == "pb::dispatch")
    below = sum(v for k, v in idle.items() if k.startswith(SPAN_PREFIX) and k not in roots)
    return inside, below


# -- readers of the keys above (each None where no rank recorded its key) --

def _traces_with(run, kind: str, key: str) -> list:
    if run.kind != kind:
        return []
    return [t for t in run.traces if t.get(key) is not None and t.get("calls")]


def sync_ms(run, kind: str) -> Optional[float]:
    """Host ms a call blocked in the program's blocking runtime calls, mean over ranks."""
    ts = _traces_with(run, kind, "sync_s")
    return 1e3 * sum(t["sync_s"] / t["calls"] for t in ts) / len(ts) if ts else None


def host_syncs(run, kind: str) -> Optional[float]:
    """The program's blocking runtime calls a call, mean over ranks."""
    ts = _traces_with(run, kind, "syncs")
    return sum(t["syncs"] / t["calls"] for t in ts) / len(ts) if ts else None


def span_ms(run, kind: str, name: str) -> Optional[float]:
    """Device ms a call of the operations launched inside ``vsr::<name>``,
    mean over the ranks that recorded the span."""
    ts = [t for t in _traces_with(run, kind, "span_s") if name in t["span_s"]]
    return 1e3 * sum(t["span_s"][name] / t["calls"] for t in ts) / len(ts) if ts else None


def comm_gbps(run, kind: str) -> Optional[float]:
    """GB/s of the gather: the bytes the program counted over the device
    seconds of NCCL kernels, mean over ranks (a kernel's wait for its
    peers is in its seconds)."""
    ts = [t for t in _traces_with(run, kind, "counters")
          if t["counters"].get("comm_bytes") and t.get("nccl_s")]
    return sum(t["counters"]["comm_bytes"] / t["nccl_s"] / 1e9 for t in ts) / len(ts) \
        if ts else None


READINGS = {  # the per-layer numbers these keys give, by the cells they read
    "sync_ms.serve": ("rbvsr.serve.w4", lambda r: sync_ms(r, "serve")),
    "sync_ms.vrt": ("vrt.serve.f16", lambda r: sync_ms(r, "serve")),
    "sync_ms.split": ("rbvsr.serve.time4", lambda r: sync_ms(r, "serve")),
    "sync_ms.train": ("rbvsr.train.b32", lambda r: sync_ms(r, "train")),
    "host_syncs.serve": ("rbvsr.serve.w4", lambda r: host_syncs(r, "serve")),
    "host_syncs.train": ("rbvsr.train.b32", lambda r: host_syncs(r, "train")),
    "flow_ms.serve": ("rbvsr.serve.w4", lambda r: span_ms(r, "serve", "model.flow")),
    "flow_ms.train": ("rbvsr.train.b32", lambda r: span_ms(r, "train", "model.flow")),
    "backward_ms.train": ("rbvsr.train.b32", lambda r: span_ms(r, "train", "step.backward")),
    "update_ms.train": ("rbvsr.train.b32", lambda r: span_ms(r, "train", "step.update")),
    "comm_gbps.split": ("rbvsr.serve.time4", lambda r: comm_gbps(r, "serve")),
}


# -- the script --------------------------------------------------------------

def traced(entry, ranks, first: int, classes: tuple) -> dict:
    """``harness``'s traced calls (the same capture, hooks and summary),
    with :func:`summarize_spans`'s keys merged into the summary."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from port_bench import harness
    from port_bench.trace import ModuleRanges, summarize

    hooks = ModuleRanges(entry.model, classes)
    activities = [ProfilerActivity.CPU]
    if ranks.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    harness.sync(ranks.device)
    before = program_counters()
    try:
        with profile(activities=activities) as prof:
            harness.sync(ranks.device)
            t0 = time.perf_counter()
            win = harness._measure(entry, ranks, harness.TRACE_MIN_S, None, first,
                                   harness.TRACE_MIN_CALLS, harness.TRACE_MAX_CALLS)
            harness.sync(ranks.device)
            wall = time.perf_counter() - t0
    finally:
        hooks.remove()
    summary = summarize(prof, wall, win.calls, hooks.calls)
    summary.update(summarize_spans(prof, before))
    return summary


def _parse(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="one cell's run with the program's spans read")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    import json
    import os
    import subprocess
    from pathlib import Path

    from port_bench import run as bench_run

    args = _parse(argv)
    bench_run.cache_environment()
    from port_bench.common import load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 3
    procs = []
    if cell.chips > 1:
        if args.rank == 0:
            args.port = bench_run.free_port()
            for rank in range(1, cell.chips):
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), "--workload", args.workload,
                     "--seed", str(args.seed), "--seconds", str(args.seconds), "--rank",
                     str(rank), "--port", str(args.port)], stdout=sys.stderr,
                    cwd=str(bench_run.ROOT)))
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(args.port),
                          RANK=str(args.rank), LOCAL_RANK=str(args.rank),
                          WORLD_SIZE=str(cell.chips), LOCAL_WORLD_SIZE=str(cell.chips))
    device = torch.device("cuda", args.rank)
    torch.cuda.set_device(device)
    try:
        from port_bench import harness

        if cell.chips > 1:
            from vsrlab_tpu_torch.parallel import initialize_distributed

            initialize_distributed("cuda")
        ranks = harness.Ranks(args.rank, cell.chips, device)
        entry = cell.entry_module().Entry(cell, ranks, args.seed)
        entry.setup()
        harness.sync(device)
        window = harness._measure(entry, ranks, args.seconds, None)
        summary = traced(entry, ranks, window.calls, harness.hooked_classes(cell))
        summaries = ranks.gather(summary)
        if cell.chips > 1:
            torch.distributed.destroy_process_group()
    finally:
        workers_ok = bench_run.stop_workers(procs)
    if args.rank != 0:
        return 0
    run = harness.Run(kind=entry.kind, units=entry.units, chips=cell.chips, setup_s=0.0,
                      window=window, traces=summaries)
    inside, below = dispatch_idle(summaries[0])
    print(idle_line(summaries[0]), file=sys.stderr)
    print(json.dumps({
        "cell": cell.name, "seed": args.seed, "workers_ok": workers_ok,
        "device": torch.cuda.get_device_name(device), "power_limit": bench_run.power_limit(),
        "untraced": {"calls": window.calls, "seconds": window.seconds,
                     "rate": readers.rate(run, entry.kind)},
        "traced": [{"calls": t["calls"], "wall_s": t["window_s"],
                    "rate": entry.units * t["calls"] / t["window_s"]} for t in summaries],
        "readings": {k: f(run) for k, (c, f) in READINGS.items() if c == cell.name},
        "dispatch_idle_s": {"all": inside, "below_entry_span": below},
        "summaries": [{k: v for k, v in t.items() if k != "module_calls"} for t in summaries],
    }))
    return 0 if workers_ok else 5


if __name__ == "__main__":
    sys.exit(main())
