"""Reading a ``torch.profiler`` capture of a few steady calls.

* Busy time is the union of the intervals in which any device operation
  (kernel, copy, set) ran; idle share is one minus busy over the captured
  wall, so overlapping streams count once and an idle device counts as idle.
  The device-side copies of host ranges (the benchmark's ``pb::`` spans,
  c10d's ``nccl:*``), which the profiler draws on the device's timeline
  under the host range's name, are not operations.
* A kernel belongs to a module when the host call that launched it (the
  CUDA API call with the kernel's correlation id; else the
  operator it is linked to) started inside one of that module's ranges.
  The ranges are ``record_function("pb::<Class>")`` spans that the
  benchmark's own forward hooks open and close (:class:`ModuleRanges`).
* Each idle gap of the device is named by the innermost host span open
  when it began (the benchmark's ``pb::`` spans around its own steps, or
  the operator or runtime call the program was in).
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

RANGE_PREFIX = "pb::"
RUNTIME_CALL = re.compile(r"^cu(da)?[A-Z]")  # cudaLaunchKernel, cuLaunchKernel, ...


class ModuleRanges:
    """Forward pre- and post-hooks on every module whose class is named in
    ``classes``: a profiler range ``pb::<Class>`` around each call, and the
    input's shape and compute type of each call recorded in ``calls``."""

    def __init__(self, model, classes: Sequence[str]):
        import torch

        self.calls: Dict[str, List[Tuple[Tuple[int, ...], str]]] = defaultdict(list)
        self.handles = []
        for m in model.modules():
            cls = type(m).__name__
            if cls not in classes:
                continue
            stack: list = []

            def pre(mod, args, cls=cls, stack=stack):
                x = args[0]
                conv1 = getattr(mod, "conv1", None)
                dt = (getattr(conv1, "dtype", None) or x.dtype) if conv1 is not None else x.dtype
                self.calls[cls].append((tuple(x.shape), str(dt).replace("torch.", "")))
                rf = torch.profiler.record_function(RANGE_PREFIX + cls)
                rf.__enter__()
                stack.append(rf)

            def post(mod, args, out, stack=stack):
                stack.pop().__exit__(None, None, None)

            self.handles.append(m.register_forward_pre_hook(pre))
            self.handles.append(m.register_forward_hook(post))

    def remove(self):
        for h in self.handles:
            h.remove()
        self.handles = []


def _union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _is_device(ev) -> bool:
    return str(ev.device_type()).split(".")[-1] in ("CUDA", "HIP")


def summarize(prof, wall_s: float, calls: int, module_calls: Dict[str, list],
              top: int = 10) -> dict:
    """The capture's numbers: ``busy_s``, ``window_s``, device seconds by
    module class and of NCCL kernels, the top device operations and the
    idle gaps by host span, and the modules' recorded calls."""
    events = prof.profiler.kineto_results.events()
    host_spans = []  # (start, end, name) of host-side events
    launch_at: Dict[int, int] = {}  # runtime correlation id -> host start
    op_at: Dict[int, int] = {}  # operator correlation id -> host start
    ranges: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    device = []
    # the profiler mirrors host ranges (the benchmark's, c10d's "nccl:*") on
    # the device's timeline: spans of the same name, not operations
    host_names = {ev.name() for ev in events if not _is_device(ev)}
    for ev in events:
        s, e = ev.start_ns(), ev.end_ns()
        name = ev.name()
        if _is_device(ev):
            if name not in host_names:
                device.append((s, e, name, ev.correlation_id(), ev.linked_correlation_id()))
            continue
        if RUNTIME_CALL.match(name):
            launch_at[ev.correlation_id()] = s
        else:
            op_at.setdefault(ev.correlation_id(), s)
        if name.startswith(RANGE_PREFIX):
            ranges[name[len(RANGE_PREFIX):]].append((s, e))
        host_spans.append((s, e, name))

    busy = _union((s, e) for s, e, *_ in device)
    busy_ns = sum(e - s for s, e in busy)
    by_op: Dict[str, float] = defaultdict(float)
    nccl_ns = 0
    module_ns: Dict[str, float] = defaultdict(float)
    starts = {k: sorted(v) for k, v in ranges.items()}
    for s, e, name, corr, linked in device:
        by_op[name[:160]] += (e - s) / 1e9
        if "nccl" in name.lower():
            nccl_ns += e - s
        t = launch_at.get(corr) or (op_at.get(linked) if linked else None)
        if t is None:
            continue
        for cls, spans in starts.items():
            i = bisect.bisect_right(spans, (t, float("inf"))) - 1
            if i >= 0 and spans[i][0] <= t <= spans[i][1]:
                module_ns[cls] += e - s

    gaps: Dict[str, float] = defaultdict(float)
    spans = sorted(host_spans)
    for (s0, e0), (s1, _) in zip(busy, busy[1:]):
        label = _open_at(spans, e0)
        gaps[label] += (s1 - e0) / 1e9
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": wall_s,
        "calls": calls,
        "nccl_s": nccl_ns / 1e9,
        "module_s": {k: v / 1e9 for k, v in module_ns.items()},
        "module_calls": {k: list(v) for k, v in module_calls.items()},
        "device_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:top],
        "device_events": len(device),
    }


def _open_at(spans: List[Tuple[int, int, str]], t: int) -> str:
    """The innermost host span (latest start) open at time ``t``."""
    i = bisect.bisect_right(spans, (t, float("inf"), "")) - 1
    best = None
    # spans are sorted by start; walk back over those that started before t
    for j in range(i, max(-1, i - 4000), -1):
        s, e, name = spans[j]
        if s <= t <= e:
            best = name
            break
    return best or "host outside any traced span"
