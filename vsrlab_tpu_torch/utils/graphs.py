"""Replay of a call as a CUDA graph, so that the host does not pace a chain
of small calls.

:class:`GraphedCall` wraps a function of tensors (a module's own forward).
On a card, without a gradient and outside a profiler's first sight of a
shape, it replays a graph of the call in place of its launches: one
``cudaGraphLaunch`` for the ~150 launches of, say, BasicVSR++'s alignment.
Elsewhere it calls the function as it is: autograd, the CPU and the first
call of a shape while a profiler collects (so that the capture happens
outside the trace) run eagerly. The two paths give the same bits.

* **Cache.** One graph a key: the arguments' shapes, dtypes and devices,
  whether inference mode is on, and the caller's ``extra`` key. At most
  ``MAX_GRAPHS`` graphs a call site, the least recently used dropped first,
  so that a caller whose shapes alternate (the edge tiles of a tiled
  request) replays each shape's graph instead of capturing anew. A change
  of the owner's parameters or buffers (a new ``data_ptr`` or ``_version``:
  ``load_state_dict``, an optimiser step) drops every graph.
* **Counts.** A capture runs the Python wrappers of the hand-written
  kernels without launching anything. What they count there (``launches``
  and ``launches_by_shape`` of each wrapper, and the program's counters,
  :func:`vsrlab_tpu_torch.utils.profiler.recording`) is the graph's launch
  plan: it is taken back after the capture and added again on every
  replay, so a replayed call counts as the eager call would.
* **Threads.** A lock covers the capture and each replay's copy in,
  replay and copy out, so that two threads calling one site share its
  static buffers in turn.

Used by :class:`vsrlab_tpu_torch.models.vrt.deform.SecondOrderDeformableAlignment`
(BasicVSR++'s 4 x (T - 1) chained alignments a clip).
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Hashable

import torch
from torch import nn

from vsrlab_tpu_torch.utils import profiler

MAX_GRAPHS = 4  # a call site's shapes: a tiled request's interior, two edges and a corner


def kernel_wrappers() -> tuple:
    """The wrappers of the hand-written kernels that count their launches."""
    from vsrlab_tpu_torch.ops import bilinear_sample, packed_gather, residual_pair, window_attention

    return (bilinear_sample.bilinear_sample, packed_gather.packed_row_gather,
            window_attention.window_attention, *residual_pair._WRAPPERS.values())


class _Graph:
    __slots__ = ("graph", "static", "out", "launches", "counts")


class GraphedCall:
    """``fn(*args)`` (tensors in, one tensor out) replayed as a CUDA graph
    where it can be; ``owner`` is the module whose parameters and buffers
    ``fn`` reads."""

    def __init__(self, fn: Callable[..., torch.Tensor], owner: nn.Module):
        self.fn, self.owner = fn, owner
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._weights = None
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._graphs)

    def __getstate__(self) -> dict:  # a copy (deepcopy, pickle) starts with no graphs
        return {"fn": self.fn, "owner": self.owner}

    def __setstate__(self, state: dict) -> None:
        self.__init__(**state)

    def __call__(self, *args: torch.Tensor, extra: Hashable = None) -> torch.Tensor:
        if not args[0].is_cuda or torch.is_grad_enabled():
            return self.fn(*args)
        key = (tuple((a.shape, a.dtype, a.device) for a in args),
               torch.is_inference_mode_enabled(), extra)
        with self._lock:
            weights = tuple((t.data_ptr(), t._version)
                            for t in (*self.owner.parameters(), *self.owner.buffers()))
            if weights != self._weights:
                self._graphs.clear()
                self._weights = weights
            entry = self._graphs.get(key)
            if entry is None:
                if profiler.collecting():
                    return self.fn(*args)
                return self._capture(key, args)
            self._graphs.move_to_end(key)
            for dst, src in zip(entry.static, args):
                dst.copy_(src)
            entry.graph.replay()
            for wrapper, plan in zip(kernel_wrappers(), entry.launches):
                wrapper.launches += sum(plan.values())
                wrapper.launches_by_shape.update(plan)
            for name, n in entry.counts.items():
                profiler.count(name, n)
            return entry.out.clone()

    def _capture(self, key, args) -> torch.Tensor:
        """Run ``fn`` once on a side stream (the warm-up a capture wants; its
        output is this call's), then capture it into a new graph."""
        while len(self._graphs) >= MAX_GRAPHS:
            self._graphs.popitem(last=False)  # let the oldest graph's memory go first
        entry = _Graph()
        entry.static = [a.clone() for a in args]
        device = args[0].device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            out = self.fn(*entry.static)
        torch.cuda.current_stream(device).wait_stream(side)
        wrappers = kernel_wrappers()
        before = [(w.launches, w.launches_by_shape.copy()) for w in wrappers]
        entry.graph = torch.cuda.CUDAGraph()
        with profiler.recording() as counts:
            with torch.cuda.graph(entry.graph, capture_error_mode="thread_local"):
                entry.out = self.fn(*entry.static)
        entry.counts = dict(counts)
        entry.launches = []
        for w, (launches, by_shape) in zip(wrappers, before):  # nothing ran: take them back
            entry.launches.append(w.launches_by_shape - by_shape)
            w.launches = launches
            w.launches_by_shape.clear()
            w.launches_by_shape.update(by_shape)
        self._graphs[key] = entry
        return out
