"""What the serving entries share: the pool of LR clips, the copy of each
request's SR frames into host memory, the faults a serving cell can have,
and the comparison with the reference.

A request hands the program one LR clip, a host float32 array of shape
``(1, T, H, W, 3)`` from a small pool of distinct clips drawn from the
seed, and ends when its SR frames are in host memory as float32 (copied
into one of a few page-locked buffers made at set-up). The comparison
runs the reference in float32, TF32 off, over the same clips, window by
window as the program's windows are cut, and reads two numbers over the
sampled requests' frames: the relative RMS gap ``||sr - ref|| / ||ref||``
(``rel_rms``) and the widest single gap ``max |sr - ref|`` (``max_abs``),
each compared where the cell's ``check`` gives it a limit.

Faults (``--fault``), for the checks that the comparison fails them:
``control`` puts the reference computed in float8 in the program's place;
``alter`` adds 0.25 to the first SR frame of each request where the
program returns it.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

from port_bench import program
from port_bench.common import Cell, make_clips
from port_bench.reference.layers import NoTF32, exact, fp8

SERVE_FAULTS = ("none", "control", "alter")


class HostFrames:
    """Page-locked float32 buffers of one request's SR frames: one to copy
    into and one for each request held for the comparison."""

    def __init__(self, shape, count: int):
        import torch

        pin = torch.cuda.is_available()
        self.free = [torch.empty(shape, dtype=torch.float32, pin_memory=pin)
                     for _ in range(count)]
        self.held: Dict[int, object] = {}

    def copy(self, i: int, sr, keep: bool):
        import torch

        buf = self.free.pop()
        buf.copy_(sr, non_blocking=True)
        if sr.is_cuda:
            torch.cuda.current_stream(sr.device).synchronize()
        if keep:
            self.held[i] = buf
        else:
            self.free.append(buf)

    def drop(self, i: int):
        self.free.append(self.held.pop(i))


class ServeEntry:
    kind = "serve"
    faults = SERVE_FAULTS

    def __init__(self, cell: Cell, ranks, seed: int, fault: str = "none"):
        if fault not in self.faults:
            raise ValueError(f"cell {cell.name} has no fault {fault!r}: {self.faults}")
        self.cell, self.ranks, self.seed, self.fault = cell, ranks, seed, fault
        self.traffic, self.device = cell.traffic, ranks.device
        self.ref = cell.reference_module()
        self.widths = cell.config["model"]
        t = self.traffic
        self.clip_shape = (1, t["frames"], t["height"], t["width"], 3)
        self.units = t["frames"]
        self.clip_of: Dict[int, int] = {}

    # -- set-up ---------------------------------------------------------
    def setup(self):
        import time

        import torch

        t0 = time.perf_counter()
        clips = make_clips(self.clip_shape, self.traffic["pool"], self.seed, "serve", self.device)
        self.pool = [c.cpu().numpy() for c in clips]
        del clips
        t1 = time.perf_counter()
        if self.fault == "control":
            self.params = program.weights(self.cell, self.seed, self.device)
            self.model = torch.nn.Module()
            self.forward = self.reference_forward(self.params, fp8)
        else:
            self.model = program.build(self.cell, self.seed, self.device)
            self.forward = self.program_forward(self.model)
        scale = self.widths.get("upscale", 4)
        out_shape = (*self.clip_shape[:2], self.clip_shape[2] * scale,
                     self.clip_shape[3] * scale, 3)
        self.host = HostFrames(out_shape, int(self.traffic.get("compare", 1)) + 1) \
            if self.ranks.root else None
        self.kept_device: Dict[int, object] = {}
        t2 = time.perf_counter()
        for i in range(int(self.traffic.get("warmup", 2))):
            self.collect(-1 - i, self.dispatch(-1 - i), False)
        t3 = time.perf_counter()
        self.phases = {"clips_s": t1 - t0, "program_and_host_buffers_s": t2 - t1,
                       "warmup_s": t3 - t2}

    def program_forward(self, model) -> Callable:
        raise NotImplementedError

    def reference_forward(self, params, q) -> Callable:
        """The reference as a drop-in for the program's forward: batches of
        clips (host or device) -> SR clips on the device."""
        import torch

        def forward(x):
            x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
            with torch.no_grad(), NoTF32():
                return torch.cat([self.ref.forward(params, x[j:j + 1], q, **self.widths)[0]
                                  for j in range(x.shape[0])])

        return forward

    # -- the calls ------------------------------------------------------
    def dispatch(self, i: int):
        self.clip_of[i] = i % len(self.pool)
        out = self.request(self.pool[self.clip_of[i]])
        if self.fault == "alter":
            out = out.clone()
            out[:, 0] += 0.25
        return out

    def request(self, clip):
        raise NotImplementedError

    def collect(self, i: int, sr, keep: bool):
        import torch

        if self.ranks.root:
            self.host.copy(i, sr.float() if sr.dtype != torch.float32 else sr, keep)
        elif sr.is_cuda:
            torch.cuda.current_stream(self.device).synchronize()
        if keep and self.ranks.world > 1:
            self.kept_device[i] = sr.clone()

    def drop(self, i: int):
        if self.ranks.root:
            self.host.drop(i)
        self.kept_device.pop(i, None)

    def finish(self):
        pass

    def release(self):
        self.model = self.forward = None

    # -- the comparison -------------------------------------------------
    def windows_of(self, clip) -> List[Tuple[int, int, int]]:
        """``(first frame, frames, padded frames)`` of each window the
        reference runs; one window of the whole clip by default."""
        t = clip.shape[1]
        return [(0, t, 0)]

    def check(self, kept: List[int]) -> Dict[str, Tuple[float, float]]:
        import torch

        limits = self.cell.check
        out: Dict[str, Tuple[float, float]] = {}
        if self.ranks.world > 1:
            out["ranks_differ"] = (self._ranks_differ(kept), limits["ranks_differ"])
        if not self.ranks.root:
            return out
        params = program.weights(self.cell, self.seed, self.device)
        d2 = r2 = 0.0
        worst = 0.0
        for i in sorted(kept):
            clip = self.pool[self.clip_of[i]]
            frames = self.host.held[i]
            for start, n, pad in self.windows_of(clip):
                x = torch.as_tensor(clip[:, start:start + n]).to(self.device)
                if pad:
                    x = torch.cat([x, x[:, -1:].expand(-1, pad, -1, -1, -1)], 1)
                with torch.no_grad(), NoTF32():
                    ref = self.ref.forward(params, x, exact, **self.widths)[0][:, :n]
                got = frames[:, start:start + n].to(self.device)
                diff = got - ref
                d2 += float((diff.double() ** 2).sum())
                r2 += float((ref.double() ** 2).sum())
                worst = max(worst, float(diff.abs().max()))
                if not math.isfinite(float(got.sum())):
                    worst = math.inf
                del ref, got, diff
        got = {"rel_rms": math.sqrt(d2 / r2) if r2 > 0 else math.inf, "max_abs": worst}
        out.update({k: (v, limits[k]) for k, v in got.items() if k in limits})
        return out

    def _ranks_differ(self, kept: List[int]) -> float:
        """The widest gap between any rank's result and rank 0's over the kept
        requests (each rank of the time axis ends with the whole result)."""
        import torch
        import torch.distributed as dist

        worst = 0.0
        for i in sorted(kept):
            mine = self.kept_device.pop(i)
            root = mine.clone()
            dist.broadcast(root, 0)
            worst = max(worst, float((mine.float() - root.float()).abs().max()))
            del mine, root
        return max(self.ranks.gather(worst))

    def work(self) -> Optional[float]:
        """The reference's FLOPs of one request."""
        from port_bench.work import forward_flops

        clip = self.pool[0]
        per_shape: Dict[tuple, float] = {}
        for _, n, pad in self.windows_of(clip):
            shape = (1, n + pad, *clip.shape[2:])
            if shape not in per_shape:
                per_shape[shape] = forward_flops(self.ref, self.widths, shape)
        return sum(per_shape[(1, n + pad, *clip.shape[2:])]
                   for _, n, pad in self.windows_of(clip))
