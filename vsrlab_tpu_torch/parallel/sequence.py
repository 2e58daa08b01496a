"""The exchanges between ranks on the ``time`` axis of a mesh: what
sequence-parallel training hands across a shard's edge (the JAX package
leaves them to XLA's partitioner, ``vsrlab_tpu/parallel/mesh.py:116-130``).

A rank that holds frames ``[k L, (k + 1) L)`` of each clip talks to the
other ranks of its line of the axis:

* :meth:`TimeLinks.halo` hands its first frame to ``k - 1`` and its last to
  ``k + 1`` and receives theirs (a one-frame halo each way); in the
  backward the halo frames' gradients go back to their owners.
* :meth:`TimeLinks.send` and :meth:`TimeLinks.receive` pass a recurrence's
  carry downstream: the ``"forward"`` recurrence's from ``k`` to ``k + 1``,
  the ``"backward"`` one's from ``k`` to ``k - 1``. In the backward the
  carry's gradient comes back, unscaled, from the receiver to the sender,
  which adds it to its own.
* :meth:`TimeLinks.window_frames` gives a rank the frames of every
  temporal attention window that holds one of its own (VRT's TMSA blocks):
  a :func:`window_plan`, which every rank computes alike for every rank,
  says which frames each rank fetches from which owner. A window may hold
  frames of ranks that are not neighbours: the whole clip where the window
  is as long as the clip, and the clip's last and first frames in the last
  window of a shifted block (the cyclic roll's wrap-around). In the
  backward each fetched frame's gradient returns to its owner, which adds
  the gradients of all its readers to its own.

Every message is one ``broadcast`` in a two-rank process group (gloo
implements ``broadcast`` and ``all_reduce`` only for CUDA tensors; NCCL
takes the same path). Each pair of ranks on a line has one group for each
kind of message it may carry (neighbours :data:`KINDS`, every pair
:data:`WINDOW_KINDS`), so that a group carries its messages in one fixed
order whatever order autograd's engine runs the backward's nodes in, and
the forward messages that a ``remat`` recompute sends again during the
backward never share a group with the backward's gradients; within a
group the lower rank's message goes first. Sends do not block
(``async_op=True``): a rank waits only for what it receives. The links
wait for their pending sends at the start and end of each forward
(:meth:`TimeLinks.wait`); a backward's sends are waited for by the next
forward.

A receiver's node and a sender's node take an ``anchor`` (a fresh leaf
that requires a gradient where grad mode is on), so both are recorded
exactly when grad mode is on: each rank then posts every message its
peer waits for.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# one two-rank group each with a neighbour: the halo frames, their gradients,
# each recurrence's carry (the carry's gradient returns in its group)
KINDS = ("halo", "halo_grad", "forward", "backward")
# one two-rank group each with every rank of the line: the window frames a
# rank fetches, and their gradients on the way back
WINDOW_KINDS = ("window", "window_grad")


def _buffer(like: torch.Tensor, shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    return torch.empty(like.shape if shape is None else shape, dtype=like.dtype,
                       device=like.device)


@dataclass(frozen=True)
class WindowPlan:
    """Rank ``index``'s part of a TMSA block whose temporal windows of
    ``window`` frames, shifted by ``shift``, tile a clip of ``frames``
    frames padded to ``padded`` (``L = frames / ranks`` frames a rank; the
    arguments of :func:`window_plan`). Frame ``f`` sits at rolled position
    ``(f - shift) mod padded``, in window ``position // window``; positions
    past the clip are padding (zeros after ``norm1``).

    * ``windows``: the windows that hold the rank's frames, ascending;
    * ``sources``: for each of their ``window`` slots, in that order, the
      index of its frame in ``[own L frames, fetched frames, one zero
      frame]``;
    * ``fetch``: ``(owner's index on the line, global frames)`` of the
      fetched frames, in the order they are stacked;
    * ``post``: ``(reader's index, offsets of own frames)`` for each rank
      that reads some;
    * ``rows``: the windows grouped by which of their slots hold own frames:
      ``(indices into windows, own slots)``; a rank computes attention rows
      for its own frames only;
    * ``place``: for each own frame, ``(group, window in the group, slot
      in the group's own slots)``.
    """

    padded: int
    windows: Tuple[int, ...]
    sources: Tuple[int, ...]
    fetch: Tuple[Tuple[int, Tuple[int, ...]], ...]
    post: Tuple[Tuple[int, Tuple[int, ...]], ...]
    rows: Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]], ...]
    place: Tuple[Tuple[int, int, int], ...]

    @property
    def sends(self) -> bool:
        """Whether the block exchanges anything on this rank."""
        return bool(self.fetch or self.post)


def _members(frames: int, ranks: int, index: int, window: int, shift: int, padded: int):
    per = frames // ranks
    windows = sorted({((f - shift) % padded) // window for f in range(index * per,
                                                                      (index + 1) * per)})
    return windows, [[(w * window + p + shift) % padded for p in range(window)] for w in windows]


def _foreign(frames: int, ranks: int, index: int, window: int, shift: int, padded: int):
    """The real frames of rank ``index``'s windows that other ranks own."""
    per = frames // ranks
    _, members = _members(frames, ranks, index, window, shift, padded)
    return sorted({g for m in members for g in m if g < frames and g // per != index})


@lru_cache(maxsize=256)
def window_plan(frames: int, ranks: int, index: int, window: int, shift: int) -> WindowPlan:
    """The :class:`WindowPlan` of rank ``index`` of ``ranks`` for a clip of
    ``frames`` frames (a multiple of ``ranks``) and temporal windows of
    ``window`` frames shifted by ``shift`` (both after
    ``get_window_size`` on the whole clip). Every rank computes every
    rank's plan alike, so every rank agrees on who sends what."""
    if frames % ranks:
        raise ValueError(f"{frames} frames do not split into {ranks} equal blocks")
    per = frames // ranks
    padded = -(-frames // window) * window
    windows, members = _members(frames, ranks, index, window, shift, padded)
    need = _foreign(frames, ranks, index, window, shift, padded)
    fetched = {g: per + i for i, g in enumerate(need)}
    sources = tuple(per + len(need) if g >= frames
                    else g - index * per if g // per == index else fetched[g]
                    for m in members for g in m)
    fetch = tuple((j, tuple(g for g in need if g // per == j))
                  for j in sorted({g // per for g in need}))
    post = []
    for j in range(ranks):
        if j != index:
            mine = [g - index * per for g in _foreign(frames, ranks, j, window, shift, padded)
                    if g // per == index]
            if mine:
                post.append((j, tuple(mine)))
    own = [tuple(p for p, g in enumerate(m) if g < frames and g // per == index)
           for m in members]
    patterns = list(dict.fromkeys(own))
    rows = tuple((tuple(i for i, o in enumerate(own) if o == pat), pat) for pat in patterns)
    place = []
    for f in range(index * per, (index + 1) * per):
        i = next(i for i, m in enumerate(members) if f in m)
        g = patterns.index(own[i])
        place.append((g, rows[g][0].index(i), own[i].index(members[i].index(f))))
    return WindowPlan(padded, tuple(windows), sources, fetch, tuple(post), rows, tuple(place))


class TimeLinks:
    """This rank's links along its line of the time axis: its global rank,
    the line's global ranks in order, the line's group, and one two-rank
    process group for each kind of message with each rank of the line:
    :data:`KINDS` with its neighbours, :data:`WINDOW_KINDS` with every
    rank. ``prev_rank`` and ``next_rank`` are its neighbours (None at an
    end of the line)."""

    def __init__(self, rank: int, line: Sequence[int], pair_groups: Dict[Tuple[int, int], dict],
                 line_group=None):
        self.rank, self.line, self.line_group = rank, list(line), line_group
        self.index = self.line.index(rank)
        self.size = len(self.line)
        self.prev_rank = self.line[self.index - 1] if self.index > 0 else None
        self.next_rank = self.line[self.index + 1] if self.index + 1 < self.size else None
        self._groups = {}
        for (lo, hi), kinds in pair_groups.items():
            if rank in (lo, hi):
                self._groups[hi if lo == rank else lo] = kinds
        self.prev_groups = self._groups.get(self.prev_rank, {})
        self.next_groups = self._groups.get(self.next_rank, {})
        self._pending: List[Tuple[object, torch.Tensor]] = []

    # where a carry of each kind goes (downstream) and comes from (upstream)
    def _downstream(self, kind: str):
        if kind == "forward":
            return self.next_rank, self.next_groups.get(kind)
        return self.prev_rank, self.prev_groups.get(kind)

    def _upstream(self, kind: str):
        if kind == "forward":
            return self.prev_rank, self.prev_groups.get(kind)
        return self.next_rank, self.next_groups.get(kind)

    def _post(self, tensor: torch.Tensor, group) -> None:
        # a copy: gloo writes a CUDA broadcast's result back into the sender's
        # tensor too, which would bump the version of a tensor autograd holds
        tensor = tensor.detach().clone(memory_format=torch.contiguous_format)
        work = dist.broadcast(tensor, self.rank, group=group, async_op=True)
        self._pending.append((work, tensor))

    @staticmethod
    def _fetch(buf: torch.Tensor, src: int, group):
        return dist.broadcast(buf, src, group=group, async_op=True)

    def wait(self) -> None:
        """Wait for every send posted so far."""
        pending, self._pending = self._pending, []
        for work, _ in pending:
            work.wait()

    def check_frames(self, frames: int) -> None:
        """Raise on every rank of the line unless each holds ``frames``
        frames (one all-reduce on the line's group)."""
        got = torch.tensor([frames, -frames], dtype=torch.float32)
        if dist.get_backend(self.line_group) == "nccl":
            got = got.cuda()
        dist.all_reduce(got, dist.ReduceOp.MAX, group=self.line_group)
        if int(got[0]) != frames or int(-got[1]) != frames:
            raise ValueError(f"the ranks of a time line hold {int(-got[1])} to {int(got[0])} "
                             "frames: the clip's frames must split into equal blocks")

    def _exchange(self, sends: Dict[int, torch.Tensor], shapes: Dict[int, Sequence[int]],
                  like: torch.Tensor, kind: str) -> Dict[int, torch.Tensor]:
        """Send ``sends[j]`` to the rank at index ``j`` of the line and return
        what each rank at index ``j`` of ``shapes`` sends here (tensors of
        that shape, ``like``'s type), each pair over its ``kind`` group,
        the lower rank's message first."""
        got, works = {}, []
        for j in sorted(set(sends) | set(shapes)):
            peer = self.line[j]
            group = self._groups[peer][kind]
            order = ("post", "fetch") if self.rank < peer else ("fetch", "post")
            for step in order:
                if step == "post" and j in sends:
                    self._post(sends[j], group)
                elif step == "fetch" and j in shapes:
                    got[j] = _buffer(like, shapes[j])
                    works.append(self._fetch(got[j], peer, group))
        for work in works:
            work.wait()
        return got

    def _swap(self, to_prev: Optional[torch.Tensor], to_next: Optional[torch.Tensor],
              like: torch.Tensor, kind: str = "halo"
              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """Send ``to_prev`` to the previous rank and ``to_next`` to the next
        one, and return what each sends here (tensors shaped as ``like``;
        None where there is no neighbour), over the neighbours' ``kind``
        groups."""
        sends, shapes = {}, {}
        for j, t in ((self.index - 1, to_prev), (self.index + 1, to_next)):
            if 0 <= j < self.size:
                sends[j], shapes[j] = t, like.shape
        got = self._exchange(sends, shapes, like, kind)
        return got.get(self.index - 1), got.get(self.index + 1)

    def halo(self, first: torch.Tensor, last: torch.Tensor
             ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """``(previous rank's last frame, next rank's first frame)`` for this
        rank's ``first`` and ``last`` frames (None at the line's ends); their
        gradients return to their owners."""
        return _Halo.apply(self, first, last)

    def receive(self, kind: str, like: torch.Tensor) -> torch.Tensor:
        """The carry of the ``kind`` recurrence from upstream, shaped as
        ``like``; ``like`` itself where this rank starts the recurrence."""
        if self._upstream(kind)[0] is None:
            return like
        return _Receive.apply(self, kind, like, _anchor(like))

    def send(self, kind: str, carry: torch.Tensor) -> torch.Tensor:
        """Hand ``carry`` downstream; returns it (as a view that the caller
        uses in its place, whose gradient gains the receiver's)."""
        if self._downstream(kind)[0] is None:
            return carry
        return _Send.apply(self, kind, carry, _anchor(carry))

    def window_plan(self, frames: int, window: int, shift: int) -> WindowPlan:
        """This rank's :func:`window_plan`."""
        return window_plan(frames, self.size, self.index, window, shift)

    def window_frames(self, x: torch.Tensor, plan: WindowPlan) -> torch.Tensor:
        """The frames of ``plan.windows`` in rolled order, ``(B, len(windows)
        * window, H, W, C)`` in fp32, from this rank's frames ``x`` ``(B, L,
        H, W, C)``: its own, those fetched from their owners (sent in
        ``x``'s type), zeros for padding. fp32, so that the gradients of a
        frame's readers on every rank add up before they are rounded to
        ``x``'s type, once (their messages travel in fp32)."""
        x32 = x.float()
        parts = [x32]
        if plan.sends:
            parts.append(_Gather.apply(self, plan, x32, x.dtype, _anchor(x)))
        parts.append(x32.new_zeros((x.shape[0], 1, *x.shape[2:])))
        index = torch.tensor(plan.sources, device=x.device)
        return torch.cat(parts, 1).index_select(1, index)


def _anchor(like: torch.Tensor) -> Optional[torch.Tensor]:
    if not torch.is_grad_enabled():
        return None
    return torch.empty(0, device=like.device, requires_grad=True)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, links: TimeLinks, first, last):
        ctx.links = links
        return links._swap(first, last, first)

    @staticmethod
    def backward(ctx, grad_prev_last, grad_next_first):
        links = ctx.links
        like = grad_prev_last if grad_prev_last is not None else grad_next_first
        # each halo frame's gradient goes back to its owner; the previous rank
        # sends the gradient of this rank's first frame, the next rank its last's
        grad_first, grad_last = links._swap(grad_prev_last, grad_next_first, like, "halo_grad")
        return None, grad_first, grad_last


class _Receive(torch.autograd.Function):
    @staticmethod
    def forward(ctx, links: TimeLinks, kind: str, like, anchor):
        ctx.links, ctx.kind = links, kind
        src, group = links._upstream(kind)
        buf = _buffer(like)
        TimeLinks._fetch(buf, src, group).wait()
        return buf

    @staticmethod
    def backward(ctx, grad):
        _, group = ctx.links._upstream(ctx.kind)
        ctx.links._post(grad, group)
        return None, None, None, None


class _Send(torch.autograd.Function):
    @staticmethod
    def forward(ctx, links: TimeLinks, kind: str, carry, anchor):
        ctx.links, ctx.kind = links, kind
        _, group = links._downstream(kind)
        links._post(carry, group)
        return carry.view_as(carry)

    @staticmethod
    def backward(ctx, grad):
        dst, group = ctx.links._downstream(ctx.kind)
        back = _buffer(grad)
        TimeLinks._fetch(back, dst, group).wait()
        return None, None, grad + back, None


class _Gather(torch.autograd.Function):
    """The frames ``plan.fetch`` names, from their owners, stacked ``(B, n,
    H, W, C)`` in ``x``'s type; this rank's frames that others read go to
    them, in ``wire``'s type. The backward returns each fetched frame's
    gradient to its owner and adds the gradients that the readers of this
    rank's frames return."""

    @staticmethod
    def forward(ctx, links: TimeLinks, plan: WindowPlan, x, wire: torch.dtype, anchor):
        ctx.links, ctx.plan, ctx.shape = links, plan, x.shape
        rest = tuple(x.shape[2:])
        sends = {j: x[:, list(offsets)].to(wire) for j, offsets in plan.post}
        shapes = {j: (x.shape[0], len(frames), *rest) for j, frames in plan.fetch}
        got = links._exchange(sends, shapes, x.new_empty(0, dtype=wire), "window")
        if not got:
            return x.new_empty((x.shape[0], 0, *rest))
        return torch.cat([got[j] for j, _ in plan.fetch], 1).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        links, plan, shape = ctx.links, ctx.plan, ctx.shape
        sends, at = {}, 0
        for j, frames in plan.fetch:
            sends[j] = grad[:, at:at + len(frames)]
            at += len(frames)
        shapes = {j: (shape[0], len(offsets), *shape[2:]) for j, offsets in plan.post}
        got = links._exchange(sends, shapes, grad.new_empty(0), "window_grad")
        out = grad.new_zeros(shape)
        for j, offsets in plan.post:
            out.index_add_(1, torch.tensor(offsets, device=out.device), got[j])
        return None, None, out, None, None
