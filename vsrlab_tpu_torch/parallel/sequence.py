"""The exchanges between neighbours on the ``time`` axis of a mesh: what
sequence-parallel training of a recurrent model hands across a shard's
edge (the JAX package leaves them to XLA's partitioner,
``vsrlab_tpu/parallel/mesh.py:116-130``).

A rank that holds frames ``[k L, (k + 1) L)`` of each clip talks to its two
neighbours on its line of the axis (``k - 1`` and ``k + 1``; the line's ends
have one):

* :meth:`TimeLinks.halo` hands its first frame to ``k - 1`` and its last to
  ``k + 1`` and receives theirs (a one-frame halo each way); in the
  backward the halo frames' gradients go back to their owners.
* :meth:`TimeLinks.send` and :meth:`TimeLinks.receive` pass a recurrence's
  carry downstream: the ``"forward"`` recurrence's from ``k`` to ``k + 1``,
  the ``"backward"`` one's from ``k`` to ``k - 1``. In the backward the
  carry's gradient comes back, unscaled, from the receiver to the sender,
  which adds it to its own.

Every message is one ``broadcast`` in a two-rank process group (gloo
implements ``broadcast`` and ``all_reduce`` only for CUDA tensors; NCCL
takes the same path). Each pair of neighbours has one group for each kind
of message (``KINDS``), so that a group carries one message a pass each
way in one fixed order whatever order autograd's engine runs the
backward's nodes in; within the halo group the lower rank's message goes
first. Sends do not block (``async_op=True``): a rank waits only for what
it receives. The links wait for their pending sends at the start and end
of each forward (:meth:`TimeLinks.wait`); a backward's sends are waited for
by the next forward.

A receiver's node and a sender's node take an ``anchor`` (a fresh leaf
that requires a gradient where grad mode is on), so both are recorded
exactly when grad mode is on: each rank then posts every message its
neighbour waits for.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

# one two-rank group each with a neighbour: the halo frames, each recurrence's carry
KINDS = ("halo", "forward", "backward")


def _buffer(like: torch.Tensor) -> torch.Tensor:
    return torch.empty(like.shape, dtype=like.dtype, device=like.device)


class TimeLinks:
    """This rank's links along its line of the time axis: its global rank,
    its neighbours' (None at an end of the line) and, with each neighbour,
    one process group for each of :data:`KINDS`."""

    def __init__(self, rank: int, prev_rank: Optional[int], next_rank: Optional[int],
                 prev_groups: Dict[str, object], next_groups: Dict[str, object]):
        self.rank, self.prev_rank, self.next_rank = rank, prev_rank, next_rank
        self.prev_groups, self.next_groups = prev_groups, next_groups
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

    def _swap(self, to_prev: Optional[torch.Tensor], to_next: Optional[torch.Tensor],
              like: torch.Tensor) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """Send ``to_prev`` to the previous rank and ``to_next`` to the next
        one, and return what each sends here (tensors shaped as ``like``;
        None where there is no neighbour). In each pair's halo group the
        lower rank's message goes first."""
        got_prev = got_next = None
        works = []
        if self.prev_rank is not None:
            group = self.prev_groups["halo"]
            got_prev = _buffer(like)
            works.append(self._fetch(got_prev, self.prev_rank, group))
            self._post(to_prev, group)
        if self.next_rank is not None:
            group = self.next_groups["halo"]
            self._post(to_next, group)
            got_next = _buffer(like)
            works.append(self._fetch(got_next, self.next_rank, group))
        for work in works:
            work.wait()
        return got_prev, got_next

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
        grad_first, grad_last = links._swap(grad_prev_last, grad_next_first, like)
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
