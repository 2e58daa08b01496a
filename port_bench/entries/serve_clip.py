"""Entry ``serve_clip``: one forward over the whole clip. A request runs
``make_forward(model)(clip)`` from ``vsrlab_tpu_torch.evaluation.harness``
and returns the SR frames on the card."""

from __future__ import annotations

from port_bench.serving import ServeEntry


class Entry(ServeEntry):
    def program_forward(self, model):
        from vsrlab_tpu_torch.evaluation.harness import make_forward

        return make_forward(model, device=self.device)

    def request(self, clip):
        return self.forward(clip)
