"""Entry ``serve_windows``: the evaluation harness's path. A request runs
``windowed_inference(make_forward(model), clip, window)`` from
``vsrlab_tpu_torch.evaluation.harness``: the clip cut into windows of
``window`` frames (the last padded with its last frame), the windows run
as one batch, the result restitched. With more than one chip the windows
are split over a mesh ``create_mesh({"time": chips})`` and gathered on
every rank; rank 0 copies the frames to the host.

A further fault on more than one chip: ``exchange`` leaves out the
gather's broadcasts (each rank keeps zeros where the other ranks' windows
belong).
"""

from __future__ import annotations

from port_bench.serving import SERVE_FAULTS, ServeEntry


class Entry(ServeEntry):
    faults = SERVE_FAULTS + ("exchange",)

    def setup(self):
        from vsrlab_tpu_torch.evaluation import harness
        from vsrlab_tpu_torch.parallel import create_mesh

        self.harness = harness
        self.window = int(self.traffic["window"])
        self.mesh = create_mesh({"time": self.ranks.world}) if self.ranks.world > 1 else None
        if self.fault == "exchange":
            def no_exchange(local, mesh):
                ranks = mesh.axis_ranks("time")
                full = local.new_zeros((local.shape[0] * len(ranks), *local.shape[1:]))
                j = ranks.index(mesh.rank)
                full[j * local.shape[0]:(j + 1) * local.shape[0]] = local
                return full

            harness._gather_windows = no_exchange
        super().setup()

    def program_forward(self, model):
        return self.harness.make_forward(model, device=self.device)

    def request(self, clip):
        sr, _ = self.harness.windowed_inference(self.forward, clip, self.window, self.mesh)
        return sr

    def windows_of(self, clip):
        t, w = clip.shape[1], self.window
        return [(s, min(w, t - s), w - min(w, t - s)) for s in range(0, t, w)]
