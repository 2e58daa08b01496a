"""Utilities of the port: deterministic seeding, the program's spans,
counters, profiler traces and timing (:mod:`vsrlab_tpu_torch.utils.profiler`),
and a call's replay as a CUDA graph (:mod:`vsrlab_tpu_torch.utils.graphs`)."""

from vsrlab_tpu_torch.utils.seed import seed_everything, seed_index_everything

__all__ = ["seed_everything", "seed_index_everything"]
