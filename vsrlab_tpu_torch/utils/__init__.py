"""Utilities of the port: deterministic seeding, profiling and timing
(:mod:`vsrlab_tpu_torch.utils.profiler`)."""

from vsrlab_tpu_torch.utils.seed import seed_everything, seed_index_everything

__all__ = ["seed_everything", "seed_index_everything"]
