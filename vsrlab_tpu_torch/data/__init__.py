"""Host-side data of the port: numpy clips ``(T, H, W, C)`` in [0, 1] from
datasets, batched ``(B, T, H, W, C)`` by a threaded loader that copies
each batch to the device one batch ahead."""

from vsrlab_tpu_torch.data.datasets import (
    DatasetVSR, SyntheticVSR, ValDatasetVSR, VideoDatasetVSR, build_pipeline)
from vsrlab_tpu_torch.data.loader import DataLoader

__all__ = ["DataLoader", "DatasetVSR", "SyntheticVSR", "ValDatasetVSR", "VideoDatasetVSR",
           "build_pipeline"]
