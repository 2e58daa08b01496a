"""Host-side data of the port: numpy clips ``(T, H, W, C)`` in [0, 1] from
datasets, degraded by augmentation pipelines (JPEG, the video-codec
emulator, crops, flips, resizes), batched ``(B, T, H, W, C)`` by a
threaded loader that copies each batch to the device one batch ahead;
video file I/O and the making of degraded LR videos (``compress_video*``)."""

from vsrlab_tpu_torch.data.augmentations import (
    Mirroring, RandomCrop, RandomFlip, RandomJPEGCompression, RandomVideoCompression, Resize,
    build_pipeline)
from vsrlab_tpu_torch.data.codec_emulator import crf_to_quality, dct_codec_roundtrip
from vsrlab_tpu_torch.data.datasets import DatasetVSR, SyntheticVSR, ValDatasetVSR, VideoDatasetVSR
from vsrlab_tpu_torch.data.loader import DataLoader
from vsrlab_tpu_torch.data.video_io import compress_video, compress_video_folder

__all__ = ["DataLoader", "DatasetVSR", "Mirroring", "RandomCrop", "RandomFlip",
           "RandomJPEGCompression", "RandomVideoCompression", "Resize", "SyntheticVSR",
           "ValDatasetVSR", "VideoDatasetVSR", "build_pipeline", "compress_video",
           "compress_video_folder", "crf_to_quality", "dct_codec_roundtrip"]
