"""VRT family: window attention, TMSA blocks, flow-guided deformable
alignment, stages and the VRT / TinyVRT models (port of
``vsrlab_tpu/models/vrt``)."""

from vsrlab_tpu_torch.models.vrt.deform import FlowGuidedDeformAlign
from vsrlab_tpu_torch.models.vrt.stage import Stage
from vsrlab_tpu_torch.models.vrt.tmsa import RTMSA, TMSA, TMSAG
from vsrlab_tpu_torch.models.vrt.vrt import VRT, TinyVRT
from vsrlab_tpu_torch.models.vrt.window_attention import (
    MlpGEGLU,
    WindowAttention,
    compute_mask,
    compute_mask_factored,
    get_window_size,
    window_partition,
    window_reverse,
)

__all__ = [
    "FlowGuidedDeformAlign", "MlpGEGLU", "RTMSA", "Stage", "TMSA", "TMSAG", "TinyVRT", "VRT",
    "WindowAttention", "compute_mask", "compute_mask_factored", "get_window_size",
    "window_partition", "window_reverse",
]
