"""Component registry of the port: the ``_target_`` names a config of this
slice (supervised RealBasicVSR / BasicVSR training) instantiates.

Importing this module fills :data:`vsrlab_tpu_torch.core.config.REGISTRY`.
Names the JAX package's configs use for components the port does not have
yet raise on instantiation, saying which slice brings them.
"""

from __future__ import annotations

import functools

from vsrlab_tpu_torch.core.config import NOT_PORTED, register
from vsrlab_tpu_torch.core.loggers import JsonlLogger, build_logger
from vsrlab_tpu_torch.core.metrics import MetricCollection
from vsrlab_tpu_torch.data import DatasetVSR, SyntheticVSR, ValDatasetVSR
from vsrlab_tpu_torch.models import BasicVSR, RealBasicVSR

register("RealBasicVSR", RealBasicVSR)
register("BasicVSR", BasicVSR)
register("DatasetVSR", DatasetVSR)
register("ValDatasetVSR", ValDatasetVSR)
register("SyntheticVSR", SyntheticVSR)
register("MetricCollection", MetricCollection)
register("Logger", build_logger)
register("JsonlLogger", JsonlLogger)


def _spec(name: str, **kw) -> tuple:
    return name, kw


# optimizers and schedules resolve to (name, kwargs) specs, which
# vsrlab_tpu_torch.train.builders turns into a torch optimizer and a schedule
for _name in ("adam", "adamw", "sgd", "cosine", "cosine_warmup"):
    register(_name, functools.partial(_spec, _name))

_GAN = "the GAN slice (ROADMAP queue 1, item 11)"
_FLOW = "the flow slice (ROADMAP queue 1, item 13)"
NOT_PORTED.update({
    "UNetDiscriminator": _GAN, "PerceptualLoss": _GAN, "vsrlab.core.losses.PerceptualLoss": _GAN,
    "AdversarialLoss": _GAN, "vsrlab.core.losses.AdversarialLoss": _GAN,
    "CharbonnierLoss": _GAN, "vsrlab.core.losses.CharbonnierLoss": _GAN, "WL1Loss": _GAN,
    "LossPipeline": _GAN,
    "SpyNet": _FLOW, "RAFT": _FLOW, "IRRPWCNet": _FLOW, "SpyNetProgressive": _FLOW,
    "FlowDataset": _FLOW, "SyntheticFlowDataset": _FLOW, "EPELoss": _FLOW,
    "OpticalFlowConsistency": _FLOW,
    "VRT": "VRT training, which needs a backward of the deformable sampler (ROADMAP queue 1)",
    "TinyVRT": "VRT training, which needs a backward of the deformable sampler (ROADMAP queue 1)",
    "VideoDatasetVSR": "the video I/O of the upscale slice (ROADMAP queue 1, item 9)",
    "WandbLogger": "no slice: wandb is not ported", "vsrlab.core.loggers.WandbLogger":
    "no slice: wandb is not ported",
})
