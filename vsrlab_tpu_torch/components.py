"""Component registry of the port: the ``_target_`` names a config
instantiates (supervised RealBasicVSR / BasicVSR training; GAN fine-tuning
with its discriminator and losses; VRT / TinyVRT, which the serving entry
points rebuild from a run's config snapshot).

Importing this module fills :data:`vsrlab_tpu_torch.core.config.REGISTRY`.
Names the JAX package's configs use for components the port does not have
yet raise on instantiation, saying which slice brings them.
"""

from __future__ import annotations

import functools

from vsrlab_tpu_torch.core.config import NOT_PORTED, register
from vsrlab_tpu_torch.core.loggers import JsonlLogger, build_logger
from vsrlab_tpu_torch.core.losses import (
    LossPipeline, adversarial_loss, charbonnier_loss, l1_loss)
from vsrlab_tpu_torch.core.metrics import MetricCollection
from vsrlab_tpu_torch.core.perceptual import PerceptualLoss
from vsrlab_tpu_torch.data import DatasetVSR, SyntheticVSR, ValDatasetVSR, VideoDatasetVSR
from vsrlab_tpu_torch.models import VRT, BasicVSR, RealBasicVSR, TinyVRT, UNetDiscriminator

register("RealBasicVSR", RealBasicVSR)
register("BasicVSR", BasicVSR)
register("DatasetVSR", DatasetVSR)
register("ValDatasetVSR", ValDatasetVSR)
register("VideoDatasetVSR", VideoDatasetVSR)
# VRT and TinyVRT serve; training them raises in the deformable sampler,
# which has no backward yet (ROADMAP queue 1, item 7)
register("VRT", VRT)
register("TinyVRT", TinyVRT)
register("SyntheticVSR", SyntheticVSR)
register("UNetDiscriminator", UNetDiscriminator)
register("MetricCollection", MetricCollection)
register("Logger", build_logger)
register("JsonlLogger", JsonlLogger)


def _adversarial(weight: float = 2e-5):
    return lambda x, target, is_disc=False: adversarial_loss(x, target, is_disc, weight)


def _charbonnier(eps: float = 1e-9):
    return lambda x, y: charbonnier_loss(x, y, eps)


# losses, config-instantiable, under their names and the reference's
for _prefix in ("", "vsrlab.core.losses."):
    register(f"{_prefix}PerceptualLoss", PerceptualLoss)
    register(f"{_prefix}AdversarialLoss", _adversarial)
    register(f"{_prefix}CharbonnierLoss", _charbonnier)
register("WL1Loss", lambda weight=1.0: lambda x, y: l1_loss(x, y, weight))
register("LossPipeline", LossPipeline)


def _spec(name: str, **kw) -> tuple:
    return name, kw


# optimizers and schedules resolve to (name, kwargs) specs, which
# vsrlab_tpu_torch.train.builders turns into a torch optimizer and a schedule
for _name in ("adam", "adamw", "sgd", "cosine", "cosine_warmup"):
    register(_name, functools.partial(_spec, _name))

_FLOW = "the flow slice (ROADMAP queue 1, item 5)"
NOT_PORTED.update({
    "SpyNet": _FLOW, "RAFT": _FLOW, "IRRPWCNet": _FLOW, "SpyNetProgressive": _FLOW,
    "FlowDataset": _FLOW, "SyntheticFlowDataset": _FLOW, "EPELoss": _FLOW,
    "OpticalFlowConsistency": _FLOW,
    "WandbLogger": "no slice: wandb is not ported", "vsrlab.core.loggers.WandbLogger":
    "no slice: wandb is not ported",
})
