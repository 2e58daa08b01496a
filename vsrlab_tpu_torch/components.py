"""Component registry of the port: the ``_target_`` names a config
instantiates (supervised RealBasicVSR / BasicVSR / BasicVSR++ / VRT /
TinyVRT training; GAN fine-tuning with its discriminator and losses; the
serving entry points rebuild a model from a run's config snapshot; the
optical-flow models, datasets and losses).

Importing this module fills :data:`vsrlab_tpu_torch.core.config.REGISTRY`.
Names the JAX package's configs use for components the port does not have
yet raise on instantiation, saying which slice brings them.
"""

from __future__ import annotations

import functools

from vsrlab_tpu_torch.core.config import NOT_PORTED, register
from vsrlab_tpu_torch.core.loggers import JsonlLogger, build_logger
from vsrlab_tpu_torch.core.losses import (
    LossPipeline, OpticalFlowConsistency, adversarial_loss, charbonnier_loss, epe_loss, l1_loss)
from vsrlab_tpu_torch.core.metrics import MetricCollection
from vsrlab_tpu_torch.core.perceptual import PerceptualLoss
from vsrlab_tpu_torch.data import DatasetVSR, SyntheticVSR, ValDatasetVSR, VideoDatasetVSR
from vsrlab_tpu_torch.data.flow_dataset import FlowDataset, SyntheticFlowDataset
from vsrlab_tpu_torch.models import (
    VRT, BasicVSR, BasicVSRPlusPlus, RealBasicVSR, SpyNet, TinyVRT, UNetDiscriminator)
from vsrlab_tpu_torch.models.flow import RAFT, IRRPWCNet, SpyNetProgressive

register("RealBasicVSR", RealBasicVSR)
register("BasicVSR", BasicVSR)
register("BasicVSRPlusPlus", BasicVSRPlusPlus)
register("DatasetVSR", DatasetVSR)
register("ValDatasetVSR", ValDatasetVSR)
register("VideoDatasetVSR", VideoDatasetVSR)
# VRT and TinyVRT serve and train: both sampler routes of the deformable
# alignment have a gradient (the kernel forward, PyTorch ops backward)
register("VRT", VRT)
register("TinyVRT", TinyVRT)
register("SyntheticVSR", SyntheticVSR)
register("SpyNet", SpyNet)
register("RAFT", RAFT)
register("IRRPWCNet", IRRPWCNet)
register("SpyNetProgressive", SpyNetProgressive)
register("FlowDataset", FlowDataset)
register("SyntheticFlowDataset", SyntheticFlowDataset)
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
register("EPELoss", lambda: epe_loss)
register("OpticalFlowConsistency", OpticalFlowConsistency)


def _spec(name: str, **kw) -> tuple:
    return name, kw


# optimizers and schedules resolve to (name, kwargs) specs, which
# vsrlab_tpu_torch.train.builders turns into a torch optimizer and a schedule
for _name in ("adam", "adamw", "sgd", "cosine", "cosine_warmup"):
    register(_name, functools.partial(_spec, _name))

NOT_PORTED.update({
    "WandbLogger": "no slice: wandb is not ported", "vsrlab.core.loggers.WandbLogger":
    "no slice: wandb is not ported",
})
