"""Models of the port: RealBasicVSR, BasicVSR and SpyNet."""

from vsrlab_tpu_torch.models.basicvsr import BasicVSR
from vsrlab_tpu_torch.models.realbasicvsr import RealBasicVSR
from vsrlab_tpu_torch.models.spynet import SpyNet, SpyNetBasicModule

__all__ = ["BasicVSR", "RealBasicVSR", "SpyNet", "SpyNetBasicModule"]
