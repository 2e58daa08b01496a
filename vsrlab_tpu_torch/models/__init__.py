"""Models of the port: RealBasicVSR, BasicVSR, SpyNet, VRT and TinyVRT."""

from vsrlab_tpu_torch.models.basicvsr import BasicVSR
from vsrlab_tpu_torch.models.realbasicvsr import RealBasicVSR
from vsrlab_tpu_torch.models.spynet import SpyNet, SpyNetBasicModule
from vsrlab_tpu_torch.models.vrt import VRT, TinyVRT

__all__ = ["BasicVSR", "RealBasicVSR", "SpyNet", "SpyNetBasicModule", "TinyVRT", "VRT"]
