"""Models of the port: RealBasicVSR, BasicVSR, BasicVSR++, SpyNet, VRT, TinyVRT,
the GAN's UNetDiscriminator; the optical-flow models are in :mod:`vsrlab_tpu_torch.models.flow`."""

from vsrlab_tpu_torch.models.basicvsr import BasicVSR
from vsrlab_tpu_torch.models.basicvsr_pp import BasicVSRPlusPlus
from vsrlab_tpu_torch.models.realbasicvsr import RealBasicVSR
from vsrlab_tpu_torch.models.spynet import SpyNet, SpyNetBasicModule
from vsrlab_tpu_torch.models.unet_discriminator import UNetDiscriminator
from vsrlab_tpu_torch.models.vrt import VRT, TinyVRT

__all__ = ["BasicVSR", "BasicVSRPlusPlus", "RealBasicVSR", "SpyNet", "SpyNetBasicModule",
           "TinyVRT", "UNetDiscriminator", "VRT"]
