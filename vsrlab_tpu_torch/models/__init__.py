"""Models of the port: RealBasicVSR, BasicVSR, SpyNet, VRT, TinyVRT and the GAN's
UNetDiscriminator."""

from vsrlab_tpu_torch.models.basicvsr import BasicVSR
from vsrlab_tpu_torch.models.realbasicvsr import RealBasicVSR
from vsrlab_tpu_torch.models.spynet import SpyNet, SpyNetBasicModule
from vsrlab_tpu_torch.models.unet_discriminator import UNetDiscriminator
from vsrlab_tpu_torch.models.vrt import VRT, TinyVRT

__all__ = ["BasicVSR", "RealBasicVSR", "SpyNet", "SpyNetBasicModule", "TinyVRT",
           "UNetDiscriminator", "VRT"]
