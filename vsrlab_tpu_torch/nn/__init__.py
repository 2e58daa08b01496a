"""Building blocks of the port, channels-last: frames ``(B, H, W, C)``,
clips ``(B, T, H, W, C)``, tokens ``(B, T, P, C)``."""

from vsrlab_tpu_torch.nn.blocks import (
    ConvLeaky,
    ConvReLU,
    ConvST,
    ConvSTBlock,
    DeformBlock,
    DeformConvPack,
    IterativeRefinement,
    PixelShufflePack,
    PixelShufflePack3D,
    ResidualBlock,
    ResidualConv,
    SpectralConv,
)
from vsrlab_tpu_torch.nn.dct import DecoderIDCT, EncoderDCT
from vsrlab_tpu_torch.nn.mlp import MixerBlock, Mlp, MlpMixer

__all__ = [
    "ConvReLU",
    "ConvLeaky",
    "SpectralConv",
    "ResidualConv",
    "ResidualBlock",
    "ConvST",
    "ConvSTBlock",
    "PixelShufflePack",
    "PixelShufflePack3D",
    "IterativeRefinement",
    "DeformConvPack",
    "DeformBlock",
    "Mlp",
    "MixerBlock",
    "MlpMixer",
    "EncoderDCT",
    "DecoderIDCT",
]
