"""Inter-frame video-compression degradation with a real severity knob
(port of the numpy path of ``vsrlab_tpu/data/codec_emulator.py``).

OpenCV's FFmpeg ``VideoWriter`` exposes no working rate control and there
is no PyAV / ffmpeg, so the degradation of an x264-style encode at a
sampled CRF is emulated: 8x8 block-DCT quantisation of motion residuals in
YCbCr with 4:2:0 chroma subsampling and a closed GOP. Training then sees
the artifacts of those codecs (blocking, ringing, chroma bleed, P-frame
error that accumulates over the GOP) with an exact quantiser;
:func:`crf_to_quality` maps a CRF onto the quantiser scale so that PSNR
falls about 0.5 dB a CRF step, as x264's does. The round trip runs in the
port's host library (:func:`vsrlab_tpu_torch.data.native.codec_degrade`)
where it is built; the numpy code here is its reference and the path
where it is not.
"""

from __future__ import annotations

import numpy as np

from vsrlab_tpu_torch.data import native

# libjpeg base quantisation tables (luma / chroma)
_Q_LUMA = np.array(
    [[16, 11, 10, 16, 24, 40, 51, 61],
     [12, 12, 14, 19, 26, 58, 60, 55],
     [14, 13, 16, 24, 40, 57, 69, 56],
     [14, 17, 22, 29, 51, 87, 80, 62],
     [18, 22, 37, 56, 68, 109, 103, 77],
     [24, 35, 55, 64, 81, 104, 113, 92],
     [49, 64, 78, 87, 103, 121, 120, 101],
     [72, 92, 95, 98, 112, 100, 103, 99]], np.float32)
_Q_CHROMA = np.full((8, 8), 99, np.float32)
_Q_CHROMA[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99], [47, 66, 99, 99]]


def _dct_basis(n: int = 8) -> np.ndarray:
    k = np.arange(n)[:, None].astype(np.float64)
    x = np.arange(n)[None, :].astype(np.float64)
    b = np.cos(np.pi * (2 * x + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    b[0] /= np.sqrt(2.0)
    return b.astype(np.float32)


_B = _dct_basis(8)


def _scale_table(table: np.ndarray, quality: float) -> np.ndarray:
    """libjpeg's quality scaling (1 worst .. 100 near lossless)."""
    q = float(np.clip(quality, 1, 100))
    scale = 5000.0 / q if q < 50 else 200.0 - 2.0 * q
    return np.clip(np.floor((table * scale + 50.0) / 100.0), 1.0, 255.0)


def _quantize_plane(plane: np.ndarray, qtab: np.ndarray) -> np.ndarray:
    """DCT -> quantise -> dequantise -> inverse DCT of the 8x8 blocks of one
    ``(H, W)`` plane (H, W multiples of 8; residual units in [-255, 255])."""
    h, w = plane.shape
    blocks = plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)
    coef = np.einsum("kn,bcnm,lm->bckl", _B, blocks, _B)
    coef = np.rint(coef / qtab) * qtab
    out = np.einsum("kn,bckl,lm->bcnm", _B, coef, _B)
    return out.transpose(0, 2, 1, 3).reshape(h, w)


def _rgb_to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    m = np.array([[0.299, 0.587, 0.114], [-0.168736, -0.331264, 0.5],
                  [0.5, -0.418688, -0.081312]], np.float32)
    out = rgb @ m.T
    out[..., 1:] += 0.5
    return out


def _ycbcr_to_rgb(ycc: np.ndarray) -> np.ndarray:
    y, cb, cr = ycc[..., 0], ycc[..., 1] - 0.5, ycc[..., 2] - 0.5
    return np.stack([y + 1.402 * cr, y - 0.344136 * cb - 0.714136 * cr, y + 1.772 * cb],
                    axis=-1)


def _sub2(p: np.ndarray) -> np.ndarray:
    return 0.25 * (p[0::2, 0::2] + p[1::2, 0::2] + p[0::2, 1::2] + p[1::2, 1::2])


def _up2(p: np.ndarray) -> np.ndarray:
    return np.repeat(np.repeat(p, 2, axis=0), 2, axis=1)


def crf_to_quality(crf: float) -> float:
    """x264-style CRF -> the emulator's quantiser quality: the emulator's
    PSNR is about linear in ``log(quality)``, and this mapping makes it fall
    about 0.5 dB a CRF step over the training range CRF 18-40."""
    return float(np.clip(np.exp(6.6 - 0.118 * float(crf)), 2.0, 100.0))


def dct_codec_roundtrip(clip: np.ndarray, quality: float, gop: int = 8,
                        subsample_chroma: bool = True, force_numpy: bool = False) -> np.ndarray:
    """Closed-GOP IPPP... codec round trip of a float32 clip ``(T, H, W, 3)``
    in [0, 1]: an I-frame quantises the frame's DCT, a P-frame the DCT of
    its residual against the previous *reconstructed* frame, so the
    quantisation error travels through the GOP as in a real inter codec.
    Frames are edge-padded to multiples of 16 (chroma planes to 8). The
    native library runs it where built; ``force_numpy`` takes the numpy
    path here."""
    gop = max(1, int(gop))
    if not force_numpy:
        fast = native.codec_degrade(clip, quality, gop, subsample_chroma)
        if fast is not None:
            return fast
    t, h, w, _ = clip.shape
    ph, pw = (-h) % 16, (-w) % 16
    padded = np.pad(clip, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="edge")
    ycc = _rgb_to_ycbcr(padded.astype(np.float32)) * 255.0
    q_l, q_c = _scale_table(_Q_LUMA, quality), _scale_table(_Q_CHROMA, quality)
    recon = np.empty_like(ycc)
    prev = None
    for i in range(t):
        is_i = (i % gop) == 0 or prev is None
        planes = []
        for c in range(3):
            p = ycc[i, :, :, c]
            if c > 0 and subsample_chroma:
                p = _sub2(p)
            ref = np.zeros_like(p) if is_i else prev[c]
            planes.append(ref + _quantize_plane(p - ref, q_l if c == 0 else q_c))
        prev = planes
        cb = _up2(planes[1]) if subsample_chroma else planes[1]
        cr = _up2(planes[2]) if subsample_chroma else planes[2]
        recon[i] = np.stack([planes[0], cb, cr], axis=-1)
    rgb = _ycbcr_to_rgb(recon / 255.0)
    return np.clip(rgb[:, :h, :w], 0.0, 1.0).astype(np.float32)
