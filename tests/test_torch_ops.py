"""vsrlab_tpu_torch.ops against vsrlab_tpu.ops on the CPU.

The same numpy inputs (seeded) go through the JAX function and its port.
Tolerances: layout ops (pixel shuffle) and integer-flow warps must be
exact; fp32 arithmetic that may sum in another order gets 1e-5 (resizes,
bilinear taps) or 1e-6 (2x2 average pooling).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vsrlab_tpu.ops.pixel_shuffle import pixel_shuffle, pixel_unshuffle  # noqa: E402
from vsrlab_tpu_torch.ops import pixel_shuffle as tps  # noqa: E402
from vsrlab_tpu_torch.ops import pooling as tpool  # noqa: E402
from vsrlab_tpu_torch.ops import resize as trs  # noqa: E402
from vsrlab_tpu_torch.ops import warp as twarp  # noqa: E402

# vsrlab_tpu.ops re-exports functions under its module names
jpool = importlib.import_module("vsrlab_tpu.ops.pooling")
jrs = importlib.import_module("vsrlab_tpu.ops.resize")
jwarp = importlib.import_module("vsrlab_tpu.ops.warp")


def _both(fn_j, fn_t, *arrays, **kw):
    got = fn_t(*[torch.from_numpy(np.array(a)) for a in arrays], **kw)
    want = fn_j(*[jnp.asarray(a) for a in arrays], **kw)
    return got.numpy(), np.asarray(want)


def test_pixel_shuffle_roundtrip_matches_jax(rng):
    x = rng.standard_normal((2, 5, 6, 12)).astype(np.float32)
    got, want = _both(pixel_shuffle, tps.pixel_shuffle, x, upscale_factor=2)
    np.testing.assert_array_equal(got, want)
    got, want = _both(pixel_unshuffle, tps.pixel_unshuffle, want, downscale_factor=2)
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(want, x)


@pytest.mark.parametrize("shape,k,s", [((2, 9, 10, 3), 2, None), ((1, 3, 11, 12, 4), 3, 2)])
def test_avg_pool2d_matches_jax(rng, shape, k, s):
    x = rng.standard_normal(shape).astype(np.float32)
    got, want = _both(jpool.avg_pool2d, tpool.avg_pool2d, x, kernel_size=k, stride=s)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
@pytest.mark.parametrize("size", [(23, 17), (7, 40)])
def test_resize_matches_jax(rng, method, align_corners, size):
    x = rng.standard_normal((2, 12, 20, 3)).astype(np.float32)
    fj = getattr(jrs, f"resize_{method}")
    ft = getattr(trs, f"resize_{method}")
    got, want = _both(fj, ft, x, size=size, align_corners=align_corners)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_resize_trilinear_and_scale_by_match_jax(rng):
    x = rng.standard_normal((1, 4, 6, 8, 2)).astype(np.float32)
    got, want = _both(jrs.resize_trilinear, trs.resize_trilinear, x, size=(6, 12, 10),
                      align_corners=False)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    x = rng.standard_normal((2, 9, 10, 3)).astype(np.float32)
    got, want = _both(jrs.scale_by, trs.scale_by, x, factor=2.5, method="bicubic")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_resize_keeps_bf16(rng):
    x = torch.from_numpy(rng.standard_normal((1, 6, 8, 3)).astype(np.float32)).bfloat16()
    assert trs.resize_bilinear(x, (12, 16)).dtype == torch.bfloat16


MODES = [
    (interp, pad, ac)
    for interp in ("bilinear", "nearest")
    for pad in ("zeros", "border", "reflection")
    for ac in (True, False)
]


@pytest.mark.parametrize("interp,pad,ac", MODES)
def test_flow_warp_matches_jax(rng, interp, pad, ac):
    x = rng.standard_normal((2, 9, 13, 4)).astype(np.float32)
    # displacements up to 6 px: many samples leave the image
    flow = (rng.standard_normal((2, 9, 13, 2)) * 3.0).astype(np.float32)
    kw = dict(interpolation=interp, padding_mode=pad, align_corners=ac)
    got, want = _both(jwarp.flow_warp, twarp.flow_warp, x, flow, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("interp,pad,ac", MODES)
def test_grid_sample_matches_jax(rng, interp, pad, ac):
    x = rng.standard_normal((2, 8, 11, 3)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 5, 7, 2)).astype(np.float32)
    kw = dict(mode=interp, padding_mode=pad, align_corners=ac)
    got, want = _both(jwarp.grid_sample, twarp.grid_sample, x, grid, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pad", ["zeros", "border"])
def test_flow_warp_integer_flow_is_exact(rng, pad):
    """An integer flow samples whole pixels: bit-exact, in JAX and the port."""
    x = rng.standard_normal((1, 10, 12, 5)).astype(np.float32)
    flow = np.zeros((1, 10, 12, 2), np.float32)
    flow[..., 0], flow[..., 1] = 2.0, -1.0
    got, want = _both(jwarp.flow_warp, twarp.flow_warp, x, flow, padding_mode=pad)
    np.testing.assert_array_equal(got, want)
    # pixel (y, x) reads (y - 1, x + 2)
    np.testing.assert_array_equal(got[:, 1:, :-2], x[:, :-1, 2:])


def test_flow_warp_bf16_computes_fp32_returns_bf16(rng):
    x = rng.standard_normal((1, 6, 7, 8)).astype(np.float32)
    flow = (rng.standard_normal((1, 6, 7, 2)) * 2).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    got = twarp.flow_warp(xb, torch.from_numpy(flow))
    assert got.dtype == torch.bfloat16
    want = jwarp.flow_warp(jnp.asarray(xb.float().numpy(), jnp.bfloat16), jnp.asarray(flow))
    # both sum in fp32 and round once to bf16: at most one bf16 rounding apart
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2**-7, atol=2**-7)
