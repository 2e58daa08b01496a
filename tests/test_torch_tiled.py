"""vsrlab_tpu_torch's tiled inference against vsrlab_tpu's on the CPU: the
same tiling grid and the same blended output for tests/test_tiled.py's
cases, on seeded numpy inputs (fp32; rtol 1e-6, both sides add the same
tiles and divide by the same counts)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vsrlab_tpu.evaluation import tiled as jtiled  # noqa: E402
from vsrlab_tpu_torch.evaluation import tiled  # noqa: E402


def _upscale4(x):
    """Per-pixel 4x nearest upsample plus an affine map, on either
    framework's array: tile-invariant, so tiled == full exactly."""
    rep = (lambda a, ax: jnp.repeat(a, 4, axis=ax)) if isinstance(x, jnp.ndarray) else \
        (lambda a, ax: a.repeat_interleave(4, dim=ax))
    return rep(rep(x, 2), 3) * 2.0 + 1.0


def _position_dependent(x):
    """A forward whose output depends on where the tile was cut (it adds
    the tile's own column ramp), so the overlap average itself is compared."""
    y = _upscale4(x)
    ramp = np.linspace(0.0, 1.0, y.shape[3], dtype=np.float32)[None, None, None, :, None]
    return y + (jnp.asarray(ramp) if isinstance(x, jnp.ndarray) else torch.from_numpy(ramp))


@pytest.mark.parametrize("size,tile,stride", [(24, 16, 8), (36, 16, 8), (8, 64, 56), (17, 16, 15),
                                              (40, 16, 16)])
def test_tile_starts_match_jax(size, tile, stride):
    assert list(tiled._tile_starts(size, tile, stride)) == list(
        jtiled._tile_starts(size, tile, stride))


@pytest.mark.parametrize("fn", [_upscale4, _position_dependent], ids=["pointwise", "ramp"])
@pytest.mark.parametrize("shape,tile,overlap", [((1, 2, 24, 36, 3), (16, 16), 8),
                                                ((1, 2, 8, 8, 3), (64, 64), 8),
                                                ((2, 1, 20, 17, 2), (12, 16), 4)])
def test_tiled_forward_matches_jax(rng, fn, shape, tile, overlap):
    lr = rng.random(shape).astype(np.float32)
    want = jtiled.tiled_forward(fn, jnp.asarray(lr), tile=tile, overlap=overlap, jit=False)
    got = tiled.tiled_forward(fn, torch.from_numpy(lr), tile=tile, overlap=overlap)
    assert got.shape == (shape[0], shape[1], 4 * shape[2], 4 * shape[3], shape[4])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    if fn is _upscale4:
        np.testing.assert_allclose(got.numpy(), _upscale4(torch.from_numpy(lr)).numpy(), rtol=1e-6)


def test_tiled_forward_refuses_a_degenerate_stride():
    with pytest.raises(ValueError, match="overlap"):
        tiled.tiled_forward(_upscale4, torch.zeros(1, 1, 32, 32, 3), tile=(8, 8), overlap=8)


def test_tiled_tiny_vrt_through_make_forward(rng):
    """The serving path for inputs larger than one pass: TinyVRT tiles of
    16x16 over a 24x24 clip, as tests/test_tiled.py's model case."""
    from vsrlab_tpu_torch.evaluation.harness import make_forward
    from vsrlab_tpu_torch.models import TinyVRT

    model = TinyVRT(upscale=4, window_size=(2, 4, 4), depths=(2,) * 7, embed_dims=(8,) * 7,
                    num_heads=(2,) * 7, deformable_groups=2)
    lr = torch.from_numpy(rng.random((1, 2, 24, 24, 3)).astype(np.float32))
    out = tiled.tiled_forward(make_forward(model, device="cpu"), lr, tile=(16, 16), overlap=8)
    assert out.shape == (1, 2, 96, 96, 3)
    assert bool(torch.isfinite(out).all())
