"""vsrlab_tpu_torch's bilinear sampler (``ops/bilinear_sample.py``, the
sampler's ``impl="fused"``) against vsrlab_tpu's on the CPU, on seeded
numpy inputs.

On the CPU the wrapper runs its plain version, so these tests hold the
function the CUDA kernel computes; the kernel itself is held against the
plain version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
Tolerances: 1e-5 in fp32, where both sides do the same fp32 arithmetic in
another order; one bf16 ulp for a bf16 image against the JAX fp32 result
rounded to bf16 (both round an fp32 sum once).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vsrlab_tpu.ops import warp as jwarp  # noqa: E402
from vsrlab_tpu_torch.ops import bilinear_sample as bs  # noqa: E402
from vsrlab_tpu_torch.ops import warp  # noqa: E402

from test_torch_deform import SAMPLER_CASES, _coords, _t  # noqa: E402

ATOL = 1e-5
SAMPLERS = (bs.bilinear_sample, bs.bilinear_sample_plain)
# the cases of SAMPLER_CASES that hold a whole window, where the JAX
# package's packed sampler does not hand the shape to its four-corner gather
WINDOW_CASES = SAMPLER_CASES[:4]


def _padded(ix, iy, h, w, padding_mode):
    """Coordinates after each side's padding step, as each sampler gets them."""
    jx, jy = jwarp._pad_coords(jnp.asarray(ix), jnp.asarray(iy), h, w, padding_mode, True)
    tx, ty = warp._pad_coords(*_t(ix, iy), h, w, padding_mode, True)
    return jx, jy, tx.reshape(ix.shape[0], -1), ty.reshape(ix.shape[0], -1)


def _bf16_ulp(v):
    """One bf16 ulp at each value of ``v`` (fp32 numpy)."""
    mag = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_bilinear_sample_matches_jax_bilinear_packed(rng, padding_mode, dtype):
    """The function the JAX package ships: ``_bilinear_packed`` on padded
    coordinates, at every shape it takes a window of."""
    for n, h, w, c, gp in WINDOW_CASES:
        x = rng.standard_normal((n, h, w, c)).astype(np.float32)
        tx_img = torch.from_numpy(x)
        if dtype == "bfloat16":
            tx_img = tx_img.bfloat16()
            x = tx_img.float().numpy()  # the JAX side samples the same values
        ix, iy = _coords(rng, n, 6, 9, h, w)
        jx, jy, tx, ty = _padded(ix, iy, h, w, padding_mode)
        want = np.array(jwarp._bilinear_packed(jnp.asarray(x), jx, jy, padding_mode, gp))
        want = want.reshape(n, -1, c)
        for fn in SAMPLERS:
            got = fn(tx_img, tx, ty, padding_mode == "zeros")
            assert got.dtype == tx_img.dtype and got.shape == (n, 54, c)
            if dtype == "float32":
                np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
            else:
                rounded = torch.from_numpy(want).bfloat16().float().numpy()
                err = np.abs(got.float().numpy() - rounded)
                assert (err <= _bf16_ulp(rounded)).all(), (fn.__name__, float(err.max()))


@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("case", SAMPLER_CASES, ids=str)
def test_bilinear_sample_matches_jax_sample_pixel_coords(rng, case, padding_mode):
    """The JAX package's public sampler at every shape, its four-corner
    fallback included: the port has none."""
    n, h, w, c, gp = case
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    ix, iy = _coords(rng, n, 7, 11, h, w)
    want = jwarp.sample_pixel_coords(jnp.asarray(x), jnp.asarray(ix), jnp.asarray(iy),
                                     "bilinear", padding_mode, True, gp)
    want = np.asarray(want).reshape(n, -1, c)
    _, _, tx, ty = _padded(ix, iy, h, w, padding_mode)
    for fn in SAMPLERS:
        got = fn(torch.from_numpy(x), tx, ty, padding_mode == "zeros")
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_non_finite_coordinates_give_zero_in_zeros_mode(rng, dtype):
    """+-inf, NaN and +-1e30 read nothing and give exactly 0, as the JAX
    sampler does; the finite samples beside them are untouched."""
    x = rng.standard_normal((2, 6, 8, 10)).astype(np.float32)
    bad = [np.inf, -np.inf, np.nan, 1e30, -1e30]
    ix = np.array([bad + [3.5, np.nan, 2.0]] * 2, np.float32)
    iy = np.array([[2.0, np.nan, np.inf, -1e30, 1e30, 2.5, 1.0, np.inf]] * 2, np.float32)
    want = np.asarray(jwarp.sample_pixel_coords(jnp.asarray(x), jnp.asarray(ix)[:, None],
                                                jnp.asarray(iy)[:, None]))[:, 0]
    for fn in SAMPLERS:
        got = fn(torch.from_numpy(x).to(dtype), *_t(ix, iy), True).float().numpy()
        assert (got[:, :5] == 0).all() and (got[:, 6:] == 0).all()
        assert (want[:, :5] == 0).all() and (want[:, 6:] == 0).all()
        np.testing.assert_allclose(got[:, 5], want[:, 5], atol=2e-2 if dtype != torch.float32
                                   else ATOL, rtol=0)


def test_bilinear_sample_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((2, 4, 5, 3))
    ix = torch.zeros((2, 6))
    # under grad a CPU call is autograd through the plain version, checked as
    # any other call
    out = bs.bilinear_sample(x.clone().requires_grad_(), ix, ix, True)
    assert out.grad_fn is not None
    with pytest.raises(ValueError, match="fp32"):
        bs.bilinear_sample(x.clone().requires_grad_(), ix.double(), ix, True)
    with pytest.raises(ValueError, match=r"\(N, P\)"):
        bs.bilinear_sample(x, ix[:1], ix[:1], True)
    with pytest.raises(ValueError, match=r"\(N, P\)"):
        bs.bilinear_sample(x, ix.reshape(2, 2, 3), ix.reshape(2, 2, 3), True)
    with pytest.raises(ValueError, match="must all be"):
        bs.bilinear_sample(x, ix, ix[:, :5], True)
    with pytest.raises(ValueError, match="fp32"):
        bs.bilinear_sample(x, ix.double(), ix, True)
    with pytest.raises(ValueError, match=r"\(N, H, W, C\)"):
        bs.bilinear_sample(x[0], ix, ix, True)
    with pytest.raises(ValueError, match="empty"):
        bs.bilinear_sample(x, ix[:, :0], ix[:, :0], True)
    with pytest.raises(ValueError, match="one CUDA device"):
        bs.bilinear_sample(x, ix.to("meta"), ix, True)
    assert bs.bilinear_sample.launches == 0  # CPU: no kernel ran
