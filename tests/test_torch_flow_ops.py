"""The flow slice's ops in vsrlab_tpu_torch against vsrlab_tpu on the CPU,
fp32, on seeded numpy inputs: the three correlation functions, the
sampler's gradient (``sample_grads`` against autograd through the plain
version and against ``jax.vjp`` of the JAX sampler; ``BilinearSample``'s
wiring with its launch replaced by the plain version, since the kernel runs
only on a card), ``flow_warp``'s ``impl`` and ``epe_loss``.

Tolerances: 1e-5 where both sides do the same fp32 arithmetic in another
order (a correlation sums up to 16 channels; a sampler gradient four
corners); the cost volume of 16 channels at 1e-5 too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vsrlab_tpu.core import losses as jlosses  # noqa: E402
from vsrlab_tpu.ops import correlation as jcorr  # noqa: E402
from vsrlab_tpu.ops import warp as jwarp  # noqa: E402
from vsrlab_tpu_torch.core import losses  # noqa: E402
from vsrlab_tpu_torch.ops import bilinear_sample as bs  # noqa: E402
from vsrlab_tpu_torch.ops import correlation, warp  # noqa: E402

ATOL = 1e-5


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("fn,kwargs", [
    ("all_pairs_correlation", {}),
    ("cost_volume", {"max_disp": 2}),
    ("cost_volume", {"max_disp": 4}),
    ("spatial_correlation_sample", {}),
    ("spatial_correlation_sample", {"patch_size": 5, "stride": 2, "padding": 1}),
    ("spatial_correlation_sample", {"patch_size": 3, "dilation_patch": 2}),
], ids=lambda v: str(v))
def test_correlation_matches_jax(rng, fn, kwargs):
    a = rng.standard_normal((2, 9, 11, 16)).astype(np.float32)
    b = rng.standard_normal((2, 9, 11, 16)).astype(np.float32)
    want = np.asarray(getattr(jcorr, fn)(jnp.asarray(a), jnp.asarray(b), **kwargs))
    got = getattr(correlation, fn)(*_t(a, b), **kwargs).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


def test_spatial_correlation_refuses_even_patches():
    a = torch.zeros((1, 4, 4, 2))
    with pytest.raises(ValueError, match="odd"):
        correlation.spatial_correlation_sample(a, a, patch_size=2)


def _coords(rng, n, p, h, w, kind):
    """``(n, p)`` fp32 coordinates: ``inside`` (non-integer, inside the
    image, where border padding's clamp is the identity), ``margin`` (over
    the image and a 2-pixel margin), ``far`` (most corners outside) or
    ``nonfinite`` (margin, with +-inf, NaN and +-1e30 among them)."""
    if kind == "inside":
        ix = rng.uniform(0.05, w - 1.05, (n, p))
        iy = rng.uniform(0.05, h - 1.05, (n, p))
    elif kind == "far":
        ix = rng.uniform(-3 * w, 4 * w, (n, p))
        iy = rng.uniform(-3 * h, 4 * h, (n, p))
    else:
        ix = rng.uniform(-2, w + 2, (n, p))
        iy = rng.uniform(-2, h + 2, (n, p))
    ix, iy = ix.astype(np.float32), iy.astype(np.float32)
    if kind == "nonfinite":
        special = np.array([np.inf, -np.inf, np.nan, 1e30, -1e30], np.float32)
        ix[:, ::7] = np.resize(special, ix[:, ::7].shape)
        iy[:, 3::11] = np.resize(special[::-1], iy[:, 3::11].shape)
    return ix, iy


def _autograd_plain(x, ix, iy, zeros, g):
    leaves = [t.clone().requires_grad_() for t in (x, ix, iy)]
    bs.bilinear_sample_plain(*leaves, zeros).backward(g)
    return [t.grad for t in leaves]


@pytest.mark.parametrize("zeros,kind", [(True, "margin"), (True, "far"), (True, "nonfinite"),
                                        (False, "inside")])
@pytest.mark.parametrize("shape", [(3, 9, 13, 1, 49), (2, 7, 10, 3, 70), (2, 6, 5, 10, 30)],
                         ids=str)
def test_sample_grads_matches_autograd_through_plain(rng, shape, zeros, kind):
    n, h, w, c, p = shape
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    ix, iy = _coords(rng, n, p, h, w, kind)
    g = rng.standard_normal((n, p, c)).astype(np.float32)
    tx, tix, tiy, tg = _t(x, ix, iy, g)
    got = bs.sample_grads(tx, tix, tiy, zeros, tg)
    want = _autograd_plain(tx, tix, tiy, zeros, tg)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=ATOL)
    if kind == "nonfinite":  # no contribution from a sample with a non-finite coordinate
        bad = ~(np.isfinite(ix) & np.isfinite(iy))
        assert (got[1].numpy()[bad] == 0).all() and (got[2].numpy()[bad] == 0).all()


def test_sample_grads_is_zero_not_nan_for_a_nonfinite_coordinate_in_border_mode():
    x = torch.ones((1, 4, 5, 2))
    ix = torch.tensor([[1.5, float("nan"), float("inf")]])
    iy = torch.tensor([[1.5, 1.0, 1.0]])
    dx, dix, diy = bs.sample_grads(x, ix, iy, False, torch.ones((1, 3, 2)))
    assert bool(torch.isfinite(dx).all()) and float(dx.sum()) == 2.0  # the finite sample only
    assert dix[0, 1:].eq(0).all() and diy[0, 1:].eq(0).all()


@pytest.mark.parametrize("padding_mode,kind", [("zeros", "margin"), ("border", "inside")])
def test_sample_grads_matches_jax_vjp(rng, padding_mode, kind):
    """Against ``jax.vjp`` of ``vsrlab_tpu.ops.warp.sample_pixel_coords``
    (the packed sampler the JAX package ships) at non-integer coordinates:
    the image and both coordinate gradients."""
    n, h, w, c, p = 3, 9, 13, 3, 40
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    ix, iy = _coords(rng, n, p, h, w, kind)
    g = rng.standard_normal((n, p, c)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, u, v: jwarp.sample_pixel_coords(a, u, v, "bilinear", padding_mode,
                                                               True),
                     jnp.asarray(x), jnp.asarray(ix), jnp.asarray(iy))
    want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    got = bs.sample_grads(*_t(x, ix, iy), padding_mode == "zeros", *_t(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=ATOL)


def test_bilinear_sample_function_runs_the_launch_forward_and_sample_grads_backward(
        rng, monkeypatch):
    """``BilinearSample`` with its kernel launch replaced by the plain
    version (a CPU tensor cannot reach the kernel): one counted launch a
    forward, and the gradients of autograd through the plain version."""
    launched = []

    def fake_launch(x, ix, iy, zeros):
        launched.append(tuple(x.shape))
        return bs.bilinear_sample_plain(x, ix, iy, zeros)

    monkeypatch.setattr(bs, "_launch", fake_launch)
    x = rng.standard_normal((2, 6, 7, 3)).astype(np.float32)
    ix, iy = _coords(rng, 2, 20, 6, 7, "margin")
    g = rng.standard_normal((2, 20, 3)).astype(np.float32)
    leaves = [t.requires_grad_() for t in _t(x, ix, iy)]
    out = bs.BilinearSample.apply(*leaves, True)
    out.backward(_t(g)[0])
    assert launched == [(2, 6, 7, 3)]
    want = _autograd_plain(*_t(x, ix, iy), True, _t(g)[0])
    for leaf, b in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), b.numpy(), atol=ATOL, rtol=ATOL)
    # only the image needs a gradient: the coordinates get none
    xl = _t(x)[0].requires_grad_()
    bs.BilinearSample.apply(xl, *_t(ix, iy), True).backward(_t(g)[0])
    np.testing.assert_allclose(xl.grad.numpy(), want[0].numpy(), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_flow_warp_impl_fused_matches_jax_with_gradient(rng, padding_mode):
    """``flow_warp(impl="fused")`` (the plain version on the CPU, under
    autograd) against the JAX warp, value and the flow's gradient."""
    x = rng.standard_normal((2, 10, 12, 3)).astype(np.float32)
    flow = (rng.standard_normal((2, 10, 12, 2)) * 2).astype(np.float32)
    g = rng.standard_normal((2, 10, 12, 3)).astype(np.float32)
    want, vjp = jax.vjp(lambda f: jwarp.flow_warp(jnp.asarray(x), f, padding_mode=padding_mode),
                        jnp.asarray(flow))
    (want_df,) = vjp(jnp.asarray(g))
    tflow = _t(flow)[0].requires_grad_()
    got = warp.flow_warp(_t(x)[0], tflow, padding_mode=padding_mode, impl="fused")
    got.backward(_t(g)[0])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(tflow.grad.numpy(), np.asarray(want_df), atol=ATOL, rtol=ATOL)
    plain = warp.flow_warp(*_t(x, flow), padding_mode=padding_mode)
    np.testing.assert_array_equal(plain.numpy(), got.detach().numpy())


def test_epe_loss_matches_jax(rng):
    a = rng.standard_normal((2, 5, 6, 2)).astype(np.float32)
    b = a.copy()
    b[0, 1] += rng.standard_normal((6, 2)).astype(np.float32)
    want = float(jlosses.epe_loss(jnp.asarray(a), jnp.asarray(b)))
    got = losses.epe_loss(*_t(a, b))
    assert got.dim() == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=ATOL)
