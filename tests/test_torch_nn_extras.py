"""The port's last building blocks against ``vsrlab_tpu.nn`` on the CPU, in fp32.

``ConvReLU``, ``ConvST`` (default and non-default strides and padding),
``ConvSTBlock``, ``PixelShufflePack3D``, ``Mlp``, ``MixerBlock``,
``MlpMixer``, ``EncoderDCT`` and ``DecoderIDCT``: the JAX module's params
(from its ``init``) go through ``convert.module_state_dict`` into the port
module (``strict=True``), both run on the same seeded numpy input, atol
1e-5. Also the 5-D case of ``module_state_dict`` and ``init_weights``'
reproducibility on the new blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vsrlab_tpu.nn import blocks as jblocks  # noqa: E402
from vsrlab_tpu.nn import dct as jdct  # noqa: E402
from vsrlab_tpu.nn import mlp as jmlp  # noqa: E402
from vsrlab_tpu_torch import convert  # noqa: E402
from vsrlab_tpu_torch import nn as pnn  # noqa: E402
from vsrlab_tpu_torch.nn import blocks  # noqa: E402

ATOL = 1e-5


def _check(jmod, mod, x):
    """``jmod``'s init params into ``mod`` (strict), both forwards on ``x``."""
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    mod.load_state_dict(convert.module_state_dict(params), strict=True)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = mod.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    return params


def test_conv_relu_matches_jax(rng):
    x = rng.standard_normal((2, 9, 11, 5)).astype(np.float32)
    _check(jblocks.ConvReLU(7), pnn.ConvReLU(5, 7), x)
    x = rng.standard_normal((1, 12, 10, 3)).astype(np.float32)
    _check(jblocks.ConvReLU(6, kernel_size=5, strides=2, padding=2),
           pnn.ConvReLU(3, 6, kernel_size=5, stride=2, padding=2), x)


@pytest.mark.parametrize("strides,padding", [((1, 1, 1), (1, 1, 1)), ((2, 2, 2), (0, 1, 1)),
                                             ((1, 2, 1), (2, 0, 1))])
def test_conv_st_matches_jax(rng, strides, padding):
    x = rng.standard_normal((2, 5, 9, 8, 4)).astype(np.float32)
    params = _check(jblocks.ConvST(6, strides=strides, padding=padding),
                    pnn.ConvST(4, 6, strides=strides, padding=padding), x)
    assert params["Conv_0"]["kernel"].shape == (1, 3, 3, 4, 6)
    assert params["Conv_1"]["kernel"].shape == (3, 1, 1, 6, 6)


def test_conv_st_block_matches_jax(rng):
    x = rng.standard_normal((1, 4, 7, 6, 3)).astype(np.float32)
    _check(jblocks.ConvSTBlock(5, blocks=2), pnn.ConvSTBlock(3, 5, blocks=2), x)


def test_pixel_shuffle_pack_3d_matches_jax(rng):
    x = rng.standard_normal((2, 3, 5, 6, 4)).astype(np.float32)
    _check(jblocks.PixelShufflePack3D(3, upscale_factor=2), pnn.PixelShufflePack3D(4, 3, 2), x)


TOKENS = (2, 3, 5, 4)  # (B, T, P, C)


def test_mlp_matches_jax(rng):
    x = rng.standard_normal(TOKENS).astype(np.float32)
    _check(jmlp.Mlp(4, 9), pnn.Mlp(4, 9), x)


def test_mixer_block_matches_jax(rng):
    x = rng.standard_normal(TOKENS).astype(np.float32)
    _check(jmlp.MixerBlock(patches_dim=5, channels_dim=4, time_dim=3),
           pnn.MixerBlock(patches_dim=5, channels_dim=4, time_dim=3), x)


def test_mlp_mixer_matches_jax(rng):
    x = rng.standard_normal(TOKENS).astype(np.float32)
    _check(jmlp.MlpMixer(5, 4, 3, exp=3, blocks=2), pnn.MlpMixer(5, 4, 3, exp=3, blocks=2), x)


@pytest.mark.parametrize("ps", [4, 8])
def test_dct_matches_jax_and_round_trips(rng, ps):
    h, w = 2 * ps, 3 * ps
    x = rng.random((2, 3, h, w, 3)).astype(np.float32)
    enc, dec = pnn.EncoderDCT(ps), pnn.DecoderIDCT(ps, h, w)
    assert not enc.state_dict() and not dec.state_dict()  # the basis is not a parameter
    want = np.asarray(jdct.EncoderDCT(ps)(jnp.asarray(x)))
    tok = enc(torch.from_numpy(x))
    assert tok.shape == (2, 3, (h // ps) * (w // ps), 3 * ps * ps)
    np.testing.assert_allclose(tok.numpy(), want, atol=ATOL, rtol=0)
    back = dec(tok)
    np.testing.assert_allclose(back.numpy(), np.asarray(jdct.DecoderIDCT(ps, h, w)(
        jnp.asarray(want))), atol=ATOL, rtol=0)
    np.testing.assert_allclose(back.numpy(), x, atol=ATOL, rtol=0)


def test_module_state_dict_five_d_kernels(rng):
    """DHWIO -> OIDHW for a 5-D kernel; a lone ``Conv_0`` is its parent's
    conv, one beside siblings keeps its name."""
    k0 = rng.standard_normal((1, 3, 3, 4, 6)).astype(np.float32)
    k1 = rng.standard_normal((3, 1, 1, 6, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    k2 = rng.standard_normal((3, 3, 4, 6)).astype(np.float32)
    tree = {"st": {"Conv_0": {"kernel": k0}, "Conv_1": {"kernel": k1, "bias": b}},
            "wrap": {"Conv_0": {"kernel": k2, "bias": b}}}
    sd = convert.module_state_dict(tree)
    assert sorted(sd) == ["st.Conv_0.weight", "st.Conv_1.bias", "st.Conv_1.weight",
                          "wrap.bias", "wrap.weight"]
    np.testing.assert_array_equal(sd["st.Conv_0.weight"].numpy(), k0.transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(sd["st.Conv_1.weight"].numpy(), k1.transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(sd["wrap.weight"].numpy(), k2.transpose(3, 2, 0, 1))
    assert sd["st.Conv_1.weight"].is_contiguous()


@pytest.mark.parametrize("make", [
    lambda: pnn.ConvReLU(3, 5),
    lambda: pnn.ConvSTBlock(3, 5, blocks=2),
    lambda: pnn.PixelShufflePack3D(4, 3),
    lambda: pnn.MlpMixer(5, 4, 3, blocks=2),
])
def test_init_weights_reproducible(make):
    def drawn(seed):
        return blocks.init_weights(make(), torch.Generator().manual_seed(seed)).state_dict()

    a, b, c = drawn(3), drawn(3), drawn(4)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(not torch.equal(a[k], c[k]) for k in a)
    # torch's default bound 1/sqrt(fan_in) on every weight and bias
    for name, t in a.items():
        fan_in = a[name.rsplit(".", 1)[0] + ".weight"][0].numel()
        assert float(t.abs().max()) <= 1 / fan_in ** 0.5
