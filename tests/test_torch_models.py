"""vsrlab_tpu_torch models and blocks against vsrlab_tpu on the CPU, in fp32.

Parameters come from the JAX ``init`` and are loaded into the port through
``vsrlab_tpu_torch.convert``; inputs are seeded numpy arrays. The models
run at mid 8, 2 residual blocks, 2 cleaning blocks, T=4 and 36x40 input:
36x40 is not a multiple of 32, so SpyNet takes its resize path, as the
180-row main path does. Gate: atol 5e-4, as tests/test_basicvsr_oracle.py;
the JAX RealBasicVSR runs with its default ``frame_pack=True``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vsrlab_tpu.models import BasicVSR as JBasicVSR  # noqa: E402
from vsrlab_tpu.models import RealBasicVSR as JRealBasicVSR  # noqa: E402
from vsrlab_tpu.models import SpyNet as JSpyNet  # noqa: E402
from vsrlab_tpu.nn import blocks as jblocks  # noqa: E402
from vsrlab_tpu_torch import convert  # noqa: E402
from vsrlab_tpu_torch.models import BasicVSR, RealBasicVSR, SpyNet  # noqa: E402
from vsrlab_tpu_torch.nn import blocks  # noqa: E402

ATOL = 5e-4
MID, BLOCKS, T, H, W = 8, 2, 4, 36, 40


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _init(model, *args):
    return _np_tree(jax.jit(model.init)(jax.random.PRNGKey(0), *args)["params"])


def _apply(model, params, *args, **kw):
    """``model.apply`` jitted: one compile instead of op-by-op dispatch."""
    fn = jax.jit(lambda p, *a: model.apply({"params": p}, *a, **kw))
    return fn(params, *[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args])


def _load(module, state):
    module.load_state_dict(state, strict=True)
    return module.eval()


@pytest.fixture(scope="module")
def clip():
    return np.random.default_rng(0).random((1, T, H, W, 3)).astype(np.float32)


def test_residual_block_matches_jax(rng):
    x = rng.standard_normal((2, 9, 11, 5)).astype(np.float32)
    jmod = jblocks.ResidualBlock(features=MID, blocks=3)
    params = _init(jmod, jnp.asarray(x))
    want = _apply(jmod, params, x)
    mod = _load(blocks.ResidualBlock(5, MID, 3), convert.residual_block_state_dict(params))
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_iterative_refinement_and_pixel_shuffle_pack_match_jax(rng):
    x = rng.random((3, 10, 12, 3)).astype(np.float32)
    jmod = jblocks.IterativeRefinement(mid_channels=MID, blocks=2, steps=3)
    params = _init(jmod, jnp.asarray(x))
    want = _apply(jmod, params, x)
    mod = _load(blocks.IterativeRefinement(MID, 2, 3),
                convert.iterative_refinement_state_dict(params))
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)

    jps = jblocks.PixelShufflePack(features=4, upscale_factor=2)
    pp = _init(jps, jnp.asarray(x))
    ps = blocks.PixelShufflePack(3, 4, 2)
    ps.conv.load_state_dict(convert.conv_state_dict(pp["Conv2d_0"]["Conv_0"]))
    with torch.no_grad():
        got = ps(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(_apply(jps, pp, x)),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("return_levels", [(5,), (2, 3, 4, 5)])
def test_spynet_matches_jax(clip, return_levels):
    frames = clip.reshape(-1, H, W, 3)
    jnet = JSpyNet(return_levels=return_levels)
    params = _init(jnet, jnp.asarray(frames[:1]), jnp.asarray(frames[:1]))
    net = _load(SpyNet(return_levels=return_levels), convert.spynet_state_dict(params))
    with torch.no_grad():
        got = net.adjacent_pairs(torch.from_numpy(frames), T)
        got_call = net(torch.from_numpy(frames[:-1]), torch.from_numpy(frames[1:]))
    want = jax.jit(lambda p, f: jnet.apply({"params": p}, f, T, method=JSpyNet.adjacent_pairs))(
        params, jnp.asarray(frames))
    want_call = _apply(jnet, params, frames[:-1], frames[1:])
    if len(return_levels) == 1:
        got, want, got_call, want_call = [got], [want], [got_call], [want_call]
    assert len(got) == len(want) == len(return_levels)
    for g, w in zip(got + got_call, want + want_call):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_basicvsr_matches_jax(clip):
    jmodel = JBasicVSR(mid_channels=MID, res_blocks=BLOCKS, upscale=4)
    params = _init(jmodel, jnp.asarray(clip))
    want = _apply(jmodel, params, clip)
    model = _load(BasicVSR(MID, BLOCKS, 4), convert.basicvsr_state_dict(params))
    with torch.no_grad():
        got = model(torch.from_numpy(clip))
    assert got.shape == (1, T, 4 * H, 4 * W, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.fixture(scope="module")
def realbasicvsr_pair(clip):
    jmodel = JRealBasicVSR(mid_channels=MID, res_blocks=BLOCKS, cleaning_blocks=BLOCKS)
    params = _init(jmodel, jnp.asarray(clip))
    model = _load(RealBasicVSR(MID, BLOCKS, BLOCKS), convert.realbasicvsr_state_dict(params))
    return jmodel, params, model


def test_realbasicvsr_matches_jax(clip, realbasicvsr_pair):
    jmodel, params, model = realbasicvsr_pair
    want_sr, want_lq = _apply(jmodel, params, clip)
    with torch.no_grad():
        sr, lq = model(torch.from_numpy(clip))
    np.testing.assert_allclose(lq.numpy(), np.asarray(want_lq), atol=ATOL)
    np.testing.assert_allclose(sr.numpy(), np.asarray(want_sr), atol=ATOL)


def test_realbasicvsr_streaming_matches_jax(clip, realbasicvsr_pair):
    """``return_state`` then ``stream_state`` over two windows of the clip."""
    jmodel, params, model = realbasicvsr_pair
    a, b = clip[:, :2], clip[:, 2:]
    jsr_a, _, jstate = _apply(jmodel, params, a, return_state=True)
    jsr_b, _, jstate_b = jax.jit(
        lambda p, x, s: jmodel.apply({"params": p}, x, stream_state=s, return_state=True)
    )(params, jnp.asarray(b), jstate)
    with torch.no_grad():
        sr_a, _, state = model(torch.from_numpy(a), return_state=True)
        sr_b, _, state_b = model(torch.from_numpy(b), stream_state=state, return_state=True)
    for g, w in ((sr_a, jsr_a), (sr_b, jsr_b), (state[0], jstate[0]), (state[1], jstate[1]),
                 (state_b[1], jstate_b[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_init_weights_is_seeded_torch_default():
    """Same seed, same weights; bounds are torch's U(+-1/sqrt(fan_in))."""
    a = blocks.init_weights(RealBasicVSR(MID, 1, 1), torch.Generator().manual_seed(3))
    b = blocks.init_weights(RealBasicVSR(MID, 1, 1), torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0, msg=name)
    w = a.basicvsr.point_conv.weight
    assert w.abs().max() <= 1.0 / np.sqrt(w[0].numel())


def test_set_pair_impl_reaches_every_residual_block():
    model = blocks.set_pair_impl(RealBasicVSR(MID, 1, 1), "im2col")
    impls = {m.pair_impl for m in model.modules() if isinstance(m, blocks.ResidualBlock)}
    assert impls == {"im2col"}
    with pytest.raises(ValueError):
        blocks.set_pair_impl(model, "cudnn")
