"""vsrlab_tpu_torch's sampler, packed gather and deformable conv against
vsrlab_tpu on the CPU, in fp32, on seeded numpy inputs.

On the CPU the kernel wrappers run their plain versions, so
``impl="take"`` tests the packed table, the per-pixel fields and the fold
that surround the row gather kernel, and ``impl="fused"`` the function the
sampler kernel computes. Tolerances: 1e-5 where
both sides do the same fp32 arithmetic in another order, exact (0) for pure
gathers.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vsrlab_tpu.nn import blocks as jblocks  # noqa: E402
from vsrlab_tpu.ops import deform as jdeform  # noqa: E402
from vsrlab_tpu.ops import warp as jwarp  # noqa: E402
from vsrlab_tpu_torch import convert  # noqa: E402
from vsrlab_tpu_torch.nn import blocks  # noqa: E402
from vsrlab_tpu_torch.ops import bilinear_sample, deform, packed_gather, warp  # noqa: E402

ATOL = 1e-5
IMPLS = ("plain", "take", "fused")


def _coords(rng, n, ho, wo, h, w):
    """Coordinates over the image and a 2-pixel margin, with exact
    integers, the last row / column and outside points among them."""
    ix = (rng.random((n, ho, wo)) * (w + 4) - 2).astype(np.float32)
    iy = (rng.random((n, ho, wo)) * (h + 4) - 2).astype(np.float32)
    ix[0, 0, :4] = [0.0, w - 1, -1.0, w - 0.5]
    iy[0, 0, :4] = [h - 1, 0.0, 2.0, h - 0.5]
    return ix, iy


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


# (N, H, W, C, window_group): gp=2 rows as the alignment uses them, one with
# a width that is no multiple of gp (padded table); the heuristic's gp (8
# at C=3); the narrowest shape that holds a window (two x-groups after
# padding); and shapes that hold none (C=4: gp=8, one x-group; one row; one
# column; one pixel), which the JAX package gives to its four-corner gather
# and the port to its kernels (``take`` over a table zero-padded to one window)
SAMPLER_CASES = [(3, 9, 13, 5, 2), (2, 16, 16, 10, 2), (2, 7, 10, 3, None), (2, 6, 3, 10, 2),
                 (2, 8, 8, 4, None), (2, 1, 5, 3, 2), (2, 4, 1, 4, None), (1, 1, 1, 2, None)]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("case", SAMPLER_CASES, ids=str)
def test_sample_pixel_coords_matches_jax(rng, case, padding_mode, impl):
    n, h, w, c, gp = case
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    ix, iy = _coords(rng, n, 7, 11, h, w)
    want = jwarp.sample_pixel_coords(jnp.asarray(x), jnp.asarray(ix), jnp.asarray(iy),
                                     "bilinear", padding_mode, True, gp)
    got = warp.sample_pixel_coords(*_t(x, ix, iy), "bilinear", padding_mode, True, gp, impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_packed_sampler_takes_the_fallback_only_where_jax_does(rng, monkeypatch):
    """Only the JAX sampler has a four-corner fallback: the port reaches a
    kernel wrapper at every shape, those included, with the same values.
    ``fused`` hands the image itself to ``bilinear_sample`` and builds no
    packed table and no per-pixel fields; ``take`` gathers table rows."""
    calls = []
    for name in ("bilinear_sample", "packed_row_gather", "packed_table", "packed_fields"):
        fn = getattr(warp, name)
        monkeypatch.setattr(warp, name,
                            lambda *a, fn=fn, name=name: calls.append((name, tuple(a[0].shape)))
                            or fn(*a))
    tables = [(3, 48, 40), (2, 105, 80), (2, 6, 96), (2, 5, 80), (2, 7, 128), (2, 2, 24),
              (2, 3, 128), (1, 1, 64)]
    fell_back = []
    for (n, h, w, c, gp), table in zip(SAMPLER_CASES, tables, strict=True):
        x = rng.standard_normal((n, h, w, c)).astype(np.float32)
        ix, iy = _coords(rng, n, 4, 5, h, w)
        jx, jy = jnp.asarray(ix), jnp.asarray(iy)
        fell_back.append(jwarp._bilinear_packed(jnp.asarray(x), jx, jy, "zeros", gp) is None)
        want = np.asarray(jwarp.sample_pixel_coords(jnp.asarray(x), jx, jy, window_group=gp))
        for impl, expect in (("fused", [("bilinear_sample", (n, h, w, c))]),
                             ("take", [("packed_table", (n, h, w, c)), ("packed_fields", (n, 4, 5)),
                                       ("packed_row_gather", table)])):
            del calls[:]
            got = warp.sample_pixel_coords(*_t(x, ix, iy), window_group=gp, impl=impl)
            assert calls == expect, (n, h, w, c, gp)
            np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert fell_back == [False] * 4 + [True] * 4


@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
def test_nearest4_matches_jax(rng, padding_mode):
    """Four taps stacked on channels; ceil equals floor at exact integers."""
    x = rng.standard_normal((2, 9, 12, 3)).astype(np.float32)
    flow = (rng.standard_normal((2, 9, 12, 2)) * 3).astype(np.float32)
    flow[0, :3] = [1.0, -2.0]  # integer displacements
    flow[1, 0, 0] = [-5.5, 20.25]  # far outside
    want = jwarp.flow_warp(jnp.asarray(x), jnp.asarray(flow), "nearest4", padding_mode)
    got = warp.flow_warp(*_t(x, flow), "nearest4", padding_mode)
    assert got.shape == (2, 9, 12, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _take_formula(xf, idx):
    """The flattened ``jnp.take`` of the TPU probe's reference
    (``scripts/bench_pallas_deform_gather.py:94-99``) at any shape."""
    n, rows, row_w = xf.shape
    base = (jnp.arange(n, dtype=jnp.int32) * rows)[:, None]
    lin = (jnp.asarray(idx) + base).reshape(-1)
    return jnp.take(jnp.asarray(xf).reshape(-1, row_w), lin, axis=0).reshape(n, -1, row_w)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_packed_row_gather_matches_take_formula(rng, dtype):
    n, rows, row_w, p = 4, 37, 24, 50
    xf = rng.standard_normal((n, rows, row_w)).astype(np.float32)
    idx = rng.integers(0, rows, size=(n, p)).astype(np.int32)
    txf, tidx = _t(xf, idx)
    jxf = jnp.asarray(xf)
    if dtype == "bfloat16":
        txf, jxf = txf.bfloat16(), jxf.astype(jnp.bfloat16)
    want = np.asarray(_take_formula(jxf, idx).astype(jnp.float32))
    for fn in (packed_gather.packed_row_gather, packed_gather.packed_row_gather_plain):
        got = fn(txf, tidx)
        assert got.dtype == txf.dtype and got.shape == (n, p, row_w)
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_packed_wrappers_refuse_what_the_kernels_do_not_take(rng):
    xf, = _t(rng.standard_normal((2, 5, 16)).astype(np.float32))
    idx = torch.zeros((2, 3), dtype=torch.int32)
    w = torch.ones((2, 3))
    with pytest.raises(ValueError, match="int32"):
        packed_gather.packed_row_gather(xf, idx.long())
    with pytest.raises(ValueError, match=r"\(N, P\)"):
        packed_gather.packed_row_gather(xf, idx[:1])
    # under a gradient the gather is no longer refused: on the CPU it is
    # autograd through the plain version
    out = packed_gather.packed_row_gather(xf.clone().requires_grad_(), idx)
    assert out.requires_grad and out.grad_fn is not None
    with pytest.raises(ValueError, match="fp32"):
        bilinear_sample.bilinear_sample(torch.zeros(2, 3, 4, 2), w.double(), w, True)
    with pytest.raises(ValueError, match=r"\(N, P\)"):
        bilinear_sample.bilinear_sample(torch.zeros(2, 3, 4, 2), w[:1], w[:1], True)
    with pytest.raises(ValueError, match="unknown sampler"):
        warp.sample_pixel_coords(torch.zeros(1, 4, 4, 1), torch.zeros(1, 2, 2),
                                 torch.zeros(1, 2, 2), impl="cudnn")
    assert packed_gather.packed_row_gather.launches == 0  # CPU: no kernel ran
    assert bilinear_sample.bilinear_sample.launches == 0


def _deform_operands(rng, n, h, w, cin, cout, groups, spread):
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    offset = (rng.standard_normal((n, h, w, 2 * groups * 9)) * spread).astype(np.float32)
    mask = rng.random((n, h, w, groups * 9)).astype(np.float32)
    weight = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    return x, offset, mask, weight, bias


# (N, H, W, Cin, Cout, G): Cg = 10 and 8 take gp=2 rows (the packed branch);
# Cg = 4 at 8x8 gives gp = 8, one x-group: the table is padded to one window
DEFORM_CASES = [(2, 9, 12, 20, 6, 2), (1, 8, 8, 8, 8, 1), (2, 8, 8, 8, 5, 2)]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("case", DEFORM_CASES, ids=str)
def test_deform_conv2d_matches_jax(rng, case, with_mask, impl):
    n, h, w, cin, cout, groups = case
    x, offset, mask, weight, bias = _deform_operands(rng, n, h, w, cin, cout, groups, 2.0)
    jm = jnp.asarray(mask) if with_mask else None
    want = jdeform.deform_conv2d(jnp.asarray(x), jnp.asarray(offset), jnp.asarray(weight),
                                 jnp.asarray(bias), 1, 1, 1, jm)
    tx, toff, tmask, tw, tb = _t(x, offset, mask, weight, bias)
    got = deform.deform_conv2d(tx, toff, tw, tb, 1, 1, 1, tmask if with_mask else None, impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_modulated_deform_conv2d_stride_dilation_and_offset_layout(rng):
    """dy comes first in each (dy, dx) pair: moving every tap one pixel
    down equals convolving the image shifted one pixel up (below the top
    row, whose upper taps then read row 0 where the shifted image has its
    zero padding)."""
    n, h, w, cin, cout, groups = 1, 10, 10, 16, 4, 2
    x, offset, mask, weight, bias = _deform_operands(rng, n, h, w, cin, cout, groups, 0.0)
    offset[..., 0::2] = 1.0  # dy
    tx, toff, tmask, tw, tb = _t(x, offset, np.ones_like(mask), weight, bias)
    got = deform.modulated_deform_conv2d(tx, toff, tmask, tw, tb, padding=1, impl="fused")
    shifted = torch.zeros_like(tx)
    shifted[:, :-1] = tx[:, 1:]
    want = deform.deform_conv2d(shifted, torch.zeros_like(toff), tw, tb, padding=1)
    np.testing.assert_allclose(got.numpy()[:, 1:], want.numpy()[:, 1:], atol=ATOL, rtol=0)
    assert float((got[:, 0] - want[:, 0]).abs().max()) > 0.1
    # stride 2, dilation 2 against the JAX function
    off2 = (rng.standard_normal((n, 4, 4, 2 * groups * 9))).astype(np.float32)
    want = jdeform.deform_conv2d(jnp.asarray(x), jnp.asarray(off2), jnp.asarray(weight),
                                 None, 2, 1, 2)
    got = deform.deform_conv2d(tx, torch.from_numpy(off2), tw, None, 2, 1, 2, impl="take")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_deform_block_matches_jax(rng):
    """DeformBlock / DeformConvPack with the zero-initialised offset convs filled."""
    import jax

    x = rng.standard_normal((2, 8, 10, 6)).astype(np.float32)
    jmod = jblocks.DeformBlock(in_features=6, mid_features=8, blocks=2)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32), shapes)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    state = {}
    state.update(convert.conv_state_dict(params["Conv2d_0"]["Conv_0"], "conv_in."))
    state.update(convert.conv_state_dict(params["Conv2d_1"]["Conv_0"], "conv_out."))
    for i in range(2):
        dc = params[f"dc_{i}"]
        state.update(convert.conv_state_dict(dc["Conv_0"], f"dcs.{i}.offset_conv."))
        state[f"dcs.{i}.weight"] = torch.from_numpy(dc["weight"])
        state[f"dcs.{i}.bias"] = torch.from_numpy(dc["bias"])
    mod = blocks.DeformBlock(6, 8, 2)
    mod.load_state_dict(state, strict=True)
    for impl in IMPLS:
        blocks.set_sampler_impl(mod, impl)
        with torch.no_grad():
            got = mod.eval()(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    with pytest.raises(ValueError):
        blocks.set_sampler_impl(mod, "cudnn")


def test_zero_init_offset_conv_survives_init_weights():
    mod = blocks.init_weights(blocks.DeformBlock(4, 8, 1), torch.Generator().manual_seed(0))
    assert float(mod.dcs[0].offset_conv.weight.detach().abs().max()) == 0.0
    assert float(mod.dcs[0].offset_conv.bias.detach().abs().max()) == 0.0
    assert float(mod.dcs[0].weight.detach().abs().max()) > 0.0
