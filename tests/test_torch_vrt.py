"""vsrlab_tpu_torch's VRT family against vsrlab_tpu on the CPU, in fp32.

Parameters are drawn with numpy over the shapes of the JAX ``init``
(``jax.eval_shape``: no init program is compiled), so the zero-initialised
offset / mask heads of the deformable alignment are non-zero too, and go
into the port through ``convert.vrt_state_dict`` / ``module_state_dict``
with ``strict=True``. Inputs are seeded numpy arrays. Gate: atol 5e-4 for
the models (as tests/test_torch_models.py), 2e-5 for single modules, where
both sides do the same fp32 arithmetic in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vsrlab_tpu.models import vrt as jvrt  # noqa: E402
from vsrlab_tpu.models.vrt import window_attention as jwa  # noqa: E402
from vsrlab_tpu_torch import convert  # noqa: E402
from vsrlab_tpu_torch.models import vrt  # noqa: E402
from vsrlab_tpu_torch.models.vrt import window_attention as wa  # noqa: E402
from vsrlab_tpu_torch.nn.blocks import set_sampler_impl  # noqa: E402

ATOL = 5e-4
ATOL_MODULE = 2e-5


def _random_params(jmodel, rng, *args):
    """Numpy parameters over the shapes of ``jmodel.init(key, *args)``:
    kernels and weights U(+-1/sqrt(fan_in)), LayerNorm scales around 1,
    biases and bias tables small."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *args)["params"]

    def draw(path, leaf):
        name = path[-1].key
        if name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        elif name in ("kernel", "weight"):
            bound = 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
            v = rng.uniform(-bound, bound, leaf.shape)
        else:
            v = 0.05 * rng.standard_normal(leaf.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _load(module, state):
    module.load_state_dict(state, strict=True)
    return module.eval()


def _run(module, *args, **kw):
    with torch.no_grad():
        return module(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args],
                      **kw)


def test_window_helpers_match_jax(rng):
    x = rng.standard_normal((2, 4, 8, 12, 3)).astype(np.float32)
    ws = (2, 4, 4)
    got = wa.window_partition(torch.from_numpy(x), ws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jwa.window_partition(jnp.asarray(x), ws)))
    back = wa.window_reverse(got, ws, 2, 4, 8, 12)
    np.testing.assert_array_equal(back.numpy(), x)
    assert wa.get_window_size((3, 8, 8), (6, 8, 8), (3, 4, 4)) == ((3, 8, 8), (0, 0, 0))
    np.testing.assert_array_equal(wa.relative_position_index(ws), jwa.relative_position_index(ws))
    np.testing.assert_array_equal(wa.sine_position_encoding((4, 4), 6),
                                  jwa.sine_position_encoding((4, 4), 6))


@pytest.mark.parametrize("shape,ws,ss", [((4, 8, 12), (2, 4, 4), (1, 2, 2)),
                                         ((6, 8, 8), (6, 4, 4), (0, 2, 2)),
                                         ((2, 4, 8), (2, 4, 4), (0, 0, 2))])
def test_masks_match_jax_and_factored_equals_dense(shape, ws, ss):
    dense = wa.compute_mask(*shape, ws, ss)
    np.testing.assert_array_equal(dense, jwa.compute_mask(*shape, ws, ss))
    fm, jfm = wa.compute_mask_factored(*shape, ws, ss), jwa.compute_mask_factored(*shape, ws, ss)
    np.testing.assert_array_equal(fm.masks, jfm.masks)
    np.testing.assert_array_equal(fm.type_ids, jfm.type_ids)
    np.testing.assert_array_equal(fm.masks[fm.type_ids], dense)


# (mut_attn, mask kind, tokens): self / mutual attention, unmasked, with the
# dense shift mask and with the factored one; a window the input shrank
# (16 of the declared 32 tokens: the bias table is indexed [:16, :16])
ATTENTION_CASES = [(False, None, 32), (True, None, 32), (True, "dense", 32),
                   (True, "factored", 32), (False, "factored", 32), (False, None, 16)]


@pytest.mark.parametrize("mut_attn,mask_kind,n", ATTENTION_CASES)
def test_window_attention_matches_jax(rng, monkeypatch, mut_attn, mask_kind, n):
    dim, heads, ws = 8, 2, (2, 4, 4)
    grid = (4, 8, 8)  # 8 windows of (2, 4, 4)
    x = rng.standard_normal((16, n, dim)).astype(np.float32)
    jmask = mask = None
    if mask_kind == "dense":
        mask = wa.compute_mask(*grid, ws, (1, 2, 2))
        jmask = jnp.asarray(mask)
    elif mask_kind == "factored":
        mask = wa.compute_mask_factored(*grid, ws, (1, 2, 2))
        jmask = jwa.compute_mask_factored(*grid, ws, (1, 2, 2))
    jmod = jwa.WindowAttention(dim, ws, heads, mut_attn=mut_attn)
    params = _random_params(jmod, rng, jnp.asarray(x))
    want = jmod.apply({"params": params}, jnp.asarray(x), jmask)
    mod = _load(wa.WindowAttention(dim, ws, heads, mut_attn=mut_attn),
                convert.module_state_dict(params))
    np.testing.assert_allclose(_run(mod, x, mask).numpy(), np.asarray(want),
                               atol=ATOL_MODULE, rtol=0)
    # the same result when the windows go through in chunks of 3
    monkeypatch.setattr(wa, "LOGITS_BUDGET", 3 * heads * n * n * 4)
    np.testing.assert_allclose(_run(mod, x, mask).numpy(), np.asarray(want),
                               atol=ATOL_MODULE, rtol=0)


def test_mlp_geglu_matches_jax(rng):
    x = rng.standard_normal((3, 5, 8)).astype(np.float32)
    jmod = jwa.MlpGEGLU(16, 6)
    params = _random_params(jmod, rng, jnp.asarray(x))
    mod = _load(wa.MlpGEGLU(8, 16, 6), convert.module_state_dict(params))
    np.testing.assert_allclose(_run(mod, x).numpy(),
                               np.asarray(jmod.apply({"params": params}, jnp.asarray(x))),
                               atol=ATOL_MODULE, rtol=0)


@pytest.mark.parametrize("mut_attn,ws,shape", [
    (True, (2, 4, 4), (1, 4, 8, 8, 8)),     # shifted block with the mask
    (False, (6, 4, 4), (1, 3, 6, 10, 8)),   # shrunk depth window, padded H and W
])
def test_tmsag_and_rtmsa_match_jax(rng, mut_attn, ws, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    jmod = jvrt.TMSAG(dim=8, depth=2, num_heads=2, window_size=ws, mut_attn=mut_attn)
    params = _random_params(jmod, rng, jnp.asarray(x))
    want = jax.jit(lambda p, a: jmod.apply({"params": p}, a))(params, jnp.asarray(x))
    mod = _load(vrt.TMSAG(8, 2, 2, ws, mut_attn=mut_attn), convert.module_state_dict(params))
    np.testing.assert_allclose(_run(mod, x).numpy(), np.asarray(want), atol=ATOL_MODULE, rtol=0)
    if not mut_attn:
        jr = jvrt.RTMSA(dim=8, depth=1, num_heads=2, window_size=ws)
        rparams = _random_params(jr, rng, jnp.asarray(x))
        rt = _load(vrt.RTMSA(8, 1, 2, ws), convert.module_state_dict(rparams))
        np.testing.assert_allclose(_run(rt, x).numpy(),
                                   np.asarray(jr.apply({"params": rparams}, jnp.asarray(x))),
                                   atol=ATOL_MODULE, rtol=0)


@pytest.mark.parametrize("impl", ["fused", "plain"])
def test_flow_guided_deform_align_matches_jax(rng, impl):
    """Offset layout, flow prior, mask: Cg = 8 takes the packed sampler."""
    n, h, w, c, groups = 2, 8, 10, 16, 2
    x, warped, cur = (rng.standard_normal((n, h, w, c)).astype(np.float32) for _ in range(3))
    flow = (rng.standard_normal((n, h, w, 2)) * 2).astype(np.float32)
    jmod = jvrt.FlowGuidedDeformAlign(c, groups, max_residue_magnitude=5.0)
    args = (jnp.asarray(x), [jnp.asarray(warped)], jnp.asarray(cur), [jnp.asarray(flow)])
    params = _random_params(jmod, rng, *args)
    want = jmod.apply({"params": params}, *args)
    mod = _load(vrt.FlowGuidedDeformAlign(c, groups, 5.0), convert.module_state_dict(params))
    set_sampler_impl(mod, impl)
    got = _run(mod, x, [torch.from_numpy(warped)], cur, [torch.from_numpy(flow)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


# reshape, (B, T, H, W, C) input, flow size, align_chunks
STAGE_CASES = [("none", (1, 3, 8, 8, 16), 8, 0), ("none", (1, 3, 8, 8, 16), 8, 3),
               ("down", (1, 4, 16, 16, 8), 8, 0), ("down", (1, 4, 16, 16, 8), 8, 3),
               ("up", (1, 3, 4, 4, 64), 8, 0), ("up", (1, 3, 4, 4, 64), 8, 3)]


@pytest.mark.parametrize("reshape,shape,fs,chunks", STAGE_CASES)
def test_stage_matches_jax(rng, reshape, shape, fs, chunks):
    """Stage with 8 channels a group (gp = 2 rows, the packed sampler)
    against the JAX Stage; ``align_chunks`` 3 over the 4 frame pairs of a
    3-frame clip leaves a ragged last chunk."""
    b, t = shape[:2]
    x = rng.standard_normal(shape).astype(np.float32)
    fb, ff = ((rng.standard_normal((b, t - 1, fs, fs, 2)) * 1.5).astype(np.float32)
              for _ in range(2))
    kw = dict(in_dim=shape[-1], dim=16, depth=2, num_heads=2, window_size=(2, 4, 4),
              deformable_groups=2, reshape=reshape, max_residue_magnitude=2.5)
    jmod = jvrt.Stage(**kw)
    args = (jnp.asarray(x), [jnp.asarray(fb)], [jnp.asarray(ff)])
    params = _random_params(jmod, rng, *args)
    want = jax.jit(lambda p, *a: jmod.apply({"params": p}, *a))(params, *args)
    mod = _load(vrt.Stage(**kw, align_chunks=chunks), convert.module_state_dict(params))
    got = _run(mod, x, [torch.from_numpy(fb)], [torch.from_numpy(ff)])
    assert got.shape == (b, t, fs, fs, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def _model_pair(jcls, cls, kw, shape, rng):
    jmodel = jcls(**kw)
    x = rng.random(shape).astype(np.float32)
    params = _random_params(jmodel, rng, jnp.asarray(x))
    want = jax.jit(lambda p, a: jmodel.apply({"params": p}, a))(params, jnp.asarray(x))
    model = _load(cls(**kw), convert.vrt_state_dict(params))
    return model, x, [np.asarray(w) for w in want]


def _check_model(model, x, want, out_shape):
    want_sr, want_lq = want
    for impl in ("fused", "take", "plain"):
        set_sampler_impl(model, impl)
        sr, lq = _run(model, x)
        assert sr.shape == out_shape
        np.testing.assert_array_equal(lq.numpy(), want_lq)
        np.testing.assert_allclose(sr.numpy(), want_sr, atol=ATOL, rtol=0)
    # the comparison can see the alignment: with the offset / mask heads
    # back at zero the output moves by far more than the gate
    sr = _run(model, x)[0]
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, vrt.FlowGuidedDeformAlign):
                m.conv_offset_3.weight.zero_()
                m.conv_offset_3.bias.zero_()
    assert float((_run(model, x)[0] - sr).abs().max()) > 20 * ATOL


def test_tiny_vrt_matches_jax(rng):
    """TinyVRT at tests/test_vrt.py's configuration: 4 channels a group,
    so the 32x32 and 16x16 stages pack (gp = 8) and the 8x8 stage, one
    x-group wide, samples a table padded to one window (the JAX model takes
    its four-corner gather there)."""
    kw = dict(upscale=4, window_size=(2, 4, 4), depths=(2,) * 7, embed_dims=(8,) * 7,
              num_heads=(2,) * 7, deformable_groups=2)
    model, x, want = _model_pair(jvrt.TinyVRT, vrt.TinyVRT, kw, (1, 4, 32, 32, 3), rng)
    _check_model(model, x, want, (1, 4, 128, 128, 3))


def test_narrow_vrt_matches_jax(rng):
    """A 2-frame 7-stage VRT, 24 + 12 channels: 12 channels a group take
    gp = 2 rows, the layout of the full-width alignment."""
    kw = dict(upscale=4, window_size=(2, 4, 4), depths=(2,) * 7 + (1,) * 6,
              embed_dims=(24,) * 7 + (12,) * 6, num_heads=(2,) * 13, deformable_groups=2)
    model, x, want = _model_pair(jvrt.VRT, vrt.VRT, kw, (1, 2, 32, 32, 3), rng)
    _check_model(model, x, want, (1, 2, 128, 128, 3))


def test_vrt_paper_configuration_and_entry_point():
    """The default VRT is the paper configuration (30.68 M parameters), and
    ``make_forward`` asks for CUDA unless the caller names the CPU."""
    from vsrlab_tpu_torch.evaluation.harness import make_forward

    model = vrt.VRT(upscale=4, img_size=(16, 256, 256), dtype=torch.bfloat16)
    assert sum(p.numel() for p in model.parameters()) == 30_676_435
    assert model.stage1.pa_deform.deformable_groups == 12
    assert model.stage1.pa_deform.sampler_impl == "fused"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_forward(model)
    tiny = vrt.TinyVRT(window_size=(2, 4, 4), depths=(2,) * 7, embed_dims=(8,) * 7,
                       num_heads=(2,) * 7, deformable_groups=2)
    sr = make_forward(tiny, device="cpu")(np.zeros((1, 2, 16, 16, 3), np.float32))
    assert sr.shape == (1, 2, 64, 64, 3)
