"""Reference vsrlab checkpoints into the port (``vsrlab_tpu_torch.core.torch_import``).

Synthetic state dicts in the reference's layouts (SpyNet's four, a
RealBasicVSR ``model_state_dict`` with and without DDP's ``module.``, VRT
with trunk ``stage8`` and TinyVRT with ``stage6``, the buffers the port
does not read included) go through the port's importers and through the
JAX importers composed with ``vsrlab_tpu_torch.convert``: the two must
agree tensor for tensor, and the result must load into the port's model
with ``strict=True``. SpyNet and RealBasicVSR also run forward against
the JAX models on the JAX importers' params (fp32; atol 1e-4 and 5e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_import import synth_realbasicvsr_sd, synth_spynet_sd  # noqa: E402
from vsrlab_tpu.core import torch_import as jimport  # noqa: E402
from vsrlab_tpu.models import RealBasicVSR as JRealBasicVSR  # noqa: E402
from vsrlab_tpu.models import SpyNet as JSpyNet  # noqa: E402
from vsrlab_tpu_torch import convert  # noqa: E402
from vsrlab_tpu_torch.core import torch_import  # noqa: E402
from vsrlab_tpu_torch.models import VRT, RealBasicVSR, SpyNet, TinyVRT  # noqa: E402

SPYNET_CHANNELS = ((8, 32), (32, 64), (64, 32), (32, 16), (16, 2))


def assert_same_state(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].device.type == "cpu", k
        assert torch.equal(got[k], want[k]), k


def tempered(sd: dict) -> dict:
    """``sd`` with each weight over ``sqrt(fan_in)`` and each bias x 0.1, so
    that a forward stays in range; buffers untouched."""
    out = {}
    for k, v in sd.items():
        if k.endswith("weight"):
            v = v / np.sqrt(np.prod(v.shape[1:]))
        elif k.endswith("bias"):
            v = 0.1 * v
        out[k] = v.astype(np.float32)
    return out


def spynet_layout(rng, layout: str, prefix: str = "") -> dict:
    """A six-level SpyNet in one of the reference family's layouts."""
    sd = {}
    for i in range(6):
        for j, (ci, co) in enumerate(SPYNET_CHANNELS):
            key = {"sequential": f"basic_module.{i}.basic_module.{2 * j}",
                   "convrelu": f"basic_module.{i}.basic_module.{j}.0",
                   "mmedit": f"basic_module.{i}.basic_module.{j}.conv",
                   "mmedit_seq": f"basic_module.{i}.basic_module.{j}.conv.0"}[layout]
            sd[f"{prefix}{key}.weight"] = rng.standard_normal((co, ci, 7, 7)).astype(np.float32)
            sd[f"{prefix}{key}.bias"] = rng.standard_normal(co).astype(np.float32)
    return sd


@pytest.mark.parametrize("layout,prefix", [("sequential", ""), ("sequential", "params."),
                                           ("convrelu", ""), ("mmedit", ""),
                                           ("mmedit_seq", "params.")])
def test_spynet_layouts_match_jax(rng, layout, prefix):
    sd = spynet_layout(rng, layout, prefix)
    got = torch_import.load_torch_spynet(sd)
    assert_same_state(got, convert.spynet_state_dict(jimport.load_torch_spynet(sd)))
    SpyNet().load_state_dict(got, strict=True)
    # torch tensors import as numpy arrays do
    as_torch = torch_import.load_torch_spynet({k: torch.from_numpy(v) for k, v in sd.items()})
    assert_same_state(as_torch, got)


def test_spynet_unknown_layout_raises():
    for importer in (torch_import.load_torch_spynet, jimport.load_torch_spynet):
        with pytest.raises(ValueError, match="unrecognised SpyNet state dict layout"):
            importer({"something.weird": np.zeros((2, 2))})
    sd = spynet_layout(np.random.default_rng(1), "sequential")
    del sd["basic_module.3.basic_module.4.weight"]
    with pytest.raises(ValueError, match="unrecognised SpyNet layout at level 3 conv 2"):
        torch_import.load_torch_spynet(sd)


def test_spynet_forward_matches_jax(rng):
    sd = tempered(synth_spynet_sd(rng))
    model = SpyNet()
    model.load_state_dict(torch_import.load_torch_spynet(sd), strict=True)
    ref, supp = (rng.random((1, 64, 96, 3)).astype(np.float32) for _ in range(2))
    want = np.asarray(jax.jit(JSpyNet().apply)(
        {"params": jimport.load_torch_spynet(sd)}, jnp.asarray(ref), jnp.asarray(supp)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(ref), torch.from_numpy(supp)).numpy()
    assert got.shape == want.shape == (1, 64, 96, 2)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


MID, BLOCKS, CLEANING = 8, 2, 1


@pytest.mark.parametrize("ddp", [False, True])
def test_realbasicvsr_matches_jax(rng, ddp):
    sd = synth_realbasicvsr_sd(rng, MID, BLOCKS, CLEANING)
    sd["basicvsr.spynet.mean"] = np.zeros((1, 3, 1, 1), np.float32)  # buffers the port computes
    sd["basicvsr.spynet.std"] = np.ones((1, 3, 1, 1), np.float32)
    if ddp:
        sd = {f"module.{k}": v for k, v in sd.items()}
    got = torch_import.load_torch_realbasicvsr(sd)
    assert_same_state(got, convert.realbasicvsr_state_dict(jimport.load_torch_realbasicvsr(sd)))
    RealBasicVSR(MID, BLOCKS, CLEANING).load_state_dict(got, strict=True)


def test_realbasicvsr_forward_matches_jax(rng):
    sd = tempered(synth_realbasicvsr_sd(rng, MID, BLOCKS, CLEANING))
    model = RealBasicVSR(MID, BLOCKS, CLEANING)
    model.load_state_dict(torch_import.load_torch_realbasicvsr(sd), strict=True)
    lr = rng.random((1, 3, 16, 16, 3)).astype(np.float32)
    jmodel = JRealBasicVSR(mid_channels=MID, res_blocks=BLOCKS, cleaning_blocks=CLEANING)
    params = jax.tree.map(jnp.asarray, jimport.load_torch_realbasicvsr(sd))
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(lr))[0])
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(lr))[0].numpy()
    assert got.shape == want.shape == (1, 3, 64, 64, 3)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)


def synth_vrt_sd(rng, reshapes, dims, depths, heads, ws, groups, indep=(-2, -1)):
    """A reference-layout VRT-family state dict (``src/vsr/models/VRT/vrt.py``):
    ``len(reshapes)`` stages, the trunk ModuleList after them, Conv3d
    ``(O, I, 1, 3, 3)`` convs, ``conv_offset.{0,2,4,6}``, the x4 upsample
    ladder at Sequential indices 0 / 5 / 10, ``optical_flow.*`` with its
    ``mean`` / ``std`` and every attention's ``relative_position_index``
    (and a mutual attention's ``position_bias``)."""
    sd = {}

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def conv(key, cin, cout, *k):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = arr(cout, cin, *k), arr(cout)

    def lin(key, cin, cout):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = arr(cout, cin), arr(cout)

    def ln(key, c):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = arr(c), arr(c)

    def tmsag(prefix, dim, depth, nh, wsz, mut):
        for j in range(depth):
            p = f"{prefix}.blocks.{j}"
            ln(f"{p}.norm1", dim)
            ln(f"{p}.norm2", dim)
            n = wsz[0] * wsz[1] * wsz[2]
            nrel = (2 * wsz[0] - 1) * (2 * wsz[1] - 1) * (2 * wsz[2] - 1)
            sd[f"{p}.attn.relative_position_bias_table"] = arr(nrel, nh)
            sd[f"{p}.attn.relative_position_index"] = rng.integers(0, nrel, (n, n))
            lin(f"{p}.attn.qkv_self", dim, 3 * dim)
            lin(f"{p}.attn.proj", 2 * dim if mut else dim, dim)
            if mut:
                lin(f"{p}.attn.qkv_mut", dim, 3 * dim)
                sd[f"{p}.attn.position_bias"] = arr(1, 2 * wsz[1] * wsz[2], dim)
            for fc, (ci, co) in (("fc11", (dim, 2 * dim)), ("fc12", (dim, 2 * dim)),
                                 ("fc2", (2 * dim, dim))):
                lin(f"{p}.mlp.{fc}", ci, co)

    ns = len(reshapes)
    for i, rs in enumerate(reshapes, start=1):
        d, prev = dims[i - 1], dims[i - 2]
        if rs == "none":
            ln(f"stage{i}.reshape.1", d)
        else:
            cin = 4 * prev if rs == "down" else prev // 4
            ln(f"stage{i}.reshape.1", cin)
            lin(f"stage{i}.reshape.2", cin, d)
        d1 = int(depths[i - 1] * 0.75)
        tmsag(f"stage{i}.residual_group1", d, d1, heads[i - 1], (2, ws[1], ws[2]), True)
        tmsag(f"stage{i}.residual_group2", d, depths[i - 1] - d1, heads[i - 1], ws, False)
        lin(f"stage{i}.linear1", d, d)
        lin(f"stage{i}.linear2", d, d)
        conv(f"stage{i}.pa_deform.conv_offset.0", 2 * d + 2, d, 3, 3)
        conv(f"stage{i}.pa_deform.conv_offset.2", d, d, 3, 3)
        conv(f"stage{i}.pa_deform.conv_offset.4", d, d, 3, 3)
        conv(f"stage{i}.pa_deform.conv_offset.6", d, 3 * 9 * groups, 3, 3)
        conv(f"stage{i}.pa_deform", d, d, 3, 3)
        lin(f"stage{i}.pa_fuse.fc11", 3 * d, 3 * d)
        lin(f"stage{i}.pa_fuse.fc12", 3 * d, 3 * d)
        lin(f"stage{i}.pa_fuse.fc2", 3 * d, d)

    tp = f"stage{ns + 1}"
    ln(f"{tp}.0.1", dims[ns - 1])
    lin(f"{tp}.0.2", dims[ns - 1], dims[ns])
    indep = [i % len(depths) for i in indep]
    for k, i in enumerate(range(ns, len(depths)), start=1):
        wsz = (1, ws[1], ws[2]) if i in indep else ws
        tmsag(f"{tp}.{k}.residual_group", dims[i], depths[i], heads[i], wsz, False)
        lin(f"{tp}.{k}.linear", dims[i], dims[i])

    ln("norm", dims[-1])
    lin("conv_after_body", dims[-1], dims[0])
    conv("conv_first", 27, dims[0], 1, 3, 3)
    conv("conv_before_upsample.0", dims[0], 64, 1, 3, 3)
    conv("upsample.0", 64, 256, 1, 3, 3)
    conv("upsample.5", 64, 256, 1, 3, 3)
    conv("upsample.10", 64, 64, 1, 3, 3)
    conv("conv_last", 64, 3, 1, 3, 3)
    sd.update(synth_spynet_sd(rng, prefix="optical_flow."))
    sd["optical_flow.mean"] = np.zeros((1, 3, 1, 1), np.float32)
    sd["optical_flow.std"] = np.ones((1, 3, 1, 1), np.float32)
    return sd


VRT_CASES = {
    # the paper's seven scale stages, trunk stage8 (six reconstruction groups)
    "vrt": (VRT, 7, ("none", "down", "down", "down", "up", "up", "up"), 13),
    # TinyVRT's five, trunk stage6 (two)
    "tinyvrt": (TinyVRT, 5, ("none", "down", "down", "up", "up"), 7),
}


@pytest.mark.parametrize("name", sorted(VRT_CASES))
@pytest.mark.parametrize("ddp", [False, True])
def test_vrt_matches_jax(rng, name, ddp):
    cls, n_stages, reshapes, n = VRT_CASES[name]
    ws, groups = (2, 4, 4), 2
    dims, heads = (8,) * n_stages + (12,) * (n - n_stages), (2,) * n
    depths = (2,) * n_stages + (1,) * (n - n_stages)
    sd = synth_vrt_sd(rng, reshapes, dims, depths, heads, ws, groups)
    if ddp:
        sd = {f"module.{k}": torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    got = torch_import.load_torch_vrt(sd, n_scale_stages=n_stages)
    assert_same_state(got, convert.vrt_state_dict(jimport.load_torch_vrt(sd, n_stages)))
    model = cls(upscale=4, window_size=ws, depths=depths, embed_dims=dims, num_heads=heads,
                deformable_groups=groups)
    model.load_state_dict(got, strict=True)
    # the (O, I, 1, 3, 3) Conv3d is the port's (O, I, 3, 3) conv, unchanged
    first = sd[("module." if ddp else "") + "conv_first.weight"]
    assert torch.equal(got["conv_first.weight"], torch.as_tensor(np.asarray(first))[:, :, 0])


def test_reference_checkpoint_unwraps(tmp_path, rng):
    sd = {k: torch.from_numpy(v) for k, v in synth_spynet_sd(rng).items()}
    for i, wrapped in enumerate(({"epoch": 3, "model_state_dict": sd}, {"state_dict": sd},
                                 {"params": sd}, sd)):
        path = tmp_path / f"ckpt{i}.pth"
        torch.save(wrapped, path)
        got = torch_import.load_reference_checkpoint(path)
        assert got.keys() == sd.keys() and all(torch.equal(got[k], sd[k]) for k in sd)
