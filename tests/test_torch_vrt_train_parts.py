"""The parts of VRT training in vsrlab_tpu_torch that need no JAX train
step, on the CPU: ``remat`` against no remat (rtol 1e-5, atol 1e-7,
``tests/test_vrt.py:244``'s gate), stochastic depth under remat, the frozen
flow net, ``DropPath``, the deterministic train step, ``head_shard_axis``,
the row gather's backward (``PackedRowGather.backward``, called directly:
on the CPU the wrapper is autograd through the plain version), the
deformable conv's gradients against the JAX package's, and the ``take``
route against the plain sampler bit for bit. The tiny TinyVRT, its batch
and its parameters are those of ``test_torch_vrt_train.py``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vsrlab_tpu.ops import deform as jdeform  # noqa: E402
from vsrlab_tpu_torch.models import vrt  # noqa: E402
from vsrlab_tpu_torch.models.vrt.tmsa import DropPath  # noqa: E402
from vsrlab_tpu_torch.ops import deform, packed_gather  # noqa: E402
from vsrlab_tpu_torch.train.builders import build_tx  # noqa: E402
from vsrlab_tpu_torch.train.state import create_train_state  # noqa: E402
from vsrlab_tpu_torch.train.step import make_supervised_train_step  # noqa: E402
from test_torch_vrt_train import (  # noqa: E402,F401  (batch and params are fixtures)
    OPT, ROUTES, _port, _tensors, batch, params)


def _loss_and_grads(model, batch, **kw):
    model.zero_grad(set_to_none=True)
    lr, hr = (torch.from_numpy(a) for a in batch)
    sr, _ = model(lr, **kw)
    loss = (sr - hr).square().mean()
    loss.backward()
    return sr.detach(), {n: p.grad for n, p in model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("impl", ROUTES)
def test_remat_matches_no_remat(batch, params, impl):
    """``remat`` recomputes each Stage and trunk RTMSA in the backward: the
    forward and every gradient as without it, on every sampler route."""
    sr, grads = _loss_and_grads(_port(params, impl), batch)
    sr_r, grads_r = _loss_and_grads(_port(params, impl, remat=True), batch)
    np.testing.assert_allclose(sr_r.numpy(), sr.numpy(), rtol=1e-5, atol=1e-7)
    assert grads.keys() == grads_r.keys() and len(grads) > 50
    for k in grads:
        np.testing.assert_allclose(grads_r[k].numpy(), grads[k].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_remat_recompute_drops_the_same_paths(batch, params):
    """Outside deterministic mode each unit draws its paths from a seed
    taken from the caller's generator outside the checkpoint: with remat
    the recompute drops the same samples, so the gradients equal the
    un-remat'd ones from the same generator seed; and paths were dropped."""
    runs = []
    for remat in (False, True):
        model = _port(params, "fused", remat=remat, drop_path_rate=0.6)
        runs.append(_loss_and_grads(model, batch, deterministic=False,
                                    generator=torch.Generator().manual_seed(5)))
    (sr, grads), (sr_r, grads_r) = runs
    np.testing.assert_allclose(sr_r.numpy(), sr.numpy(), rtol=1e-5, atol=1e-7)
    for k in grads:
        np.testing.assert_allclose(grads_r[k].numpy(), grads[k].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    sr_det, _ = _loss_and_grads(_port(params, "fused", drop_path_rate=0.6), batch)
    assert float((sr_det - sr).abs().max()) > 1e-3


def test_flow_net_is_frozen(batch, params):
    """SpyNet's parameters get a zero gradient and Adam leaves them bitwise
    equal (``tests/test_vrt.py:201``); with ``optical_flow_train`` they
    get a gradient."""
    model = _port(params, "fused")
    _, grads = _loss_and_grads(model, batch)
    assert not any(k.startswith("optical_flow.") for k in grads)
    state = create_train_state(model, build_tx(model.parameters(), {"_target_": "adam",
                                                                    "lr": 1e-3}))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, _ = make_supervised_train_step(model)(state, _tensors(batch))
    flow = [k for k in before if k.startswith("optical_flow.")]
    assert flow and all(torch.equal(model.state_dict()[k], before[k]) for k in flow)
    assert not torch.equal(model.state_dict()["conv_first.weight"], before["conv_first.weight"])
    _, grads = _loss_and_grads(_port(params, "fused", optical_flow_train=True), batch)
    assert any(k.startswith("optical_flow.") and float(g.abs().max()) > 0
               for k, g in grads.items())


def test_drop_path_is_the_identity_when_deterministic_or_at_rate_zero(rng):
    x = torch.from_numpy(rng.random((4, 3, 5)).astype(np.float32))
    assert torch.equal(DropPath(0.5)(x), x)
    assert torch.equal(DropPath(0.5)(x, deterministic=True), x)
    assert torch.equal(DropPath(0.0)(x, deterministic=False), x)
    with pytest.raises(ValueError, match="Generator"):
        DropPath(0.5)(x, deterministic=False)


def test_drop_path_drops_whole_samples_scaled_from_an_explicit_generator():
    x = torch.ones((64, 2, 3))
    y = DropPath(0.5)(x, deterministic=False, generator=torch.Generator().manual_seed(1))
    per_sample = y.reshape(64, -1)
    zero = (per_sample == 0.0).all(1)
    kept = (per_sample == 2.0).all(1)
    assert bool((zero | kept).all()) and bool(zero.any()) and bool(kept.any())
    assert abs(float(y.mean()) - 1.0) < 0.4
    again = DropPath(0.5)(x, deterministic=False, generator=torch.Generator().manual_seed(1))
    assert torch.equal(y, again)


def test_train_step_runs_deterministic(batch, params, monkeypatch):
    """The trainer's step applies the model in deterministic mode, as the
    JAX step does: no path is dropped at ``drop_path_rate`` 0.2."""
    seen = []
    forward = DropPath.forward

    def spy(self, x, deterministic=True, generator=None):
        seen.append(deterministic)
        return forward(self, x, deterministic, generator)

    monkeypatch.setattr(DropPath, "forward", spy)
    model = _port(params, "fused")
    assert max(m.rate for m in model.modules() if isinstance(m, DropPath)) > 0
    state = create_train_state(model, build_tx(model.parameters(), OPT))
    make_supervised_train_step(model)(state, _tensors(batch))
    assert seen and all(seen)


def test_head_shard_axis_takes_none_only(params, batch):
    """Without a mesh that holds its axis, ``head_shard_axis`` changes
    nothing: the model builds, shards no head (outside ``use_mesh``, and
    inside one of a world of one, whose ``model`` axis has one rank) and
    equals the model without it bit for bit. Sharding over two ranks is in
    ``test_torch_head_parallel.py``."""
    from vsrlab_tpu_torch import parallel
    from vsrlab_tpu_torch.models.vrt.window_attention import WindowAttention

    plain = _port(params, "fused").eval()
    sharded = _port(params, "fused", head_shard_axis="model").eval()
    attn = [m for m in sharded.modules() if isinstance(m, WindowAttention)]
    assert attn and all(m.head_shard_axis == "model" for m in attn)
    lr = torch.from_numpy(batch[0][:1, :2])
    with torch.no_grad():
        want = plain(lr)[0]
        assert all(m.head_shard() is None for m in attn)
        assert torch.equal(sharded(lr)[0], want)
        with parallel.use_mesh(parallel.create_mesh({"data": 1, "model": 1})):
            assert all(m.head_shard() is None for m in attn)
            assert torch.equal(sharded(lr)[0], want)
    assert parallel.active_mesh() is None
    assert WindowAttention(8, (2, 4, 4), 2, head_shard_axis=None).head_shard() is None


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_packed_row_gather_backward_matches_autograd_through_plain(rng, dtype, tol):
    """``PackedRowGather.backward`` (``gather_grads``: ``index_add_`` in
    fp32, rounded once) against autograd through ``packed_row_gather_plain``
    summed in fp64; indices repeat and fall outside the table (clamped)."""
    n, rows, wrow, p = 3, 11, 16, 40
    xf = torch.from_numpy(rng.standard_normal((n, rows, wrow)).astype(np.float32)).to(dtype)
    idx = torch.from_numpy(rng.integers(-2, rows + 2, size=(n, p)).astype(np.int32))
    g = torch.from_numpy(rng.standard_normal((n, p, wrow)).astype(np.float32)).to(dtype)
    leaf = xf.double().requires_grad_()
    packed_gather.packed_row_gather_plain(leaf, idx).backward(g.double())
    ctx = types.SimpleNamespace(saved_tensors=(idx,), rows=rows)
    got, none = packed_gather.PackedRowGather.backward(ctx, g)
    assert none is None and got.dtype == dtype and got.shape == xf.shape
    want = leaf.grad.to(dtype).double()
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=tol,
                               atol=tol * float(want.abs().max()))
    # under a gradient the CPU wrapper is autograd through the plain version
    leaf2 = xf.clone().requires_grad_()
    packed_gather.packed_row_gather(leaf2, idx).backward(g)
    assert leaf2.grad is not None and packed_gather.packed_row_gather.launches == 0


@pytest.mark.parametrize("impl", ROUTES)
def test_modulated_deform_conv_gradients_match_jax(rng, impl):
    """The gradient of ``<g, modulated_deform_conv2d(...)>`` reaches the
    input, the offsets, the mask, the weight and the bias on every route,
    as the JAX package's (the counterpart of ``vsrlab_tpu/ops/deform.py:26,132``):
    within 1e-4 of each gradient's largest value."""
    n, h, w, cin, cout, groups = 2, 6, 7, 8, 4, 2
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    offset = (rng.standard_normal((n, h, w, 2 * groups * 9)) * 1.5).astype(np.float32)
    mask = rng.random((n, h, w, groups * 9)).astype(np.float32)
    weight = (rng.standard_normal((3, 3, cin, cout)) * 0.2).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    gout = rng.standard_normal((n, h, w, cout)).astype(np.float32)
    args = (x, offset, mask, weight, bias)

    def jloss(*a):
        out = jdeform.modulated_deform_conv2d(*a, stride=1, padding=1)
        return jnp.sum(out * gout)

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(5))))(*(jnp.asarray(a) for a in args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = deform.modulated_deform_conv2d(*leaves, stride=1, padding=1, impl=impl)
    (out * torch.from_numpy(gout)).sum().backward()
    for name, leaf, wg in zip(("x", "offset", "mask", "weight", "bias"), leaves, want):
        wg = np.asarray(wg)
        assert float(np.abs(wg).max()) > 0, name
        np.testing.assert_allclose(leaf.grad.numpy(), wg, rtol=0,
                                   atol=1e-4 * float(np.abs(wg).max()), err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size", [(12, 18, 10, 2), (8, 8, 4, None), (1, 5, 3, 2), (4, 1, 4, None)])
def test_take_route_is_the_plain_sampler_bit_for_bit(size, dtype):
    """The ``take`` route's fold weighs and adds the four corners as the
    plain sampler does: the two agree in every bit, in zeros and border
    mode, also where an image holds no whole window (the table is padded)."""
    from vsrlab_tpu_torch.ops import warp

    h, w, c, gp = size
    g = torch.Generator().manual_seed(4)
    x = torch.randn((3, h, w, c), generator=g).to(dtype)
    ix = torch.rand((3, 7, 9), generator=g) * (w + 3) - 2
    iy = torch.rand((3, 7, 9), generator=g) * (h + 3) - 2
    for mode in ("zeros", "border"):
        want = warp.sample_pixel_coords(x, ix, iy, padding_mode=mode, impl="plain")
        got = warp.sample_pixel_coords(x, ix, iy, padding_mode=mode, window_group=gp, impl="take")
        assert got.dtype == dtype and torch.equal(got, want), mode
