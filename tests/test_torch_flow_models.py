"""The port's flow models against vsrlab_tpu on the CPU, fp32, with the
same parameters (numpy draws over ``jax.eval_shape(model.init, ...)``,
carried across by ``vsrlab_tpu_torch.convert``) and seeded numpy frames:
RAFT small and basic, the reference-checkpoint importer on a surrogate
state dict, IRR-PWC, the progressive SpyNet, and ``OpticalFlowConsistency``
(its value and its gradient with respect to the SR clip).

On the CPU the sampler kernel's wrapper runs its plain version, so the
flow models' ``"fused"`` lookups and warps test the function the kernel
computes. Tolerance 1e-4 relative to the largest value of each output:
both sides do the same fp32 arithmetic in another order through some
twenty convolutions and, in RAFT, a recurrence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vsrlab_tpu.core.losses import OpticalFlowConsistency as JOpticalFlowConsistency  # noqa: E402
from vsrlab_tpu.models.flow import RAFT as JRAFT  # noqa: E402
from vsrlab_tpu.models.flow import IRRPWCNet as JIRRPWCNet  # noqa: E402
from vsrlab_tpu.models.flow import SpyNetProgressive as JSpyNetProgressive  # noqa: E402
from vsrlab_tpu.models.flow import irr as jirr  # noqa: E402
from vsrlab_tpu.models.flow import load_torch_raft  # noqa: E402
from vsrlab_tpu_torch import convert  # noqa: E402
from vsrlab_tpu_torch.core.losses import OpticalFlowConsistency  # noqa: E402
from vsrlab_tpu_torch.models.flow import (  # noqa: E402
    RAFT, GConf, IRRPWCNet, SpyNetProgressive, load_raft_state_dict)
from vsrlab_tpu_torch.models.flow.irr import window_inside  # noqa: E402
from vsrlab_tpu_torch.ops import warp  # noqa: E402
from vsrlab_tpu_torch.nn.blocks import init_weights  # noqa: E402
from vsrlab_tpu_torch.ops import bilinear_sample as bs  # noqa: E402

RTOL = 1e-4


def draw_params(rng, model, *args, gain: float = 1.0, **kw):
    """He-normal kernels (std ``gain * sqrt(2 / fan_in)``) and N(0, 0.01)
    biases over the JAX model's parameter shapes."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args, **kw)["params"]

    def draw(path, s):
        if path[-1].key == "kernel":
            return rng.standard_normal(s.shape) * gain * np.sqrt(2.0 / np.prod(s.shape[:-1]))
        return rng.standard_normal(s.shape) * 0.01

    return jax.tree_util.tree_map_with_path(lambda p, s: draw(p, s).astype(np.float32), shapes)


def close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(float(np.abs(want).max()), 1e-6))


def _frames(rng, n=1, h=64, w=64):
    return (rng.random((n, h, w, 3)).astype(np.float32) for _ in range(2))


@pytest.mark.parametrize("small,iters,scale", [(True, 3, 8), (False, 2, 2)])
def test_raft_matches_jax(rng, small, iters, scale):
    a, b = _frames(rng)
    jm = JRAFT(small=small, scale_factor=scale, iters=iters)
    params = draw_params(rng, jm, jnp.asarray(a), jnp.asarray(b))
    want = jm.apply({"params": params}, jnp.asarray(a), jnp.asarray(b))
    model = RAFT(small=small, scale_factor=scale, iters=iters)
    model.load_state_dict(convert.raft_state_dict(params))
    bs.reset_launch_counts()
    with torch.no_grad():
        got = model(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (1, 8 * scale, 8 * scale, 2)
    close(got, want)
    assert bs.bilinear_sample.launches == 0  # CPU: the plain version, no kernel


def test_raft_importer_loads_a_reference_layout_checkpoint_in_both_packages(rng):
    """A surrogate of the reference's ``raft-small.pth``: a seeded port
    RAFT's state dict with ``module.`` prefixes and the entries both
    importers skip (batch-norm statistics), through ``load_torch_raft`` and
    through ``load_raft_state_dict``; the two models agree."""
    src = init_weights(RAFT(small=True, scale_factor=8, iters=2), torch.Generator().manual_seed(3))
    sd = {f"module.{k}": v for k, v in src.state_dict().items()}
    sd["module.cnet.norm1.running_mean"] = torch.zeros(96)
    model = load_raft_state_dict(RAFT(small=True, scale_factor=8, iters=2), sd)
    for k, v in src.state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)
    params = load_torch_raft(sd, small=True)
    a, b = _frames(rng)
    want = JRAFT(small=True, scale_factor=8, iters=2).apply({"params": params}, jnp.asarray(a),
                                                           jnp.asarray(b))
    with torch.no_grad():
        close(model(torch.from_numpy(a), torch.from_numpy(b)), want)
    del sd["module.fnet.conv1.weight"]
    with pytest.raises(KeyError, match="fnet.conv1.weight"):
        load_raft_state_dict(RAFT(small=True), sd)


def test_irr_window_mask_is_the_warped_ones_away_from_the_rounding_edge(rng):
    """``window_inside`` against the reference's mask, a warp of ones
    ``>= 1``: equal wherever that rounded sum is more than 1e-6 from 1 (it
    is exactly the per-corner test there); a pixel whose sum rounds to 1
    ulp below 1 is the one place the two may differ."""
    flow = torch.from_numpy((rng.standard_normal((2, 16, 16, 2)) * 4).astype(np.float32))
    flow[0, 0, :3] = torch.tensor([[float("nan"), 0.0], [-1e-9, 0.0], [0.0, 15.0]])
    ones = warp.flow_warp(torch.ones((2, 16, 16, 1)), flow, padding_mode="zeros")
    exact = window_inside(flow)
    away = (ones - 1.0).abs() > 1e-6
    assert bool(((ones >= 1.0) == exact)[away].all())
    assert exact[0, 0, :3, 0].tolist() == [False, True, True]
    assert 0 < int(exact.sum()) < exact.numel()


def test_irr_pwc_matches_jax(rng, monkeypatch):
    """With the JAX model's window mask made exact as the port's is (its
    warp of ones replaced by ``window_inside``): the rounded-sum test of
    the JAX package zeroes a few pixels whose window lies inside the image
    (the sum lands 1 ulp below 1), which moves the flows of the levels
    after by about 1 %."""
    orig = jirr.flow_warp

    def exact_mask_warp(x, flow, padding_mode="zeros", **kw):
        if bool(jnp.all(x == 1.0)):  # the mask's warp of ones (the model runs eagerly)
            mask = window_inside(torch.from_numpy(np.array(flow))).numpy()
            return jnp.asarray(np.broadcast_to(mask, x.shape).astype(np.float32))
        return orig(x, flow, padding_mode=padding_mode, **kw)

    a, b = _frames(rng)
    jm = JIRRPWCNet(return_levels=(-1, -2, -3, -4))
    params = draw_params(rng, jm, jnp.asarray(a), jnp.asarray(b))
    monkeypatch.setattr(jirr, "flow_warp", exact_mask_warp)
    want_f, want_b = jm.apply({"params": params}, jnp.asarray(a), jnp.asarray(b))
    model = IRRPWCNet(return_levels=(-1, -2, -3, -4))
    model.load_state_dict(convert.irr_pwc_state_dict(params))
    with torch.no_grad():
        got_f, got_b = model(torch.from_numpy(a), torch.from_numpy(b))
    assert [tuple(f.shape) for f in got_f] == [(1, 64, 64, 2), (1, 32, 32, 2), (1, 16, 16, 2),
                                               (1, 8, 8, 2)]
    for g, w in zip(got_f + got_b, list(want_f) + list(want_b)):
        close(g, w)


def test_spynet_progressive_matches_jax_in_train_and_eval_sizing(rng):
    assert GConf(0).image_size == (24, 32) and GConf(5).image_size == (768, 1024)
    with pytest.raises(ValueError):
        GConf(6)
    f1, f2 = _frames(rng, 2, 48, 64)
    frames = (jnp.asarray(f1), jnp.asarray(f2))
    jm = JSpyNetProgressive(k=3, return_levels=(0, 1, 2))
    params = draw_params(rng, jm, frames)
    model = SpyNetProgressive(k=3, return_levels=(0, 1, 2))
    model.load_state_dict(convert.spynet_progressive_state_dict(params))
    tf = (torch.from_numpy(f1), torch.from_numpy(f2))
    with torch.no_grad():
        for train in (True, False):
            want = jm.apply({"params": params}, frames, train=train)
            got = model(tf, train=train)
            assert isinstance(got, list) and len(got) == 3
            for g, w in zip(got, want):
                close(g, w)
        # the curriculum: only the first two levels, one level returned
        jone = JSpyNetProgressive(k=3, return_levels=(1,))
        one = SpyNetProgressive(k=3, return_levels=(1,))
        one.load_state_dict(model.state_dict())
        want = jone.apply({"params": params}, frames, train=True, limit_k=2)
        got = one(tf, train=True, limit_k=2)
        assert got.shape == (2, *GConf(1).image_size, 2)
        close(got, want)


def test_optical_flow_consistency_matches_jax_value_and_gradient(rng):
    """The loss on a 3-frame 64x64 SR / HR pair of clips (two flow pairs a
    clip) with the same random RAFT-small, and its gradient with respect to
    SR (the flows' vector-Jacobian product, through the 48 lookups a
    forward); the RAFT's parameters take none. The kernels are drawn at half
    the He scale: at the full scale the 12 GRU iterations diverge (flows of
    170 px on a 64x64 frame) and amplify the two packages' rounding to
    about 1e-4 of the flow."""
    sr = rng.random((1, 3, 64, 64, 3)).astype(np.float32)
    hr = np.clip(sr + rng.standard_normal(sr.shape).astype(np.float32) * 0.1, 0, 1)
    jraft = JRAFT(small=True, scale_factor=8)
    params = draw_params(rng, jraft, jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64, 3)),
                         gain=0.5)
    jloss = JOpticalFlowConsistency.__new__(JOpticalFlowConsistency)  # no jitted init
    jloss.weight, jloss.model, jloss.params = 0.5, jraft, params
    want = jloss(jnp.asarray(sr), jnp.asarray(hr))

    loss = OpticalFlowConsistency(weight=0.5)
    loss.model.load_state_dict(convert.raft_state_dict(params))
    tsr = torch.from_numpy(sr).requires_grad_()
    got = loss(tsr, torch.from_numpy(hr))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    # the gradient is the flows' vector-Jacobian product with sign(flow_sr -
    # flow_hr) * weight / size: where a difference lies within rounding of 0
    # the two packages' signs may differ, so the JAX product is taken with
    # the port's signs
    with torch.no_grad():
        diff = loss._flows(torch.from_numpy(sr)) - loss._flows(torch.from_numpy(hr))
    _, vjp = jax.vjp(jloss._flows, jnp.asarray(sr))
    (want_g,) = vjp(jnp.asarray((torch.sign(diff) * 0.5 / diff.numel()).numpy()))
    # a ReLU whose input lies within rounding of 0 takes its other branch in
    # one package: the 7x7x3 input patch under one first-layer unit then
    # differs (0.4 % of the elements here). So: 99 % of the elements within
    # 1e-4 of the largest, the whole within 1e-2 in L2
    got_g, want_g = tsr.grad.numpy(), np.asarray(want_g)
    err = np.abs(got_g - want_g)
    assert np.isfinite(got_g).all()
    assert (err <= RTOL * np.abs(want_g).max()).mean() >= 0.99
    assert np.linalg.norm(got_g - want_g) <= 1e-2 * np.linalg.norm(want_g)
    assert all(p.grad is None and not p.requires_grad for p in loss.model.parameters())


def test_optical_flow_consistency_falls_back_to_a_seeded_raft(tmp_path):
    """No checkpoint file: the seeded RAFT-small, the same every time; a
    checkpoint file that exists is loaded."""
    a = OpticalFlowConsistency(raft_ckpt=str(tmp_path / "missing.pth"))
    b = OpticalFlowConsistency()
    for (k, v), w in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)
    src = init_weights(RAFT(small=True, scale_factor=8), torch.Generator().manual_seed(4))
    ckpt = tmp_path / "raft-small.pth"
    torch.save({f"module.{k}": v for k, v in src.state_dict().items()}, ckpt)
    c = OpticalFlowConsistency(raft_ckpt=str(ckpt))
    for v, w in zip(c.model.state_dict().values(), src.state_dict().values()):
        torch.testing.assert_close(v, w, rtol=0, atol=0)
    assert not torch.equal(c.model.fnet.conv1.weight, a.model.fnet.conv1.weight)
