"""The GAN slice's modules against vsrlab_tpu on the CPU, fp32, with the
parameters (and the spectral-norm state) carried across by
``vsrlab_tpu_torch.convert``.

* ``SpectralConv`` against flax's ``nn.SpectralNorm`` around a bias-free
  conv: the output, the stored ``u`` / ``sigma`` after ``update_stats``,
  the power iteration that runs but stores nothing without it, a second
  call from the stored ``u``, and the gradient with respect to the kernel
  (rtol 1e-5).
* ``UNetDiscriminator`` (mid 8) on ``(2, 32, 32, 3)``: the logits and the
  updated state of every conv, two passes (atol 1e-5).
* ``VGG19Features`` from the JAX ``PRNGKey(0)`` init, against JAX and the
  golden ``tests/golden/vgg19_features_seed0.npz`` (1e-5, as
  ``test_perceptual_golden.py``); ``PerceptualLoss`` and its gradient.
* ``bce_with_logits``, ``adversarial_loss``, ``compute_loss`` and
  ``LossPipeline`` with ``match_`` (rtol 1e-5).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vsrlab_tpu.core import losses as jlosses  # noqa: E402
from vsrlab_tpu.core.perceptual import PerceptualLoss as JPerceptualLoss  # noqa: E402
from vsrlab_tpu.core.perceptual import VGG19Features as JVGG19Features  # noqa: E402
from vsrlab_tpu.models import UNetDiscriminator as JUNetDiscriminator  # noqa: E402
from vsrlab_tpu.nn.blocks import SpectralConv as JSpectralConv  # noqa: E402
from vsrlab_tpu_torch import convert  # noqa: E402
from vsrlab_tpu_torch.core import losses  # noqa: E402
from vsrlab_tpu_torch.core.perceptual import (  # noqa: E402
    LAYER_WEIGHTS, PerceptualLoss, VGG19Features, load_torch_vgg19)
from vsrlab_tpu_torch.models import UNetDiscriminator  # noqa: E402
from vsrlab_tpu_torch.nn.blocks import SpectralConv  # noqa: E402

GOLDEN = Path(__file__).parent / "golden" / "vgg19_features_seed0.npz"
TOL = dict(rtol=1e-5, atol=1e-6)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


# (in, out, kernel, stride): the discriminator's down and plain shapes
SPECTRAL = {"down": (4, 8, 4, 2), "plain": (6, 5, 3, 1)}


@pytest.mark.parametrize("case", sorted(SPECTRAL))
def test_spectral_conv_matches_flax(case):
    cin, cout, k, s = SPECTRAL[case]
    jmod = JSpectralConv(cout, k, s, 1)
    x = np.random.default_rng(1).standard_normal((2, 12, 12, cin)).astype(np.float32)
    g = np.random.default_rng(2).standard_normal((2, 12 // s, 12 // s, cout)).astype(np.float32)
    variables = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x))
    sd = convert.unet_discriminator_state_dict({"c": variables["params"]},
                                               {"c": variables["batch_stats"]})
    mine = SpectralConv(cin, cout, k, s, 1)
    mine.load_state_dict({n.removeprefix("c."): v for n, v in sd.items()})
    u0 = mine.u.clone()

    # without update_stats: the iteration runs (the output uses its sigma), nothing is stored
    want = jmod.apply(variables, jnp.asarray(x))
    got = mine(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    assert torch.equal(mine.u, u0) and float(mine.sigma) == 1.0

    # with it, twice: the second call iterates from the u the first stored
    state = variables
    for _ in range(2):
        want, upd = jmod.apply(state, jnp.asarray(x), update_stats=True, mutable=["batch_stats"])
        state = {"params": variables["params"], "batch_stats": upd["batch_stats"]}
        got = mine(_t(x), update_stats=True)
        stats = upd["batch_stats"]["SpectralNorm_0"]
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(mine.u.numpy(), np.asarray(stats["Conv_0/kernel/u"]), **TOL)
        np.testing.assert_allclose(float(mine.sigma), float(stats["Conv_0/kernel/sigma"]),
                                   rtol=1e-5)
    assert not torch.equal(mine.u, u0)

    # the gradient reaches the kernel through sigma too; u and v carry none
    def jloss(params):
        return jnp.sum(jmod.apply({"params": params, "batch_stats": state["batch_stats"]},
                                  jnp.asarray(x)) * g)

    jgrad = jax.grad(jloss)(state["params"])["Conv_0"]["kernel"]
    mine.weight.grad = None
    (mine(_t(x)) * _t(g)).sum().backward()
    np.testing.assert_allclose(mine.weight.grad.numpy(),
                               np.asarray(jgrad).transpose(3, 2, 0, 1), rtol=1e-5, atol=1e-5)


def test_spectral_conv_second_pass_in_one_graph():
    """Two stored passes, one backward (the discriminator's own step): the
    in-place write of ``u`` trips no version check, and the gradient is
    the sum of both passes'."""
    conv = SpectralConv(3, 4, 3, 1, 1)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(1, 6, 6, 3, generator=torch.Generator().manual_seed(1))
    (conv(x, update_stats=True).sum() + conv(x, update_stats=True).sum()).backward()
    assert conv.weight.grad is not None and bool(torch.isfinite(conv.weight.grad).all())


class TestDiscriminator:
    @pytest.fixture(scope="class")
    def setup(self):
        jmod = JUNetDiscriminator(mid_channels=8)
        x = np.random.default_rng(4).random((2, 32, 32, 3), dtype=np.float32)
        variables = jmod.init(jax.random.PRNGKey(5), jnp.asarray(x))
        mine = UNetDiscriminator(mid_channels=8)
        mine.load_state_dict(convert.unet_discriminator_state_dict(
            _np(variables["params"]), _np(variables["batch_stats"])))
        return jmod, variables, mine, x

    def test_logits_and_stats_match_jax(self, setup):
        jmod, variables, mine, x = setup
        want = jmod.apply(variables, jnp.asarray(x))
        np.testing.assert_allclose(mine(_t(x)).detach().numpy(), np.asarray(want), atol=1e-5)
        state = variables
        for _ in range(2):
            want, upd = jmod.apply(state, jnp.asarray(x), update_stats=True,
                                   mutable=["batch_stats"])
            state = {"params": variables["params"], "batch_stats": upd["batch_stats"]}
            got = mine(_t(x), update_stats=True)
            assert got.shape == (2, 32, 32, 1)
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
            want_sd = convert.unet_discriminator_state_dict(_np(state["params"]),
                                                            _np(state["batch_stats"]))
            for name, v in mine.state_dict().items():
                np.testing.assert_allclose(v.numpy(), want_sd[name].numpy(), atol=1e-5,
                                           err_msg=name)

    def test_state_dict_names(self, setup):
        mine = setup[2]
        names = set(mine.state_dict())
        assert {"conv_0.bias", "conv_9.bias", "conv_1.u", "conv_8.sigma"} <= names
        assert not any(n.startswith(("conv_1.bias", "conv_8.bias")) for n in names)
        assert mine.conv_3.u.shape == (1, 64) and mine.conv_3.weight.shape == (64, 32, 4, 4)

    def test_bf16_compute_keeps_fp32_state(self, setup):
        _, _, mine, x = setup
        d16 = UNetDiscriminator(mid_channels=8, dtype="bfloat16")
        d16.load_state_dict(mine.state_dict())
        out = d16(_t(x), update_stats=True).detach()
        assert out.dtype == torch.bfloat16 and d16.conv_1.u.dtype == torch.float32
        ref = mine(_t(x)).detach()
        assert float((out.float() - ref).abs().max()) < 5e-2 * float(ref.abs().max()) + 5e-2


class TestVGG:
    @pytest.fixture(scope="class")
    def setup(self):
        jmod = JVGG19Features()
        x = np.random.default_rng(0).random((1, 16, 16, 3))
        params = jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32))["params"]
        mine = VGG19Features()
        mine.load_state_dict(convert.vgg19_state_dict(_np(params)))
        return jmod, params, mine, x.astype(np.float32)

    def test_taps_match_jax_and_golden(self, setup):
        jmod, params, mine, x = setup
        want = jmod.apply({"params": params}, jnp.asarray(x))
        with torch.no_grad():
            got = mine(_t(x))
        golden = np.load(GOLDEN)
        assert set(got) == set(int(k) for k in golden.files) == set(LAYER_WEIGHTS)
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                       err_msg=f"tap {k} vs JAX")
            np.testing.assert_allclose(v.numpy(), golden[str(k)], rtol=1e-5, atol=1e-5,
                                       err_msg=f"tap {k} vs golden")

    def test_perceptual_loss_and_gradient_match_jax(self, setup):
        _, params, mine, _ = setup
        rng = np.random.default_rng(6)
        a = rng.random((1, 2, 16, 16, 3), dtype=np.float32)
        b = rng.random((1, 2, 16, 16, 3), dtype=np.float32)
        jloss = JPerceptualLoss(weight=0.5, params=params)
        want, jgrad = jax.value_and_grad(lambda y: jloss(y, jnp.asarray(b)))(jnp.asarray(a))
        ploss = PerceptualLoss(weight=0.5, state_dict=mine.state_dict())
        assert not any(p.requires_grad for p in ploss.parameters())
        ta = _t(a).requires_grad_(True)
        got = ploss(ta, _t(b))
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
        np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jgrad), rtol=1e-4, atol=1e-9)

    def test_default_init_is_seeded_he_normal(self):
        one, two = PerceptualLoss(rng=0), PerceptualLoss(rng=0)
        assert all(torch.equal(p, q) for p, q in zip(one.parameters(), two.parameters()))
        w = one.model.conv_10.weight
        std = (2.0 / w[0].numel()) ** 0.5
        assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
        assert abs(float(w.std()) / std - 1.0) < 0.05
        assert all(float(m.bias.abs().max()) == 0.0 for m in one.model.children())

    def test_torchvision_layout_loads(self, setup):
        _, _, mine, x = setup
        tv = {f"features.{k.split('.')[0][5:]}.{k.split('.')[1]}": v
              for k, v in mine.state_dict().items()}
        loaded = VGG19Features()
        loaded.load_state_dict(load_torch_vgg19(tv))
        with torch.no_grad():
            assert all(torch.equal(loaded(_t(x))[k], mine(_t(x))[k]) for k in LAYER_WEIGHTS)


def test_bce_and_adversarial_losses_match_jax():
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((3, 8, 8, 1)) * 30).astype(np.float32)
    targets = rng.random((3, 8, 8, 1)).astype(np.float32)
    np.testing.assert_allclose(float(losses.bce_with_logits(_t(logits), _t(targets))),
                               float(jlosses.bce_with_logits(jnp.asarray(logits),
                                                             jnp.asarray(targets))), rtol=1e-5)
    for target in (0.0, 1.0):
        for is_disc in (False, True):
            got = losses.adversarial_loss(_t(logits).bfloat16(), target, is_disc, 3e-4)
            want = jlosses.adversarial_loss(jnp.asarray(logits, jnp.bfloat16), target, is_disc,
                                            3e-4)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_compute_loss_and_pipeline_match_jax():
    rng = np.random.default_rng(8)
    sr, hr = (rng.random((2, 3, 16, 20, 3), dtype=np.float32) for _ in range(2))
    lq = rng.random((2, 3, 4, 5, 3), dtype=np.float32)
    for with_lq in (False, True):
        got = losses.compute_loss(losses.charbonnier_loss, _t(sr), _t(hr),
                                  _t(lq) if with_lq else None)
        want = jlosses.compute_loss(jlosses.charbonnier_loss, jnp.asarray(sr), jnp.asarray(hr),
                                    jnp.asarray(lq) if with_lq else None)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    pipeline = [{"pixel": {"x": "sr", "y": "hr"}}, {"clean": {"x": "lq", "y": "match_hr"}},
                {"pixel": {"x": "match_lq", "y": "hr"}}]
    args = {"sr": sr, "hr": hr, "lq": lq}
    got = losses.LossPipeline({"pixel": losses.charbonnier_loss, "clean": losses.l1_loss},
                              pipeline, prefix="train/", postfix="_x")({k: _t(v) for k, v in
                                                                        args.items()})
    want = jlosses.LossPipeline({"pixel": jlosses.charbonnier_loss, "clean": jlosses.l1_loss},
                                pipeline, prefix="train/", postfix="_x")(
        {k: jnp.asarray(v) for k, v in args.items()})
    assert got.keys() == want.keys() and {"train/loss_x", "train/pixel_x"} <= got.keys()
    for k in ("train/loss_x", "train/pixel_x", "train/clean_x"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
