"""The port's GAN step and trainer against vsrlab_tpu on the CPU, fp32.

Two steps of ``make_gan_train_step`` in each package from the same
parameters (the JAX ``init`` of RealBasicVSR mid 8 / one unit, of the
discriminator mid 8 with its spectral-norm state, and of the perceptual
VGG19 at ``PRNGKey(0)``, carried across by ``vsrlab_tpu_torch.convert``)
on one seeded batch, LR ``(1, 2, 8, 8, 3)``, HR 32x32, with the perceptual
loss, an adversarial weight of 0.05 (large enough that the adversarial
gradient shows in the generator), Adam at 1e-3 with a clip of 1.0 on both
networks and an EMA of decay 0.5. After each step: the losses and metrics
(rtol 1e-5), every generator and discriminator parameter and the EMA
(atol 2e-5, as ``test_torch_train_step.py``), each conv's ``u`` /
``sigma`` (atol 1e-5). Then a frozen step (the generator bitwise
unchanged, the discriminator moved), and ``train.gan.run`` on
``+experiment=synthetic_gan`` restored from a supervised run of the port.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import vsrlab_tpu.components  # noqa: E402,F401
from vsrlab_tpu.core.perceptual import PerceptualLoss as JPerceptualLoss  # noqa: E402
from vsrlab_tpu.models import RealBasicVSR as JRealBasicVSR  # noqa: E402
from vsrlab_tpu.models import UNetDiscriminator as JUNetDiscriminator  # noqa: E402
from vsrlab_tpu.train import builders as jbuilders  # noqa: E402
from vsrlab_tpu.train.gan import make_gan_train_step as j_make_gan_step  # noqa: E402
from vsrlab_tpu.train.state import create_train_state as j_create  # noqa: E402
from vsrlab_tpu_torch import convert  # noqa: E402
from vsrlab_tpu_torch.core.checkpoint import CheckpointManager  # noqa: E402
from vsrlab_tpu_torch.core.config import load_config  # noqa: E402
from vsrlab_tpu_torch.core.perceptual import PerceptualLoss  # noqa: E402
from vsrlab_tpu_torch.models import RealBasicVSR, UNetDiscriminator  # noqa: E402
from vsrlab_tpu_torch.train import gan  # noqa: E402
from vsrlab_tpu_torch.train import train as trainer  # noqa: E402
from vsrlab_tpu_torch.train.builders import build_tx  # noqa: E402
from vsrlab_tpu_torch.train.state import create_train_state  # noqa: E402

OPT = {"_target_": "adam", "lr": 1e-3, "betas": [0.9, 0.99], "eps": 1e-8}
CLIP, ADV, EMA, STEPS = 1.0, 0.05, 0.5, 2
METRICS = ("Loss", "LossDiscriminator", "PixelLoss", "PerceptualLoss", "AdversarialLoss", "PSNR",
           "SSIM")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got: dict, want: dict, atol, what):
    assert got.keys() == want.keys(), what
    for k in want:
        np.testing.assert_allclose(got[k].detach().float().numpy(), want[k].numpy(), atol=atol,
                                   rtol=0, err_msg=f"{what} {k}")


class TestGanStep:
    @pytest.fixture(scope="class")
    def jax_run(self):
        rng = np.random.default_rng(9)
        lr = rng.random((1, 2, 8, 8, 3), dtype=np.float32)
        hr = rng.random((1, 2, 32, 32, 3), dtype=np.float32)
        jmodel = JRealBasicVSR(mid_channels=8, res_blocks=1, cleaning_blocks=1)
        jdisc = JUNetDiscriminator(mid_channels=8)
        jperc = JPerceptualLoss(weight=1e-2)
        g = j_create(jmodel, jax.random.PRNGKey(0), jnp.asarray(lr[:1]),
                     jbuilders.build_tx(OPT, None, CLIP), ema_decay=EMA)
        d = j_create(jdisc, jax.random.PRNGKey(1), jnp.asarray(hr[0, :1]),
                     jbuilders.build_tx(OPT, None, CLIP))
        start = (_np(g.params), _np(d.params), _np(d.batch_stats), _np(jperc.params))
        step = j_make_gan_step(jmodel, jdisc, jperc, ADV, True, donate=False, ema_decay=EMA)
        states, metrics = [], []
        for _ in range(STEPS):
            g, d, m = step(g, d, {"lr": jnp.asarray(lr), "hr": jnp.asarray(hr)})
            states.append((_np(g.params), _np(g.ema_params), _np(d.params),
                           _np(d.batch_stats)))
            metrics.append({k: float(v) for k, v in m.items()})
        return lr, hr, start, states, metrics

    def _port(self, start):
        gp, dp, ds, vgg = start
        model = RealBasicVSR(8, 1, 1)
        model.load_state_dict(convert.realbasicvsr_state_dict(gp))
        disc = UNetDiscriminator(mid_channels=8)
        disc.load_state_dict(convert.unet_discriminator_state_dict(dp, ds))
        perc = PerceptualLoss(weight=1e-2, state_dict=convert.vgg19_state_dict(vgg))
        g = create_train_state(model, build_tx(model.parameters(), OPT, None, CLIP),
                               ema_decay=EMA)
        d = create_train_state(disc, build_tx(disc.parameters(), OPT, None, CLIP))
        return model, disc, perc, g, d

    def test_two_steps_match_jax(self, jax_run):
        lr, hr, start, states, metrics = jax_run
        model, disc, perc, g, d = self._port(start)
        step = gan.make_gan_train_step(model, disc, perc, ADV, True, ema_decay=EMA)
        batch = {"lr": torch.from_numpy(lr), "hr": torch.from_numpy(hr)}
        for (gp, ema, dp, ds), want in zip(states, metrics):
            g, d, got = step(g, d, batch)
            assert set(got) == set(want) == set(METRICS)
            for k in METRICS:
                np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-5, err_msg=k)
            _close(model.state_dict(), convert.realbasicvsr_state_dict(gp), 2e-5, "generator")
            _close(g.ema, convert.realbasicvsr_state_dict(ema), 2e-5, "ema")
            dwant = convert.unet_discriminator_state_dict(dp, ds)
            _close({k: v for k, v in disc.state_dict().items() if k.endswith(("weight", "bias"))},
                   {k: v for k, v in dwant.items() if k.endswith(("weight", "bias"))}, 2e-5,
                   "discriminator")
            _close({k: v for k, v in disc.state_dict().items() if k.endswith(("u", "sigma"))},
                   {k: v for k, v in dwant.items() if k.endswith(("u", "sigma"))}, 1e-5,
                   "spectral state")
        assert (g.step, d.step, g.tx.count, d.tx.count) == (STEPS,) * 4
        assert metrics[-1]["AdversarialLoss"] > 0

    def test_frozen_step_leaves_the_generator_unchanged(self, jax_run):
        lr, hr, start, _, metrics = jax_run
        model, disc, perc, g, d = self._port(start)
        step = gan.make_gan_train_step(model, disc, perc, ADV, False, ema_decay=EMA)
        g0 = {k: v.clone() for k, v in model.state_dict().items()}
        ema0 = {k: v.clone() for k, v in g.ema.items()}
        d0 = {k: v.clone() for k, v in disc.state_dict().items()}
        g, d, got = step(g, d, {"lr": torch.from_numpy(lr), "hr": torch.from_numpy(hr)})
        assert all(torch.equal(v, g0[k]) for k, v in model.state_dict().items())
        assert all(torch.equal(v, ema0[k]) for k, v in g.ema.items())
        assert (g.step, g.tx.count, d.step, d.tx.count) == (0, 0, 1, 1)
        assert all(p.grad is None for p in model.parameters())
        moved = [k for k, v in disc.state_dict().items() if not torch.equal(v, d0[k])]
        assert {"conv_0.weight", "conv_9.bias", "conv_4.weight", "conv_4.u", "conv_4.sigma"} <= \
            set(moved)
        # the first step's losses, as JAX computes them before its update
        for k in ("Loss", "LossDiscriminator", "PixelLoss", "PerceptualLoss", "PSNR"):
            np.testing.assert_allclose(float(got[k]), metrics[0][k], rtol=1e-5, err_msg=k)


def _overrides(tmp_path, *more):
    return [f"core.storage_dir={tmp_path}", f"train.logger.save_dir={tmp_path}/logs",
            "train.data.num_workers=1", "device=cpu", *more]


def test_run_restores_a_supervised_run_and_resumes(tmp_path, capsys, monkeypatch):
    """A supervised port run with an EMA, then ``train.gan.run`` restored
    from it (``finetune``, ``restore_ema``; a different optimizer) on
    degraded clips (JPEG and the codec emulator), then a resume with
    ``restore_opt``; the CLI without ``device=cpu`` asks for the card."""
    sup = load_config(overrides=_overrides(tmp_path / "sup", "+experiment=synthetic",
                                           "train.ema_decay=0.9", "train.max_epochs=1"))
    trainer.run(sup, device="cpu")
    src = sup.train.checkpoint_dir
    sup_ema = CheckpointManager(f"{src}/ema").restore(0)[1]["params"]

    degrade = ("train.data.datasets.train.lr_augmentation=[{_target_: RandomJPEGCompression, "
               "quality: [30, 95]}, {_target_: RandomVideoCompression, crf: [18, 35], "
               "fps: [10, 30]}]")
    cfg = load_config(overrides=["+experiment=synthetic_gan", *_overrides(
        tmp_path / "gan", f"train.restore={src}", "train.finetune=true",
        "train.restore_ema=true", degrade)])
    assert cfg.train.data.datasets.train.lr_augmentation[1]["crf"] == [18, 35]
    model = trainer.build_model(cfg.train.model, "fp32")
    g = create_train_state(model, build_tx(model.parameters(), cfg.train.optimizer.generator))
    g, start = gan.restore_generator(g, cfg.train)
    assert start == 0 and all(torch.equal(v, sup_ema[k]) for k, v in model.state_dict().items())

    capsys.readouterr()
    final = gan.run(cfg, device="cpu")
    out = capsys.readouterr().out
    assert "epoch 0:" in out and "epoch 1:" in out and "LossDiscriminator=" in out
    assert {"Loss", "PSNR", "SSIM"} <= set(final) and all(math.isfinite(v) for v in final.values())
    for line in out.splitlines():
        if line.startswith("epoch"):
            values = [float(t.split("=")[1]) for t in line.split() if "=" in t]
            assert values and all(math.isfinite(v) for v in values), line
    ckpt = CheckpointManager(cfg.train.checkpoint_dir)
    assert ckpt.all_keys() == [0, 1]
    payload = ckpt.restore(1)[1]
    assert payload["params"].keys() == model.state_dict().keys()  # the generator only
    # freeze_epochs 0: epoch 0 keeps the generator frozen, epoch 1's 2 steps update it
    assert payload["opt_state"]["count"] == 2

    resumed = load_config(overrides=["+experiment=synthetic_gan", *_overrides(
        tmp_path / "gan", f"train.restore={cfg.train.checkpoint_dir}", "train.restore_opt=true",
        "train.finetune=false", "train.max_epochs=3")])
    g2 = create_train_state(model, build_tx(model.parameters(), resumed.train.optimizer.generator))
    g2, start = gan.restore_generator(g2, resumed.train)
    assert start == 2 and g2.tx.count == 2
    gan.run(resumed, device="cpu")
    assert ckpt.all_keys() == [0, 1, 2]

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gan.main(["+experiment=synthetic_gan", *_overrides(tmp_path / "gan")[:-1]])
