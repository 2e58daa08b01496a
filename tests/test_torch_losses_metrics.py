"""The port's losses, metrics and learning-rate schedules against
vsrlab_tpu's on the CPU, on seeded numpy inputs. Gates: losses and PSNR
rtol 1e-6, SSIM (and its Y variant) 1e-5 (the same fp32 sums, filtered
in the same order), schedules 1e-6 of the peak learning rate (JAX
evaluates them in fp32, the port in Python floats: the error scales with
the terms, the peak, not with the result near its floor)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vsrlab_tpu.core import losses as jlosses  # noqa: E402
from vsrlab_tpu.core import metrics as jmetrics  # noqa: E402
from vsrlab_tpu.core import schedulers as jsched  # noqa: E402
from vsrlab_tpu_torch.core import losses, metrics, schedulers  # noqa: E402


@pytest.fixture
def pair(rng):
    hr = rng.random((2, 3, 20, 24, 3)).astype(np.float32)
    sr = np.clip(hr + rng.normal(0, 0.1, hr.shape), -0.2, 1.2).astype(np.float32)
    return sr, hr


@pytest.mark.parametrize("name", ["charbonnier_loss", "l1_loss", "rmse_loss"])
def test_losses_match_jax(pair, name):
    sr, hr = pair
    got = getattr(losses, name)(torch.from_numpy(sr), torch.from_numpy(hr))
    want = getattr(jlosses, name)(jnp.asarray(sr), jnp.asarray(hr))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_charbonnier_takes_eps_inside_the_root():
    z = torch.zeros(4)
    np.testing.assert_allclose(float(losses.charbonnier_loss(z, z, eps=1e-4)), 1e-2, rtol=1e-6)


@pytest.mark.parametrize("name,rtol", [("psnr", 1e-6), ("psnr_y", 1e-6), ("ssim", 1e-5),
                                       ("ssim_y", 1e-5)])
@pytest.mark.parametrize("frames", [False, True])
def test_metrics_match_jax(pair, name, rtol, frames):
    sr, hr = pair
    if frames:  # (B*T, H, W, C) frames as well as clips
        sr, hr = sr.reshape(-1, *sr.shape[2:]), hr.reshape(-1, *hr.shape[2:])
    got = getattr(metrics, name)(torch.from_numpy(sr), torch.from_numpy(hr))
    want = getattr(jmetrics, name)(jnp.asarray(sr), jnp.asarray(hr))
    np.testing.assert_allclose(float(got), float(want), rtol=rtol)


def test_rgb_to_y_matches_jax(pair):
    got = metrics.rgb_to_y(torch.from_numpy(pair[1])).numpy()
    np.testing.assert_allclose(got, np.asarray(jmetrics.rgb_to_y(jnp.asarray(pair[1]))),
                               rtol=1e-6)


def test_metric_collection_matches_jax(pair):
    sr, hr = pair
    names = ["PSNR", "SSIM", "PSNR_Y", "SSIM_Y"]
    got = metrics.MetricCollection(names, prefix="val_")(torch.from_numpy(sr),
                                                         torch.from_numpy(hr))
    want = jmetrics.MetricCollection(names, prefix="val_")(jnp.asarray(sr), jnp.asarray(hr))
    assert list(got) == list(want) == [f"val_{n}" for n in names]
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)
    acc = metrics.running_metrics({k: 1.0 for k in got}, metrics.MetricCollection(
        names, prefix="val_"), torch.from_numpy(sr), torch.from_numpy(hr))
    assert acc == {k: 1.0 + float(v) for k, v in got.items()}


def test_resolve_metric_names_validates_as_jax():
    assert metrics.resolve_metric_names("PSNR") == jmetrics.resolve_metric_names("PSNR")
    assert metrics.resolve_metric_names(["SSIM_Y"]) == ("SSIM_Y",)
    with pytest.raises(ValueError, match="unknown metric"):
        metrics.resolve_metric_names(["PSNR", "LPIPS"])
    with pytest.raises(ValueError, match="unknown metric"):
        metrics.MetricCollection(["P"])


STEPS = [0, 1, 7, 49, 50, 51, 99, 100, 149, 250, 999]
SCHEDULES = {
    "cosine": dict(base_lr=1e-3, t_max=100, eta_min=1e-6),
    "warmup": dict(max_lr=1e-3, first_cycle_steps=100, min_lr=1e-5, warmup_steps=10),
    "warmup_mult_gamma": dict(max_lr=2e-3, first_cycle_steps=50, min_lr_pow=2, cycle_mult=2.0,
                              warmup_steps=5, gamma=0.5),
    "no_warmup_gamma": dict(max_lr=1e-3, first_cycle_steps=40, min_lr=0.0, gamma=0.8),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_jax(name):
    kw = SCHEDULES[name]
    if name == "cosine":
        got, want = schedulers.cosine_annealing(**kw), jsched.cosine_annealing(**kw)
    else:
        got = schedulers.cosine_annealing_linear_warmup(**kw)
        want = jsched.cosine_annealing_linear_warmup(**kw)
    peak = kw.get("base_lr", kw.get("max_lr"))
    for step in STEPS:
        assert isinstance(got(step), float)
        np.testing.assert_allclose(got(step), float(want(step)), rtol=0, atol=1e-6 * peak,
                                   err_msg=f"step {step}")


def test_warmup_schedule_refuses_bad_arguments():
    with pytest.raises(ValueError):
        schedulers.cosine_annealing_linear_warmup(1e-3, 10, min_lr=0.0, warmup_steps=10)
    with pytest.raises(ValueError):
        schedulers.cosine_annealing_linear_warmup(1e-3, 10)
