"""The port's progressive SpyNet trainer against vsrlab_tpu on the CPU,
fp32.

Two train steps of ``make_level_step`` at level 0 and at level 2 of a
3-level pyramid in each package, from the same parameters (numpy draws
over the JAX shapes; the frozen levels drawn too, the levels above padded
with zeros as the JAX trainer pads them), on one seeded batch, SGD with
momentum under a cosine schedule and a clip of 1.0: after each step the
loss (rtol 1e-5) and every parameter of the level's head (atol 2e-5: the
JAX head sums its 7x7 convs in space-to-depth form, another order), then
an eval step's loss and prediction (within 1e-4 of its largest value:
flows of up to 20 px through three levels of 7x7 heads). SGD, whose update is
linear in the gradient, and not the trainer's Adam: Adam's first steps
divide each gradient element by its own magnitude, so an element within
rounding of 0 moves by up to the learning rate either way (one element of
100,352 moved 2.3e-5 apart at lr 1e-4). Adam runs in ``train.spynet.run``
below. Then ``train.spynet.run`` on
``+experiment=synthetic_spynet`` with checkpoints, a resume from
``start_k``, a cleaner, and the CLI refusing a missing card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import vsrlab_tpu.components  # noqa: E402,F401
from vsrlab_tpu.models.flow import SpyNetProgressive as JSpyNetProgressive  # noqa: E402
from vsrlab_tpu.models.spynet import SpyNetBasicModule as JSpyNetBasicModule  # noqa: E402
from vsrlab_tpu.train import builders as jbuilders  # noqa: E402
from vsrlab_tpu.train.spynet import make_level_step as j_make_level_step  # noqa: E402
from vsrlab_tpu_torch import convert  # noqa: E402
from vsrlab_tpu_torch.core.checkpoint import CheckpointManager  # noqa: E402
from vsrlab_tpu_torch.core.config import load_config  # noqa: E402
from vsrlab_tpu_torch.models.flow import GConf, SpyNetProgressive  # noqa: E402
from vsrlab_tpu_torch.models.spynet import SpyNetBasicModule  # noqa: E402
from vsrlab_tpu_torch.nn.blocks import IterativeRefinement, init_weights  # noqa: E402
from vsrlab_tpu_torch.ops import bilinear_sample as bs  # noqa: E402
from vsrlab_tpu_torch.train import spynet  # noqa: E402
from vsrlab_tpu_torch.train.builders import build_tx  # noqa: E402

K = 3
OPT = {"_target_": "sgd", "lr": 1e-2, "momentum": 0.9}
SCHED = {"_target_": "cosine", "T_max": 4, "eta_min": 1e-6}
CLIP = 1.0


def _unit_params(rng, h, w):
    shapes = jax.eval_shape(JSpyNetBasicModule().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, h, w, 8)))["params"]
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.05).astype(np.float32),
                        shapes)


@pytest.mark.parametrize("k", [0, 2])
def test_level_steps_match_jax(rng, k):
    h, w = GConf(k).image_size
    params = _unit_params(rng, h, w)
    prev = {f"unit_{i}": _unit_params(rng, 24, 32) if i < k
            else jax.tree.map(np.zeros_like, params) for i in range(K)}
    batch = {"x1": rng.random((2, h, w, 3)).astype(np.float32),
             "x2": rng.random((2, h, w, 3)).astype(np.float32),
             "flow": rng.standard_normal((2, h, w, 2)).astype(np.float32)}

    tx = jbuilders.build_tx(OPT, SCHED, CLIP)
    jpyr = JSpyNetProgressive(k=K, return_levels=(k - 1,))
    jstep = j_make_level_step(JSpyNetBasicModule(), jpyr, None, k, tx, train=True)
    jeval = j_make_level_step(JSpyNetBasicModule(), jpyr, None, k, tx, train=False)
    jb = {n: jnp.asarray(v) for n, v in batch.items()}
    jp, opt_state, want = params, tx.init(params), []
    for _ in range(2):
        jp, opt_state, metrics = jstep(jp, opt_state, prev, jb)
        want.append((float(metrics["Loss"]), convert.spynet_unit_state_dict(jax.device_get(jp))))
    jm, jpred = jeval(jp, prev, jb)

    unit = SpyNetBasicModule()
    unit.load_state_dict(convert.spynet_unit_state_dict(params))
    pyramid = spynet.frozen_pyramid(load_config(overrides=[f"train.k={K}"]), k,
                                    {f"unit_{i}": convert.spynet_unit_state_dict(prev[f"unit_{i}"])
                                     for i in range(k)}, "cpu")
    step = spynet.make_level_step(unit, pyramid, None, k, build_tx(unit.parameters(), OPT, SCHED,
                                                                     CLIP), train=True)
    eval_step = spynet.make_level_step(unit, pyramid, None, k, None, train=False)
    tb = {n: torch.from_numpy(v) for n, v in batch.items()}
    bs.reset_launch_counts()
    for loss, state in want:
        got = step(tb)
        np.testing.assert_allclose(float(got["Loss"]), loss, rtol=1e-5)
        for name, v in unit.state_dict().items():
            np.testing.assert_allclose(v.numpy(), state[name].numpy(), atol=2e-5, rtol=0,
                                       err_msg=name)
    metrics, pred = eval_step(tb)
    np.testing.assert_allclose(float(metrics["Loss"]), float(jm["Loss"]), rtol=1e-5)
    jpred = np.asarray(jpred)
    np.testing.assert_allclose(pred.numpy(), jpred, atol=1e-4 * np.abs(jpred).max(), rtol=0)
    assert not any(p.requires_grad for p in pyramid.parameters())
    assert bs.bilinear_sample.launches == 0  # CPU: the plain version


def _overrides(tmp_path, *more):
    return [f"core.storage_dir={tmp_path}", f"train.logger.save_dir={tmp_path}/logs",
            f"train.checkpoint_dir={tmp_path}/spynet", "train.data.num_workers=1", "device=cpu",
            *more]


def _equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[n], b[n]) for n in a)


def test_run_trains_every_level_resumes_and_cleans(tmp_path, capsys, monkeypatch):
    cfg = load_config(overrides=["+experiment=synthetic_spynet",
                                 *_overrides(tmp_path, "train.max_epochs=1")])
    trained = spynet.run(cfg, device="cpu")
    out = capsys.readouterr().out
    assert sorted(trained) == ["unit_0", "unit_1", "unit_2"]
    for k in range(3):
        assert f"level {k} epoch 0: train=" in out
        key, payload = CheckpointManager(f"{tmp_path}/spynet/level_{k}").restore()
        assert key == 0 and _equal(payload["params"], trained[f"unit_{k}"])
        assert payload["opt_state"]["count"] == 2  # 8 samples, batch 4
    final = CheckpointManager(f"{tmp_path}/spynet/final").restore()[1]["params"]
    assert all(_equal(final[n], trained[n]) for n in trained)
    # the JSONL log, and the last level's val flows as an image (OpenCV)
    assert list((tmp_path / "logs").rglob("pred_Val_2_0.png"))
    assert '"Loss 2/Val"' in next((tmp_path / "logs").rglob("metrics.jsonl")).read_text()

    # resume at level 2: levels 0 and 1 restored as saved, level 2 trained anew
    resumed = spynet.run(load_config(overrides=["+experiment=synthetic_spynet", *_overrides(
        tmp_path, "train.max_epochs=1", "train.start_k=2")]), device="cpu")
    assert _equal(resumed["unit_0"], trained["unit_0"])
    assert _equal(resumed["unit_1"], trained["unit_1"])
    assert "=== training pyramid level 0 ===" not in capsys.readouterr().out

    # a cleaner from an IterativeRefinement checkpoint, run without a gradient
    cleaner = init_weights(IterativeRefinement(mid_channels=8, blocks=1),
                           torch.Generator().manual_seed(1))
    CheckpointManager(str(tmp_path / "cleaner")).save(0, cleaner.state_dict())
    cleaned = spynet.run(load_config(overrides=["+experiment=synthetic_spynet", *_overrides(
        tmp_path / "c", "train.max_epochs=1", "train.k=1", f"train.cleaner_ckpt={tmp_path}/cleaner",
        "train.cleaner={mid_channels: 8, blocks: 1}")]), device="cpu")
    assert not _equal(cleaned["unit_0"], trained["unit_0"])

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        spynet.main(["+experiment=synthetic_spynet", *_overrides(tmp_path)[:-1]])


def test_launch_plan_of_a_step_is_one_warp_a_level(monkeypatch):
    """Each warp of a step is one sampler call: ``k - 1`` in the frozen
    pyramid and the level's own, ``max(k, 1)`` at level ``k`` (counted on
    the CPU through the fused route's wrapper)."""
    calls = []
    orig = bs._sample

    def counting(x, ix, iy, zeros):
        calls.append(tuple(x.shape))
        return orig(x, ix, iy, zeros)

    monkeypatch.setattr(bs, "_sample", counting)
    cfg = load_config(overrides=["train.k=4"])
    for k in range(4):
        h, w = GConf(k).image_size
        trained = {f"unit_{i}": SpyNetBasicModule().state_dict() for i in range(k)}
        unit = SpyNetBasicModule()
        step = spynet.make_level_step(unit, spynet.frozen_pyramid(cfg, k, trained, "cpu"), None,
                                      k, build_tx(unit.parameters(), OPT), train=True)
        calls.clear()
        step({"x1": torch.rand(1, h, w, 3), "x2": torch.rand(1, h, w, 3),
              "flow": torch.zeros(1, h, w, 2)})
        assert len(calls) == max(k, 1)
        assert calls[-1] == (1, h, w, 3)
        assert calls[:-1] == [(1, *GConf(i).image_size, 3) for i in range(1, k)]
