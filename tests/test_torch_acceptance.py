"""The port's acceptance command (``vsrlab_tpu_torch.evaluation.acceptance``)
against ``scripts/acceptance.py`` on the CPU.

Both run on one synthetic reference-layout RealBasicVSR checkpoint
(mid 8, its weights tempered so that the forward stays in range) and a
dataset of one paired clip and one HR-only clip whose 34x37 frames are
not divisible by the scale (both crop them and derive the LR). In RGB,
with ``--y`` and with ``--stream`` the port's PSNR lies within 1e-3 dB
and its SSIM within 1e-4 of the JAX script's; both give the same exit
codes when the bar is met (0), missed (1), the checkpoint or the data is
missing (2) and no published PSNR is known (2). ``--selftest`` exits 0.
"""

import importlib.util
import json
import os

import cv2
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_checkpoint_import import tempered  # noqa: E402
from test_torch_import import synth_realbasicvsr_sd  # noqa: E402
from vsrlab_tpu_torch.evaluation import acceptance  # noqa: E402

ARGS = ["--model", "realbasicvsr", "--mid-channels", "8", "--res-blocks", "2",
        "--cleaning-blocks", "1", "--window", "2"]
PSNR_TOL, SSIM_TOL = 1e-3, 1e-4


@pytest.fixture(scope="module")
def jax_acceptance():
    spec = importlib.util.spec_from_file_location(
        "jax_acceptance_under_test",
        os.path.join(os.path.dirname(__file__), os.pardir, "scripts", "acceptance.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("acceptance")
    rng = np.random.default_rng(0)
    sd = tempered(synth_realbasicvsr_sd(rng))
    ckpt = root / "ckpt.pth"
    torch.save({"epoch": 3, "model_state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}},
               ckpt)

    def write_frames(d, frames):
        d.mkdir(parents=True)
        for i, f in enumerate(frames):
            assert cv2.imwrite(str(d / f"{i:03d}.png"),
                               (np.clip(f, 0, 1)[..., ::-1] * 255).astype(np.uint8))

    t, scale = 3, 4
    hr_a = rng.random((t, 32, 32, 3)).astype(np.float32)
    write_frames(root / "data" / "clip_a" / "hr", hr_a)
    write_frames(root / "data" / "clip_a" / "lr", hr_a[:, ::scale, ::scale])
    write_frames(root / "data" / "clip_b" / "hr", rng.random((t, 34, 37, 3)))
    return ckpt, root / "data"


def run(main, capsys, argv):
    rc = main(argv)
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    return rc, json.loads(lines[-1])


def both(jax_acceptance, capsys, argv):
    """``(rc, json)`` of the JAX script and of the port on ``argv``."""
    return (run(jax_acceptance.main, capsys, argv),
            run(acceptance.main, capsys, argv + ["--device", "cpu"]))


MODES = {"rgb": [], "y": ["--y"], "stream": ["--stream"]}


@pytest.fixture(scope="module")
def measured(jax_acceptance, assets):
    """Each mode's ``((rc, json) of the JAX script, (rc, json) of the port)``
    at an unreachable published PSNR, run once for the module."""
    ckpt, data = assets
    argv = ARGS + ["--checkpoint", str(ckpt), "--data", str(data), "--published-psnr", "99.0"]
    runs = {}

    def get(mode, capsys):
        if mode not in runs:
            runs[mode] = both(jax_acceptance, capsys, argv + MODES[mode])
        return runs[mode]

    return get


@pytest.mark.parametrize("mode", sorted(MODES))
def test_metrics_match_jax(measured, capsys, mode):
    (rc_j, want), (rc, got) = measured(mode, capsys)
    assert rc == rc_j == 1 and got["pass"] is want["pass"] is False
    assert got["clips"] == want["clips"] == 2
    for key in ("metric_channel", "mode", "bar_db", "published_psnr", "model"):
        assert got[key] == want[key], key
    assert abs(got["psnr"] - want["psnr"]) <= PSNR_TOL, (got, want)
    assert abs(got["ssim"] - want["ssim"]) <= SSIM_TOL, (got, want)
    assert 5.0 < got["psnr"] < 40.0  # a measurement, not a clipped-out image


def test_exit_codes_match_jax(jax_acceptance, assets, measured, capsys):
    ckpt, data = assets
    base = ARGS + ["--checkpoint", str(ckpt), "--data", str(data)]
    (_, jax_rgb), _ = measured("rgb", capsys)
    # bar met: the published value is the JAX script's own measurement
    (rc_j, want), (rc, got) = both(jax_acceptance, capsys,
                                   base + ["--published-psnr", str(jax_rgb["psnr"])])
    assert rc == rc_j == 0 and got["pass"] is want["pass"] is True
    assert abs(got["delta_db"]) <= got["bar_db"]
    # no published PSNR for RealBasicVSR: measured, but blocked on the target
    (rc_j, want), (rc, got) = both(jax_acceptance, capsys, base)
    assert rc == rc_j == 2 and got["pass"] is None and want["pass"] is None
    assert "published" in got["note"]
    # a missing checkpoint or dataset
    for argv, what in ((["--checkpoint", "/no/such.pth", "--data", str(data)], "checkpoint"),
                       (["--checkpoint", str(ckpt), "--data", "/no/such/dir"], "clip folders")):
        (rc_j, want), (rc, got) = both(jax_acceptance, capsys, ARGS + argv)
        assert rc == rc_j == 2 and what in got["blocked"] and got == want


def test_cuda_by_default_raises_without_a_card(assets):
    ckpt, data = assets
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        acceptance.main(ARGS + ["--checkpoint", str(ckpt), "--data", str(data)])


def test_fp32_run_turns_tf32_off_and_restores_it(assets, capsys, monkeypatch):
    """The fp32 run computes with TF32 off and leaves the settings as it
    found them; a ``--bf16`` run does not touch them."""
    from vsrlab_tpu_torch.evaluation import harness

    ckpt, data = assets
    seen, windowed = [], harness.windowed_inference

    def spy(*a, **kw):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return windowed(*a, **kw)

    monkeypatch.setattr(harness, "windowed_inference", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    argv = ARGS + ["--checkpoint", str(ckpt), "--data", str(data), "--device", "cpu",
                   "--published-psnr", "0"]
    run(acceptance.main, capsys, argv)
    assert seen == [(False, False)] * 2
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    run(acceptance.main, capsys, argv + ["--bf16"])
    assert seen[2:] == [(True, True)] * 2


def test_selftest_exits_0(capsys):
    rc, out = run(acceptance.main, capsys, ["--selftest", "--device", "cpu"])
    assert rc == 0 and out["selftest"] is True
    for key in ("realbasicvsr_windowed_psnr", "realbasicvsr_streamed_psnr",
                "tinyvrt_chunked_align_windowed_psnr"):
        assert np.isfinite(out[key]), (key, out)
