"""The port's trainer end to end on the CPU (``run`` and the CLI on the
synthetic experiment): checkpoints and JSONL logs, restore / restore_opt /
finetune / restore_ema, and the step-granular resume, which reproduces an
uninterrupted run's parameters bit for bit (the batch stream is a pure
function of seed and epoch, and the CPU's arithmetic repeats itself)."""

import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from vsrlab_tpu_torch.core.checkpoint import CheckpointManager  # noqa: E402
from vsrlab_tpu_torch.core.config import Config, load_config  # noqa: E402
from vsrlab_tpu_torch.models import RealBasicVSR  # noqa: E402
from vsrlab_tpu_torch.train import train as trainer  # noqa: E402
from vsrlab_tpu_torch.train.builders import build_tx  # noqa: E402
from vsrlab_tpu_torch.train.state import create_train_state  # noqa: E402


def _overrides(tmp_path, *more):
    return ["+experiment=synthetic", f"core.storage_dir={tmp_path}",
            f"train.logger.save_dir={tmp_path}/logs", "train.data.num_workers=1", *more]


def _rows(tmp_path):
    files = list(Path(tmp_path).glob("logs/**/metrics.jsonl"))
    assert files
    return [json.loads(line) for f in files for line in f.read_text().splitlines()]


def _params(ckpt_dir, key=None):
    return CheckpointManager(str(ckpt_dir)).restore(key)[1]["params"]


def test_run_writes_checkpoints_and_logs_then_resumes(tmp_path, capsys):
    cfg = load_config(overrides=_overrides(tmp_path))
    final = trainer.run(cfg, device="cpu")
    assert {"Loss", "PSNR", "SSIM"} <= set(final)
    assert all(v == v and abs(v) < 1e6 for v in final.values())
    ckpt_dir = Path(cfg.train.checkpoint_dir)
    mgr = CheckpointManager(str(ckpt_dir))
    assert mgr.latest_epoch() == cfg.train.max_epochs - 1
    saved = _params(ckpt_dir)
    rows = _rows(tmp_path)
    assert any("Loss/Train" in r for r in rows) and any("Loss/Val" in r for r in rows)
    assert (ckpt_dir / "config.json").exists()

    # restore_opt continues at epoch + 1 from exactly the saved weights: one more epoch
    cfg2 = load_config(overrides=_overrides(tmp_path, f"train.restore={ckpt_dir}",
                                            "train.restore_opt=true",
                                            f"train.max_epochs={cfg.train.max_epochs + 1}",
                                            "train.checkpoint_dir=" + str(tmp_path / "b")))
    model = trainer.build_model(cfg2.train.model, "bf16")
    state = create_train_state(model, build_tx(model.parameters(), cfg2.train.optimizer))
    state, epoch, batch = trainer.restore_state(state, cfg2.train, CheckpointManager(
        str(tmp_path / "b")), str(tmp_path / "b"), steps_per_epoch=4)
    assert (epoch, batch, state.step, state.tx.count) == (2, 0, 8, 8)
    assert all(torch.equal(v, saved[k]) for k, v in model.state_dict().items())
    trainer.run(cfg2, device="cpu")
    assert CheckpointManager(str(tmp_path / "b")).all_keys() == [cfg.train.max_epochs]
    assert "resuming from epoch 2, batch 0" in capsys.readouterr().out


def test_step_granular_resume_matches_uninterrupted(tmp_path):
    base = _overrides(tmp_path, "train.max_epochs=1", "train.save_every_steps=2")
    cfg_a = load_config(overrides=base + [f"train.checkpoint_dir={tmp_path}/a"])
    trainer.run(cfg_a, device="cpu")
    mgr = CheckpointManager(f"{tmp_path}/a")
    assert mgr.all_keys() == [2, 4]
    assert mgr.load_meta(2) == {"epoch": 0, "batch_in_epoch": 2, "steps_per_epoch": 4}
    cfg_b = load_config(overrides=base + [f"train.checkpoint_dir={tmp_path}/b",
                                          f"train.restore={tmp_path}/a", "train.restore_step=2",
                                          "train.restore_opt=true"])
    trainer.run(cfg_b, device="cpu")
    a, b = _params(f"{tmp_path}/a", 4), _params(f"{tmp_path}/b", 4)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert CheckpointManager(f"{tmp_path}/b").load_meta(4)["batch_in_epoch"] == 4


def _saved(tmp_path, epoch=5, ema=False):
    model = RealBasicVSR(8, 1, 1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    tx = build_tx(model.parameters(), ("adam", {"lr": 1e-3}))
    state = create_train_state(model, tx, ema_decay=0.9 if ema else 0.0)
    CheckpointManager(str(tmp_path / "src")).save(epoch, model.state_dict(), tx.state_dict())
    if ema:
        state.ema = {k: v + 2.0 for k, v in state.ema.items()}
        CheckpointManager(str(tmp_path / "src" / "ema")).save(epoch, state.ema)
    return model.state_dict(), state


def _fresh(ema=0.0):
    model = RealBasicVSR(8, 1, 1)
    return create_train_state(model, build_tx(model.parameters(), ("adam", {"lr": 1e-3})),
                              ema_decay=ema)


@pytest.mark.parametrize("flags,epoch,step", [({}, 6, 0), ({"restore_opt": True}, 6, 12),
                                              ({"restore_opt": True, "finetune": True}, 0, 12)])
def test_restore_semantics(tmp_path, flags, epoch, step):
    """Any restore loads the weights and resumes at epoch + 1; restore_opt
    also the step; finetune resets the epoch to 0."""
    saved, _ = _saved(tmp_path)
    ckpt = CheckpointManager(str(tmp_path / "dst"))
    tcfg = Config.from_dict({"restore": str(tmp_path / "src"), **flags})
    state, start, batch = trainer.restore_state(_fresh(), tcfg, ckpt, str(tmp_path / "dst"),
                                                steps_per_epoch=2)
    assert (start, batch, state.step) == (epoch, 0, step)
    assert all(torch.equal(v, saved[k]) for k, v in state.model.state_dict().items())


def test_mid_epoch_resume_rejects_a_changed_stream(tmp_path):
    model = RealBasicVSR(8, 1, 1)
    tx = build_tx(model.parameters(), ("adam", {"lr": 1e-3}))
    CheckpointManager(str(tmp_path / "src")).save(
        2, model.state_dict(), tx.state_dict(),
        meta={"epoch": 0, "batch_in_epoch": 2, "steps_per_epoch": 4})
    ckpt = CheckpointManager(str(tmp_path / "dst"))
    tcfg = Config.from_dict({"restore": str(tmp_path / "src")})
    with pytest.raises(ValueError, match="steps/epoch"):
        trainer.restore_state(_fresh(), tcfg, ckpt, str(tmp_path / "dst"), steps_per_epoch=8)
    _, e, b = trainer.restore_state(_fresh(), tcfg, ckpt, str(tmp_path / "dst"),
                                    steps_per_epoch=4)
    assert (e, b) == (0, 2)


def test_restore_ema_and_the_ema_sidecar(tmp_path):
    """restore_ema starts from the source run's average; an EMA run
    restores its shadow, or seeds it from the weights where the source kept
    none."""
    saved, src = _saved(tmp_path, ema=True)
    ckpt = CheckpointManager(str(tmp_path / "dst"))
    tcfg = Config.from_dict({"restore": str(tmp_path / "src"), "restore_ema": True})
    state, *_ = trainer.restore_state(_fresh(0.5), tcfg, ckpt, str(tmp_path / "dst"))
    weights = state.model.state_dict()
    assert all(torch.equal(weights[k], v) for k, v in src.ema.items())
    assert all(torch.equal(state.ema[k], v) for k, v in src.ema.items())
    (tmp_path / "plain").mkdir()
    CheckpointManager(str(tmp_path / "plain")).save(1, saved)
    tcfg = Config.from_dict({"restore": str(tmp_path / "plain")})
    state, *_ = trainer.restore_state(_fresh(0.5), tcfg, ckpt, str(tmp_path / "dst"))
    assert all(torch.equal(state.ema[k], saved[k]) for k in state.ema)


def test_ema_run_saves_its_shadow_beside_the_weights(tmp_path):
    cfg = load_config(overrides=_overrides(tmp_path, "train.max_epochs=1", "train.ema_decay=0.9"))
    trainer.run(cfg, device="cpu")
    ema = CheckpointManager(str(Path(cfg.train.checkpoint_dir) / "ema"))
    assert ema.all_keys() == [0]
    weights = _params(cfg.train.checkpoint_dir)
    shadow = ema.restore(0)[1]["params"]
    assert shadow.keys() == weights.keys()
    assert any(not torch.equal(shadow[k], weights[k]) for k in weights)


def test_cli_runs_on_the_cpu_and_refuses_a_missing_card(tmp_path, monkeypatch):
    trainer.main(_overrides(tmp_path, "train.max_epochs=1", "device=cpu"))
    assert any("Loss/Val" in r for r in _rows(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.main(_overrides(tmp_path, "train.max_epochs=1"))
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.run(load_config(overrides=_overrides(tmp_path)), device="cuda")
