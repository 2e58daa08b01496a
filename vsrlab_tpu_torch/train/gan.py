"""GAN fine-tuning: generator and U-Net discriminator (port of
``vsrlab_tpu/train/gan.py``).

    python -m vsrlab_tpu_torch.train.gan +experiment=basic_gan [device=cpu] [a.b=v ...]

One step, in the JAX step's order:

* generator half: ``charbonnier(sr, hr) + charbonnier(lq, resize(hr)) +
  perceptual(sr, hr) + adv_weight * BCE(D(sr), 1)``, the discriminator at
  the step's starting parameters without storing its spectral-norm state;
  the gradient reaches the generator only, whose optimizer and EMA run
  only in an epoch that updates it (``epoch > freeze_epochs``);
* discriminator half: ``BCE(D(hr), 1) + BCE(D(sr), 0)`` on the same
  ``sr``, detached, both passes storing the power-iteration state (the
  second starts from the ``u`` the first stored).

Two optimizers (``optimizer.generator`` / ``.discriminator`` with their
schedules), each clipping its own gradient norm. A checkpoint holds the
generator's parameters and optimizer (and the EMA sidecar), as the JAX
trainer's does: the discriminator is not checkpointed. The run is on the
card unless ``device=cpu``; under torchrun with ``train.ddp`` the ranks
train data-parallel as :mod:`vsrlab_tpu_torch.train.train` does, both
updaters averaging their gradients over the ranks (the spectral-norm
``u`` / ``sigma`` depend only on D's weights, so they stay equal on every
rank, and are checked so after each epoch).
"""

from __future__ import annotations

import sys
import time
from typing import Dict

import torch
import torch.distributed as dist

import vsrlab_tpu_torch.components  # noqa: F401  (fills the registry)
from vsrlab_tpu_torch.core.checkpoint import CheckpointManager
from vsrlab_tpu_torch.core.config import Config, instantiate, load_config
from vsrlab_tpu_torch.core.loggers import build_logger
from vsrlab_tpu_torch.core.losses import adversarial_loss, charbonnier_loss
from vsrlab_tpu_torch.core.metrics import resolve_metric_names
from vsrlab_tpu_torch.core.perceptual import PerceptualLoss
from vsrlab_tpu_torch.data.loader import to_device
from vsrlab_tpu_torch.evaluation.harness import resolve_device
from vsrlab_tpu_torch.nn.blocks import init_weights
from vsrlab_tpu_torch.parallel import (
    assert_replicated, data_parallel, reduce_metrics, replicated, stdout_on_rank0)
from vsrlab_tpu_torch.train.builders import build_loaders, build_model, build_tx
from vsrlab_tpu_torch.train.state import TrainState, create_train_state
from vsrlab_tpu_torch.train.step import (
    DEFAULT_METRICS, _resize_clip_to, default_metrics, ema_update, make_eval_step,
    metrics_from_config)
from vsrlab_tpu_torch.train.train import (
    _accumulate, _load_ema_params, _mean_metrics, _restore_ema, replica_state)
from vsrlab_tpu_torch.utils.seed import seed_index_everything


def _frames(clip: torch.Tensor) -> torch.Tensor:
    return clip.flatten(0, 1)


def make_gan_train_step(model: torch.nn.Module, discriminator: torch.nn.Module,
                        perceptual_loss=None, adv_weight: float = 2e-5,
                        update_generator: bool = True, ema_decay: float = 0.0,
                        metrics=DEFAULT_METRICS, group=None):
    """``step(g_state, d_state, batch) -> (g_state, d_state, metrics)`` for
    ``lr`` / ``hr`` clips ``(B, T, H, W, 3)`` on the models' device; both
    states are updated in place. Without ``update_generator`` the
    generator's half runs without a gradient and the generator, its
    optimizer and its EMA stay as they are. With a process ``group`` the
    metrics are averaged over the ranks (the updaters average the
    gradients)."""
    names = resolve_metric_names(metrics)

    def generator_half(lr, hr):
        sr, lq = model(lr)
        pixel = charbonnier_loss(sr, hr) + charbonnier_loss(lq, _resize_clip_to(hr, lq))
        adv = adversarial_loss(discriminator(_frames(sr)), 1.0, is_disc=False, weight=adv_weight)
        perc = (perceptual_loss(sr, hr) if perceptual_loss is not None
                else torch.zeros((), device=sr.device))
        return pixel + perc + adv, sr, {"PixelLoss": pixel, "PerceptualLoss": perc,
                                        "AdversarialLoss": adv}

    def step(g_state: TrainState, d_state: TrainState, batch):
        lr, hr = batch["lr"], batch["hr"]
        if update_generator:
            g_state.tx.optimizer.zero_grad(set_to_none=True)
            discriminator.requires_grad_(False)  # D takes (and computes) no weight gradient here
            try:
                loss_g, sr, parts = generator_half(lr, hr)
                loss_g.backward()
            finally:
                discriminator.requires_grad_(True)
            g_state.tx.step()
            g_state.step += 1
            ema_update(g_state, ema_decay)
        else:
            with torch.no_grad():
                loss_g, sr, parts = generator_half(lr, hr)

        d_state.tx.optimizer.zero_grad(set_to_none=True)
        logits_hr = discriminator(_frames(hr), update_stats=True)
        logits_sr = discriminator(_frames(sr.detach()), update_stats=True)
        loss_d = (adversarial_loss(logits_hr, 1.0, is_disc=True)
                  + adversarial_loss(logits_sr, 0.0, is_disc=True))
        loss_d.backward()
        d_state.tx.step()
        d_state.step += 1

        out = {"Loss": loss_g.detach(), "LossDiscriminator": loss_d.detach(),
               **{k: v.detach() for k, v in parts.items()}}
        out.update(default_metrics(sr, hr, names))
        return g_state, d_state, reduce_metrics(out, group)

    return step


def restore_generator(g_state: TrainState, tcfg):
    """The JAX trainer's generator restore: ``restore`` loads the weights
    (any optimizer, so a supervised run's checkpoint is a fine-tune init)
    and resumes at ``epoch + 1``; ``restore_opt`` also loads the optimizer
    state (a run of the same optimizer); ``finetune`` resets the epoch to
    0; ``restore_ema`` starts from the source run's EMA weights; an
    EMA-enabled run takes the source's shadow, or seeds it from the
    restored weights. Returns ``(g_state, start_epoch)``."""
    if not tcfg.get("restore"):
        return g_state, 0
    src = CheckpointManager(tcfg.restore)
    key, payload = src.restore(epoch=tcfg.get("restore_step"))
    g_state.model.load_state_dict(payload["params"])
    if tcfg.get("restore_opt"):
        g_state.tx.load_state_dict(payload["opt_state"])
    if tcfg.get("restore_ema"):
        g_state.model.load_state_dict(_load_ema_params(tcfg.restore, key), strict=False)
    if g_state.ema is not None:
        _restore_ema(g_state, tcfg.restore, key)
    meta = src.load_meta(key)  # a step-keyed checkpoint: resume at its epoch's end
    epoch = int(meta["epoch"]) if meta else key
    start_epoch = 0 if tcfg.get("finetune") else epoch + 1
    print(f"restored generator @ key {key} from {tcfg.restore}; resuming from epoch "
          f"{start_epoch}")
    return g_state, start_epoch


def run(cfg: Config, device: str | torch.device = "cuda") -> Dict[str, float]:
    """Fine-tune per ``cfg`` on ``device`` (raises where CUDA is asked for
    and absent), data-parallel under torchrun with ``train.ddp``; returns
    the last validation metrics."""
    device, mesh, created = data_parallel(bool(cfg.train.get("ddp", True)),
                                          resolve_device(device))
    try:
        with stdout_on_rank0(mesh.rank):
            return _run(cfg, device, mesh)
    finally:
        if created:
            dist.destroy_process_group()


def _run(cfg, device, mesh):
    generator = seed_index_everything(cfg)
    tcfg = cfg.train
    model = build_model(tcfg.model, tcfg.get("precision", "fp32"))
    replicated(init_weights(model, generator).to(device).train(), mesh.group)
    discriminator = instantiate(tcfg.discriminator)
    replicated(init_weights(discriminator, generator).to(device).train(), mesh.group)

    skip_nf = int(tcfg.get("skip_nonfinite", 0) or 0)
    schedules = tcfg.get("scheduler") or {}
    tx_g = build_tx(model.parameters(), tcfg.optimizer.generator, schedules.get("generator"),
                    tcfg.get("gradient_clip_val"), skip_nonfinite=skip_nf, group=mesh.group)
    tx_d = build_tx(discriminator.parameters(), tcfg.optimizer.discriminator,
                    schedules.get("discriminator"), tcfg.get("gradient_clip_val"),
                    skip_nonfinite=skip_nf, group=mesh.group)
    # the GAN step takes the whole batch: num_grad_acc only divides the val batch
    train_dl, val_dl = build_loaders(tcfg.data, num_grad_acc=int(tcfg.get("num_grad_acc", 1)),
                                     device_put=to_device(device), num_shards=mesh.size,
                                     shard_index=mesh.data_index,
                                     seed=int(cfg.get("seed_index") or 0))
    ema_decay = float(tcfg.get("ema_decay", 0.0))
    g_state = create_train_state(model, tx_g, ema_decay=ema_decay)
    d_state = create_train_state(discriminator, tx_d)
    g_state, start_epoch = restore_generator(g_state, tcfg)
    if tcfg.get("restore"):
        replicated(model, mesh.group)
        replicated(g_state.ema or {}, mesh.group)

    perceptual = None
    if tcfg.get("perceptual_loss"):
        perceptual = PerceptualLoss(weight=float(tcfg.perceptual_loss.get("weight", 1e-2)))
        perceptual = perceptual.to(device)
    adv_weight = float((tcfg.get("adversarial_loss") or {}).get("weight", 2e-5))
    metric_names = metrics_from_config(tcfg)
    steps = {up: make_gan_train_step(model, discriminator, perceptual, adv_weight, up,
                                     ema_decay=ema_decay, metrics=metric_names,
                                     group=mesh.group)
             for up in (True, False)}
    eval_step = make_eval_step(model, metrics=metric_names, group=mesh.group)

    keep = int(tcfg.get("checkpoint_max_to_keep", 3))
    ckpt = CheckpointManager(tcfg.get("checkpoint_dir", "./checkpoints"), max_to_keep=keep)
    ema_ckpt = (CheckpointManager(str(ckpt.directory / "ema"), max_to_keep=keep) if ema_decay
                else None)
    logger = build_logger(tcfg.get("logger")) if mesh.rank == 0 else None
    try:
        return _gan_loop(cfg, g_state, d_state, train_dl, val_dl, steps, eval_step,
                         int(tcfg.get("freeze_epochs", -1)), logger, ckpt, ema_ckpt, start_epoch,
                         mesh)
    finally:
        if logger:
            logger.close()


def _gan_loop(cfg, g_state, d_state, train_dl, val_dl, steps, eval_step, freeze_epochs, logger,
              ckpt, ema_ckpt, start_epoch, mesh):
    tcfg = cfg.train
    final_val: Dict[str, float] = {}
    for epoch in range(start_epoch, int(tcfg.get("max_epochs", 1))):
        t0 = time.time()
        train_dl.set_epoch(epoch)
        step = steps[epoch > freeze_epochs]
        sums, nb = {}, 0
        for batch in train_dl:
            g_state, d_state, metrics = step(g_state, d_state, batch)
            _accumulate(sums, metrics)
            nb += 1
        train_metrics = _mean_metrics(sums, nb)
        if logger:
            logger.log_dict(train_metrics, epoch, "Train")
        print(f"epoch {epoch}: " + " ".join(f"{k}={v:.4f}" for k, v in train_metrics.items())
              + f" ({time.time() - t0:.1f}s, {nb} steps)")
        if val_dl is not None:
            vsums, vn = {}, 0
            for batch in val_dl:  # an EMA run validates the averaged weights
                vmetrics, _ = eval_step(g_state.ema, batch)
                _accumulate(vsums, vmetrics)
                vn += 1
            if vn:
                final_val = _mean_metrics(vsums, vn)
                if logger:
                    logger.log_dict(final_val, epoch, "Val")
                print("  val: " + " ".join(f"{k}={v:.4f}" for k, v in final_val.items()))
        if mesh.rank == 0:
            ckpt.save(epoch, g_state.model.state_dict(), g_state.tx.state_dict(),
                      config=cfg.to_dict())
            if ema_ckpt is not None:
                ema_ckpt.save(epoch, g_state.ema)
        mesh.barrier()
        # G, its EMA, D and D's spectral-norm state
        assert_replicated(replica_state(g_state) + replica_state(d_state), mesh.group,
                          "generator and discriminator")
    return final_val


def main(argv=None):
    cfg = load_config(overrides=list(sys.argv[1:] if argv is None else argv))
    return run(cfg, device=cfg.get("device") or "cuda")


if __name__ == "__main__":
    main()
