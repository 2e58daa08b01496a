"""Supervised VSR trainer (port of ``vsrlab_tpu/train/train.py``).

    python -m vsrlab_tpu_torch.train.train +experiment=synthetic [device=cpu] [a.b=v ...]
    torchrun --nproc_per_node N -m vsrlab_tpu_torch.train.train +experiment=vrt [...]

The config comes from the repository's ``conf/`` (experiment overlays and
dotted overrides); the run is on the card unless ``device=cpu``. Under
torchrun with ``train.ddp`` (the default) the ranks train data-parallel
(:mod:`vsrlab_tpu_torch.parallel`): each rank on ``cuda:LOCAL_RANK`` (NCCL;
``device=cuda:0`` puts every rank on one card, gloo; ``device=cpu`` gloo),
each on its slice of every global batch, the gradients and metrics
averaged over the ranks, the parameters broadcast from rank 0 after the
init and any restore and checked equal on every rank after each epoch.
Rank 0 alone logs, prints and writes checkpoints; every rank restores.
``ddp: false`` or a world of one runs one process. Per epoch: the train
steps (metrics summed on the device and read back once), eval, JSONL logs,
``torch.save`` checkpoints with the JAX trainer's restore / restore_opt /
finetune / restore_ema semantics and, with ``save_every_steps``,
step-granular checkpoints that resume mid-epoch on the exact next batch.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Dict, Optional

import torch
import torch.distributed as dist

import vsrlab_tpu_torch.components  # noqa: F401  (fills the registry)
from vsrlab_tpu_torch.core.checkpoint import CheckpointManager
from vsrlab_tpu_torch.core.config import Config, load_config
from vsrlab_tpu_torch.core.loggers import build_logger
from vsrlab_tpu_torch.data.loader import to_device
from vsrlab_tpu_torch.evaluation.harness import resolve_device
from vsrlab_tpu_torch.nn.blocks import init_weights
from vsrlab_tpu_torch.parallel import (
    assert_replicated, data_parallel, replicated, stdout_on_rank0)
from vsrlab_tpu_torch.train.builders import build_loaders, build_model, build_tx
from vsrlab_tpu_torch.train.state import TrainState, copy_params, create_train_state
from vsrlab_tpu_torch.train.step import make_eval_step, make_supervised_train_step, metrics_from_config
from vsrlab_tpu_torch.utils.seed import seed_index_everything


def _mean_metrics(sums: Dict[str, torch.Tensor], count: int) -> Dict[str, float]:
    # the one read-back of the device's metric sums a loop makes
    return {k: float(v) / max(count, 1) for k, v in sums.items()}


def _accumulate(sums: Dict[str, torch.Tensor], metrics) -> Dict[str, torch.Tensor]:
    """Add a step's metrics to the sums on the device, reading nothing back."""
    for k, v in metrics.items():
        sums[k] = sums[k] + v if k in sums else v.detach().clone()
    return sums


def _load_ema_params(restore_dir: str, key: int) -> Dict[str, torch.Tensor]:
    """The EMA shadow a run saved under ``<run>/ema`` at key ``key``, or at
    its nearest older key with a warning (a crash between the paired saves).
    Raises FileNotFoundError where the run kept no EMA or only newer keys:
    a later average is never paired with step-``key`` weights."""
    ema_dir = Path(restore_dir) / "ema"
    if not ema_dir.is_dir():
        raise FileNotFoundError(f"no EMA sidecar under {restore_dir}")
    mgr = CheckpointManager(str(ema_dir))
    keys = mgr.all_keys()
    if not keys:
        raise FileNotFoundError(f"empty EMA sidecar under {restore_dir}")
    older = [k for k in keys if k <= key]
    if not older:
        raise FileNotFoundError(f"{ema_dir} only has keys newer than {key} ({keys}): refusing "
                                f"to pair step-{key} weights with a later average")
    if older[-1] != key:
        print(f"WARNING: {ema_dir} has no checkpoint @ key {key} (interrupted between paired "
              f"saves?): using its nearest older key {older[-1]} instead")
    return mgr.restore(epoch=older[-1])[1]["params"]


def _restore_ema(state: TrainState, restore_dir: str, key: int) -> None:
    """Load the source run's EMA shadow; seed it from the restored weights
    where that run kept none."""
    device = next(state.model.parameters()).device
    try:
        state.ema = {k: v.to(device, torch.float32)
                     for k, v in _load_ema_params(restore_dir, key).items()}
    except FileNotFoundError:
        print(f"note: no EMA sidecar under {restore_dir}: seeding the EMA shadow from the "
              "restored weights")
        state.ema = copy_params(state.model)


def restore_state(state: TrainState, tcfg, ckpt: CheckpointManager, ckpt_dir: str,
                  steps_per_epoch: Optional[int] = None):
    """The JAX trainer's restore semantics: any ``restore`` loads the
    weights and resumes at ``epoch + 1``; ``restore_opt`` also loads the
    optimizer state and the step; ``finetune`` resets the epoch to 0;
    ``restore_ema`` starts from the source run's EMA weights. A key with a
    ``meta`` sidecar (``save_every_steps``) resumes inside its epoch,
    skipping the batches already taken. Returns ``(state, start_epoch,
    start_batch)``."""
    start_epoch, start_batch = 0, 0
    if not tcfg.get("restore"):
        return state, start_epoch, start_batch
    src = CheckpointManager(tcfg.restore) if tcfg.restore != ckpt_dir else ckpt
    key, payload = src.restore(epoch=tcfg.get("restore_step"))  # None -> latest
    state.model.load_state_dict(payload["params"])
    if tcfg.get("restore_ema"):
        state.model.load_state_dict(_load_ema_params(tcfg.restore, key), strict=False)
    if state.ema is not None:
        _restore_ema(state, tcfg.restore, key)
    meta = src.load_meta(key)
    if meta is not None:  # a step-keyed checkpoint
        epoch = int(meta["epoch"])
        k, n = int(meta["batch_in_epoch"]), int(meta["steps_per_epoch"])
        if steps_per_epoch is not None and n != steps_per_epoch:
            raise ValueError(
                f"mid-epoch resume needs the same batch stream: checkpoint was saved with {n} "
                f"steps/epoch but the current loaders yield {steps_per_epoch} (batch size or "
                "dataset changed: use finetune instead)")
        start_epoch, start_batch = (epoch + 1, 0) if k >= n else (epoch, k)
    else:  # an epoch-keyed checkpoint
        epoch = key
        start_epoch = epoch + 1
    if tcfg.get("restore_opt"):
        if meta is not None:
            gstep = int(meta["epoch"]) * int(meta["steps_per_epoch"]) + int(meta["batch_in_epoch"])
        elif steps_per_epoch is not None:
            gstep = (epoch + 1) * steps_per_epoch
        else:
            gstep = epoch
        state.tx.load_state_dict(payload["opt_state"])
        state.step = gstep
    if tcfg.get("finetune"):
        start_epoch, start_batch = 0, 0
        print("finetuning mode")
    print(f"restored checkpoint @ key {key} from {tcfg.restore}; resuming from epoch "
          f"{start_epoch}, batch {start_batch}")
    return state, start_epoch, start_batch


def run(cfg: Config, device: str | torch.device = "cuda") -> Dict[str, float]:
    """Train per ``cfg`` on ``device`` (raises where CUDA is asked for and
    absent), data-parallel under torchrun with ``train.ddp``; returns the
    last validation metrics."""
    tcfg = cfg.train
    device, mesh, created = data_parallel(bool(tcfg.get("ddp", True)),
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
    tx = build_tx(model.parameters(), tcfg.optimizer, tcfg.get("scheduler"),
                  tcfg.get("gradient_clip_val"),
                  skip_nonfinite=int(tcfg.get("skip_nonfinite", 0) or 0), group=mesh.group)
    num_grad_acc = int(tcfg.get("num_grad_acc", 1))
    train_dl, val_dl = build_loaders(tcfg.data, num_grad_acc=num_grad_acc,
                                     device_put=to_device(device), num_shards=mesh.size,
                                     shard_index=mesh.data_index,
                                     seed=int(cfg.get("seed_index") or 0))
    ema_decay = float(tcfg.get("ema_decay", 0.0))
    state = create_train_state(model, tx, ema_decay=ema_decay)

    ckpt_dir = tcfg.get("checkpoint_dir", "./checkpoints")
    keep = int(tcfg.get("checkpoint_max_to_keep", 3))
    ckpt = CheckpointManager(ckpt_dir, max_to_keep=keep)
    state, start_epoch, start_batch = restore_state(state, tcfg, ckpt, ckpt_dir,
                                                    steps_per_epoch=len(train_dl))
    if tcfg.get("restore"):
        replicated(model, mesh.group)
        replicated(state.ema or {}, mesh.group)
    logger = build_logger(tcfg.get("logger")) if mesh.rank == 0 else None
    metric_names = metrics_from_config(tcfg)
    train_step = make_supervised_train_step(model, num_grad_accum=num_grad_acc,
                                            ema_decay=ema_decay, metrics=metric_names,
                                            log_grad_norm=bool(tcfg.get("log_grad_norm", False)),
                                            group=mesh.group)
    eval_step = make_eval_step(model, metrics=metric_names, group=mesh.group)
    ema_ckpt = CheckpointManager(str(ckpt.directory / "ema"), max_to_keep=keep) if ema_decay else None
    try:
        return _train_loop(cfg, state, train_dl, val_dl, train_step, eval_step, logger, ckpt,
                           mesh, start_epoch, start_batch, ema_ckpt=ema_ckpt)
    finally:
        if logger:
            logger.close()


def _save(ckpt, ema_ckpt, key, state, cfg, mesh, meta=None):
    """One checkpoint of the weights and the optimizer (and, beside it, the
    EMA), written by rank 0; every rank waits for it."""
    if mesh.rank == 0:
        ckpt.save(key, state.model.state_dict(), state.tx.state_dict(), config=cfg.to_dict(),
                  meta=meta)
        if ema_ckpt is not None:
            ema_ckpt.save(key, state.ema)
    mesh.barrier()


def replica_state(state: TrainState) -> list:
    """What every rank must hold bit for bit: the parameters, the buffers
    and the EMA shadow."""
    model = state.model
    return [*model.parameters(), *model.buffers(), *(state.ema or {}).values()]


def _train_loop(cfg, state, train_dl, val_dl, train_step, eval_step, logger, ckpt, mesh,
                start_epoch, start_batch=0, ema_ckpt=None):
    tcfg = cfg.train
    final_val: Dict[str, float] = {}
    max_epochs = int(tcfg.get("max_epochs", 1))
    eval_every = int(tcfg.get("eval_every", 1))
    # step-granular checkpoints: every key is a global step with a meta
    # sidecar, so that a restore resumes mid-epoch on the exact next batch
    save_every = int(tcfg.get("save_every_steps", 0))
    spe = len(train_dl)
    for epoch in range(start_epoch, max_epochs):
        t0 = time.time()
        train_dl.set_epoch(epoch)
        nb = 0
        if epoch == start_epoch and start_batch:
            train_dl.skip_next(start_batch)
            nb = start_batch
        nb0, sums = nb, {}
        for batch in train_dl:
            state, metrics = train_step(state, batch)
            _accumulate(sums, metrics)
            nb += 1
            if save_every and nb < spe and (epoch * spe + nb) % save_every == 0:
                _save(ckpt, ema_ckpt, epoch * spe + nb, state, cfg, mesh,
                      {"epoch": epoch, "batch_in_epoch": nb, "steps_per_epoch": spe})
        train_metrics = _mean_metrics(sums, nb - nb0)
        if logger:
            logger.log_dict(train_metrics, epoch, "Train")
        print(f"epoch {epoch}: " + " ".join(f"{k}={v:.4f}" for k, v in train_metrics.items())
              + f" ({time.time() - t0:.1f}s, {nb - nb0} steps)")
        if save_every:  # the epoch boundary, in the global-step key space
            _save(ckpt, ema_ckpt, (epoch + 1) * spe, state, cfg, mesh,
                  {"epoch": epoch, "batch_in_epoch": spe, "steps_per_epoch": spe})

        if val_dl is not None and (epoch % eval_every == 0 or epoch == max_epochs - 1):
            vsums, vn, sr = {}, 0, None
            val_dl.set_epoch(epoch)
            # an EMA run validates the averaged weights: they are what ships
            for batch in val_dl:
                vmetrics, sr = eval_step(state.ema, batch)
                _accumulate(vsums, vmetrics)
                vn += 1
            if vn:
                final_val = _mean_metrics(vsums, vn)
                if logger:
                    logger.log_dict(final_val, epoch, "Val")
                    logger.log_images(epoch, "Val", lr=batch["lr"][:1].cpu().numpy(),
                                      sr=sr[:1].clamp(0, 1).float().cpu().numpy(),
                                      hr=batch["hr"][:1].cpu().numpy())
                print("  val: " + " ".join(f"{k}={v:.4f}" for k, v in final_val.items()))
            if not save_every:  # an epoch-keyed checkpoint
                _save(ckpt, ema_ckpt, epoch, state, cfg, mesh)
            if logger:
                logger.save(ckpt.directory)
        assert_replicated(replica_state(state), mesh.group, "parameters")
    return final_val


def main(argv=None):
    cfg = load_config(overrides=list(sys.argv[1:] if argv is None else argv))
    return run(cfg, device=cfg.get("device") or "cuda")


if __name__ == "__main__":
    main()
