"""Progressive SpyNet curriculum trainer (port of ``vsrlab_tpu/train/spynet.py``).

    python -m vsrlab_tpu_torch.train.spynet +experiment=spynet [device=cpu] [a.b=v ...]

Pyramid levels ``k = start_k .. K-1`` are trained one after another, on
the card unless ``device=cpu``; under torchrun with ``train.ddp`` (off by
default, as in the JAX trainer) the ranks train each level data-parallel
as :mod:`vsrlab_tpu_torch.train.train` does: each on its slice of every
batch, the head's gradients and the losses averaged over the ranks, rank 0
alone logging and writing checkpoints. Level ``k`` sees frame pairs
at ``GConf(k)`` size (``24*2^k x 32*2^k``), degraded by the codec emulator
at CRF ``34 - (K-1-k)*4``; the levels before it form a frozen pyramid run
without a gradient, whose flow is upsampled x2 with its values x2; the
level's head predicts a residual on it from the first frame, the second
warped by it (border padding) and the flow, against the teacher flow by
L1. Adam (or the configured optimizer), the schedule, the clip and the
non-finite skip come through :func:`~vsrlab_tpu_torch.train.builders.build_tx`.
Each level's checkpoints go under ``<checkpoint_dir>/level_{k}`` (the
head's ``state_dict`` each epoch), the combined pyramid under ``final``;
``start_k`` restores the levels before it. An optional cleaner
(``cleaner_ckpt``: an ``IterativeRefinement`` ``state_dict``) cleans both
frames first, without a gradient.

Every warp of a step is one call of the sampler of the pyramid's
``sampler_impl`` (``"fused"``: the hand-written kernel): ``k - 1`` in the
frozen pyramid and the level's own, ``max(k, 1)`` a step.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

import vsrlab_tpu_torch.components  # noqa: F401  (fills the registry)
from vsrlab_tpu_torch.core.checkpoint import CheckpointManager
from vsrlab_tpu_torch.core.config import Config, load_config
from vsrlab_tpu_torch.core.loggers import build_logger
from vsrlab_tpu_torch.core.losses import l1_loss
from vsrlab_tpu_torch.data.flow_dataset import (
    FlowCompose, FlowDataset, FlowRandomHorizontalFlip, FlowRandomRotation,
    FlowRandomVerticalFlip, FlowResize, FlowVideoCompression, SyntheticFlowDataset)
from vsrlab_tpu_torch.data.loader import DataLoader, to_device
from vsrlab_tpu_torch.evaluation.harness import resolve_device
from vsrlab_tpu_torch.models.flow.spynet_progressive import GConf, SpyNetProgressive
from vsrlab_tpu_torch.models.spynet import IMAGENET_MEAN, IMAGENET_STD, SpyNetBasicModule
from vsrlab_tpu_torch.nn.blocks import IterativeRefinement, init_weights
from vsrlab_tpu_torch.ops.resize import resize_bilinear
from vsrlab_tpu_torch.ops.warp import flow_warp
from vsrlab_tpu_torch.parallel import (
    DataMesh, assert_replicated, data_parallel, reduce_metrics, replicated, stdout_on_rank0)
from vsrlab_tpu_torch.train.builders import build_tx
from vsrlab_tpu_torch.train.train import _accumulate, _mean_metrics


def load_level_data(cfg, k: int, levels: int):
    """Level ``k``'s train and val datasets: ``FlowDataset`` (resize,
    rotation, flips for train; resize for val) or ``SyntheticFlowDataset``
    at the GConf size, both compressed at the level's CRF and 12 fps."""
    h, w = GConf(k).image_size
    crf = 34 - (levels - k) * 4
    compression = FlowVideoCompression(crf=(crf, crf), fps=(12, 12))
    dcfg = cfg.train.data.datasets.train
    if dcfg.get("_target_", "FlowDataset") == "SyntheticFlowDataset":
        return tuple(SyntheticFlowDataset(num_samples=dcfg.get("num_samples", 16), height=h,
                                          width=w, split=split, compression=compression)
                     for split in ("train", "val"))
    train_tfms = FlowCompose([FlowResize(h, w), FlowRandomRotation(17, 0.5),
                              FlowRandomHorizontalFlip(0.5), FlowRandomVerticalFlip(0.5)])
    size = dcfg.get("train_size", 0.9)
    return (FlowDataset(dcfg.path, dcfg.frames_root, "train", size, augmentation=train_tfms,
                        compression=compression),
            FlowDataset(dcfg.path, dcfg.frames_root, "val", size,
                        augmentation=FlowCompose([FlowResize(h, w)]), compression=compression))


def level_forward(unit: SpyNetBasicModule, pyramid: SpyNetProgressive,
                  cleaner: Optional[torch.nn.Module], k: int, batch):
    """Level ``k``'s loss and prediction on a batch ``{"x1", "x2", "flow"}``
    of ``(B, h, w, C)`` tensors on the unit's device: ``pred = unit([x1,
    warp(x2, V), V]) + V``, ``V`` the frozen ``pyramid``'s flow of levels
    ``0 .. k-1`` upsampled x2 with its values x2 (zero at level 0), loss
    ``L1(flow, pred)``; the frames ImageNet-normalised, cleaned first by
    ``cleaner`` (without a gradient) where one is given."""
    x1, x2, y = batch["x1"], batch["x2"], batch["flow"]
    mean = torch.tensor(IMAGENET_MEAN, device=x1.device)
    std = torch.tensor(IMAGENET_STD, device=x1.device)
    if cleaner is not None:
        with torch.no_grad():
            x1, x2 = cleaner(torch.cat([x1, x2], 0)).chunk(2)
    x1n, x2n = (x1 - mean) / std, (x2 - mean) / std
    if k > 0:
        with torch.no_grad():
            v = pyramid((x1n, x2n), train=True, limit_k=k)
        v = resize_bilinear(v, x1.shape[1:3], align_corners=True) * 2.0
    else:
        v = torch.zeros_like(y)
    warped = flow_warp(x2n, v, padding_mode="border", impl=pyramid.sampler_impl)
    pred = unit(torch.cat([x1n, warped, v], -1)) + v
    return l1_loss(y, pred), pred


def make_level_step(unit: SpyNetBasicModule, pyramid: SpyNetProgressive,
                    cleaner: Optional[torch.nn.Module], k: int, tx, train: bool, group=None):
    """Level ``k``'s step (:func:`level_forward`). ``train``: ``step(batch)
    -> {"Loss"}``, one update of ``unit`` by ``tx`` (an
    :class:`~vsrlab_tpu_torch.train.builders.Updater` over its parameters);
    else ``eval_step(batch) -> ({"Loss"}, pred)`` without a gradient.
    Metrics stay on the device, averaged over the ranks of ``group``."""
    if train:
        def step(batch):
            tx.optimizer.zero_grad(set_to_none=True)
            loss, _ = level_forward(unit, pyramid, cleaner, k, batch)
            loss.backward()
            tx.step()
            return reduce_metrics({"Loss": loss.detach()}, group)

        return step

    @torch.no_grad()
    def eval_step(batch):
        loss, pred = level_forward(unit, pyramid, cleaner, k, batch)
        return reduce_metrics({"Loss": loss}, group), pred

    return eval_step


class FlowLoader(DataLoader):
    """The threaded loader with ``(f1, f2, flow)`` samples batched into
    ``{"x1", "x2", "flow"}``."""

    def _collate(self, samples) -> dict:
        return {"x1": np.stack([s[0] for s in samples]), "x2": np.stack([s[1] for s in samples]),
                "flow": np.stack([s[2] for s in samples])}


def frozen_pyramid(cfg, k: int, trained_units: Dict[str, dict], device) -> SpyNetProgressive:
    """The pyramid of levels ``0 .. k-1`` from ``trained_units`` (``unit_{i}``
    -> a head's ``state_dict``), frozen, on ``device``; it returns level
    ``k - 1``'s flow."""
    pyramid = SpyNetProgressive(k=int(cfg.train.k), return_levels=(k - 1,))
    for i in range(k):
        pyramid.units[i].load_state_dict(trained_units[f"unit_{i}"])
    return pyramid.to(device).eval().requires_grad_(False)


def _level_dir(cfg, name: str) -> str:
    return str(Path(cfg.train.get("checkpoint_dir", "./checkpoints")) / name)


def train_one_level(cfg, k: int, trained_units: Dict[str, dict], cleaner, logger,
                    device, mesh: DataMesh) -> Dict[str, torch.Tensor]:
    """Train level ``k`` (its head drawn from ``seed_index + k``) over the
    ranks of ``mesh``; returns the head's ``state_dict`` (CPU)."""
    group = mesh.group
    unit = SpyNetBasicModule()
    init_weights(unit, torch.Generator().manual_seed(int(cfg.get("seed_index") or 0) + k))
    replicated(unit.to(device).train(), group)
    pyramid = frozen_pyramid(cfg, k, trained_units, device)
    tx = build_tx(unit.parameters(), cfg.train.optimizer, cfg.train.get("scheduler"),
                  cfg.train.get("gradient_clip_val"),
                  skip_nonfinite=int(cfg.train.get("skip_nonfinite", 0) or 0), group=group)
    train_ds, val_ds = load_level_data(cfg, k, int(cfg.train.k) - 1)
    bs = int(cfg.train.data.batch_size)
    workers = int(cfg.train.data.get("num_workers", 2))
    train_dl, val_dl = (FlowLoader(ds, batch_size=bs, shuffle=shuffle, num_workers=workers,
                                   device_put=to_device(device), num_shards=mesh.size,
                                   shard_index=mesh.rank)
                        for ds, shuffle in ((train_ds, True), (val_ds, False)))
    step = make_level_step(unit, pyramid, cleaner, k, tx, train=True, group=group)
    eval_step = make_level_step(unit, pyramid, cleaner, k, tx, train=False, group=group)
    ckpt = CheckpointManager(_level_dir(cfg, f"level_{k}")) if mesh.rank == 0 else None
    for epoch in range(int(cfg.train.max_epochs)):
        t0 = time.time()
        train_dl.set_epoch(epoch)
        sums, nb = {}, 0
        for batch in train_dl:
            _accumulate(sums, step(batch))
            nb += 1
        tr = _mean_metrics(sums, nb)
        vsums, vn, pred = {}, 0, None
        for batch in val_dl:
            vmetrics, pred = eval_step(batch)
            _accumulate(vsums, vmetrics)
            vn += 1
        vl = _mean_metrics(vsums, vn)
        if logger:
            logger.log_dict({f"Loss {k}": tr.get("Loss", 0.0)}, epoch, "Train")
            logger.log_dict({f"Loss {k}": vl.get("Loss", 0.0)}, epoch, "Val")
            if pred is not None:  # the val split can be empty (drop_last)
                logger.log_flow(epoch, f"Val_{k}", pred=pred[:4].float().cpu().numpy())
        print(f"level {k} epoch {epoch}: train={tr.get('Loss', 0):.4f} "
              f"val={vl.get('Loss', 0):.4f} ({time.time() - t0:.1f}s, {nb} steps)")
        if ckpt is not None:
            ckpt.save(epoch, unit.state_dict(), tx.state_dict())
        mesh.barrier()
        assert_replicated(unit, group, f"level {k} head")
    return {n: t.detach().cpu().clone() for n, t in unit.state_dict().items()}


def build_cleaner(cfg, device) -> Optional[IterativeRefinement]:
    """The frozen cleaner of ``cleaner_ckpt`` (the latest key of that
    checkpoint directory), sized by ``train.cleaner``; None without one."""
    if not cfg.train.get("cleaner_ckpt"):
        return None
    ccfg = cfg.train.get("cleaner") or {}
    cleaner = IterativeRefinement(mid_channels=int(ccfg.get("mid_channels", 64)),
                                  blocks=int(ccfg.get("blocks", 20)))
    _, payload = CheckpointManager(cfg.train.cleaner_ckpt).restore()
    cleaner.load_state_dict(payload["params"])
    return cleaner.to(device).eval().requires_grad_(False)


def run(cfg: Config, device: str | torch.device = "cuda") -> Dict[str, dict]:
    """The curriculum per ``cfg`` on ``device`` (raises where CUDA is asked
    for and absent), data-parallel under torchrun with ``train.ddp``;
    returns ``{"unit_{k}": state_dict}`` of every level."""
    device, mesh, created = data_parallel(bool(cfg.train.get("ddp", False)),
                                          resolve_device(device))
    try:
        with stdout_on_rank0(mesh.rank):
            return _run(cfg, device, mesh)
    finally:
        if created:
            dist.destroy_process_group()


def _run(cfg, device, mesh):
    logger = build_logger(cfg.train.get("logger")) if mesh.rank == 0 else None
    cleaner = build_cleaner(cfg, device)
    trained: Dict[str, dict] = {}
    start_k = int(cfg.train.get("start_k", 0))
    for i in range(start_k):  # resume: the levels already trained, on every rank
        trained[f"unit_{i}"] = CheckpointManager(_level_dir(cfg, f"level_{i}")).restore()[1][
            "params"]
    try:
        for k in range(start_k, int(cfg.train.k)):
            print(f"=== training pyramid level {k} ===")
            trained[f"unit_{k}"] = train_one_level(cfg, k, trained, cleaner, logger, device,
                                                   mesh)
        if mesh.rank == 0:
            CheckpointManager(_level_dir(cfg, "final")).save(0, trained, config=cfg.to_dict())
        mesh.barrier()
    finally:
        if logger:
            logger.close()
    return trained


def main(argv=None):
    cfg = load_config(overrides=list(sys.argv[1:] if argv is None else argv))
    return run(cfg, device=cfg.get("device") or "cuda")


if __name__ == "__main__":
    main()
