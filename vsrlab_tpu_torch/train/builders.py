"""Builders: config -> optimizer with its schedule and step wrapper, model,
loaders (port of ``vsrlab_tpu/train/builders.py``).

The update follows the optax chain the JAX package builds, step for step:
``apply_if_finite(chain(clip_by_global_norm, adam | adamw | sgd))`` with
the learning rate from a schedule indexed by applied updates.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import torch

from vsrlab_tpu_torch.core import schedulers
from vsrlab_tpu_torch.core.config import Config, instantiate
from vsrlab_tpu_torch.data import DataLoader
from vsrlab_tpu_torch.parallel import all_reduce_mean


def build_schedule(spec, base_lr: float) -> Callable[[int], float]:
    """A ``(name, kwargs)`` spec (or its config) -> ``step -> lr``."""
    if spec is None:
        return lambda step: base_lr
    name, kw = spec if isinstance(spec, tuple) else instantiate(spec)
    if name == "cosine":
        return schedulers.cosine_annealing(base_lr, int(kw.get("T_max", 1_000_000)),
                                           float(kw.get("eta_min", 0.0)))
    if name == "cosine_warmup":
        min_lr, min_lr_pow = kw.get("min_lr"), kw.get("min_lr_pow")
        if min_lr is None and min_lr_pow is None:
            min_lr = 0.0  # the schedule takes exactly one of the two
        return schedulers.cosine_annealing_linear_warmup(
            max_lr=base_lr, first_cycle_steps=int(kw.get("first_cycle_steps", 1_000_000)),
            min_lr=min_lr, min_lr_pow=min_lr_pow, cycle_mult=float(kw.get("cycle_mult", 1.0)),
            warmup_steps=int(kw.get("warmup_steps", 0)), gamma=float(kw.get("gamma", 1.0)))
    raise ValueError(f"unknown schedule: {name}")


class Updater:
    """The step wrapper around a torch optimizer, as optax's chain updates:

    * a parameter without a gradient (SpyNet under ``train_flow: false``)
      gets a zero gradient, as optax gives it: adam leaves it where it is,
      adamw still decays it;
    * with a process ``group`` (data parallelism), the gradients are then
      averaged over its ranks, one flat all-reduce, so that the norm, the
      non-finite check, the clip and the update see the global mean
      gradient on every rank, as the XLA program does;
    * ``skip_nonfinite > 0``: an update whose gradients hold inf / NaN is
      skipped (parameters and optimizer state untouched) unless more than
      ``skip_nonfinite`` such updates came in a row (``optax.apply_if_finite``);
      the check reads one flag back from the device;
    * ``grad_clip``: gradients times ``max / ||g||`` where the global norm
      ``||g|| >= max`` (``optax.clip_by_global_norm``), on the device;
    * the learning rate of each applied update is ``schedule(count)``,
      ``count`` the updates applied before it.
    """

    def __init__(self, optimizer: torch.optim.Optimizer, schedule: Callable[[int], float],
                 grad_clip: Optional[float] = None, skip_nonfinite: int = 0, group=None):
        self.optimizer, self.schedule, self.group = optimizer, schedule, group
        self.grad_clip, self.skip_nonfinite = grad_clip, int(skip_nonfinite or 0)
        self.params = [p for g in optimizer.param_groups for p in g["params"]]
        self.count = 0  # applied updates
        self.notfinite_count = 0  # non-finite updates in a row
        self.total_notfinite = 0

    def grads(self) -> list:
        """Every parameter's gradient, zeros where it has none."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    def step(self) -> torch.Tensor:
        """Apply one update from the parameters' gradients; returns their
        global norm before clipping (a 0-d tensor on the device)."""
        grads = all_reduce_mean(self.grads(), self.group)
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.skip_nonfinite:
            finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            self.total_notfinite += not finite
            if not finite and self.notfinite_count <= self.skip_nonfinite:
                return norm
        if self.grad_clip:
            scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                                self.grad_clip / norm)
            torch._foreach_mul_(grads, scale)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.count)
        self.optimizer.step()
        self.count += 1
        return norm

    def state_dict(self) -> dict:
        return {"optimizer": self.optimizer.state_dict(), "count": self.count,
                "notfinite_count": self.notfinite_count, "total_notfinite": self.total_notfinite}

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.count = int(state["count"])
        self.notfinite_count = int(state["notfinite_count"])
        self.total_notfinite = int(state["total_notfinite"])


def build_tx(params: Iterable[torch.nn.Parameter], optimizer_cfg, scheduler_cfg=None,
             grad_clip: Optional[float] = None, skip_nonfinite: int = 0,
             group=None) -> Updater:
    """Optimizer config (+ schedule, clip, non-finite skip, the process
    ``group`` to average gradients over) -> the
    :class:`Updater` over ``params``, which holds the optimizer (``adam``,
    ``adamw`` for adam with weight decay too, ``sgd``) and the schedule.
    The optimizers run their foreach updates (a few launches for all the
    tensors), which bump the parameters' version counters as the fused
    ones do not (``ResidualConv``'s cache reads them)."""
    name, kw = optimizer_cfg if isinstance(optimizer_cfg, tuple) else instantiate(optimizer_cfg)
    lr = float(kw.get("lr", 1e-4))
    schedule = build_schedule(scheduler_cfg, lr)
    betas = tuple(float(b) for b in kw.get("betas", (0.9, 0.999)))
    eps = float(kw.get("eps", 1e-8))
    wd = float(kw.get("weight_decay", 0.0) or 0.0)
    params = list(params)
    if name in ("adam", "adamw"):
        if wd or name == "adamw":
            opt = torch.optim.AdamW(params, lr, betas, eps, weight_decay=wd, foreach=True)
        else:
            opt = torch.optim.Adam(params, lr, betas, eps, foreach=True)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr, momentum=float(kw.get("momentum") or 0.0),
                              foreach=True)
    else:
        raise ValueError(f"unknown optimizer: {name}")
    return Updater(opt, schedule, float(grad_clip) if grad_clip else None, skip_nonfinite,
                   group)


def build_model(model_cfg, precision: str = "fp32") -> torch.nn.Module:
    """The configured model; ``precision: bf16`` gives a bf16 compute type
    over fp32 parameters."""
    dtype = torch.bfloat16 if precision in ("bf16", "bfloat16") else None
    return instantiate(model_cfg, dtype=dtype)


def build_loaders(data_cfg: Config, num_grad_acc: int = 1, device_put: Optional[Callable] = None,
                  num_shards: int = 1, shard_index: int = 0,
                  seed: int = 0) -> Tuple[DataLoader, Optional[DataLoader]]:
    """Train / val loaders; ``seed`` drives the shuffle order. Val drops
    its last partial batch too, as the JAX package does."""
    train_ds = instantiate(data_cfg.datasets.train)
    val_spec = data_cfg.get("datasets", {}).get("val")
    val_ds = instantiate(val_spec) if val_spec else None
    common = dict(num_workers=int(data_cfg.get("num_workers", 4)),
                  prefetch_factor=int(data_cfg.get("prefetch_factor", 2)),
                  num_shards=num_shards, shard_index=shard_index, device_put=device_put,
                  seed=int(seed))
    train_dl = DataLoader(train_ds, batch_size=int(data_cfg.batch_size), shuffle=True, **common)
    val_dl = None
    if val_ds is not None and len(val_ds):
        val_batch = max(num_shards, int(data_cfg.batch_size) // max(num_grad_acc, 1))
        val_dl = DataLoader(val_ds, batch_size=val_batch, shuffle=False, drop_last=True, **common)
    return train_dl, val_dl
