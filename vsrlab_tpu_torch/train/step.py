"""Supervised train and eval steps (port of ``vsrlab_tpu/train/step.py``).

One step: forward (with the cleaning branch), the Charbonnier loss,
backward, gradient accumulation over ``num_grad_accum`` microbatches (the
gradients summed, then divided, as the JAX step scans them), the update
(:class:`~vsrlab_tpu_torch.train.builders.Updater`), the EMA. Metrics are
0-d tensors on the device: a loop sums them and reads them back once an
epoch. While a profiler collects, the step is the span ``step`` with the
children ``step.forward``, ``step.backward`` and ``step.metrics`` (each
microbatch), ``step.grad_reduce``, ``step.update`` and ``step.ema``
(:func:`vsrlab_tpu_torch.utils.profiler.annotate`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch.func import functional_call

from vsrlab_tpu_torch.core.losses import charbonnier_loss
from vsrlab_tpu_torch.core.metrics import MetricCollection, resolve_metric_names
from vsrlab_tpu_torch.ops.resize import resize_bilinear
from vsrlab_tpu_torch.parallel import all_reduce_sharded_grads, check_step_group, reduce_metrics
from vsrlab_tpu_torch.train.state import TrainState
from vsrlab_tpu_torch.utils.profiler import annotate

Batch = Dict[str, torch.Tensor]
DEFAULT_METRICS = ("PSNR", "SSIM")


def metrics_from_config(tcfg) -> Tuple[str, ...]:
    """The metric names of a ``train`` config section (``metric.metrics``)."""
    return resolve_metric_names((tcfg.get("metric") or {}).get("metrics") or DEFAULT_METRICS)


def _resize_clip_to(hr: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Bilinear resize of HR clips ``(B, T, H, W, C)`` to the LR grid of
    ``like``, for the cleaning loss."""
    b, t, h, w, c = hr.shape
    th, tw = like.shape[2:4]
    out = resize_bilinear(hr.reshape(b * t, h, w, c), (th, tw), align_corners=False)
    return out.reshape(b, t, th, tw, c)


def default_metrics(sr, hr, names=DEFAULT_METRICS) -> Dict[str, torch.Tensor]:
    """Built-in metrics by name on clamped ``sr`` and ``hr``."""
    sr, hr = sr.detach().clamp(0.0, 1.0), hr.clamp(0.0, 1.0)
    return {k: MetricCollection.BUILTIN[k](sr, hr) for k in names}


def supervised_loss(model_out, batch: Batch,
                    loss_fn: Callable = charbonnier_loss) -> Tuple[torch.Tensor, Dict]:
    """``loss(sr, hr) + loss(lq, resize(hr))`` where the model returns a
    cleaned branch ``(sr, lq)``."""
    sr, lq = model_out if isinstance(model_out, tuple) else (model_out, None)
    hr = batch["hr"]
    loss = loss_fn(sr, hr)
    if lq is not None:
        loss = loss + loss_fn(lq, _resize_clip_to(hr, lq))
    return loss, {"sr": sr}


@torch.no_grad()
def ema_update(state: TrainState, decay: float) -> TrainState:
    """``ema <- decay * ema + (1 - decay) * params`` (no-op when disabled)."""
    if decay and state.ema is not None:
        ema = list(state.ema.values())
        params = [p.detach().float() for p in state.model.parameters()]
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, torch._foreach_mul(params, 1.0 - decay))
    return state


def make_supervised_train_step(model: torch.nn.Module, loss_fn: Callable = charbonnier_loss,
                               num_grad_accum: int = 1, compute_metrics: bool = True,
                               ema_decay: float = 0.0, metrics=DEFAULT_METRICS,
                               log_grad_norm: bool = False, group=None):
    """``train_step(state, batch) -> (state, metrics)`` for ``lr`` / ``hr``
    clips ``(B, T, H, W, 3)`` on the model's device; ``B`` divides by
    ``num_grad_accum``. ``log_grad_norm`` adds the global gradient norm
    after accumulation and before clipping as ``GradNorm``. With a process
    ``group`` the batch is this rank's slice and the metrics are averaged
    over the ranks (the state's updater averages the gradients). Inside
    ``parallel.use_mesh`` of a mesh whose ``time`` axis splits the frames
    (``shard_batch_sp``) both groups must hold the whole mesh
    (``mesh.mesh_group``); where its ``model`` axis splits a VRT's heads,
    the whole mesh or the data axis's group (``parallel.check_step_group``
    raises otherwise). After the last microbatch's backward,
    ``parallel.all_reduce_sharded_grads`` makes the head-sharded gradients
    whole on each model line, so that the update is one process's. The
    state is updated in place and returned."""
    metrics = resolve_metric_names(metrics)

    def train_step(state: TrainState, batch: Batch):
        check_step_group(group, state.tx.group)
        lr, hr = batch["lr"], batch["hr"]
        n = num_grad_accum
        if lr.shape[0] % n:
            raise ValueError(f"batch {lr.shape[0]} does not split into {n} microbatches")
        with annotate("step"):
            state.tx.optimizer.zero_grad(set_to_none=True)
            loss_sum = torch.zeros((), device=lr.device)
            msums = ({k: torch.zeros((), device=lr.device) for k in metrics}
                     if compute_metrics else {})
            for lr_i, hr_i in zip(lr.chunk(n), hr.chunk(n)):
                with annotate("step.forward"):
                    loss, aux = supervised_loss(model(lr_i), {"hr": hr_i}, loss_fn)
                with annotate("step.backward"):
                    loss.backward()
                loss_sum += loss.detach()
                if compute_metrics:
                    with annotate("step.metrics"):
                        for k, v in default_metrics(aux["sr"], hr_i, metrics).items():
                            msums[k] += v
                del aux
            with annotate("step.grad_reduce"):
                # the head-sharded attention's parts summed over each model line,
                # the rest averaged there: whole before the updater's mean over
                # ``group``
                all_reduce_sharded_grads(model)
                if n > 1:
                    torch._foreach_div_(state.tx.grads(), float(n))
            with annotate("step.update"):
                norm = state.tx.step()
            state.step += 1
            with annotate("step.ema"):
                ema_update(state, ema_decay)
            out = {"Loss": loss_sum / n}
            if log_grad_norm:
                out["GradNorm"] = norm
            out.update({k: v / n for k, v in msums.items()})
            return state, reduce_metrics(out, group)

    return train_step


def make_eval_step(model: torch.nn.Module, loss_fn: Callable = charbonnier_loss,
                   metrics=DEFAULT_METRICS, group=None):
    """``eval_step(params, batch) -> (metrics, sr)``: forward, loss and the
    metrics without a gradient, averaged over the ranks of ``group``;
    ``params`` (name -> tensor, such as the EMA shadow) stand in for the
    model's own, ``None`` keeps them."""
    names = resolve_metric_names(metrics)

    @torch.no_grad()
    def eval_step(params: Optional[Dict[str, torch.Tensor]], batch: Batch):
        lr = batch["lr"]
        out = model(lr) if params is None else functional_call(model, params, (lr,))
        loss, aux = supervised_loss(out, batch, loss_fn)
        metrics = {"Loss": loss, **default_metrics(aux["sr"], batch["hr"], names)}
        return reduce_metrics(metrics, group), aux["sr"]

    return eval_step
