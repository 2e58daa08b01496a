"""Train state (port of ``vsrlab_tpu/train/state.py``): the model (fp32
parameters), the optimizer's step wrapper, the count of train steps and an
optional exponential-moving-average shadow of the parameters in fp32."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from vsrlab_tpu_torch.train.builders import Updater


@dataclass
class TrainState:
    model: torch.nn.Module
    tx: Updater
    step: int = 0  # train steps taken, applied or skipped (flax's TrainState.step)
    ema: Optional[Dict[str, torch.Tensor]] = None  # parameter name -> fp32 shadow


def copy_params(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A detached fp32 copy of every parameter, by name."""
    return {n: p.detach().float().clone() for n, p in model.named_parameters()}


def create_train_state(model: torch.nn.Module, tx: Updater, ema_decay: float = 0.0) -> TrainState:
    """Wrap ``model`` (initialised and on its device) and the step wrapper
    over its parameters; ``ema_decay > 0`` seeds the EMA shadow with a copy
    of the parameters, which the train step (built with the same decay)
    then moves after every step."""
    return TrainState(model=model, tx=tx, ema=copy_params(model) if ema_decay else None)
