"""Learning-rate schedules as plain ``step -> lr`` functions
(port of ``vsrlab_tpu/core/schedulers.py``).

``step`` counts optimizer updates, from 0 for the first, as optax indexes
its schedules; the trainer sets each update's learning rate from it.

* :func:`cosine_annealing`: torch ``CosineAnnealingLR`` in closed form.
* :func:`cosine_annealing_linear_warmup`: linear warmup, then cosine
  cycles whose length grows by ``cycle_mult`` and whose peak decays by
  ``gamma`` a cycle.
"""

from __future__ import annotations

import math


def cosine_annealing(base_lr: float, t_max: int, eta_min: float = 0.0):
    """``eta_min + (base - eta_min) * (1 + cos(pi * t / T_max)) / 2``."""

    def schedule(step) -> float:
        return eta_min + (base_lr - eta_min) * (1.0 + math.cos(math.pi * float(step) / t_max)) / 2.0

    return schedule


def cosine_annealing_linear_warmup(max_lr: float, first_cycle_steps: int,
                                   min_lr: float | None = None, cycle_mult: float = 1.0,
                                   warmup_steps: int = 0, gamma: float = 1.0,
                                   min_lr_pow: int | None = None):
    """Warmup + cosine cycles. ``s`` steps into a cycle of length ``L``:
    during warmup (``s < w``) linear from ``min_lr`` to the cycle's peak,
    then ``min_lr + (peak - min_lr) * (1 + cos(pi*(s-w)/(L-w)))/2``. Cycles
    after the first are ``(L - w) * cycle_mult + w`` long; the peak is
    ``max_lr * gamma**cycle``. Give exactly one of ``min_lr`` and
    ``min_lr_pow`` (``min_lr = max_lr * 10**-min_lr_pow``)."""
    if not warmup_steps < first_cycle_steps:
        raise ValueError("warmup_steps must be shorter than first_cycle_steps")
    if (min_lr is None) == (min_lr_pow is None):
        raise ValueError("specify exactly one of min_lr / min_lr_pow")
    if min_lr_pow is not None:
        min_lr = max_lr * (10.0 ** -min_lr_pow)

    def cycle_of(step: float):
        if cycle_mult == 1.0:
            return step // first_cycle_steps, step % first_cycle_steps, float(first_cycle_steps)
        ratio = step / first_cycle_steps * (cycle_mult - 1.0) + 1.0
        n = math.floor(math.log(ratio) / math.log(cycle_mult))
        start = first_cycle_steps * (cycle_mult**n - 1.0) / (cycle_mult - 1.0)
        return n, step - start, first_cycle_steps * cycle_mult**n

    def schedule(step) -> float:
        cycle, s, length = cycle_of(float(step))
        peak = max_lr * gamma**cycle
        if s < warmup_steps:
            return (peak - min_lr) * s / max(warmup_steps, 1) + min_lr
        denom = max(length - warmup_steps, 1.0)
        return min_lr + (peak - min_lr) * (1.0 + math.cos(math.pi * (s - warmup_steps) / denom)) / 2.0

    return schedule
