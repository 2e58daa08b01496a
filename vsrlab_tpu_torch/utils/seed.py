"""Deterministic seeding (port of ``vsrlab_tpu/utils/seed.py``): python's
and numpy's generators are seeded, and a seeded ``torch.Generator`` takes
the place of the JAX key (``init_weights`` draws the parameters from it)."""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_everything(seed: int) -> torch.Generator:
    """Seed python / numpy / torch's global generator; return a CPU
    ``torch.Generator`` seeded with ``seed``."""
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    # reaches subprocesses only: the running interpreter fixed its hash seed at start
    os.environ["PYTHONHASHSEED"] = str(seed)
    return torch.Generator().manual_seed(seed)


def seed_index_everything(cfg, sanity: int = 42) -> torch.Generator:
    """Seed from ``cfg.seed_index``, or ``sanity`` where it is unset."""
    seed = cfg.get("seed_index") if hasattr(cfg, "get") else None
    return seed_everything(int(sanity if seed is None else seed))
