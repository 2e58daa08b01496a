"""The system under test, built from a configuration file.

A configuration names the program's model class (``program.class``, a
dotted path into ``vsrlab_tpu_torch``), the widths its constructor and
the reference share (``model``), the program's own options
(``program.options``) and the precision. The weights are the
benchmark's: drawn from the seed on the card over the reference's list of
parameters (:func:`port_bench.common.seeded_params`) and loaded into the
program by name, so both sides hold the same numbers.
"""

from __future__ import annotations

import importlib

from port_bench.common import Cell, default_fan_in, seeded_params

DTYPES = {"bf16": "bfloat16", "fp32": None}


def compute_dtype(cell: Cell):
    import torch

    name = DTYPES[cell.config["precision"]]
    return None if name is None else getattr(torch, name)


def weights(cell: Cell, seed: int, device) -> dict:
    """The seed's weights, fp32 on ``device``, by the program's parameter names."""
    ref = cell.reference_module()
    shapes = ref.param_shapes(**cell.config["model"])
    return seeded_params(shapes, seed, device, getattr(ref, "fan_in", default_fan_in))


def build(cell: Cell, seed: int, device, **extra):
    """The program's model on ``device`` holding the seed's weights."""
    import torch

    mod_name, cls_name = cell.config["program"]["class"].rsplit(".", 1)
    cls = getattr(importlib.import_module(mod_name), cls_name)
    kwargs = {**cell.config["model"], **cell.config["program"].get("options", {}), **extra}
    with torch.device(device):
        model = cls(**kwargs, dtype=compute_dtype(cell))
    model.load_state_dict(weights(cell, seed, device))
    return model
