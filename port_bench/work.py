"""The work a cell asks of the card, counted the same whatever implements it.

* A model's FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``
  run over the plain reference (``port_bench/reference``) on the meta
  device at the cell's shapes: products only (convolutions, matmuls), as
  a model's FLOPs are counted. Training counts the forward and the
  backward that the step needs, with no recompute.
* The residual pair ``x + conv2(relu(conv1(x) + b1)) + b2`` (3x3, zero
  padding) is counted from the shape each call sees: two 3x3 products of
  ``2 * 9 * C * C`` FLOPs a pixel, and the bytes of reading each input
  once (the activation and both convs' weights and biases) and writing
  the output once.
* Peaks of one NVIDIA H100 SXM (the data sheet, dense): 989 TFLOP/s in
  bf16 on the tensor cores, 67 TFLOP/s in fp32 on the CUDA cores (the
  program's fp32 pair kernel uses no TF32), 3.35 TB/s of HBM3. A card set
  below 700 W runs under them; its ``power.limit`` is reported beside.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def pair_work(shape: Sequence[int], dtype: str) -> Tuple[float, float]:
    """``(flops, bytes)`` of one residual pair call on ``(B, H, W, C)``."""
    b, h, w, c = shape
    pixels = b * h * w
    flops = 2.0 * (2.0 * 9 * c * c) * pixels
    size = ITEMSIZE[dtype]
    act = pixels * c * size
    weights = 2 * (9 * c * c * size + c * 4)  # both convs; fp32 biases
    return flops, float(2 * act + weights)


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of compute and memory."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def counted_flops(fn: Callable[[], object]) -> float:
    """The FLOPs ``FlopCounterMode`` counts while ``fn`` runs."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def meta_params(shapes: Dict[str, Tuple[int, ...]], grad: Callable[[str], bool] = lambda n: False):
    import torch

    return {n: torch.empty(s, device="meta", requires_grad=grad(n)) for n, s in shapes.items()}


def forward_flops(ref, widths: dict, clip_shape: Sequence[int]) -> float:
    """FLOPs of the reference's forward over one batch of ``clip_shape``."""
    import torch

    p = meta_params(ref.param_shapes(**widths))

    def run():
        with torch.no_grad():
            ref.forward(p, torch.empty(clip_shape, device="meta"), **widths)

    return counted_flops(run)


def train_flops(ref, widths: dict, lr_shape: Sequence[int], hr_shape: Sequence[int],
                loss: Callable) -> float:
    """FLOPs of one training step's forward and backward, the trainable
    parameters' gradients only, with no recompute."""
    import torch

    p = meta_params(ref.param_shapes(**widths), lambda n: not ref.frozen(n, **widths))

    def run():
        out = ref.forward(p, torch.empty(lr_shape, device="meta"), **widths)
        loss(out, torch.empty(hr_shape, device="meta")).backward()

    return counted_flops(run)
