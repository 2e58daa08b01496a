"""Export of a trained model for serving (port of ``vsrlab_tpu/evaluation/export.py``).

:func:`export_model` traces the served forward of a run directory at a
FIXED input shape with ``torch.export`` and saves the program, with its
weights, as one ``.pt2`` file. A later process loads it with
:func:`load_exported` and calls it without the run directory, the config
system or the model's classes.

The hand-written kernels stay in the exported graph: the residual pair,
the bilinear sampler and the packed row gather go into it as the custom
ops ``torch.ops.vsrlab.*``, whose implementation launches the kernel on a
CUDA tensor (counted in the wrappers' ``launches``) and runs the plain
version on a CPU one. So, unlike the JAX artifact, loading one needs the
port's op library registered: ``import vsrlab_tpu_torch.ops`` (this module
does it). The layout of the pair's weights is traced into the graph, from
the weights the program holds. The program runs on the device it was
exported on.

    python -m vsrlab_tpu_torch.evaluation.export --cfg-dir <run-dir> \\
        --output model.pt2 --window-size 10 --height 180 --width 320

    from vsrlab_tpu_torch.evaluation.export import load_exported
    forward = load_exported("model.pt2")
    sr = forward(clip)   # (1, 10, 180, 320, 3) -> (1, 10, 720, 1280, 3)
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, Sequence, Tuple

import torch

import vsrlab_tpu_torch.ops  # noqa: F401  (registers the kernels' custom ops)
from vsrlab_tpu_torch.evaluation.harness import load_test_model, resolve_device, set_align_chunks


class _SROnly(torch.nn.Module):
    """The model's forward, returning only the SR clip."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, clip):
        out = self.model(clip)
        return out[0] if isinstance(out, tuple) else out


def export_module(model: torch.nn.Module, out_path: str, input_shape: Sequence[int],
                  device: str | torch.device = "cuda") -> int:
    """Export ``model``'s SR forward at fp32 input ``input_shape`` on
    ``device`` to ``out_path``. Returns the file's size in bytes."""
    device = resolve_device(device)
    model = model.to(device).eval()
    example = torch.zeros(tuple(input_shape), dtype=torch.float32, device=device)
    with torch.no_grad():
        program = torch.export.export(_SROnly(model), (example,), strict=False)
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, str(out))
    return os.path.getsize(out)


def export_model(cfg_dir: str, out_path: str, window_size: int = 10, height: int = 180,
                 width: int = 320, batch: int = 1, align_chunks: int = 0, use_ema: bool = True,
                 device: str | torch.device = "cuda") -> int:
    """Export the run's served model at input ``(batch, window_size, height,
    width, 3)``. Returns the artifact's size in bytes."""
    model, _ = load_test_model(cfg_dir, use_ema=use_ema, device=device)
    if align_chunks:
        set_align_chunks(model, align_chunks)
    return export_module(model, out_path, (batch, window_size, height, width, 3), device)


def load_exported_forward(path: str) -> Tuple[Callable, Tuple[int, ...]]:
    """``(forward, input_shape)`` of an exported artifact: ``forward(clip)``
    takes a numpy array or tensor of exactly ``input_shape`` ``(batch,
    window, H, W, 3)``, moves it to the program's device and returns the SR
    clip there."""
    program = torch.export.load(str(path))
    names = set(program.graph_signature.user_inputs)
    spec = next(n.meta["val"] for n in program.graph.nodes
                if n.op == "placeholder" and n.name in names)
    shape, device = tuple(int(s) for s in spec.shape), spec.device
    module = program.module()

    @torch.inference_mode()
    def forward(clip):
        return module(torch.as_tensor(clip, dtype=torch.float32).to(device))

    return forward, shape


def load_exported(path: str) -> Callable:
    """``forward(clip) -> sr`` of an exported artifact (input shape fixed at
    export time)."""
    return load_exported_forward(path)[0]


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="export a trained model with torch.export")
    ap.add_argument("--cfg-dir", required=True, help="trained run directory")
    ap.add_argument("--output", required=True, help="artifact path (.pt2)")
    ap.add_argument("--window-size", type=int, default=10)
    ap.add_argument("--height", type=int, default=180)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--align-chunks", type=int, default=0)
    ap.add_argument("--raw-weights", action="store_true", help="export the raw (non-EMA) weights")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    n = export_model(args.cfg_dir, args.output, args.window_size, args.height, args.width,
                     args.batch, args.align_chunks, use_ema=not args.raw_weights,
                     device=args.device)
    print(f"wrote {args.output}: {n / 1e6:.1f} MB "
          f"({args.batch}x{args.window_size}x{args.height}x{args.width}x3)")
    return n


if __name__ == "__main__":
    main()
