"""Parameter count and inference-speed bench (port of
``vsrlab_tpu/evaluation/params_bench.py``): the average wall time of one
windowed forward after a warm-up, and the parameter count; one CSV row a
run directory.

    python -m vsrlab_tpu_torch.evaluation.params_bench <run-dir> [...] [--out x.csv]
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from vsrlab_tpu_torch.evaluation.harness import load_test_model, make_forward, resolve_device
from vsrlab_tpu_torch.utils.profiler import best_time


def param_count(model: torch.nn.Module) -> int:
    """Trainable parameters of ``model`` (every parameter tensor's size)."""
    return int(sum(p.numel() for p in model.parameters()))


def speed_bench(model: torch.nn.Module, clip_shape=(1, 10, 180, 320, 3), n_iters: int = 5,
                device: str | torch.device = "cuda") -> Dict[str, float]:
    """Seconds a forward of one ``clip_shape`` input (already on the device)
    and frames/s, the best of 3 runs of ``n_iters`` calls after one warm
    call, each run ended by a device sync; with the parameter count.
    Returns ``{"avg_time", "frames_per_sec", "params"}``."""
    device = resolve_device(device)
    forward = make_forward(model, device=device)
    lr = torch.from_numpy(np.random.default_rng(0).random(clip_shape, np.float32)).to(device)

    def call_and_sync(n):
        for _ in range(n):
            forward(lr)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    best = best_time(call_and_sync, n_iters)
    return {"avg_time": best, "frames_per_sec": clip_shape[1] / best,
            "params": param_count(model)}


def run(cfg_dirs: List[str], out_csv: Optional[str] = None, batch: int = 1,
        window_size: int = 10, height: int = 180, width: int = 320,
        device: str | torch.device = "cuda") -> List[Dict]:
    """Bench every run directory at ``(batch, window_size, height, width,
    3)``; ``frames_per_sec`` counts the frames of all ``batch`` clips (the
    serving throughput of a batched forward). Returns the rows (a list of
    dicts) and writes them to ``out_csv`` with the ``csv`` module."""
    rows = []
    for cfg_dir in cfg_dirs:
        model, _ = load_test_model(cfg_dir, device=device)
        stats = speed_bench(model, (batch, window_size, height, width, 3), device=device)
        stats["frames_per_sec"] *= batch
        rows.append({"model": Path(cfg_dir).name, "batch": batch, **stats})
        print(rows[-1])
    if out_csv:
        with open(out_csv, "w", newline="") as fh:
            writer = csv.DictWriter(fh, fieldnames=list(rows[0]) if rows else ["model"])
            writer.writeheader()
            writer.writerows(rows)
    return rows


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="parameter count and inference speed")
    ap.add_argument("cfg_dirs", nargs="+")
    ap.add_argument("--out", default=None)
    ap.add_argument("--batch", type=int, default=1, help="clips per forward (serving throughput)")
    ap.add_argument("--window-size", type=int, default=10)
    ap.add_argument("--height", type=int, default=180)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(args.cfg_dirs, args.out, args.batch, args.window_size, args.height, args.width,
               args.device)


if __name__ == "__main__":
    main()
