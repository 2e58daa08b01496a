"""Serving and evaluation entry points (port of ``vsrlab_tpu/evaluation/harness.py``).

* :func:`load_test_model` rebuilds a trained model from a run directory
  (config snapshot, ``torch.save`` checkpoint, EMA sidecar);
* :func:`make_forward` builds the sr-only callable ``forward(clip)``,
  optionally over overlapping spatial tiles;
* :func:`make_stream_forward` builds ``(first, rest)`` for stateful
  windowed inference that carries the forward recurrence across windows;
* :func:`windowed_inference` splits a long clip into windows, runs them
  as one batch (or, over a mesh's ``time`` axis, each rank its share of
  them) and restitches;
* :func:`evaluate_video` scores one clip; :func:`run_test_matrix` sweeps
  the fps x crf matrix of compressed test videos and writes a CSV
  (``python -m vsrlab_tpu_torch.evaluation.harness``).

Every entry point takes a ``device``, ``"cuda"`` unless the caller asks
for ``"cpu"``; asking for CUDA where there is none raises.
``windowed_inference`` runs on the device of the ``forward`` it is given.
The model is moved to the device once and runs in inference mode, with
its residual-pair operand caches dropped (a write through ``p.data``
before the call is seen). Clips are ``(B, T, H, W, C)`` numpy arrays or
tensors; results are tensors on the device.

Over a mesh with a ``time`` axis (``parallel.create_mesh({"time": n})``
under torchrun, one card a rank), every rank of the axis is handed the
same clip, runs its contiguous share of the windows on its own device and
ends with the whole result: the shares are gathered by one broadcast from
each rank in turn, which NCCL and gloo both carry. Only rank 0 dumps
frames and writes the CSV of :func:`run_test_matrix`.
"""

from __future__ import annotations

import csv
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from vsrlab_tpu_torch.core.checkpoint import CheckpointManager, load_config_snapshot
from vsrlab_tpu_torch.core.config import Config
from vsrlab_tpu_torch.core.metrics import MetricCollection, resolve_metric_names
from vsrlab_tpu_torch.data.datasets import load_frame
from vsrlab_tpu_torch.evaluation.tiled import tiled_forward
from vsrlab_tpu_torch.nn.blocks import refresh_pair_caches
from vsrlab_tpu_torch.parallel import Mesh, process_index


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The ``torch.device`` to run on; raises if CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return device


def _prepare(model: torch.nn.Module, device) -> torch.device:
    device = resolve_device(device)
    refresh_pair_caches(model.to(device).eval())
    return device


def _to(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(device)


def set_align_chunks(model: torch.nn.Module, chunks: int) -> None:
    """Chunk the parallel-warping alignment of a VRT-family model into
    ``chunks`` sequential parts (a memory knob, the same numerics; the JAX
    package's ``model.clone(align_chunks=...)``); other models have none."""
    for m in model.modules():
        if hasattr(m, "align_chunks"):
            m.align_chunks = chunks


def load_test_model(cfg_dir: str, use_ema: bool = True,
                    device: str | torch.device = "cuda") -> Tuple[torch.nn.Module, Config]:
    """Rebuild the model of a run directory from its ``config.json``
    snapshot (with the snapshot's precision) and load its latest
    checkpoint. Returns ``(model, config)``: the weights live in the
    module, on ``device``, in eval mode, with fresh pair caches (the JAX
    function returns its params beside the model).

    A run trained with ``train.ema_decay`` keeps an EMA shadow under
    ``<run>/ema``; it serves by default, but only when its latest key
    equals the main checkpoint's: a stale or partial sidecar serves the
    raw weights, with a warning. ``use_ema=False`` serves the raw weights."""
    import vsrlab_tpu_torch.components  # noqa: F401  (fills the registry)
    from vsrlab_tpu_torch.train.builders import build_model

    device = resolve_device(device)
    cfg = Config.from_dict(load_config_snapshot(cfg_dir))
    model = build_model(cfg.train.model, cfg.train.get("precision", "fp32"))
    mgr = CheckpointManager(cfg_dir)
    key = mgr.latest_epoch()
    params = None
    ema_dir = Path(cfg_dir) / "ema"
    if use_ema and ema_dir.is_dir():
        ema_mgr = CheckpointManager(str(ema_dir))
        if ema_mgr.latest_epoch() == key:
            params = ema_mgr.restore()[1]["params"]
            print(f"serving EMA weights from {ema_dir} @ key {key}")
        else:
            print(f"WARNING: {ema_dir} latest key {ema_mgr.latest_epoch()} != main checkpoint "
                  f"key {key}: serving RAW weights (stale or partial EMA sidecar)")
    if params is None:
        params = mgr.restore()[1]["params"]
    model.load_state_dict(params)
    _prepare(model, device)
    return model, cfg


def get_video(path, pool=None) -> np.ndarray:
    """Frame folder -> ``(1, T, H, W, 3)`` float32, decoded by a thread pool."""
    from concurrent.futures import ThreadPoolExecutor

    frames = sorted(p for p in Path(path).iterdir() if p.is_file())
    if pool is None:
        with ThreadPoolExecutor(8) as own:
            imgs = list(own.map(load_frame, frames))
    else:
        imgs = list(pool.map(load_frame, frames))
    return np.stack(imgs)[None]


def make_forward(model: torch.nn.Module, tile: Optional[int] = None, tile_overlap: int = 16,
                 device: str | torch.device = "cuda") -> Callable:
    """``forward(clip) -> sr`` for ``model`` on ``device``; ``tile`` runs it
    over overlapping ``tile x tile`` spatial tiles, mean-blended
    (:func:`~vsrlab_tpu_torch.evaluation.tiled.tiled_forward`), for inputs
    whose single pass does not fit the card."""
    device = _prepare(model, device)

    @torch.inference_mode()
    def forward(x):
        out = model(_to(x, device))
        return out[0] if isinstance(out, tuple) else out

    if not tile:
        return forward

    def tiled(x):
        return tiled_forward(forward, _to(x, device), (tile, tile), tile_overlap)

    return tiled


def make_stream_forward(model: torch.nn.Module, device: str | torch.device = "cuda"):
    """``(first, rest)``: ``first(window) -> (sr, state)`` and
    ``rest(window, state) -> (sr, state)`` (BasicVSR family). Carrying the
    state makes the forward recurrence equal to a full-clip run's."""
    device = _prepare(model, device)

    @torch.inference_mode()
    def first(x):
        out = model(_to(x, device), return_state=True)
        return out[0], out[-1]

    @torch.inference_mode()
    def rest(x, state):
        out = model(_to(x, device), stream_state=state, return_state=True)
        return out[0], out[-1]

    return first, rest


def _gather_windows(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ``time`` axis's shares of a window batch, in rank order, on every
    rank of the axis: one broadcast from each rank in turn into its block."""
    ranks = mesh.axis_ranks("time")
    per = local.shape[0]
    full = local.new_empty((per * len(ranks), *local.shape[1:]))
    for j, src in enumerate(ranks):
        block = full[j * per:(j + 1) * per]
        if src == mesh.rank:
            block.copy_(local)
        torch.distributed.broadcast(block, src, group=mesh.axis_group("time"))
    return full


def windowed_inference(forward: Callable, video_lr, window_size: int,
                       mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, int]:
    """Split ``(1, T, H, W, C)`` into ``window_size`` windows (the last one
    padded by repeating the last frame), run them as ONE batch through
    ``forward`` (which places them on its device) and restitch. Returns
    ``(sr, num_windows)`` with ``sr`` ``(1, T, sH, sW, C)``.

    With a ``mesh`` that has a ``time`` axis of ``n`` ranks, the window
    batch is padded to a multiple of ``n`` by repeating the last window,
    rank ``k`` of the axis runs windows ``[k*per, (k+1)*per)`` and every
    rank of the axis returns the whole result."""
    video = torch.as_tensor(video_lr, dtype=torch.float32)
    _, t, h, w, c = video.shape
    n_windows = -(-t // window_size)
    pad = n_windows * window_size - t
    if pad:
        video = torch.cat([video, video[:, -1:].expand(-1, pad, -1, -1, -1)], 1)
    windows = video.reshape(n_windows, window_size, h, w, c)
    nt = mesh.shape.get("time", 1) if mesh is not None else 1
    if nt > 1:
        bpad = (-n_windows) % nt
        if bpad:
            windows = torch.cat([windows, windows[-1:].expand(bpad, -1, -1, -1, -1)])
        per, k = windows.shape[0] // nt, mesh.axis_index("time")
        windows = windows[k * per:(k + 1) * per]
    sr = forward(windows)
    if isinstance(sr, tuple):
        sr = sr[0]
    if nt > 1:
        with torch.no_grad():
            sr = _gather_windows(sr, mesh)
    sr = sr[:n_windows]
    scale = sr.shape[2] // h
    sr = sr.reshape(1, n_windows * window_size, h * scale, w * scale, -1)
    return sr[:, :t], n_windows


def evaluate_video(forward: Callable, video_lr, video_hr, window_size: int,
                   metrics, mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, Dict[str, float]]:
    """One clip of the test matrix: :func:`windowed_inference` of
    ``video_lr`` ``(1, T, h, w, 3)`` (over ``mesh``'s ``time`` axis where
    given), clipped to [0, 1] in fp32, and each built-in metric named in
    ``metrics`` against ``video_hr`` ``(1, T, H, W, 3)``, computed on the
    device. Returns ``(sr, {metric: value})``, the same on every rank."""
    sr, _ = windowed_inference(forward, video_lr, window_size, mesh)
    sr = sr.float().clamp(0.0, 1.0)
    hr = torch.as_tensor(video_hr, dtype=torch.float32).to(sr.device)
    fns = MetricCollection.BUILTIN
    return sr, {k: float(fns[k](sr, hr)) for k in metrics}


def _save_frames(folder: Path, sr: torch.Tensor) -> None:
    """Dump ``sr`` ``(1, T, H, W, 3)`` in [0, 1] as ``img{i:05d}.png`` (OpenCV)."""
    import cv2

    folder.mkdir(parents=True, exist_ok=True)
    frames = (sr[0] * 255).round().to(torch.uint8).cpu().numpy()
    for i, frame in enumerate(frames):
        cv2.imwrite(str(folder / f"img{i:05d}.png"), frame[..., ::-1])


def run_test_matrix(
    cfg_dir: str,
    lr_dir: str,
    hr_dir: str,
    out_dir: str,
    window_size: int = 10,
    fps_list=(6, 8, 10),
    crf_list=(30, 32, 34),
    hr_crf: int = 5,
    metrics=None,
    save_frames: bool = True,
    mesh: Optional[Mesh] = None,
    tile: Optional[int] = None,
    tile_overlap: int = 16,
    align_chunks: int = 0,
    use_ema: bool = True,
    device: str | torch.device = "cuda",
) -> List[Dict]:
    """The fps x crf evaluation sweep. Returns one row a configuration,
    ``{cf, bpp, fps, crf, <metrics>}`` (a list of dicts: pandas is not a
    dependency of the port), and writes them with the ``csv`` module to
    ``<out_dir>/<run>/<run>.csv`` in that column order.

    Layout: ``<lr_dir>/fps=F_crf=C/frames/<video>/`` frame folders, and
    ``.../video/<video>`` encoded files for the bitrate statistics; HR
    under ``<hr_dir>/fps=F_crf=<hr_crf>/...``. ``tile`` serves each window
    over spatial tiles; ``align_chunks`` (VRT family) chunks the alignment
    instead. Metric names come from ``metrics``, else the run's snapshot
    (PSNR / SSIM by default), and are validated before any decode. cf and
    bpp average over the videos whose encoded files are present. SR frames
    are dumped as ``img{i:05d}.png`` where OpenCV is importable.

    With a ``mesh`` (a ``time`` axis: each window batch split over its
    ranks), every rank decodes the same clips and returns the same rows;
    rank 0 alone prints, dumps frames and writes the CSV.
    """
    try:
        import cv2  # noqa: F401
        can_dump = True
    except ImportError:
        can_dump = False
    from vsrlab_tpu_torch.train.step import metrics_from_config

    model, cfg = load_test_model(cfg_dir, use_ema=use_ema, device=device)
    if align_chunks:
        set_align_chunks(model, align_chunks)
    metrics = (metrics_from_config(cfg.train) if metrics is None
               else resolve_metric_names(metrics))
    forward = make_forward(model, tile, tile_overlap, device)
    writer = process_index() == 0
    rows: List[Dict] = []
    name = Path(cfg_dir).name
    output_folder = Path(out_dir) / name

    for fps in fps_list:
        for crf in crf_list:
            video_folder = Path(lr_dir) / f"fps={fps}_crf={crf}" / "frames"
            video_paths = sorted(p for p in video_folder.glob("*") if p.is_dir())
            sums = {k: 0.0 for k in metrics}
            bpp = cf = 0.0
            n_bitrate = 0  # videos with encoded files present
            for video_lr_path in video_paths:
                t0 = time.time()
                vname = video_lr_path.name
                hr_base = Path(hr_dir) / f"fps={fps}_crf={hr_crf}"
                video_lr = get_video(video_lr_path)
                video_hr = get_video(hr_base / "frames" / vname)
                _, f, hh, ww, cc = video_hr.shape
                orig_file = hr_base / "video" / vname
                comp_file = Path(lr_dir) / f"fps={fps}_crf={crf}" / "video" / vname
                if orig_file.exists() and comp_file.exists():
                    bits_orig = orig_file.stat().st_size * 8
                    bits_comp = comp_file.stat().st_size * 8
                    cf += bits_comp / bits_orig
                    bpp += bits_comp / (cc * hh * ww * f)
                    n_bitrate += 1
                sr, vmetrics = evaluate_video(forward, video_lr, video_hr, window_size, metrics,
                                              mesh)
                for k in metrics:
                    sums[k] += vmetrics[k]
                if not writer:
                    continue
                if save_frames and can_dump:
                    _save_frames(output_folder / f"fps={fps}_crf={crf}" / vname, sr)
                print(f"fps={fps} crf={crf} {vname}: "
                      + " ".join(f"{k}={v:.3f}" for k, v in vmetrics.items())
                      + f" ({time.time() - t0:.1f}s)")
            n = max(len(video_paths), 1)
            nb = max(n_bitrate, 1)  # over the videos measured, not all
            rows.append({"cf": cf / nb, "bpp": bpp / nb, "fps": fps, "crf": crf,
                         **{k: v / n for k, v in sums.items()}})

    if writer:
        output_folder.mkdir(parents=True, exist_ok=True)
        with open(output_folder / f"{name}.csv", "w", newline="") as fh:
            out = csv.DictWriter(fh, fieldnames=["cf", "bpp", "fps", "crf", *metrics])
            out.writeheader()
            out.writerows(rows)
    return rows


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="fps x crf evaluation sweep")
    ap.add_argument("--cfg-dir", required=True)
    ap.add_argument("--lr-dir", required=True)
    ap.add_argument("--hr-dir", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--window-size", type=int, default=10)
    ap.add_argument("--tile", type=int, default=0,
                    help="spatial tile size for tiled inference (0 = single pass)")
    ap.add_argument("--tile-overlap", type=int, default=16)
    ap.add_argument("--align-chunks", type=int, default=0,
                    help="VRT memory knob: chunked alignment, the same numerics")
    ap.add_argument("--raw-weights", action="store_true",
                    help="serve the raw (non-EMA) weights even when the run kept an EMA shadow")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rows = run_test_matrix(
        args.cfg_dir, args.lr_dir, args.hr_dir, args.out_dir, args.window_size,
        tile=args.tile or None, tile_overlap=args.tile_overlap,
        align_chunks=args.align_chunks, use_ema=not args.raw_weights, device=args.device)
    for row in rows:
        print(row)
    return rows


if __name__ == "__main__":
    main()
