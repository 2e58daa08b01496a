"""Video -> video super-resolution (port of ``vsrlab_tpu/evaluation/upscale.py``).

Point it at a video file or a frame folder and a trained run directory (or
an exported artifact), and get the upscaled video or PNG frames:

    python -m vsrlab_tpu_torch.evaluation.upscale \\
        --cfg-dir <run-dir> --input clip.mp4 --output clip_4x.mp4 \\
        [--window-size 10] [--tile 0] [--tile-overlap 16] [--fps 0] \\
        [--align-chunks 0] [--stream] [--raw-weights] [--device cuda]

    python -m vsrlab_tpu_torch.evaluation.upscale \\
        --artifact model.pt2 --input clip.mp4 --output clip_4x.mp4

Windows run one after another at O(window) memory for any length: a
background thread decodes window ``i+1`` while the card computes window
``i`` and the host copies back and encodes window ``i-1`` (one window of
lag, so the copy never waits on the window just queued). ``--stream``
carries the forward recurrence state across windows (BasicVSR family).
:func:`upscale_frames` is that loop over any frame source and sink; file
decode and encode need OpenCV.
"""

from __future__ import annotations

import inspect
import queue
import threading
import time
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

VIDEO_EXTS = {".mp4", ".avi", ".mkv", ".mov", ".webm"}


def _iter_windows(read_next, window_size: int):
    """Yield ``(window (1, ws, H, W, 3), n_real)`` until the source is
    exhausted; a short final read is padded by repeating its last frame
    (``n_real`` says how many frames are real)."""
    while True:
        frames = read_next(window_size)
        k = 0 if frames is None else len(frames)
        if k == 0:
            return
        if k < window_size:
            frames = np.concatenate([frames, np.repeat(frames[-1:], window_size - k, axis=0)])
        yield frames[None], k


def _prefetch(gen, depth: int = 1):
    """Run a generator in a daemon thread with a bounded queue, so the next
    window decodes while the card computes the current one (OpenCV's decode
    releases the GIL). An error in the source is raised to the consumer.

    Closing the returned generator (or abandoning it on an error) stops the
    worker and joins it BEFORE returning, so the caller may then release
    what the source reads from (an open capture: releasing it while the
    worker sits inside ``read()`` is a race in native code)."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def worker():
        try:
            for item in gen:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.05)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put(end)
        except BaseException as e:  # handed to the consumer, which raises it
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while t.is_alive():  # drain so that a blocked put() sees the stop
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            t.join(0.05)


class _VideoSink:
    """Incremental video encoder: frames are appended as windows drain."""

    def __init__(self, path, fps: float, codec: str):
        self.path, self.fps, self.codec = Path(path), fps, codec
        self._writer = None
        self.frames_written = 0
        self.frame_shape = None

    def write(self, frames: np.ndarray):
        from vsrlab_tpu_torch.data.video_io import open_video_writer, write_frames

        if self._writer is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            h, w = frames.shape[1:3]
            self._writer = open_video_writer(self.path, w, h, self.codec, self.fps)
        write_frames(self._writer, frames)
        self.frames_written += len(frames)
        self.frame_shape = frames.shape[1:]

    def close(self):
        if self._writer is not None:
            self._writer.release()


class _FolderSink:
    """Incremental PNG frame dump, ``img{i:05d}.png`` (OpenCV)."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self.frames_written = 0
        self.frame_shape = None

    def write(self, frames: np.ndarray):
        import cv2

        from vsrlab_tpu_torch.data.video_io import to_uint8

        for frame in to_uint8(frames):
            cv2.imwrite(str(self.path / f"img{self.frames_written:05d}.png"), frame[..., ::-1])
            self.frames_written += 1
        self.frame_shape = frames.shape[1:]

    def close(self):
        pass


class ArraySink:
    """Keeps the frames in memory: ``frames()`` is ``(T, H, W, 3)`` float32."""

    def __init__(self):
        self.chunks: List[np.ndarray] = []
        self.frames_written = 0
        self.frame_shape = None

    def write(self, frames: np.ndarray):
        self.chunks.append(frames)
        self.frames_written += len(frames)
        self.frame_shape = frames.shape[1:]

    def frames(self) -> np.ndarray:
        return np.concatenate(self.chunks)

    def close(self):
        pass


def array_source(frames: np.ndarray) -> Callable[[int], Optional[np.ndarray]]:
    """``read_next(n)`` over in-memory frames ``(T, H, W, 3)``."""
    pos = 0

    def read_next(n):
        nonlocal pos
        batch = frames[pos:pos + n]
        pos += len(batch)
        return batch if len(batch) else None

    return read_next


def upscale_frames(read_next: Callable, sink, window_size: int, forward: Callable = None,
                   stream: tuple = None, expect_hw: tuple = None) -> int:
    """Super-resolve every frame ``read_next(n)`` yields into ``sink``, a
    window of ``window_size`` at a time: through ``forward(window) -> sr``,
    or with ``stream = (first, rest)`` carrying the recurrence state from
    window to window. ``expect_hw`` refuses frames of another size (an
    exported artifact's fixed shape). Window ``i`` is queued on the device
    before window ``i-1`` is copied back and written. Returns the frames
    written."""
    state = None
    pending = None  # (SR on the device, real frames): one window behind
    windows = _prefetch(_iter_windows(read_next, window_size))
    try:
        for win, n_real in windows:
            if expect_hw and win.shape[2:4] != expect_hw:
                raise ValueError(f"input frames are {win.shape[2]}x{win.shape[3]} but the "
                                 f"artifact was exported at {expect_hw[0]}x{expect_hw[1]} "
                                 "(fixed shape)")
            if stream:
                first, rest = stream
                sr, state = first(win) if state is None else rest(win, state)
            else:
                sr = forward(win)
            sr = sr[0].float().clamp(0.0, 1.0)  # queued, not waited for
            if pending is not None:
                prev, k = pending
                sink.write(prev[:k].cpu().numpy())
            pending = (sr, n_real)
        if pending is None:
            raise IOError("no frames decoded from the input")
        prev, k = pending
        sink.write(prev[:k].cpu().numpy())
    finally:
        windows.close()  # joins the decode thread before the caller releases the reader
    return sink.frames_written


def _frame_folder_source(folder: Path):
    from vsrlab_tpu_torch.data.datasets import load_frame

    frame_files = sorted(p for p in folder.iterdir() if p.is_file())
    if not frame_files:
        raise IOError(f"no frames in {folder}")
    pos = 0

    def read_next(n):
        nonlocal pos
        batch = frame_files[pos:pos + n]
        pos += len(batch)
        return np.stack([load_frame(p) for p in batch]) if batch else None

    return read_next


def upscale(cfg_dir: Optional[str], input_path: str, output_path: str, window_size: int = 10,
            tile: int = 0, tile_overlap: int = 16, fps: float = 0.0, codec: str = "mp4v",
            align_chunks: int = 0, stream: bool = False, use_ema: bool = True,
            artifact: str = "", device: str | torch.device = "cuda") -> tuple:
    """Upscale one video file or frame folder into a video (by the output's
    extension) or a frame folder. Returns ``((T, H, W, 3), seconds)``."""
    from vsrlab_tpu_torch.data.video_io import SequentialVideoReader
    from vsrlab_tpu_torch.evaluation.harness import (
        load_test_model, make_forward, make_stream_forward, set_align_chunks)

    out = Path(output_path)
    to_video = out.suffix.lower() in VIDEO_EXTS
    if out.suffix and not to_video and not out.is_dir():
        raise ValueError(f"unrecognised output extension '{out.suffix}': use one of "
                         f"{sorted(VIDEO_EXTS)} for a video, or a directory path for PNG frames")
    expect_hw = forward = pair = None
    if artifact:
        if stream or tile or align_chunks:
            raise ValueError("--artifact serves a fixed-shape exported program; --stream, "
                             "--tile and --align-chunks need the model code (use --cfg-dir)")
        from vsrlab_tpu_torch.evaluation.export import load_exported_forward

        forward, in_shape = load_exported_forward(artifact)
        if in_shape[0] != 1:
            raise ValueError(f"the artifact was exported at batch={in_shape[0]}; the upscale "
                             "loop feeds single-clip windows (re-export with --batch 1)")
        if window_size != in_shape[1]:
            print(f"note: the window size is fixed at export time: using the artifact's "
                  f"{in_shape[1]} (not {window_size})")
            window_size = in_shape[1]
        expect_hw = in_shape[2:4]
    else:
        model, _ = load_test_model(cfg_dir, use_ema=use_ema, device=device)
        if align_chunks:
            set_align_chunks(model, align_chunks)
        if stream and "stream_state" not in inspect.signature(model.forward).parameters:
            raise ValueError("--stream needs a recurrent model (BasicVSR family); "
                             f"{type(model).__name__} has no propagation state to carry")
        if stream and tile:
            raise ValueError("--stream and --tile are mutually exclusive")
        if stream:
            pair = make_stream_forward(model, device=device)
        else:
            forward = make_forward(model, tile, tile_overlap, device)

    # open the input only after every check that can raise
    inp = Path(input_path)
    reader = None
    if inp.is_dir():
        read_next = _frame_folder_source(inp)
        src_fps = fps or 24.0
    else:
        reader = SequentialVideoReader(inp)
        read_next = reader.read
        src_fps = fps or reader.fps or 24.0  # some containers carry no fps
    sink = _VideoSink(out, src_fps, codec) if to_video else _FolderSink(out)
    t0 = time.time()
    try:
        upscale_frames(read_next, sink, window_size, forward, pair, expect_hw)
    finally:
        sink.close()
        if reader is not None:
            reader.close()
    return (sink.frames_written, *sink.frame_shape), time.time() - t0


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="video -> video SR")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--cfg-dir", help="trained run directory")
    src.add_argument("--artifact", help="exported .pt2 artifact (evaluation/export.py); window "
                     "size and frame size are fixed at export time")
    ap.add_argument("--input", required=True, help="video file or frame folder")
    ap.add_argument("--output", required=True, help="output video file (by extension) or folder")
    ap.add_argument("--window-size", type=int, default=10)
    ap.add_argument("--tile", type=int, default=0, help="spatial tile size (0 = single pass)")
    ap.add_argument("--tile-overlap", type=int, default=16)
    ap.add_argument("--fps", type=float, default=0.0, help="0 = keep the source's fps")
    ap.add_argument("--codec", default="mp4v")
    ap.add_argument("--align-chunks", type=int, default=0,
                    help="VRT memory knob: chunked alignment, the same numerics")
    ap.add_argument("--stream", action="store_true",
                    help="carry the forward recurrence state across windows (BasicVSR family)")
    ap.add_argument("--raw-weights", action="store_true",
                    help="serve the raw (non-EMA) weights even when the run kept an EMA shadow")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    shape, dt = upscale(args.cfg_dir, args.input, args.output, args.window_size, args.tile,
                        args.tile_overlap, args.fps, args.codec, args.align_chunks, args.stream,
                        use_ema=not args.raw_weights, artifact=args.artifact or "",
                        device=args.device)
    print(f"wrote {args.output}: {shape} in {dt:.1f}s "
          f"({shape[0] / max(dt, 1e-9):.2f} frames/s)")
    return shape


if __name__ == "__main__":
    main()
