"""Inference entry points (port of ``vsrlab_tpu/evaluation/harness.py:104-196``).

* :func:`make_forward` builds the sr-only callable ``forward(clip)``;
* :func:`make_stream_forward` builds ``(first, rest)`` for stateful
  windowed inference that carries the forward recurrence across windows;
* :func:`windowed_inference` splits a long clip into windows, runs them
  as one batch and restitches.

``make_forward`` and ``make_stream_forward`` take a ``device``, ``"cuda"``
unless the caller asks for ``"cpu"``; asking for CUDA where there is none
raises. ``windowed_inference`` runs on the device of the ``forward`` it is
given. The model is moved to the
device once and runs in inference mode. Clips are ``(B, T, H, W, C)``
numpy arrays or tensors; results are tensors on the device.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


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
    model.to(device).eval()
    return device


def _to(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(device)


def make_forward(model: torch.nn.Module, device: str | torch.device = "cuda") -> Callable:
    """``forward(clip) -> sr`` for ``model`` on ``device``."""
    device = _prepare(model, device)

    @torch.inference_mode()
    def forward(x):
        out = model(_to(x, device))
        return out[0] if isinstance(out, tuple) else out

    return forward


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


def windowed_inference(forward: Callable, video_lr, window_size: int) -> Tuple[torch.Tensor, int]:
    """Split ``(1, T, H, W, C)`` into ``window_size`` windows (the last one
    padded by repeating the last frame), run them as ONE batch through
    ``forward`` (which places them on its device) and restitch. Returns
    ``(sr, num_windows)`` with ``sr`` ``(1, T, sH, sW, C)``."""
    video = torch.as_tensor(video_lr, dtype=torch.float32)
    _, t, h, w, c = video.shape
    n_windows = -(-t // window_size)
    pad = n_windows * window_size - t
    if pad:
        video = torch.cat([video, video[:, -1:].expand(-1, pad, -1, -1, -1)], 1)
    sr = forward(video.reshape(n_windows, window_size, h, w, c))
    if isinstance(sr, tuple):
        sr = sr[0]
    scale = sr.shape[2] // h
    sr = sr.reshape(1, n_windows * window_size, h * scale, w * scale, -1)
    return sr[:, :t], n_windows
