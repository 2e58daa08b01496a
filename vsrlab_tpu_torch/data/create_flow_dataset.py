"""Teacher-flow dataset builder (port of ``vsrlab_tpu/data/create_flow_dataset.py``).

A frozen RAFT-small teacher (``scale_factor=8``, the reference's
``raft-small.pth`` layout) runs over every adjacent frame pair of every
video folder and saves each pair's flow::

    python -m vsrlab_tpu_torch.data.create_flow_dataset \\
        --frames <root of video folders> --out <flow dir> --raft-ckpt <raft-small.pth> \\
        [--height 384 --width 512] [--device cpu]

It writes ``<out>/<video>_<f1>_<f2>.npz`` (key ``flow``, ``(H, W, 2)``
fp32), ``f1`` a frame's stem and ``f2`` the next frame's file name, as
:class:`~vsrlab_tpu_torch.data.flow_dataset.FlowDataset` reads them. The
teacher runs on the card unless ``--device cpu`` is given; its 48
correlation lookups a pair go through the sampler kernel there. The
checkpoint is required: there is no random-teacher fallback.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from vsrlab_tpu_torch.data.datasets import load_frame
from vsrlab_tpu_torch.data.video_io import _need_cv2
from vsrlab_tpu_torch.evaluation.harness import resolve_device
from vsrlab_tpu_torch.models.flow.raft import RAFT, load_raft_state_dict


def build_teacher(raft_ckpt: str, device="cuda"):
    """``fwd(a, b) -> flow``: the RAFT-small of ``raft_ckpt`` on ``device``
    (raises where CUDA is asked for and absent), without a gradient; ``a``,
    ``b`` ``(B, H, W, 3)`` in [0, 1], the flow ``(B, H, W, 2)`` on the
    device. The model is ``fwd.model``."""
    device = resolve_device(device)
    model = RAFT(small=True, scale_factor=8)
    load_raft_state_dict(model, torch.load(raft_ckpt, map_location="cpu", weights_only=True))
    model.to(device).eval().requires_grad_(False)

    @torch.no_grad()
    def fwd(a, b):
        return model(torch.as_tensor(a, dtype=torch.float32).to(device),
                     torch.as_tensor(b, dtype=torch.float32).to(device))

    fwd.model = model
    return fwd


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--raft-ckpt", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cv = _need_cv2("create_flow_dataset")
    fwd = build_teacher(args.raft_ckpt, args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for video in sorted(Path(args.frames).iterdir()):
        if not video.is_dir():
            continue
        frames = sorted(p for p in video.iterdir() if p.is_file())
        for p1, p2 in zip(frames[:-1], frames[1:]):
            a = cv.resize(load_frame(p1), (args.width, args.height))
            b = cv.resize(load_frame(p2), (args.width, args.height))
            flow = fwd(a[None], b[None])
            name = f"{video.name}_{p1.stem}_{p2.name}"
            np.savez_compressed(out / f"{name}.npz", flow=flow[0].cpu().numpy())
            print(name)


if __name__ == "__main__":
    main()
