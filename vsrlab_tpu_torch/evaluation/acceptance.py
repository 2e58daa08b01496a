"""One-command weights-level acceptance of a reference checkpoint (port of
``scripts/acceptance.py``).

Serves every clip of a dataset with a checkpoint of the reference
vsrlab and holds the mean PSNR against the published value:

    python -m vsrlab_tpu_torch.evaluation.acceptance --model vrt \\
        --checkpoint 002_VRT_videosr_bi_REDS_16frames.pth \\
        --data REDS4 --published-psnr 32.19 --published-ssim 0.9006

    python -m vsrlab_tpu_torch.evaluation.acceptance --model realbasicvsr \\
        --checkpoint RealBasicVSR_x4.pth --data REDS4 --published-psnr <value>

Dataset layout: ``<data>/<clip>/hr/*.png`` with an optional
``<data>/<clip>/lr/*.png``; without ``lr/`` the HR frames are cropped to
the scale-divisible region and the LR is their bicubic / ``scale``
(``ops.resize.resize_bicubic``). A flat ``<data>/<clip>/*.png`` folder is
HR only.

Checkpoint: a state dict, or a dict holding one under
``model_state_dict`` / ``state_dict`` / ``params``, converted by
:mod:`vsrlab_tpu_torch.core.torch_import` and loaded with
``strict=True``. The model runs in fp32 with TF32 off (restored after)
unless ``--bf16``: a 0.05 dB bar must not spend its budget on the compute
type's rounding.

Prints one JSON line; exits 0 on pass, 1 on fail, 2 when a checkpoint or
dataset is missing or no published PSNR is known. ``--device cuda`` (the
default) raises where there is no card; ``--device cpu`` runs on the CPU.
``--selftest`` runs every serving mode of the command on tiny seeded
models and synthetic frames.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

# published anchors; RealBasicVSR publishes no PSNR (real-world SR,
# NIQE-evaluated), so its target comes from a reference run via --published-psnr
PUBLISHED = {
    "vrt": {"psnr": 32.19, "ssim": 0.9006},  # REDS4 4x, 16-frame
}


def build_model(name: str, args) -> torch.nn.Module:
    """The port's model for ``--model`` in ``--bf16`` or fp32, with
    ``--align-chunks`` set on the VRT family."""
    from vsrlab_tpu_torch.evaluation.harness import set_align_chunks
    from vsrlab_tpu_torch.models import VRT, RealBasicVSR, TinyVRT

    dtype = torch.bfloat16 if args.bf16 else None
    if name == "realbasicvsr":
        return RealBasicVSR(mid_channels=args.mid_channels, res_blocks=args.res_blocks,
                            cleaning_blocks=args.cleaning_blocks, dtype=dtype)
    model = (VRT if name == "vrt" else TinyVRT)(upscale=4, dtype=dtype)
    set_align_chunks(model, args.align_chunks)
    return model


def import_state_dict(name: str, checkpoint) -> dict:
    """The port's ``state_dict`` for ``--model`` from a reference checkpoint."""
    from vsrlab_tpu_torch.core import torch_import

    sd = torch_import.load_reference_checkpoint(checkpoint)
    if name == "realbasicvsr":
        return torch_import.load_torch_realbasicvsr(sd)
    return torch_import.load_torch_vrt(sd, n_scale_stages=7 if name == "vrt" else 5)


def stream_windows(stream_fwd, lr, window: int) -> torch.Tensor:
    """Stateful windowed inference (BasicVSR family): the forward
    recurrence's state carries from window to window, as ``upscale
    --stream`` serves."""
    first, rest = stream_fwd
    state, srs = None, []
    for i in range(0, lr.shape[1], window):
        win = lr[:, i:i + window]
        sr, state = first(win) if state is None else rest(win, state)
        srs.append(sr)
    return torch.cat(srs, 1)


def clip_dirs(data: Path):
    """``(name, hr_dir, lr_dir or None)`` for every clip folder under ``data``."""
    for d in sorted(p for p in data.iterdir() if p.is_dir()):
        if (d / "hr").is_dir():
            yield d.name, d / "hr", (d / "lr") if (d / "lr").is_dir() else None
        elif any(p.is_file() for p in d.iterdir()):
            yield d.name, d, None


def derive_lr(name: str, hr: np.ndarray, scale: int, device) -> tuple:
    """``(hr, lr)``: HR cropped to the scale-divisible region (else SR would
    come back smaller than HR), LR its bicubic / ``scale`` on ``device``."""
    from vsrlab_tpu_torch.ops.resize import resize_bicubic

    b, t, h, w, c = hr.shape
    hs, ws = h // scale * scale, w // scale * scale
    if (hs, ws) != (h, w):
        print(f"# {name}: cropping HR {h}x{w} -> {hs}x{ws} (scale-divisible region)",
              file=sys.stderr)
        hr = hr[:, :, :hs, :ws]
    frames = torch.as_tensor(np.ascontiguousarray(hr)).reshape(b * t, hs, ws, c).to(device)
    lr = resize_bicubic(frames, (hs // scale, ws // scale))
    return hr, lr.reshape(b, t, hs // scale, ws // scale, c)


def selftest(device: str) -> int:
    """Every serving mode the acceptance uses (RealBasicVSR windowed and
    streamed, TinyVRT windowed with chunked alignment) on tiny seeded
    models and synthetic frames; passes when every PSNR is finite."""
    from vsrlab_tpu_torch.core.metrics import psnr
    from vsrlab_tpu_torch.evaluation.harness import (
        make_forward, make_stream_forward, resolve_device, windowed_inference)
    from vsrlab_tpu_torch.models import RealBasicVSR, TinyVRT
    from vsrlab_tpu_torch.nn.blocks import init_weights

    device = resolve_device(device)
    rng = np.random.default_rng(0)
    t, h, w, s = 4, 16, 16, 4
    hr = torch.from_numpy(rng.random((1, t, h * s, w * s, 3)).astype(np.float32)).to(device)
    _, lr = derive_lr("selftest", hr.cpu().numpy(), s, device)
    results = {}

    g = torch.Generator().manual_seed(0)
    rb = init_weights(RealBasicVSR(mid_channels=8, res_blocks=2, cleaning_blocks=1), g)
    sr, _ = windowed_inference(make_forward(rb, device=device), lr, 2)
    results["realbasicvsr_windowed_psnr"] = float(psnr(sr.clamp(0, 1), hr))
    sr = stream_windows(make_stream_forward(rb, device), lr, 2)
    results["realbasicvsr_streamed_psnr"] = float(psnr(sr.clamp(0, 1), hr))

    vrt = init_weights(TinyVRT(upscale=4, window_size=(2, 4, 4), depths=(1,) * 7,
                               embed_dims=(8,) * 7, num_heads=(2,) * 7, deformable_groups=2,
                               drop_path_rate=0.0, align_chunks=1), g)
    sr, _ = windowed_inference(make_forward(vrt, device=device), lr, 2)
    results["tinyvrt_chunked_align_windowed_psnr"] = float(psnr(sr.clamp(0, 1), hr))

    ok = all(np.isfinite(v) for v in results.values())
    print(json.dumps({"selftest": bool(ok), **{k: round(v, 3) for k, v in results.items()}}))
    return 0 if ok else 1


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", required=True, choices=("realbasicvsr", "vrt", "tinyvrt"))
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--scale", type=int, default=4)
    ap.add_argument("--window", type=int, default=16, help="frames per inference window")
    ap.add_argument("--bar", type=float, default=0.05,
                    help="acceptance bar in dB (north star: 0.05)")
    ap.add_argument("--published-psnr", type=float, default=None)
    ap.add_argument("--published-ssim", type=float, default=None)
    ap.add_argument("--y", action="store_true",
                    help="Y-channel (BT.601) metrics, the Vimeo / Vid4 protocol")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 compute (the serving type); the default fp32 runs with TF32 off")
    ap.add_argument("--tile", type=int, default=0,
                    help="spatial tile size for inputs whose single pass does not fit the card")
    ap.add_argument("--stream", action="store_true",
                    help="stateful windowed inference (BasicVSR family): the forward "
                         "recurrence's state carries across windows")
    ap.add_argument("--align-chunks", type=int, default=30,
                    help="VRT chunked alignment (a memory knob, the same numerics)")
    ap.add_argument("--mid-channels", type=int, default=64)
    ap.add_argument("--res-blocks", type=int, default=30)
    ap.add_argument("--cleaning-blocks", type=int, default=20)
    ap.add_argument("--max-clips", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if "--selftest" in argv:
        ap = argparse.ArgumentParser()
        ap.add_argument("--selftest", action="store_true")
        ap.add_argument("--device", default="cuda")
        return selftest(ap.parse_args(argv).device)
    args = parse_args(argv)

    checkpoint, data = Path(args.checkpoint), Path(args.data)
    if not checkpoint.exists():
        print(json.dumps({"blocked": f"checkpoint not found: {checkpoint}"}))
        return 2
    clips = list(clip_dirs(data)) if data.is_dir() else []
    if not clips:
        print(json.dumps({"blocked": f"no clip folders under: {data}"}))
        return 2
    if args.max_clips:
        clips = clips[:args.max_clips]

    from vsrlab_tpu_torch.core.metrics import psnr, psnr_y, ssim, ssim_y
    from vsrlab_tpu_torch.evaluation.harness import (
        get_video, make_forward, make_stream_forward, resolve_device, windowed_inference)

    device = resolve_device(args.device)
    model = build_model(args.model, args)
    if args.stream and not hasattr(model, "basicvsr"):
        raise SystemExit("--stream needs a recurrent model (BasicVSR family)")
    model.load_state_dict(import_state_dict(args.model, checkpoint), strict=True)
    psnr_fn, ssim_fn = (psnr_y, ssim_y) if args.y else (psnr, ssim)

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    if not args.bf16:  # fp32 means fp32: no TF32 in cuDNN's convs or in matmuls
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if args.stream:
            stream_fwd = make_stream_forward(model, device)
        else:
            forward = make_forward(model, tile=args.tile or None, device=device)
        per_clip = {}
        for name, hr_dir, lr_dir in clips:
            hr = get_video(hr_dir)
            if lr_dir is not None:
                lr = get_video(lr_dir)
            else:
                hr, lr = derive_lr(name, hr, args.scale, device)
            if args.stream:
                sr = stream_windows(stream_fwd, torch.as_tensor(lr).to(device), args.window)
            else:
                sr, _ = windowed_inference(forward, lr, args.window)
            sr = sr.float().clamp(0.0, 1.0)
            hr_t = torch.as_tensor(np.ascontiguousarray(hr[:, :sr.shape[1]])).to(sr.device)
            per_clip[name] = float(psnr_fn(sr, hr_t)), float(ssim_fn(sr, hr_t))
            print(f"# {name}: PSNR {per_clip[name][0]:.3f} SSIM {per_clip[name][1]:.4f}",
                  file=sys.stderr)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

    mean_psnr = float(np.mean([v[0] for v in per_clip.values()]))
    mean_ssim = float(np.mean([v[1] for v in per_clip.values()]))
    pub = PUBLISHED.get(args.model, {})
    pub_psnr = args.published_psnr if args.published_psnr is not None else pub.get("psnr")
    pub_ssim = args.published_ssim if args.published_ssim is not None else pub.get("ssim")

    out = {
        "model": args.model,
        "clips": len(per_clip),
        "psnr": round(mean_psnr, 4),
        "ssim": round(mean_ssim, 5),
        "metric_channel": "Y" if args.y else "RGB",
        "mode": "streamed" if args.stream else "tiled" if args.tile else "windowed",
        "bar_db": args.bar,
    }
    if pub_psnr is None:
        out["pass"] = None
        out["note"] = ("no published PSNR for this model — pass --published-psnr from a "
                       "reference-framework run")
        print(json.dumps(out))
        return 2
    out["published_psnr"] = pub_psnr
    out["delta_db"] = round(mean_psnr - pub_psnr, 4)
    if pub_ssim is not None:
        out["published_ssim"] = pub_ssim
        out["delta_ssim"] = round(mean_ssim - pub_ssim, 5)
    out["pass"] = abs(out["delta_db"]) <= args.bar
    print(json.dumps(out))
    return 0 if out["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
