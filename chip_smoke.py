#!/usr/bin/env python3
"""Smoke run of vsrlab_tpu_torch (the PyTorch / CUDA port) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Device and build: the card's name and power limit (``nvidia-smi``), then
   the residual-pair kernels built from ``vsrlab_tpu_torch/csrc`` (nvcc,
   sm_90a) into ``build/kernels/``.
2. Kernels against their plain version: both residual-pair kernels
   (``taps``, ``im2col``) against ``residual_conv_pair_plain`` at
   ``(1,180,320,64)`` (a recurrence step), ``(10,180,320,64)`` (the
   cleaner) and a ragged ``(2,13,21,64)``; fp32 with TF32 off at 1e-4,
   bf16 at 2e-2 (``|a-b| <= tol + tol*|b|``).
3. The main path: RealBasicVSR 4x at the headline configuration (mid 64,
   30 residual blocks, 20 cleaning blocks, 3 steps, bf16), weights from a
   seeded ``torch.Generator``, serving 180x320 -> 720x1280 requests through
   the harness: ``windowed_inference`` on a 20-frame clip (two 10-frame
   windows as one batch), then ``make_stream_forward`` ``first`` (taps)
   and ``rest`` (im2col) on two consecutive windows. The wrappers count
   their launches by input shape over these three calls; each call must
   make 660 residual-pair launches. Then shapes and finite values, each
   window's kernel output against the plain version's and an fp32 run
   (``rest`` with the state ``first`` returned; gate: twice the plain bf16
   run's deviation from fp32), the frames/s of a 10-frame and a 20-frame
   request, and a torch.profiler breakdown of the 10-frame one.
4. Each kernel at every input shape the main path gave it: bf16 against
   the plain version (2e-2), then its time, the plain version's and one
   library call's (two bf16 channels_last ``F.conv2d`` plus ReLU and the
   add; timed only), with CUDA events, median of 20 samples after warm-up.
5. One JSON line ``{"kernels": [...]}``: per kernel its main-path launches
   and, summed over those launches (per-launch time at each shape times
   that shape's count), ``ms``, ``plain_ms``, ``library_ms`` and
   ``bound_ms``; ``max_abs_err`` is the largest bf16 error, beside
   ``max_abs_err_fp32``; ``shapes`` holds the per-launch rows. Then the
   last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

CHECK_SHAPES = ((1, 180, 320, 64), (10, 180, 320, 64), (2, 13, 21, 64))
TOL = {"fp32": 1e-4, "bf16": 2e-2}
# residual pairs per forward of one 10-frame window: 2 directions x 10
# steps x 30 blocks, and 3 cleaning steps x 20 blocks
LAUNCHES_PER_FORWARD = 660
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
KERNELS = {
    "taps": ("residual_conv_pair", "vsrlab_tpu/ops/pallas_conv.py:86"),
    "im2col": ("residual_conv_pair_im2col", "vsrlab_tpu/ops/pallas_conv.py:185"),
}
SOURCE = "vsrlab_tpu_torch/csrc/residual_pair.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def pair_operands(shape, dtype, seed, device):
    """x ~ N(0, 1); weights and biases at torch's default conv init scale."""
    import torch

    g = torch.Generator().manual_seed(seed)
    c = shape[-1]
    bound = 1.0 / (9 * c) ** 0.5
    x = torch.randn(shape, generator=g)
    w1, w2 = ((torch.rand((3, 3, c, c), generator=g) * 2 - 1) * bound for _ in range(2))
    b1, b2 = ((torch.rand((c,), generator=g) * 2 - 1) * bound for _ in range(2))
    return (x.to(device, dtype), w1.to(device, dtype), b1.to(device),
            w2.to(device, dtype), b2.to(device))


def cuda_ms(fn, reps: int, samples: int = 20, warmup: int = 3) -> float:
    """Median ms of one ``fn()`` over ``samples`` event-timed runs of ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(shape) -> tuple[float, str]:
    """Least time (ms) for one bf16 pair: FLOPs over peak vs bytes over HBM rate."""
    b, h, w, c = shape
    flops = 2 * (2 * b * h * w * c * c * 9)
    nbytes = 2 * b * h * w * c * 2 + 2 * 9 * c * c * 2 + 2 * c * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_pair(fn, ops, tol, label) -> float:
    """max |fn - plain| on ``ops``; raises beyond ``tol + tol*|plain|``."""
    import torch

    from vsrlab_tpu_torch.ops.residual_pair import residual_conv_pair_plain

    got, want = fn(*ops).float(), residual_conv_pair_plain(*ops).float()
    err = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool((err <= tol + tol * want.abs()).all())
    e = float(err.max())
    log(f"  {label}: max|kernel-plain| = {e:.3e} (tol {tol} + {tol}*|plain|) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} disagrees with the plain version")
    return e


def check_kernels(device):
    """Phase 2. Returns ``{formulation: {"fp32": err, "bf16": err}}``."""
    import torch

    from vsrlab_tpu_torch.ops.residual_pair import PAIR_IMPLS

    errs = {}
    for form in KERNELS:
        errs[form] = {}
        for dname, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            errs[form][dname] = max(
                check_pair(PAIR_IMPLS[form], pair_operands(shape, dtype, i, device),
                           TOL[dname], f"{form:6s} {dname} {shape}")
                for i, shape in enumerate(CHECK_SHAPES))
    return errs


def time_kernel(form, launches_by_shape, device):
    """Phase 4 for one kernel: at each shape the main path gave it, a bf16
    check against the plain version and per-launch times. Returns the
    largest error and one row per shape."""
    import torch
    import torch.nn.functional as F

    from vsrlab_tpu_torch.ops.residual_pair import PAIR_IMPLS, residual_conv_pair_plain

    fn, err, rows = PAIR_IMPLS[form], 0.0, []
    for shape, n in sorted(launches_by_shape.items()):
        x, w1, b1, w2, b2 = ops = pair_operands(shape, torch.bfloat16, 7, device)
        err = max(err, check_pair(fn, ops, TOL["bf16"], f"{form:6s} bf16 {shape}"))
        xc = x.permute(0, 3, 1, 2)  # channels_last NCHW view
        wc1, wc2 = (w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                    for w in (w1, w2))
        bb1, bb2 = b1.bfloat16(), b2.bfloat16()

        def library():
            return xc + F.conv2d(torch.relu(F.conv2d(xc, wc1, bb1, padding=1)), wc2, bb2,
                                 padding=1)

        reps = 10 if shape[0] < 10 else 3
        b_ms, b_by = bound(shape)
        row = {
            "shape": list(shape),
            "launches": n,
            "ms": cuda_ms(lambda: fn(*ops), reps),
            "plain_ms": cuda_ms(lambda: residual_conv_pair_plain(*ops), reps),
            "library_ms": cuda_ms(library, reps),
            "bound_ms": b_ms,
            "bound_by": b_by,
        }
        rows.append(row)
        log(f"  {form:6s} bf16 {shape} x{n}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
    return err, rows


def profile_request(request, wall_s: float, top: int = 12) -> dict:
    """Device time of one ``request()`` by kernel (``torch.profiler``), its
    share of ``wall_s`` (the request's unprofiled time) and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        request()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total / 1e3
    total = sum(kernels.values())
    if total == 0:
        return {"device_ms": "not measured (the profiler saw no device time)"}
    pair = sum(v for k, v in kernels.items() if "pair_taps" in k or "pair_im2col" in k)
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    return {
        "wall_ms": wall_s * 1e3,
        "device_ms": total,
        "device_busy_share": total / (wall_s * 1e3),
        "residual_pair_ms": pair,
        "top": [{"kernel": k[:90], "ms": v, "share": v / total} for k, v in ranked],
    }


def build_model(dtype):
    import torch

    from vsrlab_tpu_torch.models import RealBasicVSR
    from vsrlab_tpu_torch.nn.blocks import init_weights

    model = RealBasicVSR(mid_channels=64, res_blocks=30, cleaning_blocks=20,
                         cleaning_steps=3, dtype=dtype)
    return init_weights(model, torch.Generator().manual_seed(0))


def run_main_path(model, clip, device):
    """Phase 3's served requests: one windowed forward over ``clip``
    ``(1, 2*10, H, W, 3)`` (two windows as one batch), then ``first`` (taps)
    and ``rest`` (im2col) on its two windows. Returns the outputs, the
    state ``first`` passed to ``rest``, and each kernel's launches by input
    shape, per call and over the three."""
    from vsrlab_tpu_torch.evaluation.harness import (
        make_forward, make_stream_forward, windowed_inference)
    from vsrlab_tpu_torch.nn.blocks import set_pair_impl
    from vsrlab_tpu_torch.ops.residual_pair import (
        PAIR_IMPLS, reset_launch_counts)

    def counts():
        return {form: PAIR_IMPLS[form].launches_by_shape.copy() for form in KERNELS}

    calls = {}
    set_pair_impl(model, "taps")
    reset_launch_counts()
    seen = counts()
    sr_windowed, n_windows = windowed_inference(make_forward(model, device), clip, 10)
    now = counts()
    calls["windowed"], seen = {f: now[f] - seen[f] for f in KERNELS}, now
    first, rest = make_stream_forward(model, device)
    sr_first, state = first(clip[:, :10])
    now = counts()
    calls["first"], seen = {f: now[f] - seen[f] for f in KERNELS}, now
    set_pair_impl(model, "im2col")
    sr_rest, _ = rest(clip[:, 10:], state)
    now = counts()
    calls["rest"], seen = {f: now[f] - seen[f] for f in KERNELS}, now
    set_pair_impl(model, "taps")
    return {"windowed": sr_windowed, "first": sr_first, "rest": sr_rest, "state": state,
            "n_windows": n_windows, "calls": calls, "launches_by_shape": seen}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA GPU",
              file=sys.stderr)
        return 1
    from vsrlab_tpu_torch.build import load
    from vsrlab_tpu_torch.evaluation.harness import (
        make_forward, make_stream_forward, windowed_inference)
    from vsrlab_tpu_torch.nn.blocks import set_pair_impl

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    log("phase 1: device and build")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(card)
    lib = load("residual_pair")
    log(f"  kernels built in {lib.build_seconds:.1f} s -> {lib.path.name}")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    log("phase 2: kernels against their plain version")
    errs = check_kernels(device)

    log("phase 3: main path (RealBasicVSR 4x, mid 64, 30+20 blocks, bf16)")
    model = build_model(torch.bfloat16)
    g = torch.Generator().manual_seed(1)
    clip = torch.rand((1, 20, 180, 320, 3), generator=g)
    t0 = time.perf_counter()
    res = run_main_path(model, clip, device)
    torch.cuda.synchronize()
    log(f"  served 3 requests in {time.perf_counter() - t0:.2f} s (first use included)")
    expect = {"windowed": (1, 20, 720, 1280, 3), "first": (1, 10, 720, 1280, 3),
              "rest": (1, 10, 720, 1280, 3)}
    for name, shape in expect.items():
        out = res[name]
        if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name}: shape {tuple(out.shape)} (want {shape}) or non-finite")
        log(f"  {name}: {tuple(out.shape)} finite, range [{float(out.min()):.3f}, "
            f"{float(out.max()):.3f}]")
    # each call runs one formulation: taps for windowed and first, im2col for rest
    uses = {"windowed": "taps", "first": "taps", "rest": "im2col"}
    for name, form in uses.items():
        by_shape = res["calls"][name]
        log(f"  {name} launches by input shape: "
            + ", ".join(f"{f} {dict(c)}" for f, c in by_shape.items()))
        totals = {f: sum(c.values()) for f, c in by_shape.items()}
        want = {f: LAUNCHES_PER_FORWARD if f == form else 0 for f in KERNELS}
        if totals != want:
            raise AssertionError(f"{name}: launches {totals} != {want}")
    if res["n_windows"] != 2:
        raise AssertionError(f"{res['n_windows']} windows != 2")

    # each window of the stream through the plain pair (rest from the same
    # state as the kernel's rest), and in fp32 (TF32 off)
    windows = (clip[:, :10], clip[:, 10:])
    set_pair_impl(model, "plain")
    first, rest = make_stream_forward(model, device)
    plain = (first(windows[0])[0].float(), rest(windows[1], res["state"])[0].float())
    set_pair_impl(model, "taps")
    model32 = build_model(None)
    model32.load_state_dict(model.state_dict())
    set_pair_impl(model32, "plain")
    first, rest = make_stream_forward(model32, device)
    ref0, state32 = first(windows[0])
    ref32 = (ref0.float(), rest(windows[1], state32)[0].float())

    def dev(a, b):
        d = (a - b).abs()
        return float(d.max()), float(d.pow(2).mean().sqrt())

    # gate: a path as accurate as the plain bf16 one lies within (plain vs
    # fp32) of fp32, so two such paths lie within twice that of each other
    taps, im2col = res["first"].float(), res["rest"].float()
    cases = (
        (0, "taps vs plain (bf16)", taps, plain[0]),
        (0, "taps vs fp32", taps, ref32[0]),
        (0, "windowed (batch 2) vs first (batch 1)", res["windowed"][:, :10].float(), taps),
        (1, "im2col vs plain (bf16)", im2col, plain[1]),
        (1, "im2col vs fp32", im2col, ref32[1]),
    )
    gates = [dev(plain[i], ref32[i]) for i in range(2)]
    for i, (b_max, b_rms) in enumerate(gates):
        log(f"  window {i}: plain bf16 vs fp32: max {b_max:.4e}, rms {b_rms:.4e}; gate: 2x that")
    for i, name, a, b in cases:
        b_max, b_rms = gates[i]
        d_max, d_rms = dev(a, b)
        log(f"  window {i}: {name}: max {d_max:.4e} ({d_max / b_max:.2f}x), rms {d_rms:.4e} "
            f"({d_rms / b_rms:.2f}x)")
        if not (d_max <= 2 * b_max and d_rms <= 2 * b_rms):
            raise AssertionError(f"{name} deviates by more than twice bf16's own deviation")

    forward = make_forward(model, device)
    requests = {
        "clip10": (10, lambda: forward(windows[0])),
        "windowed20": (20, lambda: windowed_inference(forward, clip, 10)),
    }
    fps = {}
    for name, (frames, request) in requests.items():
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            request()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        fps[name] = frames / statistics.median(times)
    log(f"  frames/s on {card}: 10-frame clip {fps['clip10']:.2f}, "
        f"20-frame clip as 2 windows {fps['windowed20']:.2f} (median of 5, host clock, "
        "input upload included)")
    log(json.dumps({"fps": fps, "card": card}))
    log(json.dumps({"profile_clip10": profile_request(requests["clip10"][1],
                                                      10 / fps["clip10"])}))

    log("phase 4: each kernel at the main path's shapes")
    kernels = []
    for form, (name, replaces) in KERNELS.items():
        err, rows = time_kernel(form, res["launches_by_shape"][form], device)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": sum(r["launches"] for r in rows),
            "max_abs_err": max(err, errs[form]["bf16"]),
            "max_abs_err_fp32": errs[form]["fp32"],
            **{k: sum(r[k] * r["launches"] for r in rows)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
            "bound_by": "operations" if all(r["bound_by"] == "operations"
                                            for r in rows) else "bytes",
            "shapes": rows,
        })
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
