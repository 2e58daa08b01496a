#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``vsrlab_tpu_torch`` on the
NVIDIA card(s) of this machine.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It prints, as the last line of standard output, one JSON object: whether
the timed path's output matched the plain reference (``correct``), the
calls made in the window (``attempted``, ``failed``), the cell's
end-to-end metrics (``--trace 0``) or per-layer metrics (``--trace 1``),
the device, and last (``checks``) each compared number beside its limit,
which also end standard error. It exits with another code and prints no
result where no card (or fewer than the cell asks for) is visible, where
the program is not this checkout's ``vsrlab_tpu_torch``, or where JAX or
the JAX package got loaded in the process of any rank.

A cell on more than one chip runs one process a card: this process is
rank 0 and starts the others (``--rank``), which meet it over TCP on
localhost. ``--fault`` plants one of the faults the comparison must catch
(for the benchmark's own checks; the measured runs never pass it).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vsrlab_tpu")
WORKER_WAIT_S = 120


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default="none")
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def cache_environment():
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_workers(args, chips: int):
    """Ranks 1..chips-1 as child processes, their standard output sent to
    standard error (the last line of standard output is rank 0's)."""
    procs = []
    for rank in range(1, chips):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--workload", args.workload,
               "--seed", str(args.seed), "--seconds", str(args.seconds), "--trace",
               str(args.trace), "--fault", args.fault, "--rank", str(rank), "--port",
               str(args.port)]
        procs.append(subprocess.Popen(cmd, stdout=sys.stderr, cwd=str(ROOT)))
    return procs


def stop_workers(procs) -> bool:
    """Wait for every worker; end any that outlives the wait. True if all
    exited with 0."""
    ok = True
    deadline = time.monotonic() + WORKER_WAIT_S
    for p in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        ok = ok and p.returncode == 0
    return ok


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    cache_environment()
    from port_bench.common import load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 3
    import vsrlab_tpu_torch

    if ROOT not in Path(vsrlab_tpu_torch.__file__).resolve().parents:
        print(f"vsrlab_tpu_torch is not this checkout's: {vsrlab_tpu_torch.__file__}",
              file=sys.stderr)
        return 3

    procs = []
    if cell.chips > 1:
        if args.rank == 0:
            args.port = free_port()
            procs = start_workers(args, cell.chips)
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(args.port),
                          RANK=str(args.rank), LOCAL_RANK=str(args.rank),
                          WORLD_SIZE=str(cell.chips), LOCAL_WORLD_SIZE=str(cell.chips))
    device = torch.device("cuda", args.rank)
    torch.cuda.set_device(device)
    try:
        from port_bench.harness import Ranks, run_cell

        if cell.chips > 1:
            from vsrlab_tpu_torch.parallel import initialize_distributed

            initialize_distributed("cuda")
        ranks = Ranks(args.rank, cell.chips, device)
        result = run_cell(cell, ranks, args.seed, args.seconds, bool(args.trace), T0, args.fault)
        if cell.chips > 1:
            torch.distributed.destroy_process_group()
    finally:
        workers_ok = stop_workers(procs)
    return finish(args.rank, result, workers_ok)


def finish(rank: int, result: dict, workers_ok: bool) -> int:
    """The exit code once the window has closed, and on rank 0 the result.
    Every rank looks for JAX and the JAX package in its own process: a
    worker that finds one exits with 4, which fails rank 0 (5)."""
    bad = forbidden_modules()
    if bad:
        print(f"rank {rank}: JAX or the JAX package was loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    if rank != 0:
        return 0
    if not workers_ok:
        print("a rank of the cell failed", file=sys.stderr)
        return 5
    print(f"card: {result['device']['kind']}, power limit {power_limit()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it, or ``not read``."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


if __name__ == "__main__":
    sys.exit(main())
