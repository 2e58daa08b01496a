"""Each cell's comparison fails what it must fail. A run is driven past the
harness's look for a card (on the CPU, in float32, at tiny widths and
sizes, with the cell's own limits) with the timed path broken underneath:
``correct`` must come out false for every fault the cell can have, and
true without one. The control (the reference computed in float8 in the
program's place) is one of them."""

import copy
import json
import os
import socket
import time

import pytest
import torch

from port_bench.common import load_cell
from port_bench.harness import Ranks, run_cell

TINY = {
    "realbasicvsr_c64b20": {"mid_channels": 16, "res_blocks": 2, "cleaning_blocks": 2},
    "vrt_reds_6f": {"depths": [2] * 13, "embed_dims": [12] * 7 + [18] * 6,
                    "num_heads": [2] * 13, "deformable_groups": 2},
}
SMALL = {
    "rbvsr.serve.w4": {"frames": 8, "height": 32, "width": 48, "window": 4},
    "vrt.serve.f16": {"frames": 6, "height": 64, "width": 64, "pool": 2},
    "rbvsr.train.b32": {"batch": 8, "frames": 3, "height": 32, "width": 32,
                        "reference_rows": 4},
    "rbvsr.serve.time4": {"frames": 10, "height": 16, "width": 24, "window": 2},
}
SEED = 2**33 + 17


def tiny_cell(name):
    cell = load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["precision"] = "fp32"
    cell.config["model"].update(TINY[cell.config_name])
    cell.traffic = {**cell.traffic, **SMALL[name]}
    return cell


def one_rank(name, fault):
    torch.manual_seed(0)
    return run_cell(tiny_cell(name), Ranks(0, 1, torch.device("cpu")), SEED, 0.3, False,
                    time.perf_counter(), fault)


CASES = [("rbvsr.serve.w4", f) for f in ("none", "alter", "control")] + \
        [("vrt.serve.f16", f) for f in ("none", "alter", "control")] + \
        [("rbvsr.train.b32", f) for f in ("none", "stale", "half_batch", "control", "fp32")]


@pytest.mark.parametrize("name,fault", CASES)
def test_one_chip_cells(name, fault):
    out = one_rank(name, fault)
    checks = {k: (v["value"], v["limit"]) for k, v in out["checks"].items()}
    assert out["correct"] == (fault in ("none", "fp32")), checks  # fp32 is a witness


def _rank(rank, world, port, fault, q):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_WORLD_SIZE=str(world))
    from vsrlab_tpu_torch.parallel import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed("cpu")
    try:
        out = run_cell(tiny_cell("rbvsr.serve.time4"), Ranks(rank, world, torch.device("cpu")),
                       SEED, 0.3, False, time.perf_counter(), fault)
        if rank == 0:
            q.put(json.dumps(out))
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("fault", ["none", "exchange", "alter"])
def test_four_ranks_over_gloo(fault):
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, 4, port, fault, q)) for r in range(4)]
    for p in procs:
        p.start()
    try:
        out = json.loads(q.get(timeout=240))
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs)
    checks = {k: (v["value"], v["limit"]) for k, v in out["checks"].items()}
    assert out["correct"] == (fault == "none"), checks
