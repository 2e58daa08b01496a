"""On the card: each cell's control, the reference computed in float8 in the
program's place, run at the cell's own size through ``run.py`` on three
seeds, comes out not correct. Needs a card with the cell's chips."""

import json
import subprocess
import sys

import pytest

from port_bench import common

CELLS = common.cell_names()
SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    import torch

    if torch.cuda.device_count() < common.load_cell(cell).chips:
        pytest.skip(f"{cell} needs more cards")
    for seed in SEEDS:
        out = subprocess.run([sys.executable, str(common.BENCH_DIR / "run.py"), "--workload",
                              cell, "--seed", str(seed), "--seconds", "2", "--trace", "0",
                              "--fault", "control"], capture_output=True, text=True,
                             cwd=str(common.ROOT), timeout=900, check=True)
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is False
