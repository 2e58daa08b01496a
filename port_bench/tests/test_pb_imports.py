"""What the benchmark loads: never JAX, jaxlib, flax or the JAX package
(compared by whole top-level names: ``vsrlab_tpu_torch`` is the program,
``vsrlab_tpu`` is not), and a reference that imports nothing of the
program."""

import ast
import json
import subprocess
import sys

import pytest

from port_bench import common

FORBIDDEN = ("jax", "jaxlib", "flax", "vsrlab_tpu")


def test_nothing_the_run_loads_is_jax_or_the_jax_package():
    code = f"""
import sys, json
sys.path.insert(0, {str(common.ROOT)!r})
sys.argv = ["run.py"]
from port_bench import common, harness, program, serving, trace, work, readers
import port_bench.run
import vsrlab_tpu_torch.evaluation.harness, vsrlab_tpu_torch.train.step
import vsrlab_tpu_torch.train.builders, vsrlab_tpu_torch.parallel
for kind in ("entries", "metrics", "reference"):
    for p in sorted((common.BENCH_DIR / kind).glob("*.py")):
        common.load_module(p)
for name in common.cell_names():
    cell = common.load_cell(name)
    cell.entry_module(); cell.reference_module()
    mod, cls = cell.config["program"]["class"].rsplit(".", 1)
    __import__(mod)
print(json.dumps(sorted(sys.modules)))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=str(common.ROOT))
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "vsrlab_tpu_torch" in loaded
    bad = sorted({m for m in loaded if m.split(".")[0] in FORBIDDEN})
    assert not bad, bad


def test_the_run_refuses_what_it_finds_loaded(monkeypatch):
    sys.path.insert(0, str(common.BENCH_DIR))
    import port_bench.run as run

    monkeypatch.setitem(sys.modules, "vsrlab_tpu.models", object())
    assert run.forbidden_modules() == ["vsrlab_tpu.models"]
    monkeypatch.delitem(sys.modules, "vsrlab_tpu.models")
    assert run.forbidden_modules() == []


RESULT = {"correct": True, "device": {"kind": "a card"}, "checks": {"gap": {"value": 0.1,
                                                                         "limit": 1.0}}}


@pytest.mark.parametrize("rank,loaded,workers_ok,code", [
    (1, "jax", True, 4),  # a worker that finds JAX fails, so rank 0 sees a failed rank
    (2, "vsrlab_tpu.models", True, 4),
    (1, None, True, 0),
    (0, None, False, 5),  # a worker failed: no result
    (0, "flax", True, 4),
    (0, None, True, 0),
])
def test_every_rank_refuses_what_it_finds_loaded(monkeypatch, capsys, rank, loaded,
                                                 workers_ok, code):
    import port_bench.run as run

    monkeypatch.setattr(run, "power_limit", lambda: "700.00 W")
    if loaded:
        monkeypatch.setitem(sys.modules, loaded, object())
    assert run.finish(rank, RESULT if rank == 0 else {}, workers_ok) == code
    out = capsys.readouterr()
    assert (out.out.strip() == json.dumps(RESULT)) == (rank == 0 and code == 0), out.out
    if loaded:
        assert loaded in out.err


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((common.BENCH_DIR / "reference").glob("*.py"))
    assert files
    for path in files:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"vsrlab_tpu_torch", *FORBIDDEN}, (path.name, tops)
        assert tops <= {"torch", "math", "typing", "port_bench", "__future__", "numpy"}, tops


def test_no_file_of_the_benchmark_imports_jax():
    for path in common.BENCH_DIR.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(FORBIDDEN), path
