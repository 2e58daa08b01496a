"""The benchmark is driven by data: every cell, configuration, traffic mix
and metric is a file found by its name, and a new one is a new file."""

import json
import shutil

import pytest

from port_bench import common, harness

BENCH = json.loads(common.BENCHMARK_JSON.read_text())


def test_every_benchmark_entry_has_its_files():
    for c in BENCH["configs"]:
        assert (common.ROOT / c["file"]).is_file()
        assert json.loads((common.ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in BENCH["workloads"]:
        cell = common.load_cell(w["name"])
        assert cell.config_name == w["config"] and cell.traffic_name == w["traffic"]
        assert cell.chips == w["chips"] and cell.why == w["why"]
        assert (common.BENCH_DIR / "entries" / f"{cell.entry}.py").is_file()
        assert (common.BENCH_DIR / "reference" / f"{cell.config['architecture']}.py").is_file()
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert (common.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_every_benchmark_cell_is_on_disk():
    # a cell may wait on disk for its BENCHMARK.json entry
    assert {w["name"] for w in BENCH["workloads"]} <= set(common.cell_names())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_setup_and_what_its_layers_move(cell):
    metrics = {m.name: m for m in common.load_cell(cell).metrics}
    assert "setup_s" in metrics
    e2e = {n for n, m in metrics.items() if m.kind == "end_to_end"}
    assert len(e2e) >= 2
    layers = [m for m in BENCH["per_layer"] if cell in m.get("workloads", [cell])]
    assert layers
    assert all(m["moves"] in e2e for m in layers)


def test_a_new_cell_and_metric_are_new_files_only(tmp_path):
    bench = tmp_path / "port_bench"
    shutil.copytree(common.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    spec = dict(json.loads((bench / "workloads" / "rbvsr.serve.w4.json").read_text()))
    spec["why"] = "a throwaway cell"
    (bench / "workloads" / "zz.throwaway.json").write_text(json.dumps(spec))
    # a metric of a module class no reader hooked before: it names the class itself
    (bench / "metrics" / "zz_metric.py").write_text(
        'HOOKS = ("ZzBlock",)\n\n\ndef read(run):\n    return 1.0\n')
    bench_json = dict(BENCH)
    bench_json["per_layer"] = BENCH["per_layer"] + [
        {"name": "zz_metric", "unit": "%", "better": "higher", "source": "program_counter",
         "layer": "device", "moves": "frames_per_s", "workloads": ["zz.throwaway"]}]
    bench_json["workloads"] = BENCH["workloads"] + [
        {"name": "zz.throwaway", "config": spec["config"], "traffic": spec["traffic"],
         "chips": 1, "why": spec["why"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench_json))

    assert "zz.throwaway" in common.cell_names(bench)
    cell = common.load_cell("zz.throwaway", bench)
    names = [m.name for m in cell.metrics]
    assert names == ["setup_s", "zz_metric"]
    reader = [m for m in cell.metrics if m.name == "zz_metric"][0].reader
    assert common.load_module(reader).read(None) == 1.0
    assert harness.hooked_classes(cell) == ("ZzBlock",)
    after = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())


@pytest.mark.parametrize("cell,classes", [
    ("rbvsr.serve.w4", ("ResidualConv",)),
    ("vrt.serve.f16", ("WindowAttention",)),
    ("rbvsr.train.b32", ("ResidualConv",)),
    ("rbvsr.serve.time4", ("ResidualConv",)),
])
def test_the_traced_run_hooks_what_the_metrics_declare(cell, classes):
    assert harness.hooked_classes(common.load_cell(cell)) == classes


def test_module_ranges_hook_any_named_class():
    import torch

    from port_bench.trace import ModuleRanges

    class ZzBlock(torch.nn.Linear):
        pass

    model = torch.nn.Sequential(ZzBlock(3, 3), torch.nn.Linear(3, 3), ZzBlock(3, 3))
    hooks = ModuleRanges(model, ("ZzBlock",))
    model(torch.zeros(2, 3))
    hooks.remove()
    model(torch.zeros(2, 3))
    assert hooks.calls == {"ZzBlock": [((2, 3), "float32")] * 2}


def test_seeds_give_the_same_weights_and_clips():
    import torch

    shapes = {"a.weight": (4, 3, 3, 3), "a.bias": (4,), "n.weight": (4,), "n.bias": (4,)}
    one = common.seeded_params(shapes, 2**40 + 3, "cpu")
    two = common.seeded_params(shapes, 2**40 + 3, "cpu")
    other = common.seeded_params(shapes, 2**40 + 4, "cpu")
    assert all(torch.equal(one[k], two[k]) for k in shapes)
    assert not torch.equal(one["a.weight"], other["a.weight"])
    assert float(one["a.weight"].abs().max()) <= 1 / 27 ** 0.5
    assert torch.equal(one["n.weight"], torch.ones(4)) and torch.equal(one["n.bias"], torch.zeros(4))
    clips = common.make_clips((1, 2, 4, 4, 3), 2, 2**40 + 3, "t", "cpu")
    assert torch.equal(clips, common.make_clips((1, 2, 4, 4, 3), 2, 2**40 + 3, "t", "cpu"))
    assert 0.0 <= float(clips.min()) and float(clips.max()) < 1.0
