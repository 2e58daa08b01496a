"""What every part of the benchmark shares: finding a cell's files by name,
seeds, the weights and clips made from a seed, and loading a module of
``port_bench`` by its file path.

A cell is ``workloads/<cell>.json``: its configuration's name (a file
``configs/<config>.json``), its traffic mix's name (``traffic/<traffic>.json``),
its entry kind (``entries/<kind>.py``), the chips it takes, its ``why``
and the limits of its comparison (``check``). Which metrics it reports
comes from ``BENCHMARK.json`` at the checkout's root; each metric's reader
is ``metrics/<metric>.py``.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional, Sequence, Tuple

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
BENCHMARK_JSON = ROOT / "BENCHMARK.json"


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """Import the Python file ``path`` (its name may hold dots, as metric names do)."""
    name = "port_bench._loaded." + path.stem.replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Metric:
    name: str
    unit: str
    kind: str  # "end_to_end" or "per_layer"
    reader: Path


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    entry: str
    chips: int
    why: str
    config: dict
    traffic: dict
    check: dict
    metrics: List[Metric] = field(default_factory=list)

    def entry_module(self) -> ModuleType:
        return load_module(BENCH_DIR / "entries" / f"{self.entry}.py")

    def reference_module(self) -> ModuleType:
        return load_module(BENCH_DIR / "reference" / f"{self.config['architecture']}.py")


def cell_names(bench_dir: Path = BENCH_DIR) -> List[str]:
    return sorted(p.name[:-len(".json")] for p in (bench_dir / "workloads").glob("*.json"))


def _metrics_for(cell: str, bench: dict, bench_dir: Path) -> List[Metric]:
    """The metrics that ``BENCHMARK.json`` has this cell report: each that lists
    it under ``workloads``, or that lists none."""
    out = []
    for kind in ("end_to_end", "per_layer"):
        for m in bench.get(kind, []):
            if cell in m.get("workloads", [cell]):
                out.append(Metric(m["name"], m["unit"], kind,
                                  bench_dir / "metrics" / f"{m['name']}.py"))
    return out


def load_cell(name: str, bench_dir: Path = BENCH_DIR,
              benchmark_json: Optional[Path] = None) -> Cell:
    w = read_json(bench_dir / "workloads" / f"{name}.json")
    bench_path = benchmark_json or (bench_dir.parent / "BENCHMARK.json")
    bench = read_json(bench_path) if bench_path.exists() else {}
    return Cell(name=name, config_name=w["config"], traffic_name=w["traffic"],
                entry=w["entry"], chips=int(w["chips"]), why=w["why"],
                config=read_json(bench_dir / "configs" / f"{w['config']}.json"),
                traffic=read_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
                check=w.get("check", {}), metrics=_metrics_for(name, bench, bench_dir))


def derive_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one stream of the run (weights, clips, sampling),
    the same for the same ``seed`` and tags."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def default_fan_in(name: str, shape: Sequence[int]) -> int:
    """Inputs per output of an OIHW conv or (out, in) linear weight."""
    return int(math.prod(shape[1:]))


def seeded_params(shapes: Dict[str, Tuple[int, ...]], seed: int, device,
                  fan_in: Callable[[str, Sequence[int]], int] = default_fan_in,
                  table_bound: float = 0.04) -> Dict:
    """Weights for every parameter in ``shapes`` from ``seed``, in fp32 on
    ``device``: one uniform draw on the device for all of them, cut into
    leaves. A weight and its bias are uniform in +-1/sqrt(fan in) (PyTorch's
    default for convs and linears, as the program draws them); a 1-D weight
    (a LayerNorm's scale) is one and its bias zero; a relative-position bias
    table is uniform in +-``table_bound``."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, "weights"))
    drawn = [n for n, s in shapes.items() if not _is_norm(n, shapes)]
    total = sum(math.prod(shapes[n]) for n in drawn)
    flat = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for name, shape in shapes.items():
        if _is_norm(name, shapes):
            fill = 1.0 if name.endswith(".weight") else 0.0
            out[name] = torch.full(shape, fill, device=device)
            continue
        n = math.prod(shape)
        if name.endswith("relative_position_bias_table"):
            bound = table_bound
        else:
            wname = name[:-len("bias")] + "weight" if name.endswith(".bias") else name
            bound = 1.0 / math.sqrt(fan_in(wname, shapes[wname]))
        out[name] = flat[at:at + n].view(shape).mul_(bound)
        at += n
    return out


def _is_norm(name: str, shapes: Dict) -> bool:
    base = name.rsplit(".", 1)[0]
    w = shapes.get(f"{base}.weight")
    return w is not None and len(w) == 1 and name.rsplit(".", 1)[1] in ("weight", "bias")


def make_clips(shape: Sequence[int], count: int, seed: int, tag: str, device):
    """``count`` clips of ``shape`` uniform in [0, 1) from ``seed``, drawn on
    ``device`` in one call."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, "clips", tag))
    return torch.rand((count, *shape), generator=gen, device=device)


def percentile(values: Sequence[float], pct: float) -> float:
    """The ``pct`` percentile of ``values`` by linear interpolation between
    the closest ranks."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    k = (len(v) - 1) * pct / 100.0
    lo = math.floor(k)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (k - lo)
