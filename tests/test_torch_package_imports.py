"""The port stands alone: no module of vsrlab_tpu_torch, and not
chip_smoke.py, imports jax, flax or vsrlab_tpu (checked on the sources,
without importing them)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "vsrlab_tpu"}
SOURCES = sorted((ROOT / "vsrlab_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_sources_exist():
    assert (ROOT / "chip_smoke.py").is_file()
    assert len(SOURCES) > 10
    # the training, serving, GAN, flow and data-parallel slices' modules are
    # among those checked
    for module in ("components.py", "core/config.py", "core/checkpoint.py", "data/datasets.py",
                   "data/loader.py", "train/train.py", "train/step.py", "utils/seed.py",
                   "data/video_io.py", "evaluation/harness.py", "evaluation/upscale.py",
                   "evaluation/params_bench.py", "evaluation/export.py", "utils/profiler.py",
                   "convert.py", "core/losses.py", "core/perceptual.py",
                   "models/unet_discriminator.py", "data/codec_emulator.py",
                   "data/augmentations.py", "train/gan.py",
                   # the flow slice's
                   "ops/correlation.py", "models/flow/raft.py", "models/flow/irr.py",
                   "models/flow/spynet_progressive.py", "train/spynet.py",
                   "data/flow_dataset.py", "data/create_flow_dataset.py",
                   # the data-parallel slice's
                   "parallel/__init__.py", "parallel/mesh.py",
                   # the time / model axes and the host data core
                   "evaluation/harness.py", "models/vrt/window_attention.py",
                   "models/vrt/tmsa.py", "models/vrt/stage.py", "models/vrt/vrt.py",
                   "data/native.py", "build.py"):
        assert ROOT / "vsrlab_tpu_torch" / module in SOURCES, module


def test_host_library_source_is_the_ports_own():
    """The C++ the port builds lives under ``vsrlab_tpu_torch/csrc``: a file
    of its own (no link into the JAX package), which ``build.load_host``
    compiles; the JAX package's source stays where it was."""
    from vsrlab_tpu_torch import build

    src = ROOT / "vsrlab_tpu_torch" / "csrc" / "vsrio.cpp"
    assert src.is_file() and not src.is_symlink()
    assert build.CSRC == src.parent
    text = src.read_text()
    assert "vsrio_codec_degrade" in text and "#ifdef VSRIO_OPENCV" in text
    assert "vsrlab_tpu/" not in text.replace("vsrlab_tpu_torch/", "")
    assert (ROOT / "vsrlab_tpu" / "native" / "vsrio.cpp").is_file()


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_vsrlab_tpu_import(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
