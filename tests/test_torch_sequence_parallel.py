"""The ``time`` mesh axis of vsrlab_tpu_torch on the CPU: long-clip serving
split over two gloo ranks, the mesh's layout and the placement helpers,
against the JAX package.

* Two ranks (subprocesses with torchrun's environment and ``jax`` /
  ``flax`` poisoned on their path, started once for the file) serve a
  tiny RealBasicVSR run directory through ``windowed_inference`` and
  ``run_test_matrix`` with ``create_mesh({"time": 2})``. Gates: the
  gathered result on each rank equals the JAX ``windowed_inference`` over
  ``create_mesh({"data": 4, "time": 2})`` within atol 5e-4 (fp32, as
  ``tests/test_torch_models.py``), equals bit for bit one process's
  forward of each rank's share of the windows (the same work, launch for
  launch, at one thread as the ranks run) and is within 1e-5 of one
  process's unsharded ``windowed_inference`` (the batch of every window);
  a window count that does not divide the axis (3 windows over 2 ranks)
  is padded as JAX pads it; the sweep's rows equal one process's within
  1e-5 (metrics of SR clips within 1e-5 of each other), and rank 0 alone
  writes the CSV and the frames and prints.
* ``create_mesh``'s layout and its ``-1`` inference against JAX's
  ``create_mesh`` over the test configuration's 8 virtual devices, and
  ``shard_batch_sp``'s blocks against the device shards JAX's
  ``P("data", "time")`` gives (exactly).
"""

import csv
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from vsrlab_tpu.evaluation import harness as jh  # noqa: E402
from vsrlab_tpu.models import RealBasicVSR as JRealBasicVSR  # noqa: E402
from vsrlab_tpu.parallel import create_mesh as j_create_mesh  # noqa: E402
from vsrlab_tpu.parallel import shard_batch_sp as j_shard_batch_sp  # noqa: E402
from vsrlab_tpu_torch import convert, parallel  # noqa: E402
from vsrlab_tpu_torch.data import SyntheticVSR  # noqa: E402
from vsrlab_tpu_torch.evaluation import harness  # noqa: E402
from test_torch_parallel import TIMEOUT, _free_port, _worker_env  # noqa: E402
from test_torch_vrt import _random_params  # noqa: E402

ATOL = 5e-4  # the port against JAX, fp32
SELF_ATOL = 1e-5  # the ranks against one process's batched run
RBV = {"_target_": "RealBasicVSR", "mid_channels": 8, "res_blocks": 1, "cleaning_blocks": 1}
CLIPS = {"clip8": (1, 8, 8, 8, 3), "clip5": (1, 5, 8, 8, 3)}  # 4 windows of 2; 3 padded to 4
WINDOW = 2

WORKER = r"""
import json, sys
import numpy as np, torch
from vsrlab_tpu_torch import parallel
from vsrlab_tpu_torch.evaluation import harness

root = sys.argv[1]
assert parallel.initialize_distributed("cpu")
r = parallel.process_index()
mesh = parallel.create_mesh({"time": 2})
res = {"rank": r, "shape": mesh.shape, "coords": mesh.coords, "line": mesh.axis_ranks("time"),
       "inferred": parallel.create_mesh({"data": -1, "time": 2}).shape}
model, _ = harness.load_test_model(f"{root}/run", device="cpu")
forward = harness.make_forward(model, device="cpu")
for name in ("clip8", "clip5"):
    sr, n = harness.windowed_inference(forward, np.load(f"{root}/{name}.npy"), 2, mesh)
    np.save(f"{root}/{name}_rank{r}.npy", sr.numpy())
    res[name] = n
rows = harness.run_test_matrix(f"{root}/run", f"{root}/matrix/lr", f"{root}/matrix/hr",
                               f"{root}/out{r}", window_size=2, fps_list=(6,),
                               crf_list=(30, 32), mesh=mesh, device="cpu")
res["rows"] = rows
batch = {"lr": torch.arange(2 * 4 * 3, dtype=torch.float32).reshape(2, 4, 3)}
dt = parallel.create_mesh({"data": 1, "time": 2})
res["sp"] = parallel.shard_batch_sp(batch, dt)["lr"].tolist()
res["data_index"] = (mesh.data_index, dt.data_index, parallel.create_mesh({"data": 2}).data_index)
json.dump(res, open(f"{root}/rank{r}.json", "w"))
torch.distributed.destroy_process_group()
"""


def _write_matrix(root):
    """``<root>/{lr,hr}/fps=6_crf={30,32}/{frames,video}/vid0``: a 5-frame
    32x32 clip (LR 8x8), as ``tests/test_evaluation.py`` builds one."""
    lr_clip, hr_clip = SyntheticVSR(num_videos=1, seq=5, height=32, width=32, scale=4)[0]

    def write(base, clip, size):
        frames_dir, video_dir = base / "frames" / "vid0", base / "video"
        frames_dir.mkdir(parents=True)
        video_dir.mkdir(parents=True)
        for i, f in enumerate(clip):
            cv2.imwrite(str(frames_dir / f"{i:05d}.png"),
                        (np.clip(f, 0, 1) * 255).round().astype(np.uint8)[..., ::-1])
        (video_dir / "vid0").write_bytes(b"x" * size)

    for crf, size in ((30, 1000), (32, 700)):
        write(root / "lr" / f"fps=6_crf={crf}", lr_clip, size)
    write(root / "hr" / "fps=6_crf=5", hr_clip, 4000)


@pytest.fixture(scope="module")
def jax_params():
    jmodel = JRealBasicVSR(mid_channels=8, res_blocks=1, cleaning_blocks=1)
    return jmodel, _random_params(jmodel, np.random.default_rng(7), jnp.zeros((1, 2, 8, 8, 3)))


@pytest.fixture(scope="module")
def sp_runs(tmp_path_factory, jax_params):
    """Two ranks of the worker over one run directory, its clips and a test
    matrix; returns the directory and each rank's record and output."""
    root = tmp_path_factory.mktemp("sp")
    convert.write_run_dir(root / "run", jax_params[1], {"train": {"model": RBV,
                                                                  "precision": "fp32"}})
    for i, (name, shape) in enumerate(CLIPS.items()):
        np.save(root / f"{name}.npy", np.random.default_rng(i).random(shape, np.float32))
    _write_matrix(root / "matrix")
    port = _free_port()
    procs = []
    for rank in range(2):
        env = _worker_env(root)
        env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, "-c", WORKER, str(root)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=TIMEOUT))
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate())
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"{out}\n{err}"
    records = [json.loads((root / f"rank{r}.json").read_text()) for r in range(2)]
    return root, records, [o for o, _ in outs]


class _OneThread:
    """Run the reference at one thread, as the ranks run (OMP_NUM_THREADS=1)."""

    def __enter__(self):
        self.n = torch.get_num_threads()
        torch.set_num_threads(1)

    def __exit__(self, *exc):
        torch.set_num_threads(self.n)


def _port_forward(root):
    model, _ = harness.load_test_model(str(root / "run"), device="cpu")
    return harness.make_forward(model, device="cpu")


def test_ranks_lay_out_the_time_axis(sp_runs):
    root, records, _ = sp_runs
    assert not (root / "imported").exists(), (root / "imported").read_text()
    for rank, r in enumerate(records):
        assert (r["rank"], r["shape"], r["coords"], r["line"]) == (
            rank, {"time": 2}, {"time": rank}, [0, 1])
        assert r["inferred"] == {"data": 1, "time": 2}
        assert (r["clip8"], r["clip5"]) == (4, 3)
        # the batch's frames 2 a rank, the batch axis whole (data 1)
        assert r["sp"] == torch.arange(24.0).reshape(2, 4, 3)[:, 2 * rank:2 * rank + 2].tolist()
        # the loader's shard is the rank's index on the data axis, not its rank
        assert r["data_index"] == [0, 0, rank]


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_ranks_match_jax_time_sharded(sp_runs, jax_params, name):
    """Each rank's gathered SR against the JAX harness's, sharded over
    ``create_mesh({"data": 4, "time": 2})``: atol 5e-4 (fp32)."""
    root, _, _ = sp_runs
    jmodel, params = jax_params
    video = np.load(root / f"{name}.npy")
    forward = jax.jit(lambda p, x: jmodel.apply({"params": p}, x))
    mesh = j_create_mesh({"data": 4, "time": 2})
    with mesh:
        want, n = jh.windowed_inference(forward, params, video, WINDOW, mesh)
    want = np.asarray(want)
    for rank in range(2):
        got = np.load(root / f"{name}_rank{rank}.npy")
        assert got.shape == want.shape == (1, video.shape[1], 32, 32, 3)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_ranks_equal_one_process(sp_runs, name):
    """Bitwise equal to one process's forward of each rank's share (the
    window batch padded by the last window to 4, 2 a rank), and within
    1e-5 of one process's unsharded ``windowed_inference``; both ranks hold
    the same whole result."""
    root, _, _ = sp_runs
    video = torch.from_numpy(np.load(root / f"{name}.npy"))
    forward = _port_forward(root)
    t = video.shape[1]
    n = -(-t // WINDOW)
    padded = torch.cat([video, video[:, -1:].expand(-1, n * WINDOW - t, -1, -1, -1)], 1)
    windows = padded.reshape(n, WINDOW, 8, 8, 3)
    windows = torch.cat([windows, windows[-1:].expand((-n) % 2, -1, -1, -1, -1)])
    with _OneThread():
        shares = [forward(windows[2 * k:2 * k + 2]) for k in range(2)]
        whole, _ = harness.windowed_inference(forward, video, WINDOW)
    want = torch.cat(shares)[:n].reshape(1, n * WINDOW, 32, 32, 3)[:, :t].numpy()
    got = [np.load(root / f"{name}_rank{rank}.npy") for rank in range(2)]
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_allclose(got[0], whole.numpy(), atol=SELF_ATOL, rtol=0)


def test_run_test_matrix_over_the_time_axis(sp_runs, tmp_path, capsys):
    """Both ranks return one process's rows (within 1e-5); rank 0 alone
    wrote the CSV and the frames and printed the per-video lines."""
    root, records, outs = sp_runs
    capsys.readouterr()
    rows = harness.run_test_matrix(str(root / "run"), str(root / "matrix" / "lr"),
                                   str(root / "matrix" / "hr"), str(tmp_path), window_size=2,
                                   fps_list=(6,), crf_list=(30, 32), device="cpu")
    assert "fps=6 crf=30 vid0" in capsys.readouterr().out
    for r in records:
        assert [list(row) for row in r["rows"]] == [list(row) for row in rows]
        for got, want in zip(r["rows"], rows):
            for k, v in want.items():
                assert got[k] == pytest.approx(v, abs=SELF_ATOL), k
    out0, out1 = root / "out0" / "run", root / "out1"
    with open(out0 / "run.csv") as fh:
        assert [list(map(float, row.values())) for row in csv.DictReader(fh)] == \
            [[float(v) for v in row.values()] for row in records[0]["rows"]]
    assert sorted(p.name for p in (out0 / "fps=6_crf=30" / "vid0").glob("*.png")) == \
        [f"img{i:05d}.png" for i in range(5)]
    assert not out1.exists() or not any(out1.rglob("*"))
    assert "fps=6 crf=30 vid0" in outs[0] and "fps=6" not in outs[1]


AXES = [None, 8, {"data": -1, "time": 2}, {"data": 2, "time": 2, "model": 2},
        {"time": 4, "data": -1}, {"model": 2, "data": 4}]


@pytest.mark.parametrize("axes", AXES, ids=str)
def test_mesh_layout_matches_jax(axes):
    """The port's layout of 8 ranks equals JAX's ``create_mesh`` over the 8
    virtual devices: the axes and sizes (``-1`` inferred), and each rank's
    position (JAX's device ``r`` is the port's rank ``r``)."""
    jmesh = j_create_mesh(axes)
    names, sizes = parallel.mesh_layout(axes, 8)
    assert dict(zip(names, sizes)) == dict(jmesh.shape)
    devices = jax.devices()
    for r in range(8):
        (where,) = np.argwhere(jmesh.devices == devices[r])
        assert parallel.Mesh(names, sizes, r).coords == dict(zip(names, map(int, where)))


@pytest.mark.parametrize("axes", [{"data": 4, "time": 2}, {"time": 2, "data": 4},
                                  {"data": 2, "time": 4}, {"data": 8, "time": 1}], ids=str)
def test_shard_batch_sp_matches_jax_shards(axes):
    """Each rank's block of a global ``(8, 8, 4, 4, 3)`` batch equals the
    shard JAX's ``P("data", "time")`` places on that device: the same
    slices, the same values."""
    rng = np.random.default_rng(1)
    batch = {"lr": rng.random((8, 8, 4, 4, 3), np.float32),
             "hr": rng.random((8, 8, 16, 16, 3), np.float32)}
    jmesh = j_create_mesh(axes)
    placed = j_shard_batch_sp(batch, jmesh)
    names, sizes = parallel.mesh_layout(axes, 8)
    devices = list(jax.devices())
    for key in batch:
        for shard in placed[key].addressable_shards:
            mesh = parallel.Mesh(names, sizes, devices.index(shard.device))
            index = parallel.clip_sharding(mesh).index(batch[key].shape)
            assert [s.indices(n) for s, n in zip(index, batch[key].shape)] == \
                [s.indices(n) for s, n in zip(shard.index, batch[key].shape)]
            got = parallel.shard_batch_sp(batch, mesh)[key]
            np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))
            # the trainers' loader takes the same rows: its shard is the data index
            assert parallel.shard_slice(8, mesh.size, mesh.data_index) == index[0]


def test_batch_sharding_and_one_rank_time_axis():
    """``batch_sharding`` splits axis 0 alone; a ``time`` axis of one rank
    serves the clip in one batch, as without a mesh."""
    mesh = parallel.Mesh(("data", "time"), (4, 2), 5)
    assert parallel.batch_sharding(mesh).index((8, 6, 3)) == (slice(4, 6), slice(None),
                                                              slice(None))
    assert parallel.batch_sharding(mesh, "time").index((8, 6)) == (slice(4, 8), slice(None))
    calls = []

    def forward(x):
        calls.append(x.shape[0])
        return x.repeat_interleave(2, 2).repeat_interleave(2, 3)

    video = np.random.default_rng(0).random((1, 5, 4, 4, 3), np.float32)
    one = parallel.create_mesh({"time": 1})
    sr, n = harness.windowed_inference(forward, video, 2, one)
    want, _ = harness.windowed_inference(forward, video, 2)
    assert (n, calls) == (3, [3, 3]) and torch.equal(sr, want)
