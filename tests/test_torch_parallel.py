"""Data parallelism in vsrlab_tpu_torch (``vsrlab_tpu_torch.parallel`` and
the three trainers) on the CPU, with gloo.

* The primitives in one process (a world of one) and in two processes
  that join one gloo group through torchrun's environment: the flat
  all-reduce of gradients and metrics, the broadcast from rank 0, the
  replica check, the ``Updater`` averaging before the clip.
* Each trainer (supervised, GAN, SpyNet) under ``python -m
  torch.distributed.run --nproc_per_node 2`` at the size of the
  synthetic experiments, each rank in a directory of its own (relative
  storage paths), with ``jax`` and ``flax`` poisoned on the workers'
  path. Gates: both ranks end bitwise equal (the trainers check it with a
  broadcast after every epoch and raise otherwise, so a clean exit shows
  it), rank 0's checkpoints equal a one-process run's on the same global
  batches within atol 2e-5, rank 1 wrote no checkpoint, log or line of
  output, and the supervised run's first loss equals the JAX
  data-parallel step's (``create_mesh(2)`` on the test configuration's
  virtual CPU devices) within rtol 1e-5.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import vsrlab_tpu.components  # noqa: E402,F401
from vsrlab_tpu.models import RealBasicVSR as JRealBasicVSR  # noqa: E402
from vsrlab_tpu.parallel import create_mesh as j_create_mesh  # noqa: E402
from vsrlab_tpu.parallel import replicated as j_replicated  # noqa: E402
from vsrlab_tpu.parallel import shard_batch as j_shard_batch  # noqa: E402
from vsrlab_tpu.train import builders as jbuilders  # noqa: E402
from vsrlab_tpu.train.state import create_train_state as j_create  # noqa: E402
from vsrlab_tpu.train.step import make_supervised_train_step as j_make_step  # noqa: E402
from vsrlab_tpu_torch import convert, parallel  # noqa: E402
from vsrlab_tpu_torch.core.checkpoint import CheckpointManager  # noqa: E402
from vsrlab_tpu_torch.core.config import load_config  # noqa: E402
from vsrlab_tpu_torch.train import gan, spynet  # noqa: E402
from vsrlab_tpu_torch.train import train as trainer  # noqa: E402
from vsrlab_tpu_torch.train.builders import build_loaders, build_tx  # noqa: E402
from test_torch_vrt import _random_params  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 240

# the trainers at the synthetic experiments' sizes, fp32; the supervised
# run starts from the JAX init's parameters (restore + finetune) and takes
# one step an epoch, the GAN's first epoch keeps G frozen (freeze_epochs 0).
# SGD with momentum in place of the configs' Adam: Adam's first steps move
# a parameter whose gradient is ~0 by up to lr either way, so the rounding
# of the all-reduce against one process's sum would show as lr-sized
# differences (a SpyNet head's bias moved by 3e-5 with Adam at 1e-4)
SGD = "{_target_: sgd, lr: 0.01, momentum: 0.9}"
RUNS = {
    "train": ("vsrlab_tpu_torch.train.train", [
        "+experiment=synthetic", "train.precision=fp32", "train.max_epochs=2",
        "train.ema_decay=0.9", "train.data.datasets.train.num_videos=4",
        "train.finetune=true", f"train.optimizer={SGD}"]),
    "gan": ("vsrlab_tpu_torch.train.gan", [
        "+experiment=synthetic_gan", "train.ddp=true", "train.precision=fp32",
        "train.max_epochs=2", f"train.optimizer.generator={SGD}",
        f"train.optimizer.discriminator={SGD}"]),
    "spynet": ("vsrlab_tpu_torch.train.spynet", [
        "+experiment=synthetic_spynet", "train.ddp=true", "train.k=2", "train.max_epochs=1",
        f"train.optimizer={SGD}"]),
}
# what a rank's standard output shows of each trainer's epochs
PROGRESS = {"train": "epoch 0:", "gan": "epoch 1:", "spynet": "level 1 epoch 0:"}


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _poisoned_path(root: Path) -> str:
    """A ``PYTHONPATH`` whose ``jax`` and ``flax`` note the import in
    ``root/imported`` and raise: the workers must import neither."""
    for name in ("jax", "flax"):
        pkg = root / "poison" / name
        pkg.mkdir(parents=True, exist_ok=True)
        (pkg / "__init__.py").write_text(
            f"open({str(root / 'imported')!r}, 'a').write('{name}\\n')\n"
            f"raise ImportError('the port imported {name}')\n")
    return f"{root / 'poison'}{os.pathsep}{REPO}"


def _worker_env(root: Path) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "RANK", "WORLD_SIZE", "LOCAL_", "MASTER_"))}
    env["PYTHONPATH"] = _poisoned_path(root)
    env["OMP_NUM_THREADS"] = "1"
    return env


def _launch(root: Path, module: str, overrides) -> subprocess.Popen:
    """torchrun with two ranks, each in ``root/rank{i}`` with its output in
    ``out.txt`` there."""
    for i in range(2):
        (root / f"rank{i}").mkdir(parents=True, exist_ok=True)
    script = (f'cd "{root}/rank$LOCAL_RANK" && exec "{sys.executable}" -m {module} "$@" '
              '> out.txt 2>&1')
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_port", str(_free_port()), "--no-python", "sh", "-c", script, "sh",
           *overrides, "device=cpu", "core.storage_dir=run", "train.logger.save_dir=logs"]
    return subprocess.Popen(cmd, cwd=root, env=_worker_env(root), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _latest(directory: Path) -> dict:
    return CheckpointManager(str(directory)).restore()[1]["params"]


def _files(root: Path, name: str) -> list:
    return sorted(p for p in root.rglob(name))


@pytest.fixture(scope="module")
def jax_params():
    """Parameters drawn with numpy over the JAX ``init``'s shapes (no init
    program is compiled)."""
    jmodel = JRealBasicVSR(mid_channels=8, res_blocks=1, cleaning_blocks=1)
    return jmodel, _random_params(jmodel, np.random.default_rng(5), jnp.zeros((1, 3, 32, 32, 3)))


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory, jax_params):
    """The three trainers: two ranks each under torchrun (started together)
    and, meanwhile, one process each in this one on the same config."""
    base = tmp_path_factory.mktemp("dp")
    init = base / "init"
    CheckpointManager(str(init)).save(0, convert.realbasicvsr_state_dict(jax_params[1]))
    extra = {"train": [f"train.restore={init}"], "gan": [], "spynet": []}
    procs = {name: _launch(base / name, module, [*overrides, *extra[name]])
             for name, (module, overrides) in RUNS.items()}
    single = {}
    for name, (module, overrides) in RUNS.items():
        root = base / name / "single"
        cfg = load_config(overrides=[*overrides, *extra[name], f"core.storage_dir={root}/run",
                                     f"train.logger.save_dir={root}/logs"])
        single[name] = {"train": trainer, "gan": gan, "spynet": spynet}[name].run(cfg, "cpu")
    logs = {}
    for name, p in procs.items():
        try:
            out, _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        ranks = [(base / name / f"rank{i}" / "out.txt") for i in range(2)]
        logs[name] = (p.returncode, out, [r.read_text() if r.exists() else "" for r in ranks])
    return base, logs, single


@pytest.mark.parametrize("name", sorted(RUNS))
def test_two_ranks_train_and_stay_equal(dp_runs, name):
    """Each trainer runs to its end on two gloo ranks (the in-trainer check
    after every epoch broadcasts rank 0's parameters, buffers and EMA, D's
    spectral state among them, and raises on any bit that differs), and
    neither rank imported jax or flax."""
    base, logs, _ = dp_runs
    rc, out, ranks = logs[name]
    assert rc == 0, f"{name}: torchrun rc {rc}\n{out}\nrank 0:\n{ranks[0]}\nrank 1:\n{ranks[1]}"
    assert PROGRESS[name] in ranks[0]
    assert not (base / name / "imported").exists(), (base / name / "imported").read_text()


@pytest.mark.parametrize("name", sorted(RUNS))
def test_rank_one_writes_nothing(dp_runs, name):
    """Rank 0 alone prints, logs and writes checkpoints (and the EMA
    sidecar); rank 1's directory holds no checkpoint and no log, and its
    output no progress line."""
    base, logs, _ = dp_runs
    rank0, rank1 = base / name / "rank0", base / name / "rank1"
    assert _files(rank0, "checkpoint.pt") and _files(rank0, "metrics.jsonl")
    assert not _files(rank1, "checkpoint.pt") and not _files(rank1, "metrics.jsonl")
    assert "epoch" not in logs[name][2][1]
    if name == "train":
        assert [p.parent.parent.name for p in _files(rank0, "checkpoint.pt")].count("ema") == 2


@pytest.mark.parametrize("name", sorted(RUNS))
def test_two_ranks_equal_one_process(dp_runs, name):
    """Rank 0's last checkpoint equals the one-process run's on the same
    global batches within atol 2e-5 (the supervised and GAN generators;
    every level of the SpyNet curriculum's ``final``); the validation
    means rank 0 logged equal those the one-process run returns (rtol
    1e-4)."""
    base, _, single = dp_runs
    sub = {"train": "checkpoints", "gan": "checkpoints", "spynet": "spynet/final"}[name]
    (two,) = [p.parent.parent for p in _files(base / name / "rank0", "checkpoint.pt")
              if p.parent.parent.as_posix().endswith(sub)][:1]
    (one,) = [p.parent.parent for p in _files(base / name / "single", "checkpoint.pt")
              if p.parent.parent.as_posix().endswith(sub)][:1]
    a, b = _latest(two), _latest(one)
    flat_a = a if name != "spynet" else {f"{u}.{k}": v for u, d in a.items() for k, v in d.items()}
    flat_b = b if name != "spynet" else {f"{u}.{k}": v for u, d in b.items() for k, v in d.items()}
    assert flat_a.keys() == flat_b.keys() and flat_a
    for k in flat_a:
        np.testing.assert_allclose(flat_a[k].numpy(), flat_b[k].numpy(), atol=2e-5, rtol=0,
                                   err_msg=k)
    if name != "spynet":  # the validation means of the last epoch, averaged over the ranks
        logged = [json.loads(line) for line in _files(base / name / "rank0", "metrics.jsonl")[0]
                  .read_text().splitlines()]
        last = [r for r in logged if "Loss/Val" in r][-1]
        assert single[name].keys() == {"Loss", "PSNR", "SSIM"}
        for k, v in single[name].items():
            np.testing.assert_allclose(last[f"{k}/Val"], v, rtol=1e-4, err_msg=k)


def test_supervised_loss_equals_the_jax_data_parallel_step(dp_runs, jax_params):
    """The two-rank run's first train loss (one step an epoch, read from
    rank 0's log) equals the JAX step's on the same global batch, sharded
    over a two-device mesh, from the same parameters."""
    base, _, _ = dp_runs
    module, overrides = RUNS["train"]
    cfg = load_config(overrides=list(overrides))
    train_dl, _ = build_loaders(cfg.train.data, seed=int(cfg.get("seed_index") or 0))
    train_dl.set_epoch(0)
    batch = next(iter(train_dl))
    jmodel, params = jax_params
    state = j_create(jmodel, None, None, jbuilders.build_tx({"_target_": "sgd", "lr": 0.0}),
                     variables={"params": params})
    mesh = j_create_mesh(2)
    with mesh:
        _, m = j_make_step(jmodel, donate=False)(jax.device_put(state, j_replicated(mesh)),
                                                 j_shard_batch(batch, mesh))
    logged = [json.loads(line) for line in _files(base / "train" / "rank0", "metrics.jsonl")[0]
              .read_text().splitlines()]
    losses = [r["Loss/Train"] for r in logged if "Loss/Train" in r]
    assert len(losses) == 2
    np.testing.assert_allclose(losses[0], float(m["Loss"]), rtol=1e-5)


# two processes in one gloo group through torchrun's environment, by hand
PRIMITIVES = r"""
import json, sys
import torch, torch.distributed as dist
import vsrlab_tpu_torch.components
from vsrlab_tpu_torch import parallel
from vsrlab_tpu_torch.train.builders import build_tx

assert parallel.initialize_distributed("cpu")
assert not parallel.initialize_distributed("cpu")  # a second call does nothing
mesh = parallel.create_mesh()
r = parallel.process_index()
res = {"rank": r, "count": parallel.process_count(), "mesh": mesh.shape,
       "slice": [parallel.local_batch_slice(8).start, parallel.local_batch_slice(8).stop]}
res["shard"] = parallel.shard_batch({"lr": torch.arange(8.0)}, "cpu")["lr"].tolist()
a = [torch.full((3,), float(r + 1)), torch.full((2, 2), 10.0 * (r + 1)),
     torch.full((4,), r + 1, dtype=torch.float64)]
parallel.all_reduce_mean(a, mesh.group)
res["mean"] = [t.flatten().tolist() for t in a]
m = parallel.reduce_metrics({"Loss": torch.tensor(float(r)), "PSNR": torch.tensor(2.0 * r)},
                            mesh.group)
res["metrics"] = {k: float(v) for k, v in m.items()}
torch.manual_seed(r)
lin = torch.nn.Linear(4, 3)
lin.register_buffer("u", torch.randn(3))
parallel.replicated(lin, mesh.group)
parallel.assert_replicated(lin, mesh.group)
x = torch.arange(8.0).reshape(2, 4) * (r + 1) / 8
tx = build_tx(lin.parameters(), {"_target_": "sgd", "lr": 0.5}, None, 0.1, group=mesh.group)
lin(x).square().mean().backward()
res["norm"] = float(tx.step())
res["after"] = [p.detach().flatten().tolist() for p in lin.parameters()]
res["u"] = lin.u.tolist()
parallel.assert_replicated(lin, mesh.group)
with torch.no_grad():
    lin.bias.add_(float(r))
try:
    parallel.assert_replicated(lin, mesh.group, "bias")
    res["caught"] = ""
except RuntimeError as e:
    res["caught"] = str(e)
json.dump(res, open(sys.argv[1], "w"))
dist.destroy_process_group()
"""


def test_primitives_across_two_processes(tmp_path):
    """All-reduce of two dtypes, metrics, the broadcast from rank 0 and the
    replica check; the Updater's averaged, clipped step equals one process
    stepping on both ranks' rows."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = _worker_env(tmp_path)
        env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", PRIMITIVES, str(tmp_path / f"r{rank}.json")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out, _ = p.communicate(timeout=TIMEOUT)
        assert p.returncode == 0, out
    res = [json.loads((tmp_path / f"r{rank}.json").read_text()) for rank in range(2)]
    assert not (tmp_path / "imported").exists()
    for rank, r in enumerate(res):
        assert (r["rank"], r["count"], r["mesh"]) == (rank, 2, {"data": 2})
        assert r["slice"] == [4 * rank, 4 * rank + 4]
        assert r["shard"] == [float(i) for i in range(4 * rank, 4 * rank + 4)]
        assert r["mean"] == [[1.5] * 3, [15.0] * 4, [1.5] * 4]
        assert r["metrics"] == {"Loss": 0.5, "PSNR": 1.0}
        assert "bias" in r["caught"]
    assert res[0]["after"] == res[1]["after"] and res[0]["norm"] == res[1]["norm"]
    assert res[0]["u"] == res[1]["u"]
    # one process, both ranks' rows: the same update within fp32 rounding
    torch.manual_seed(0)
    lin = torch.nn.Linear(4, 3)
    x = torch.cat([torch.arange(8.0).reshape(2, 4) * (r + 1) / 8 for r in range(2)])
    tx = build_tx(lin.parameters(), {"_target_": "sgd", "lr": 0.5}, None, 0.1)
    lin(x).square().mean().backward()
    norm = float(tx.step())
    assert norm > 0.1  # the clip was in force
    np.testing.assert_allclose(res[0]["norm"], norm, rtol=1e-6)
    for got, want in zip(res[0]["after"], lin.parameters()):
        np.testing.assert_allclose(got, want.detach().flatten().numpy(), rtol=1e-6, atol=1e-7)


def test_one_process_is_a_world_of_one(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert not parallel.initialize_distributed("cpu")
    mesh = parallel.create_mesh()
    assert (mesh.shape, mesh.rank, mesh.group) == ({"data": 1}, 0, None)
    assert parallel.create_mesh({"data": -1, "time": 1}).shape == {"data": 1, "time": 1}
    assert parallel.local_batch_slice(16) == slice(0, 16)
    assert parallel.local_batch_slice(16, axis_size=4) == slice(0, 4)
    t = [torch.ones(3)]
    assert parallel.all_reduce_mean(t) is not t and torch.equal(t[0], torch.ones(3))
    metrics = {"Loss": torch.tensor(1.0)}
    assert parallel.reduce_metrics(metrics) is metrics
    device, mesh, created = parallel.data_parallel(True, "cpu")
    assert (device, mesh.size, created) == (torch.device("cpu"), 1, False)


class _Indexed:
    """A dataset whose sample ``i`` is ``i`` in both its LR and HR arrays."""

    def __len__(self):
        return 24

    def __getitem__(self, i):
        return np.full((1,), i), np.full((1,), i)


@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_loader_shards_by_the_batch_slice(num_shards, monkeypatch):
    """The loader's shard ``k`` of every global batch is the rows
    ``shard_slice`` gives it (the rule ``local_batch_slice`` and
    ``shard_batch`` use), and the shards together are the one-process
    loader's batch."""
    from vsrlab_tpu_torch.data.loader import DataLoader

    whole = [b["lr"][:, 0] for b in DataLoader(_Indexed(), 8, num_workers=1, seed=3)]
    shards = [[b["lr"][:, 0] for b in DataLoader(_Indexed(), 8, num_workers=1, seed=3,
                                                 num_shards=num_shards, shard_index=k)]
              for k in range(num_shards)]
    for i, batch in enumerate(whole):
        for k in range(num_shards):
            np.testing.assert_array_equal(shards[k][i],
                                          batch[parallel.shard_slice(8, num_shards, k)])
        np.testing.assert_array_equal(np.concatenate([sh[i] for sh in shards]), batch)
    monkeypatch.setattr(parallel.mesh, "process_index", lambda: num_shards - 1)
    monkeypatch.setattr(parallel.mesh, "process_count", lambda: num_shards)
    assert parallel.local_batch_slice(8) == parallel.shard_slice(8, num_shards, num_shards - 1)
    rows = parallel.shard_batch({"lr": whole[0]}, "cpu")["lr"]
    np.testing.assert_array_equal(rows.numpy(), shards[-1][0])


def test_sequence_parallelism_and_bad_meshes_raise():
    """A mesh that does not cover the ranks, or names an axis it does not
    know, raises; so does a block that does not split. The placement
    helpers run over two ranks in ``test_torch_sequence_parallel.py``."""
    with pytest.raises(ValueError, match="!= 1 processes"):
        parallel.create_mesh({"data": 1, "time": 2})
    with pytest.raises(ValueError, match="!= 1 processes"):
        parallel.create_mesh(2)
    with pytest.raises(ValueError, match="unknown mesh axes"):
        parallel.create_mesh({"data": 1, "pipe": 2})
    with pytest.raises(ValueError, match="does not split"):
        parallel.shard_batch_sp({"lr": torch.zeros(3, 4)}, parallel.Mesh(("data", "time"), (2, 1)),
                                "cpu")
    with pytest.raises(ValueError, match="no axis 'data'"):
        parallel.clip_sharding(parallel.Mesh(("time",), (1,))).index((2, 4))


def test_rank_device_and_backend(monkeypatch):
    """A rank's device is ``cuda:LOCAL_RANK`` for ``"cuda"``, the one named
    for ``"cuda:k"``; NCCL only where each rank has a card of its own;
    ``ddp: false`` in a larger world raises."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert parallel.rank_device("cuda") == torch.device("cuda", 1)
    assert parallel.rank_device("cuda:0") == torch.device("cuda", 0)
    assert parallel.rank_device("cpu") == torch.device("cpu")
    assert parallel.default_backend("cuda") == "nccl"
    assert parallel.default_backend("cuda:0") == "gloo"  # the ranks share the named card
    assert parallel.default_backend("cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert parallel.default_backend("cuda") == "gloo"
    with pytest.raises(RuntimeError, match="no card of its own"):
        parallel.rank_device("cuda")
    with pytest.raises(ValueError, match="train.ddp is false"):
        parallel.data_parallel(False, "cpu")
