"""VRT split over ``time`` and ``model`` at once in vsrlab_tpu_torch on the
CPU, and head-sharded training through the port's own train step.

The JAX package composes the frames' split over ``time`` (the input's
sharding) with the heads' split over ``model`` (``head_shard_axis``, a
sharding annotation) on any mesh, and trains a head-sharded TinyVRT through
its ``make_supervised_train_step`` (``__graft_entry__.py:159-188``). Here
one world of four gloo CPU ranks (subprocesses with torchrun's environment
and ``jax`` / ``flax`` poisoned on their path, started once for the file)
runs the TinyVRT of ``tests/test_torch_vrt_sequence_train.py`` (depth 4 a
Stage, 8 channels, 2 heads, ``remat``, windows ``(6, 4, 4)`` and ``(4, 4,
4)``) built with ``time_shard_axis="time"`` and ``head_shard_axis="model"``
on 2 clips of 6 x 16x16 (``shard_batch_sp``):

* (a) ``{"data": 2, "model": 2}``: one SGD step (lr 0.1) of
  ``make_supervised_train_step`` with ``group=mesh.mesh_group``: the
  gradients the update applied within ``1e-5 + 1e-4|b|`` of one
  process's, the parameters within atol 1e-5 of its and bitwise equal on
  the ranks. Without ``parallel.all_reduce_sharded_grads`` in the step the
  head-sharded gradients come out halved (the mean of the two ranks'
  parts), and the gradient gate fails;
* (b) ``{"time": 2, "model": 2}``: each rank's SR frames (the eval step's)
  within atol 1e-5 of the JAX ``TinyVRT``'s on the whole batch (the same
  numpy parameters through ``convert.py``, one device) at window ``(6, 4,
  4)``, and of the port's one process at ``(4, 4, 4)`` (one JAX compile
  of each window would take longer than this file may;
  ``test_torch_vrt_sequence_train.py`` holds that window's split against
  JAX);
* (c) on (b)'s mesh, one SGD step: the averaged gradients and the
  parameters as in (a); each kind of window message sent as many times
  as the plans say, on each model rank's time line;
* (d) ``windowed_inference`` of the two clips as one 12-frame clip in
  windows of 6 over (b)'s mesh: each time rank serves one window with its
  heads split; the result within atol 1e-5 of (b)'s reference, the same
  bit for bit on every rank.

The step is held against the port's one process, as that file does
(``test_torch_vrt_train.py`` holds that process against the JAX step).
``create_mesh``'s groups and time links on ``{"time": 2, "model": 2}`` and
``{"data": 2, "time": 2, "model": 2}`` are checked in one process, every
rank's call replayed with ``torch.distributed``'s group calls recorded.
"""

import json
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vsrlab_tpu_torch import convert, parallel  # noqa: E402
from vsrlab_tpu_torch.parallel import mesh as mesh_module  # noqa: E402
from vsrlab_tpu_torch.parallel import window_plan  # noqa: E402
from test_torch_parallel import TIMEOUT, _free_port, _worker_env  # noqa: E402
from test_torch_vrt import _random_params  # noqa: E402
from test_torch_vrt_sequence_train import (  # noqa: E402
    GRAD_TOL,
    KW,
    LR_SHAPE,
    PARAM_ATOL,
    SR_ATOL,
    WINDOWS,
    _blocks,
    _jax_model,
    _make_batch,
    _one_process,
    _OneThread,
    _port,
    _redraw_tables,
)
from vsrlab_tpu_torch.train.step import make_eval_step  # noqa: E402

RANKS = 4
JAX_WINDOW = "w6"  # the window whose SR frames come from the JAX TinyVRT
MESHES = {"data_model": {"data": 2, "model": 2}, "time_model": {"time": 2, "model": 2}}
SERVE_WINDOW = 6  # the 12-frame clip's windows: one a time rank

WORKER = r"""
import collections, json, sys
import numpy as np, torch
from vsrlab_tpu_torch import parallel
from vsrlab_tpu_torch.evaluation.harness import make_forward, windowed_inference
from vsrlab_tpu_torch.models import TinyVRT
from vsrlab_tpu_torch.models.vrt import WindowAttention
from vsrlab_tpu_torch.parallel.sequence import TimeLinks
from vsrlab_tpu_torch.train.builders import build_tx
from vsrlab_tpu_torch.train.state import create_train_state
from vsrlab_tpu_torch.train.step import make_eval_step, make_supervised_train_step

root, spec = sys.argv[1], json.loads(sys.argv[2])
assert parallel.initialize_distributed("cpu")
whole = {"lr": np.load(f"{root}/lr.npy"), "hr": np.load(f"{root}/hr.npy")}
sent = collections.Counter()
exchange = TimeLinks._exchange


def counted(self, sends, shapes, like, kind):  # messages this rank posts, by kind and peer
    for j in sends:
        sent[f"{kind}:{self.line[j]}"] += 1
    return exchange(self, sends, shapes, like, kind)


TimeLinks._exchange = counted


def model_for(window):
    model = TinyVRT(**spec["kw"], window_size=spec["windows"][window], remat=True,
                    time_shard_axis="time", head_shard_axis="model")
    model.load_state_dict(torch.load(f"{root}/params_{window}.pt"))
    return model


def train(mesh, batch, window, name):
    model = model_for(window)
    group = mesh.mesh_group
    state = create_train_state(model, build_tx(model.parameters(), ("sgd", {"lr": 0.1}),
                                               group=group))
    with parallel.use_mesh(mesh):
        sent.clear()
        _, metrics = make_supervised_train_step(model, group=group)(state, batch)
        messages = dict(sent)
        heads = sorted({a.head_shard()[1:] for a in model.modules()
                        if isinstance(a, WindowAttention)})
    parallel.assert_replicated(model, group, "updated parameters")
    if mesh.rank == 0:  # the parameters after the update and the averaged gradients it applied
        torch.save({"params": model.state_dict(),
                    "grads": {n: p.grad for n, p in model.named_parameters()}},
                   f"{root}/{name}_{window}.pt")
    return {"train": {k: float(v) for k, v in metrics.items()}, "messages": messages,
            "heads": heads}


meshes = {name: parallel.create_mesh(axes) for name, axes in spec["meshes"].items()}
res = {"rank": meshes["data_model"].rank}
video = torch.from_numpy(whole["lr"]).reshape(1, -1, *whole["lr"].shape[2:])
for window in spec["windows"]:
    # (a) data x model: the batch split over data, the heads over model
    mesh = meshes["data_model"]
    batch = parallel.shard_batch_sp(whole, mesh, "cpu", time_axis=None)
    res[f"data_model_{window}"] = {"coords": mesh.coords, "block": list(batch["lr"].shape),
                                   **train(mesh, batch, window, "data_model")}
    # (b), (c) time x model: the frames split over time, the heads over model
    mesh = meshes["time_model"]
    batch = parallel.shard_batch_sp(whole, mesh, "cpu", batch_axis=None)
    with parallel.use_mesh(mesh):
        sent.clear()
        metrics, sr = make_eval_step(model_for(window), group=mesh.mesh_group)(None, batch)
        eval_messages = dict(sent)
    torch.save(sr, f"{root}/sr_{window}_{mesh.rank}.pt")
    res[f"time_model_{window}"] = {
        "coords": mesh.coords, "block": list(batch["lr"].shape),
        "line": mesh.links["time"].line, "eval_messages": eval_messages,
        "eval": {k: float(v) for k, v in metrics.items()},
        **train(mesh, batch, window, "time_model")}
    # (d) serving: each time rank's windows whole, the heads split over its model line
    sent.clear()
    sr, n = windowed_inference(make_forward(model_for(window), device="cpu"), video,
                               spec["serve_window"], mesh)
    torch.save(sr, f"{root}/served_{window}_{mesh.rank}.pt")
    res[f"served_{window}"] = {"windows": n, "messages": dict(sent)}
json.dump(res, open(f"{root}/rank{res['rank']}.json", "w"))
torch.distributed.destroy_process_group()
"""


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """That file's parameters of each window (numpy over the JAX ``init``'s
    shapes) and batch, written for the ranks."""
    root = tmp_path_factory.mktemp("vrt_time_model")
    lr, hr = _make_batch()
    np.save(root / "lr.npy", lr)
    np.save(root / "hr.npy", hr)
    params = {"w6": _random_params(_jax_model("w6"), np.random.default_rng(20),
                                   jnp.asarray(lr[:1]))}
    params["w4"] = _redraw_tables(params["w6"], np.random.default_rng(21), WINDOWS["w4"])
    for window in WINDOWS:
        torch.save(convert.vrt_state_dict(params[window]), root / f"params_{window}.pt")
    return root, params, lr, hr


@pytest.fixture(scope="module")
def rank_procs(setup):
    """The four ranks, started once (the references run while they work);
    any rank still running at the end of the module is killed."""
    root = setup[0]
    spec = json.dumps({"meshes": MESHES, "kw": KW, "windows": WINDOWS,
                       "serve_window": SERVE_WINDOW})
    port = _free_port()
    procs = []
    for rank in range(RANKS):
        env = _worker_env(root)
        env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(RANKS),
                   LOCAL_WORLD_SIZE=str(RANKS), MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, "-c", WORKER, str(root), spec], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    yield procs
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def references(setup, rank_procs):
    """While the ranks run: the SR frames on the whole batch of the JAX
    TinyVRT (one device) at ``JAX_WINDOW`` and of the port's one process at
    the other window (``sr``), and the port's one process (eval and one SGD
    step) for each window at one thread (``port``)."""
    _, params, lr, hr = setup
    batch = {"lr": torch.from_numpy(lr), "hr": torch.from_numpy(hr)}
    out = {"sr": {}, "port": {}}

    def jax_sr():
        model = _jax_model(JAX_WINDOW)
        fn = jax.jit(lambda p, x: model.apply({"params": p}, x)[0])
        out["sr"][JAX_WINDOW] = np.asarray(fn(params[JAX_WINDOW], jnp.asarray(lr)))

    def port():
        with _OneThread():
            for window in WINDOWS:
                out["port"][window] = _one_process(params, window, batch)
                if window != JAX_WINDOW:
                    out["sr"][window] = make_eval_step(_port(params, window))(
                        None, batch)[1].numpy()

    threads = [threading.Thread(target=jax_sr), threading.Thread(target=port)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert out["sr"].keys() == out["port"].keys() == WINDOWS.keys()
    return out


@pytest.fixture(scope="module")
def rank_runs(setup, rank_procs, references):
    """Each rank's exit and its record."""
    root = setup[0]
    for p in rank_procs:
        out = p.communicate(timeout=TIMEOUT)[0]
        assert p.returncode == 0, out
    assert not (root / "imported").exists(), (root / "imported").read_text()
    return [json.loads((root / f"rank{r}.json").read_text()) for r in range(RANKS)]


def _gate_step(got, want):
    """The averaged gradients within ``1e-5 + 1e-4|b|`` of one process's
    (SpyNet's none), the parameters within atol 1e-5."""
    assert got["grads"].keys() == want["grads"].keys()
    moved = 0
    for k, w in want["grads"].items():
        g = got["grads"][k]
        if w is None:  # SpyNet is frozen
            assert g is None, k
            continue
        assert bool(((g - w).abs() <= GRAD_TOL[0] + GRAD_TOL[1] * w.abs()).all()), \
            f"{k}: {float((g - w).abs().max()):.3e}"
        moved += bool(w.abs().max() > 0)
    assert moved > 100
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), atol=PARAM_ATOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_head_sharded_step_on_data_model_is_one_process(setup, rank_runs, references, window):
    """(a) The head-sharded step on ``data = 2 x model = 2`` applies one
    process's gradients: each rank's attention parameters' gradients hold
    its own heads' part only until the step sums them over the model line;
    the ranks end bitwise equal (each checked against rank 0) and every
    rank's metrics are one process's."""
    want = references["port"][window]
    _gate_step(torch.load(setup[0] / f"data_model_{window}.pt"), want)
    for r in rank_runs:
        rec = r[f"data_model_{window}"]
        assert rec["block"] == [1, *LR_SHAPE[1:]]
        assert rec["heads"] == [[rec["coords"]["model"], rec["coords"]["model"] + 1]]
        assert rec["messages"] == {}
        for k, v in want["train"].items():
            np.testing.assert_allclose(rec["train"][k], v, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_time_model_forward_matches_jax(setup, rank_runs, references, window):
    """(b) Each rank's SR frames, its time block of the whole batch's (the
    JAX TinyVRT's at window (6, 4, 4), the port's one process's at (4, 4,
    4)), within atol 1e-5; the ranks of a model line bitwise equal."""
    t = LR_SHAPE[1] // MESHES["time_model"]["time"]
    by_block = {}
    for r in rank_runs:
        rec = r[f"time_model_{window}"]
        k = rec["coords"]["time"]
        assert rec["block"] == [LR_SHAPE[0], t, *LR_SHAPE[2:]]
        sr = torch.load(setup[0] / f"sr_{window}_{r['rank']}.pt")
        np.testing.assert_allclose(sr.numpy(), references["sr"][window][:, k * t:(k + 1) * t],
                                   atol=SR_ATOL, rtol=0, err_msg=f"rank {r['rank']}")
        if k in by_block:
            assert torch.equal(sr, by_block[k]), f"rank {r['rank']}"
        by_block[k] = sr
        for key, v in references["port"][window]["eval"].items():
            np.testing.assert_allclose(rec["eval"][key], v, rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_time_model_step_matches_one_process(setup, rank_runs, references, window):
    """(c) The step on ``time = 2 x model = 2`` with ``group=mesh.mesh_group``:
    the head-sharded gradients summed over each model line, then the mean
    over the whole mesh, are one process's; the ranks bitwise equal; each
    rank the metrics of one process."""
    want = references["port"][window]
    _gate_step(torch.load(setup[0] / f"time_model_{window}.pt"), want)
    for r in rank_runs:
        rec = r[f"time_model_{window}"]
        assert rec["heads"] == [[rec["coords"]["model"], rec["coords"]["model"] + 1]]
        for k, v in want["train"].items():
            np.testing.assert_allclose(rec["train"][k], v, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_time_model_messages_follow_the_plans(rank_runs, window):
    """(c) Each rank posts on its time line, for each kind and peer, as many
    messages as the window plans and the halos say (as on a ``time``-only
    mesh: the frames cross each model rank's line once): in the eval step
    one of each straddling block's frames a reader and one halo a
    neighbour each forward, in the train step those again in the recompute
    and each of their gradients once."""
    ranks, stages = MESHES["time_model"]["time"], len(KW["depths"]) - 2
    for r in rank_runs:
        rec = r[f"time_model_{window}"]
        k, line = rec["coords"]["time"], rec["line"]
        assert len(line) == ranks and r["rank"] in line
        plans = [window_plan(LR_SHAPE[1], ranks, k, wd, shift) for wd, shift in _blocks(window)]
        frames, grads = {}, {}
        for plan in plans:
            for j, _ in plan.post:
                frames[f"window:{line[j]}"] = frames.get(f"window:{line[j]}", 0) + 1
            for j, _ in plan.fetch:
                grads[f"window_grad:{line[j]}"] = grads.get(f"window_grad:{line[j]}", 0) + 1
        peer = line[1 - k]
        assert rec["eval_messages"] == {**frames, f"halo:{peer}": 1 + stages}
        assert rec["messages"] == {**{f: 2 * n for f, n in frames.items()}, **grads,
                                   f"halo:{peer}": 1 + 2 * stages, f"halo_grad:{peer}": stages}
        assert grads and all(frames.values())


@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_time_model_serving_matches_jax(setup, rank_runs, references, window):
    """(d) ``windowed_inference`` over ``time = 2 x model = 2``: each time
    rank serves one of the two 6-frame windows whole (no frame crosses a
    time line) with its heads split; every rank returns the whole clip,
    within atol 1e-5 of each window's forward (the JAX TinyVRT's at window
    (6, 4, 4), the port's one process's at (4, 4, 4)), bit for bit alike."""
    want = references["sr"][window].reshape(1, -1, *references["sr"][window].shape[2:])
    first = None
    for r in rank_runs:
        assert r[f"served_{window}"] == {"windows": 2, "messages": {}}
        sr = torch.load(setup[0] / f"served_{window}_{r['rank']}.pt")
        np.testing.assert_allclose(sr.numpy(), want, atol=SR_ATOL, rtol=0,
                                   err_msg=f"rank {r['rank']}")
        if first is not None:
            assert torch.equal(sr, first), f"rank {r['rank']}"
        first = sr


class _Group:
    """A process group that ``dist.new_group`` would have made: its ranks."""

    def __init__(self, ranks):
        self.ranks = tuple(ranks)


@pytest.mark.parametrize("axes", [{"time": 2, "model": 2}, {"data": 2, "time": 2, "model": 2}],
                         ids=["time2_model2", "data2_time2_model2"])
def test_create_mesh_lines_on_time_and_model(monkeypatch, axes):
    """``create_mesh`` on both axes, every rank's call replayed in one
    process with ``dist.new_group`` recorded: each rank's ``time`` group
    and links hold its time line (the ranks that differ in their time
    index only), its ``model`` group its model line, every rank creates
    the same groups in one order, and each line's pairs get their
    message groups."""
    n = int(np.prod(list(axes.values())))
    grid = np.arange(n).reshape(tuple(axes.values()))
    names = list(axes)
    calls = {}
    for rank in range(n):
        made = []

        def new_group(ranks, made=made):
            made.append(tuple(ranks))
            return _Group(ranks)

        monkeypatch.setattr(mesh_module, "process_count", lambda: n)
        monkeypatch.setattr(mesh_module, "process_index", lambda rank=rank: rank)
        monkeypatch.setattr(mesh_module.dist, "new_group", new_group)
        mesh = parallel.create_mesh(axes)
        calls[rank] = made
        coords = mesh.coords
        for axis in ("time", "model"):
            where = [coords[a] if a != axis else slice(None) for a in names]
            line = tuple(int(r) for r in grid[tuple(where)])
            assert mesh.axis_group(axis).ranks == line
            assert mesh.axis_ranks(axis) == list(line)
        links = mesh.links["time"]
        assert links.line == mesh.axis_ranks("time") and links.index == coords["time"]
        peer = links.line[1 - links.index]
        assert set(links._groups[peer]) == {"halo", "halo_grad", "forward", "backward",
                                            "window", "window_grad"}
        assert links._groups[peer]["window"].ranks == tuple(sorted((rank, peer)))
        assert mesh.shape == axes and mesh.mesh_group is None  # no process group here
    assert all(calls[r] == calls[0] for r in calls)


def test_whole_clips_mesh_splits_no_frames():
    """``Mesh.whole_clips`` (serving's windows): no module finds time links
    under it, while the ``model`` axis still splits heads."""
    from vsrlab_tpu_torch.models.vrt.window_attention import WindowAttention

    mesh = parallel.Mesh(("time", "model"), (2, 2), 3, {"model": "line"}, {"time": "links"})
    attn = WindowAttention(8, (2, 4, 4), 2, head_shard_axis="model")
    with parallel.use_mesh(mesh):
        assert parallel.active_links("time") == "links"
    with parallel.use_mesh(mesh.whole_clips()):
        assert parallel.active_links("time") is None
        assert attn.head_shard() == ("line", 1, 2)
    assert mesh.split_frames and not mesh.whole_clips().split_frames


def test_step_group_on_a_model_split_mesh():
    """``check_step_group`` on a mesh that splits heads and no frames: the
    whole mesh or the data axis's group gives one process's numbers, a
    group that misses the data axis's ranks raises and names the group to
    pass; with one rank on ``data`` no group is needed (the model line is
    the whole mesh)."""
    sizes = {}

    class Group:
        def __init__(self, size):
            sizes[self] = size

    monkey = pytest.MonkeyPatch()
    monkey.setattr(mesh_module.dist, "get_world_size", lambda group: sizes[group])
    try:
        data, model, world = Group(2), Group(2), Group(4)
        mesh = parallel.Mesh(("data", "model"), (2, 2), 0, {"data": data, "model": model})
        with parallel.use_mesh(mesh):
            parallel.check_step_group(world, data)
            for bad in (None, model):
                with pytest.raises(ValueError, match="the heads are split over 'model'.*"
                                                     "group=mesh.mesh_group"):
                    parallel.check_step_group(bad)
        with parallel.use_mesh(parallel.Mesh(("data", "model"), (1, 2), 1, {"model": model})):
            parallel.check_step_group(None, Group(2), model)
        with parallel.use_mesh(parallel.Mesh(("time", "model"), (2, 2), 0, {"model": model})):
            with pytest.raises(ValueError, match="the frames are split over 'time'"):
                parallel.check_step_group(Group(2))
    finally:
        monkey.undo()
