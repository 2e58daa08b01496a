"""Sequence-parallel training of TinyVRT in vsrlab_tpu_torch on the CPU,
against the JAX package's single-device forward and the port's one process.

The JAX package splits each clip's frames over the ``time`` axis of a
``(data, time)`` mesh and leaves the exchanges to XLA
(``tests/test_parallel_train.py:256-291``). The port's
``TinyVRT(time_shard_axis="time")`` inside ``parallel.use_mesh`` fetches the
frames of every attention window that holds one of a rank's frames from
their owners (the clip's wrap-around in shifted blocks included), hands the
neighbours their edge LR frames and, in every Stage, their edge features
(``parallel.TimeLinks``). Here gloo CPU ranks (subprocesses with torchrun's
environment and ``jax`` / ``flax`` poisoned on their path, one world each
of two, three and four ranks, started together once for the file) run a
TinyVRT of depth 4 a Stage (``residual_group1``'s window-2 blocks then
hold a shifted one: a temporal shift of 1 whose last window pairs the
clip's last and first frames, the wrap-around), 8 channels, 2 heads,
``remat`` on, on their block of 2 clips of 6 frames of 16x16
(``shard_batch_sp``):

* windows ``(6, 4, 4)``, the paper's case: each window is the whole clip,
  so every token attends to every rank's frames; and ``(4, 4, 4)``: the
  clip padded to 8 frames, and in the first Stage (depth 5) a block
  shifted by 2 that rolls the first two frames into the padded window;
* meshes ``time = 2`` (3 frames a rank, odd), ``time = 3`` (the line's
  ends are not neighbours) and ``data = 2 x time = 2``; ``align_chunks=4``
  with window 4 on ``time = 3``;
* each rank runs ``make_eval_step`` and one SGD step (lr 0.1) of
  ``make_supervised_train_step`` with ``group=mesh.mesh_group``.

Gates: each rank's SR frames within atol 1e-5 of the JAX ``TinyVRT``'s on
the whole batch (fp32, the same numpy parameters through ``convert.py``);
the averaged gradients the update applied within ``1e-5 + 1e-4|b|`` of one
process's of the port on the whole batch, the parameters after it within
atol 1e-5 of that process's and bitwise equal on every rank; the eval and
train metrics within rtol 1e-5 of one process's; each kind of message
(the window frames and their gradients, the halo frames and theirs) sent
as many times as the plans say, the ends' pair used on ``time = 3``.
A step against the JAX package's is not taken here: its compile alone
takes longer than this file may (``test_torch_vrt_train.py`` holds the
port's one-process step against it). In the ranks and in the test process:
ranks that hold different numbers of frames, generators that differ
under stochastic depth and tiled serving raise; outside a mesh, or with a
``time`` axis of one rank, the model is the unsplit one bit for bit.
"""

import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

# pytest-xdist's workers share the machine's cores (see
# test_torch_sequence_train.py): one intra-op thread in each of them
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

from vsrlab_tpu.models import vrt as jvrt  # noqa: E402
from vsrlab_tpu_torch import convert, parallel  # noqa: E402
from vsrlab_tpu_torch.evaluation import harness  # noqa: E402
from vsrlab_tpu_torch.models import vrt  # noqa: E402
from vsrlab_tpu_torch.parallel import window_plan  # noqa: E402
from vsrlab_tpu_torch.train.builders import build_tx  # noqa: E402
from vsrlab_tpu_torch.train.state import create_train_state  # noqa: E402
from vsrlab_tpu_torch.train.step import make_eval_step, make_supervised_train_step  # noqa: E402
from test_torch_parallel import TIMEOUT, _free_port, _worker_env  # noqa: E402
from test_torch_vrt import _random_params  # noqa: E402

# depth 4 a Stage: residual_group1 holds 3 blocks, the middle one shifted;
# the first Stage's 5 give residual_group2 a shifted block too; the trunk's
# two RTMSAs (window 1, nothing to exchange) hold one block each
KW = dict(upscale=4, depths=(5, 4, 4, 4, 4, 1, 1), embed_dims=(8,) * 7, num_heads=(2,) * 7,
          deformable_groups=2, drop_path_rate=0.0)
WINDOWS = {"w6": (6, 4, 4), "w4": (4, 4, 4)}
LR_SHAPE = (2, 6, 16, 16, 3)
SR_ATOL, METRIC_RTOL, PARAM_ATOL = 1e-5, 1e-5, 1e-5
GRAD_TOL = (1e-5, 1e-4)  # atol + rtol * |b|, against one process
MESHES = {"time2": {"data": 1, "time": 2}, "time3": {"data": 1, "time": 3},
          "data2_time2": {"data": 2, "time": 2}}
# (window, align_chunks) a mesh runs
CASES = {"time2": [("w6", 0), ("w4", 0)], "time3": [("w6", 0), ("w4", 4)],
         "data2_time2": [("w6", 0), ("w4", 0)]}

WORKER = r"""
import collections, json, sys
import numpy as np, torch
from vsrlab_tpu_torch import parallel
from vsrlab_tpu_torch.models import TinyVRT
from vsrlab_tpu_torch.parallel.sequence import TimeLinks
from vsrlab_tpu_torch.train.builders import build_tx
from vsrlab_tpu_torch.train.state import create_train_state
from vsrlab_tpu_torch.train.step import make_eval_step, make_supervised_train_step

root, name, spec = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
assert parallel.initialize_distributed("cpu")
whole = {"lr": np.load(f"{root}/lr.npy"), "hr": np.load(f"{root}/hr.npy")}
sent = collections.Counter()
exchange = TimeLinks._exchange


def counted(self, sends, shapes, like, kind):  # messages this rank posts, by kind and peer
    for j in sends:
        sent[f"{kind}:{self.line[j]}"] += 1
    return exchange(self, sends, shapes, like, kind)


TimeLinks._exchange = counted


def model_for(window, chunks=0, **kw):
    model = TinyVRT(**spec["kw"], window_size=spec["windows"][window], remat=True,
                    align_chunks=chunks, time_shard_axis="time", **kw)
    model.load_state_dict(torch.load(f"{root}/params_{window}.pt"))
    return model


mesh = parallel.create_mesh(spec["axes"])
r, group, links = mesh.rank, mesh.mesh_group, mesh.links["time"]
batch = parallel.shard_batch_sp(whole, mesh, "cpu")
res = {"rank": r, "coords": mesh.coords, "block": list(batch["lr"].shape),
       "line": links.line}
for window, chunks in spec["cases"]:
    case = f"{window}_{chunks}"
    out = res[case] = {}
    with parallel.use_mesh(mesh):
        sent.clear()
        metrics, sr = make_eval_step(model_for(window, chunks), group=group)(None, batch)
        out["eval_messages"] = dict(sent)
        out["eval"] = {k: float(v) for k, v in metrics.items()}
        torch.save(sr, f"{root}/{name}_{case}_sr{r}.pt")
        model = model_for(window, chunks)
        state = create_train_state(model, build_tx(model.parameters(), ("sgd", {"lr": 0.1}),
                                                   group=group))
        sent.clear()
        _, m = make_supervised_train_step(model, group=group)(state, batch)
        out["train_messages"] = dict(sent)
        out["train"] = {k: float(v) for k, v in m.items()}
    parallel.assert_replicated(model, group, "updated parameters")
    if r == 0:  # the parameters after the update and the averaged gradients it applied
        torch.save({"params": model.state_dict(),
                    "grads": {n: p.grad for n, p in model.named_parameters()}},
                   f"{root}/{name}_{case}.pt")

# what raises: blocks of different lengths, generators that differ under stochastic depth
model = model_for("w4")
with parallel.use_mesh(mesh), torch.no_grad():
    try:
        model(batch["lr"][:, :batch["lr"].shape[1] - (links.index == 0)])
        res["uneven"] = ""
    except ValueError as e:
        res["uneven"] = str(e)
    try:
        model(batch["lr"], deterministic=False,
              generator=torch.Generator().manual_seed(links.index))
        res["generators"] = ""
    except RuntimeError as e:
        res["generators"] = str(e)
json.dump(res, open(f"{root}/{name}_rank{r}.json", "w"))
torch.distributed.destroy_process_group()
"""


class _OneThread:
    """Run at one thread, as the ranks run (OMP_NUM_THREADS=1). Not imported
    from ``test_torch_sequence_parallel``, whose imports take seconds."""

    def __enter__(self):
        self.n = torch.get_num_threads()
        torch.set_num_threads(1)

    def __exit__(self, *exc):
        torch.set_num_threads(self.n)


def _make_batch():
    rng = np.random.default_rng(3)
    b, t, h, w, c = LR_SHAPE
    return (rng.random(LR_SHAPE, dtype=np.float32),
            rng.random((b, t, 4 * h, 4 * w, c), dtype=np.float32))


def _jax_model(window):
    return jvrt.TinyVRT(window_size=WINDOWS[window], **KW)


def _redraw_tables(params, rng, window):
    """``params`` with the bias tables that depend on the temporal window
    (``residual_group2``'s: the trunk's window is 1 in both) drawn anew at
    ``window``'s size, as :func:`_random_params` draws them: one JAX
    ``eval_shape`` of the model serves both windows."""
    size = (2 * window[0] - 1) * (2 * window[1] - 1) * (2 * window[2] - 1)

    def draw(path, leaf):
        keys = [p.key for p in path]
        if keys[-1] == "relative_position_bias_table" and "residual_group2" in keys:
            return (0.05 * rng.standard_normal((size, leaf.shape[1]))).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(draw, params)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The parameters of each window (numpy over the JAX ``init``'s shapes:
    the bias tables' sizes follow the window) and the batch, written for
    the ranks."""
    root = tmp_path_factory.mktemp("vrt_sp_train")
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
    """Every mesh's ranks started together (the JAX and one-process
    references run while they work); any rank still running at the end of
    the module is killed."""
    root = setup[0]
    procs = {}
    for name, axes in MESHES.items():
        n = int(np.prod(list(axes.values())))
        spec = json.dumps({"axes": axes, "cases": CASES[name], "kw": KW, "windows": WINDOWS})
        port = _free_port()
        procs[name] = []
        for rank in range(n):
            env = _worker_env(root)
            env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(n),
                       LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="localhost", MASTER_PORT=str(port))
            procs[name].append(subprocess.Popen(
                [sys.executable, "-c", WORKER, str(root), name, spec], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    yield procs
    for ps in procs.values():
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _port(params, window, **kw):
    model = vrt.TinyVRT(**KW, window_size=WINDOWS[window], **kw)
    model.load_state_dict(convert.vrt_state_dict(params[window]))
    return model


def _one_process(params, window, batch) -> dict:
    """One process of the port on the whole batch: the eval step's
    metrics, and one SGD step's metrics, gradients and parameters after it."""
    metrics, _ = make_eval_step(_port(params, window))(None, batch)
    model = _port(params, window)
    state = create_train_state(model, build_tx(model.parameters(), ("sgd", {"lr": 0.1})))
    _, m = make_supervised_train_step(model)(state, batch)
    return {"eval": {k: float(v) for k, v in metrics.items()},
            "train": {k: float(v) for k, v in m.items()},
            "grads": {n: p.grad for n, p in model.named_parameters()},
            "params": model.state_dict()}


@pytest.fixture(scope="module")
def references(setup, rank_procs):
    """While the ranks run: the JAX TinyVRT's SR frames on the whole batch,
    one device, for each window (the two compiles side by side: XLA
    releases the GIL), and beside them :func:`_one_process` for each
    window at one thread, as the ranks run."""
    _, params, lr, hr = setup
    batch = {"lr": torch.from_numpy(lr), "hr": torch.from_numpy(hr)}
    out = {"jax": {}, "port": {}}

    def jax_sr(window):
        model = _jax_model(window)
        fn = jax.jit(lambda p, x: model.apply({"params": p}, x)[0])
        out["jax"][window] = np.asarray(fn(params[window], jnp.asarray(lr)))

    def port():
        with _OneThread():
            for window in WINDOWS:
                out["port"][window] = _one_process(params, window, batch)

    threads = [threading.Thread(target=jax_sr, args=(w,)) for w in WINDOWS]
    threads.append(threading.Thread(target=port))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert out["jax"].keys() == out["port"].keys() == WINDOWS.keys()
    return out


@pytest.fixture(scope="module")
def jax_sr(references):
    return references["jax"]


@pytest.fixture(scope="module")
def one_process(references):
    return references["port"]


@pytest.fixture(scope="module")
def rank_runs(setup, rank_procs, jax_sr, one_process):
    """Each rank's exit (one timeout a launch) and its records, by mesh."""
    root = setup[0]
    for name, ps in rank_procs.items():
        for p in ps:
            out = p.communicate(timeout=TIMEOUT)[0]
            assert p.returncode == 0, f"{name}:\n{out}"
    assert not (root / "imported").exists(), (root / "imported").read_text()
    return {name: [json.loads((root / f"{name}_rank{r}.json").read_text())
                   for r in range(int(np.prod(list(axes.values()))))]
            for name, axes in MESHES.items()}


def _cases():
    return [(name, w, c) for name in MESHES for w, c in CASES[name]]


def _ids(case):
    name, window, chunks = case
    return f"{name}-{window}" + (f"-align_chunks{chunks}" if chunks else "")


@pytest.mark.parametrize("case", _cases(), ids=_ids)
def test_split_forward_matches_jax(setup, rank_runs, jax_sr, case):
    """Each rank's SR frames (the eval step's) are its block of the JAX
    TinyVRT's on the whole batch, within atol 1e-5."""
    name, window, chunks = case
    axes = MESHES[name]
    b, t = LR_SHAPE[0] // axes["data"], LR_SHAPE[1] // axes["time"]
    for r in rank_runs[name]:
        d, k = r["coords"]["data"], r["coords"]["time"]
        assert r["block"] == [b, t, *LR_SHAPE[2:]]
        sr = torch.load(setup[0] / f"{name}_{window}_{chunks}_sr{r['rank']}.pt").numpy()
        want = jax_sr[window][d * b:(d + 1) * b, k * t:(k + 1) * t]
        np.testing.assert_allclose(sr, want, atol=SR_ATOL, rtol=0,
                                   err_msg=f"rank {r['rank']} of {name}")


@pytest.mark.parametrize("case", _cases(), ids=_ids)
def test_split_step_matches_one_process(setup, rank_runs, one_process, case):
    """The gradients the update applied (the mean over the whole mesh of
    each rank's, which hold the gradients its peers returned for its
    frames) within ``1e-5 + 1e-4|b|`` of one process's on the whole batch,
    the parameters after the step within atol 1e-5, the step's and the
    eval step's metrics within rtol 1e-5; the ranks' parameters are
    bitwise equal (each rank checked them against rank 0's)."""
    name, window, chunks = case
    want = one_process[window]
    got = torch.load(setup[0] / f"{name}_{window}_{chunks}.pt")
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
    for r in rank_runs[name]:
        for part in ("eval", "train"):
            rec = r[f"{window}_{chunks}"][part]
            assert rec.keys() == want[part].keys()
            for k, v in want[part].items():
                np.testing.assert_allclose(rec[k], v, rtol=METRIC_RTOL,
                                           err_msg=f"rank {r['rank']} {part} {k}")


def _blocks(window):
    """The (temporal window, shift) of each Stage's TMSA blocks of one
    forward, in order, on a clip of ``LR_SHAPE[1]`` frames (the trunk's
    window-1 blocks exchange nothing)."""
    t = LR_SHAPE[1]
    out = []
    for depth in KW["depths"][:5]:
        d1 = int(depth * 0.75)
        for wd, n in ((2, d1), (WINDOWS[window][0], depth - d1)):
            wd = min(wd, t)
            out += [(wd, 0 if i % 2 == 0 or wd == t else wd // 2) for i in range(n)]
    return out


@pytest.mark.parametrize("case", _cases(), ids=_ids)
def test_every_message_kind_is_sent(rank_runs, case):
    """Each rank posts, for each kind of message and each peer, as many
    messages as the window plans and the halos say: in the eval step one
    of each straddling block's frames a reader and one halo a neighbour
    each forward (the LR frames and each Stage's features); in the train
    step those again in each Stage's recompute (remat), and each of their
    gradients once. ``time = 3``'s ends exchange the window frames of the
    whole clip (window 6) and of the wrap-around (window 4)."""
    name, window, chunks = case
    key = f"{window}_{chunks}"
    ranks, stages = MESHES[name]["time"], len(KW["depths"]) - 2
    for r in rank_runs[name]:
        k, line = r["coords"]["time"], r["line"]
        plans = [window_plan(LR_SHAPE[1], ranks, k, wd, shift) for wd, shift in _blocks(window)]
        frames, grads = {}, {}
        for plan in plans:
            for j, _ in plan.post:
                frames[f"window:{line[j]}"] = frames.get(f"window:{line[j]}", 0) + 1
            for j, _ in plan.fetch:  # the gradients of what it read go back
                grads[f"window_grad:{line[j]}"] = grads.get(f"window_grad:{line[j]}", 0) + 1
        peers = [line[j] for j in (k - 1, k + 1) if 0 <= j < ranks]
        want_eval = {**frames, **{f"halo:{p}": 1 + stages for p in peers}}
        want_train = {**{f: 2 * n for f, n in frames.items()}, **grads,
                      **{f"halo:{p}": 1 + 2 * stages for p in peers},
                      **{f"halo_grad:{p}": stages for p in peers}}  # the LR frames need none
        assert r[key]["eval_messages"] == want_eval, f"rank {r['rank']}"
        assert r[key]["train_messages"] == want_train, f"rank {r['rank']}"
        assert grads and all(frames.values())
        if name == "time3" and k != 1:  # the line's ends read each other's frames
            assert f"window:{line[2 - k]}" in want_eval


@pytest.mark.parametrize("name", sorted(MESHES))
def test_uneven_blocks_and_differing_generators_raise(rank_runs, name):
    """Ranks of a line that hold different numbers of frames raise on every
    rank, as do generators in different states under stochastic depth
    (every rank of a line must drop the same paths of a clip)."""
    for r in rank_runs[name]:
        assert "must split into equal blocks" in r["uneven"], r["uneven"]
        assert "stochastic-depth generators differ" in r["generators"], r["generators"]


def test_window_plans():
    """The plans of the test's windows: each rank's frames sit in its
    windows' slots, and what a rank fetches from an owner is what the
    owner's plan posts to it; the paper's window over 2 ranks fetches the
    other rank's 3 frames; the shifted window 2 over 3 ranks pairs the
    line's ends (the wrap-around); window 1 and unshifted window 2 on even
    blocks send nothing."""
    for ranks in (2, 3):
        per = 6 // ranks
        for wd, shift in ((6, 0), (4, 2), (4, 0), (2, 1), (2, 0), (1, 0)):
            plans = [window_plan(6, ranks, k, wd, shift) for k in range(ranks)]
            for k, plan in enumerate(plans):
                slots = [plan.sources[plan.rows[g][0][i] * wd + plan.rows[g][1][p]]
                         for g, i, p in plan.place]
                assert slots == list(range(per))
                for j, frames in plan.fetch:
                    assert dict(plans[j].post)[k] == tuple(f - j * per for f in frames)
    assert window_plan(6, 2, 0, 6, 0).fetch == ((1, (3, 4, 5)),)
    assert window_plan(6, 3, 0, 2, 1).fetch == ((1, (2,)), (2, (5,)))
    padded = window_plan(6, 3, 0, 4, 2)  # the clip's first frames share the padded window
    assert padded.padded == 8 and not padded.fetch and padded.sources[:2] == (2, 2)
    assert not window_plan(6, 3, 0, 1, 0).sends and not window_plan(6, 3, 1, 2, 0).sends
    assert window_plan(6, 2, 0, 2, 0).sends  # 3 frames a rank: the window (2, 3) straddles


def test_unsupported_combinations_raise(setup):
    """Tiled serving of frames split over ``time`` raises before any
    message: its tiles would each need the other ranks' tiles at once.
    (Heads split over ``model`` on the same mesh run:
    ``test_torch_vrt_time_model.py``.)"""
    _, params, lr, _ = setup

    class Links:  # never reached: the check comes first
        def __getattr__(self, name):
            raise AssertionError(f"links.{name} used")

    mesh = parallel.Mesh(("time", "model"), (2, 2), 0, {}, {"time": Links()})
    with parallel.use_mesh(mesh), torch.no_grad():
        forward = harness.make_forward(_port(params, "w4", time_shard_axis="time"), tile=8,
                                       tile_overlap=2, device="cpu")
        with pytest.raises(ValueError, match="tiled serving"):
            forward(torch.from_numpy(lr))


def test_outside_a_mesh_the_model_is_unsplit(setup):
    """``time_shard_axis="time"`` outside ``use_mesh``, or inside it with a
    ``time`` axis of one rank, is the unsplit model bit for bit; the
    parameter tree is unchanged."""
    _, params, lr, _ = setup
    split = _port(params, "w4", time_shard_axis="time")
    plain = _port(params, "w4")
    assert split.state_dict().keys() == plain.state_dict().keys()
    x = torch.from_numpy(lr)
    with torch.no_grad(), _OneThread():
        want = plain(x)[0]
        got = [split(x)[0]]
        with parallel.use_mesh(parallel.Mesh(("data", "time"), (1, 1))):
            got.append(split(x)[0])
    for sr in got:
        assert torch.equal(sr, want)
