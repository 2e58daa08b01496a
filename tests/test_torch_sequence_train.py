"""Sequence-parallel training of RealBasicVSR in vsrlab_tpu_torch on the CPU,
against the JAX package's single-device step.

The JAX package splits each clip's frames over the ``time`` axis of a
``(data, time)`` mesh and leaves the exchanges to XLA
(``tests/test_parallel_train.py:219-254``). The port hands its
neighbours on the axis their halo frames and the recurrences' carries
(``parallel.TimeLinks``); ``RealBasicVSR(time_shard_axis="time")`` does so
inside ``parallel.use_mesh``. Here gloo CPU ranks (subprocesses with
torchrun's environment and ``jax`` / ``flax`` poisoned on their path,
one world of two ranks and one of four, each started once for the file)
take one SGD step (lr 0.1) of
``make_supervised_train_step`` with ``group=mesh.mesh_group`` on their
block of one seeded batch (``shard_batch_sp``), then run
``make_eval_step`` from the starting parameters:

* meshes: ``time = 2``, ``time = 4`` (one frame a rank: every middle rank
  receives and sends in both directions) and ``data = 2 x time = 2``;
* ``train_flow`` false and true (true sends the halo frames' gradients
  back to their owners' cleaners);
* gates: each rank's loss and metrics within rtol 1e-5 of the JAX step's
  on the whole batch, the parameters after the update within atol 1e-5 of
  the JAX step's (JAX's own tolerances) and bitwise equal on every rank;
  the eval metrics within rtol 1e-5 of the JAX eval step's; a step whose
  group is the data line only raises.
* Sharper, against one process of the port (fp32): the
  averaged gradients the update applied, each tensor within 1e-4 of its
  largest value (with these weights the recurrences' gradients are ~1e-4
  and a lost carry gradient would move the parameters by less than JAX's
  atol); and a loss on the flows alone (``compute_flow`` with the halo,
  each flow weighted by a seeded field), whose gradient reaches the
  frames through SpyNet only: each rank's frames' gradient and the
  SpyNet gradients summed over the ranks, by the same rule (the halo
  frames' gradients moved the cleaner's by ~1e-7 in the step).

In the test process: a ``T`` that does not split over the axis raises;
outside a mesh, or with a ``time`` axis of one rank, the model is the
unsplit one bit for bit; the placement helpers default to the rank's card.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

# pytest-xdist's workers share the machine's cores, and torch's default of a
# thread a core in each of them oversubscribes it many times over (beside
# XLA's own pools). Every worker imports every test module while it
# collects, so this sets one intra-op thread for the whole of each worker.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

from vsrlab_tpu.models import RealBasicVSR as JRealBasicVSR  # noqa: E402
from vsrlab_tpu.train import make_eval_step as j_make_eval  # noqa: E402
from vsrlab_tpu.train import make_supervised_train_step as j_make_step  # noqa: E402
from vsrlab_tpu.train.state import create_train_state as j_create  # noqa: E402
from vsrlab_tpu_torch import convert, parallel  # noqa: E402
from vsrlab_tpu_torch.models import RealBasicVSR  # noqa: E402
from vsrlab_tpu_torch.train.step import supervised_loss  # noqa: E402
from test_torch_parallel import TIMEOUT, _free_port, _worker_env  # noqa: E402
from test_torch_sequence_parallel import _OneThread  # noqa: E402
from test_torch_vrt import _random_params  # noqa: E402

LR, SCALE = (2, 4, 8, 8, 3), 4  # as tests/test_parallel_train.py:252-254
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5
GRAD_TOL = 1e-4  # of each gradient tensor's largest value, against one process
MESHES = {"time2": {"data": 1, "time": 2}, "time4": {"data": 1, "time": 4},
          "data2_time2": {"data": 2, "time": 2}}
TRAIN_FLOW = (False, True)

WORKER = r"""
import json, sys
import numpy as np, torch
from vsrlab_tpu_torch import parallel
from vsrlab_tpu_torch.models import RealBasicVSR
from vsrlab_tpu_torch.train.builders import build_tx
from vsrlab_tpu_torch.train.state import create_train_state
from vsrlab_tpu_torch.train.step import make_eval_step, make_supervised_train_step

root, cases = sys.argv[1], json.loads(sys.argv[2])
assert parallel.initialize_distributed("cpu")
state_dict = torch.load(f"{root}/params.pt")
whole = {"lr": np.load(f"{root}/lr.npy"), "hr": np.load(f"{root}/hr.npy")}
wf, wb = (torch.from_numpy(np.load(f"{root}/{k}.npy")) for k in ("wf", "wb"))


def model_for(train_flow):
    model = RealBasicVSR(8, 1, 1, train_flow=train_flow, time_shard_axis="time")
    model.load_state_dict(state_dict)
    return model


def sgd(model, group):
    return create_train_state(model, build_tx(model.parameters(), ("sgd", {"lr": 0.1}), None,
                                              None, group=group))


def run(name, axes):
    mesh = parallel.create_mesh(axes)
    r, group, links = mesh.rank, mesh.mesh_group, mesh.links["time"]
    batch = parallel.shard_batch_sp(whole, mesh, "cpu")
    res = {"rank": r, "coords": mesh.coords, "frames": batch["lr"].shape[1],
           "neighbours": [links.prev_rank, links.next_rank]}
    for train_flow in (False, True):
        model = model_for(train_flow)
        state = sgd(model, group)
        with parallel.use_mesh(mesh):
            _, m = make_supervised_train_step(model, group=group)(state, batch)
        parallel.assert_replicated(model, group, "updated parameters")
        res[f"train_flow={train_flow}"] = {k: float(v) for k, v in m.items()}
        if r == 0:  # the parameters after the update and the averaged gradients it applied
            torch.save({"params": model.state_dict(),
                        "grads": {n: p.grad for n, p in model.named_parameters()}},
                       f"{root}/{name}_{train_flow}.pt")

    # a loss on the flows alone: this rank's flows weighted by their block of a global field
    model = model_for(True)
    x = batch["lr"].clone().requires_grad_()
    with parallel.use_mesh(mesh):
        prev, next_frame = links.halo(x[:, 0], x[:, -1])
        ff, fb = model.basicvsr.compute_flow(x, prev, next_frame)
    rows = parallel.clip_sharding(mesh).index(whole["lr"].shape)[0]
    t, k, n = whole["lr"].shape[1], mesh.coords["time"], x.shape[1]
    ((ff * wf[rows, max(k * n - 1, 0):k * n + n - 1]).sum()
     + (fb * wb[rows, k * n:min(k * n + n, t - 1)]).sum()).backward()
    links.wait()
    spynet = [p.grad for p in model.basicvsr.spynet.parameters()]
    parallel.all_reduce_sum(spynet, group)
    torch.save({"frames": x.grad, "spynet": spynet if r == 0 else None},
               f"{root}/{name}_flows_rank{r}.pt")

    with parallel.use_mesh(mesh):
        metrics, sr = make_eval_step(model_for(False), group=group)(None, batch)
        res["eval"] = {k: float(v) for k, v in metrics.items()}
        res["sr_shape"] = list(sr.shape)
        # averaging over the data line alone would not give one process's gradient
        model = model_for(False)
        try:
            make_supervised_train_step(model, group=mesh.group)(sgd(model, mesh.group), batch)
            res["data_line"] = ""
        except ValueError as e:
            res["data_line"] = str(e)
    json.dump(res, open(f"{root}/{name}_rank{r}.json", "w"))


for name, axes in cases:
    run(name, axes)
torch.distributed.destroy_process_group()
"""


def _make_batch():
    rng = np.random.default_rng(3)
    b, t, h, w, c = LR
    return (rng.random(LR, dtype=np.float32),
            rng.random((b, t, h * SCALE, w * SCALE, c), dtype=np.float32))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The parameters (numpy over the JAX ``init``'s shapes) and the batch,
    written for the ranks."""
    root = tmp_path_factory.mktemp("sp_train")
    params = _random_params(JRealBasicVSR(mid_channels=8, res_blocks=1, cleaning_blocks=1),
                            np.random.default_rng(11), jnp.zeros((1, 2, 8, 8, 3)))
    torch.save(convert.realbasicvsr_state_dict(params), root / "params.pt")
    lr, hr = _make_batch()
    np.save(root / "lr.npy", lr)
    np.save(root / "hr.npy", hr)
    b, t, h, w, _ = LR
    field = np.random.default_rng(4).standard_normal((2, b, t - 1, h, w, 2)).astype(np.float32)
    np.save(root / "wf.npy", field[0])
    np.save(root / "wb.npy", field[1])
    return root, params, lr, hr


def _port_model(params, train_flow):
    model = RealBasicVSR(8, 1, 1, train_flow=train_flow)
    model.load_state_dict(convert.realbasicvsr_state_dict(params))
    return model


def _assert_close(got, want, what):
    """``max |got - want| <= GRAD_TOL * max |want|`` (exactly equal where
    ``want`` is zero)."""
    err = float((got - want).abs().max())
    assert err <= GRAD_TOL * float(want.abs().max()), f"{what}: {err:.3e} of " \
        f"{float(want.abs().max()):.3e}"


@pytest.fixture(scope="module")
def port_grads(setup):
    """One process of the port on the whole batch: the step's gradients for
    each ``train_flow``, and the flow loss's gradients to the frames and to
    SpyNet."""
    _, params, lr, hr = setup
    batch = {"lr": torch.from_numpy(lr), "hr": torch.from_numpy(hr)}
    out = {}
    with _OneThread():  # torch's threads crawl beside XLA's idle pool
        for train_flow in TRAIN_FLOW:
            model = _port_model(params, train_flow)
            supervised_loss(model(batch["lr"]), batch)[0].backward()
            out[train_flow] = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                               for n, p in model.named_parameters()}
        model = _port_model(params, True)
        x = batch["lr"].clone().requires_grad_()
        ff, fb = model.basicvsr.compute_flow(x)
        wf, wb = (torch.from_numpy(np.load(setup[0] / f"{k}.npy")) for k in ("wf", "wb"))
        ((ff * wf).sum() + (fb * wb).sum()).backward()
    out["flows"] = {"frames": x.grad,
                    "spynet": [p.grad for p in model.basicvsr.spynet.parameters()]}
    return out


def _worlds():
    """The meshes by world size: the two of four ranks run one after the
    other in one world."""
    worlds = {}
    for name, axes in MESHES.items():
        worlds.setdefault(int(np.prod(list(axes.values()))), []).append((name, axes))
    return worlds


@pytest.fixture(scope="module")
def rank_procs(setup):
    """Every world's ranks started together (the JAX and one-process
    references run while they work); any rank still running at the end of
    the module is killed."""
    root = setup[0]
    procs = {}
    for n, cases in _worlds().items():
        port = _free_port()
        procs[n] = []
        for rank in range(n):
            env = _worker_env(root)
            env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(n),
                       LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="localhost", MASTER_PORT=str(port))
            procs[n].append(subprocess.Popen(
                [sys.executable, "-c", WORKER, str(root), json.dumps(cases)], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    yield procs
    for ps in procs.values():
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def rank_runs(setup, rank_procs, jax_steps, port_grads):
    """Each rank's exit (one timeout a launch) and its records, by mesh."""
    root = setup[0]
    for n, ps in rank_procs.items():
        for p in ps:
            out = p.communicate(timeout=TIMEOUT)[0]
            assert p.returncode == 0, f"{_worlds()[n]}:\n{out}"
    assert not (root / "imported").exists(), (root / "imported").read_text()
    return {name: [json.loads((root / f"{name}_rank{r}.json").read_text())
                   for r in range(int(np.prod(list(axes.values()))))]
            for name, axes in MESHES.items()}


@pytest.fixture(scope="module")
def jax_steps(setup):
    """The JAX step on the whole batch, one device, for each ``train_flow``;
    and the JAX eval step from the starting parameters."""
    _, params, lr, hr = setup
    batch = {"lr": jnp.asarray(lr), "hr": jnp.asarray(hr)}
    out = {}
    for train_flow in TRAIN_FLOW:
        jmodel = JRealBasicVSR(mid_channels=8, res_blocks=1, cleaning_blocks=1,
                               train_flow=train_flow)
        state = j_create(jmodel, None, None, optax.sgd(0.1), variables={"params": params})
        state, metrics = j_make_step(jmodel, donate=False)(state, batch)
        out[train_flow] = ({k: float(v) for k, v in metrics.items()},
                           convert.realbasicvsr_state_dict(jax.tree.map(np.asarray, state.params)))
    metrics, _ = j_make_eval(jmodel)(params, batch)
    out["eval"] = {k: float(v) for k, v in metrics.items()}
    return out


@pytest.mark.parametrize("name", sorted(MESHES))
def test_ranks_hold_their_blocks(rank_runs, name):
    """Each rank holds ``T / time`` frames of its data rows and its
    neighbours are the ranks beside it on its time line."""
    axes = MESHES[name]
    for r in rank_runs[name]:
        k, n = r["coords"]["time"], axes["time"]
        assert r["frames"] == LR[1] // n
        assert r["neighbours"] == [r["rank"] - 1 if k > 0 else None,
                                   r["rank"] + 1 if k < n - 1 else None]
        assert r["sr_shape"] == [LR[0] // axes["data"], LR[1] // n, 32, 32, 3]


@pytest.mark.parametrize("train_flow", TRAIN_FLOW, ids=lambda v: f"train_flow={v}")
@pytest.mark.parametrize("name", sorted(MESHES))
def test_split_step_matches_jax_single_device(setup, rank_runs, jax_steps, name, train_flow):
    """Loss and metrics rtol 1e-5, every parameter after the update atol
    1e-5 of the JAX step on the whole batch; the ranks' parameters are
    bitwise equal (each rank checked them against rank 0's)."""
    want_metrics, want_params = jax_steps[train_flow]
    for r in rank_runs[name]:
        got = r[f"train_flow={train_flow}"]
        assert got.keys() == want_metrics.keys()
        for k, v in want_metrics.items():
            np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, err_msg=f"rank {r['rank']} {k}")
    got_params = torch.load(setup[0] / f"{name}_{train_flow}.pt")["params"]
    assert got_params.keys() == want_params.keys()
    start = convert.realbasicvsr_state_dict(setup[1])
    moved = set()
    for k, v in want_params.items():
        np.testing.assert_allclose(got_params[k].numpy(), v.numpy(), atol=PARAM_ATOL, rtol=0,
                                   err_msg=k)
        if not torch.equal(v, start[k]):
            moved.add(k.split(".")[0] + (".spynet" if ".spynet." in k else ""))
    # SpyNet trains under train_flow alone
    assert ("basicvsr.spynet" in moved) == train_flow and "cleaner" in moved


@pytest.mark.parametrize("train_flow", TRAIN_FLOW, ids=lambda v: f"train_flow={v}")
@pytest.mark.parametrize("name", sorted(MESHES))
def test_split_gradients_match_one_process(setup, rank_runs, port_grads, name, train_flow):
    """The gradients the update applied (the mean over the whole mesh of
    each rank's, which hold the carries' gradients from downstream) against
    one process's on the whole batch, each tensor within 1e-4 of its
    largest value; SpyNet's zero unless it trains."""
    got = torch.load(setup[0] / f"{name}_{train_flow}.pt")["grads"]
    want = port_grads[train_flow]
    assert got.keys() == want.keys()
    for k in want:
        _assert_close(got[k], want[k], k)
        if ".spynet." in k:
            assert bool(got[k].abs().sum() > 0) == train_flow, k


@pytest.mark.parametrize("name", sorted(MESHES))
def test_halo_gradients_reach_their_owners(setup, rank_runs, port_grads, name):
    """A loss on the flows alone, split: each rank's frames get one
    process's gradient (their halo copies' included, sent back by the
    neighbours), and the SpyNet gradients summed over the ranks are one
    process's."""
    axes = MESHES[name]
    want = port_grads["flows"]
    b, t = LR[0] // axes["data"], LR[1] // axes["time"]
    for r in rank_runs[name]:
        got = torch.load(setup[0] / f"{name}_flows_rank{r['rank']}.pt")
        d, k = r["coords"]["data"], r["coords"]["time"]
        _assert_close(got["frames"], want["frames"][d * b:(d + 1) * b, k * t:(k + 1) * t],
                      f"rank {r['rank']} frames")
    spynet = torch.load(setup[0] / f"{name}_flows_rank0.pt")["spynet"]
    for i, (g, w) in enumerate(zip(spynet, want["spynet"], strict=True)):
        _assert_close(g, w, f"SpyNet parameter {i}")


@pytest.mark.parametrize("name", sorted(MESHES))
def test_split_eval_matches_jax(rank_runs, jax_steps, name):
    """The eval step's loss and metrics, averaged over the whole mesh,
    within rtol 1e-5 of the JAX eval step's on the whole batch."""
    for r in rank_runs[name]:
        assert r["eval"].keys() == jax_steps["eval"].keys()
        for k, v in jax_steps["eval"].items():
            np.testing.assert_allclose(r["eval"][k], v, rtol=LOSS_RTOL, err_msg=k)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_step_over_the_data_line_raises(rank_runs, name):
    """A rank's gradients hold its part of every rank's loss: only their mean
    over the whole mesh is one process's gradient, so a step whose group is
    the data line's (None for one data rank) raises before it computes."""
    for r in rank_runs[name]:
        assert "averages over all" in r["data_line"] and \
            f"group of {MESHES[name]['data']}" in r["data_line"]


def test_frames_that_do_not_split_raise():
    """``shard_batch_sp`` refuses a ``T`` (or a batch) that does not split
    into equal blocks over the mesh."""
    lr, _ = _make_batch()
    mesh = parallel.Mesh(("data", "time"), (1, 2), 1)
    with pytest.raises(ValueError, match="axis 1 of .* does not split into 2 equal parts over "
                                         "'time'"):
        parallel.shard_batch_sp({"lr": lr[:, :3]}, mesh, "cpu")
    with pytest.raises(ValueError, match="axis 0 of .* does not split"):
        parallel.shard_batch_sp({"lr": lr[:1]}, parallel.Mesh(("data", "time"), (2, 1)), "cpu")
    assert parallel.shard_batch_sp({"lr": lr}, mesh, "cpu")["lr"].shape == (2, 2, 8, 8, 3)


def test_outside_a_mesh_the_model_is_unsplit(setup):
    """``time_shard_axis="time"`` outside ``use_mesh``, or inside it with a
    ``time`` axis of one rank, is the unsplit model bit for bit, with no
    neighbour links; the parameter tree is unchanged."""
    _, params, lr, _ = setup
    state = convert.realbasicvsr_state_dict(params)
    split = RealBasicVSR(8, 1, 1, time_shard_axis="time")
    assert split.state_dict().keys() == state.keys()
    split.load_state_dict(state)
    plain = _port_model(params, False)
    x = torch.from_numpy(lr)
    with torch.no_grad(), _OneThread():
        want = plain(x)
        one = parallel.Mesh(("data", "time"), (1, 1))
        assert parallel.active_links("time") is None
        got = [split(x)]
        with parallel.use_mesh(one):
            assert parallel.active_links("time") is None
            got.append(split(x))
    for sr, lq in got:
        assert torch.equal(sr, want[0]) and torch.equal(lq, want[1])


def test_placement_defaults_name_the_rank_card(monkeypatch):
    """``shard_batch``, ``shard_batch_sp`` and ``initialize_distributed``
    default to this rank's card: ``cuda:LOCAL_RANK`` where each rank has
    one (NCCL, the card set as current)."""
    import inspect

    for fn in (parallel.shard_batch, parallel.shard_batch_sp, parallel.initialize_distributed):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    placed = []
    monkeypatch.setattr(torch.Tensor, "to", lambda self, device: placed.append(device) or self)
    parallel.shard_batch({"lr": torch.zeros(4, 2)})
    parallel.shard_batch_sp({"lr": torch.zeros(2, 4)}, parallel.Mesh(("data", "time"), (1, 2), 1))
    assert placed == [torch.device("cuda", 1)] * 2
    calls = []
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(("set_device", d)))
    monkeypatch.setattr(parallel.mesh.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(parallel.mesh.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw["rank"])))
    assert parallel.initialize_distributed()
    assert calls == [("set_device", torch.device("cuda", 1)), ("nccl", 1)]
