"""Head-sharded VRT attention (``head_shard_axis``) in vsrlab_tpu_torch on
the CPU, over two gloo ranks of a ``model`` mesh axis.

Two ranks (subprocesses with torchrun's environment and ``jax`` / ``flax``
poisoned on their path, started once for the file) load the same
parameters and run, inside ``parallel.use_mesh(create_mesh({"model": 2}))``:

* TinyVRT at ``tests/test_parallel_train.py:300-314``'s configuration
  (``head_shard_axis="model"``, 2 heads a stage, 8 channels, depth 2,
  window (2, 4, 4)) on a ``(1, 2, 16, 16, 3)`` clip: its output within
  atol 1e-5 of the port's unsharded TinyVRT (the JAX test's own gate;
  ``tests/test_torch_vrt.py`` holds the unsharded port against JAX), the
  same model outside ``use_mesh`` within 1e-6 of it (one rank's heads are
  all its heads there), and one backward's gradients, summed over the
  ranks by ``all_reduce_head_grads``, within ``1e-5 + 1e-4|b|`` of the
  unsharded gradients;
* one ``WindowAttention`` with 3 heads (2 on rank 0, 1 on rank 1), one
  without mutual attention and one with a single head (rank 1 holds
  none): output, input gradient and parameter gradients within
  ``1e-5 + 1e-4|b|`` of one process's.

Both ranks end with the same output and gradients bit for bit.
"""

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vsrlab_tpu_torch.models.vrt import TinyVRT  # noqa: E402
from vsrlab_tpu_torch.models.vrt.window_attention import (  # noqa: E402
    WindowAttention,
    compute_mask_factored,
    head_range,
)
from vsrlab_tpu_torch.nn.blocks import init_weights  # noqa: E402
from test_torch_parallel import TIMEOUT, _free_port, _worker_env  # noqa: E402

KW = dict(upscale=4, window_size=(2, 4, 4), depths=(2,) * 7, embed_dims=(8,) * 7,
          num_heads=(2,) * 7, deformable_groups=2, drop_path_rate=0.0)
ATOL = 1e-5  # the sharded output against the unsharded one (JAX's gate)
GRAD_TOL = (1e-5, 1e-4)  # |a - b| <= atol + rtol * |b|
# WindowAttention cases: dim, heads, mutual attention, windows x tokens
ATTN = [dict(dim=12, num_heads=3, mut_attn=True), dict(dim=12, num_heads=2, mut_attn=False),
        dict(dim=8, num_heads=1, mut_attn=True)]

WORKER = r"""
import sys
import torch
from vsrlab_tpu_torch import parallel
from vsrlab_tpu_torch.models.vrt import TinyVRT
from vsrlab_tpu_torch.models.vrt.window_attention import WindowAttention, all_reduce_head_grads

root = sys.argv[1]
assert parallel.initialize_distributed("cpu")
r = parallel.process_index()
mesh = parallel.create_mesh({"model": 2})
spec = torch.load(f"{root}/spec.pt", weights_only=False)
out = {"shape": mesh.shape}
model = TinyVRT(**spec["kw"], head_shard_axis="model")
model.load_state_dict(spec["vrt"])
x = spec["x"]
with torch.no_grad():
    out["outside"] = model(x)[0]
    with parallel.use_mesh(mesh):
        out["sr"] = model(x)[0]
        out["heads"] = sorted({m.head_shard()[1:] for m in model.modules()
                               if isinstance(m, WindowAttention)})
with parallel.use_mesh(mesh):
    (model(x)[0] * spec["w"]).sum().backward()
    all_reduce_head_grads(model)
out["vrt_grads"] = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
for i, case in enumerate(spec["attn"]):
    attn = WindowAttention(**case["kw"], window_size=(2, 4, 4), head_shard_axis="model")
    attn.load_state_dict(case["state"])
    xi = case["x"].clone().requires_grad_(True)
    with parallel.use_mesh(mesh):
        y = attn(xi, case["mask"])
        (y * case["w"]).sum().backward()
        all_reduce_head_grads(attn)
        heads = attn.head_shard()[1:]
    out[f"attn{i}"] = {"y": y.detach(), "dx": xi.grad, "heads": heads,
                       "grads": {n: p.grad for n, p in attn.named_parameters()}}
torch.save(out, f"{root}/rank{r}.pt")
torch.distributed.destroy_process_group()
"""


def _vrt_spec():
    g = torch.Generator().manual_seed(0)
    model = init_weights(TinyVRT(**KW), g)
    with torch.no_grad():  # the offset heads start at zero; draw them so the alignment samples
        for name, p in model.named_parameters():
            if "conv_offset" in name:
                p.normal_(0.0, 0.02, generator=g)
    x = torch.rand((1, 2, 16, 16, 3), generator=g)
    w = torch.randn((1, 2, 64, 64, 3), generator=g)
    return model, x, w


def _attn_case(i, kw):
    g = torch.Generator().manual_seed(10 + i)
    attn = init_weights(WindowAttention(**kw, window_size=(2, 4, 4)), g)
    x = torch.randn((4, 32, kw["dim"]), generator=g)
    w = torch.randn((4, 32, kw["dim"]), generator=g)
    # a shifted block's mask over a (2, 8, 4) clip: two windows a clip
    mask = compute_mask_factored(2, 8, 4, (2, 4, 4), (1, 2, 2))
    return attn, x, w, mask


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    model, x, w = _vrt_spec()
    attn = []
    for i, kw in enumerate(ATTN):
        m, ax, aw, mask = _attn_case(i, kw)
        attn.append({"kw": kw, "state": m.state_dict(), "x": ax, "w": aw, "mask": mask})
    torch.save({"kw": KW, "vrt": model.state_dict(), "x": x, "w": w, "attn": attn},
               root / "spec.pt")
    port = _free_port()
    procs = []
    for rank in range(2):
        env = _worker_env(root)
        env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, "-c", WORKER, str(root)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    for p in procs:
        try:
            out, _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        assert p.returncode == 0, out
    assert not (root / "imported").exists(), (root / "imported").read_text()
    return [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(2)]


def _close(a, b, label):
    d = (a - b).abs()
    bad = d > GRAD_TOL[0] + GRAD_TOL[1] * b.abs()
    assert not bool(bad.any()), f"{label}: max |a-b| {float(d.max()):.3e}"


@pytest.mark.parametrize("heads,parts,want", [
    (6, 4, [(0, 2), (2, 4), (4, 5), (5, 6)]), (3, 2, [(0, 2), (2, 3)]), (2, 2, [(0, 1), (1, 2)]),
    (1, 2, [(0, 1), (1, 1)]), (6, 1, [(0, 6)])])
def test_head_range_cuts_contiguous_near_equal_ranges(heads, parts, want):
    assert [head_range(heads, parts, k) for k in range(parts)] == want


def test_tinyvrt_sharded_matches_unsharded(tp_runs):
    model, x, w = _vrt_spec()
    with torch.no_grad():
        want = model.eval()(x)[0]
    for rank, rec in enumerate(tp_runs):
        assert rec["shape"] == {"model": 2}
        assert rec["heads"] == [(rank, rank + 1)]  # 2 heads a stage: one a rank
        np.testing.assert_allclose(rec["sr"].numpy(), want.numpy(), atol=ATOL, rtol=0)
        np.testing.assert_allclose(rec["outside"].numpy(), want.numpy(), atol=1e-6, rtol=0)
    assert torch.equal(tp_runs[0]["sr"], tp_runs[1]["sr"])


def test_tinyvrt_sharded_gradients_match_unsharded(tp_runs):
    model, x, w = _vrt_spec()
    (model.train()(x)[0] * w).sum().backward()
    want = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    assert not any(n.startswith("optical_flow") for n in want)  # SpyNet frozen
    for rec in tp_runs:
        assert rec["vrt_grads"].keys() == want.keys()
        for n, g in want.items():
            _close(rec["vrt_grads"][n], g, n)
    for n in want:
        assert torch.equal(tp_runs[0]["vrt_grads"][n], tp_runs[1]["vrt_grads"][n]), n


@pytest.mark.parametrize("case", range(len(ATTN)), ids=[str(a) for a in ATTN])
def test_window_attention_sharded_matches_one_process(tp_runs, case):
    """Output, input gradient and every parameter's gradient (relative
    position table, both QKV projections, the projection) against one
    process's, each rank's heads a contiguous range."""
    attn, x, w, mask = _attn_case(case, ATTN[case])
    x.requires_grad_(True)
    y = attn(x, mask)
    (y * w).sum().backward()
    nh = ATTN[case]["num_heads"]
    for rank, rec in enumerate(tp_runs):
        got = rec[f"attn{case}"]
        assert got["heads"] == head_range(nh, 2, rank)
        _close(got["y"], y.detach(), "output")
        _close(got["dx"], x.grad, "input gradient")
        assert got["grads"].keys() == dict(attn.named_parameters()).keys()
        for n, p in attn.named_parameters():
            _close(got["grads"][n], p.grad, n)
    a, b = (rec[f"attn{case}"] for rec in tp_runs)
    assert torch.equal(a["y"], b["y"]) and torch.equal(a["dx"], b["dx"])


def test_unsharded_outside_a_mesh_with_the_axis():
    """Outside ``use_mesh``, or in a mesh without the axis, or with it at one
    rank, the module shards nothing and equals the module without the axis
    bit for bit."""
    from vsrlab_tpu_torch import parallel

    attn, x, _, mask = _attn_case(0, ATTN[0])
    sharded = WindowAttention(**ATTN[0], window_size=(2, 4, 4), head_shard_axis="model")
    sharded.load_state_dict(attn.state_dict())
    with torch.no_grad():
        want = attn(x, mask)
        assert sharded.head_shard() is None and torch.equal(sharded(x, mask), want)
        for axes in ({"data": 1}, {"data": 1, "model": 1}):
            with parallel.use_mesh(parallel.create_mesh(axes)):
                assert sharded.head_shard() is None and torch.equal(sharded(x, mask), want)
    assert parallel.active_mesh() is None
