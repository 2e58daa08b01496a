"""VRT training in vsrlab_tpu_torch against vsrlab_tpu on the CPU, fp32.

A tiny TinyVRT (depth 1 a stage, 8 channels, 2 heads, window (2, 4, 4),
2 offset groups of 4 channels) on a batch of 2 clips of 4 frames at 16x16
-> 64x64. Parameters are drawn with numpy over the JAX ``init``'s shapes
(``test_torch_vrt._random_params``: the offset / mask heads non-zero) and
go into both packages (``convert.vrt_state_dict``). Each package takes two
steps of its own ``make_supervised_train_step`` with SGD at 0.1: one JAX
compile (module fixture) serves every port route, and the JAX gradient of
the first step is its parameter update over the learning rate (exact to
a few 1e-7). Gates: losses and metrics rtol 1e-5, parameters atol 2e-5
(as ``test_torch_gan_step.py``), the first step's gradients atol 1e-5 +
rtol 1e-4. On the CPU the ``fused`` and ``take`` routes are autograd
through their kernels' plain versions. ``test_torch_vrt_train_parts.py``
holds the parts of VRT training that need no JAX step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import vsrlab_tpu.components  # noqa: E402,F401
import vsrlab_tpu_torch.components  # noqa: E402,F401
from vsrlab_tpu.models import vrt as jvrt  # noqa: E402
from vsrlab_tpu.train import builders as jbuilders  # noqa: E402
from vsrlab_tpu.train.state import create_train_state as j_create  # noqa: E402
from vsrlab_tpu.train.step import make_supervised_train_step as j_make_step  # noqa: E402
from vsrlab_tpu_torch import convert  # noqa: E402
from vsrlab_tpu_torch.models import vrt  # noqa: E402
from vsrlab_tpu_torch.nn.blocks import set_sampler_impl  # noqa: E402
from vsrlab_tpu_torch.train.builders import build_tx  # noqa: E402
from vsrlab_tpu_torch.train.state import create_train_state  # noqa: E402
from vsrlab_tpu_torch.train.step import make_supervised_train_step  # noqa: E402
from test_torch_vrt import _random_params  # noqa: E402

KW = dict(upscale=4, window_size=(2, 4, 4), depths=(1,) * 7, embed_dims=(8,) * 7,
          num_heads=(2,) * 7, deformable_groups=2)
B, T, H, W = 2, 4, 16, 16
LR = 0.1
OPT = {"_target_": "sgd", "lr": LR}
STEPS = 2
ROUTES = ("plain", "fused", "take")


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(11)
    return (rng.random((B, T, H, W, 3)).astype(np.float32),
            rng.random((B, T, 4 * H, 4 * W, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def params(batch):
    return _random_params(jvrt.TinyVRT(**KW), np.random.default_rng(3), jnp.asarray(batch[0]))


@pytest.fixture(scope="module")
def jax_run(batch, params):
    """The JAX step twice (one compile): the metrics of each step, the
    parameters after each (port layout), the first step's gradient."""
    jmodel = jvrt.TinyVRT(**KW)
    state = j_create(jmodel, None, None, jbuilders.build_tx(OPT), variables={"params": params})
    step = j_make_step(jmodel, donate=False)
    jb = {"lr": jnp.asarray(batch[0]), "hr": jnp.asarray(batch[1])}
    trees, metrics = [convert.vrt_state_dict(params)], []
    for _ in range(STEPS):
        state, m = step(state, jb)
        metrics.append({k: float(v) for k, v in m.items()})
        trees.append(convert.vrt_state_dict(jax.tree.map(np.asarray, state.params)))
    grads = {k: (trees[0][k] - trees[1][k]) / LR for k in trees[0]}
    return {"metrics": metrics, "params": trees, "grads": grads}


def _port(params, impl, **kw):
    model = vrt.TinyVRT(**KW, **kw)
    model.load_state_dict(convert.vrt_state_dict(params), strict=True)
    return set_sampler_impl(model, impl).train()


def _tensors(batch):
    return {"lr": torch.from_numpy(batch[0]), "hr": torch.from_numpy(batch[1])}


@pytest.mark.parametrize("impl", ROUTES)
def test_two_steps_match_jax(batch, params, jax_run, impl):
    """Losses and metrics of each step, the first step's gradient of every
    parameter, and every parameter after each step; SpyNet unmoved."""
    model = _port(params, impl)
    state = create_train_state(model, build_tx(model.parameters(), OPT))
    step = make_supervised_train_step(model)
    for i in range(STEPS):
        state, m = step(state, _tensors(batch))
        want = jax_run["metrics"][i]
        assert m.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(float(m[k]), want[k], rtol=1e-5, err_msg=f"step {i} {k}")
        if i == 0:
            for name, p in model.named_parameters():
                np.testing.assert_allclose(p.grad.numpy(), jax_run["grads"][name], atol=1e-5,
                                           rtol=1e-4, err_msg=f"grad {name}")
        got = model.state_dict()
        for name, v in jax_run["params"][i + 1].items():
            np.testing.assert_allclose(got[name].numpy(), v, atol=2e-5, rtol=0,
                                       err_msg=f"step {i} {name}")
    start = jax_run["params"][0]
    spynet = {k: v for k, v in model.state_dict().items() if k.startswith("optical_flow.")}
    assert spynet and all(torch.equal(v, start[k]) for k, v in spynet.items())
