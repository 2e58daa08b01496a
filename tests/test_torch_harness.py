"""vsrlab_tpu_torch.evaluation.harness against vsrlab_tpu.evaluation.harness
on the CPU: windowed inference with T not a multiple of the window, and
streaming ``first`` / ``rest``. RealBasicVSR at mid 8, 1 block, 36x40,
params from the JAX init through ``convert``; gate atol 5e-4 (fp32), as
tests/test_torch_models.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vsrlab_tpu.evaluation import harness as jh  # noqa: E402
from vsrlab_tpu.models import RealBasicVSR as JRealBasicVSR  # noqa: E402
from vsrlab_tpu_torch import convert  # noqa: E402
from vsrlab_tpu_torch.evaluation import harness as th  # noqa: E402
from vsrlab_tpu_torch.models import RealBasicVSR  # noqa: E402

ATOL = 5e-4
H, W = 36, 40


@pytest.fixture(scope="module")
def models():
    jmodel = JRealBasicVSR(mid_channels=8, res_blocks=1, cleaning_blocks=1)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 2, H, W, 3)))["params"]
    params = jax.tree.map(np.asarray, params)
    model = RealBasicVSR(8, 1, 1)
    model.load_state_dict(convert.realbasicvsr_state_dict(params), strict=True)
    return jmodel, params, model


def test_windowed_inference_matches_jax(models):
    jmodel, params, model = models
    video = np.random.default_rng(1).random((1, 7, H, W, 3)).astype(np.float32)
    want, jn = jh.windowed_inference(jh.make_forward(jmodel), params, video, window_size=3)
    got, n = th.windowed_inference(th.make_forward(model, device="cpu"), video, 3)
    assert n == jn == 3
    assert got.shape == (1, 7, 4 * H, 4 * W, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_stream_forward_matches_jax(models):
    jmodel, params, model = models
    video = np.random.default_rng(2).random((1, 6, H, W, 3)).astype(np.float32)
    jfirst, jrest = jh.make_stream_forward(jmodel)
    first, rest = th.make_stream_forward(model, device="cpu")
    jsr_a, jstate = jfirst(params, jnp.asarray(video[:, :3]))
    jsr_b, _ = jrest(params, jnp.asarray(video[:, 3:]), jstate)
    sr_a, state = first(video[:, :3])
    sr_b, _ = rest(video[:, 3:], state)
    np.testing.assert_allclose(sr_a.numpy(), np.asarray(jsr_a), atol=ATOL)
    np.testing.assert_allclose(sr_b.numpy(), np.asarray(jsr_b), atol=ATOL)


def test_entry_points_refuse_missing_cuda(models):
    """Without a card, asking for CUDA (the default) raises, never runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, model = models
    with pytest.raises(RuntimeError, match="device='cpu'"):
        th.make_forward(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        th.make_stream_forward(model, device="cuda")
