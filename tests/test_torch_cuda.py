"""vsrlab_tpu_torch's CUDA kernels on the card: agreement with the plain
version at ragged shapes, the launch counter, and the wrapper's refusals.

Skips without a CUDA device. On a machine with a card and no JAX, run
without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest

torch = pytest.importorskip("torch")

from vsrlab_tpu_torch.ops.residual_pair import (  # noqa: E402
    residual_conv_pair,
    residual_conv_pair_im2col,
    residual_conv_pair_plain,
)

pytestmark = pytest.mark.cuda
WRAPPERS = [residual_conv_pair, residual_conv_pair_im2col]


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


def _operands(shape, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    c = shape[-1]
    bound = 1.0 / (9 * c) ** 0.5
    x = torch.randn(shape, generator=g)
    w1, w2 = ((torch.rand((3, 3, c, c), generator=g) * 2 - 1) * bound for _ in range(2))
    b1, b2 = ((torch.rand((c,), generator=g) * 2 - 1) * bound for _ in range(2))
    return (x.to(device, dtype), w1.to(device, dtype), b1.to(device),
            w2.to(device, dtype), b2.to(device))


@pytest.mark.parametrize("wrapper", WRAPPERS)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(3, 7, 33, 64), (1, 1, 1, 64), (2, 25, 17, 64)])
def test_kernel_matches_plain(cuda, wrapper, dtype, tol, shape):
    ops = _operands(shape, dtype, cuda)
    before, before_shape = wrapper.launches, wrapper.launches_by_shape[shape]
    got = wrapper(*ops)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert wrapper.launches_by_shape[shape] == before_shape + 1
    assert got.dtype == dtype and got.shape == ops[0].shape
    torch.testing.assert_close(got.float(), residual_conv_pair_plain(*ops).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_kernel_refuses_what_it_does_not_take(cuda, wrapper):
    x, w1, b1, w2, b2 = _operands((1, 8, 8, 64), torch.bfloat16, cuda)
    before = wrapper.launches
    cases = [
        (x.half(), w1, b1, w2, b2),                       # dtype
        (x, w1.float(), b1, w2, b2),                      # weights not in x's type
        (x, w1, b1.bfloat16(), w2, b2),                   # biases not fp32
        (x.transpose(1, 2), w1, b1, w2, b2),              # not contiguous
        (x, w1, b1.cpu(), w2, b2),                        # mixed devices
    ]
    for case in cases:
        with pytest.raises(ValueError):
            wrapper(*case)
    x8, w8, b8, _, _ = _operands((1, 8, 8, 32), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="C=64"):
        wrapper(x8, w8, b8, w8, b8)
    assert wrapper.launches == before
