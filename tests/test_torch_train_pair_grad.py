"""The residual pair's gradient (``ResidualPair``) on the CPU.

Its forward is the plain version here (a CPU tensor), its backward the
hand-derived one in PyTorch convolutions. Held against ``jax.vjp`` of
``residual_conv_pair_xla`` in fp32 for all five operands (1e-5: the same
sums in another order), against autograd through the plain version in
bf16 (the same rounding points; 1e-2 relative plus 1e-2 of the largest
value, for the order of bf16 roundings of sums), and at the module level:
every parameter of a ``ResidualBlock`` gets the gradient autograd through
the plain pair gives (1e-5), while inference still runs the wrapper, not
the Function, bit for bit as before.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vsrlab_tpu.ops.pallas_conv import residual_conv_pair_xla  # noqa: E402
from vsrlab_tpu_torch.models import RealBasicVSR  # noqa: E402
from vsrlab_tpu_torch.nn import blocks  # noqa: E402
from vsrlab_tpu_torch.ops import residual_pair as rp  # noqa: E402
from vsrlab_tpu_torch.train.builders import build_tx  # noqa: E402

SHAPES = [(2, 9, 11, 8), (1, 12, 12, 64)]


def _operands(rng, shape):
    c = shape[-1]
    s = 1.0 / np.sqrt(9 * c)
    return (rng.standard_normal(shape).astype(np.float32),
            (rng.uniform(-1, 1, (3, 3, c, c)) * s).astype(np.float32),
            (rng.uniform(-1, 1, c) * s).astype(np.float32),
            (rng.uniform(-1, 1, (3, 3, c, c)) * s).astype(np.float32),
            (rng.uniform(-1, 1, c) * s).astype(np.float32))


@pytest.mark.parametrize("formulation", ["taps", "im2col"])
@pytest.mark.parametrize("shape", SHAPES)
def test_gradients_match_jax_vjp_fp32(rng, shape, formulation):
    ops = _operands(rng, shape)
    g = rng.standard_normal(shape).astype(np.float32)
    out, vjp = jax.vjp(residual_conv_pair_xla, *map(jnp.asarray, ops))
    want = vjp(jnp.asarray(g))
    t_ops = [torch.from_numpy(a).requires_grad_(True) for a in ops]
    got = rp.residual_pair(*t_ops, formulation)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=1e-5, atol=1e-5)
    got.backward(torch.from_numpy(g))
    for name, t, w in zip(("x", "w1", "b1", "w2", "b2"), t_ops, want):
        scale = float(np.abs(np.asarray(w)).max())
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_gradients_match_autograd_through_plain(rng, shape):
    """bf16 operands: every gradient at the plain version's rounding points
    (weights' gradients in bf16, biases' in fp32, ``dx`` in bf16)."""
    ops = _operands(rng, shape)
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()

    def leaves():
        x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in ops)
        return [t.requires_grad_(True) for t in (x.bfloat16(), w1.bfloat16(), b1,
                                                 w2.bfloat16(), b2)]

    a, b = leaves(), leaves()
    out_fn = rp.residual_pair(*a, "taps")
    out_plain = rp.residual_conv_pair_plain(*b)
    assert torch.equal(out_fn, out_plain)
    out_fn.backward(g)
    out_plain.backward(g)
    for name, ta, tb in zip(("x", "w1", "b1", "w2", "b2"), a, b):
        assert ta.grad.dtype == tb.grad.dtype == tb.dtype, name
        want = tb.grad.float()
        torch.testing.assert_close(ta.grad.float(), want, rtol=1e-2,
                                   atol=1e-2 * float(want.abs().max()), msg=name)


def test_function_forward_launches_nothing_on_the_cpu(rng):
    ops = [torch.from_numpy(a).requires_grad_(True) for a in _operands(rng, (1, 4, 5, 8))]
    rp.reset_launch_counts()
    rp.residual_pair(*ops, "taps").sum().backward()
    assert rp.residual_conv_pair.launches == rp.residual_conv_pair_im2col.launches == 0


def test_residual_pair_refuses_an_unknown_formulation(rng):
    ops = [torch.from_numpy(a) for a in _operands(rng, (1, 4, 5, 8))]
    with pytest.raises(ValueError, match="formulation"):
        rp.residual_pair(*ops, "plain")


def _block(dtype=None):
    return blocks.init_weights(blocks.ResidualBlock(5, 16, 3, dtype=dtype),
                               torch.Generator().manual_seed(1))


def _grads(module, x, impl, g):
    blocks.set_pair_impl(module, impl)
    module.zero_grad(set_to_none=True)
    xx = x.clone().requires_grad_(True)
    out = module(xx)
    out.backward(g)
    return out.detach(), {"x": xx.grad, **{n: p.grad for n, p in module.named_parameters()}}


@pytest.mark.parametrize("impl", ["taps", "im2col"])
def test_every_residual_conv_weight_gets_the_plain_gradient(rng, impl):
    """The repair: no ``None`` gradient, no raise, and each parameter's
    gradient (and the input's) equal to autograd through the plain pair."""
    module = _block()
    x = torch.from_numpy(rng.standard_normal((2, 7, 9, 5)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 7, 9, 16)).astype(np.float32))
    out, got = _grads(module, x, impl, g)
    out_plain, want = _grads(module, x, "plain", g)
    torch.testing.assert_close(out, out_plain, rtol=0, atol=0)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] is not None and float(got[k].abs().sum()) > 0, k
        torch.testing.assert_close(got[k], want[k], rtol=1e-5,
                                   atol=1e-5 * float(want[k].abs().max()), msg=k)


def test_bf16_block_gradients_match_the_plain_path(rng):
    """A bf16 block (fp32 parameters): each parameter's gradient through
    the Function against autograd through the plain pair, as above."""
    module = _block(torch.bfloat16)
    x = torch.from_numpy(rng.random((1, 6, 8, 5)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((1, 6, 8, 16)).astype(np.float32)).bfloat16()
    _, got = _grads(module, x, "taps", g)
    _, want = _grads(module, x, "plain", g)
    for k in want:
        assert got[k].dtype == want[k].dtype
        torch.testing.assert_close(got[k].float(), want[k].float(), rtol=1e-2,
                                   atol=1e-2 * float(want[k].abs().max()), msg=k)


def test_two_forwards_accumulate_as_plain(rng):
    """Two forwards and backwards into one ``.grad`` (gradient
    accumulation): nothing graph-carrying is kept from the first."""
    module = _block()
    xs = [torch.from_numpy(rng.standard_normal((1, 6, 7, 5)).astype(np.float32))
          for _ in range(2)]
    grads = {}
    for impl in ("taps", "plain"):
        blocks.set_pair_impl(module, impl)
        module.zero_grad(set_to_none=True)
        for x in xs:
            module(x).square().mean().backward()
        grads[impl] = {n: p.grad.clone() for n, p in module.named_parameters()}
    for k in grads["plain"]:
        torch.testing.assert_close(grads["taps"][k], grads["plain"][k], rtol=1e-5,
                                   atol=1e-6, msg=k)


@pytest.mark.parametrize("mode", ["inference_mode", "no_grad"])
def test_serving_runs_the_wrapper_bit_for_bit(rng, monkeypatch, mode):
    """Without a gradient the unit calls the pair's wrapper on its cached
    operands, as before the Function existed: the Function is never
    entered and the output equals the plain pair of those operands."""
    unit = blocks.init_weights(blocks.ResidualConv(8), torch.Generator().manual_seed(2))
    x = torch.from_numpy(rng.standard_normal((2, 5, 6, 8)).astype(np.float32))
    with torch.no_grad():
        grad_path = unit(x.requires_grad_(False), "taps").clone()
    monkeypatch.setattr(rp.ResidualPair, "apply",
                        lambda *a: pytest.fail("the Function ran without a gradient"))
    with getattr(torch, mode)():
        got = unit(x, "taps")
        want = rp.residual_conv_pair_plain(x, *unit.pair_operands(torch.float32))
    assert torch.equal(got, want) and torch.equal(got, grad_path)


def test_model_inference_is_unchanged_by_the_grad_route(rng):
    """A whole RealBasicVSR: the output under ``inference_mode`` equals the
    forward of a training step (the Function's forward) bit for bit."""
    model = blocks.init_weights(RealBasicVSR(8, 1, 1), torch.Generator().manual_seed(4))
    clip = torch.from_numpy(rng.random((1, 3, 12, 12, 3)).astype(np.float32))
    with torch.inference_mode():
        sr, lq = model(clip)
    sr2, lq2 = model(clip)
    assert sr2.requires_grad
    assert torch.equal(sr, sr2.detach()) and torch.equal(lq, lq2.detach())


@pytest.mark.parametrize("optimizer", ["adam", "adamw", "sgd"])
def test_cached_operands_follow_an_optimizer_step(rng, optimizer):
    """The trainer's update bumps the parameters' versions: the cached
    operands and the taps kernel's weight order are laid out anew from the
    new weights."""
    unit = blocks.init_weights(blocks.ResidualConv(64), torch.Generator().manual_seed(3))
    first = unit.pair_fragments()
    x = torch.from_numpy(rng.standard_normal((1, 4, 4, 64)).astype(np.float32))
    unit(x).sum().backward()
    build_tx(unit.parameters(), (optimizer, {"lr": 1e-2, "weight_decay": 0.1})).step()
    again = unit.pair_fragments()
    assert again is not first
    w1, _, w2, _ = unit.pair_operands(torch.bfloat16)
    torch.testing.assert_close(w1, unit.conv1.weight.detach().permute(2, 3, 1, 0).bfloat16(),
                               rtol=0, atol=0)
    torch.testing.assert_close(again[1], rp.pack_weight_fragments(w2), rtol=0, atol=0)
