"""vsrlab_tpu_torch.ops.residual_pair against vsrlab_tpu.ops.pallas_conv on the CPU.

The plain version is held against the XLA lowering and against both
Pallas kernels in interpret mode, at tests/test_pallas_conv.py's shapes:
fp32 at 1e-5 (summation order differs), bf16 at 2e-2 (one bf16 rounding
at the residual add). The CUDA kernels themselves run only on the card
(chip_smoke.py); here the wrappers must take the plain path for a CPU
tensor and refuse what the kernels do not take.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vsrlab_tpu.ops.pallas_conv import (  # noqa: E402
    residual_conv_pair as pallas_taps,
    residual_conv_pair_im2col as pallas_im2col,
    residual_conv_pair_xla,
)
from vsrlab_tpu_torch.nn.blocks import ResidualConv  # noqa: E402
from vsrlab_tpu_torch.ops.residual_pair import (  # noqa: E402
    pack_weight_fragments,
    reset_launch_counts,
    residual_conv_pair,
    residual_conv_pair_im2col,
    residual_conv_pair_plain,
)

SHAPES = [
    ((1, 24, 16, 8), 12),   # multiple row blocks
    ((2, 12, 20, 8), 4),    # batch grid + odd width
    ((1, 12, 12, 64), 12),  # production channel width
]


def _operands(rng, shape):
    c = shape[-1]
    return (
        rng.standard_normal(shape).astype(np.float32),
        (rng.standard_normal((3, 3, c, c)) * 0.1).astype(np.float32),
        rng.standard_normal((c,)).astype(np.float32),
        (rng.standard_normal((3, 3, c, c)) * 0.1).astype(np.float32),
        rng.standard_normal((c,)).astype(np.float32),
    )


def _torch(ops, dtype=torch.float32):
    x, *rest = (torch.from_numpy(a) for a in ops)
    return (x.to(dtype), *rest)


@pytest.mark.parametrize("shape,block_rows", SHAPES)
def test_plain_matches_xla_and_pallas_fp32(rng, shape, block_rows):
    ops = _operands(rng, shape)
    got = residual_conv_pair_plain(*_torch(ops)).numpy()
    jops = [jnp.asarray(a) for a in ops]
    want = [
        residual_conv_pair_xla(*jops),
        pallas_taps(*jops, block_rows=block_rows, interpret=True),
        pallas_im2col(*jops, block_rows=block_rows, interpret=True),
    ]
    for w in want:
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-5, atol=1e-5)


def test_plain_matches_xla_and_pallas_bf16(rng):
    ops = _operands(rng, (1, 24, 16, 8))
    got = residual_conv_pair_plain(*_torch(ops, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    jx = jnp.asarray(ops[0], jnp.bfloat16)
    jrest = [jnp.asarray(a) for a in ops[1:]]
    for want in (
        residual_conv_pair_xla(jx, *jrest),
        pallas_taps(jx, *jrest, block_rows=12, interpret=True),
        pallas_im2col(jx, *jrest, block_rows=12, interpret=True),
    ):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("wrapper", [residual_conv_pair, residual_conv_pair_im2col])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_on_cpu_is_plain_and_launches_nothing(rng, wrapper, dtype):
    ops = _torch(_operands(rng, (2, 13, 21, 64)), dtype)
    before, before_by_shape = wrapper.launches, wrapper.launches_by_shape.copy()
    got = wrapper(*ops)
    assert wrapper.launches == before
    assert wrapper.launches_by_shape == before_by_shape
    torch.testing.assert_close(got, residual_conv_pair_plain(*ops), rtol=0, atol=0)


def test_reset_launch_counts_zeroes_every_wrapper():
    for wrapper in (residual_conv_pair, residual_conv_pair_im2col):
        wrapper.launches += 3
        wrapper.launches_by_shape[(1, 2, 3, 64)] += 3
    reset_launch_counts()
    for wrapper in (residual_conv_pair, residual_conv_pair_im2col):
        assert wrapper.launches == 0
        assert sum(wrapper.launches_by_shape.values()) == 0


@pytest.mark.parametrize("wrapper", [residual_conv_pair, residual_conv_pair_im2col])
@pytest.mark.parametrize("grad_arg", [0, 1])
def test_wrapper_refuses_inputs_that_require_grad(rng, wrapper, grad_arg):
    ops = list(_torch(_operands(rng, (1, 4, 5, 8))))
    ops[grad_arg].requires_grad_(True)
    with pytest.raises(ValueError, match="forward-only"):
        wrapper(*ops)


@pytest.mark.parametrize("bad", ["w_shape", "b_shape", "x_rank"])
def test_wrapper_refuses_bad_shapes(rng, bad):
    x, w1, b1, w2, b2 = _torch(_operands(rng, (1, 4, 5, 8)))
    if bad == "w_shape":
        w1 = w1[:, :, :4]
    elif bad == "b_shape":
        b2 = b2[:4]
    else:
        x = x[0]
    with pytest.raises(ValueError):
        residual_conv_pair(x, w1, b1, w2, b2)


def test_pack_weight_fragments_matches_the_hwio_original(rng):
    """Every register of every lane, against its definition from the HWIO
    weights: the pair (ci, ci + 1) of one output channel, low half first."""
    w = torch.from_numpy(rng.standard_normal((3, 3, 64, 64)).astype(np.float32)).bfloat16()
    packed = pack_weight_fragments(w)
    assert packed.shape == (36, 4, 32, 4) and packed.dtype == torch.int32
    assert packed.is_contiguous()
    bits = w.reshape(9, 64, 64).view(torch.int16).numpy().astype(np.int64) & 0xFFFF
    got = packed.numpy().astype(np.int64) & 0xFFFFFFFF
    for step in range(36):
        tap, kc = divmod(step, 4)
        for wq in range(4):
            for lane in range(32):
                g, t = divmod(lane, 4)
                for r in range(4):
                    co = 16 * wq + g + 8 * (r & 1)
                    ci = 16 * kc + 2 * t + 8 * (r >> 1)
                    want = bits[tap, ci, co] | (bits[tap, ci + 1, co] << 16)
                    assert got[step, wq, lane, r] == want, (step, wq, lane, r)


def test_pack_weight_fragments_refuses_other_weights():
    with pytest.raises(ValueError):
        pack_weight_fragments(torch.zeros((3, 3, 64, 64)))            # not bf16
    with pytest.raises(ValueError):
        pack_weight_fragments(torch.zeros((3, 3, 8, 8)).bfloat16())   # not C = 64


@pytest.mark.parametrize("tap", range(9))
def test_pack_weight_fragments_keeps_each_tap_in_its_own_steps(rng, tap):
    """The kernel takes tap ``t`` from steps ``4t .. 4t + 3``: a change to
    that tap's weights changes those steps, every word of them, and no other."""
    w = torch.from_numpy(rng.standard_normal((3, 3, 64, 64)).astype(np.float32)).bfloat16()
    changed = w.clone()
    changed[tap // 3, tap % 3] += 1.0
    differs = (pack_weight_fragments(w) != pack_weight_fragments(changed)).reshape(9, -1)
    assert bool(differs[tap].all())
    assert not bool(differs[[t for t in range(9) if t != tap]].any())


def _unit(rng):
    unit = ResidualConv(64)
    with torch.no_grad():
        for p in unit.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32)) * 0.1)
    return unit


def test_residual_conv_fragments_are_those_of_its_bf16_operands(rng):
    unit = _unit(rng)
    w1, _, w2, _ = unit.pair_operands(torch.bfloat16)
    f1, f2 = unit.pair_fragments()
    torch.testing.assert_close(f1, pack_weight_fragments(w1), rtol=0, atol=0)
    torch.testing.assert_close(f2, pack_weight_fragments(w2), rtol=0, atol=0)
    # HWIO operands of the module's OIHW parameters
    torch.testing.assert_close(w1, unit.conv1.weight.detach().permute(2, 3, 1, 0).bfloat16(),
                               rtol=0, atol=0)


@pytest.mark.parametrize("inference", [False, True])
@pytest.mark.parametrize("change", ["none", "written", "replaced", "other_dtype"])
def test_residual_conv_fragments_follow_the_parameters(rng, change, inference):
    """Laid out once, and again when a parameter was written in place or
    replaced or the operands were rebuilt for another compute type, also
    where the operands are made in inference mode (no version counter on
    them: the cache is keyed on the parameters)."""
    unit = _unit(rng)
    with torch.inference_mode(inference):
        first = unit.pair_fragments()
        assert unit.pair_fragments() is first
    with torch.no_grad():
        if change == "written":
            unit.conv2.weight.mul_(-1.5)
        elif change == "replaced":
            unit.conv1.weight = torch.nn.Parameter(unit.conv1.weight.detach() + 0.25)
    with torch.inference_mode(inference):
        if change == "other_dtype":
            unit.pair_operands(torch.float32)
        again = unit.pair_fragments()
        if change == "none":
            assert again is first
            return
        assert again is not first
        w1, _, w2, _ = unit.pair_operands(torch.bfloat16)
        torch.testing.assert_close(again[0], pack_weight_fragments(w1), rtol=0, atol=0)
        torch.testing.assert_close(again[1], pack_weight_fragments(w2), rtol=0, atol=0)
        assert torch.equal(again[0], first[0]) == (change != "replaced")
        assert torch.equal(again[1], first[1]) == (change != "written")
