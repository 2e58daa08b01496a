"""The work counts: the residual pair by hand, the models by FlopCounterMode
over the reference on the meta device."""

import math

import pytest
import torch

from port_bench import work
from port_bench.reference import realbasicvsr, vrt


@pytest.mark.parametrize("shape,dtype", [((4, 180, 320, 64), "bfloat16"),
                                         ((2, 17, 23, 64), "float32")])
def test_pair_work_by_hand(shape, dtype):
    b, h, w, c = shape
    size = 2 if dtype == "bfloat16" else 4
    macs = 2 * b * h * w * (3 * 3 * c) * c  # two 3x3 convs, C in and out
    nbytes = 2 * b * h * w * c * size + 2 * (3 * 3 * c * c * size + c * 4)
    flops, got = work.pair_work(shape, dtype)
    assert flops == 2 * macs and got == nbytes
    least = work.least_seconds(flops, got, dtype)
    assert least == max(flops / work.PEAK_FLOPS[dtype], nbytes / work.PEAK_BYTES_PER_S)


def _tiny_rbvsr():
    return dict(mid_channels=8, res_blocks=2, cleaning_blocks=1, cleaning_steps=2, upscale=4,
                train_flow=False)


def test_meta_count_equals_a_real_count():
    widths = _tiny_rbvsr()
    shape = (1, 3, 16, 24, 3)
    meta = work.forward_flops(realbasicvsr, widths, shape)
    p = {k: torch.rand(s) for k, s in realbasicvsr.param_shapes(**widths).items()}
    real = work.counted_flops(lambda: realbasicvsr.forward(p, torch.rand(shape), **widths))
    assert meta == real > 0


def test_a_residual_unit_more_counts_one_pair_a_frame_a_direction():
    widths = _tiny_rbvsr()
    b, t, h, w = 1, 3, 32, 32
    base = work.forward_flops(realbasicvsr, widths, (b, t, h, w, 3))
    more = work.forward_flops(realbasicvsr, {**widths, "res_blocks": widths["res_blocks"] + 1},
                              (b, t, h, w, 3))
    pair = work.pair_work((b * t, h, w, widths["mid_channels"]), "float32")[0]
    assert more - base == 2 * pair


def test_train_count_adds_the_backward():
    from port_bench.reference.train import supervised_loss

    widths = {**_tiny_rbvsr(), "mid_channels": 64}
    fwd = work.forward_flops(realbasicvsr, widths, (2, 3, 32, 32, 3))
    step = work.train_flops(realbasicvsr, widths, (2, 3, 32, 32, 3), (2, 3, 128, 128, 3),
                            supervised_loss)
    # the trainable convs twice more (input and weight gradients); SpyNet is frozen
    assert 2 * fwd < step < 3 * fwd


def test_vrt_counts_on_meta():
    widths = dict(depths=(2,) * 13, embed_dims=(12,) * 7 + (18,) * 6, num_heads=(2,) * 13,
                  deformable_groups=2)
    one = work.forward_flops(vrt, widths, (1, 6, 64, 64, 3))
    two = work.forward_flops(vrt, widths, (2, 6, 64, 64, 3))
    assert one > 0 and math.isclose(two, 2 * one, rel_tol=1e-9)
