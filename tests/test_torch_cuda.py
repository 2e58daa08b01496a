"""vsrlab_tpu_torch's CUDA kernels on the card (the residual pair, the
bilinear sampler and the packed row gather): agreement with the plain
version at ragged shapes, the launch counter, and the wrappers' refusals.

Skips without a CUDA device. On a machine with a card and no JAX, run
without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest

torch = pytest.importorskip("torch")

from vsrlab_tpu_torch.ops import bilinear_sample as bs  # noqa: E402
from vsrlab_tpu_torch.ops import packed_gather as pg  # noqa: E402
from vsrlab_tpu_torch.ops import warp  # noqa: E402
from vsrlab_tpu_torch.nn.blocks import ResidualConv, refresh_pair_caches  # noqa: E402
from vsrlab_tpu_torch.ops.residual_pair import (  # noqa: E402
    pack_weight_fragments,
    pair_launch_plan,
    residual_conv_pair,
    residual_conv_pair_im2col,
    residual_conv_pair_plain,
    residual_pair,
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


def _edge_shapes():
    """Shapes that cross the bf16 kernels' tilings (15x30 and 7x30 for taps,
    8x16 for im2col, which test_edge_shapes_cover_the_tiling_cases holds
    against the library's own plan): for each tile, exactly one; one pixel
    more in H and in W; fewer tiles than SMs; more than two rounds of tiles
    on a 132-SM card; three ragged frames, small and large."""
    shapes = []
    for th, tw in ((15, 30), (7, 30), (8, 16)):
        shapes += [(1, th, tw, 64), (1, th + 1, tw + 1, 64), (1, 3 * th, 2 * tw, 64)]
    # the last two make more wide tiles than a card has SMs: the deep tile, ragged
    return sorted(set(shapes)) + [(3, 23, 37, 64), (2, 150, 256, 64), (3, 121, 151, 64)]


FORMULATIONS = [(residual_conv_pair, "taps"), (residual_conv_pair_im2col, "im2col")]


@pytest.mark.parametrize("wrapper,formulation", FORMULATIONS)
@pytest.mark.parametrize("shape", _edge_shapes())
def test_bf16_kernel_at_tile_edges_is_right_and_repeats_bitwise(cuda, wrapper, formulation, shape):
    x, w1, b1, w2, b2 = _operands(shape, torch.bfloat16, cuda, seed=5)
    # large values on the image's border: a wrong halo, a missed zero of the
    # padding or a stale slot of the staged intermediate shows
    x[:, 0], x[:, -1], x[:, :, 0], x[:, :, -1] = 8.0, -8.0, 6.0, -6.0
    ops = (x, w1, b1, w2, b2)
    want = residual_conv_pair_plain(*ops).float()
    runs = [wrapper(*ops) for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
    torch.testing.assert_close(runs[0].float(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("formulation", ["taps", "im2col"])
@pytest.mark.parametrize("shape", _edge_shapes() + [(1, 180, 320, 64), (2, 180, 320, 64),
                                                    (10, 180, 320, 64), (1, 1, 1, 64)])
def test_launch_plan_matches_a_brute_force_count(cuda, formulation, shape):
    """The plan the library's entry makes, against a count of the tiles
    that hold a pixel and of the tiles each CTA walks over."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = pair_launch_plan(formulation, shape, cuda)
    th, tw = plan["tile"]
    b, h, w, _ = shape
    tiles = {(n, r // th, c // tw) for n in range(b) for r in range(h) for c in range(w)}
    assert plan["tiles"] == len(tiles)
    assert plan["ctas"] == min(len(tiles), sms)
    rounds = max(len(range(i, len(tiles), plan["ctas"])) for i in range(plan["ctas"]))
    assert plan["rounds"] == rounds
    if formulation == "taps":  # the wide tile exactly where it gives every CTA one tile
        wide = b * -(-h // 15) * -(-w // 30)
        assert plan["tile"] == ((15, 30) if wide <= sms else (7, 30))
    else:
        assert plan["tile"] == (8, 16)


@pytest.mark.parametrize("formulation", ["taps", "im2col"])
def test_edge_shapes_cover_the_tiling_cases(cuda, formulation):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plans = [pair_launch_plan(formulation, s, cuda) for s in _edge_shapes()]
    assert any(p["tiles"] == 1 for p in plans)
    assert any(1 < p["tiles"] < sms for p in plans)
    assert any(p["rounds"] > 2 for p in plans)
    # exactly one tile, and one pixel more each way, for every tile in use
    for th, tw in {p["tile"] for p in plans}:
        assert (1, th, tw, 64) in _edge_shapes() and (1, th + 1, tw + 1, 64) in _edge_shapes()
    if formulation == "taps":
        assert len({p["tile"] for p in plans}) == 2


def test_launch_plan_refuses_what_has_no_kernel(cuda):
    with pytest.raises(ValueError):
        pair_launch_plan("plain", (1, 8, 8, 64), cuda)
    with pytest.raises(RuntimeError):
        pair_launch_plan("taps", (0, 8, 8, 64), cuda)


# fp32: the 12x16 tile exactly, one pixel more in H and W, fewer rows than a
# tile, five ragged frames in five rounds of tiles; frames the plan cuts
# into 12x20 tiles: three ragged ones, exactly whole tiles and one pixel
# more; the shapes the fp32 paths time (the flow trainer's cleaner, a
# precision-fp32 window's recurrence and cleaner)
FP32_EDGE_SHAPES = [(1, 12, 16, 64), (1, 13, 17, 64), (1, 7, 30, 64), (5, 121, 151, 64),
                    (3, 121, 151, 64), (1, 168, 300, 64), (1, 169, 301, 64)]
FP32_PATH_SHAPES = [(16, 48, 64, 64), (1, 180, 320, 64), (10, 180, 320, 64)]


def _fp32_tile(shape, sms):
    """The fp32 plan's rule: the 12x20 tile where its rounds of tiles over
    the SMs take fewer thread-pixel passes (10 + 8 a thread against 8 + 6),
    else 12x16."""
    b, h, w, _ = shape

    def cost(th, tw, passes):
        tiles = b * -(-h // th) * -(-w // tw)
        return -(-tiles // min(tiles, sms)) * passes

    return (12, 20) if cost(12, 20, 18) < cost(12, 16, 14) else (12, 16)


@pytest.mark.parametrize("wrapper", WRAPPERS)
@pytest.mark.parametrize("shape", FP32_EDGE_SHAPES + FP32_PATH_SHAPES)
def test_fp32_kernel_at_tile_edges_is_right_and_repeats_bitwise(cuda, wrapper, shape):
    """The fp32 kernel (both formulations route to it) against the plain
    version with TF32 off, 1e-4, three launches bitwise equal."""
    x, w1, b1, w2, b2 = _operands(shape, torch.float32, cuda, seed=7)
    x[:, 0], x[:, -1], x[:, :, 0], x[:, :, -1] = 8.0, -8.0, 6.0, -6.0
    ops = (x, w1, b1, w2, b2)
    want = residual_conv_pair_plain(*ops)
    runs = [wrapper(*ops) for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
    torch.testing.assert_close(runs[0], want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("formulation", ["taps", "im2col"])
@pytest.mark.parametrize("shape", FP32_EDGE_SHAPES + FP32_PATH_SHAPES + [(1, 1, 1, 64),
                                                                         (16, 768, 1024, 64)])
def test_fp32_launch_plan_matches_a_brute_force_count(cuda, formulation, shape):
    """The fp32 plan: the tile by the rule, the tiles that hold a pixel,
    one CTA an SM at a time and the rounds of the busiest SM."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = pair_launch_plan(formulation, shape, cuda, torch.float32)
    assert plan["tile"] == _fp32_tile(shape, sms)
    th, tw = plan["tile"]
    b, h, w, _ = shape
    tiles = b * len({r // th for r in range(h)}) * len({c // tw for c in range(w)})
    assert plan["tiles"] == tiles
    assert plan["ctas"] == min(tiles, sms)
    assert plan["rounds"] == max(len(range(i, tiles, plan["ctas"])) for i in range(plan["ctas"]))


def test_fp32_edge_shapes_cover_both_tiles(cuda):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plans = {s: pair_launch_plan("taps", s, cuda, torch.float32) for s in FP32_EDGE_SHAPES}
    assert {p["tile"] for p in plans.values()} == {(12, 16), (12, 20)}
    assert any(p["tiles"] == 1 for p in plans.values())
    assert any(p["rounds"] > 2 for p in plans.values())
    assert all(p["tile"] == _fp32_tile(s, sms) for s, p in plans.items())
    # for each tile, frames of whole tiles and of one pixel more each way
    square = [s for s, p in plans.items() if p["tile"] == (12, 16)]
    wide = [s for s, p in plans.items() if p["tile"] == (12, 20)]
    assert (1, 12, 16, 64) in square and (1, 13, 17, 64) in square
    assert any(s[1] % 12 == 0 and s[2] % 20 == 0 for s in wide)
    assert any(s[1] % 12 == 1 and s[2] % 20 == 1 for s in wide)


@pytest.mark.parametrize("inference", [False, True])
@pytest.mark.parametrize("fragments", [False, True])
def test_taps_kernel_follows_a_weight_written_in_place(cuda, inference, fragments):
    """The wrapper lays the kernel's weight order out on every call: a write
    to a weight reaches the next launch, also for tensors made in inference
    mode. Fragments the caller hands in are what the kernel reads."""
    with torch.inference_mode(inference):
        ops = list(_operands((1, 20, 40, 64), torch.bfloat16, cuda, seed=6))
        residual_conv_pair(*ops)
        ops[1].mul_(-1.5)
        ops[3].add_(0.01)
        given = (pack_weight_fragments(ops[1]), pack_weight_fragments(ops[3])) if fragments else None
        got = residual_conv_pair(*ops, fragments=given)
        torch.testing.assert_close(got.float(), residual_conv_pair_plain(*ops).float(),
                                   rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("inference", [False, True])
@pytest.mark.parametrize("impl", ["taps", "im2col"])
def test_residual_conv_on_the_card_follows_its_parameters(cuda, impl, inference):
    """The module's cached operands and fragments: the kernel's result is the
    plain version's on the same parameters, before and after a write."""
    torch.manual_seed(3)
    unit = ResidualConv(64, dtype=torch.bfloat16).to(cuda)
    x = torch.randn((2, 20, 40, 64), device=cuda)
    for step in range(2):
        with torch.inference_mode(inference):
            got, want = unit(x, impl), unit(x, "plain")
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
        with torch.no_grad():
            unit.conv1.weight.mul_(-1.25)
            unit.conv2.bias.add_(0.5)
    launched = residual_conv_pair if impl == "taps" else residual_conv_pair_im2col
    assert launched.launches_by_shape[(2, 20, 40, 64)] >= 2


@pytest.mark.parametrize("write", ["data_mul", "fused_adam"])
def test_residual_conv_on_the_card_sees_writes_no_version_counter_sees(cuda, write):
    """A write through ``.data`` or a fused Adam step bumps no version
    counter: the grad route's forward and backward still use the new
    weights (its weight order is laid out on each call), and so does the
    no-grad route after ``refresh_pair_caches`` (``.data``) or on its own
    (the optimizer step count). Held against autograd through the plain
    version on the same weights, bf16: each tensor within 2 % of the plain
    one in norm (stale weights, 2x or a step of 0.05 away, miss by far more)."""
    torch.manual_seed(4)
    unit = ResidualConv(64, dtype=torch.bfloat16).to(cuda)
    x = torch.randn((2, 20, 40, 64), device=cuda)
    with torch.no_grad():
        unit(x)  # fills the cache
    if write == "data_mul":
        unit.conv1.weight.data.mul_(-2.0)
        refresh_pair_caches(unit)
    else:
        opt = torch.optim.Adam(unit.parameters(), lr=0.05, fused=True)
        unit(x.requires_grad_()).float().square().mean().backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
    with torch.no_grad():
        torch.testing.assert_close(unit(x).float(), unit(x, "plain").float(), rtol=2e-2,
                                   atol=2e-2)
    outs = []
    for impl in ("taps", "plain"):
        xg = x.detach().clone().requires_grad_()
        y = unit(xg, impl)
        y.float().sum().backward()
        outs.append([y.detach().float(), xg.grad.float()]
                    + [p.grad.float() for p in unit.parameters()])
        unit.zero_grad(set_to_none=True)
    for got, want in zip(*outs):
        assert float((got - want).norm() / want.norm()) < 2e-2


def _packed_operands(n, h, w, c, gp, dtype, device, seed=0):
    """Table and per-pixel fields for random images and coordinates that
    reach 2 pixels outside the image."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, h, w, c), generator=g).to(device, dtype)
    ix = (torch.rand((n, h, w), generator=g) * (w + 3) - 2).to(device)
    iy = (torch.rand((n, h, w), generator=g) * (h + 3) - 2).to(device)
    return warp.packed_table(x, gp), warp.packed_fields(ix, iy, h, w, gp, "zeros")


# (N, H, W, C, gp): 160-byte rows (16-byte vectors), 24-byte bf16 / 48-byte
# fp32 rows (the element-wise and the vector path), the TinyVRT row
PACKED_SHAPES = [(3, 9, 13, 10, 2), (2, 7, 10, 3, 1), (5, 16, 16, 8, 2)]


@pytest.mark.parametrize("wrapper,formulation", FORMULATIONS)
@pytest.mark.parametrize("shape", [(4, 64, 64, 64), (2, 25, 17, 64), (1, 169, 301, 64)])
def test_residual_pair_gradient_matches_autograd_through_plain(cuda, wrapper, formulation, shape):
    """fp32 (TF32 off): the kernel's forward and the PyTorch backward of
    ``ResidualPair`` against autograd through the plain version, each
    launch counted on the wrapper."""
    ops = _operands(shape, torch.float32, cuda, seed=4)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(5)).to(cuda)
    leaves = [[t.clone().requires_grad_(True) for t in ops] for _ in range(2)]
    before = wrapper.launches
    got = residual_pair(*leaves[0], formulation)
    want = residual_conv_pair_plain(*leaves[1])
    assert wrapper.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    got.backward(g)
    want.backward(g)
    for a, b in zip(leaves[0], leaves[1]):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-4 * float(b.grad.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", PACKED_SHAPES)
def test_packed_kernels_match_plain(cuda, dtype, shape):
    xf, fields = _packed_operands(*shape, dtype, cuda)
    key = (*xf.shape, fields[0].shape[1])
    before = pg.packed_row_gather.launches_by_shape[key]
    rows = pg.packed_row_gather(xf, fields[0])
    torch.cuda.synchronize()
    assert pg.packed_row_gather.launches_by_shape[key] == before + 1
    assert rows.dtype == dtype
    assert torch.equal(rows, pg.packed_row_gather_plain(xf, fields[0]))


def _sample_coords(n, h, w, kind, g):
    """(N, H*W) coordinates: the pixel grid plus an N(0, 3) residue, uniform
    over the image and a 2-pixel margin, or uniform over three image sizes
    on each side (most corners outside)."""
    if kind == "realistic":
        ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
        ix = xs[None] + torch.randn((n, h, w), generator=g) * 3.0
        iy = ys[None] + torch.randn((n, h, w), generator=g) * 3.0
    else:
        lo, span = (-2.0, 3.0) if kind == "uniform" else (-3.0 * max(h, w), 6.0 * max(h, w))
        ix = torch.rand((n, h, w), generator=g) * (w + span) + lo
        iy = torch.rand((n, h, w), generator=g) * (h + span) + lo
    return ix.reshape(n, -1), iy.reshape(n, -1)


# (N, H, W, C): the alignment's shape, a row pitch that is no multiple of 16
# bytes, C = 4, C = 3 (the generic path), one row, one column, one pixel
SAMPLE_SHAPES = [(180, 32, 32, 10), (3, 9, 13, 10), (24, 8, 8, 4), (3, 9, 13, 3), (2, 1, 5, 10),
                 (2, 4, 1, 4), (1, 1, 1, 10)]


@pytest.mark.parametrize("kind", ["realistic", "uniform", "far"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", SAMPLE_SHAPES)
def test_bilinear_sample_matches_plain(cuda, dtype, tol, shape, kind):
    g = torch.Generator().manual_seed(2)
    x = torch.randn(shape, generator=g).to(cuda, dtype)
    ix, iy = (t.to(cuda) for t in _sample_coords(*shape[:3], kind, g))
    key = (*shape, ix.shape[1])
    for zeros in (True, False):
        if not zeros:
            ix, iy = warp._pad_coords(ix, iy, shape[1], shape[2], "border", True)
        before = bs.bilinear_sample.launches_by_shape[key]
        got = bs.bilinear_sample(x, ix, iy, zeros)
        again = bs.bilinear_sample(x, ix, iy, zeros)
        torch.cuda.synchronize()
        assert bs.bilinear_sample.launches_by_shape[key] == before + 2
        assert got.dtype == dtype and got.shape == (*ix.shape, shape[3])
        assert torch.equal(got, again)
        torch.testing.assert_close(got.float(), bs.bilinear_sample_plain(x, ix, iy, zeros).float(),
                                   rtol=tol, atol=tol)


def test_bilinear_sample_non_finite_coordinates_give_zero(cuda):
    x = torch.randn((2, 6, 8, 10), device=cuda).bfloat16()
    bad = [float("inf"), float("-inf"), float("nan"), 1e30, -1e30]
    ix = torch.tensor([bad + [3.5, float("nan"), 2.0]] * 2, device=cuda)
    iy = torch.tensor([[2.0, float("nan"), float("inf"), -1e30, 1e30, 2.5, 1.0, float("inf")]] * 2,
                      device=cuda)
    got = bs.bilinear_sample(x, ix, iy, True).float()
    assert (got[:, :5] == 0).all() and (got[:, 6:] == 0).all()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, bs.bilinear_sample_plain(x, ix, iy, True).float(),
                               rtol=2e-2, atol=2e-2)


# (H, W, C, window_group): the last three hold no whole window for the
# packed table (one x-group, one row, one column), which is padded to one
@pytest.mark.parametrize("size", [(12, 18, 10, 2), (8, 8, 4, None), (1, 5, 3, 2), (4, 1, 4, None)])
@pytest.mark.parametrize("impl", ["take", "fused"])
def test_packed_sampler_matches_four_corner_on_the_card(cuda, impl, size):
    h, w, c, gp = size
    g = torch.Generator().manual_seed(1)
    x = torch.randn((4, h, w, c), generator=g).to(cuda)
    ix = (torch.rand((4, 12, 18), generator=g) * (w + 3) - 2).to(cuda)
    iy = (torch.rand((4, 12, 18), generator=g) * (h + 3) - 2).to(cuda)
    wrapper = bs.bilinear_sample if impl == "fused" else pg.packed_row_gather
    before = wrapper.launches
    for padding_mode in ("zeros", "border"):
        want = warp.sample_pixel_coords(x, ix, iy, padding_mode=padding_mode, window_group=gp,
                                        impl="plain")
        got = warp.sample_pixel_coords(x, ix, iy, padding_mode=padding_mode, window_group=gp,
                                       impl=impl)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert wrapper.launches == before + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size", [(64, 64, 10, 2), (12, 18, 10, 2), (8, 8, 4, None)])
def test_take_route_is_the_plain_sampler_bit_for_bit_on_the_card(cuda, dtype, size):
    """The row gather kernel moves bits and the fold weighs and adds the
    four corners as the plain sampler does: the ``take`` route equals the
    plain one in every bit, zeros and border."""
    h, w, c, gp = size
    g = torch.Generator().manual_seed(6)
    x = torch.randn((5, h, w, c), generator=g).to(cuda, dtype)
    ix = (torch.rand((5, h, w), generator=g) * (w + 3) - 2).to(cuda)
    iy = (torch.rand((5, h, w), generator=g) * (h + 3) - 2).to(cuda)
    before = pg.packed_row_gather.launches
    for mode in ("zeros", "border"):
        want = warp.sample_pixel_coords(x, ix, iy, padding_mode=mode, impl="plain")
        got = warp.sample_pixel_coords(x, ix, iy, padding_mode=mode, window_group=gp, impl="take")
        assert torch.equal(got, want), mode
    assert pg.packed_row_gather.launches == before + 2


@pytest.mark.parametrize("c", [1, 3, 4, 8, 10])
def test_bilinear_sample_fp32_is_the_plain_version_bit_for_bit(cuda, c):
    """In fp32 the kernel rounds each corner's product before the sum, as
    the plain version does: the two agree in every bit (fast and generic
    paths, zeros and border)."""
    g = torch.Generator().manual_seed(c)
    x = torch.randn((5, 17, 23, c), generator=g).to(cuda)
    ix = (torch.rand((5, 300), generator=g) * 27 - 2).to(cuda)
    iy = (torch.rand((5, 300), generator=g) * 21 - 2).to(cuda)
    for zeros in (True, False):
        if not zeros:
            ix, iy = ix.clamp(0, 22), iy.clamp(0, 16)
        got = bs.bilinear_sample(x, ix, iy, zeros)
        assert torch.equal(got, bs.bilinear_sample_plain(x, ix, iy, zeros))


@pytest.mark.parametrize("zeros", [True, False])
@pytest.mark.parametrize("shape", [(96, 12, 16, 1, 49), (6, 9, 13, 3, 117), (4, 16, 16, 10, 256)])
def test_bilinear_sample_gradient_matches_autograd_through_plain(cuda, shape, zeros):
    """``BilinearSample`` (the kernel forward, ``sample_grads`` backward)
    against autograd through the plain version, fp32 at 1e-4: the output,
    ``dx`` and both coordinate gradients; one kernel launch a forward."""
    n, h, w, c, p = shape
    g = torch.Generator().manual_seed(2)
    x = torch.randn((n, h, w, c), generator=g).to(cuda)
    ix = (torch.rand((n, p), generator=g) * (w + 4) - 2).to(cuda)
    iy = (torch.rand((n, p), generator=g) * (h + 4) - 2).to(cuda)
    if not zeros:
        ix, iy = ix.clamp(0, w - 1), iy.clamp(0, h - 1)
    gout = torch.randn((n, p, c), generator=g).to(cuda)
    res = []
    for fn in (bs.bilinear_sample, bs.bilinear_sample_plain):
        leaves = [t.clone().requires_grad_() for t in (x, ix, iy)]
        before = bs.bilinear_sample.launches
        out = fn(*leaves, zeros)
        out.backward(gout)
        res.append([out.detach()] + [t.grad for t in leaves])
        assert bs.bilinear_sample.launches == before + (fn is bs.bilinear_sample)
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", PACKED_SHAPES)
def test_packed_row_gather_gradient_matches_autograd_through_plain(cuda, dtype, tol, shape):
    """``PackedRowGather`` (the kernel forward, ``gather_grads`` backward)
    against autograd through the plain gather: the rows exactly, the
    table's gradient within the tolerance (both scatter-add in an order
    the atomics choose); one kernel launch a forward."""
    xf, fields = _packed_operands(*shape, dtype, cuda)
    gout = torch.randn((xf.shape[0], fields[0].shape[1], xf.shape[2]), device=cuda).to(dtype)
    res = []
    for fn in (pg.packed_row_gather, pg.packed_row_gather_plain):
        leaf = xf.clone().requires_grad_()
        before = pg.packed_row_gather.launches
        out = fn(leaf, fields[0])
        out.backward(gout)
        res.append((out.detach(), leaf.grad))
        assert pg.packed_row_gather.launches == before + (fn is pg.packed_row_gather)
    assert torch.equal(res[0][0], res[1][0])
    assert res[0][1].dtype == dtype
    torch.testing.assert_close(res[0][1].float(), res[1][1].float(), rtol=tol,
                               atol=tol * float(res[1][1].float().abs().max()))


def test_packed_kernels_refuse_what_they_do_not_take(cuda):
    xf, fields = _packed_operands(2, 6, 8, 4, 2, torch.bfloat16, cuda)
    x = torch.randn((2, 6, 8, 4), device=cuda).bfloat16()
    ix = torch.zeros((2, 48), device=cuda)
    before = (pg.packed_row_gather.launches, bs.bilinear_sample.launches)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        pg.packed_row_gather(xf.half(), fields[0])
    with pytest.raises(ValueError, match="contiguous"):
        pg.packed_row_gather(xf.transpose(1, 2), fields[0])
    with pytest.raises(ValueError, match="one CUDA device"):
        pg.packed_row_gather(xf, fields[0].cpu())
    with pytest.raises(ValueError, match="bf16 or fp32"):
        bs.bilinear_sample(x.half(), ix, ix, True)
    with pytest.raises(ValueError, match="contiguous"):
        bs.bilinear_sample(x.transpose(1, 2), ix, ix, True)
    with pytest.raises(ValueError, match="one CUDA device"):
        bs.bilinear_sample(x, ix, ix.cpu(), True)
    # the gradient route (BilinearSample) refuses what the kernel does not take
    with pytest.raises(ValueError, match="bf16 or fp32"):
        bs.bilinear_sample(x.half(), ix.clone().requires_grad_(), ix, True)
    with pytest.raises(ValueError, match="one CUDA device"):
        bs.bilinear_sample(x, ix.clone().requires_grad_(), ix.cpu(), True)
    # and so does the row gather's (PackedRowGather)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        pg.packed_row_gather(xf.half().requires_grad_(), fields[0])
    with pytest.raises(ValueError, match="one CUDA device"):
        pg.packed_row_gather(xf.clone().requires_grad_(), fields[0].cpu())
    assert (pg.packed_row_gather.launches, bs.bilinear_sample.launches) == before


def test_host_data_core_builds_on_the_cards_host(cuda):
    """``libvsrio`` builds with g++ on the card's host (its OpenCV half where
    the headers are there) and its codec round trip is the numpy path's
    within 1e-5."""
    import numpy as np

    from vsrlab_tpu_torch import build
    from vsrlab_tpu_torch.data import codec_emulator, native

    lib = build.load_host("vsrio")
    assert hasattr(lib.lib, "vsrio_codec_degrade")
    clip = np.random.default_rng(0).random((3, 21, 35, 3)).astype(np.float32)
    native.reset_counts()
    got = codec_emulator.dct_codec_roundtrip(clip, 30.0, 4)
    assert native.counts()["codec_degrade"] == {"native": 1, "python": 0}
    np.testing.assert_allclose(got, codec_emulator.dct_codec_roundtrip(clip, 30.0, 4,
                                                                      force_numpy=True),
                               atol=1e-5, rtol=0)


def test_windowed_inference_on_a_one_rank_time_axis(cuda):
    """A ``time`` axis of one rank serves on the card exactly as no mesh."""
    from vsrlab_tpu_torch import parallel
    from vsrlab_tpu_torch.evaluation.harness import make_forward, windowed_inference
    from vsrlab_tpu_torch.models import RealBasicVSR

    torch.manual_seed(0)
    model = RealBasicVSR(mid_channels=64, res_blocks=2, cleaning_blocks=2)
    forward = make_forward(model, device=cuda)
    video = torch.rand((1, 5, 16, 24, 3), generator=torch.Generator().manual_seed(1))
    before = residual_conv_pair.launches
    want, n = windowed_inference(forward, video, 2)
    got, m = windowed_inference(forward, video, 2, parallel.create_mesh({"time": 1}))
    assert (n, m) == (3, 3) and residual_conv_pair.launches > before
    assert got.device.type == "cuda" and torch.equal(got, want)
