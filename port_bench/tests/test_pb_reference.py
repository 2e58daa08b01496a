"""The references agree with the program's plain route at tiny widths on the
CPU in float32 (the test imports both; the reference never imports the
program)."""

import torch

from port_bench.common import seeded_params
from port_bench.reference import realbasicvsr, train, vrt


def test_realbasicvsr_matches_the_program():
    from vsrlab_tpu_torch.models.realbasicvsr import RealBasicVSR

    w = dict(mid_channels=16, res_blocks=2, cleaning_blocks=2, cleaning_steps=2, upscale=4)
    model = RealBasicVSR(**w)
    shapes = realbasicvsr.param_shapes(**w)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == shapes
    p = seeded_params(shapes, 2**35 + 1, "cpu")
    model.load_state_dict(p)
    lr = torch.rand(2, 5, 32, 48, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        sr, lq = model(lr)
        rsr, rlq = realbasicvsr.forward(p, lr, **w)
    assert torch.allclose(sr, rsr, atol=2e-5, rtol=0)
    assert torch.allclose(lq, rlq, atol=2e-5, rtol=0)


def test_vrt_matches_the_program():
    from vsrlab_tpu_torch.models.vrt import VRT

    w = dict(upscale=4, depths=(2,) * 13, embed_dims=(12,) * 7 + (18,) * 6, num_heads=(2,) * 13,
             deformable_groups=2, window_size=(6, 8, 8))
    model = VRT(**w)
    shapes = vrt.param_shapes(**w)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == shapes
    p = seeded_params(shapes, 2**35 + 2, "cpu", vrt.fan_in)
    model.load_state_dict(p)
    x = torch.rand(1, 6, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        sr, _ = model(x)
        rsr, _ = vrt.forward(p, x, **w)
    assert torch.allclose(sr, rsr, atol=2e-5, rtol=0)


def test_training_reference_matches_the_program_step():
    from vsrlab_tpu_torch.models.realbasicvsr import RealBasicVSR
    from vsrlab_tpu_torch.train.builders import build_tx
    from vsrlab_tpu_torch.train.state import create_train_state
    from vsrlab_tpu_torch.train.step import make_supervised_train_step

    w = dict(mid_channels=8, res_blocks=1, cleaning_blocks=1, cleaning_steps=1, upscale=4,
             train_flow=False)
    model = RealBasicVSR(**w)
    shapes = realbasicvsr.param_shapes(**w)
    p0 = seeded_params(shapes, 2**35 + 3, "cpu")
    model.load_state_dict(p0)
    tx = build_tx(model.parameters(), ("adam", {"lr": 1e-3, "betas": (0.9, 0.99)}), None,
                  grad_clip=1.0)
    state = create_train_state(model, tx)
    step = make_supervised_train_step(model)
    g = torch.Generator().manual_seed(2)
    hr = torch.rand(4, 3, 64, 64, 3, generator=g)
    lr = torch.rand(4, 3, 16, 16, 3, generator=g)
    _, metrics = step(state, {"lr": lr, "hr": hr})

    params = {k: v.clone().requires_grad_(not realbasicvsr.frozen(k, **w)) for k, v in p0.items()}
    adam = train.Adam(list(params.values()), 1e-3, (0.9, 0.99), 1e-8, 1.0)
    loss, grads = train.accumulated_grads(
        lambda q, x: realbasicvsr.forward(q, x, **w), params, list(params), lr, hr, rows=2)
    adam.step(grads)
    assert abs(float(metrics["Loss"]) - loss) < 1e-5 * loss
    for name, prm in model.named_parameters():
        assert torch.allclose(prm.detach(), params[name].detach(), atol=1e-6), name
