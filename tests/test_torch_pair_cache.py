"""ResidualConv's operand cache after writes to its parameters, on the CPU.

After a write through ``p.data`` (then ``refresh_pair_caches``), a
``load_state_dict``, a ``.to()`` round trip, a mode switch or a fused
Adam step, the unit's no-grad forward must equal that of a fresh module
loaded with the same ``state_dict`` (bitwise: both run the plain version
of the pair), and its grad forward and backward too; after the fused step
the ``taps`` route's gradients (``ResidualPair``: the pair forward,
``pair_grads`` backward) must match autograd through ``impl="plain"``
within fp32 rounding (rtol 1e-5, atol 1e-6: ``pair_grads`` orders its
sums differently).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vsrlab_tpu_torch.nn.blocks import ResidualConv, init_weights, refresh_pair_caches  # noqa: E402

C = 8


def unit(seed=0):
    return init_weights(ResidualConv(C), torch.Generator().manual_seed(seed))


def clip(seed=1):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((2, 6, 7, C),
                                                                        np.float32))


def fresh_copy(m):
    f = ResidualConv(C)
    f.load_state_dict(m.state_dict())
    return f


def run_grad(m, x, impl="taps"):
    x = x.clone().requires_grad_()
    y = m(x, impl)
    y.backward(torch.cos(y.detach()))
    grads = [x.grad] + [p.grad for p in m.parameters()]
    m.zero_grad(set_to_none=True)
    return y.detach(), grads


def data_write(m):
    m.conv1.weight.data.mul_(2.0)
    m.conv2.bias.data.add_(0.5)
    refresh_pair_caches(m)


def load(m):
    m.load_state_dict(unit(seed=7).state_dict())


def to_round_trip(m):
    m.to(torch.float16).to(torch.float32)


def mode_switch(m):
    # a .data write that only a mode switch (which drops the cache) sees
    m.conv2.weight.data.mul_(-1.0)
    m.train()
    m.eval()


def fused_adam(m):
    opt = torch.optim.Adam(m.parameters(), lr=0.05, fused=True)
    m(clip(3).requires_grad_()).square().mean().backward()
    opt.step()
    opt.zero_grad(set_to_none=True)


WRITES = {"data_mul": data_write, "load_state_dict": load, "to": to_round_trip,
          "train_eval": mode_switch, "fused_adam": fused_adam}


@pytest.mark.parametrize("write", list(WRITES), ids=list(WRITES))
def test_forward_after_a_write_equals_a_fresh_module(write):
    m, x = unit(), clip()
    with torch.no_grad():
        before = m(x)  # fills the cache
    WRITES[write](m)
    fresh = fresh_copy(m)
    with torch.no_grad():
        got, want = m(x), fresh(x)
    assert not torch.equal(got, before), "the write changed nothing"
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    (y, grads), (y_ref, grads_ref) = run_grad(m, x), run_grad(fresh, x)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
    for g, g_ref in zip(grads, grads_ref):
        torch.testing.assert_close(g, g_ref, rtol=0, atol=0)


def test_fused_adam_step_bumps_no_version_yet_is_seen():
    m = unit()
    versions = [p._version for p in m.parameters()]
    with torch.no_grad():
        m(clip())
    fused_adam(m)
    assert [p._version for p in m.parameters()] == versions  # the hazard itself
    with torch.no_grad():
        torch.testing.assert_close(m(clip()), fresh_copy(m)(clip()), rtol=0, atol=0)


def test_grad_route_after_fused_step_matches_plain_autograd():
    m = unit()
    with torch.no_grad():
        m(clip())
    fused_adam(m)
    (y, grads), (y_ref, grads_ref) = run_grad(m, clip(), "taps"), run_grad(m, clip(), "plain")
    torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-6)
    for g, g_ref in zip(grads, grads_ref):
        torch.testing.assert_close(g, g_ref, rtol=1e-5, atol=1e-6)


def test_refresh_pair_caches_walks_the_tree():
    model = torch.nn.Sequential(unit(), torch.nn.ModuleList([unit(1), unit(2)]))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, ResidualConv):
                m(clip())
    assert refresh_pair_caches(model) is model
    assert all(m._pair_cache is None for m in model.modules() if isinstance(m, ResidualConv))
