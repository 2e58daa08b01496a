"""The port's supervised train step against vsrlab_tpu's on the CPU, fp32.

Both start from the same parameters (the JAX ``init``, converted with
``vsrlab_tpu_torch.convert``) and take three steps on one seeded batch of
RealBasicVSR (mid 8, one residual unit a recurrence, one cleaning unit,
3 frames of 16x16 -> 64x64), Adam at 1e-3 through each package's
``build_tx``. After each step: the loss, the metrics and every parameter.
Gates: loss and metrics rtol 1e-5; parameters atol 2e-5 (a few Adam steps
of 1e-3 on gradients that agree to fp32 rounding; summation orders differ
between XLA and PyTorch). Cases: the plain step; two microbatches with the
clip triggered, an EMA of decay 0.9 (its shadow checked too) and the
gradient norm logged; a start from an Adam state converted with
``adam_state_dict``; ``skip_nonfinite`` on a batch holding a NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import vsrlab_tpu.components  # noqa: E402,F401
import vsrlab_tpu_torch.components  # noqa: E402,F401
from vsrlab_tpu.models import RealBasicVSR as JRealBasicVSR  # noqa: E402
from vsrlab_tpu.train import builders as jbuilders  # noqa: E402
from vsrlab_tpu.train.state import create_train_state as j_create  # noqa: E402
from vsrlab_tpu.train.step import make_supervised_train_step as j_make_step  # noqa: E402
from vsrlab_tpu_torch import convert  # noqa: E402
from vsrlab_tpu_torch.models import RealBasicVSR  # noqa: E402
from vsrlab_tpu_torch.train.builders import build_tx  # noqa: E402
from vsrlab_tpu_torch.train.state import create_train_state  # noqa: E402
from vsrlab_tpu_torch.train.step import make_supervised_train_step  # noqa: E402

MID, T, H, W = 8, 3, 16, 16
OPT = {"_target_": "adam", "lr": 1e-3, "betas": [0.9, 0.99], "eps": 1e-8}
STEPS = 3

# name -> (num_grad_accum, gradient clip, ema decay, log_grad_norm)
CASES = {
    "plain": (1, None, 0.0, False),
    "accum2_clip_ema_gradnorm": (2, 0.05, 0.9, True),
}


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(7)
    lr = rng.random((2, T, H, W, 3)).astype(np.float32)
    hr = rng.random((2, T, 4 * H, 4 * W, 3)).astype(np.float32)
    return lr, hr


@pytest.fixture(scope="module")
def jmodel():
    return JRealBasicVSR(mid_channels=MID, res_blocks=1, cleaning_blocks=1)


def _j_state(jmodel, batch, tx, ema=0.0):
    return j_create(jmodel, jax.random.PRNGKey(0), jnp.asarray(batch[0][:1]), tx, ema_decay=ema)


def _t_state(jstate, clip=None, skip=0, ema=0.0):
    model = RealBasicVSR(MID, 1, 1)
    model.load_state_dict(convert.realbasicvsr_state_dict(jax.tree.map(np.asarray,
                                                                       jstate.params)))
    tx = build_tx(model.parameters(), OPT, None, clip, skip_nonfinite=skip)
    return create_train_state(model, tx, ema_decay=ema)


def _assert_params(tstate, jparams, what="params"):
    want = convert.realbasicvsr_state_dict(jax.tree.map(np.asarray, jparams))
    got = tstate.model.state_dict() if what == "params" else tstate.ema
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(), atol=2e-5, rtol=0,
                                   err_msg=f"{what} {k}")


def _assert_metrics(got, want):
    assert got.keys() == {k: 0 for k in want}.keys()
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_steps_match_jax(jmodel, batch, case):
    accum, clip, ema, norm = CASES[case]
    jtx = jbuilders.build_tx(OPT, None, clip)
    jstate = _j_state(jmodel, batch, jtx, ema)
    tstate = _t_state(jstate, clip, ema=ema)
    jstep = j_make_step(jmodel, num_grad_accum=accum, ema_decay=ema, log_grad_norm=norm,
                        donate=False)
    tstep = make_supervised_train_step(tstate.model, num_grad_accum=accum, ema_decay=ema,
                                       log_grad_norm=norm)
    jb = {"lr": jnp.asarray(batch[0]), "hr": jnp.asarray(batch[1])}
    tb = {"lr": torch.from_numpy(batch[0]), "hr": torch.from_numpy(batch[1])}
    for _ in range(STEPS):
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        _assert_metrics(tm, jm)
        _assert_params(tstate, jstate.params)
        if ema:
            _assert_params(tstate, jstate.ema_params, "ema")
    assert tstate.step == int(jstate.step) == STEPS
    if clip:  # the clip was in force: the pre-clip norm exceeds it
        assert float(tm["GradNorm"]) > clip
    # SpyNet is frozen (train_flow false): no update moved it
    spynet = {k: v for k, v in tstate.model.state_dict().items() if ".spynet." in k}
    start = convert.realbasicvsr_state_dict(
        jax.tree.map(np.asarray, _j_state(jmodel, batch, jtx).params))
    assert spynet and all(torch.equal(v, start[k]) for k, v in spynet.items())


def test_step_from_a_converted_adam_state(jmodel, batch):
    """Two JAX steps, then the JAX Adam state converted into the port's
    optimizer: the next step agrees, also in the schedule's step count."""
    jtx = jbuilders.build_tx(OPT, ("cosine", {"T_max": 10, "eta_min": 1e-5}))
    jstate = _j_state(jmodel, batch, jtx)
    jstep = j_make_step(jmodel, donate=False)
    jb = {"lr": jnp.asarray(batch[0]), "hr": jnp.asarray(batch[1])}
    for _ in range(2):
        jstate, _ = jstep(jstate, jb)
    model = RealBasicVSR(MID, 1, 1)
    model.load_state_dict(convert.realbasicvsr_state_dict(jax.tree.map(np.asarray,
                                                                       jstate.params)))
    tx = build_tx(model.parameters(), OPT, ("cosine", {"T_max": 10, "eta_min": 1e-5}))
    named = convert.adam_state_dict(jax.tree.map(np.asarray, jstate.opt_state),
                                    jax.tree.map(np.asarray, jstate.params))
    for name, p in model.named_parameters():
        tx.optimizer.state[p] = named[name]
    tx.count = 2
    tstate = create_train_state(model, tx)
    jstate, jm = jstep(jstate, jb)
    tstate, tm = make_supervised_train_step(model)(
        tstate, {"lr": torch.from_numpy(batch[0]), "hr": torch.from_numpy(batch[1])})
    _assert_metrics(tm, jm)
    _assert_params(tstate, jstate.params)
    assert all(float(s["step"]) == 3 for s in tx.optimizer.state.values())


def test_skip_nonfinite_matches_apply_if_finite(jmodel, batch):
    """A batch holding a NaN: the update is skipped (parameters and Adam
    state untouched, the step still counted) until more than
    ``skip_nonfinite`` come in a row; then it applies, as optax's
    ``apply_if_finite`` does. Clean steps around it agree with JAX."""
    jtx = jbuilders.build_tx(OPT, None, None, skip_nonfinite=1)
    jstate = _j_state(jmodel, batch, jtx)
    tstate = _t_state(jstate, skip=1)
    jstep = j_make_step(jmodel, donate=False)
    tstep = make_supervised_train_step(tstate.model)
    bad_lr = batch[0].copy()
    bad_lr[0, 1, 3, 4, 2] = np.nan
    for lr in (batch[0], bad_lr, batch[0], bad_lr, bad_lr):
        before = {k: v.clone() for k, v in tstate.model.state_dict().items()}
        jstate, jm = jstep(jstate, {"lr": jnp.asarray(lr), "hr": jnp.asarray(batch[1])})
        tstate, tm = tstep(tstate, {"lr": torch.from_numpy(lr), "hr": torch.from_numpy(batch[1])})
        inner = jstate.opt_state
        assert tstate.tx.notfinite_count == int(inner.notfinite_count)
        assert tstate.tx.total_notfinite == int(inner.total_notfinite)
        skipped = tstate.tx.notfinite_count in (1,)  # the first non-finite in a row
        after = tstate.model.state_dict()
        if skipped:
            assert all(torch.equal(after[k], before[k]) for k in before)
        if np.isfinite(float(jm["Loss"])):
            _assert_metrics(tm, jm)
        if tstate.tx.notfinite_count == 0:
            _assert_params(tstate, jstate.params)
    # the fifth update (second non-finite in a row) applied: NaN parameters on both sides
    assert tstate.tx.count == 3
    assert not all(bool(torch.isfinite(v).all()) for v in tstate.model.state_dict().values())


UPDATES = {
    "adam_cosine": ({"_target_": "adam", "lr": 1e-2}, ("cosine", {"T_max": 4, "eta_min": 1e-3}),
                    None),
    "adamw_clip": ({"_target_": "adamw", "lr": 1e-2, "weight_decay": 0.1}, None, 0.5),
    "adam_weight_decay_warmup": ({"_target_": "adam", "lr": 1e-2, "weight_decay": 0.05},
                                 ("cosine_warmup", {"first_cycle_steps": 5, "warmup_steps": 2}),
                                 None),
    "sgd_momentum_clip": ({"_target_": "sgd", "lr": 1e-1, "momentum": 0.9}, None, 0.3),
}


@pytest.mark.parametrize("name", sorted(UPDATES))
def test_updater_matches_the_optax_chain(rng, name):
    """Four updates of the port's ``Updater`` against the JAX package's
    optax chain on the same gradients (fp32, rtol 1e-5), one parameter
    without a gradient (zeros to optax: adamw and adam-with-decay still
    decay it) and one gradient large enough to be clipped."""
    opt, sched, clip = UPDATES[name]
    shapes = [(3, 4), (5,), (2, 2, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * (3.0 if k == 1 else 0.1)).astype(np.float32)
              for s in shapes] for k in range(4)]
    tx = jbuilders.build_tx(opt, sched, clip)
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    updater = build_tx(tp, opt, sched, clip)
    for step_grads in grads:
        jg = [jnp.asarray(g) for g in step_grads[:2]] + [jnp.zeros(shapes[2], jnp.float32)]
        upd, jstate = tx.update(jg, jstate, jp)
        jp = [p + u for p, u in zip(jp, upd)]
        for p, g in zip(tp, step_grads[:2]):
            p.grad = torch.from_numpy(g.copy())
        tp[2].grad = None  # no gradient: the updater fills zeros
        norm = updater.step()
        np.testing.assert_allclose(float(norm), float(np.sqrt(sum(
            (g.astype(np.float64) ** 2).sum() for g in step_grads[:2]))), rtol=1e-5)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)
    assert updater.count == 4
    moved = not np.allclose(tp[2].detach().numpy(), params[2])
    assert moved == (name in ("adamw_clip", "adam_weight_decay_warmup"))
