"""The port's optimisation methods, schedules, regularizers and gradient
multipliers (``bigdl_tpu_torch/optim/methods.py``, ``schedules.py``,
``regularizer.py``, ``nn/module.py``) against the JAX reference's on the
CPU.

- each of the six methods of this slice updates the same seeded params
  with the same seeded gradients for 6 steps: params and slots within
  1e-6 absolute + 1e-5 relative (float32 elementwise arithmetic, rounded
  in the libraries' own orders); ``LBFGS.optimize`` on a quadratic within
  1e-5;
- each schedule's rate over steps 0..29 and epochs 1..6 within 1e-6
  relative; ``Plateau`` through a score sequence gives the same
  multipliers and rates, with ``min_lr``;
- the three regularizers' penalties and gradients within 1e-6 relative,
  and a train step with an ``L2Regularizer`` on one layer gives the
  reference's loss and updated weights within 1e-6;
- ``freeze``/``set_scale_w``/``set_scale_b`` give the reference's
  per-parameter multipliers, through containers (``MapTable``'s child
  included);
- ``OptimMethod.save``/``load`` round-trip the method and its state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as jopt
from bigdl_tpu.optim.optimizer import make_train_step as jax_train_step
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as topt
from bigdl_tpu_torch.nn.module import grad_scales

SHAPES = {"w": (3, 4), "b": (4,)}
STEPS = 6

METHODS = {
    "Adagrad": dict(learningrate=0.05, learningrate_decay=0.1,
                    weightdecay=0.01),
    "Adadelta": dict(decayrate=0.8, epsilon=1e-6),
    "Adamax": dict(learningrate=0.01),
    "RMSprop": dict(learningrate=0.01, learningrate_decay=0.05,
                    decayrate=0.9),
    "Ftrl": dict(learningrate=0.1, l1_strength=0.01, l2_strength=0.02),
    "LBFGS": dict(learningrate=0.1),
}


def _draw(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _close(got, want, atol=1e-6, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _run_both(jm, tm, steps=STEPS, epochs=None):
    p0 = _draw(0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jm.init_state(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = tm.init_state(tp)
    for i in range(steps):
        g = _draw(100 + i)
        if epochs is not None:
            js = {**js, "epoch": jnp.asarray(epochs[i], jnp.int32)}
            ts["epoch"].fill_(epochs[i])
        jp, js = jm.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tm.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
    return jp, js, tp, ts


@pytest.mark.parametrize("name", list(METHODS))
def test_method_matches_reference_over_steps(name):
    jp, js, tp, ts = _run_both(getattr(jopt, name)(**METHODS[name]),
                               getattr(topt, name)(**METHODS[name]))
    for k in SHAPES:
        _close(tp[k], jp[k])
    for slot, tree in ts.items():
        if isinstance(tree, dict):
            for k in SHAPES:
                _close(tree[k], js[slot][k])
    assert int(ts["step"]) == int(js["step"]) == STEPS


def test_lbfgs_optimize_matches_reference_on_a_quadratic():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((6, 6)).astype(np.float32)
    h = a @ a.T + 6 * np.eye(6, dtype=np.float32)
    b = rng.standard_normal(6).astype(np.float32)

    def jf(x):
        return 0.5 * x @ jnp.asarray(h) @ x - jnp.asarray(b) @ x, \
            jnp.asarray(h) @ x - jnp.asarray(b)

    th, tb = torch.from_numpy(h), torch.from_numpy(b)

    def tf(x):
        return 0.5 * x @ th @ x - tb @ x, th @ x - tb

    kw = dict(max_iter=15, learningrate=0.05, ncorrection=5)
    jx, jl = jopt.LBFGS(**kw).optimize(jf, jnp.zeros(6))
    tx, tl = topt.LBFGS(**kw).optimize(tf, torch.zeros(6))
    assert len(tl) == len(jl)
    _close(tl, jl, atol=1e-5)
    _close(tx, jx, atol=1e-5)
    assert tl[-1] < tl[0]


SCHEDULES = {
    "EpochStep": lambda m: m.EpochStep(2, 0.5),
    "EpochDecay": lambda m: m.EpochDecay(lambda e: e // 3),
    "Exponential": lambda m: m.Exponential(7, 0.8),
    "Exponential_stair": lambda m: m.Exponential(7, 0.8, stair_case=True),
    "NaturalExp": lambda m: m.NaturalExp(5, 0.3),
    "EpochSchedule": lambda m: m.EpochSchedule([
        m.Regime(1, 2, {"learningRate": 0.3}),
        m.Regime(3, 4, {"learningRate": 0.05})]),
    "Plateau": lambda m: m.Plateau(),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_rates_match_reference(name):
    js, ts = SCHEDULES[name](jopt), SCHEDULES[name](topt)
    for epoch in range(1, 7):
        for step in range(30):
            want = js(0.1, jnp.asarray(step, jnp.int32),
                      jnp.asarray(epoch, jnp.int32))
            got = ts(0.1, torch.tensor(step, dtype=torch.int32),
                     torch.tensor(epoch, dtype=torch.int32))
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("name", [n for n in SCHEDULES if n != "Plateau"])
def test_sgd_with_schedule_across_epochs_matches_reference(name):
    epochs = [1, 1, 2, 3, 3, 5]
    jp, _, tp, _ = _run_both(
        jopt.SGD(learningrate=0.1, momentum=0.5,
                 learningrate_schedule=SCHEDULES[name](jopt)),
        topt.SGD(learningrate=0.1, momentum=0.5,
                 learningrate_schedule=SCHEDULES[name](topt)),
        epochs=epochs)
    for k in SHAPES:
        _close(tp[k], jp[k])


def test_plateau_multiplier_and_rate_match_reference():
    kw = dict(factor=0.5, patience=2, mode="max", epsilon=1e-3, cooldown=1,
              min_lr=0.02)
    jm = jopt.SGD(learningrate=0.1, learningrate_schedule=jopt.Plateau(**kw))
    tm = topt.SGD(learningrate=0.1, learningrate_schedule=topt.Plateau(**kw))
    js = jm.init_state({"w": jnp.zeros(2)})
    ts = tm.init_state({"w": torch.zeros(2)})
    assert "plateau_mult" in ts and ts["plateau_mult"].dtype == torch.float32
    for score in [0.5, 0.6, 0.6, 0.6, 0.6, 0.59, 0.58, 0.7, 0.7, 0.7, 0.7]:
        jmult = jm.schedule.record(score)
        tmult = tm.schedule.record(score)
        assert jmult == tmult
        js = {**js, "plateau_mult": jnp.asarray(jmult, jnp.float32)}
        ts["plateau_mult"].fill_(tmult)
        np.testing.assert_allclose(float(tm.current_lr(ts)),
                                   float(jm.current_lr(js)), rtol=1e-6)
    assert float(tm.current_lr(ts)) == pytest.approx(0.02)


REGULARIZERS = {"L1": ("L1Regularizer", (0.03,)),
                "L2": ("L2Regularizer", (0.07,)),
                "L1L2": ("L1L2Regularizer", (0.03, 0.07))}


@pytest.mark.parametrize("name", list(REGULARIZERS))
def test_regularizer_penalty_and_gradient_match_reference(name):
    cls, args = REGULARIZERS[name]
    w = _draw(5)["w"]
    jr, tr = getattr(jopt, cls)(*args), getattr(topt, cls)(*args)
    jv, jg = jax.value_and_grad(jr)(jnp.asarray(w))
    tw = torch.from_numpy(w).requires_grad_()
    tv = tr(tw)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    _close(tw.grad, jg, rtol=1e-6)


@pytest.mark.parametrize("name", list(REGULARIZERS))
def test_train_step_with_a_regularized_layer_matches_reference(name):
    cls, args = REGULARIZERS[name]

    def build(n, reg, **kw):
        return (n.Sequential()
                .add(n.Linear(6, 5, w_regularizer=reg, b_regularizer=reg,
                              **kw))
                .add(n.Tanh()).add(n.Linear(5, 3, **kw)).add(n.LogSoftMax()))

    jm = build(jnn, getattr(jopt, cls)(*args)).build(0, (4, 6))
    tm = build(tnn, getattr(topt, cls)(*args), device="cpu")
    tm.load_state_dict(convert.module_params_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, jm.params)))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 6)).astype(np.float32)
    y = rng.integers(0, 3, 4).astype(np.int32)
    jopt_m = jopt.SGD(learningrate=0.5)
    step = jax_train_step(jm, jnn.ClassNLLCriterion(), jopt_m)
    params, _, _, jloss = step(jm.params, jm.state,
                               jopt_m.init_state(jm.params),
                               jax.random.key(0), jnp.asarray(x),
                               jnp.asarray(y))
    topt_m = topt.SGD(learningrate=0.5)
    tstep = topt.make_train_step(tm, tnn.ClassNLLCriterion(), topt_m)
    tloss = tstep(topt_m.init_state(dict(tm.named_parameters())),
                  torch.from_numpy(x), torch.from_numpy(y))
    plain = float(tnn.ClassNLLCriterion()(tm(torch.from_numpy(x)),
                                          torch.from_numpy(y)).detach())
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    got, _ = convert.module_params_to_jax(tm)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                        np.asarray, params))):
        _close(g, w, rtol=1e-6)
    assert float(tloss) != pytest.approx(plain, abs=1e-6)  # penalty is in


def _scaled(n, **kw):
    inner = n.Sequential().add(n.Linear(4, 4, **kw)).add(
        n.Linear(4, 4, **kw).set_scale_w(0.5).set_scale_b(2.0))
    return (n.Sequential().add(inner)
            .add(n.ConcatTable().add(n.Identity()).add(n.Tanh()))
            .add(n.MapTable(n.Linear(4, 4, **kw))).add(n.CAddTable())
            .add(n.Linear(4, 2, **kw)))


@pytest.mark.parametrize("frozen", ["none", "first_leaf", "inner",
                                    "map_table", "all"])
def test_grad_multipliers_match_reference(frozen):
    jm = _scaled(jnn).build(0, (2, 4))
    tm = _scaled(tnn, device="cpu")
    for m in (jm, tm):
        inner, mt = m[0], m[2]
        {"none": lambda: None, "first_leaf": inner[0].freeze,
         "inner": inner.freeze, "map_table": mt.freeze,
         "all": m.freeze}[frozen]()
    want = jax.tree_util.tree_leaves(jm.grad_scale_tree(jm.params))
    scales = grad_scales(tm)
    got, _ = convert.module_params_to_jax(
        tm, {n: torch.full_like(p, scales[n])
             for n, p in tm.named_parameters()})
    got = [float(np.unique(a)[0]) for a in jax.tree_util.tree_leaves(got)]
    assert got == [float(s) for s in want]
    for m in (jm, tm):
        m.unfreeze()
    assert sorted(set(grad_scales(tm).values())) == [0.5, 1.0, 2.0]


def test_frozen_layer_does_not_move_in_a_train_step():
    tm = _scaled(tnn, device="cpu").reset(0)
    tm[0][0].freeze()
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    m = topt.SGD(learningrate=0.1)
    step = topt.make_train_step(tm, lambda out, y: (out - y).square().mean(),
                                m)
    step(m.init_state(dict(tm.named_parameters())), torch.ones(3, 4),
         torch.zeros(3, 2))
    after = tm.state_dict()
    for k in before:
        moved = not torch.equal(before[k], after[k])
        assert moved == (not k.startswith("0.0.")), k


def test_optim_method_save_and_load_round_trip(tmp_path):
    m = topt.Adam(learningrate=0.01, learningrate_schedule=topt.Plateau())
    tp = {k: torch.from_numpy(v) for k, v in _draw(0).items()}
    state = m.init_state(tp)
    m.update({k: torch.from_numpy(v) for k, v in _draw(1).items()}, state,
             tp)
    path = tmp_path / "optimMethod.7"
    m.save(str(path), state)
    with pytest.raises(FileExistsError):
        m.save(str(path), state)
    m.save(str(path), state, overwrite=True)
    m2, s2 = topt.OptimMethod.load(str(path))
    assert type(m2) is topt.Adam and m2.learningrate == 0.01
    assert isinstance(m2.schedule, topt.Plateau)
    assert int(s2["step"]) == 1 and s2["m"]["w"].device.type == "cpu"
    for k in SHAPES:
        assert torch.equal(s2["m"][k], state["m"][k])
        assert torch.equal(s2["v"][k], state["v"][k])
