"""The port's ResNet training step (``models/resnet.py`` through
``optim.make_train_step`` with ``SGD`` and the ported schedules) against
the JAX reference's ``make_train_step`` on the same weights and batch.

CIFAR ResNet-8 (NHWC, batch 4, 16 x 16, 10 classes) with the recipe of
``examples/resnet_cifar10.py``: ``CrossEntropyCriterion`` and
``SGD(momentum=0.9, dampening=0, nesterov=True, weightdecay=1e-4)`` under
``SequentialSchedule(Warmup -> Step)``, here with budgets short enough
that three steps cross from the warm-up into the step decay. Losses,
updated weights and BN running statistics agree at rtol 1e-4 / atol 1e-5
(float32 on both sides). One ``compute_dtype=bfloat16`` step agrees in
loss within 2 %. Each ported schedule's learning rate over 10 steps
matches the reference's at rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.resnet import ResNet as JaxResNet
from bigdl_tpu.nn.criterion import CrossEntropyCriterion as JaxCE
from bigdl_tpu.optim import methods as jmethods
from bigdl_tpu.optim import schedules as jsched
from bigdl_tpu.optim.optimizer import make_train_step as jax_train_step
from bigdl_tpu_torch import convert, optim
from bigdl_tpu_torch.models import ResNet
from bigdl_tpu_torch.nn import CrossEntropyCriterion

CFG = dict(class_num=10, depth=8, data_set="CIFAR-10", format="NHWC")
B, HW = 4, 16
TOL = dict(rtol=1e-4, atol=1e-5)
LR = 0.1


def _schedule(mod):
    """The recipe's warm-up then step decay, from module ``mod`` (the
    reference's schedules or the port's)."""
    return (mod.SequentialSchedule()
            .add(mod.Warmup(LR / 20), 2)
            .add(mod.Step(step_size=1, gamma=0.5), 10 ** 9))


def _sgd(mod, sched_mod):
    return mod.SGD(learningrate=LR, momentum=0.9, dampening=0.0,
                   weightdecay=1e-4, nesterov=True,
                   learningrate_schedule=_schedule(sched_mod))


@pytest.fixture(scope="module")
def ref():
    """The reference model, its params and state (node-id keyed), the
    same keyed by layer name (numpy), and a seeded batch."""
    jm = JaxResNet(**CFG)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, HW, HW, 3)).astype(np.float32)
    y = rng.integers(0, 10, B).astype(np.int32)
    params, state = jm.setup(jax.random.PRNGKey(0),
                             jax.ShapeDtypeStruct(x.shape, jnp.float32))
    return jm, params, state, x, y


def _by_name(jm, tree):
    return {n.module.name: jax.tree_util.tree_map(np.asarray,
                                                  tree[str(n.id)])
            for n in jm.exec_order if tree[str(n.id)]}


def _port(jm, params, state):
    tm = ResNet(device="cpu", **CFG)
    tm.load_state_dict(convert.resnet_params_from_jax(
        _by_name(jm, params), _by_name(jm, state)))
    return tm


def _jax_steps(jm, params, state, method, x, y, steps, **kw):
    # the reference's step donates its inputs: run it on copies
    params, state = jax.tree_util.tree_map(jnp.array, (params, state))
    step = jax_train_step(jm, JaxCE(), method, **kw)
    opt_state = method.init_state(params)
    losses = []
    for _ in range(steps):
        params, state, opt_state, loss = step(
            params, state, opt_state, jax.random.PRNGKey(1), jnp.asarray(x),
            jnp.asarray(y))
        losses.append(float(loss))
    return params, state, opt_state, losses


def _port_steps(tm, method, x, y, steps, **kw):
    step = optim.make_train_step(tm, CrossEntropyCriterion(), method, **kw)
    opt_state = method.init_state(dict(tm.named_parameters()))
    losses = [float(step(opt_state, torch.from_numpy(x),
                         torch.from_numpy(y).long())) for _ in range(steps)]
    return opt_state, losses


def test_three_sgd_nesterov_steps_match_reference(ref):
    jm, params, state, x, y = ref
    want_p, want_s, want_opt, want_losses = _jax_steps(
        jm, params, state, _sgd(jmethods, jsched), x, y, 3)
    tm = _port(jm, params, state)
    opt_state, losses = _port_steps(tm, _sgd(optim, optim), x, y, 3)
    np.testing.assert_allclose(losses, want_losses, **TOL)
    assert losses[2] < losses[0]
    assert int(opt_state["step"]) == 3
    np.testing.assert_allclose(
        float(_sgd(optim, optim).current_lr(opt_state)),
        float(_sgd(jmethods, jsched).current_lr(want_opt)), rtol=1e-6)
    got_p, got_s = convert.resnet_params_to_jax(tm.state_dict())
    for want, got in ((_by_name(jm, want_p), got_p),
                      (_by_name(jm, want_s), got_s)):
        assert want.keys() == got.keys()
        for name, leaves in want.items():
            for leaf, a in leaves.items():
                np.testing.assert_allclose(got[name][leaf], a,
                                           err_msg=f"{name}.{leaf}", **TOL)
    # the momentum slots too, parameter by parameter
    want_v = _by_name(jm, want_opt["velocity"])
    for key, v in opt_state["velocity"].items():
        name, leaf = key.rsplit(".", 1)
        a = want_v[name][leaf]
        got = v.numpy()
        if a.ndim == 4:                                    # HWIO <- OIHW
            got = got.transpose(2, 3, 1, 0)
        elif a.ndim == 2:
            got = got.T
        np.testing.assert_allclose(got, a, err_msg=key, **TOL)


def test_bfloat16_compute_step(ref):
    """One step with bfloat16 compute (parameters and images cast, BN
    statistics in float32, gradients back in float32): the loss within
    2 % of the reference's bfloat16 step and of the float32 loss."""
    jm, params, state, x, y = ref
    method = jmethods.SGD(learningrate=LR, momentum=0.9)
    _, _, _, want = _jax_steps(jm, params, state, method, x, y, 1,
                               compute_dtype=jnp.bfloat16)
    _, _, _, want32 = _jax_steps(jm, params, state, method, x, y, 1)
    tm = _port(jm, params, state)
    _, got = _port_steps(tm, optim.SGD(learningrate=LR, momentum=0.9), x, y,
                         1, compute_dtype=torch.bfloat16)
    assert np.isfinite(got[0])
    assert abs(got[0] - want[0]) <= 0.02 * abs(want[0])
    assert abs(got[0] - want32[0]) <= 0.02 * abs(want32[0])
    for p in tm.parameters():
        assert p.dtype == torch.float32
    assert tm.conv1_bn.running_mean.dtype == torch.float32


SCHEDULES = {
    "step": lambda m: m.Step(step_size=3, gamma=0.5),
    "multistep": lambda m: m.MultiStep([2, 5, 7], gamma=0.3),
    "poly": lambda m: m.Poly(power=0.5, max_iteration=8),
    "warmup": lambda m: m.Warmup(delta=0.01),
    "sequential": lambda m: (m.SequentialSchedule()
                             .add(m.Warmup(0.005), 3)
                             .add(m.Poly(2.0, 4), 4)
                             .add(m.Step(2, 0.5), 2)),
    "default": lambda m: m.Default(0.1),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_learning_rates_over_ten_steps(name):
    ref_sched, port_sched = SCHEDULES[name](jsched), SCHEDULES[name](optim)
    for step in range(10):
        want = float(ref_sched(0.1, jnp.asarray(step, jnp.int32),
                               jnp.asarray(1, jnp.int32)))
        got = port_sched(0.1, torch.tensor(step, dtype=torch.int32),
                         torch.tensor(1, dtype=torch.int32))
        assert got.dtype == torch.float32, (name, step)
        np.testing.assert_allclose(float(got), want, rtol=1e-6,
                                   err_msg=f"{name} step {step}")
