"""The port's GPipe pipeline (``bigdl_tpu_torch/parallel/pipeline.py``)
against the reference's ``make_pipeline_train_step``
(``bigdl_tpu/parallel/pipeline.py``) on the CPU, modelled on the
reference's ``tests/test_pipeline_moe.py``.

Each configuration is a case of one parametrised test. The reference
runs on a 4-device CPU mesh (``tests/conftest.py``'s virtual devices, a
``pipe`` axis), the port over ``["cpu"] * 4``, from the same stacked
stage parameters (``convert.pipeline_params_from_jax``) on the same
seeded microbatches, ``MSECriterion`` and ``SGD(0.1, momentum 0.9)``, two
steps:

- ``linear_tanh``: the reference test's stage (``Linear(16, 16)`` then
  ``Tanh``), 4 stages, 8 microbatches of 2;
- ``gpt_block``: a GPT decoder block a stage (hidden 64, 4 heads), 4
  stages, 4 microbatches of 2 x 16 tokens; its attention runs the flash
  kernels' plain versions on the CPU.

Held: each step's loss within 1e-5 relative of the reference's; the new
parameters and the momentum slots within 1e-5 of each tensor's largest
magnitude (``pipeline_params_to_jax``); the step counters. The first
step's loss and gradients also equal the sequential oracle's: the stages
applied in turn to the whole batch, one criterion call.
"""

import copy

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import bigdl_tpu.nn as jnn
from bigdl_tpu.models.gpt import TransformerDecoderBlock as JBlock
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.parallel.pipeline import make_pipeline_train_step as jmake
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models.gpt import TransformerDecoderBlock
from bigdl_tpu_torch.optim import SGD
from bigdl_tpu_torch.parallel import make_pipeline_train_step, \
    pipeline_apply

CPU = "cpu"
N_STAGES = 4
LR, MOMENTUM = 0.1, 0.9


def _linear_tanh():
    d = 16
    return (lambda: jnn.Sequential().add(jnn.Linear(d, d)).add(jnn.Tanh()),
            lambda: tnn.Sequential(tnn.Linear(d, d, device=CPU), tnn.Tanh()),
            8, (2, d))


def _gpt_block():
    hidden, heads = 64, 4
    return (lambda: jnn.Sequential().add(JBlock(hidden, heads)),
            lambda: tnn.Sequential(TransformerDecoderBlock(hidden, heads,
                                                           device=CPU)),
            4, (2, 16, hidden))


CONFIGS = {"linear_tanh": _linear_tanh, "gpt_block": _gpt_block}


def _setup(name):
    jstage_ctor, tstage_ctor, n_micro, mb = CONFIGS[name]()
    stages = []
    for s in range(N_STAGES):
        st = jstage_ctor()
        st.build(s, mb)
        stages.append(st.params)
    stacked = jtu.tree_map(lambda *v: np.stack([np.asarray(a) for a in v]),
                           *stages)
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((n_micro,) + mb).astype(np.float32)
    ys = rng.standard_normal((n_micro,) + mb).astype(np.float32)
    jstage = jstage_ctor()
    jstage.build(0, mb)
    return jstage, tstage_ctor(), stacked, xs, ys, n_micro


def _close(got, want, what, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


def _trees_close(got, want, what):
    gl, wl = jtu.tree_leaves(got), jtu.tree_leaves(want)
    assert len(gl) == len(wl), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        _close(g, w, f"{what} leaf {i}")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_pipeline_step_matches_the_reference(name):
    jstage, tstage, stacked, xs, ys, n_micro = _setup(name)
    mesh = Mesh(np.asarray(jax.devices()[:N_STAGES]), ("pipe",))
    jstep, jparams, jopt = jmake(jstage, jnn.MSECriterion(),
                                 JSGD(learningrate=LR, momentum=MOMENTUM),
                                 mesh, n_micro=n_micro)(
        jtu.tree_map(jnp.asarray, stacked))
    factory = make_pipeline_train_step(
        tstage, tnn.MSECriterion(), SGD(learningrate=LR, momentum=MOMENTUM),
        [CPU] * N_STAGES, n_micro=n_micro)
    step, params, opt = factory(convert.pipeline_params_from_jax(tstage,
                                                                 stacked))
    assert all(p is not q for a, b in zip(params, params[1:])
               for p, q in zip(a.values(), b.values()))
    for it in range(2):
        jparams, jopt, jloss = jstep(jparams, jopt, jnp.asarray(xs),
                                     jnp.asarray(ys))
        params, opt, loss = step(params, opt, torch.from_numpy(xs),
                                 torch.from_numpy(ys))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                                   err_msg=f"step {it} loss")
        _trees_close(convert.pipeline_params_to_jax(tstage, params),
                     jtu.tree_map(np.asarray, jparams), f"step {it} params")
        _trees_close(convert.pipeline_params_to_jax(
            tstage, [o["velocity"] for o in opt]),
            jtu.tree_map(np.asarray, jopt["velocity"]),
            f"step {it} velocity")
        assert all(int(o["step"]) == int(jopt["step"]) == it + 1
                   for o in opt)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_pipeline_loss_and_gradients_are_the_sequential_oracles(name):
    """One plain SGD step of the pipeline equals the stages applied in turn
    to the whole batch with one criterion call and one SGD step."""
    _, tstage, stacked, xs, ys, n_micro = _setup(name)
    factory = make_pipeline_train_step(tstage, tnn.MSECriterion(),
                                       SGD(learningrate=LR),
                                       [CPU] * N_STAGES, n_micro=n_micro)
    stacked_t = convert.pipeline_params_from_jax(tstage, stacked)
    step, params, opt = factory(stacked_t)
    _, _, loss = step(params, opt, torch.from_numpy(xs),
                      torch.from_numpy(ys))
    # the oracle: stage copies with each stage's weights
    chain = []
    for s in range(N_STAGES):
        m = copy.deepcopy(tstage)
        m.load_state_dict({k: v[s] for k, v in stacked_t.items()})
        chain.append(m)
    flat = torch.from_numpy(xs.reshape((-1,) + xs.shape[2:]))
    h = flat
    for m in chain:
        h = m(h)
    want = tnn.MSECriterion()(h, torch.from_numpy(
        ys.reshape((-1,) + ys.shape[2:])))
    np.testing.assert_allclose(float(loss), float(want.detach()),
                               rtol=1e-5)
    grads = torch.autograd.grad(want, [p for m in chain
                                       for p in m.parameters()])
    it = iter(grads)
    for s, m in enumerate(chain):
        for (k, w), g in zip(m.named_parameters(), it):
            _close(params[s][k].detach(), (w - LR * g).detach(),
                   f"stage {s} {k}")


def test_pipeline_apply_runs_each_microbatch_through_every_stage():
    """The schedule alone: stage ``s`` adds ``s + 1``; a stage on another
    device gets its input there; the outputs come back in microbatch
    order, on the last stage's device."""
    calls = []

    def stage(s):
        def fn(x):
            calls.append((s, int(x[0])))
            return x + (s + 1)
        fn.device = torch.device(CPU)
        return fn

    xs = torch.arange(5, dtype=torch.float32)[:, None] * 100
    out = pipeline_apply([stage(s) for s in range(3)], xs)
    np.testing.assert_array_equal(out.numpy(), xs.numpy() + 6)
    # GPipe order: at tick t stage s runs microbatch t - s
    ticks = {}
    for s, v in calls:
        ticks.setdefault(s, []).append(v)
    assert ticks[0] == [0, 100, 200, 300, 400]
    assert ticks[2] == [3, 103, 203, 303, 403]
    assert calls[:3] == [(0, 0), (1, 1), (0, 100)]
