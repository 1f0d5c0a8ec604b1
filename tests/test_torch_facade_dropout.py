"""The training facade's random stream (``bigdl_tpu_torch/optim/
optimizer.py`` ``Optimizer(seed=)``, ``parallel/distri_optimizer.py``,
``parallel/allreduce.py`` ``replica_generators``): a model whose forward
takes a ``generator`` gets one at every step, seeded from ``seed``, so
its dropout draws while it trains, as the reference's does from its
``jax.random`` key.

The draws are torch's, so they cannot equal the reference's: the runs
here are held against each other (dropout on against off, seed against
seed, replica against replica), and with dropout off the first loss
against the reference's at 1e-5 relative. Each dataset's epoch shuffle is
pinned to one seed, as the facade's parity tests pin it, so two runs see
the same batches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models import vgg as jvgg
from bigdl_tpu.nn.criterion import ClassNLLCriterion as JaxNLL
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as topt
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.models import GPTForCausalLM, VggForCifar10
from bigdl_tpu_torch.parallel import DistriOptimizer
from bigdl_tpu_torch.parallel.allreduce import replica_generators

GPT_CFG = dict(vocab_size=61, hidden_size=32, n_layers=2, n_heads=2,
               max_position=32)
FIRST_REL = 1e-5


class Losses:
    def __init__(self):
        self.values = []

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.values.append(float(value))


def _pinned(ds, seed=5):
    base = type(ds)

    class Pinned(base):
        def shuffle(self, _seed=None):
            return base.shuffle(self, seed)

    ds.__class__ = Pinned
    return ds


def _gpt_losses(dropout, seed, steps=3):
    ids = np.random.default_rng(0).integers(0, 61, (16, 17)).astype(np.int32)
    model = GPTForCausalLM(**GPT_CFG, dropout=dropout, device="cpu")
    model.load_state_dict(convert.init_params(model, seed=0))
    ds = _pinned(DataSet.array([Sample(ids[i, :-1], ids[i, 1:])
                                for i in range(16)]) >> SampleToMiniBatch(4))
    log = Losses()
    opt = topt.Optimizer(model=model, dataset=ds,
                         criterion=tnn.CrossEntropyCriterion(), seed=seed)
    opt.set_optim_method(topt.SGD(learningrate=0.1))
    opt.set_end_when(topt.Trigger.max_iteration(steps))
    opt.set_train_summary(log)
    opt.optimize()
    return log.values


def test_gpt_dropout_draws_through_the_facade():
    off = _gpt_losses(0.0, 1)
    on = _gpt_losses(0.1, 1)
    assert len(off) == len(on) == 3
    assert on != off
    assert _gpt_losses(0.1, 1) == on
    assert _gpt_losses(0.1, 2) != on
    # without dropout the seed changes nothing
    assert _gpt_losses(0.0, 2) == off


def test_facade_passes_a_generator_only_to_a_forward_that_takes_one():
    class Plain(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = tnn.Linear(4, 3, device="cpu").reset(0)

        def forward(self, x):
            return torch.log_softmax(self.lin(x), -1)

    rng = np.random.default_rng(1)
    ds = DataSet.array([Sample(rng.standard_normal(4).astype(np.float32),
                               np.int32(i % 3)) for i in range(8)]) \
        >> SampleToMiniBatch(4)
    opt = topt.Optimizer(model=Plain(), dataset=ds,
                         criterion=tnn.ClassNLLCriterion())
    opt.set_end_when(topt.Trigger.max_iteration(2)).optimize()
    assert opt.metrics["steps"] == 2
    assert opt._generator("cpu") is None
    opt2 = topt.Optimizer(model=tnn.Sequential().add(Plain()), dataset=ds,
                          criterion=tnn.ClassNLLCriterion(), seed=7)
    g = opt2._generator("cpu")
    assert g.initial_seed() == 7


def _cifar_records(n=8, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 3, 32, 32)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    return x, y


def _cifar_losses(has_dropout, seed, params=None, state=None, steps=2,
                  batch=4):
    x, y = _cifar_records()
    model = VggForCifar10(10, has_dropout=has_dropout, device="cpu")
    if params is not None:
        model.load_state_dict(convert.module_params_from_jax(model, params,
                                                             state))
    ds = _pinned(DataSet.array([Sample(x[i], y[i]) for i in range(len(x))])
                 >> SampleToMiniBatch(batch))
    log = Losses()
    opt = topt.Optimizer(model=model, dataset=ds,
                         criterion=tnn.ClassNLLCriterion(), seed=seed)
    opt.set_optim_method(topt.SGD(learningrate=0.01))
    opt.set_end_when(topt.Trigger.max_iteration(steps))
    opt.set_train_summary(log)
    opt.optimize()
    return log.values


def test_vgg_cifar_dropout_through_the_facade():
    on = _cifar_losses(True, 1)
    assert len(on) == 2 and all(np.isfinite(on))
    assert _cifar_losses(True, 1) == on
    assert _cifar_losses(True, 2) != on


def test_vgg_cifar_without_dropout_starts_at_the_reference_loss():
    """One batch of all 8 records: the facade's first loss is the
    reference's training-mode loss on them, whatever the shuffle's
    order."""
    x, y = _cifar_records()
    jm = jvgg.VggForCifar10(10, has_dropout=False)
    params, state = jm.setup(jax.random.PRNGKey(0),
                             jax.ShapeDtypeStruct(x.shape, jnp.float32))
    out, _ = jm.apply(params, state, jnp.asarray(x), training=True)
    want = float(JaxNLL().apply(out, jnp.asarray(y)))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    np_state = jax.tree_util.tree_map(np.asarray, state)
    got = _cifar_losses(False, 1, np_params, np_state, steps=1, batch=8)
    assert abs(got[0] - want) <= FIRST_REL * abs(want)


def test_replica_generators_are_distinct_and_follow_the_seed():
    def draws(seed):
        gens = replica_generators(torch.Generator().manual_seed(seed),
                                  ["cpu", "cpu"])
        return [torch.rand(64, generator=g) for g in gens]

    a, b = draws(1)
    assert not torch.equal(a, b)
    a2, b2 = draws(1)
    assert torch.equal(a, a2) and torch.equal(b, b2)
    assert not torch.equal(draws(2)[0], a)


def _distri_masks(seed):
    """Each replica's dropout masks over 2 steps of a 2-replica
    ``DistriOptimizer`` whose records are all the same row, so the
    replicas see equal inputs."""
    model = (tnn.Sequential().add(tnn.Linear(6, 16, device="cpu"))
             .add(tnn.Dropout(0.5)).add(tnn.Linear(16, 3, device="cpu"))
             .add(tnn.LogSoftMax())).reset(0)
    row = np.random.default_rng(4).standard_normal(6).astype(np.float32)
    ds = DataSet.array([Sample(row, np.int32(1)) for _ in range(8)],
                       distributed=True) >> SampleToMiniBatch(4)
    opt = DistriOptimizer(model=model, dataset=ds,
                          criterion=tnn.ClassNLLCriterion(),
                          mesh=["cpu", "cpu"], seed=seed)
    opt.set_end_when(topt.Trigger.max_iteration(2))
    masks = {0: [], 1: []}
    build = opt._build_step

    def hooked():
        build()
        for q, r in enumerate(opt._step.state.replicas):
            r[1].register_forward_hook(
                lambda m, i, o, q=q: masks[q].append(o.detach() == 0))

    opt._build_step = hooked
    opt.optimize()
    return masks


def test_distri_replicas_draw_different_masks():
    masks = _distri_masks(1)
    assert len(masks[0]) == len(masks[1]) == 2
    for step in range(2):
        assert not torch.equal(masks[0][step], masks[1][step])
        assert masks[0][step].any() and not masks[0][step].all()
    assert not torch.equal(masks[0][0], masks[0][1])
    again = _distri_masks(1)
    assert all(torch.equal(a, b) for q in (0, 1)
               for a, b in zip(masks[q], again[q]))
    assert not torch.equal(_distri_masks(2)[0][0], masks[0][0])


@pytest.mark.parametrize("steps_per_loop", [1, 2])
def test_steps_per_loop_draws_the_same_stream(steps_per_loop):
    """The K-step loop takes the step's generator: K = 2 gives K = 1's
    losses with dropout on."""
    ids = np.random.default_rng(0).integers(0, 61, (16, 17)).astype(np.int32)

    def run(k):
        model = GPTForCausalLM(**GPT_CFG, dropout=0.1, device="cpu")
        model.load_state_dict(convert.init_params(model, seed=0))
        ds = _pinned(DataSet.array([Sample(ids[i, :-1], ids[i, 1:])
                                    for i in range(16)])
                     >> SampleToMiniBatch(4))
        log = Losses()
        opt = topt.Optimizer(model=model, dataset=ds,
                             criterion=tnn.CrossEntropyCriterion(), seed=3,
                             steps_per_loop=k)
        opt.set_optim_method(topt.SGD(learningrate=0.1))
        opt.set_end_when(topt.Trigger.max_iteration(4))
        opt.set_train_summary(log)
        opt.optimize()
        return log.values

    np.testing.assert_allclose(run(steps_per_loop), run(1), rtol=1e-6)
