"""The port's triggers, validation methods and evaluators
(``bigdl_tpu_torch/optim/trigger.py``, ``validation.py``,
``evaluator.py``) against the JAX reference's on the CPU.

Triggers must decide alike over the same ``driver_state`` dicts. The
validation methods' counters on the same outputs must agree (accuracies
exactly; losses and MAE within 1e-6 relative), with and without the
padded-row mask, per sample and per token. ``Evaluator`` on LeNet with
the reference's weights over a test set with a padded tail must give the
reference's counts exactly and its loss within 1e-5 relative (float32
convolutions in two libraries' orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.optim as jopt
from bigdl_tpu.dataset.mnist import mnist_dataset as jax_mnist_dataset
from bigdl_tpu.models.lenet import LeNet5 as JaxLeNet5
from bigdl_tpu.optim.validation import _row_mask as jax_row_mask
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import optim as topt
from bigdl_tpu_torch.dataset.mnist import mnist_dataset
from bigdl_tpu_torch.models import LeNet5
from bigdl_tpu_torch.optim.validation import _row_mask

TRIGGERS = {
    "every_epoch": lambda T: T.every_epoch(),
    "several_iteration": lambda T: T.several_iteration(3),
    "max_epoch": lambda T: T.max_epoch(2),
    "max_iteration": lambda T: T.max_iteration(5),
    "max_score": lambda T: T.max_score(0.8),
    "min_loss": lambda T: T.min_loss(0.1),
    "and": lambda T: T.and_(T.max_epoch(1), T.several_iteration(2)),
    "or": lambda T: T.or_(T.min_loss(0.5), T.max_iteration(3)),
}

STATES = [
    {"epoch": e, "neval": n, "loss": lo, "score": sc, "epoch_finished": f}
    for e in (1, 2, 3) for n in (0, 1, 2, 3, 5, 6)
    for lo, sc in ((None, None), (0.05, 0.9), (0.3, 0.5))
    for f in (False, True)]


@pytest.mark.parametrize("name", list(TRIGGERS))
def test_trigger_decides_as_reference(name):
    t, j = TRIGGERS[name](topt.Trigger), TRIGGERS[name](jopt.Trigger)
    got = [t(s) for s in STATES]
    assert got == [j(s) for s in STATES]
    assert any(got) or name == "max_score"


def _outputs(rows, classes, seed):
    rng = np.random.default_rng(seed)
    out = np.log(rng.dirichlet(np.ones(classes), rows)).astype(np.float32)
    return out, rng.integers(0, classes, rows).astype(np.int32)


METHODS = ["Top1Accuracy", "Top5Accuracy", "Loss", "MAE"]


def _inputs(name, rows, seed):
    out, y = _outputs(rows, 7, seed)
    if name == "MAE":
        return out, (out + np.random.default_rng(seed).standard_normal(
            out.shape).astype(np.float32) * 0.1)
    return out, y


@pytest.mark.parametrize("valid", ["none", "all", "padded"])
@pytest.mark.parametrize("name", METHODS)
def test_validation_counters_match_reference(name, valid):
    out, y = _inputs(name, 10, 1)
    mask = {"none": None, "all": np.ones(10, bool),
            "padded": np.arange(10) < 6}[valid]
    tm, jm = getattr(topt, name)(), getattr(jopt, name)()
    tv, tc = tm.counters(torch.from_numpy(out), torch.from_numpy(y),
                         None if mask is None else torch.from_numpy(mask))
    jv, jc = jm.counters(jnp.asarray(out), jnp.asarray(y),
                         None if mask is None else jnp.asarray(mask))
    assert int(tc) == int(jc) == (6 if valid == "padded" else 10)
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-6)
    g = tm.make_result(tv, tc).result()
    w = jm.make_result(jv, jc).result()
    assert g[1] == w[1]
    np.testing.assert_allclose(g[0], w[0], rtol=1e-6)
    # a padded batch's masked counters equal those of its real rows alone
    if valid == "padded":
        rv, rc = tm.counters(torch.from_numpy(out[:6]),
                             torch.from_numpy(y[:6]))
        np.testing.assert_allclose(float(tv), float(rv), rtol=1e-6)
        assert int(tc) == int(rc)


def test_results_add_and_mask_expands_per_token():
    a = topt.Top1Accuracy()(torch.tensor([[0.1, 0.9]]), torch.tensor([1]))
    b = topt.Top1Accuracy()(torch.tensor([[0.9, 0.1]]), torch.tensor([1]))
    s = a + b
    assert s.result() == (0.5, 2) and float(s) == 0.5
    lr = topt.LossResult(3.0, 2) + topt.LossResult(1.0, 2)
    assert lr.result() == (1.0, 4)
    valid = np.array([True, True, False])
    np.testing.assert_array_equal(_row_mask(torch.from_numpy(valid),
                                            12).numpy(),
                                  np.asarray(jax_row_mask(
                                      jnp.asarray(valid), 12)))
    with pytest.raises(ValueError, match="cannot align"):
        _row_mask(torch.from_numpy(valid), 7)
    # per-token rows: (3 samples x 4 steps) of outputs
    out, y = _outputs(12, 5, 4)
    t, j = topt.Top1Accuracy(), jopt.Top1Accuracy()
    tv, tc = t.counters(torch.from_numpy(out.reshape(3, 4, 5)),
                        torch.from_numpy(y.reshape(3, 4)),
                        torch.from_numpy(valid))
    jv, jc = j.counters(jnp.asarray(out.reshape(3, 4, 5)),
                        jnp.asarray(y.reshape(3, 4)), jnp.asarray(valid))
    assert (int(tv), int(tc)) == (int(jv), int(jc)) and int(tc) == 8


def test_evaluator_on_lenet_matches_reference():
    jm = JaxLeNet5(10).build(0, (2, 1, 28, 28))
    tm = LeNet5(10, device="cpu")
    tm.load_state_dict(convert.module_params_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, jm.params)))
    kw = dict(training=False, batch_size=64, synthetic_size=200)
    methods = ["Top1Accuracy", "Top5Accuracy", "Loss"]
    got = topt.Evaluator(tm).evaluate(mnist_dataset(**kw),
                                      [getattr(topt, m)() for m in methods])
    want = jopt.Evaluator(jm).evaluate(jax_mnist_dataset(**kw),
                                       [getattr(jopt, m)() for m in methods])
    assert list(got) == methods
    for m in methods:
        (gv, gc), (wv, wc) = got[m].result(), want[m].result()
        assert gc == wc == 200
        if m == "Loss":
            np.testing.assert_allclose(gv, wv, rtol=1e-5)
        else:
            assert gv == wv
    assert tm.training        # the evaluator restores the mode
    ds = mnist_dataset(**kw)
    preds = topt.Predictor(tm).predict(ds)
    assert preds.shape == (200, 10)
    np.testing.assert_allclose(preds, np.asarray(jopt.Predictor(jm).predict(
        jax_mnist_dataset(**kw))), rtol=0, atol=2e-5)
    val = topt.LocalValidator(tm, ds).test([topt.Top1Accuracy()])
    assert val["Top1Accuracy"].result() == got["Top1Accuracy"].result()
