"""The port's mesh inference (``Predictor(mesh=)``, ``DistriPredictor``,
``DistriValidator``) and the DistriOptimizer's in-mesh validation against
the reference's, on the CPU (the reference on the 8-device virtual CPU
mesh of ``tests/conftest.py``, the port on ``mesh=["cpu"] * N``), from
the same seeded weights.

Bars: predictions within rtol 1e-5 / atol 1e-6 of the host path and of
the reference's (the reference test's own bar,
``tests/test_distributed.py:680``); validation counts and accuracies
equal, losses within 1e-5 (``tests/test_distributed.py:660``).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as jopt
from bigdl_tpu.dataset.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset.sample import Sample as JaxSample
from bigdl_tpu.dataset.transformer import SampleToMiniBatch as JaxS2MB
from bigdl_tpu.parallel.allreduce import AllReduceParameter as JaxARP
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as topt
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch
from bigdl_tpu_torch.optim.validation import AccuracyResult, ValidationMethod
from bigdl_tpu_torch.parallel import DistriOptimizer


def _mesh(n=8):
    return Mesh(np.asarray(jax.devices()[:n]), axis_names=("data",))


def _models(seed=0):
    def build(pkg, **kw):
        return (pkg.Sequential().add(pkg.Linear(4, 16, **kw))
                .add(pkg.ReLU()).add(pkg.Linear(16, 3, **kw))
                .add(pkg.LogSoftMax()))

    jm = build(jnn).build(seed, (8, 4))
    tm = build(tnn, device="cpu")
    tm.load_state_dict(convert.module_params_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, jm.params)))
    return jm, tm


def _datasets(n, seed, batch):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    y = (np.abs(x).argmax(axis=1) % 3).astype(np.int32)
    jds = JaxDataSet.array([JaxSample(x[i], y[i]) for i in range(n)]) \
        >> JaxS2MB(batch)
    tds = DataSet.array([Sample(x[i], y[i]) for i in range(n)]) \
        >> SampleToMiniBatch(batch)
    return jds, tds


@pytest.mark.parametrize("n,samples,batch", [
    (8, 64, 16),     # every batch split over the mesh
    (8, 15, 5),      # no batch divides the mesh: each runs unsplit
    (8, 19, 8),      # a padded tail, trimmed
    (2, 19, 8),
    (3, 40, 12)])
def test_distri_predictor_matches_host_and_reference(n, samples, batch):
    jm, tm = _models()
    jds, tds = _datasets(samples, 9 + samples, batch)
    want = np.asarray(jopt.DistriPredictor(jm, mesh=_mesh(n)).predict(jds))
    host = topt.Predictor(tm).predict(tds)
    got = topt.DistriPredictor(tm, mesh=["cpu"] * n).predict(tds)
    assert got.shape == host.shape == want.shape == (samples, 3)
    np.testing.assert_allclose(got, host, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    same = topt.Predictor(tm, mesh=["cpu"] * n).predict(tds)
    np.testing.assert_array_equal(same, got)
    np.testing.assert_array_equal(
        topt.DistriPredictor(tm, mesh=["cpu"] * n).predict_class(tds),
        np.argmax(got, axis=-1))


def test_distri_predictor_without_a_mesh_takes_every_card():
    """``mesh=None`` is every visible card; there is none here."""
    _, tm = _models()
    with pytest.raises(RuntimeError, match="no CUDA device|there is none"):
        topt.DistriPredictor(tm)


def test_distri_validator_matches_reference():
    jm, tm = _models()
    jds, tds = _datasets(100, 11, 64)
    want = jopt.DistriValidator(jm, jds).test([jopt.Top1Accuracy(),
                                               jopt.Loss()])
    got = topt.DistriValidator(tm, tds).test([topt.Top1Accuracy(),
                                              topt.Loss()])
    assert got["Top1Accuracy"].result() == want["Top1Accuracy"].result()
    assert abs(got["Loss"].result()[0] - want["Loss"].result()[0]) < 1e-5


@pytest.mark.parametrize("n", [2, 4, 8])
def test_inmesh_validation_masks_the_padded_tail_like_reference(n):
    """100 samples in batches of 64: the second batch's 28 padded rows
    are masked out of the counters on both sides (the reference's
    ``test_padded_tail_masked_exactly``), on the wire-rounded weights."""
    jm, tm = _models()
    jds, tds = _datasets(100, 11, 64)
    jo = jopt.Optimizer(model=jm, dataset=jds,
                        criterion=jnn.ClassNLLCriterion(), mesh=_mesh(n))
    jo.set_optim_method(jopt.SGD(learningrate=0.05))
    jo.set_validation(jopt.Trigger.every_epoch(), jds,
                      [jopt.Top1Accuracy(), jopt.Loss()])
    flat = jax.device_put(JaxARP(jm.params, n).flat(),
                          NamedSharding(_mesh(n), P("data")))
    state = jax.device_put(jm.state, NamedSharding(_mesh(n), P()))
    want = jo._validate_inmesh(flat, state)

    to = topt.Optimizer(model=tm, dataset=tds,
                        criterion=tnn.ClassNLLCriterion(),
                        mesh=["cpu"] * n)
    to.set_validation(topt.Trigger.every_epoch(), tds,
                      [topt.Top1Accuracy(), topt.Loss()])
    to._ensure_ready()
    to._build_step()
    got = to._validate_inmesh()
    assert got["Top1Accuracy"].result() == want["Top1Accuracy"].result()
    assert got["Top1Accuracy"].result()[1] == 100
    lg, ng = got["Loss"].result()
    lw, nw = want["Loss"].result()
    assert ng == nw == 100 and abs(lg - lw) < 1e-5


def test_custom_method_without_counters_validates_on_the_host():
    """A ValidationMethod with no ``counters`` has no in-mesh form:
    ``_validate_inmesh`` returns None and the hook validates the
    materialized model on the host."""

    class Weird(ValidationMethod):
        name = "Weird"

        def __call__(self, output, target):
            return AccuracyResult(1, 1)

    _, tm = _models()
    _, tds = _datasets(64, 7, 32)
    to = DistriOptimizer(model=tm, dataset=tds,
                         criterion=tnn.ClassNLLCriterion(),
                         mesh=["cpu", "cpu"])
    to.set_optim_method(topt.SGD(learningrate=0.05))
    to.set_end_when(topt.Trigger.max_epoch(1))
    to.set_validation(topt.Trigger.every_epoch(), tds, [Weird()])
    seen = []
    to.set_validation_summary(type("S", (), {
        "add_scalar": lambda self, tag, v, step: seen.append((tag, v))})())
    to.optimize()
    assert to._validate_inmesh() is None
    assert seen == [("Weird", 1.0)]


def test_inmesh_validation_under_bfloat16_compute():
    """``compute_dtype=bfloat16``: each replica's forward on cast weights
    and inputs; every real sample is counted once."""
    _, tm = _models()
    _, tds = _datasets(100, 11, 64)
    to = DistriOptimizer(model=tm, dataset=tds,
                         criterion=tnn.ClassNLLCriterion(),
                         mesh=["cpu", "cpu"], compute_dtype=torch.bfloat16)
    to.set_validation(topt.Trigger.every_epoch(), tds, [topt.Top1Accuracy()])
    to._ensure_ready()
    to._build_step()
    acc, count = to._validate_inmesh()["Top1Accuracy"].result()
    assert count == 100 and 0.0 <= acc <= 1.0
