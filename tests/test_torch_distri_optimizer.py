"""The port's ``DistriOptimizer`` (``bigdl_tpu_torch/parallel/
distri_optimizer.py``) against the reference's, on the CPU, through the
reference's API: ``Optimizer(model=, dataset=, criterion=, mesh=)``,
``optimize()``, the summaries.

The reference runs on the 8-device virtual CPU mesh of
``tests/conftest.py``, the port on ``mesh=["cpu"] * N``. Both train on a
``DistributedDataSet`` (``DataSet.array(..., distributed=True)``), whose
epoch shuffle draws from the epoch count, so both see the same batches;
both start from the reference's seeded weights.

Bars: per-iteration losses within 1e-4 relative and final weights within
1e-4 absolute (the same float32 math in two libraries' orders, carried
from step to step by SGD; bfloat16 wire rounds the same sums, so the
same bar holds there); validation accuracies equal as counts and losses
within 1e-4 relative; ``steps_per_loop=2`` against K = 1 within 1e-6
(the same eager steps, grouped).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as jopt
from bigdl_tpu.dataset.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset.sample import Sample as JaxSample
from bigdl_tpu.dataset.transformer import SampleToMiniBatch as JaxS2MB
from bigdl_tpu.parallel import DistriOptimizer as JaxDistri
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as topt
from bigdl_tpu_torch.dataset import DataSet, DistributedDataSet
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch
from bigdl_tpu_torch.parallel import DistriOptimizer
from bigdl_tpu_torch.utils.serializer import load_module


class Summary:
    """A TrainSummary stand-in: keeps every scalar by tag."""

    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, step):
        self.scalars.setdefault(tag, []).append((step, float(value)))

    def values(self, tag="Loss"):
        return [v for _, v in self.scalars.get(tag, [])]

    def steps(self, tag="Loss"):
        return [s for s, _ in self.scalars.get(tag, [])]


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), axis_names=("data",))


def _models(seed=0):
    def build(pkg, **kw):
        return (pkg.Sequential().add(pkg.Linear(4, 16, **kw))
                .add(pkg.ReLU()).add(pkg.Linear(16, 3, **kw))
                .add(pkg.LogSoftMax()))

    jm = build(jnn).build(seed, (2, 4))
    tm = build(tnn, device="cpu")
    tm.load_state_dict(convert.module_params_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, jm.params)))
    return jm, tm


def _data(n=128, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    y = (np.abs(x).argmax(axis=1) % 3).astype(np.int32)
    return x, y


def _datasets(n=128, seed=3, batch=32):
    x, y = _data(n, seed)
    jds = JaxDataSet.array([JaxSample(x[i], y[i]) for i in range(n)],
                           distributed=True) >> JaxS2MB(batch)
    tds = DataSet.array([Sample(x[i], y[i]) for i in range(n)],
                        distributed=True) >> SampleToMiniBatch(batch)
    return jds, tds


def _weights(tm):
    return jax.tree_util.tree_leaves(convert.module_params_to_jax(tm)[0])


def _check_weights(jm, tm, atol=1e-4):
    for a, b in zip(jax.tree_util.tree_leaves(jm.params), _weights(tm)):
        np.testing.assert_allclose(np.asarray(a), b, atol=atol)


def _train(jm, tm, jds, tds, n=2, epochs=2, wire=None, val=None, ckpt=None,
           jmethod=None, tmethod=None, **kw):
    """Both optimizers set up alike; returns (jopt, topt, jsum, tsum,
    jval, tval)."""
    jwire = None if wire is None else getattr(jax.numpy, wire)
    twire = None if wire is None else getattr(torch, wire)
    jo = jopt.Optimizer(model=jm, dataset=jds,
                        criterion=jnn.ClassNLLCriterion(), mesh=_mesh(n),
                        wire_dtype=jwire, **kw)
    to = topt.Optimizer(model=tm, dataset=tds,
                        criterion=tnn.ClassNLLCriterion(),
                        mesh=["cpu"] * n, wire_dtype=twire, **kw)
    sums = []
    for pkg, o, method in ((jopt, jo, jmethod), (topt, to, tmethod)):
        o.set_optim_method(method or pkg.SGD(learningrate=0.1,
                                             momentum=0.9))
        o.set_end_when(pkg.Trigger.max_epoch(epochs))
        s, vs = Summary(), Summary()
        o.set_train_summary(s)
        o.set_validation_summary(vs)
        if val is not None:
            o.set_validation(pkg.Trigger.every_epoch(),
                             val[0] if pkg is jopt else val[1],
                             [pkg.Top1Accuracy(), pkg.Loss()])
        if ckpt is not None:
            o.set_checkpoint(str(ckpt / pkg.__name__.split(".")[0]),
                             pkg.Trigger.several_iteration(2))
        sums += [s, vs]
    return jo, to, sums


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_end_to_end_matches_reference(wire):
    """Two epochs at N = 2 on a distributed dataset, with in-mesh
    validation over a padded tail (100 samples, batches of 64)."""
    jm, tm = _models()
    jds, tds = _datasets()
    jv, tv = _datasets(n=100, seed=11, batch=64)
    jo, to, (js, jvs, ts, tvs) = _train(jm, tm, jds, tds, wire=wire,
                                        val=(jv, tv))
    assert isinstance(jo, JaxDistri) and isinstance(to, DistriOptimizer)
    jo.optimize()
    to.optimize()
    assert ts.steps() == js.steps() == list(range(1, 9))
    np.testing.assert_allclose(ts.values(), js.values(), rtol=1e-4)
    _check_weights(jm, tm)
    assert tvs.values("Top1Accuracy") == jvs.values("Top1Accuracy")
    np.testing.assert_allclose(tvs.values("Loss"), jvs.values("Loss"),
                               rtol=1e-4)
    # the in-mesh counters count every real sample of the padded tail once
    res = to._validate_inmesh()
    assert res["Top1Accuracy"].result()[1] == 100
    assert res["Loss"].result()[1] == 100
    m = to.metrics_summary()
    assert m["steps"] == 8 and m["allreduce_bytes_total"] > 0
    assert to.metrics["dispatches"] == 8 and to.retries == 0


@pytest.mark.parametrize("n", [2, 4])
def test_adam_at_four_replicas_matches_reference(n):
    jm, tm = _models(seed=1)
    jds, tds = _datasets(seed=4)
    jo, to, (js, _, ts, _) = _train(
        jm, tm, jds, tds, n=n, wire="float32",
        jmethod=jopt.Adam(learningrate=0.02),
        tmethod=topt.Adam(learningrate=0.02))
    jo.optimize()
    to.optimize()
    np.testing.assert_allclose(ts.values(), js.values(), rtol=1e-4)
    _check_weights(jm, tm)


def test_steps_per_loop_matches_single_steps():
    """``steps_per_loop=2``: the same steps in half the dispatches."""
    results = []
    for k in (1, 2):
        _, tm = _models()
        _, tds = _datasets()
        to = DistriOptimizer(model=tm, dataset=tds,
                             criterion=tnn.ClassNLLCriterion(),
                             mesh=["cpu", "cpu"], steps_per_loop=k)
        to.set_optim_method(topt.SGD(learningrate=0.1, momentum=0.9))
        to.set_end_when(topt.Trigger.max_epoch(2))
        s = Summary()
        to.set_train_summary(s)
        to.optimize()
        results.append((s, _weights(tm), to.metrics["dispatches"]))
    (s1, w1, d1), (s2, w2, d2) = results
    assert s1.steps() == s2.steps()
    np.testing.assert_allclose(s2.values(), s1.values(), rtol=1e-6)
    for a, b in zip(w1, w2):
        np.testing.assert_allclose(a, b, atol=1e-6)
    assert (d1, d2) == (8, 4)


def test_factory_and_batch_checks_match_reference():
    """``Optimizer`` returns the DistriOptimizer for ``mesh=`` and for a
    distributed dataset; a batch the mesh does not divide raises the
    reference's message, as does an ``accumulate_steps`` that does not
    divide a replica's rows."""
    jm, tm = _models()
    jds, tds = _datasets(batch=30)
    errors = []
    for jo_or_to in _train(jm, tm, jds, tds, n=4, epochs=1)[:2]:
        with pytest.raises(ValueError) as e:
            jo_or_to.optimize()
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert "batchSize % nodeNumber == 0" in errors[1]
    _, tds = _datasets(batch=32)
    to = DistriOptimizer(model=tm, dataset=tds,
                         criterion=tnn.ClassNLLCriterion(),
                         mesh=["cpu"] * 4, accumulate_steps=3)
    with pytest.raises(ValueError, match="accumulate_steps=3 must divide"):
        to.optimize()
    made = topt.Optimizer.__new__(topt.Optimizer, model=tm, dataset=tds,
                                  criterion=tnn.ClassNLLCriterion())
    assert type(made) is DistriOptimizer
    assert isinstance(tds, DistributedDataSet)


def test_distributed_dataset_orders_match_reference():
    """The seeded epoch shuffle, ``size``/``local_size``/``origin_rdd``."""
    from bigdl_tpu.dataset.dataset import DistributedDataSet as JaxDDS
    recs = list(range(37))
    j, t = JaxDDS(recs, 0, 1), DistributedDataSet(recs)
    for _ in range(3):
        assert list(j.shuffle().data()) == list(t.shuffle().data())
    assert list(j.shuffle(7).data()) == list(t.shuffle(7).data())
    assert (t.size(), t.local_size(), t.origin_rdd()) == (
        j.size(), j.local_size(), j.origin_rdd())


def test_accumulate_steps_matches_reference():
    jm, tm = _models(seed=2)
    jds, tds = _datasets(seed=5, batch=64)
    jo, to, (js, _, ts, _) = _train(jm, tm, jds, tds, wire="float32",
                                    accumulate_steps=2)
    jo.optimize()
    to.optimize()
    np.testing.assert_allclose(ts.values(), js.values(), rtol=1e-4)
    _check_weights(jm, tm)


def _failing(opt, at):
    """Make the optimizer's ``_shard_batch`` raise on call ``at`` (the
    reference test's injected executor failure); returns the counter."""
    original = opt._shard_batch
    count = {"n": 0}

    def failing(batch, *args):
        count["n"] += 1
        if count["n"] == at:
            raise RuntimeError("injected executor failure")
        return original(batch, *args)

    opt._shard_batch = failing
    return count


def test_retry_from_checkpoint_matches_reference(tmp_path):
    """One failure at the fifth batch: both reload the latest checkpoint
    (after iteration 3) and resume the run's counters from it; they end
    with the same weights and loss stream."""
    jm, tm = _models()
    jds, tds = _datasets()
    jo, to, (js, _, ts, _) = _train(jm, tm, jds, tds, epochs=4,
                                    wire="float32", ckpt=tmp_path)
    counts = [_failing(o, 5) for o in (jo, to)]
    jo.optimize()
    to.optimize()
    assert counts[0]["n"] == counts[1]["n"] > 5
    assert to.retries == 1
    assert ts.steps() == js.steps() and max(ts.steps()) > 5
    np.testing.assert_allclose(ts.values(), js.values(), rtol=1e-4)
    _check_weights(jm, tm)


def test_a_persistent_fault_raises_after_the_retry_budget(tmp_path):
    """A fault that survives the reload (a sticky CUDA error does) fails
    every rebuilt step and raises after ``failure_retry_times`` retries;
    each retry is logged."""
    _, tm = _models()
    _, tds = _datasets()
    to = DistriOptimizer(model=tm, dataset=tds,
                         criterion=tnn.ClassNLLCriterion(),
                         mesh=["cpu", "cpu"], failure_retry_times=2)
    to.set_end_when(topt.Trigger.max_epoch(3))
    to.set_checkpoint(str(tmp_path), topt.Trigger.several_iteration(1))
    build = to._build_step
    calls = {"steps": 0}

    def faulting_build():
        build()
        good = to._fn

        def fn(x, y):
            calls["steps"] += 1
            if calls["steps"] > 2:
                raise RuntimeError("CUDA error: an illegal memory access "
                                   "was encountered")
            return good(x, y)

        to._fn = fn

    to._build_step = faulting_build
    with pytest.raises(RuntimeError, match="illegal memory access"):
        to.optimize()
    assert to.retries == 2


def test_without_a_checkpoint_path_the_first_failure_raises():
    _, tm = _models()
    _, tds = _datasets()
    to = DistriOptimizer(model=tm, dataset=tds,
                         criterion=tnn.ClassNLLCriterion(),
                         mesh=["cpu", "cpu"])
    _failing(to, 2)
    with pytest.raises(RuntimeError, match="injected executor failure"):
        to.optimize()
    assert to.retries == 0


def test_sharded_checkpoint_flag_writes_shard_files(monkeypatch, tmp_path):
    _, tm = _models()
    _, tds = _datasets()
    to = DistriOptimizer(model=tm, dataset=tds,
                         criterion=tnn.ClassNLLCriterion(),
                         mesh=["cpu", "cpu"])
    to.set_end_when(topt.Trigger.max_iteration(4))
    to.set_checkpoint(str(tmp_path), topt.Trigger.several_iteration(2))
    monkeypatch.setenv("BIGDL_TPU_SHARDED_CHECKPOINT", "1")
    to.optimize()
    names = set(p.name for p in tmp_path.iterdir())
    assert {"shard.2.p0", "shard.4.p0", "model.4",
            "optimMethod.4"} <= names, names


def test_processes_wait_for_a10b():
    with pytest.raises(NotImplementedError, match=r"queue A.10\(b\)"):
        DistributedDataSet(list(range(8)), process_index=1, process_count=2)


def test_checkpoint_holds_the_float32_masters(tmp_path):
    """The checkpoint's weights are the float32 masters (not their
    bfloat16 wire copy) and its optimizer state the gathered slots."""
    _, tm = _models()
    _, tds = _datasets()
    to = DistriOptimizer(model=tm, dataset=tds,
                         criterion=tnn.ClassNLLCriterion(),
                         mesh=["cpu", "cpu"])
    to.set_optim_method(topt.SGD(learningrate=0.1, momentum=0.9))
    to.set_end_when(topt.Trigger.max_epoch(1))
    to.set_checkpoint(str(tmp_path), topt.Trigger.every_epoch())
    to.optimize()
    sd = load_module(str(tmp_path / "model.5"), device="cpu").state_dict()
    for k, v in tm.state_dict().items():
        assert torch.equal(sd[k], v)
    flat = to._step.state.full_master(torch.device("cpu"))
    assert not torch.equal(flat.to(torch.bfloat16).float(), flat)
    method, state = topt.OptimMethod.load(str(tmp_path / "optimMethod.5"))
    assert state["velocity"]["flat"].shape == (to._step.state.arp.padded_size,)
    assert int(state["step"]) == 4
