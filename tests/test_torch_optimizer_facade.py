"""The port's training facade (``bigdl_tpu_torch/optim/optimizer.py``
``Optimizer``/``LocalOptimizer``) against the JAX reference's, on the CPU,
through the reference's own API: ``Optimizer(model=, dataset=,
criterion=)``, the ``set_*`` builders, ``optimize()``, ``Evaluator``.

Both packages start from the same weights (the reference's, carried by
``convert``) and see the same batches: the reference's epoch shuffle is
unseeded (``LocalDataSet.shuffle()``), so each dataset here is a
``LocalDataSet`` subclass whose ``shuffle`` takes the next seed of one
fixed sequence. Per-iteration losses are read through an ``add_scalar``
summary, as a user reads them.

Bars: the first iteration's loss within 1e-5 relative (one forward in two
libraries' float32 orders); every later loss within 1e-4 relative and the
final weights within 1e-4 absolute, because SGD carries the last-bit
differences of XLA's and torch's CPU convolutions and reductions forward
from step to step; validation accuracies equal as counts, validation
losses within 1e-4 relative.
"""

import jax
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as jopt
from bigdl_tpu.dataset import dataset as jds
from bigdl_tpu.dataset.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset.mnist import mnist_dataset as jax_mnist_dataset
from bigdl_tpu.dataset.transformer import SampleToMiniBatch as JaxS2MB
from bigdl_tpu.models.lenet import LeNet5 as JaxLeNet5
from bigdl_tpu.models.resnet import ResNet as JaxResNet
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as topt
from bigdl_tpu_torch.dataset import dataset as tds
from bigdl_tpu_torch.dataset.dataset import DataSet
from bigdl_tpu_torch.dataset.mnist import mnist_dataset
from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch
from bigdl_tpu_torch.models import LeNet5, ResNet
from bigdl_tpu_torch.utils.serializer import load_module

FIRST_REL = 1e-5
LOSS_REL = 1e-4
WEIGHT_ABS = 1e-4
SEEDS = [11, 12, 13, 14, 15]


class Summary:
    """A TrainSummary stand-in: keeps every scalar by tag."""

    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, step):
        self.scalars.setdefault(tag, []).append((step, float(value)))

    def losses(self):
        return [v for _, v in self.scalars.get("Loss", [])]


def _pinned(ds, base):
    """``ds`` with its epoch shuffle pinned to SEEDS, in order."""
    seeds = iter(SEEDS)

    class Pinned(base):
        def shuffle(self, seed=None):
            return base.shuffle(self, next(seeds))

    ds.__class__ = Pinned
    return ds


def _lenet_pair(synthetic_size=384, batch_size=128, reg=True):
    jm = JaxLeNet5(10).build(1, (batch_size, 1, 28, 28))
    tm = LeNet5(10, device="cpu")
    tm.load_state_dict(convert.module_params_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, jm.params)))
    if reg:
        jm.modules[1].w_regularizer = jopt.L2Regularizer(1e-4)
        tm[1].w_regularizer = topt.L2Regularizer(1e-4)
    kw = dict(training=True, batch_size=batch_size,
              synthetic_size=synthetic_size)
    return (jm, _pinned(jax_mnist_dataset(**kw), jds.LocalDataSet),
            tm, _pinned(mnist_dataset(**kw), tds.LocalDataSet))


def _val(mod, size=200):
    return mod(training=False, batch_size=128, synthetic_size=size)


def _setup(pkg, opt, val_ds=None, method=None, epochs=2, ckpt=None):
    opt.set_optim_method(method or pkg.SGD(learningrate=0.05))
    opt.set_end_when(pkg.Trigger.max_epoch(epochs))
    if val_ds is not None:
        opt.set_validation(pkg.Trigger.every_epoch(), val_ds,
                           [pkg.Top1Accuracy(), pkg.Loss()])
    if ckpt is not None:
        opt.set_checkpoint(str(ckpt), pkg.Trigger.every_epoch())
    s, vs = Summary(), Summary()
    opt.set_train_summary(s)
    opt.set_validation_summary(vs)
    return s, vs


def _close_losses(got, want):
    assert len(got) == len(want) > 0
    assert abs(got[0] - want[0]) <= FIRST_REL * abs(want[0])
    np.testing.assert_allclose(got, want, rtol=LOSS_REL)


def _close_weights(tm, jm):
    got, _ = convert.module_params_to_jax(tm)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                        np.asarray, jm.params))):
        np.testing.assert_allclose(g, w, rtol=0, atol=WEIGHT_ABS)


def test_lenet_example_setters_match_reference(tmp_path):
    """``examples/lenet_mnist.py``'s setters (SGD 0.05, validation every
    epoch with Top1Accuracy and Loss, a checkpoint every epoch), with an
    L2Regularizer on conv1_5x5, for two epochs of three iterations."""
    jm, jds_, tm, tds_ = _lenet_pair()
    jopt_ = jopt.Optimizer(model=jm, dataset=jds_,
                           criterion=jnn.ClassNLLCriterion())
    topt_ = topt.Optimizer(model=tm, dataset=tds_,
                           criterion=tnn.ClassNLLCriterion())
    assert type(topt_) is topt.LocalOptimizer
    js, jvs = _setup(jopt, jopt_, _val(jax_mnist_dataset),
                     ckpt=tmp_path / "jax")
    ts, tvs = _setup(topt, topt_, _val(mnist_dataset),
                     ckpt=tmp_path / "port")
    jopt_.optimize()
    trained = topt_.optimize()
    assert trained is tm
    _close_losses(ts.losses(), js.losses())
    assert [s for s, _ in ts.scalars["Loss"]] == list(range(1, 7))
    _close_weights(tm, jm)
    for tag in ("Top1Accuracy", "Loss"):
        got = [v for _, v in tvs.scalars[tag]]
        want = [v for _, v in jvs.scalars[tag]]
        assert [s for s, _ in tvs.scalars[tag]] == [4, 7]
        if tag == "Loss":
            np.testing.assert_allclose(got, want, rtol=LOSS_REL)
        else:
            assert [round(v * 200) for v in got] == \
                [round(v * 200) for v in want]
    m = topt_.metrics
    assert m["steps"] == m["dispatches"] == 6 and m["records"] == 768
    assert set(topt_.metrics_summary()) == set(jopt_.metrics_summary())
    # the files, and their reload into a fresh model and method
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir()) \
        == ["model.4", "model.7", "optimMethod.4", "optimMethod.7"]
    fresh = LeNet5(10, device="cpu", seed=9)
    fresh.load_state_dict(load_module(str(tmp_path / "port" / "model.7"),
                                      device="cpu").state_dict())
    for (k, a), b in zip(tm.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), k
    method, state = topt.OptimMethod.load(str(tmp_path / "port" /
                                              "optimMethod.7"))
    assert type(method) is topt.SGD and method.learningrate == 0.05
    assert int(state["step"]) == 6 and int(state["epoch"]) == 2
    res = topt.Evaluator(trained).evaluate(_val(mnist_dataset),
                                           [topt.Top1Accuracy()])
    assert res["Top1Accuracy"].result()[1] == 200


CASES = {
    "clip_l2": (lambda p, o: o.set_gradient_clipping_by_l2_norm(0.5),
                lambda p: p.SGD(learningrate=0.05)),
    "clip_value": (lambda p, o: o.set_constant_gradient_clipping(-0.01,
                                                                 0.01),
                   lambda p: p.SGD(learningrate=0.05)),
    "accumulate_2": (None, lambda p: p.SGD(learningrate=0.05,
                                           momentum=0.9)),
    "epoch_step_adam": (None, lambda p: p.Adam(
        learningrate=2e-3, learningrate_schedule=p.EpochStep(1, 0.5))),
    "plateau": (None, lambda p: p.SGD(
        learningrate=0.05, learningrate_schedule=p.Plateau(
            mode="max", patience=1, factor=0.5))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_facade_options_match_reference(case):
    setter, method = CASES[case]
    kw = {"accumulate_steps": 2} if case == "accumulate_2" else {}
    jm, jds_, tm, tds_ = _lenet_pair(synthetic_size=256, reg=False)
    jopt_ = jopt.Optimizer(model=jm, dataset=jds_,
                           criterion=jnn.ClassNLLCriterion(), **kw)
    topt_ = topt.Optimizer(model=tm, dataset=tds_,
                           criterion=tnn.ClassNLLCriterion(), **kw)
    val = case == "plateau"
    js, _ = _setup(jopt, jopt_, _val(jax_mnist_dataset) if val else None,
                   method(jopt), epochs=3)
    ts, _ = _setup(topt, topt_, _val(mnist_dataset) if val else None,
                   method(topt), epochs=3)
    if setter is not None:
        setter(jopt, jopt_)
        setter(topt, topt_)
    jopt_.optimize()
    topt_.optimize()
    _close_losses(ts.losses(), js.losses())
    _close_weights(tm, jm)
    tstate, jstate = topt_._opt_state, jopt_._opt_state
    assert int(tstate["epoch"]) == int(jstate["epoch"]) == 4
    if case == "plateau":
        assert float(tstate["plateau_mult"]) == \
            float(jstate["plateau_mult"])


def test_steps_per_loop_two_is_bit_identical_to_one_on_the_cpu():
    runs = []
    for k in (1, 2):
        _, _, tm, tds_ = _lenet_pair(synthetic_size=640)
        o = topt.Optimizer(model=tm, dataset=tds_,
                           criterion=tnn.ClassNLLCriterion(),
                           steps_per_loop=k)
        s, _ = _setup(topt, o, method=topt.Adam(learningrate=2e-3))
        o.optimize()
        runs.append((s.losses(), tm.state_dict(), dict(o.metrics)))
    (l1, w1, m1), (l2, w2, m2) = runs
    assert l1 == l2 and len(l1) == 10
    for k in w1:
        assert torch.equal(w1[k], w2[k]), k
    # 5 steps an epoch: two 2-step loops and the epoch's 1-step tail
    assert m1["dispatches"] == m1["steps"] == m2["steps"] == 10
    assert m2["dispatches"] == 6


def test_steps_per_loop_stops_at_a_trigger_inside_a_loop(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_STEPS_PER_LOOP", "4")
    _, _, tm, tds_ = _lenet_pair(synthetic_size=1024)
    o = topt.Optimizer(model=tm, dataset=tds_,
                       criterion=tnn.ClassNLLCriterion())
    assert o.steps_per_loop == 4
    s, _ = _setup(topt, o)
    o.set_end_when(topt.Trigger.max_iteration(6))
    o.optimize()
    assert len(s.losses()) == o.metrics["steps"] == 6
    assert o.metrics["dispatches"] == 2          # a loop of 4, then of 2


def _cifar(mod, s2mb, n=12, hw=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, hw, hw, 3)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    return mod.sample_arrays(x, y).transform(s2mb(4))


def test_cifar_resnet8_trains_through_the_facade_like_reference():
    """The 3x3 stride-1 convolutions take the conv kernels' plain versions
    on the CPU (``ops.conv3x3``)."""
    cfg = dict(class_num=10, depth=8, data_set="CIFAR-10", format="NHWC")
    jm = JaxResNet(**cfg)
    params, state = jm.setup(jax.random.PRNGKey(0), jax.ShapeDtypeStruct(
        (4, 16, 16, 3), np.float32))
    jm.params, jm.state = params, state
    by_name = {n.module.name: (jax.tree_util.tree_map(np.asarray,
                                                      params[str(n.id)]),
                               jax.tree_util.tree_map(np.asarray,
                                                      state[str(n.id)]))
               for n in jm.exec_order}
    tm = ResNet(device="cpu", **cfg)
    tm.load_state_dict(convert.resnet_params_from_jax(
        {k: p for k, (p, _) in by_name.items() if p},
        {k: s for k, s in ((k, s) for k, (_, s) in by_name.items()) if s}))
    jds_ = _pinned(_cifar(JaxDataSet, JaxS2MB), jds.LocalDataSet)
    tds_ = _pinned(_cifar(DataSet, SampleToMiniBatch), tds.LocalDataSet)
    jopt_ = jopt.Optimizer(model=jm, dataset=jds_,
                           criterion=jnn.ClassNLLCriterion())
    topt_ = topt.Optimizer(model=tm, dataset=tds_,
                           criterion=tnn.ClassNLLCriterion())
    method = {p: p.SGD(learningrate=0.05, momentum=0.9,
                       learningrate_schedule=p.MultiStep([2, 4], 0.5))
              for p in (jopt, topt)}
    js, _ = _setup(jopt, jopt_, method=method[jopt])
    ts, _ = _setup(topt, topt_, method=method[topt])
    # the counter is process-wide: this run's calls are its growth
    before = dict(tnn.SpatialConvolution.library_calls)
    jopt_.optimize()
    topt_.optimize()
    _close_losses(ts.losses(), js.losses())
    assert len(ts.losses()) == 6
    # only the two stride-2 3x3s and the two 1x1 projections of each
    # forward reach F.conv2d
    calls = tnn.SpatialConvolution.library_calls
    assert calls.get("3x3/s1", 0) == before.get("3x3/s1", 0)
    assert sum(calls.values()) - sum(before.values()) == 4 * 6


def test_float64_samples_train_validate_and_predict_like_reference():
    """Datasets built from float64 arrays: the reference's ``jnp.asarray``
    makes them float32, in training and in evaluation alike, and so must
    the port (a padded tail of 2 rows in each validation pass)."""
    jm = jnn.Sequential().add(jnn.Linear(6, 4)).add(jnn.LogSoftMax())
    jm.build(3, (4, 6))
    tm = tnn.Sequential().add(tnn.Linear(6, 4, device="cpu")) \
        .add(tnn.LogSoftMax())
    tm.load_state_dict(convert.module_params_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, jm.params)))
    rng = np.random.default_rng(5)
    x, y = rng.standard_normal((10, 6)), rng.integers(0, 4, 10)
    assert x.dtype == np.float64

    def data(mod, s2mb):
        return mod.sample_arrays(x, y.astype(np.int32)).transform(s2mb(4))

    jopt_ = jopt.Optimizer(model=jm, dataset=_pinned(data(JaxDataSet, JaxS2MB),
                                                     jds.LocalDataSet),
                           criterion=jnn.ClassNLLCriterion())
    topt_ = topt.Optimizer(model=tm, dataset=_pinned(
        data(DataSet, SampleToMiniBatch), tds.LocalDataSet),
        criterion=tnn.ClassNLLCriterion())
    js, jvs = _setup(jopt, jopt_, data(JaxDataSet, JaxS2MB))
    ts, tvs = _setup(topt, topt_, data(DataSet, SampleToMiniBatch))
    jopt_.optimize()
    topt_.optimize()
    _close_losses(ts.losses(), js.losses())
    for tag in ("Top1Accuracy", "Loss"):
        np.testing.assert_allclose([v for _, v in tvs.scalars[tag]],
                                   [v for _, v in jvs.scalars[tag]],
                                   rtol=LOSS_REL)
    methods = ["Top1Accuracy", "Loss"]
    got = topt.Evaluator(tm).evaluate(data(DataSet, SampleToMiniBatch),
                                      [getattr(topt, m)() for m in methods])
    want = jopt.Evaluator(jm).evaluate(data(JaxDataSet, JaxS2MB),
                                       [getattr(jopt, m)() for m in methods])
    for m in methods:
        (gv, gc), (wv, wc) = got[m].result(), want[m].result()
        assert gc == wc == 10
        np.testing.assert_allclose(gv, wv, rtol=LOSS_REL)
    preds = topt.Predictor(tm).predict(data(DataSet, SampleToMiniBatch))
    assert preds.shape == (10, 4) and preds.dtype == np.float32
    np.testing.assert_allclose(preds, np.asarray(jopt.Predictor(jm).predict(
        data(JaxDataSet, JaxS2MB))), rtol=0, atol=WEIGHT_ABS)


def test_mesh_and_distributed_datasets_are_refused():
    """ROADMAP queue A.10 is ported, so neither is refused any more: the
    factory gives the ``DistriOptimizer`` for ``mesh=`` and for a
    distributed dataset (its own tests: ``test_torch_distri_*.py``); a
    dataset over more than one process is refused, naming A.10(b)."""
    from bigdl_tpu_torch.parallel import DistriOptimizer
    tm = LeNet5(10, device="cpu")
    crit = tnn.ClassNLLCriterion()
    o = topt.Optimizer(model=tm, dataset=None, criterion=crit,
                       mesh=["cpu", "cpu"])
    assert type(o) is DistriOptimizer and o.mesh == ["cpu", "cpu"]
    dds = mnist_dataset(distributed=True, synthetic_size=8)
    made = topt.Optimizer.__new__(topt.Optimizer, model=tm, dataset=dds,
                                  criterion=crit)
    assert type(made) is DistriOptimizer
    with pytest.raises(NotImplementedError, match=r"queue A.10\(b\)"):
        tds.DistributedDataSet([1, 2], process_count=2)


@pytest.mark.parametrize("kw", [dict(accumulate_steps=0),
                                dict(accumulate_steps=1.5),
                                dict(steps_per_loop=0)])
def test_bad_step_counts_raise(kw):
    with pytest.raises(ValueError, match="positive integer"):
        topt.Optimizer(model=LeNet5(10, device="cpu"), dataset=None,
                       criterion=tnn.ClassNLLCriterion(), **kw)


def test_accumulate_steps_must_divide_the_batch():
    _, _, tm, _ = _lenet_pair(reg=False)
    ds = mnist_dataset(training=True, batch_size=5, synthetic_size=10)
    o = topt.Optimizer(model=tm, dataset=ds,
                       criterion=tnn.ClassNLLCriterion(), accumulate_steps=2)
    with pytest.raises(ValueError, match="must divide the batch rows"):
        o.optimize()


def test_async_checkpoint_surfaces_a_writer_error(tmp_path, monkeypatch):
    _, _, tm, tds_ = _lenet_pair(synthetic_size=256, reg=False)
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    o = topt.Optimizer(model=tm, dataset=tds_,
                       criterion=tnn.ClassNLLCriterion())
    _setup(topt, o, ckpt=blocker / "ckpt")
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        o.optimize()
    monkeypatch.setenv("BIGDL_TPU_ASYNC_CHECKPOINT", "0")
    _, _, tm, tds_ = _lenet_pair(synthetic_size=256, reg=False)
    o = topt.Optimizer(model=tm, dataset=tds_,
                       criterion=tnn.ClassNLLCriterion())
    _setup(topt, o, ckpt=tmp_path / "sync", epochs=1)
    o.optimize()
    assert sorted(p.name for p in (tmp_path / "sync").iterdir()) == \
        ["model.3", "optimMethod.3"]


def test_fileio_writes_whole_files_and_refuses_urls(tmp_path):
    """Local files appear whole or not at all; a URL scheme no filesystem
    serves is refused (``utils/fileio.py``; a registered one is held in
    ``test_torch_serializer.py``)."""
    from bigdl_tpu_torch.utils import fileio
    target = fileio.path_join(str(tmp_path / "a" / "b"), "f.bin")
    fileio.file_makedirs(str(tmp_path / "a" / "b"))
    fileio.atomic_write(target, b"abc")
    fileio.atomic_file_swap(target + "2",
                            lambda p: open(p, "wb").write(b"xyz"))
    assert fileio.file_exists(target) and fileio.file_exists(target + "2")
    with fileio.file_open(target + "2") as f:
        assert f.read() == b"xyz"
    assert sorted(p.name for p in (tmp_path / "a" / "b").iterdir()) == \
        ["f.bin", "f.bin2"]

    def broken(p):
        open(p, "wb").write(b"half")
        raise OSError("disk full")

    with pytest.raises(OSError, match="disk full"):
        fileio.atomic_file_swap(target, broken)
    with fileio.file_open(target) as f:
        assert f.read() == b"abc"          # the old file is untouched
    with pytest.raises(ValueError, match="bigdl-none"):
        fileio.file_open("bigdl-none://bucket/model.1")
