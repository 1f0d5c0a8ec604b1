"""The port's training preemption and training fault sites
(``bigdl_tpu_torch/resilience/preempt.py``, the ``Optimizer`` loops and
``parallel/allreduce.py``) against the reference's, on the CPU.

The model and data are the reference's ``tests/test_resilience.py`` ones:
an MLP (4 -> 16 -> 3) on 128 seeded 4-feature records in batches of 32,
the port's weights carried from the reference's by ``convert``. The local
loops pin their epoch shuffle to one seed sequence (the reference's
``LocalDataSet.shuffle`` is unseeded); the distributed ones shuffle from
the epoch count in both packages. The reference runs on 2 of the 8
virtual CPU devices, the port at ``mesh=["cpu"] * 2``.

- the guard: ``install`` replaces the SIGTERM handler and ``uninstall``
  puts it back; a real SIGTERM flips it with the reference's reason; off
  the main thread ``install`` does nothing; ``BIGDL_TPU_PREEMPT_GUARD=0``
  installs nothing;
- local preemption (``train.step:preempt``): the reference's
  ``TrainingPreempted.neval``, the final checkpoint's files and step
  count, the losses before it; resumed from that checkpoint, the later
  losses within 1e-5 relative of the reference's uninterrupted run;
- distributed preemption pierces the retry loop, with the reference's
  ``neval`` and ``driverState``; a run resumed through the retry path
  gives the reference's resumed losses;
- ``allreduce.sync`` and ``train.step`` errors are retried once from the
  checkpoint, as in the reference; ``ckpt.write:corrupt`` empties a file;
  a ``train.drain`` delay counts a sync timeout;
- the ``bigdl_train_*`` and ``bigdl_allreduce_bytes_total`` families
  (help, type, labels) and their increments, and the ``train/*`` span
  names and counts, are the reference's.
"""

import os
import signal
import threading

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as jopt
from bigdl_tpu import obs as jobs
from bigdl_tpu.dataset import dataset as jds
from bigdl_tpu.dataset.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset.sample import Sample as JaxSample
from bigdl_tpu.dataset.transformer import SampleToMiniBatch as JaxS2MB
from bigdl_tpu.resilience import faults as jfaults
from bigdl_tpu.resilience import preempt as jpreempt
from bigdl_tpu.resilience.preempt import \
    TrainingPreempted as JaxTrainingPreempted
from bigdl_tpu_torch import convert, obs
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as topt
from bigdl_tpu_torch.dataset import dataset as tds
from bigdl_tpu_torch.dataset.dataset import DataSet
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch
from bigdl_tpu_torch.optim.methods import OptimMethod
from bigdl_tpu_torch.resilience import TrainingPreempted, faults, preempt
from bigdl_tpu_torch.utils.serializer import load_module

SEEDS = [21, 22, 23, 24]
RESUME_REL = 1e-5
LOSS_REL = 1e-5


def _reset_harness(handler):
    """Both packages' plans off and guards clear and uninstalled, then
    ``handler`` back as the process's SIGTERM handler."""
    for f, p in ((faults, preempt), (jfaults, jpreempt)):
        f.configure(None)
        p.clear()
        p.uninstall()
    signal.signal(signal.SIGTERM, handler)


@pytest.fixture(autouse=True)
def _clean_harness():
    # an earlier test file's ``optimize()`` may have left either guard
    # installed in this process: start each test with neither
    orig = signal.getsignal(signal.SIGTERM)
    _reset_harness(orig)
    yield
    _reset_harness(orig)


@pytest.fixture(scope="module")
def pair():
    """The reference's MLP weights and the 2-device reference mesh."""
    jm = _build(jnn).build(0, (2, 4))
    return (jax.tree_util.tree_map(np.asarray, jm.params),
            Mesh(np.asarray(jax.devices()[:2]), axis_names=("data",)))


class Summary:
    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, step):
        self.scalars.setdefault(tag, []).append((step, float(value)))

    def losses(self):
        return [v for _, v in self.scalars.get("Loss", [])]

    def steps(self):
        return [s for s, _ in self.scalars.get("Loss", [])]


def _build(pkg, **kw):
    return (pkg.Sequential().add(pkg.Linear(4, 16, **kw)).add(pkg.ReLU())
            .add(pkg.Linear(16, 3, **kw)).add(pkg.LogSoftMax()))


def _models(params):
    jm = _build(jnn).build(0, (2, 4))
    jm.params = jax.tree_util.tree_map(np.array, params)
    tm = _build(tnn, device="cpu")
    tm.load_state_dict(convert.module_params_from_jax(tm, params))
    return jm, tm


def _pinned(ds, base):
    seeds = iter(SEEDS)

    class Pinned(base):
        def shuffle(self, seed=None):
            return base.shuffle(self, next(seeds))

    ds.__class__ = Pinned
    return ds


def _records(n=128, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    y = (np.abs(x).argmax(axis=1) % 3).astype(np.int32)
    return x, y


def _datasets(distributed=False):
    x, y = _records()
    j = JaxDataSet.array([JaxSample(x[i], y[i]) for i in range(len(x))],
                         distributed=distributed) >> JaxS2MB(32)
    t = DataSet.array([Sample(x[i], y[i]) for i in range(len(x))],
                      distributed=distributed) >> SampleToMiniBatch(32)
    if not distributed:
        j, t = _pinned(j, jds.LocalDataSet), _pinned(t, tds.LocalDataSet)
    return j, t


def _optimizer(pkg, model, ds, ckpt=None, ckpt_every=1000, epochs=2,
               mesh=None, summary=None):
    kw = {} if mesh is None else {"mesh": mesh}
    crit = (jnn if pkg is jopt else tnn).ClassNLLCriterion()
    opt = pkg.Optimizer(model=model, dataset=ds, criterion=crit, **kw)
    opt.set_optim_method(pkg.SGD(learningrate=0.1))
    opt.set_end_when(pkg.Trigger.max_epoch(epochs))
    if ckpt is not None:
        opt.set_checkpoint(str(ckpt), pkg.Trigger.several_iteration(
            ckpt_every))
    if summary is not None:
        opt.set_train_summary(summary)
    return opt


def _both(pair, tmp_path, distributed=False, **kw):
    """(reference optimizer, summary), (port optimizer, summary) over the
    same weights and data."""
    jm, tm = _models(pair[0])
    jd, td = _datasets(distributed)
    out = []
    for pkg, m, d, mesh in ((jopt, jm, jd, pair[1]),
                            (topt, tm, td, ["cpu", "cpu"])):
        s = Summary()
        ckpt = (None if tmp_path is None
                else tmp_path / ("ref" if pkg is jopt else "port"))
        out.append((_optimizer(pkg, m, d, ckpt=ckpt, summary=s,
                               mesh=mesh if distributed else None, **kw),
                    s))
    return out


# -------------------------------------------------------------- the guard
def test_guard_installs_flips_on_sigterm_and_restores_the_handler():
    prev = signal.getsignal(signal.SIGTERM)
    try:
        assert preempt.install() is True
        assert signal.getsignal(signal.SIGTERM) is not prev
        assert preempt.install() is True                 # idempotent
        os.kill(os.getpid(), signal.SIGTERM)
        assert preempt.requested() and preempt.reason() == "SIGTERM"
        jpreempt.install()
        os.kill(os.getpid(), signal.SIGTERM)
        assert jpreempt.reason() == preempt.reason()
        jpreempt.uninstall()
        preempt.uninstall()
        assert signal.getsignal(signal.SIGTERM) is prev
        preempt.clear()
        assert not preempt.requested() and preempt.reason() is None
        got = []
        t = threading.Thread(target=lambda: got.append(preempt.install()))
        t.start()
        t.join()
        assert got == [False]
        assert signal.getsignal(signal.SIGTERM) is prev
    finally:
        preempt.uninstall()
        jpreempt.uninstall()
        signal.signal(signal.SIGTERM, prev)


def test_guard_flag_off_installs_nothing(pair, monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_PREEMPT_GUARD", "0")
    _, tm = _models(pair[0])
    prev = signal.getsignal(signal.SIGTERM)
    _optimizer(topt, tm, _datasets()[1], epochs=1).optimize()
    assert signal.getsignal(signal.SIGTERM) is prev


def test_preempt_kind_with_signal_sends_sigterm():
    prev = signal.getsignal(signal.SIGTERM)
    try:
        assert preempt.install() is True     # unguarded, SIGTERM ends us
        faults.configure("train.step:preempt:signal=1:times=1")
        faults.fault_point("train.step")
        # the harness flipped the guard, then the real signal renamed it
        assert preempt.requested() and preempt.reason() == "SIGTERM"
    finally:
        preempt.uninstall()
        signal.signal(signal.SIGTERM, prev)


# ---------------------------------------------------------- local loops
def test_local_preemption_checkpoints_and_resumes_like_the_reference(
        pair, tmp_path):
    (jo, js), (to, ts) = _both(pair, tmp_path)
    # the reference's uninterrupted run: the yardstick of the resume
    jm_u, _ = _models(pair[0])
    ju = Summary()
    _optimizer(jopt, jm_u, _datasets()[0], summary=ju).optimize()
    errors = []
    for f, o, err in ((jfaults, jo, JaxTrainingPreempted),
                      (faults, to, TrainingPreempted)):
        f.configure("train.step:preempt:after=3:times=1")
        with pytest.raises(err) as ei:
            o.optimize()
        errors.append(ei.value)
    assert errors[1].neval == errors[0].neval == 5
    assert "injected at train.step" in str(errors[1])
    n = errors[1].neval
    files = set(os.listdir(tmp_path / "port"))
    assert {f"model.{n}", f"optimMethod.{n}"} <= files
    assert set(os.listdir(tmp_path / "ref")) == files
    np.testing.assert_allclose(ts.losses(), js.losses(), rtol=LOSS_REL)
    assert ts.steps() == js.steps() == [1, 2, 3, 4]
    # the final checkpoint holds the weights after n - 1 steps
    method, state = OptimMethod.load(str(tmp_path / "port"
                                         / f"optimMethod.{n}"))
    assert int(state["step"]) == n - 1
    # resume: a fresh model from the checkpoint, the same dataset object
    # (its pinned shuffle goes on to the next epoch's seed)
    import torch
    preempt.clear()
    faults.configure(None)
    tm2 = _build(tnn, device="cpu")
    tm2.load_state_dict(load_module(str(tmp_path / "port" / f"model.{n}"),
                                    device="cpu").state_dict())
    rs = Summary()
    resumed = _optimizer(topt, tm2, to.dataset, epochs=1, summary=rs)
    resumed.set_optim_method(method)
    resumed.optimize()
    np.testing.assert_allclose(rs.losses(), ju.losses()[n - 1:],
                               rtol=RESUME_REL)
    assert len(rs.losses()) == 4


def test_ckpt_write_corrupt_empties_a_file_like_the_reference(pair,
                                                             tmp_path):
    sizes = []
    for (o, _), f in zip(_both(pair, tmp_path, ckpt_every=2),
                         (jfaults, faults)):
        f.configure("ckpt.write:corrupt=empty:times=1")
        o.optimize()
        o._join_checkpoint()
        assert f.active_plan().counts() == {("ckpt.write", "corrupt"): 1}
        path = o.checkpoint_path
        sizes.append(sorted(os.path.getsize(os.path.join(path, n))
                            for n in os.listdir(path)
                            if n.startswith("model.")))
    for s in sizes:
        assert len(s) == 4 and s[0] == 0 and s[-1] > 0


def test_ckpt_write_error_surfaces_at_the_next_join(pair, tmp_path):
    for (o, _), f in zip(_both(pair, tmp_path, ckpt_every=2),
                         (jfaults, faults)):
        f.configure("ckpt.write:error:times=1")
        with pytest.raises(RuntimeError, match="async checkpoint write "
                                               "failed"):
            o.optimize()


def test_sync_timeout_counts_a_slow_drain(pair, monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_SYNC_TIMEOUT_S", "0.01")
    child = obs.counter(
        "bigdl_sync_timeouts_total",
        "blocking loss-readback syncs over BIGDL_TPU_SYNC_TIMEOUT_S",
        ("loop",)).labels("local")
    before = child.value
    faults.configure("train.drain:delay=0.05:times=2")
    _, tm = _models(pair[0])
    _optimizer(topt, tm, _datasets()[1], epochs=1).optimize()
    assert child.value - before == 2


# ---------------------------------------------------------- distri loops
def test_distri_preemption_pierces_the_retry_and_resumes(pair, tmp_path):
    (jo, js), (to, ts) = _both(pair, tmp_path, distributed=True, epochs=3)
    errors = []
    for f, o, err in ((jfaults, jo, JaxTrainingPreempted),
                      (faults, to, TrainingPreempted)):
        f.configure("train.step:preempt:after=3:times=1")
        with pytest.raises(err) as ei:
            o.optimize()
        errors.append(ei.value)
    n = errors[1].neval
    assert n == errors[0].neval and to.retries == 0
    for o in (jo, to):
        files = os.listdir(o.checkpoint_path)
        assert {f"model.{n}", f"optimMethod.{n}",
                f"driverState.{n}"} <= set(files)
    np.testing.assert_allclose(ts.losses(), js.losses(), rtol=LOSS_REL)
    # both resume through the retry path: a first-step error reloads the
    # preemption checkpoint and the run completes
    resumed = []
    for pkg, f, p, o, mesh in ((jopt, jfaults, jpreempt, jo, pair[1]),
                               (topt, faults, preempt, to,
                                ["cpu", "cpu"])):
        p.clear()
        f.configure("train.step:error:times=1")
        m = _models(pair[0])[0 if pkg is jopt else 1]
        ds = _datasets(distributed=True)[0 if pkg is jopt else 1]
        s = Summary()
        o2 = _optimizer(pkg, m, ds, ckpt=o.checkpoint_path, epochs=3,
                        mesh=mesh, summary=s)
        o2.optimize()
        resumed.append(s)
    assert resumed[1].steps() == resumed[0].steps()
    assert resumed[1].steps()[0] == n
    np.testing.assert_allclose(resumed[1].losses(), resumed[0].losses(),
                               rtol=RESUME_REL)


@pytest.mark.parametrize("site", ["allreduce.sync", "train.step"])
def test_distri_error_is_retried_once_from_the_checkpoint(pair, tmp_path,
                                                         site):
    runs = _both(pair, tmp_path, distributed=True, ckpt_every=2, epochs=3)
    for (o, _), f in zip(runs, (jfaults, faults)):
        f.configure(f"{site}:error:after=4:times=1")
        o.optimize()
        assert f.active_plan().counts() == {(site, "error"): 1}
    assert runs[1][0].retries == 1
    np.testing.assert_allclose(runs[1][1].losses(), runs[0][1].losses(),
                               rtol=LOSS_REL)
    assert runs[1][1].steps() == runs[0][1].steps()


# ------------------------------------------------- families and spans
def _families(snap, prefix):
    return {name: (fam["help"], fam["type"],
                   sorted({k for s in fam["series"] for k in s["labels"]}))
            for name, fam in snap.items() if name.startswith(prefix)}


def _values(snap, prefix, **labels):
    out = {}
    for name, fam in snap.items():
        if not name.startswith(prefix):
            continue
        for s in fam["series"]:
            if all(s["labels"].get(k) == v for k, v in labels.items()):
                out[name] = s.get("value", s.get("count"))
    return out


@pytest.mark.parametrize("loop", ["local", "distri"])
def test_train_families_increments_and_spans_match_the_reference(
        pair, tmp_path, loop):
    regs = (jobs.default_registry(), obs.default_registry())
    tracers = (jobs.default_tracer(), obs.default_tracer())
    runs = _both(pair, tmp_path, distributed=loop == "distri",
                 ckpt_every=3)
    deltas, names = [], []
    for (o, _), reg, tr, pkg in zip(runs, regs, tracers, (jopt, topt)):
        o.set_validation(pkg.Trigger.every_epoch(), o.dataset,
                         [pkg.Top1Accuracy()])
        tr.clear()
        before = reg.snapshot()
        o.optimize()
        after = reg.snapshot()
        spans = [s.name for s in tr.spans()]
        names.append({n: spans.count(n) for n in set(spans)
                      if n.startswith("train/")})
        d = {}
        for prefix, lab in (("bigdl_train_", {"loop": loop}),
                            ("bigdl_allreduce_bytes_total", {})):
            a, b = _values(after, prefix, **lab), _values(before, prefix,
                                                          **lab)
            d.update({k: v - (b.get(k) or 0) for k, v in a.items()
                      if k.endswith("_total")})
        deltas.append(d)
        if pkg is topt:
            assert _families(after, "bigdl_train_") == \
                _families(regs[0].snapshot(), "bigdl_train_")
            assert _families(after, "bigdl_allreduce_bytes") == \
                _families(regs[0].snapshot(), "bigdl_allreduce_bytes")
    assert deltas[1] == deltas[0]
    assert deltas[1]["bigdl_train_steps_total"] == 8
    assert deltas[1]["bigdl_train_dispatches_total"] == 8
    assert deltas[1]["bigdl_train_records_total"] == 256
    assert (deltas[1].get("bigdl_allreduce_bytes_total", 0) > 0) == \
        (loop == "distri")
    assert names[1] == names[0]
    assert names[1]["train/dispatch"] == names[1]["train/feed"] == 8
    assert names[1]["train/drain"] == 8
    assert names[1]["train/validate"] == 2
    # every third iteration (3, 6, 9) and again at the end of epoch 2 (9)
    assert names[1]["train/checkpoint"] == 4
