"""``TFTrainingSession`` of the port (``bigdl_tpu_torch/interop/
tf_session.py``) against the JAX reference's (``bigdl_tpu/interop/
tf_session.py``), on the CPU, on the graphs ``chip_smoke.py``'s ``load_tf``
phase imports, cut to two layers: Google BERT's classifier fine-tuning
graph (``bert_tf_graph``) and TF-slim's ``vgg_16`` (``vgg16_tf_graph``)
with two convolutions, each written as a GraphDef and an
``export_tf_checkpoint.py``-style ``.npy`` directory in the test.

Both packages load the same files: forward outputs agree within 1e-5 of
their largest magnitude, and one ``Adam`` step through each package's
session leaves every imported weight within 1e-5 of its largest magnitude
of the other's (the batch is the whole dataset, so the reference's
unseeded epoch shuffle only reorders it). Also: a session built without
``sample_input`` applies the imported weights before training (the
reference's ``test_session_without_sample_input_applies_weights``), the
imported mini-BERT of ``TestMiniBERT`` trains, and ``mesh=`` trains on the
port's ``DistriOptimizer`` to the weights of the reference's. A weight
whose gradient is zero analytically moves by rounding alone and is held to
1e-7 of the graph's largest weight (``_check_weights``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.dataset import SampleToMiniBatch as JToBatch
from bigdl_tpu.interop.tf_session import TFTrainingSession as JSession
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Adam as JAdam
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.interop.tf_session import TFTrainingSession
from bigdl_tpu_torch.optim import SGD, Adam, Trigger
from test_torch_tf_loader import _close, _np, _param_pairs

REL = 1e-5


@pytest.fixture(autouse=True)
def _keep_library_calls():
    """Leave ``SpatialConvolution.library_calls``, a process-wide counter
    that other test files read, as each test found it."""
    saved = tnn.SpatialConvolution.library_calls.copy()
    yield
    tnn.SpatialConvolution.library_calls.clear()
    tnn.SpatialConvolution.library_calls.update(saved)


def _jds(x, y, batch):
    return JDataSet.array([JSample.from_ndarray(f, l)
                           for f, l in zip(x, y)]) >> JToBatch(batch)


def _tds(x, y, batch):
    return DataSet.array([Sample.from_ndarray(f, l)
                          for f, l in zip(x, y)]) >> SampleToMiniBatch(batch)


def _write(tmp_path, nodes, var):
    pb = str(tmp_path / "g.pb")
    with open(pb, "wb") as f:
        f.write(cs.tf_graphdef(nodes))
    cs.write_npy_dir(str(tmp_path), var)
    return pb


def _sessions(pb, inputs, outputs, root, sample):
    js = JSession(pb, inputs, outputs, bin_dir=root,
                  sample_input=jnp.asarray(sample))
    ts = TFTrainingSession(pb, inputs, outputs, bin_dir=root,
                           sample_input=sample, device="cpu")
    return js, ts


def _check_weights(ts, js, after_step=False):
    """Every imported weight of the port's session against the
    reference's. After an Adam step a weight whose gradient is zero
    analytically (a key bias under softmax's shift invariance) has moved
    by Adam's normalised rounding in each package: it is held to 1e-7 of
    the graph's largest weight."""
    from bigdl_tpu_torch import convert
    jg = js.graph
    pairs = list(_param_pairs(ts.graph, jg, jg.params))
    assert pairs
    floor = 1e-30
    if after_step:
        floor = 1e-2 * max(float(np.abs(np.asarray(a)).max())
                           for _, _, _, a in pairs)
    for t, m, leaf, a in pairs:
        _close(convert._leaf_to_jax(m, leaf, t), np.asarray(a), REL, floor)


def _forward_and_step(pb, inputs, outputs, root, x, y, lr):
    js, ts = _sessions(pb, inputs, outputs, root, x[:1])
    js.graph.evaluate()
    want = np.asarray(js.graph.forward(jnp.asarray(x)))
    ts.graph.evaluate()
    with torch.no_grad():
        got = ts.graph(torch.from_numpy(x))
    _close(got, want, REL)
    _check_weights(ts, js)
    n = len(x)
    js.train(_jds(x, y, n), jnn.CrossEntropyCriterion(),
             JAdam(learningrate=lr), JTrigger.max_iteration(1))
    ts.train(_tds(x, y, n), tnn.CrossEntropyCriterion(),
             Adam(learningrate=lr), Trigger.max_iteration(1))
    _check_weights(ts, js, after_step=True)
    return js, ts


BERT = dict(n_layers=2, hidden=16, heads=2, ffn=32, vocab=50, seq=8,
            classes=2)


def test_bert_classifier_graph_forward_and_adam_step(tmp_path):
    nodes, var = cs.bert_tf_graph(seed=3, **BERT)
    before = {k: v.copy() for k, v in var.items()}
    pb = _write(tmp_path, nodes, var)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 50, (4, 8)).astype(np.int32)
    y = rng.integers(0, 2, 4).astype(np.int32)
    js, ts = _forward_and_step(pb, ["input_ids"], ["output/logits"],
                               str(tmp_path), x, y, 1e-3)
    # the step moved the weights away from the imported ones
    emb = [t for t, m, _, _ in _param_pairs(ts.graph, js.graph,
                                            js.graph.params)
           if m.get_name() == "bert/embeddings/GatherV2"][0]
    assert not np.allclose(_np(emb), before["bert/embeddings/word_embeddings"])


def test_vgg_graph_forward_and_adam_step(tmp_path):
    nodes, var = cs.vgg16_tf_graph(blocks=((2, 4),), image=8, fc=16,
                                   classes=5, seed=4)
    pb = _write(tmp_path, nodes, var)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 5, 4).astype(np.int32)
    js, ts = _forward_and_step(pb, ["input"], ["vgg_16/fc8/squeezed"],
                               str(tmp_path), x, y, 1e-3)
    # the reference's Squeeze takes the first of squeeze_dims [1, 2]
    with torch.no_grad():
        assert tuple(ts.graph(torch.from_numpy(x)).shape) == (4, 1, 5)


def test_session_without_sample_input_applies_weights():
    """The reference's deferred-build case: with no ``sample_input`` the
    imported weights are applied when training starts, so an SGD step at
    learning rate 0 predicts the numpy oracle."""
    import test_tf_importer as ref
    w = ref._bert_weights()
    gd = ref._bert_graphdef(w)
    ids = np.asarray([[1, 5, 2, 9], [3, 3, 0, 15]], np.int32)
    labels = np.asarray([0, 1], np.int32)
    sess = TFTrainingSession(gd, ["ids"], ["out"], device="cpu")
    assert not getattr(sess.graph, "_tf_weights_applied", False)
    sess.train(_tds(ids, labels, 2), tnn.CrossEntropyCriterion(),
               optim_method=SGD(learningrate=0.0),
               end_trigger=Trigger.max_epoch(1))
    got = sess.predict(ids, batch_size=2)
    np.testing.assert_allclose(got, ref._bert_numpy_oracle(w, ids),
                               atol=1e-4)
    js = JSession(gd, ["ids"], ["out"])
    js.train(_jds(ids, labels, 2), jnn.CrossEntropyCriterion(),
             optim_method=JSGD(learningrate=0.0),
             end_trigger=JTrigger.max_epoch(1))
    _close(got, np.asarray(js.predict(ids, batch_size=2)), REL)


def test_imported_mini_bert_trains():
    """The reference's ``test_imported_bert_trains``: imported variables
    (embedding, dense, LayerNorm gamma and beta) receive gradients and the
    loss drops."""
    import test_tf_importer as ref
    w = ref._bert_weights()
    gd = ref._bert_graphdef(w)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, ref.VOCAB, (ref.BATCH * 8, ref.T_LEN)) \
        .astype(np.int32)
    labels = (ids[:, 0] % ref.CLASSES).astype(np.int32)
    sess = TFTrainingSession(gd, ["ids"], ["out"],
                             sample_input=ids[:ref.BATCH], device="cpu")
    crit = tnn.CrossEntropyCriterion()

    def loss():
        sess.graph.evaluate()
        with torch.no_grad():
            out = sess.graph(torch.from_numpy(ids[:ref.BATCH]))
        return float(crit(out, torch.from_numpy(labels[:ref.BATCH])))

    before = loss()
    sess.train(_tds(ids, labels, ref.BATCH), crit,
               optim_method=Adam(learningrate=0.01),
               end_trigger=Trigger.max_epoch(20))
    assert loss() < before * 0.7


def test_mesh_trains_on_the_distri_optimizer(tmp_path):
    """``mesh=`` trains through each package's ``DistriOptimizer``: the
    port on two CPU replicas (``mesh=["cpu", "cpu"]``), the reference on
    two of the virtual CPU devices of ``tests/conftest.py``, both with
    their default bfloat16 wire; one SGD step leaves the same weights."""
    import jax
    from jax.sharding import Mesh
    nodes, var = cs.bert_tf_graph(seed=5, **BERT)
    pb = _write(tmp_path, nodes, var)
    rng = np.random.default_rng(2)
    x = rng.integers(0, 50, (4, 8)).astype(np.int32)
    y = rng.integers(0, 2, 4).astype(np.int32)
    js, ts = _sessions(pb, ["input_ids"], ["output/logits"], str(tmp_path),
                       x[:1])
    js.train(JDataSet.array([JSample.from_ndarray(f, l)
                             for f, l in zip(x, y)], distributed=True)
             >> JToBatch(4), jnn.CrossEntropyCriterion(),
             JSGD(learningrate=0.5), JTrigger.max_iteration(1),
             mesh=Mesh(np.asarray(jax.devices()[:2]), ("data",)))
    ts.train(DataSet.array([Sample.from_ndarray(f, l) for f, l in zip(x, y)],
                           distributed=True) >> SampleToMiniBatch(4),
             tnn.CrossEntropyCriterion(), SGD(learningrate=0.5),
             Trigger.max_iteration(1), mesh=["cpu", "cpu"])
    _check_weights(ts, js, after_step=True)


@pytest.mark.parametrize("what", ["nhwc_pool", "names"])
def test_session_keeps_the_graphs_names(tmp_path, what):
    """The imported layers carry the TF node names, as the reference's."""
    nodes, var = cs.vgg16_tf_graph(blocks=((1, 4),), image=4, fc=8,
                                   classes=3, seed=6)
    pb = _write(tmp_path, nodes, var)
    s = TFTrainingSession(pb, ["input"], ["vgg_16/fc8/squeezed"],
                          bin_dir=str(tmp_path), device="cpu")
    names = [n.module.get_name() for n in s.graph.exec_order]
    if what == "names":
        assert "vgg_16/conv1/conv1_1/Conv2D" in names
        assert names[-1] == "vgg_16/fc8/squeezed"
    else:
        pool = [n.module for n in s.graph.exec_order
                if n.module.get_name() == "vgg_16/pool1/MaxPool"][0]
        assert pool.format == "NHWC" and (pool.kh, pool.dh) == (2, 2)
