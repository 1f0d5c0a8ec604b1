"""Caffe export in the port (``bigdl_tpu_torch/interop/savers.py``:
``CaffePersister``, ``save_caffe``) against the JAX reference's, on the
CPU, mirroring the Caffe cases of the reference's ``tests/test_savers.py``.

The same model and weights in both packages (``convert`` carries the
reference's built params into the port): each package's ``save_caffe``
writes the same prototxt text and the same caffemodel bytes, each
package loads either package's files, and every load gives the source's
outputs within 1e-5 of their largest magnitude. What the reference
refuses (a ``Concat`` container, SAME padding, an unmapped layer), the
port refuses with the same message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.interop import save_caffe as jsave
from bigdl_tpu.interop.caffe import load_caffe as jload
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.interop import CaffePersister
from bigdl_tpu_torch.interop import load_caffe as tload
from bigdl_tpu_torch.interop import save_caffe as tsave

OUT_REL = 1e-5


@pytest.fixture(autouse=True)
def _keep_library_calls():
    """Leave ``SpatialConvolution.library_calls``, a process-wide counter
    that other test files read, as each test found it."""
    saved = tnn.SpatialConvolution.library_calls.copy()
    yield
    tnn.SpatialConvolution.library_calls.clear()
    tnn.SpatialConvolution.library_calls.update(saved)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= OUT_REL * scale


def _port_out(model, x):
    model.evaluate()
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


def _jax_out(model, x):
    return np.asarray(model.apply(model.params, model.state,
                                  jnp.asarray(x), training=False)[0])


def _carry(jm, tm):
    """The reference model's built weights into the port's twin (a Graph's
    node-id-keyed params in ``exec_order``)."""
    p, s = jax.tree_util.tree_map(np.asarray, (jm.params, jm.state))
    if isinstance(jm, jnn.Graph):
        keys = [str(n.id) for n in jm.exec_order]
        p, s = [p[k] for k in keys], [s[k] for k in keys]
    tm.load_state_dict(convert.module_params_from_jax(tm, p, s))
    return tm


def _convnet(nn, dev, shape):
    kw = {} if dev is None else {"device": dev}
    m = nn.Sequential(
        nn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1, **kw),
        nn.ReLU(),
        nn.SpatialMaxPooling(2, 2, 2, 2),
        nn.Flatten(),
        nn.Linear(8 * 8 * 8, 10, **kw),
        nn.SoftMax())
    return m.build(0, shape) if dev is None else m


def _graph_concat(nn, dev, shape):
    kw = {} if dev is None else {"device": dev}
    inp = nn.Input()
    a = nn.SpatialConvolution(4, 6, 1, 1, **kw)(inp)
    b = nn.SpatialConvolution(4, 6, 3, 3, 1, 1, 1, 1, **kw)(inp)
    cat = nn.JoinTable(1)(a, b)
    out = nn.ReLU()(cat)
    g = nn.Graph([inp], [out])
    return g.build(2, shape) if dev is None else g


def _logsoftmax(nn, dev, shape):
    kw = {} if dev is None else {"device": dev}
    m = nn.Sequential(nn.Linear(6, 3, **kw), nn.LogSoftMax())
    return m.build(3, shape) if dev is None else m


def _breadth(nn, dev, shape):
    """Every other layer the saver writes: grouped strided convolution,
    BN with its Scale, LRN, average and global pooling, tanh, sigmoid,
    dropout, the element-wise joins, an identity (a Split)."""
    kw = {} if dev is None else {"device": dev}
    inp = nn.Input()
    c = nn.SpatialConvolution(4, 8, 3, 3, 2, 2, 1, 1, n_group=2, **kw)(inp)
    bn = nn.SpatialBatchNormalization(8, **kw)(c)
    t = nn.Tanh()(nn.SpatialCrossMapLRN(3, 0.01, 0.75, 2.0)(bn))
    s = nn.Sigmoid()(nn.SpatialAveragePooling(3, 3, 1, 1, 1, 1)(bn))
    prod = nn.CMulTable()(t, s)
    mx = nn.CMaxTable()(prod, nn.Identity()(t))
    add = nn.CAddTable()(mx, s)
    g = nn.SpatialMaxPooling(1, 1, global_pooling=True)(nn.Dropout(0.2)(add))
    out = nn.Linear(8, 3, **kw)(nn.Flatten()(g))
    m = nn.Graph([inp], [out])
    return m.build(4, shape) if dev is None else m


CASES = {"convnet": (_convnet, (2, 3, 16, 16)),
         "graph_concat": (_graph_concat, (2, 4, 8, 8)),
         "logsoftmax": (_logsoftmax, (4, 6)),
         "breadth": (_breadth, (2, 4, 8, 8))}


@pytest.mark.parametrize("case", list(CASES))
def test_save_caffe_cross(tmp_path, case):
    make, shape = CASES[case]
    jm = make(jnn, None, shape)
    if case == "breadth":            # non-trivial BN statistics
        rng = np.random.default_rng(1)
        jm.training()
        for _ in range(2):
            jm.forward(jnp.asarray(rng.standard_normal(shape)
                                   .astype(np.float32)))
    jm.evaluate()
    tm = _carry(jm, make(tnn, "cpu", shape))
    x = np.random.RandomState(len(case)).randn(*shape).astype("float32")
    want = _jax_out(jm, x)
    _close(_port_out(tm, x), want)
    files = {}
    for who, save, model in (("port", tsave, tm), ("ref", jsave, jm)):
        proto = str(tmp_path / f"{who}.prototxt")
        weights = str(tmp_path / f"{who}.caffemodel")
        save(model, proto, weights, shape)
        files[who] = (proto, weights)
    for i in (0, 1):
        mode = "rb" if i else "r"
        assert open(files["port"][i], mode).read() \
            == open(files["ref"][i], mode).read()
    for proto, weights in files.values():
        loaded = tload(proto, weights, sample_input=shape, device="cpu")
        _close(_port_out(loaded, x), want)
        _close(_jax_out(jload(proto, weights, sample_input=shape), x), want)
    if case == "logsoftmax":
        assert "SoftmaxWithLoss" in open(files["port"][0]).read()


def test_save_caffe_refusals(tmp_path):
    """A Concat container, SAME padding and an unmapped layer are refused
    as the reference refuses them; an existing file needs overwrite."""
    cases = [
        (lambda nn, kw: nn.Sequential(
            nn.Concat(1).add(nn.SpatialConvolution(3, 2, 1, 1, **kw))
            .add(nn.SpatialConvolution(3, 2, 1, 1, **kw))), (1, 3, 4, 4),
         "unsupported layer Concat"),
        (lambda nn, kw: nn.Sequential(
            nn.SpatialConvolution(3, 2, 3, 3, 1, 1, -1, -1, **kw)),
         (1, 3, 4, 4), "SAME padding"),
        (lambda nn, kw: nn.Sequential(
            nn.SpatialMaxPooling(2, 2, 2, 2, -1, -1)), (1, 3, 4, 4),
         "SAME padding"),
        (lambda nn, kw: nn.Sequential(nn.ELU()), (1, 3), "unsupported layer"),
        (lambda nn, kw: nn.Sequential(
            nn.SpatialConvolution(3, 2, 1, 1, format="NHWC", **kw)),
         (1, 4, 4, 3), "NCHW"),
    ]
    for i, (make, shape, match) in enumerate(cases):
        jm = make(jnn, {}).build(0, shape)
        with pytest.raises(ValueError, match=match) as je:
            jsave(jm, str(tmp_path / f"j{i}.prototxt"),
                  str(tmp_path / f"j{i}.caffemodel"), shape)
        with pytest.raises(ValueError, match=match) as te:
            tsave(make(tnn, {"device": "cpu"}).reset(0),
                  str(tmp_path / f"t{i}.prototxt"),
                  str(tmp_path / f"t{i}.caffemodel"), shape)
        assert str(te.value) == str(je.value)
    m = tnn.Sequential(tnn.ReLU())
    proto, weights = str(tmp_path / "x.prototxt"), str(tmp_path / "x.cm")
    CaffePersister.save(m, proto, weights, (1, 3))
    with pytest.raises(FileExistsError, match="overwrite=True"):
        CaffePersister.save_caffe(m, proto, weights, (1, 3))
    CaffePersister.save_caffe(m, proto, weights, (1, 3), overwrite=True)


def test_save_caffe_keeps_the_card_free(tmp_path):
    """The saver's shape pass runs on a CPU copy at batch 1: the model's
    own tensors are neither moved nor changed, and a Flatten's recorded
    rank stays the model's own."""
    m = tnn.Sequential(tnn.SpatialConvolution(3, 4, 3, 3, device="cpu"),
                       tnn.Flatten(), tnn.Linear(4 * 4 * 4, 2, device="cpu"))
    m.reset(0)
    before = {k: v.clone() for k, v in m.state_dict().items()}
    tsave(m, str(tmp_path / "a.prototxt"), str(tmp_path / "a.cm"),
          (5, 3, 6, 6))
    for k, v in m.state_dict().items():
        assert torch.equal(v, before[k])
    assert not hasattr(m[1], "_input_rank")
    text = open(tmp_path / "a.prototxt").read()
    assert "input_shape { dim: 5 dim: 3 dim: 6 dim: 6 }" in text
