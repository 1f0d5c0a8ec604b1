"""Caffe and Torch7 import and export in the port (``bigdl_tpu_torch/
interop``, ``utils/protowire.py``) against the JAX reference's
(``bigdl_tpu/interop``), on the CPU, mirroring the reference's
``tests/test_interop.py`` (``TestTorchFile``, ``TestProtoWire``,
``TestCaffeLoader``, ``test_caffe_batchnorm_scale``,
``test_caffe_wave2_layers``, ``TestSaveTorchModules``,
``TestCaffeBreadthAudit``).

Every file is written here: by hand through either package's wire
encoder, or by either package's ``save_torch``. Each package loads the
same file; their outputs agree within 1e-5 of the largest magnitude
(float32, the same layers in the same order). Weights cross between the
packages through ``convert`` where a layer has no blob (a prototxt-only
load draws each package's own random weights). The two packages' writers
give the same bytes for the same module and weights (``.t7``) and for the
same dicts (``protowire.encode``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.interop import caffe as jcaffe
from bigdl_tpu.interop import torch_file as jt7
from bigdl_tpu.utils import protowire as jwire
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.interop import caffe as tcaffe
from bigdl_tpu_torch.interop import torch_file as tt7
from bigdl_tpu_torch.models import (Inception_v1_NoAuxClassifier,
                                    conv_routes, layer_walk, model_flops)
from bigdl_tpu_torch.utils import protowire as twire

OUT_REL = 1e-5


@pytest.fixture(autouse=True)
def _keep_library_calls():
    """Leave ``SpatialConvolution.library_calls``, a process-wide counter
    that other test files read, as each test found it."""
    saved = tnn.SpatialConvolution.library_calls.copy()
    yield
    tnn.SpatialConvolution.library_calls.clear()
    tnn.SpatialConvolution.library_calls.update(saved)


def _close(got, want, rel=OUT_REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale


def _jax_out(model, x):
    x = [jnp.asarray(a) for a in x] if isinstance(x, list) else jnp.asarray(x)
    return np.asarray(model.apply(model.params, model.state, x,
                                  training=False)[0])


def _port_out(model, x):
    model.evaluate()
    with torch.no_grad():
        x = [torch.from_numpy(a) for a in x] if isinstance(x, list) \
            else torch.from_numpy(x)
        return model(x).numpy()


def _graph_params(jg):
    """A built reference ``Graph``'s params and state as the port's
    ``convert`` takes them (node-id keys in ``exec_order``)."""
    keys = [str(n.id) for n in jg.exec_order]
    tree = jax.tree_util.tree_map(np.asarray, (jg.params, jg.state))
    return [tree[0][k] for k in keys], [tree[1][k] for k in keys]


def _blob(a):
    a = np.asarray(a, np.float32)
    return {"shape": {"dim": list(a.shape)}, "data": a.ravel()}


def _write(path, text_or_bytes):
    mode = "wb" if isinstance(text_or_bytes, bytes) else "w"
    with open(path, mode) as f:
        f.write(text_or_bytes)
    return str(path)


# ---------------------------------------------------------------- wire --

WIRE_CASES = {
    "scalars": ({1: ("name", "string"), 2: ("vals[]", "floats_packed"),
                 3: ("n", "int"), 4: ("sub", ("msg", {1: ("x", "float")}))},
                {"name": "abc", "vals": [1.0, 2.5, -3.0], "n": 42,
                 "sub": {"x": 7.5}}),
    "negative_and_repeated": ({1: ("a[]", "int"), 2: ("d", "double"),
                               3: ("b", "bool"), 4: ("s", "sint")},
                              {"a": [1, -2, 300, -(1 << 40)], "d": -0.125,
                               "b": True}),
    "caffe_net": (jcaffe.NET, {
        "name": "n", "input": ["data"],
        "layer": [{"name": "c", "type": "Convolution", "bottom": ["data"],
                   "top": ["c"],
                   "convolution_param": {"num_output": 4, "pad_h": 1,
                                         "bias_term": False},
                   "blobs": [_blob(np.arange(24.0).reshape(4, 1, 2, 3))]},
                  {"name": "p", "type": "Pooling",
                   "pooling_param": {"pool": 1, "kernel_size": 3}}]}),
}


@pytest.mark.parametrize("case", list(WIRE_CASES))
def test_protowire_bytes_and_round_trip(case):
    """The port's encoder writes the reference's bytes; each decoder
    reads them back to the same dict."""
    schema, msg = WIRE_CASES[case]
    tschema = tcaffe.NET if schema is jcaffe.NET else schema
    buf = twire.encode(msg, tschema)
    assert buf == jwire.encode(msg, schema)
    back = twire.decode(buf, tschema)
    assert repr(back) == repr(jwire.decode(buf, schema))
    if case == "scalars":
        assert back["name"] == "abc" and back["n"] == 42
        np.testing.assert_allclose(back["vals"], [1.0, 2.5, -3.0])
        assert back["sub"]["x"] == 7.5
    if case == "negative_and_repeated":
        assert back["a"] == [1, -2, 300, -(1 << 40)] and back["b"] is True
        # zigzag (sint) fields decode; neither encoder writes them
        assert twire.decode(b"\x20\x11", schema) == {"s": -9}


def test_caffe_schemas_are_the_reference_s():
    for name in ("NET", "LAYER", "V1_LAYER", "BLOB", "CONV_PARAM",
                 "POOL_PARAM", "V1_TYPES", "_TYPE_CANON"):
        assert getattr(tcaffe, name) == getattr(jcaffe, name), name
    assert tcaffe.V1_TYPES[3] == "Concat" and tcaffe.V1_TYPES[5] == "Data"
    assert tcaffe.V1_TYPES[6] == "Dropout" and tcaffe.V1_TYPES[8] == "Flatten"
    assert tcaffe.V1_TYPES[39] == "Deconvolution"
    assert tcaffe.V1_TYPES[14] == "InnerProduct"


# ------------------------------------------------------------------ t7 --

def test_t7_table_and_tensors_cross(tmp_path):
    """A table of tensors, strings, booleans and numbers: each package's
    file is the other's byte for byte, and each reads both."""
    obj = {1: np.arange(12, dtype=np.float32).reshape(3, 4),
           2: np.arange(6, dtype=np.float64).reshape(2, 3).T,
           3: np.arange(5, dtype=np.int64),
           "name": "hello", "flag": True, "num": 3.5,
           "nested": {"a": np.ones(2, np.float32)}}
    pt, pj = str(tmp_path / "t.t7"), str(tmp_path / "j.t7")
    tt7.write_t7(pt, obj)
    jt7.write_t7(pj, obj)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    for back in (tt7.read_t7(pj), jt7.read_t7(pt)):
        np.testing.assert_array_equal(back[1], obj[1])
        np.testing.assert_array_equal(back[2], obj[2])
        assert back[3].dtype == np.int64
        assert back["name"] == "hello" and back["flag"] is True
        assert back["num"] == 3.5
        np.testing.assert_array_equal(back["nested"]["a"], np.ones(2))


def test_legacy_nn_conversion(tmp_path):
    """A hand-written nn.Sequential(nn.Linear, nn.ReLU) loads in both
    packages to the same outputs and the Linear's math."""
    rng = np.random.default_rng(0)
    w1 = rng.standard_normal((8, 4)).astype(np.float32)   # (out, in)
    b1 = rng.standard_normal(8).astype(np.float32)
    seq = jt7.TorchObject("nn.Sequential", {"modules": {
        1: jt7.TorchObject("nn.Linear", {"weight": w1, "bias": b1}),
        2: jt7.TorchObject("nn.ReLU", {"inplace": False})}})
    path = str(tmp_path / "m.t7")
    jt7.write_t7(path, seq)
    tm = tt7.load_torch(path, device="cpu")
    assert isinstance(tm[0], tnn.Linear) and isinstance(tm[1], tnn.ReLU)
    jm = jt7.load_torch(path).build(0, (2, 4))
    x = rng.standard_normal((2, 4)).astype(np.float32)
    y = _port_out(tm, x)
    _close(y, np.maximum(x @ w1.T + b1, 0.0))
    _close(y, _jax_out(jm, x))


def test_conv_conversion_layout(tmp_path):
    """A legacy SpatialConvolution's OIHW weight is the port's as it is."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((2, 3, 3, 3)).astype(np.float32)
    conv = jt7.TorchObject("nn.SpatialConvolution", {
        "weight": w, "bias": np.zeros(2, np.float32),
        "nInputPlane": 3.0, "nOutputPlane": 2.0,
        "kW": 3.0, "kH": 3.0, "dW": 1.0, "dH": 1.0,
        "padW": 0.0, "padH": 0.0})
    path = str(tmp_path / "conv.t7")
    jt7.write_t7(path, conv)
    m = tt7.load_torch(path, device="cpu")
    x = rng.standard_normal((1, 3, 5, 5)).astype(np.float32)
    y = _port_out(m, x)
    center = sum(w[0, c, i, j] * x[0, c, 1 + i, 1 + j]
                 for c in range(3) for i in range(3) for j in range(3))
    np.testing.assert_allclose(y[0, 0, 1, 1], center, rtol=1e-4)
    _close(y, _jax_out(jt7.load_torch(path).build(0, x.shape), x))


def test_load_torch_defaults_to_the_card(tmp_path):
    path = str(tmp_path / "r.t7")
    jt7.write_t7(path, jt7.TorchObject("nn.Linear", {
        "weight": np.ones((2, 3), np.float32)}))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tt7.load_torch(path)
    m = tt7.load_torch(path, device="cpu")
    assert m.bias is None and m.weight.device.type == "cpu"


def _convnet_pair():
    jm = (jnn.Sequential()
          .add(jnn.SpatialConvolution(3, 6, 3, 3, 1, 1, 1, 1))
          .add(jnn.ReLU())
          .add(jnn.SpatialMaxPooling(2, 2))
          .add(jnn.Flatten())
          .add(jnn.Linear(6 * 4 * 4, 4))
          .add(jnn.LogSoftMax())).build(0, (2, 3, 8, 8))
    tm = tnn.Sequential(tnn.SpatialConvolution(3, 6, 3, 3, 1, 1, 1, 1,
                                               device="cpu"),
                        tnn.ReLU(), tnn.SpatialMaxPooling(2, 2),
                        tnn.Flatten(), tnn.Linear(6 * 4 * 4, 4, device="cpu"),
                        tnn.LogSoftMax())
    return jm, tm, (2, 3, 8, 8)


def _bn_pair():
    jm = (jnn.Sequential()
          .add(jnn.SpatialConvolution(2, 4, 3, 3, 1, 1, 1, 1))
          .add(jnn.SpatialBatchNormalization(4))
          .add(jnn.Tanh())).build(0, (2, 2, 6, 6))
    rng = np.random.default_rng(1)
    jm.training()
    for _ in range(3):                  # non-trivial running statistics
        jm.forward(jnp.asarray(rng.standard_normal((2, 2, 6, 6))
                               .astype(np.float32)))
    jm.evaluate()
    tm = tnn.Sequential(tnn.SpatialConvolution(2, 4, 3, 3, 1, 1, 1, 1,
                                               device="cpu"),
                        tnn.SpatialBatchNormalization(4, device="cpu"),
                        tnn.Tanh())
    return jm, tm, (2, 2, 6, 6)


def _tables_pair():
    """Concat, ConcatTable, ParallelTable, CAddTable, LRN, average and
    ceil max pooling, dropout, reshape and the element-wise layers the t7
    writer knows."""
    def build(nn, dev):
        kw = {} if dev is None else {"device": dev}
        branch = (nn.Concat(1)
                  .add(nn.SpatialConvolution(3, 2, 1, 1, **kw))
                  .add(nn.SpatialConvolution(3, 3, 3, 3, 1, 1, 1, 1, **kw)))
        pair = (nn.ConcatTable()
                .add(nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1).ceil())
                .add(nn.SpatialAveragePooling(3, 3, 2, 2, 1, 1)))
        return (nn.Sequential()
                .add(branch).add(nn.Sigmoid())
                .add(nn.SpatialCrossMapLRN(3, 0.01, 0.75, 2.0))
                .add(pair)
                .add(nn.ParallelTable().add(nn.Identity()).add(nn.Tanh()))
                .add(nn.CAddTable())
                .add(nn.Dropout(0.3))
                .add(nn.Reshape((5 * 6 * 6,)))
                .add(nn.Linear(180, 6, **kw)).add(nn.SoftMax()))
    return build(jnn, None).build(0, (2, 3, 11, 11)), build(tnn, "cpu"), \
        (2, 3, 11, 11)


def _flatten_after_reshape_pair():
    """A Flatten whose per-sample rank comes from its input, not from a
    spatial layer before it."""
    jm = (jnn.Sequential().add(jnn.Reshape((2, 3, 4)))
          .add(jnn.Flatten()).add(jnn.Linear(24, 5))).build(0, (3, 24))
    tm = tnn.Sequential(tnn.Reshape((2, 3, 4)), tnn.Flatten(),
                        tnn.Linear(24, 5, device="cpu"))
    return jm, tm, (3, 24)


T7_PAIRS = {"convnet": _convnet_pair, "batchnorm": _bn_pair,
            "tables": _tables_pair, "flatten_rank": _flatten_after_reshape_pair}


@pytest.mark.parametrize("case", list(T7_PAIRS))
def test_save_torch_cross(tmp_path, case):
    """The same module and weights in both packages: ``save_torch`` writes
    the same bytes, and each package loads either file to the same module
    tree, weights and outputs."""
    jm, tm, shape = T7_PAIRS[case]()
    p, s = jax.tree_util.tree_map(np.asarray, (jm.params, jm.state))
    tm.load_state_dict(convert.module_params_from_jax(tm, p, s))
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    want = _jax_out(jm, x)
    _close(_port_out(tm, x), want)
    pt, pj = str(tmp_path / "t.t7"), str(tmp_path / "j.t7")
    tt7.save_torch(tm, pt)
    jt7.save_torch(jm, pj)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    back = tt7.load_torch(pj, device="cpu")
    # a Flatten travels as a legacy nn.View, which loads as a Reshape
    assert [type(m).__name__ for m in back.modules()] \
        == [type(m).__name__.replace("Flatten", "Reshape")
            for m in tm.modules()]
    for k, v in tm.state_dict().items():
        torch.testing.assert_close(back.state_dict()[k], v, rtol=0, atol=0)
    _close(_port_out(back, x), want)
    jback = jt7.load_torch(pt).build(0, shape)
    _close(_jax_out(jback, x), want)


def test_save_torch_refusals(tmp_path):
    """What the reference refuses, the port refuses with its message: an
    unmapped layer, a dilated or grouped convolution (the Caffe AlexNet's
    conv2/4/5), an NHWC pooling; an existing file without overwrite."""
    cases = [
        (jnn.SoftPlus(), tnn.SoftPlus(), (1, 4)),
        (jnn.SpatialConvolution(2, 4, 3, 3, dilation_w=2, dilation_h=2),
         tnn.SpatialConvolution(2, 4, 3, 3, dilation_w=2, dilation_h=2,
                                device="cpu"), (1, 2, 8, 8)),
        (jnn.SpatialConvolution(4, 4, 3, 3, n_group=2),
         tnn.SpatialConvolution(4, 4, 3, 3, n_group=2, device="cpu"),
         (1, 4, 8, 8)),
        (jnn.SpatialMaxPooling(2, 2, format="NHWC"),
         tnn.SpatialMaxPooling(2, 2, format="NHWC"), (1, 8, 8, 2)),
        (jnn.SpatialMaxPooling(1, 1, global_pooling=True),
         tnn.SpatialMaxPooling(1, 1, global_pooling=True), (1, 2, 4, 4)),
    ]
    for i, (jl, tl, shape) in enumerate(cases):
        jm = jnn.Sequential().add(jl).build(0, shape)
        with pytest.raises(ValueError, match="no legacy-nn mapping") as je:
            jt7.save_torch(jm, str(tmp_path / f"j{i}.t7"))
        with pytest.raises(ValueError, match="no legacy-nn mapping") as te:
            tt7.save_torch(tnn.Sequential(tl), str(tmp_path / f"t{i}.t7"))
        assert str(te.value) == str(je.value)
    path = _write(tmp_path / "exists.t7", b"")
    with pytest.raises(FileExistsError):
        tt7.save_torch(tnn.Sequential(tnn.ReLU()), path)
    tt7.save_torch(tnn.Sequential(tnn.ReLU()), path, overwrite=True)
    assert tt7.read_t7(path).torch_class == "nn.Sequential"


def test_save_torch_flatten_needs_a_rank(tmp_path):
    """A Flatten that has not run and follows no spatial layer cannot be
    written: legacy nn.View needs its numInputDims."""
    m = tnn.Sequential(tnn.Linear(4, 4, device="cpu"), tnn.Flatten())
    with pytest.raises(ValueError, match="per-sample rank"):
        tt7.save_torch(m, str(tmp_path / "f.t7"))
    m.reset(0)(torch.zeros(2, 4))
    tt7.save_torch(m, str(tmp_path / "f.t7"))
    view = tt7.read_t7(str(tmp_path / "f.t7")).get("modules")[2]
    assert view.torch_class == "nn.View" and view.get("numInputDims") == 1


def test_reshape_batch_mode_roundtrip(tmp_path):
    m = tnn.Sequential(tnn.Reshape((6, 4), batch_mode=False))
    p = str(tmp_path / "r.t7")
    tt7.save_torch(m, p)
    back = tt7.load_torch(p, device="cpu")
    assert back[0].batch_mode is False
    assert back(torch.ones(2, 12)).shape == (6, 4)
    assert jt7.load_torch(p).modules[0].batch_mode is False


def test_save_torch_raw_tree(tmp_path):
    """A tree of tensors (a state_dict) is a plain table of its leaves,
    dict keys sorted, as the reference writes a params pytree."""
    tree = {"b": torch.arange(3.0), "a": [np.ones((2, 2), np.float32),
                                          None, torch.zeros(1)]}
    p = str(tmp_path / "raw.t7")
    tt7.save_torch(tree, p)
    back = jt7.read_t7(p)
    assert sorted(back) == [1, 2, 3]
    np.testing.assert_array_equal(back[1], np.ones((2, 2)))
    np.testing.assert_array_equal(back[2], np.zeros(1))
    np.testing.assert_array_equal(back[3], np.arange(3.0))


# --------------------------------------------------------------- caffe --

TINY = """
name: "TinyNet"
input: "data"
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 2 kernel_size: 3 stride: 1 pad: 1 } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "fc1" type: "InnerProduct" bottom: "pool1" top: "fc1"
  inner_product_param { num_output: 4 } }
layer { name: "prob" type: "Softmax" bottom: "fc1" top: "prob" }
"""


def _both(proto, weights, sample, x):
    """Each package's load of the same files and its outputs on ``x``."""
    tg = tcaffe.load_caffe(proto, weights, sample_input=sample, device="cpu")
    jg = jcaffe.load_caffe(proto, weights, sample_input=sample)
    return tg, jg, _port_out(tg, x), _jax_out(jg, x)


def test_caffe_loader_tiny_net(tmp_path):
    rng = np.random.default_rng(0)
    w_conv = rng.standard_normal((2, 3, 3, 3)).astype(np.float32)
    b_conv = rng.standard_normal(2).astype(np.float32)
    w_fc = rng.standard_normal((4, 2 * 4 * 4)).astype(np.float32)
    b_fc = rng.standard_normal(4).astype(np.float32)
    assert tcaffe.parse_prototxt(TINY) == jcaffe.parse_prototxt(TINY)
    assert len(tcaffe.parse_prototxt(TINY)["layer"]) == 5
    net = {"name": "TinyNet", "layer": [
        {"name": "conv1", "type": "Convolution",
         "blobs": [_blob(w_conv), _blob(b_conv)]},
        {"name": "fc1", "type": "InnerProduct",
         "blobs": [_blob(w_fc), _blob(b_fc)]}]}
    proto = _write(tmp_path / "net.prototxt", TINY)
    model = _write(tmp_path / "net.caffemodel", twire.encode(net, tcaffe.NET))
    x = rng.standard_normal((1, 3, 8, 8)).astype(np.float32)
    tg, _, y, want = _both(proto, model, (1, 3, 8, 8), x)
    assert y.shape == (1, 4)
    np.testing.assert_allclose(y.sum(), 1.0, rtol=1e-5)
    _close(y, want)
    conv = np.zeros((1, 2, 8, 8), np.float32)
    xp = np.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1)))
    for i in range(8):
        for j in range(8):
            conv[0, :, i, j] = np.tensordot(
                w_conv, xp[0, :, i:i + 3, j:j + 3], axes=3)
    conv = np.maximum(conv + b_conv.reshape(1, 2, 1, 1), 0.0)
    logits = conv.reshape(1, 2, 4, 2, 4, 2).max(axis=(3, 5)) \
        .reshape(1, -1) @ w_fc.T + b_fc
    np.testing.assert_allclose(y, np.exp(logits) / np.exp(logits).sum(),
                               rtol=1e-4)
    assert [n.module.get_name() for n in tg.exec_order][1:] \
        == ["conv1", "relu1", "pool1", "Sequential", "prob"]


def test_caffe_v1_layers_and_default_device(tmp_path):
    """A caffemodel of V1 ``layers`` (type enums) loads in both; the
    loader makes its layers on the card unless told otherwise."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 2)).astype(np.float32)
    net = {"layers": [{"name": "ip", "type_enum": 14, "blobs": [_blob(w)]}]}
    proto = _write(tmp_path / "v1.prototxt", '''
input: "data"
layers { name: "ip" type: INNER_PRODUCT bottom: "data" top: "ip"
  inner_product_param { num_output: 3 bias_term: false } }
layers { name: "s" type: SIGMOID bottom: "ip" top: "ip" }
''')
    model = _write(tmp_path / "v1.caffemodel", twire.encode(net, tcaffe.NET))
    x = rng.standard_normal((4, 2)).astype(np.float32)
    _, _, y, want = _both(proto, model, (4, 2), x)
    _close(y, want)
    _close(y, 1.0 / (1.0 + np.exp(-(x @ w.T))))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcaffe.load_caffe(proto, model)


def test_caffe_batchnorm_scale(tmp_path):
    proto = _write(tmp_path / "bn.prototxt", '''
input: "data"
layer { name: "bn" type: "BatchNorm" bottom: "data" top: "bn" }
layer { name: "sc" type: "Scale" bottom: "bn" top: "sc" }
''')
    mean = np.array([1.0, 2.0], np.float32)
    var = np.array([4.0, 9.0], np.float32)
    gamma = np.array([2.0, 3.0], np.float32)
    beta = np.array([0.5, -0.5], np.float32)
    net = {"layer": [
        {"name": "bn", "type": "BatchNorm",
         "blobs": [_blob(mean * 2), _blob(var * 2),
                   _blob(np.array([2.0], np.float32))]},
        {"name": "sc", "type": "Scale",
         "blobs": [_blob(gamma), _blob(beta)]}]}
    model = _write(tmp_path / "bn.caffemodel", twire.encode(net, tcaffe.NET))
    x = np.random.default_rng(0).standard_normal((1, 2, 3, 3)) \
        .astype(np.float32)
    tg, _, y, want = _both(proto, model, (1, 2, 3, 3), x)
    expect = ((x - mean.reshape(1, 2, 1, 1))
              / np.sqrt(var.reshape(1, 2, 1, 1) + 1e-5)
              * gamma.reshape(1, 2, 1, 1) + beta.reshape(1, 2, 1, 1))
    np.testing.assert_allclose(y, expect, rtol=1e-4)
    _close(y, want)
    bn = tg.exec_order[1].module
    assert isinstance(bn, tnn.SpatialBatchNormalization) and not bn.affine


def test_caffe_wave2_layers(tmp_path):
    """Power/AbsVal/Slice/ELU from a prototxt alone."""
    proto = _write(tmp_path / "net.prototxt", """
name: "wave2"
input: "data"
input_shape { dim: 2 dim: 6 }
layer { name: "pw" type: "Power" bottom: "data" top: "pw"
  power_param { power: 2.0 scale: 1.0 shift: 1.0 } }
layer { name: "abs" type: "AbsVal" bottom: "pw" top: "abs" }
layer { name: "sl" type: "Slice" bottom: "abs" top: "a" top: "b"
  slice_param { axis: 1 slice_point: 2 slice_point: 6 } }
layer { name: "elu" type: "ELU" bottom: "a" top: "elu"
  elu_param { alpha: 1.0 } }
""")
    x = np.random.RandomState(0).randn(2, 6).astype("float32")
    tg, _, y, want = _both(proto, None, x.shape, x)
    np.testing.assert_allclose(y, (x[:, :2] + 1.0) ** 2, rtol=1e-5,
                               atol=1e-6)
    _close(y, want)
    assert [n.module.get_name() for n in tg.exec_order][1:] \
        == ["pw", "abs", "sl:0", "elu"]


BREADTH = """
name: "breadth"
input: "data"
input_shape { dim: 2 dim: 3 dim: 8 dim: 8 }
layer { name: "c1" type: "Convolution" bottom: "data" top: "c1"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1 group: 1 } }
layer { name: "pr" type: "PReLU" bottom: "c1" top: "c1" }
layer { name: "dc" type: "Deconvolution" bottom: "c1" top: "dc"
  convolution_param { num_output: 4 kernel_size: 2 stride: 2 } }
layer { name: "bias" type: "Bias" bottom: "dc" top: "dc" }
layer { name: "sc" type: "Scale" bottom: "dc" top: "dc" }
layer { name: "lrn" type: "LRN" bottom: "dc" top: "lrn"
  lrn_param { local_size: 3 alpha: 0.5 beta: 0.75 norm_region: WITHIN_CHANNEL } }
layer { name: "p" type: "Pooling" bottom: "lrn" top: "p"
  pooling_param { pool: AVE kernel_size: 3 stride: 2 } }
layer { name: "sl" type: "Slice" bottom: "p" top: "s0" top: "s1" top: "s2"
  slice_param { axis: 1 slice_point: 1 slice_point: 3 } }
layer { name: "e" type: "Exp" bottom: "s0" top: "e"
  exp_param { base: 2.0 scale: 0.5 shift: -1.0 } }
layer { name: "bnll" type: "BNLL" bottom: "s1" top: "bnll" }
layer { name: "t" type: "TanH" bottom: "s2" top: "t" }
layer { name: "tile" type: "Tile" bottom: "e" top: "tile"
  tile_param { axis: 1 tiles: 2 } }
layer { name: "prod" type: "Eltwise" bottom: "tile" bottom: "bnll" top: "prod"
  eltwise_param { operation: PROD } }
layer { name: "mx" type: "Eltwise" bottom: "prod" bottom: "bnll" top: "mx"
  eltwise_param { operation: MAX } }
layer { name: "wsum" type: "Eltwise" bottom: "mx" bottom: "tile" top: "wsum"
  eltwise_param { operation: SUM coeff: 2.0 coeff: 0.5 } }
layer { name: "sub" type: "Eltwise" bottom: "wsum" bottom: "mx" top: "sub"
  eltwise_param { operation: SUM coeff: 1 coeff: -1 } }
layer { name: "cat" type: "Concat" bottom: "sub" bottom: "t" top: "cat" }
layer { name: "lg" type: "Log" bottom: "cat" top: "lg"
  log_param { scale: 0.5 shift: 3.0 } }
layer { name: "th" type: "Threshold" bottom: "lg" top: "th"
  threshold_param { threshold: 1.0 } }
layer { name: "sg" type: "Sigmoid" bottom: "lg" top: "sg" }
layer { name: "both" type: "Eltwise" bottom: "sg" bottom: "th" top: "both" }
layer { name: "dr" type: "Dropout" bottom: "both" top: "both"
  dropout_param { dropout_ratio: 0.3 } }
layer { name: "r" type: "Reshape" bottom: "both" top: "r"
  reshape_param { shape { dim: 0 dim: -1 } } }
layer { name: "fl" type: "Flatten" bottom: "r" top: "fl" }
layer { name: "ip" type: "InnerProduct" bottom: "fl" top: "ip"
  inner_product_param { num_output: 5 } }
layer { name: "sm" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label" top: "sm" }
"""


def test_caffe_breadth_net(tmp_path):
    """Every layer type with a port layer, in one net, with blobs for the
    convolution, deconvolution, scale and inner product (the reference
    copies none into PReLU and Bias: both packages keep their initial
    values there): both packages' loads agree."""
    rng = np.random.default_rng(11)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    net = {"layer": [
        {"name": "c1", "type": "Convolution", "blobs": [_blob(r(4, 3, 3, 3)),
                                                          _blob(r(4))]},
        {"name": "dc", "type": "Deconvolution",
         "blobs": [_blob(r(4, 4, 2, 2)), _blob(r(4))]},
        {"name": "sc", "type": "Scale", "blobs": [_blob(r(4)), _blob(r(4))]},
        {"name": "ip", "type": "InnerProduct",
         "blobs": [_blob(r(5, 192)), _blob(r(5))]}]}
    proto = _write(tmp_path / "b.prototxt", BREADTH)
    model = _write(tmp_path / "b.caffemodel", twire.encode(net, tcaffe.NET))
    x = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    tg, jg, y, want = _both(proto, model, x.shape, x)
    _close(y, want)
    tkinds = [type(n.module).__name__ for n in tg.exec_order]
    jkinds = [type(n.module).__name__ for n in jg.exec_order]
    assert tkinds == jkinds
    for kind in ("PReLU", "SpatialFullConvolution", "CAdd", "Scale",
                 "SpatialWithinChannelLRN", "Narrow", "SoftPlus", "Tile",
                 "CMulTable", "CMaxTable", "CSubTable", "CAddTable",
                 "BinaryThreshold", "InferReshape", "LogSoftMax"):
        assert kind in tkinds, kind


def test_caffe_case_insensitive_alias_types(tmp_path):
    proto = _write(tmp_path / "alias.prototxt", '''
name: "aliases"
input: "data"
input_shape { dim: 1 dim: 2 dim: 8 dim: 8 }
layer { name: "pool" type: "POOLING" bottom: "data" top: "pool"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "act" type: "TANH" bottom: "pool" top: "act" }
layer { name: "out" type: "SIGMOIDCROSSENTROPYLOSS" bottom: "act"
  top: "out" }
''')
    x = np.ones((2, 2, 8, 8), np.float32)
    _, _, y, want = _both(proto, None, x.shape, x)
    assert y.shape == (2, 2, 4, 4)
    assert float(y.min()) >= 0.0 and float(y.max()) <= 1.0
    _close(y, want)


def test_caffe_reshape_layer(tmp_path):
    proto = _write(tmp_path / "rs.prototxt", '''
name: "rs"
input: "data"
input_shape { dim: 2 dim: 12 }
layer { name: "r" type: "Reshape" bottom: "data" top: "r"
  reshape_param { shape { dim: 0 dim: 3 dim: -1 } } }
''')
    x = np.arange(24, dtype=np.float32).reshape(2, 12)
    _, _, y, want = _both(proto, None, x.shape, x)
    assert y.shape == (2, 3, 4)
    _close(y, want)
    bad = _write(tmp_path / "rs2.prototxt", '''
input: "data"
layer { name: "r" type: "Reshape" bottom: "data" top: "r"
  reshape_param { shape { dim: 3 } axis: 1 } }
''')
    for load in (jcaffe.load_caffe,
                 lambda p: tcaffe.load_caffe(p, device="cpu")):
        with pytest.raises(ValueError, match="sub-range"):
            load(bad)


def test_caffe_eltwise_coeffs_global_max_within_lrn(tmp_path):
    gp = _write(tmp_path / "gp.prototxt", '''
name: "ops"
input: "a"
input_shape { dim: 1 dim: 2 dim: 4 dim: 4 }
layer { name: "gp" type: "Pooling" bottom: "a" top: "gp"
  pooling_param { pool: MAX global_pooling: true } }
''')
    x = np.arange(32, dtype=np.float32).reshape(1, 2, 4, 4)
    _, _, y, want = _both(gp, None, x.shape, x)
    np.testing.assert_allclose(y.ravel(), [15.0, 31.0])
    _close(y, want)
    sub = _write(tmp_path / "sub.prototxt", '''
name: "sub"
input: "a"
input_shape { dim: 1 dim: 3 }
input: "b"
input_shape { dim: 1 dim: 3 }
layer { name: "d" type: "Eltwise" bottom: "a" bottom: "b" top: "d"
  eltwise_param { operation: SUM coeff: 1 coeff: -1 } }
''')
    a = np.asarray([[5., 6., 7.]], np.float32)
    b = np.asarray([[1., 2., 3.]], np.float32)
    tg = tcaffe.load_caffe(sub, device="cpu")
    np.testing.assert_allclose(_port_out(tg, [a, b]), [[4., 4., 4.]])
    wl = _write(tmp_path / "wl.prototxt", '''
name: "wl"
input: "a"
input_shape { dim: 1 dim: 2 dim: 4 dim: 4 }
layer { name: "l" type: "LRN" bottom: "a" top: "l"
  lrn_param { local_size: 3 norm_region: WITHIN_CHANNEL } }
''')
    tg, _, y, want = _both(wl, None, x.shape, x / 32)
    assert "SpatialWithinChannelLRN" in [type(n.module).__name__
                                         for n in tg.exec_order]
    _close(y, want)


def test_caffe_refusals(tmp_path):
    """Recurrent layers, unknown types, Eltwise coefficient counts and
    Slice without points: both packages refuse with the same message."""
    cases = {
        "rnn": ('layer { name: "rnn" type: "RNN" bottom: "a" top: "r" }',
                "cell"),
        "odd": ('layer { name: "o" type: "Crop" bottom: "a" top: "o" }',
                "unsupported caffe layer type"),
        "coeff": ('layer { name: "e" type: "Eltwise" bottom: "a" '
                  'bottom: "a" top: "e" eltwise_param { operation: SUM '
                  'coeff: 2 } }', "coeffs for 2 bottoms"),
        "slice": ('layer { name: "s" type: "Slice" bottom: "a" top: "x" '
                  'top: "y" }', "slice_point"),
    }
    for name, (layer, match) in cases.items():
        p = _write(tmp_path / f"{name}.prototxt",
                   f'input: "a"\ninput_shape {{ dim: 1 dim: 4 }}\n{layer}\n')
        with pytest.raises(ValueError, match=match) as je:
            jcaffe.load_caffe(p, None)
        with pytest.raises(ValueError, match=match) as te:
            tcaffe.load_caffe(p, None, device="cpu")
        assert str(te.value).replace("bigdl_tpu_torch", "bigdl_tpu") \
            == str(je.value)


WIDTHS = """
input: "data"
layer { name: "c" type: "Convolution" bottom: "data" top: "c"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1 } }
layer { name: "c2" type: "Convolution" bottom: "c" top: "c2"
  _n_in: 4 convolution_param { num_output: 2 kernel_size: 1 } }
layer { name: "ip" type: "InnerProduct" bottom: "c2" top: "ip"
  _n_in: 32 inner_product_param { num_output: 3 } }
"""


def test_caffe_prototxt_alone_takes_the_reference_s_widths(tmp_path):
    """Without a caffemodel a convolution's input width is its ``_n_in``,
    else 3, and an InnerProduct's ``_n_in``, else 1, in both packages;
    with the reference's weights carried over, the outputs agree. A net
    whose widths are not so fails in both at load."""
    proto = _write(tmp_path / "w.prototxt", WIDTHS)
    x = np.random.default_rng(2).standard_normal((2, 3, 4, 4)) \
        .astype(np.float32)
    tg = tcaffe.load_caffe(proto, sample_input=x.shape, device="cpu")
    jg = jcaffe.load_caffe(proto, sample_input=x.shape)
    convs = [n.module for n in tg.exec_order
             if isinstance(n.module, tnn.SpatialConvolution)]
    assert [c.n_input_plane for c in convs] == [3, 4]
    params, state = _graph_params(jg)
    tg.load_state_dict(convert.module_params_from_jax(tg, params, state))
    _close(_port_out(tg, x), _jax_out(jg, x))
    bad = _write(tmp_path / "bad.prototxt", WIDTHS.replace("_n_in: 32", ""))
    with pytest.raises(Exception):
        jcaffe.load_caffe(bad, sample_input=x.shape)
    with pytest.raises(RuntimeError):
        tcaffe.load_caffe(bad, sample_input=x.shape, device="cpu")
    # without sample_input neither package builds, and so neither fails
    jcaffe.load_caffe(bad)
    tcaffe.load_caffe(bad, device="cpu")


def test_weights_wait_for_sample_input(tmp_path):
    """``load_caffe`` without ``sample_input`` records the blobs and
    ``apply_caffe_weights`` copies them in, as the reference's build
    does."""
    rng = np.random.default_rng(4)
    w = rng.standard_normal((4, 3, 3, 3)).astype(np.float32)
    net = {"layer": [{"name": "c", "type": "Convolution",
                      "blobs": [_blob(w), _blob(np.zeros(4))]}]}
    proto = _write(tmp_path / "a.prototxt", WIDTHS.split('layer { name: "c2"')
                   [0])
    model = _write(tmp_path / "a.caffemodel", twire.encode(net, tcaffe.NET))
    g = tcaffe.load_caffe(proto, model, device="cpu")
    conv = g.exec_order[1].module
    assert not np.array_equal(conv.weight.detach().numpy(), w)
    tcaffe.apply_caffe_weights(g)
    np.testing.assert_array_equal(conv.weight.detach().numpy(), w)


# ----------------------------------------- routes over a loaded graph --

TOWER = """
input: "data"
layer { name: "stem" type: "Convolution" bottom: "data" top: "stem"
  convolution_param { num_output: 8 kernel_size: 3 pad: 1 } }
layer { name: "a" type: "Convolution" bottom: "stem" top: "a" _n_in: 8
  convolution_param { num_output: 8 kernel_size: 1 } }
layer { name: "b1" type: "Convolution" bottom: "stem" top: "b1" _n_in: 8
  convolution_param { num_output: 4 kernel_size: 1 } }
layer { name: "b2" type: "Convolution" bottom: "b1" top: "b2" _n_in: 4
  convolution_param { num_output: 8 kernel_size: 3 pad: 1 } }
layer { name: "p" type: "Pooling" bottom: "stem" top: "p"
  pooling_param { pool: MAX kernel_size: 3 stride: 1 pad: 1 } }
layer { name: "cat" type: "Concat" bottom: "a" bottom: "b2" bottom: "p"
  top: "cat" }
layer { name: "pool" type: "Pooling" bottom: "cat" top: "pool"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "post" type: "Convolution" bottom: "pool" top: "post"
  _n_in: 24 convolution_param { num_output: 8 kernel_size: 3 pad: 1 } }
"""


def _tower_sequential(dev="cpu"):
    def conv(i, o, k, p=0):
        return tnn.SpatialConvolution(i, o, k, k, 1, 1, p, p, device=dev)
    return tnn.Sequential(
        conv(3, 8, 3, 1),
        tnn.Concat(1).add(conv(8, 8, 1))
        .add(tnn.Sequential(conv(8, 4, 1), conv(4, 8, 3, 1)))
        .add(tnn.SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil()),
        tnn.SpatialMaxPooling(3, 3, 2, 2).ceil(),
        conv(24, 8, 3, 1)).reset(0)


@pytest.mark.parametrize("dtype", [None, torch.float32, torch.bfloat16])
def test_routes_over_a_loaded_graph(tmp_path, dtype):
    """``layer_walk``/``conv_routes``/``model_flops`` over a Caffe-loaded
    graph with a 3x3 tower and a join equal those of the same net built as
    a Sequential of Concats (the first convolution, reading the images,
    takes no input gradient; a join's (h, w) is its first input's). The
    prototxt gives the widths (``_n_in``): without a caffemodel the
    loader infers none."""
    g = tcaffe.load_caffe(_write(tmp_path / "t.prototxt", TOWER),
                          device="cpu")
    seq = _tower_sequential()
    for hw in ((16, 16), (15, 17)):
        assert conv_routes(g, hw, dtype) == conv_routes(seq, hw, dtype)
        assert model_flops(g, hw) == model_flops(seq, hw)
        walked = [(type(m).__name__, hw_, grad)
                  for m, hw_, grad in layer_walk(g, hw)
                  if isinstance(m, tnn.SpatialConvolution)]
        assert sorted(walked) == sorted(
            (type(m).__name__, hw_, grad) for m, hw_, grad in
            layer_walk(seq, hw) if isinstance(m, tnn.SpatialConvolution))
    # 3 kernel-route convolutions: the stem (no input gradient), b2, post
    assert conv_routes(g, (16, 16)) == {"i2c": 5, "k9": 0, "library": 2}


def test_routes_count_padding_and_deconvolution_sizes():
    """``SpatialZeroPadding`` and ``SpatialFullConvolution`` change (h, w)
    on the walk: a 3x3 convolution after them is counted at its true
    input size."""
    m = tnn.Sequential(
        tnn.SpatialZeroPadding(1, 2, 3, 0),
        tnn.SpatialFullConvolution(3, 8, 3, 3, 2, 2, 1, 1, 1, 1,
                                   device="cpu"),
        tnn.SpatialConvolution(8, 8, 3, 3, 1, 1, 1, 1, device="cpu")).reset(0)
    walk = layer_walk(m, (5, 6))
    assert [hw for _, hw, _ in walk] == [(5, 6), (8, 9), (16, 18)]
    with torch.no_grad():
        y = m[1](m[0](torch.zeros(1, 3, 5, 6)))
    assert tuple(y.shape[2:]) == (16, 18)


# --------------------------------------------- the BVLC GoogLeNet slice --

def test_googlenet_slice_written_as_the_chip_run_writes_it(tmp_path):
    """Two inception modules of BVLC GoogLeNet's layout, written the way
    ``chip_smoke.py``'s ``load_interop`` writes the whole net (its
    ``googlenet_prototxt`` and ``caffemodel_bytes``) from the port's
    Inception-v1 layers: both packages load it to the source model's
    outputs; ``load_weights_into`` a fresh source copies every weight;
    the loaded graph's conv routes are the source's."""
    import chip_smoke
    from bigdl_tpu_torch.models.inception import _stem_v1, inception_module
    torch.manual_seed(0)
    src = (_stem_v1("cpu")
           .add(inception_module(192, ([64], [96, 128], [16, 32], [32]),
                                 "3a", device="cpu"))
           .add(inception_module(256, ([128], [128, 192], [32, 96], [64]),
                                 "3b", device="cpu"))
           .add(tnn.SpatialAveragePooling(8, 8, 1, 1))
           .add(tnn.Dropout(0.4)).add(tnn.Reshape((480,)))
           .add(tnn.Linear(480, 10, device="cpu")
                .set_name("loss3/classifier"))
           .add(tnn.LogSoftMax())).reset(5)
    text = chip_smoke.googlenet_prototxt(
        2, image=64, modules=chip_smoke.GOOGLENET_MODULES[:2], pool5=8,
        classes=10)
    proto = _write(tmp_path / "g.prototxt", text)
    model = _write(tmp_path / "g.caffemodel",
                   chip_smoke.caffemodel_bytes(src))
    x = np.random.default_rng(9).standard_normal((2, 3, 64, 64)) \
        .astype(np.float32)
    want = _port_out(src, x)
    tg, _, y, jy = _both(proto, model, x.shape, x)
    _close(y, want)
    _close(jy, want)
    assert conv_routes(tg, (64, 64), torch.bfloat16) \
        == conv_routes(src, (64, 64), torch.bfloat16)
    names = [n.module.get_name() for n in tg.exec_order]
    assert names[1] == "conv1/7x7_s2" and names[-1] == "loss3/loss3"
    assert "inception_3b/output" in names
    fresh = _stem_v1("cpu")
    fresh.add(inception_module(192, ([64], [96, 128], [16, 32], [32]), "3a",
                               device="cpu"))
    fresh.add(inception_module(256, ([128], [128, 192], [32, 96], [64]), "3b",
                               device="cpu"))
    fresh.add(tnn.Linear(480, 10, device="cpu").set_name("loss3/classifier"))
    fresh.reset(6)
    _, copied = tcaffe.CaffeLoader(proto, model).load_weights_into(fresh)
    assert len(copied) == 3 + 2 * 6 + 1
    want_sd = {k: v for k, v in src.state_dict().items()}
    for (k, v), (k2, v2) in zip(fresh.state_dict().items(),
                                want_sd.items()):
        torch.testing.assert_close(v, v2, rtol=0, atol=0)


def test_load_weights_into_match_all(tmp_path):
    """``match_all`` names every convolution and Linear without a blob;
    without it the others are copied alone."""
    net = {"layer": [{"name": "conv1/7x7_s2", "type": "Convolution",
                      "blobs": [_blob(np.ones((64, 3, 7, 7)))]}]}
    model = _write(tmp_path / "m.caffemodel", twire.encode(net, tcaffe.NET))
    m = Inception_v1_NoAuxClassifier(10, device="cpu")
    loader = tcaffe.CaffeLoader(None, model)
    with pytest.raises(ValueError, match="no caffe weights for layers"):
        loader.load_weights_into(m)
    _, copied = loader.load_weights_into(m, match_all=False)
    assert copied == ["conv1/7x7_s2"]
    assert float(m[0].weight.detach().min()) == 1.0
    assert os.path.getsize(model) > 64 * 3 * 49 * 4
