"""A TF-slim VGG training graph (``chip_smoke.vgg16_tf_train_graph``: the
graph TF 1.x's ``tf.gradients`` writes for the mean softmax cross entropy,
its gradients as outputs) imported by the port and by the JAX reference
from the same bytes, on the CPU, at a small size: two one-convolution
blocks, 32 x 32 images, fc 64, 10 classes, batch 4.

The port's graph is fed from a TFRecord of tf.Examples written here
(``ParseExample`` -> ``DecodeRaw`` -> ``Reshape`` -> ``Cast`` -> ``Mul``);
the reference cannot run its host-side ops inside a graph, so it is held
through the same graph with a placeholder front, which the port's gives
bit for bit. The loss and every gradient output agree with the
reference's import, with ``jax.grad`` of the reference's forward graph
and with the port's autograd of its forward import, within 1e-4 of each
output's largest magnitude. The route table counts the graph's
``Conv2DBackpropInput`` nodes as flip launches.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from bigdl_tpu.interop.tf_loader import load_tf as jload
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.interop import (TFRecordWriter, TensorflowLoader,
                                     tf_record_iterator)
from bigdl_tpu_torch.interop import load_tf as tload
from bigdl_tpu_torch.models import conv_routes
from bigdl_tpu_torch.ops import tf_ops as tt

REL = 1e-4
B, HW, C = 4, 32, 10
SMALL = dict(blocks=((1, 8), (1, 16)), image=HW, fc=64, classes=C, seed=3)


def _close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, err / scale


@pytest.fixture(autouse=True)
def _keep_library_calls():
    """Leave ``SpatialConvolution.library_calls``, a process-wide counter
    that other test files read, as each test found it."""
    saved = tnn.SpatialConvolution.library_calls.copy()
    yield
    tnn.SpatialConvolution.library_calls.clear()
    tnn.SpatialConvolution.library_calls.update(saved)


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    root = tmp_path_factory.mktemp("vgg_train")
    nodes, var, grads = cs.vgg16_tf_train_graph(batch=B, **SMALL)
    ph, _, _ = cs.vgg16_tf_train_graph(batch=B, front="placeholders",
                                       **SMALL)
    fwd, _ = cs.vgg16_tf_graph(**SMALL)
    files = {}
    for key, ns in (("examples", nodes), ("placeholders", ph),
                    ("forward", fwd)):
        files[key] = str(root / f"{key}.pb")
        with open(files[key], "wb") as f:
            f.write(cs.tf_graphdef(ns))
    cs.write_npy_dir(str(root), var)
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (B, HW, HW, 3), dtype=np.uint8)
    labels = rng.integers(0, C, B)
    path = str(root / "train.tfrecord")
    with TFRecordWriter(path) as w:
        for im, lab in zip(images, labels):
            w.write_example({"image/class/label": np.asarray([lab]),
                             "image/raw": im.tobytes()})
    serialized = np.asarray(list(tf_record_iterator(path)), dtype=object)
    x = images.astype(np.float32) * np.float32(1.0 / 255.0)
    return dict(root=str(root), files=files, var=var, grads=grads,
                images=images, labels=labels.astype(np.int32),
                serialized=serialized, x=x)


def _port_outputs(d):
    """The port's example-fed graph: [loss, logits, decoded images,
    gradients...] on the CPU."""
    outs = ["Mean", "xent/Reshape", "Reshape"] + d["grads"]
    g = tload(d["files"]["examples"], ["serialized"], outs,
              bin_dir=d["root"], sample_input=d["serialized"],
              device="cpu")
    with torch.no_grad():
        return g(d["serialized"])


@pytest.fixture(scope="module")
def port(graphs):
    return _port_outputs(graphs)


def test_example_front_decodes_the_written_images(graphs, port):
    assert port[2].dtype == torch.uint8
    np.testing.assert_array_equal(port[2].numpy(), graphs["images"])
    # the reference imports the same bytes; its host ops decode alike
    outs = ["Mean"] + graphs["grads"]
    jg = jload(graphs["files"]["examples"], ["serialized"], outs,
               bin_dir=graphs["root"])
    mods = {type(n.module).__name__: n.module for n in jg.exec_order}
    parsed = mods["ParseExampleOp"].forward(graphs["serialized"])
    raw = mods["DecodeRaw"].forward(parsed[2])
    np.testing.assert_array_equal(parsed[1], graphs["labels"])
    np.testing.assert_array_equal(raw.reshape(graphs["images"].shape),
                                  graphs["images"])


def test_both_fronts_give_the_same_outputs(graphs, port):
    outs = ["Mean", "xent/Reshape"] + graphs["grads"]
    g = tload(graphs["files"]["placeholders"], ["images", "labels"], outs,
              bin_dir=graphs["root"],
              sample_input=[graphs["x"], graphs["labels"]], device="cpu")
    with torch.no_grad():
        got = g([torch.from_numpy(graphs["x"]),
                 torch.from_numpy(graphs["labels"])])
    want = [port[0], port[1]] + list(port[3:])
    assert len(got) == len(want) == 2 + len(graphs["var"])
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_data_only_graph_puts_host_values_on_its_recorded_device(
        graphs, monkeypatch):
    """The front alone (``ParseExample`` -> ``DecodeRaw`` -> ``Reshape``
    -> ``Cast`` -> ``Mul``, ``OneHot``) holds no parameter or buffer: its
    numeric values go to the device the loader recorded, follow a move of
    the graph, and without a recorded device go to the card (raising
    where there is none), never to the CPU by default."""
    outs = ["Reshape", "images", "OneHot"]
    g = TensorflowLoader(graphs["files"]["examples"], ["serialized"],
                         outs).load(device="cpu")
    assert not list(g.parameters()) and not list(g.buffers())
    assert g.device == torch.device("cpu")
    raw, images, onehot = g(graphs["serialized"])
    np.testing.assert_array_equal(raw.numpy(), graphs["images"])
    _close(images, graphs["x"], 0)
    eye = np.eye(C, dtype=np.float32)
    np.testing.assert_array_equal(onehot.numpy(), eye[graphs["labels"]])
    g.to("meta")
    assert g.device == torch.device("meta")
    got = g(graphs["serialized"])
    assert [t.device.type for t in got] == ["meta"] * 3
    assert [tuple(t.shape) for t in got] == [(B, HW, HW, 3)] * 2 + [(B, C)]
    g.device = None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        g(graphs["serialized"])


def test_loss_and_gradients_match_the_reference_import(graphs, port):
    outs = ["Mean", "xent/Reshape"] + graphs["grads"]
    feed = JT(graphs["x"], graphs["labels"])
    jg = jload(graphs["files"]["placeholders"], ["images", "labels"], outs,
               bin_dir=graphs["root"], sample_input=feed)
    y, _ = jg.apply(jg.params, jg.state, feed, training=False)
    want = [y[k] for k in sorted(y)]
    _close(port[0], want[0], 1e-6)
    _close(port[1], np.asarray(want[1]).reshape(B, C), 1e-6)
    for got, w, name in zip(port[3:], want[2:], graphs["var"]):
        assert tuple(got.shape) == graphs["var"][name].shape
        _close(got, w)


def test_gradients_match_jax_grad_of_the_reference_forward(graphs, port):
    import jax
    import jax.numpy as jnp
    jg = jload(graphs["files"]["forward"], ["input"],
               ["vgg_16/fc8/squeezed"], bin_dir=graphs["root"],
               sample_input=jnp.asarray(graphs["x"]))
    onehot = np.eye(C, dtype=np.float32)[graphs["labels"]]

    def loss(params):
        logits = jg.apply(params, jg.state, jnp.asarray(graphs["x"]),
                          training=False)[0].reshape(B, C)
        return -jnp.mean(jnp.sum(onehot * jax.nn.log_softmax(logits), -1))

    value, grads = jax.value_and_grad(loss)(jg.params)
    _close(port[0], value, 1e-6)
    by_name = {n.module.name: grads[str(n.id)] for n in jg.exec_order}
    for got, name in zip(port[3:], graphs["var"]):
        layer, leaf = name.rsplit("/", 1)
        want = (by_name[f"{layer}/Conv2D"]["weight"] if leaf == "weights"
                else by_name[f"{layer}/BiasAdd"]["bias"])
        _close(got, np.asarray(want).reshape(got.shape))


def test_gradients_match_the_ports_autograd(graphs, port):
    g = tload(graphs["files"]["forward"], ["input"], ["vgg_16/fc8/squeezed"],
              bin_dir=graphs["root"], sample_input=graphs["x"], device="cpu")
    logits = g(torch.from_numpy(graphs["x"])).reshape(B, C)
    onehot = torch.nn.functional.one_hot(
        torch.from_numpy(graphs["labels"]).long(), C)
    loss = -(onehot * torch.log_softmax(logits, -1)).sum(-1).mean()
    mods = {n.module.get_name(): n.module for n in g.exec_order}
    leaves = []
    for name in graphs["var"]:
        layer, leaf = name.rsplit("/", 1)
        leaves.append(mods[f"{layer}/Conv2D"].weight if leaf == "weights"
                      else mods[f"{layer}/BiasAdd"].bias)
    want = torch.autograd.grad(loss, leaves)
    _close(port[0], loss.detach(), 1e-6)
    for got, w, leaf in zip(port[3:], want, leaves):
        if w.dim() == 4:                      # OIHW -> TF's HWIO
            w = w.permute(2, 3, 1, 0)
        _close(got, w.reshape(got.shape))


def test_route_table_of_the_small_training_graph(graphs):
    g = TensorflowLoader(graphs["files"]["examples"], ["serialized"],
                         ["Mean"] + graphs["grads"],
                         bin_dir=graphs["root"]).load(device="cpu")
    split = conv_routes(g, (HW, HW), torch.float32)
    # forward conv1_1 and conv2_1 (3 and 8 input channels) and conv2_1's
    # input gradient (16 channels) on i2c; fc6-8 forward and their input
    # gradients on the library; conv1_1 has no input gradient
    assert split == {"i2c": {"tc": 0, "simt": 3}, "k9": {"tc": 0, "simt": 0},
                     "library": 6}
    before = tnn.SpatialConvolution.library_calls.copy()
    with torch.no_grad():
        g(graphs["serialized"][:B])
    calls = tnn.SpatialConvolution.library_calls - before
    assert sum(calls.values()) == 6
    assert not any(k.startswith("3x3/s1") for k in calls)


def test_route_table_of_vgg16s_training_graph(tmp_path):
    """VGG-16's 13 convolutions at their widths (fc cut to 64 and the
    images to 32 x 32 to keep the test small): 21 k9 and 4 i2c CUDA-core
    launches an evaluation, the 25 of the autograd step of its forward
    import, and 6 library calls (fc6-8, forward and input gradient)."""
    nodes, var, grads = cs.vgg16_tf_train_graph(image=32, fc=64,
                                                classes=10, batch=2)
    pb = str(tmp_path / "vgg16_train.pb")
    with open(pb, "wb") as f:
        f.write(cs.tf_graphdef(nodes))
    cs.write_npy_dir(str(tmp_path), var)
    g = TensorflowLoader(pb, ["serialized"], ["Mean"] + grads,
                         bin_dir=str(tmp_path)).load(device="cpu")
    split = conv_routes(g, (32, 32), torch.float32)
    assert split == {"i2c": {"tc": 0, "simt": 4},
                     "k9": {"tc": 0, "simt": 21}, "library": 6}
    fwd, _ = cs.vgg16_tf_graph(image=32, fc=64, classes=10)
    pbf = str(tmp_path / "vgg16.pb")
    with open(pbf, "wb") as f:
        f.write(cs.tf_graphdef(fwd))
    gf = TensorflowLoader(pbf, ["input"], ["vgg_16/fc8/squeezed"],
                          bin_dir=str(tmp_path)).load(device="cpu")
    auto = conv_routes(gf, (32, 32), torch.float32)
    assert auto["i2c"] == split["i2c"] and auto["k9"] == split["k9"]
    kinds = [type(n.module) for n in g.exec_order]
    assert kinds.count(tt.ConvBackpropInput) == 15
    assert kinds.count(tt.ConvBackpropFilter) == 16
    assert kinds.count(tt.MaxPoolGrad) == 5 and kinds.count(tt.ReluGrad) == 15


def test_op_sweep_graph_matches_the_reference():
    """``chip_smoke.tf_grad_sweep_graph`` (the card's op sweep) without
    its host op, at a small width: every output the reference's, within
    1e-5 of its largest magnitude (integers exactly)."""
    nodes, ins, outs, feed = cs.tf_grad_sweep_graph(0, host=False,
                                                    wide=(1, 6, 72))
    gd = cs.tf_graphdef(nodes)
    tg = tload(gd, ins, outs, device="cpu")
    jg = jload(gd, ins, outs)
    jx = JT(*feed)
    jg.build(0, jx)
    y, _ = jg.apply(jg.params, jg.state, jx, training=False)
    want = [y[k] for k in sorted(y)]
    with torch.no_grad():
        got = tg([torch.from_numpy(a) for a in feed])
    assert len(got) == len(want) == len(outs)
    for name, g, w in zip(outs, got, want):
        w = np.asarray(w)
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            _close(g, w, 1e-5)
    split = conv_routes(tg, (5, 5), torch.float32)
    assert split == {"i2c": {"tc": 0, "simt": 8},
                     "k9": {"tc": 0, "simt": 1}, "library": 0}
