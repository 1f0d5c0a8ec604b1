"""The port's native model format (``bigdl_tpu_torch/utils/serializer.py``)
against the reference's (``bigdl_tpu/utils/serializer.py``) on the CPU.

- every committed corpus file (``tests/data/serializer/``, written by the
  reference's ``scripts/gen_serializer_corpus.py``) loads in the port and
  reproduces its recorded output within the reference's own tolerance
  (``rtol=1e-5, atol=1e-6``); written again by the port, the reference
  loads it and reproduces the same output;
- both directions for LeNet-5 (``Sequential`` and ``Graph``), ResNet-50 at
  32 x 32 (NHWC, evaluation mode), a small PTB model and a small
  ``GPTForCausalLM`` with its head tied and untied: the reference's file
  loads in the port and the port's file in the reference, each forwarding
  the same input to within 1e-5 of the largest output magnitude, with
  equal temperature-0 tokens.
  The reference cannot rebuild any GPT file, its own included: its
  attention is a class local to a function (``MultiHeadAttention.__new__.
  <locals>._MHA``), which its ``_resolve`` cannot import. So for GPT the
  reference refuses the port's file exactly as it refuses its own, and
  its decoder reads the port's file's params into its own model;
- the reference's cases, ported: separable weights, a graph's node
  cycles, BN state, bfloat16 params, the overwrite guard, no pickle or zip
  in the blob, a class or function name outside the tables refused by
  name, a v1 zip refused, and a sharded checkpoint's marker file refused
  once its shard files are gone;
- a ``mem://`` filesystem registered through ``utils/fileio.py`` serves
  ``save_module``, ``load_module``, ``Optimizer._checkpoint`` and
  ``DistriOptimizer._save_driver_state``, as the reference's own test.
"""

import io
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.models.gpt import GPTForCausalLM as JaxGPT
from bigdl_tpu.models.lenet import LeNet5 as JaxLeNet5
from bigdl_tpu.models.lenet import lenet_graph as jax_lenet_graph
from bigdl_tpu.models.resnet import ResNet as JaxResNet
from bigdl_tpu.models.rnn import PTBModel as JaxPTBModel
from bigdl_tpu.utils import protowire as jax_protowire
from bigdl_tpu.utils import serializer as jser
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models.gpt import GPTForCausalLM
from bigdl_tpu_torch.models.lenet import LeNet5, lenet_graph
from bigdl_tpu_torch.models.resnet import ResNet
from bigdl_tpu_torch.models.rnn import PTBModel, SimpleRNN
from bigdl_tpu_torch.utils import fileio, protowire
from bigdl_tpu_torch.utils.serializer import (MAGIC, MODEL_FILE,
                                              load_module, save_module)

ROOT = os.path.join(os.path.dirname(__file__), "data", "serializer")
NAMES = sorted(f[:-6] for f in os.listdir(ROOT) if f.endswith(".bigdl"))
MODEL_REL = 1e-5
GPT_CFG = dict(vocab_size=61, hidden_size=32, n_layers=2, n_heads=4,
               max_position=16)


class _deep:
    """The reference's codec recurses once a message level and leaves the
    limit to its caller: ResNet-50's graph needs more than Python's
    default (the port's codec keeps stacks of its own, so its calls run
    outside)."""

    def __enter__(self):
        self.limit = sys.getrecursionlimit()
        sys.setrecursionlimit(max(self.limit, 20000))

    def __exit__(self, *exc):
        sys.setrecursionlimit(self.limit)


@pytest.fixture(autouse=True)
def _keep_library_calls():
    """Leave ``SpatialConvolution.library_calls``, a process-wide counter
    that other test files read, as each test found it."""
    saved = tnn.SpatialConvolution.library_calls.copy()
    yield
    tnn.SpatialConvolution.library_calls.clear()
    tnn.SpatialConvolution.library_calls.update(saved)


def _port_forward(m, x):
    m.eval()
    with torch.no_grad():
        return m(torch.from_numpy(np.asarray(x))).numpy()


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=0, atol=MODEL_REL * scale,
                               err_msg=what)


# ----------------------------------------------------------- the corpus
def test_corpus_is_whole():
    assert len(NAMES) >= 20, f"corpus shrank: {NAMES}"


@pytest.mark.parametrize("name", NAMES)
def test_corpus_file_loads_in_the_port(name):
    model = load_module(os.path.join(ROOT, f"{name}.bigdl"), device="cpu")
    got = _port_forward(model, np.load(os.path.join(ROOT, f"{name}.in.npy")))
    np.testing.assert_allclose(
        got, np.load(os.path.join(ROOT, f"{name}.out.npy")), rtol=1e-5,
        atol=1e-6, err_msg=f"golden fixture '{name}' forward drifted")


@pytest.mark.parametrize("name", NAMES)
def test_port_written_corpus_file_loads_in_the_reference(name, tmp_path):
    model = load_module(os.path.join(ROOT, f"{name}.bigdl"), device="cpu")
    p = str(tmp_path / f"{name}.bigdl")
    save_module(model, p)
    ref = jser.load_module(p).evaluate()
    got = np.asarray(ref.forward(jnp.asarray(
        np.load(os.path.join(ROOT, f"{name}.in.npy")))))
    np.testing.assert_allclose(
        got, np.load(os.path.join(ROOT, f"{name}.out.npy")), rtol=1e-5,
        atol=1e-6)


def test_port_writes_the_reference_bytes_for_a_file_it_read(tmp_path):
    """Where the reference's classes have not changed since the corpus was
    written, the port's file of a loaded model is the committed file,
    byte for byte (attributes, their order, the tensor table)."""
    same = []
    for name in NAMES:
        model = load_module(os.path.join(ROOT, f"{name}.bigdl"),
                            device="cpu")
        p = tmp_path / f"{name}.bigdl"
        save_module(model, str(p))
        if p.read_bytes() == open(os.path.join(ROOT, f"{name}.bigdl"),
                                  "rb").read():
            same.append(name)
    assert len(same) >= 18, sorted(set(NAMES) - set(same))


# ------------------------------------------------------ models, both ways
def _reference_lenet(builder, x):
    jm = builder(10)
    jm.build(3, x.shape)
    return jm.evaluate()


@pytest.mark.parametrize("graph", [False, True])
def test_lenet_both_directions(graph, tmp_path):
    x = np.random.default_rng(0).standard_normal((2, 1, 28, 28)).astype(
        np.float32)
    tm = (lenet_graph if graph else LeNet5)(10, device="cpu", seed=4)
    save_module(tm, str(tmp_path / "port.bigdl"))
    ref = jser.load_module(str(tmp_path / "port.bigdl")).evaluate()
    _close(np.asarray(ref.forward(jnp.asarray(x))), _port_forward(tm, x),
           "reference load of the port's LeNet")
    jm = _reference_lenet(jax_lenet_graph if graph else JaxLeNet5, x)
    jser.save_module(jm, str(tmp_path / "ref.bigdl"))
    back = load_module(str(tmp_path / "ref.bigdl"), device="cpu")
    assert type(back) is type(tm)
    _close(_port_forward(back, x), np.asarray(jm.forward(jnp.asarray(x))),
           "port load of the reference's LeNet")


def test_resnet50_both_directions(tmp_path):
    """The port's ResNet is written as the reference builds it, a Graph of
    its named layers, which the reference loads as a Graph and the port
    builds back into a ``ResNet`` (the graph records the constructor's
    values); the reference's own ResNet file is a Graph in both."""
    tm = ResNet(10, 50, data_set="ImageNet", format="NHWC", device="cpu")
    tm.load_state_dict(convert.init_resnet_params(tm, seed=0))
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    want = _port_forward(tm, x)
    save_module(tm, str(tmp_path / "port.bigdl"))
    with _deep():
        ref = jser.load_module(str(tmp_path / "port.bigdl")).evaluate()
    assert type(ref).__name__ == "Graph"
    ref_out = np.asarray(ref.forward(jnp.asarray(x)))
    _close(ref_out, want, "reference load of the port's ResNet-50")
    jm = JaxResNet(10, 50, data_set="ImageNet", format="NHWC")
    jm.build(5, x.shape)
    jm.evaluate()
    with _deep():
        jser.save_module(jm, str(tmp_path / "ref.bigdl"))
    back = load_module(str(tmp_path / "ref.bigdl"), device="cpu")
    assert isinstance(back, tnn.Graph)
    _close(_port_forward(back, x), np.asarray(jm.forward(jnp.asarray(x))),
           "port load of the reference's ResNet-50")
    fresh = load_module(str(tmp_path / "port.bigdl"), device="cpu")
    assert isinstance(fresh, ResNet) and fresh.training == tm.training
    assert (fresh.class_num, fresh.depth, fresh.format) == (10, 50, "NHWC")
    for (k, a), (k2, b) in zip(tm.state_dict().items(),
                               fresh.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    np.testing.assert_array_equal(_port_forward(fresh, x), want)


@pytest.mark.parametrize("tie", [True, False])
def test_gpt_both_directions(tie, tmp_path):
    ids = np.random.default_rng(2).integers(0, 61, (2, 8)).astype(np.int32)
    jm = JaxGPT(**GPT_CFG, tie_embeddings=tie)
    params, _ = jm.setup(jax.random.PRNGKey(3), None)
    jm.params, jm.state = params, ()
    jser.save_module(jm, str(tmp_path / "ref.bigdl"))
    with pytest.raises(AttributeError, match="<locals>") as ref_own:
        jser.load_module(str(tmp_path / "ref.bigdl"))
    want = np.asarray(jm.apply(params, (), jnp.asarray(ids))[0])
    want_tokens = np.asarray(jm.generate(params, jnp.asarray(ids[:1]), 6))
    # the reference's file in the port
    tm = load_module(str(tmp_path / "ref.bigdl"), device="cpu")
    assert tm.tie_embeddings is tie and (tm.head is None) is tie
    _close(_port_forward(tm, ids.astype(np.int64)), want,
           "port load of the reference's GPT")
    got_tokens = tm.generate(torch.from_numpy(ids[:1]).long(), 6,
                             temperature=0.0).numpy()
    np.testing.assert_array_equal(got_tokens, want_tokens)
    # the port's file in the reference
    save_module(tm, str(tmp_path / "port.bigdl"))
    with pytest.raises(AttributeError) as ref_port:
        jser.load_module(str(tmp_path / "port.bigdl"))
    assert str(ref_port.value) == str(ref_own.value)
    msg = jax_protowire.decode((tmp_path / "port.bigdl").read_bytes(),
                               jser.MODEL_FILE)
    ref_params = jser._Decoder(msg["tensors"]).value(msg["params"])
    _close(np.asarray(jm.apply(ref_params, (), jnp.asarray(ids))[0]), want,
           "the reference's decode of the port's GPT params")
    np.testing.assert_array_equal(
        np.asarray(jm.generate(ref_params, jnp.asarray(ids[:1]), 6)),
        want_tokens)


def test_bert_both_directions(tmp_path):
    """BERT as GPT: the reference's ``BertForMLM`` file builds the port's
    model with the same logits; the reference refuses the port's file as
    it refuses its own (its attention is a local class) and its decoder
    reads the port's params into its own model."""
    from bigdl_tpu.models.transformer import BertForMLM as JaxBert
    from bigdl_tpu_torch.models.transformer import BertForMLM
    ids = np.random.default_rng(4).integers(0, 31, (2, 8)).astype(np.int32)
    jm = JaxBert(vocab_size=31, hidden_size=16, n_layers=2, n_heads=2,
                 max_position=8)
    params, _ = jm.setup(jax.random.PRNGKey(5), None)
    jm.params, jm.state = params, ()
    want = np.asarray(jm.apply(params, (), jnp.asarray(ids))[0])
    jser.save_module(jm, str(tmp_path / "ref.bigdl"))
    tm = load_module(str(tmp_path / "ref.bigdl"), device="cpu")
    assert isinstance(tm, BertForMLM) and len(tm.bert.layers) == 2
    _close(_port_forward(tm, ids.astype(np.int64)), want,
           "port load of the reference's BERT")
    save_module(tm, str(tmp_path / "port.bigdl"))
    with pytest.raises(AttributeError, match="<locals>"):
        jser.load_module(str(tmp_path / "port.bigdl"))
    msg = jax_protowire.decode((tmp_path / "port.bigdl").read_bytes(),
                               jser.MODEL_FILE)
    ref_params = jser._Decoder(msg["tensors"]).value(msg["params"])
    _close(np.asarray(jm.apply(ref_params, (), jnp.asarray(ids))[0]), want,
           "the reference's decode of the port's BERT params")


def test_recurrent_models_both_directions(tmp_path):
    """The PTB model (``LookupTable``, ``Recurrent(MultiRNNCell)``,
    ``TimeDistributed``) both ways; ``SimpleRNN``'s ``RnnCell`` holds its
    activation as a function value, written as the reference's
    ``jax.numpy:tanh`` through the function table (the reference's own
    encoder cannot write its jitted ``tanh``, so that direction is the
    port's file alone)."""
    x = np.random.default_rng(3).integers(1, 50, (2, 5))
    jx = jnp.asarray(x.astype(np.float32))
    for tm in (PTBModel(50, 8, 50, 2, device="cpu").reset(3),
               SimpleRNN(50, 8, 50, device="cpu").reset(3)):
        save_module(tm, str(tmp_path / "port.bigdl"), overwrite=True)
        ref = jser.load_module(str(tmp_path / "port.bigdl")).evaluate()
        _close(np.asarray(ref.forward(jx)), _port_forward(tm, x),
               "reference load of the port's recurrent model")
    jm = JaxPTBModel(50, 8, 50, 2)
    jm.build(1, x.shape)
    jm.evaluate()
    jser.save_module(jm, str(tmp_path / "ref.bigdl"))
    back = load_module(str(tmp_path / "ref.bigdl"), device="cpu")
    _close(_port_forward(back, x), np.asarray(jm.forward(jx)),
           "port load of the reference's PTB model")


# --------------------------------------------------- the reference's cases
def _mlp():
    return tnn.Sequential(tnn.Linear(8, 16, device="cpu"), tnn.ReLU(),
                          tnn.Linear(16, 4, device="cpu"),
                          tnn.LogSoftMax()).reset(3)


def test_sequential_roundtrip(tmp_path):
    m = _mlp()
    x = np.random.RandomState(0).randn(5, 8).astype("float32")
    m.save_module(str(tmp_path / "m.bigdl"))
    back = load_module(str(tmp_path / "m.bigdl"), device="cpu")
    np.testing.assert_array_equal(_port_forward(back, x),
                                  _port_forward(m, x))


def test_lenet_with_separable_weights(tmp_path):
    x = np.random.RandomState(1).randn(2, 1, 28, 28).astype("float32")
    m = LeNet5(10, device="cpu")
    save_module(m, str(tmp_path / "model.bigdl"),
                weight_path=str(tmp_path / "model.weights"))
    msg = protowire.decode((tmp_path / "model.bigdl").read_bytes(),
                           MODEL_FILE)
    assert msg["magic"] == MAGIC and not msg.get("tensors")
    assert msg["weights_file"] == "model.weights"
    assert os.path.getsize(tmp_path / "model.weights") > 1000
    back = load_module(str(tmp_path / "model.bigdl"), device="cpu")
    np.testing.assert_array_equal(_port_forward(back, x),
                                  _port_forward(m, x))
    ref = jser.load_module(str(tmp_path / "model.bigdl")).evaluate()
    _close(np.asarray(ref.forward(jnp.asarray(x))), _port_forward(m, x),
           "reference load of separable weights")


def test_graph_model_cycles(tmp_path):
    """Nodes link to their inputs: a diamond's shared parent is one object
    after the round trip, and the graph keeps the file's node ids."""
    inp = tnn.Input()
    h = tnn.Linear(6, 6, device="cpu")(inp)
    out = tnn.CAddTable()(tnn.ReLU()(h), tnn.Tanh()(h))
    m = tnn.Graph([inp], [out]).reset(2)
    x = np.random.RandomState(2).randn(3, 6).astype("float32")
    save_module(m, str(tmp_path / "g.bigdl"))
    back = load_module(str(tmp_path / "g.bigdl"), device="cpu")
    np.testing.assert_array_equal(_port_forward(back, x),
                                  _port_forward(m, x))
    assert [n.id for n in back.exec_order] == [n.id for n in m.exec_order]
    join = back.exec_order[-1]
    assert join.prev_nodes[0].prev_nodes[0] is join.prev_nodes[1] \
        .prev_nodes[0]


def test_a_deep_graph_round_trips_at_the_default_recursion_limit(
        tmp_path):
    """A chain of 500 nodes nests its records and messages a few levels
    a node deep (the reference's codec, at one Python frame a level,
    needs a raised limit past ~170); the port's walks them on stacks of
    its own, so save and load run at Python's default limit and leave it
    as it was."""
    limit = sys.getrecursionlimit()
    assert limit <= 1000
    node = inp = tnn.Input()
    for i in range(500):
        node = (tnn.Tanh() if i % 2 else tnn.AddConstant(0.01))(node)
    m = tnn.Graph([inp], [node])
    x = np.random.RandomState(4).randn(2, 3).astype("float32")
    save_module(m, str(tmp_path / "deep.bigdl"))
    back = load_module(str(tmp_path / "deep.bigdl"), device="cpu")
    assert sys.getrecursionlimit() == limit
    assert len(back.exec_order) == len(m.exec_order)
    np.testing.assert_array_equal(_port_forward(back, x),
                                  _port_forward(m, x))


def test_batchnorm_state_roundtrip(tmp_path):
    m = tnn.Sequential(tnn.Linear(4, 8, device="cpu"),
                       tnn.BatchNormalization(8, device="cpu")).reset(4)
    x = torch.from_numpy(np.random.RandomState(3).randn(16, 4)
                         .astype("float32"))
    m.train()
    m(x)                          # running statistics move
    save_module(m, str(tmp_path / "bn.bigdl"))
    back = load_module(str(tmp_path / "bn.bigdl"), device="cpu")
    assert back.training and back[1].training    # train_mode kept
    for k, v in m.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    ref = jser.load_module(str(tmp_path / "bn.bigdl"))
    np.testing.assert_array_equal(np.asarray(ref.state[1]["running_var"]),
                                  m[1].running_var.numpy())


def test_bf16_params(tmp_path):
    m = tnn.Linear(4, 4, device="cpu").reset(6).to(torch.bfloat16)
    save_module(m, str(tmp_path / "m.bigdl"))
    back = load_module(str(tmp_path / "m.bigdl"), device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in back.parameters())
    for k, v in m.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    ref = jser.load_module(str(tmp_path / "m.bigdl"))
    assert all(v.dtype == jnp.bfloat16
               for v in jax.tree_util.tree_leaves(ref.params))
    jm = jnn.Linear(4, 4).build(6)
    jm.params = jax.tree_util.tree_map(lambda v: v.astype(jnp.bfloat16),
                                       jm.params)
    jser.save_module(jm, str(tmp_path / "j.bigdl"))
    back = load_module(str(tmp_path / "j.bigdl"), device="cpu")
    assert back.weight.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        back.weight.detach().float().numpy().T,
        np.asarray(jm.params["weight"].astype(jnp.float32)))


def test_bf16_gpt_loads_as_bf16(tmp_path):
    """A bfloat16 ``GPTForCausalLM`` file builds a bfloat16 model (the
    constructor gets the file's type), its weights bit for bit and its
    greedy tokens the saved model's; the reference decodes bfloat16
    leaves from it."""
    m = GPTForCausalLM(**GPT_CFG, tie_embeddings=False, device="cpu")
    m.load_state_dict(convert.init_params(m, seed=5))
    m = m.to(torch.bfloat16)
    save_module(m, str(tmp_path / "g.bigdl"))
    back = load_module(str(tmp_path / "g.bigdl"), device="cpu")
    assert {t.dtype for t in back.state_dict().values()} == {torch.bfloat16}
    for k, v in m.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    ids = torch.from_numpy(np.random.default_rng(6).integers(0, 61, (1, 5)))
    assert torch.equal(back.generate(ids, 4), m.generate(ids, 4))
    msg = jax_protowire.decode((tmp_path / "g.bigdl").read_bytes(),
                               jser.MODEL_FILE)
    tree = jser._Decoder(msg["tensors"]).value(msg["params"])
    assert {v.dtype for v in jax.tree_util.tree_leaves(tree)} \
        == {jnp.dtype(jnp.bfloat16)}


def test_int8_gpt_round_trips(tmp_path):
    """A GPT served from int8 weights (``nn.quantize_model``) is written
    with the reference's ``{"q", "scale"}`` leaves and loads back int8,
    with the same weights and logits."""
    m = GPTForCausalLM(**GPT_CFG, device="cpu")
    m.load_state_dict(convert.init_params(m, seed=7))
    tnn.quantize_model(m)
    save_module(m, str(tmp_path / "q.bigdl"))
    back = load_module(str(tmp_path / "q.bigdl"), device="cpu")
    assert isinstance(back.gpt.layers[0].fc1, tnn.Int8Linear)
    for k, v in m.state_dict().items():
        assert back.state_dict()[k].dtype == v.dtype, k
        assert torch.equal(back.state_dict()[k], v), k
    ids = np.random.default_rng(8).integers(0, 61, (2, 6))
    np.testing.assert_array_equal(_port_forward(back, ids),
                                  _port_forward(m, ids))
    msg = jax_protowire.decode((tmp_path / "q.bigdl").read_bytes(),
                               jser.MODEL_FILE)
    tree = jser._Decoder(msg["tensors"]).value(msg["params"])
    fc1 = tree["gpt"]["layers"][0]["fc1"]["weight"]
    assert set(fc1) == {"q", "scale"} and fc1["q"].dtype == jnp.int8


def test_overwrite_guard(tmp_path):
    m = tnn.Linear(2, 2, device="cpu").reset(7)
    p = str(tmp_path / "m.bigdl")
    save_module(m, p)
    with pytest.raises(FileExistsError):
        save_module(m, p)
    save_module(m, p, overwrite=True)


def test_no_pickle_in_format(tmp_path):
    m = tnn.Linear(2, 2, device="cpu").reset(8)
    p = str(tmp_path / "m.bigdl")
    save_module(m, p)
    blob = open(p, "rb").read()
    assert b"pickle" not in blob and blob[:2] != b"PK"


def _record_named(tmp_path, old, new):
    """A LeNet file whose records name ``new`` in place of ``old``."""
    p = tmp_path / "m.bigdl"
    save_module(LeNet5(10, device="cpu"), str(p))
    blob = p.read_bytes()
    assert old.encode() in blob and len(old) == len(new)
    p.write_bytes(blob.replace(old.encode(), new.encode()))
    return str(p)


@pytest.mark.parametrize("old, new", [
    ("bigdl_tpu.nn.activation:Tanh", "bigdl_tpu.nn.activation:Evil"),
    ("bigdl_tpu.nn.linear:Linear", "os:system.__class__.Linear"),
    ("bigdl_tpu.nn.init_methods:Xavier", "bigdl_tpu.nn.init_methods:Xavie0"),
])
def test_unknown_class_name_is_refused_by_name(tmp_path, old, new):
    p = _record_named(tmp_path, old, new)
    with pytest.raises(ValueError, match="refusing to load") as e:
        load_module(p, device="cpu")
    assert new in str(e.value)


def test_unknown_function_name_is_refused_by_name(tmp_path):
    from bigdl_tpu_torch.utils import serializer as tser
    enc = tser._Encoder()
    msg = {"magic": MAGIC, "module": {"kind": tser._FUNC,
                                      "s": "builtins:eval"},
           "tensors": enc.tensors}
    p = tmp_path / "f.bigdl"
    p.write_bytes(protowire.encode(msg, MODEL_FILE))
    with pytest.raises(ValueError, match="'builtins:eval'"):
        load_module(str(p), device="cpu")
    with pytest.raises(TypeError, match="cannot serialize"):
        save_module(tnn.Sequential(torch.nn.GELU()), str(tmp_path / "x"))


def test_v1_zip_and_foreign_files_are_refused(tmp_path):
    (tmp_path / "v1").write_bytes(b"PK\x03\x04rest")
    with pytest.raises(ValueError, match="v1"):
        load_module(str(tmp_path / "v1"), device="cpu")
    (tmp_path / "junk").write_bytes(b"garbled model")
    (tmp_path / "other").write_bytes(protowire.encode(
        {"magic": "another.format.v1"}, MODEL_FILE))
    for name in ("junk", "other"):
        with pytest.raises(ValueError, match="not a bigdl_tpu model file"):
            load_module(str(tmp_path / name), device="cpu")


def test_sharded_marker_is_refused_once_its_shards_are_gone(tmp_path):
    m = _mlp()
    m._sharded_weights_marker = {"neval": 3, "nprocs": 1}
    save_module(m, str(tmp_path / "model.3"))
    (tmp_path / "shard.3.p0").write_bytes(b"x")
    back = load_module(str(tmp_path / "model.3"), device="cpu")
    assert back._sharded_weights_marker == {"neval": 3, "nprocs": 1}
    assert jser.load_module(str(tmp_path / "model.3")) \
        ._sharded_weights_marker == {"neval": 3, "nprocs": 1}
    os.remove(tmp_path / "shard.3.p0")
    with pytest.raises(ValueError, match="STALE placeholder"):
        load_module(str(tmp_path / "model.3"), device="cpu")
    with pytest.raises(ValueError, match="STALE placeholder"):
        jser.load_module(str(tmp_path / "model.3"))


def test_entry_point_defaults_to_the_card(tmp_path):
    save_module(_mlp(), str(tmp_path / "m.bigdl"))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default loads onto it")
    with pytest.raises((RuntimeError, AssertionError)):
        load_module(str(tmp_path / "m.bigdl"))


# ------------------------------------------------ the filesystem registry
def test_remote_filesystem_hook():
    """``mem://`` paths route through a registered filesystem (reference
    ``utils/File.scala:26``)."""
    from bigdl_tpu_torch import optim as topt
    from bigdl_tpu_torch.optim.optimizer import Optimizer
    from bigdl_tpu_torch.parallel import DistriOptimizer

    blobs = {}

    class MemFS:
        @staticmethod
        def open(path, mode="rb"):
            if "w" in mode:
                buf = io.BytesIO()
                real_close = buf.close

                def close():
                    blobs[path] = buf.getvalue()
                    real_close()
                buf.close = close
                return buf
            return io.BytesIO(blobs[path])

        @staticmethod
        def exists(path):
            return path in blobs

        @staticmethod
        def makedirs(path):
            pass

        @staticmethod
        def listdir(path):
            return [b.rsplit("/", 1)[-1] for b in blobs
                    if b.startswith(path.rstrip("/") + "/")]

    fileio.register_filesystem("mem", MemFS)
    model = tnn.Sequential(tnn.Linear(4, 3, device="cpu"),
                           tnn.Tanh()).reset(0)
    x = np.random.RandomState(0).randn(2, 4).astype(np.float32)
    save_module(model, "mem://bucket/model.bigdl",
                weight_path="mem://bucket/model.weights")
    assert {"mem://bucket/model.bigdl", "mem://bucket/model.weights"} \
        <= set(blobs)
    back = load_module("mem://bucket/model.bigdl", device="cpu")
    np.testing.assert_array_equal(_port_forward(back, x),
                                  _port_forward(model, x))

    opt = Optimizer.__new__(Optimizer)
    opt.checkpoint_path = "mem://bucket/ckpt"
    opt.model = model
    opt.optim_method = topt.SGD(learningrate=0.1)
    opt._ckpt_thread, opt._ckpt_exc = None, []
    opt._checkpoint(7, opt.optim_method.init_state(
        dict(model.named_parameters())))
    opt._join_checkpoint()
    assert "mem://bucket/ckpt/model.7" in blobs
    assert "mem://bucket/ckpt/optimMethod.7" in blobs
    back = load_module("mem://bucket/ckpt/model.7", device="cpu")
    np.testing.assert_array_equal(_port_forward(back, x),
                                  _port_forward(model, x))

    dopt = DistriOptimizer.__new__(DistriOptimizer)
    dopt.checkpoint_path = "mem://bucket/ckpt"
    dopt._save_driver_state({"epoch": 2, "neval": 7, "loss": 0.5,
                             "score": None, "epoch_finished": False})
    assert "mem://bucket/ckpt/driverState.7" in blobs
    assert "mem://bucket/ckpt/driverState.latest" in blobs
    assert "model.7" in fileio.file_listdir("mem://bucket/ckpt")
    assert pickle.loads(blobs["mem://bucket/ckpt/driverState.7"])[
        "neval"] == 7
