"""Every port module class goes through the native model format: the
layer table covers each class of the port's ``nn``, ``ops``, ``models``
and TF loader modules, each name it writes is a class of the reference,
and a module of each class saved by the port loads back in the port with
the same type, attributes, children and weights (``CASES``); 25 classes
and the tree-LSTM sentiment model forward alike through both packages'
loads. Trained models (BERT, a TF-imported BERT graph, a convolutional
LSTM) checkpoint through ``DistriOptimizer`` and resume through its
retry, on the CPU."""

import importlib
import os

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn, ops
from bigdl_tpu_torch.ops import tf_ops
from bigdl_tpu_torch.interop import tf_loader as tfl
from bigdl_tpu_torch.utils import serializer
from bigdl_tpu_torch.utils.serializer import load_module, save_module
from bigdl_tpu_torch.utils.table import Table

CPU = "cpu"


@pytest.fixture(autouse=True)
def _keep_library_calls():
    """Leave ``SpatialConvolution.library_calls``, a process-wide counter
    that other test files read, as each test found it."""
    saved = nn.SpatialConvolution.library_calls.copy()
    yield
    nn.SpatialConvolution.library_calls.clear()
    nn.SpatialConvolution.library_calls.update(saved)


def _conv():
    return nn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1, device=CPU)


def _calibrated(m):
    m._calib_amax = 2.5
    return m


def _graph():
    x = nn.Input()
    h = nn.Linear(4, 3, device=CPU)(x)
    return nn.Graph(x, nn.Tanh()(h), device=CPU)


def _while():
    cond = _graph()
    body = _graph()
    body._tf_used_inputs = [0]
    return tfl._TFWhileModule(cond, body, [("node", None),
                                           ("const", np.float32(1.5))], 0,
                              trip=3)


# key -> factory of a module on the CPU; with ``_cases``'s defaults, every
# class the layer table builds (``test_every_class_has_an_entry_and_a_case``)
CASES = {
    # nn.activation
    **{c: (lambda c=c: getattr(nn, c)()) for c in (
        "ReLU", "Tanh", "Sigmoid", "LogSoftMax", "Identity", "ReLU6",
        "Abs", "Exp", "Log", "Square", "Sqrt", "Negative", "SoftSign",
        "SoftMax", "ELU", "SoftPlus")},
    "PReLU": lambda: nn.PReLU(3, device=CPU),
    "Power": lambda: nn.Power(2.0, 0.5, 1.0),
    "Maxout": lambda: nn.Maxout(4, 3, 2, device=CPU),
    # nn.basic
    "AddConstant": lambda: nn.AddConstant(1.5),
    "MulConstant": lambda: nn.MulConstant(0.5),
    "CAdd": lambda: nn.CAdd((1, 3), device=CPU),
    "CMul": lambda: nn.CMul((1, 3), device=CPU),
    "Dropout": lambda: nn.Dropout(0.3),
    "Flatten": lambda: nn.Flatten(),
    "Mean": lambda: nn.Mean(1, squeeze=False),
    "Sum": lambda: nn.Sum(1, size_average=True),
    "Narrow": lambda: nn.Narrow(1, 1, 2),
    "Reshape": lambda: nn.Reshape((2, 3)),
    "Scale": lambda: nn.Scale((1, 3), device=CPU),
    "SpatialZeroPadding": lambda: nn.SpatialZeroPadding(1, 2, 3, 4),
    "Squeeze": lambda: nn.Squeeze(1),
    "Tile": lambda: nn.Tile(1, 3),
    "View": lambda: nn.View(2, 3),
    "Input": lambda: nn.Input().module,
    # nn.containers
    "Sequential": lambda: nn.Sequential(nn.Linear(4, 3, device=CPU),
                                        nn.ReLU()),
    "Concat": lambda: nn.Concat(1).add(nn.Linear(4, 3, device=CPU))
    .add(nn.Identity()),
    "ConcatTable": lambda: nn.ConcatTable(nn.Identity(), nn.Tanh()),
    "ParallelTable": lambda: nn.ParallelTable(nn.Identity(), nn.Tanh()),
    "MapTable": lambda: nn.MapTable(nn.Linear(4, 3, device=CPU)),
    "Bottle": lambda: nn.Bottle(nn.Linear(4, 3, device=CPU), 2, 2),
    "Container": lambda: nn.Container(nn.Identity()),
    # nn.conv
    "SpatialConvolution": _conv,
    "SpatialDilatedConvolution": lambda: nn.SpatialDilatedConvolution(
        3, 4, 3, 3, 1, 1, 2, 2, 2, 2, with_bias=False, device=CPU),
    "SpatialFullConvolution": lambda: nn.SpatialFullConvolution(
        4, 2, 3, 3, 2, 2, 1, 1, device=CPU),
    "VolumetricConvolution": lambda: nn.VolumetricConvolution(
        2, 3, 2, 2, 2, device=CPU),
    "VolumetricFullConvolution": lambda: nn.VolumetricFullConvolution(
        2, 3, 2, 2, 2, device=CPU),
    "TemporalConvolution": lambda: nn.TemporalConvolution(4, 3, 2,
                                                          device=CPU),
    # nn.criterion
    "ClassNLLCriterion": lambda: nn.ClassNLLCriterion(
        torch.tensor([1.0, 2.0, 0.5]), padding_value=-1),
    "CrossEntropyCriterion": lambda: nn.CrossEntropyCriterion(
        torch.tensor([1.0, 2.0, 0.5])),
    "TimeDistributedCriterion": lambda: nn.TimeDistributedCriterion(
        nn.ClassNLLCriterion(), size_average=True),
    **{c: (lambda c=c: getattr(nn, c)()) for c in (
        "AbsCriterion", "BCECriterionWithLogits", "CategoricalCrossEntropy",
        "CosineDistanceCriterion", "CosineProximityCriterion",
        "DistKLDivCriterion", "DotProductCriterion", "GaussianCriterion",
        "KLDCriterion", "KullbackLeiblerDivergenceCriterion", "L1Cost",
        "MSECriterion", "MeanAbsolutePercentageCriterion",
        "MeanSquaredLogarithmicCriterion", "MultiLabelMarginCriterion",
        "PoissonCriterion", "SoftMarginCriterion")},
    "BCECriterion": lambda: nn.BCECriterion(torch.tensor([1.0, 0.5]),
                                            size_average=False),
    "SmoothL1Criterion": lambda: nn.SmoothL1Criterion(sigma=3.0),
    "MarginCriterion": lambda: nn.MarginCriterion(0.5, squared=True),
    "MarginRankingCriterion": lambda: nn.MarginRankingCriterion(0.25),
    "CosineEmbeddingCriterion": lambda: nn.CosineEmbeddingCriterion(0.1),
    "HingeEmbeddingCriterion": lambda: nn.HingeEmbeddingCriterion(2.0),
    "MultiMarginCriterion": lambda: nn.MultiMarginCriterion(
        2, torch.tensor([1.0, 2.0, 0.5]), margin=0.5),
    "MultiLabelSoftMarginCriterion": lambda: (
        nn.MultiLabelSoftMarginCriterion(torch.tensor([1.0, 2.0]))),
    "DiceCoefficientCriterion": lambda: nn.DiceCoefficientCriterion(
        epsilon=0.5),
    "PGCriterion": lambda: nn.PGCriterion(True),
    "MultiCriterion": lambda: nn.MultiCriterion().add(nn.MSECriterion(), 0.5)
    .add(nn.AbsCriterion()),
    "ParallelCriterion": lambda: nn.ParallelCriterion().add(
        nn.SoftmaxWithCriterion(ignore_label=-1)).add(
        nn.SmoothL1CriterionWithWeights(3.0), 0.5),
    "TransformerCriterion": lambda: nn.TransformerCriterion(
        nn.MSECriterion(), nn.Tanh(), nn.Square()),
    "SoftmaxWithCriterion": lambda: nn.SoftmaxWithCriterion(-1, "FULL"),
    "ClassSimplexCriterion": lambda: nn.ClassSimplexCriterion(4),
    "L1HingeEmbeddingCriterion": lambda: nn.L1HingeEmbeddingCriterion(2.0),
    "SmoothL1CriterionWithWeights": lambda: nn.SmoothL1CriterionWithWeights(
        3.0, num=128),
    "NegativeEntropyPenalty": lambda: nn.NegativeEntropyPenalty(0.05),
    "TimeDistributedMaskCriterion": lambda: nn.TimeDistributedMaskCriterion(
        nn.MSECriterion(), padding_value=-1),
    # nn.detection
    "PriorBox": lambda: nn.PriorBox([30.0], [60.0], [2.0], flip=False,
                                    img_size=300, step=8.0,
                                    variances=[0.1, 0.1, 0.2, 0.2]),
    "Proposal": lambda: nn.Proposal(60, 10, [0.5, 1.0, 2.0], [4.0, 8.0],
                                    rpn_post_nms_topn_train=20,
                                    min_size=8.0),
    "RoiPooling": lambda: nn.RoiPooling(7, 6, 0.0625),
    "DetectionOutputSSD": lambda: nn.DetectionOutputSSD(
        5, nms_topk=20, keep_top_k=10, variance_encoded_in_target=True),
    "DetectionOutputFrcnn": lambda: nn.DetectionOutputFrcnn(
        5, nms_thresh=0.4, keep_top_k=10),
    # nn.embedding
    "LookupTable": lambda: nn.LookupTable(7, 3, device=CPU),
    "LookupTableSparse": lambda: nn.LookupTableSparse(7, 3, "mean",
                                                      device=CPU),
    # nn.graph
    "Graph": _graph,
    # nn.linear, nn.locally_connected
    "Linear": lambda: nn.Linear(4, 3, device=CPU),
    "Cosine": lambda: nn.Cosine(4, 3, device=CPU),
    "Euclidean": lambda: nn.Euclidean(4, 3, fast_backward=False,
                                      device=CPU),
    "Bilinear": lambda: nn.Bilinear(4, 3, 2, bias_res=False, device=CPU),
    "LocallyConnected1D": lambda: nn.LocallyConnected1D(6, 4, 3, 2,
                                                        device=CPU),
    "LocallyConnected2D": lambda: nn.LocallyConnected2D(
        2, 5, 5, 3, 2, 2, device=CPU),
    # nn.misc
    "BinaryThreshold": lambda: nn.BinaryThreshold(0.25),
    "Highway": lambda: nn.Highway(4, device=CPU),
    "InferReshape": lambda: nn.InferReshape((-1, 2)),
    # nn.module
    "Module": lambda: nn.Module(),
    "Criterion": lambda: nn.Criterion(size_average=False),
    # nn.normalization
    "BatchNormalization": lambda: nn.BatchNormalization(3, device=CPU),
    "SpatialBatchNormalization": lambda: nn.SpatialBatchNormalization(
        3, format="NHWC", device=CPU),
    "VolumetricBatchNormalization": lambda: nn.VolumetricBatchNormalization(
        3, device=CPU),
    "LayerNormalization": lambda: nn.LayerNormalization(3, device=CPU),
    "SpatialCrossMapLRN": lambda: nn.SpatialCrossMapLRN(3),
    "SpatialWithinChannelLRN": lambda: nn.SpatialWithinChannelLRN(3),
    "Normalize": lambda: nn.Normalize(float("inf"), eps=1e-6),
    "NormalizeScale": lambda: nn.NormalizeScale(scale=20.0,
                                                size=(1, 3, 1, 1),
                                                device=CPU),
    # nn.pooling
    "SpatialMaxPooling": lambda: nn.SpatialMaxPooling(2, 2, 2, 2).ceil(),
    "SpatialAveragePooling": lambda: nn.SpatialAveragePooling(3, 3, 1, 1,
                                                              1, 1),
    "_Pool2D": lambda: nn.pooling._Pool2D(2, 2),
    "VolumetricMaxPooling": lambda: nn.VolumetricMaxPooling(2, 2, 2),
    "VolumetricAveragePooling": lambda: nn.VolumetricAveragePooling(2, 2,
                                                                    2),
    "TemporalMaxPooling": lambda: nn.TemporalMaxPooling(2),
    # nn.quantized
    "QuantizedLinear": lambda: nn.QuantizedLinear.from_float(
        _calibrated(nn.Linear(4, 3, device=CPU))),
    "QuantizedSpatialConvolution": lambda: (
        nn.QuantizedSpatialConvolution(_conv())
        ._fill(_calibrated(_conv()), (1, 2, 3))),
    "QuantizedSpatialDilatedConvolution": lambda: (
        nn.QuantizedSpatialDilatedConvolution(
            nn.SpatialDilatedConvolution(3, 4, 3, 3, dilation_w=2,
                                         dilation_h=2, device=CPU))),
    # nn.recurrent
    "Recurrent": lambda: nn.Recurrent(nn.LSTM(3, 4, device=CPU)),
    "BiRecurrent": lambda: nn.BiRecurrent(
        "concat", nn.GRU(3, 4, device=CPU)),
    "RecurrentDecoder": lambda: nn.RecurrentDecoder(
        3, nn.LSTM(4, 4, device=CPU)),
    "LSTM": lambda: nn.LSTM(3, 4, p=0.25, device=CPU),
    "GRU": lambda: nn.GRU(3, 4, device=CPU),
    "LSTMPeephole": lambda: nn.LSTMPeephole(3, 4, device=CPU),
    "ConvLSTMPeephole": lambda: nn.ConvLSTMPeephole(2, 3, 3, 3,
                                                    device=CPU),
    "ConvLSTMPeephole3D": lambda: nn.ConvLSTMPeephole3D(
        2, 3, 3, 3, with_peephole=False, device=CPU),
    "RnnCell": lambda: nn.RnnCell(3, 4, device=CPU),
    "Cell": lambda: nn.Cell(),
    "MultiRNNCell": lambda: nn.MultiRNNCell([nn.LSTM(3, 4, device=CPU),
                                             nn.LSTM(4, 4, device=CPU)]),
    "TimeDistributed": lambda: nn.TimeDistributed(
        nn.Linear(4, 3, device=CPU)),
    # nn.table_ops
    **{c: (lambda c=c: getattr(nn, c)()) for c in (
        "CAddTable", "CMulTable", "CSubTable", "CDivTable", "CMaxTable",
        "CMinTable")},
    "JoinTable": lambda: nn.JoinTable(1),
    "MM": lambda: nn.MM(True, False),
    "MV": lambda: nn.MV(True),
    "SplitTable": lambda: nn.SplitTable(1),
    **{c: (lambda c=c: getattr(nn, c)()) for c in (
        "CAveTable", "FlattenTable", "MixtureTable", "DotProduct",
        "CosineDistance")},
    "SelectTable": lambda: nn.SelectTable(2),
    "_ReduceTable": lambda: nn.table_ops._ReduceTable(),
    # nn.tree_lstm
    "BinaryTreeLSTM": lambda: nn.BinaryTreeLSTM(3, 4, device=CPU),
    "TreeGather": lambda: nn.tree_lstm.TreeGather(),
    # ops.control_ops
    "Cond": lambda: ops.Cond(nn.Linear(4, 3, device=CPU), nn.Tanh()),
    "WhileLoop": lambda: ops.WhileLoop(nn.Tanh(), torch.lt, 4),
    "Select": lambda: ops.Select(),
    # ops.tf_ops with constructor values
    "AvgPoolGrad": lambda: tf_ops.AvgPoolGrad([1, 4, 4, 2], [1, 2, 2, 1],
                                           [1, 2, 2, 1], "SAME"),
    "BucketizedCol": lambda: tf_ops.BucketizedCol([0.0, 1.0, 5.0]),
    "Cast": lambda: tf_ops.Cast(np.dtype("int32")),
    "CategoricalColHashBucket": lambda: tf_ops.CategoricalColHashBucket(11),
    "CategoricalColVocaList": lambda: tf_ops.CategoricalColVocaList(
        ["a", "b"], num_oov_buckets=2),
    "ConstSource": lambda: tf_ops.ConstSource(
        np.arange(6, dtype=np.float32).reshape(2, 3), device=CPU),
    "ConvBackpropFilter": lambda: tf_ops.ConvBackpropFilter(
        [3, 3, 2, 4], [1, 1, 1, 1], "SAME"),
    "ConvBackpropInput": lambda: tf_ops.ConvBackpropInput(
        [1, 5, 5, 2], np.ones((3, 3, 2, 4), np.float32), [1, 1, 1, 1],
        "SAME", device=CPU),
    "CrossCol": lambda: tf_ops.CrossCol(13),
    "DecodeImage": lambda: tf_ops.DecodeImage(3),
    "DecodeRaw": lambda: tf_ops.DecodeRaw(np.int16, little_endian=False),
    "Dilation2D": lambda: tf_ops.Dilation2D(
        np.ones((2, 2, 3), np.float32), (1, 1), (1, 1), "VALID"),
    "Dilation2DBackprop": lambda: tf_ops.Dilation2DBackprop(
        np.ones((2, 2, 3), np.float32), (1, 1), (1, 1), "SAME",
        wrt="filter", device=CPU),
    "ExpandDims": lambda: tf_ops.ExpandDims(1),
    "InTopK": lambda: tf_ops.InTopK(2),
    "IndicatorCol": lambda: tf_ops.IndicatorCol(5),
    "Kv2Tensor": lambda: tf_ops.Kv2Tensor(dim=4),
    "LRNGrad": lambda: tf_ops.LRNGrad(2, 1.5, 0.5, 0.75),
    "MaxPoolGrad": lambda: tf_ops.MaxPoolGrad([1, 2, 2, 1], [1, 2, 2, 1],
                                           "VALID"),
    "OneHot": lambda: tf_ops.OneHot(5, 2.0, -1.0),
    "ParseExampleOp": lambda: tf_ops.ParseExampleOp(
        ["x"], [[2]], [np.dtype("float32")]),
    "RandomUniform": lambda: tf_ops.RandomUniform([2, 3], -1.0, 1.0, 7,
                                               device=CPU),
    "ResizeBilinear": lambda: tf_ops.ResizeBilinear([4, 6], True),
    "SegmentSum": lambda: tf_ops.SegmentSum(3),
    "SegmentSumConst": lambda: tf_ops.SegmentSumConst(np.array([0, 0, 1])),
    "Slice": lambda: tf_ops.Slice([0, 1], [1, 2]),
    "SplitTF": lambda: tf_ops.SplitTF(2, 1),
    "StridedSlice": lambda: tf_ops.StridedSlice([0, 1], [2, 3], [1, 2],
                                             shrink_axis_mask=1),
    "Substr": lambda: tf_ops.Substr(1, 2),
    "TFConv3D": lambda: tf_ops.TFConv3D((2, 2, 2, 3, 4), (1, 1, 1), "SAME",
                                     device=CPU),
    "TensorArraySplit": lambda: tf_ops.TensorArraySplit([2, 2]),
    "Tile": lambda: tf_ops.Tile([2, 1]),
    "TopK": lambda: tf_ops.TopK(2),
    # interop.tf_loader's graph modules
    "_ConstBinary": lambda: tfl._ConstBinary(torch.gt, None,
                                             np.float32(0.5)),
    "_EinsumModule": lambda: tfl._EinsumModule("ij,jk->ik"),
    "_GatherWeight": lambda: tfl._GatherWeight((5, 3), device=CPU),
    "_PadModule": lambda: tfl._PadModule([[0, 0], [1, 2], [3, 4], [0, 0]]),
    "_Rsqrt": lambda: tfl._Rsqrt(),
    "_SquaredDiffTable": lambda: tfl._SquaredDiffTable(),
    "_TransposeModule": lambda: tfl._TransposeModule([0, 2, 1]),
    "_TFWhileModule": _while,
}


def _cases():
    """``CASES`` and every other ``tf_ops`` class, built with its
    constructor's defaults."""
    out = dict(CASES)
    for spec in serializer._tables()["layers"].values():
        name = spec.cls.__name__
        if spec.cls.__module__.endswith("tf_ops") and name not in out \
                and not any(r for _, r in serializer._ctor_params(spec.cls)):
            out[name] = spec.cls
    return out


def _seeded(m, seed=0):
    """``m`` with every floating tensor drawn from a seeded normal (a
    constructor may leave them unset)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in list(m.parameters()) + list(m.buffers()):
            if t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))
    return m


ALL = _cases()


def _public(m):
    out = {k: v for k, v in vars(m).items()
           if not k.startswith("_") and k != "training"}
    out.update(dict(m.named_children()))
    return out


def _same(a, b, path, seen):
    if isinstance(a, torch.nn.Module):
        assert type(a) is type(b), path
        if id(a) in seen:
            return
        seen.add(id(a))
        pa, pb = _public(a), _public(b)
        assert sorted(pa) == sorted(pb), path
        for k in pa:
            _same(pa[k], pb[k], f"{path}.{k}", seen)
        assert a.training == b.training, path
        sa, sb = a.state_dict(), b.state_dict()
        assert list(sa) == list(sb), path
        for k in sa:
            assert sa[k].dtype == sb[k].dtype, f"{path}.{k}"
            assert torch.equal(sa[k], sb[k]), f"{path}.{k}"
    elif isinstance(a, (torch.Tensor, np.ndarray)):
        assert isinstance(b, (torch.Tensor, np.ndarray)), path
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]", seen)
    elif isinstance(a, (dict, Table)):
        assert type(a) is type(b) and list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]", seen)
    elif hasattr(a, "__dict__") and not callable(a):
        assert type(a) is type(b), path
        va, vb = vars(a), vars(b)
        assert sorted(va) == sorted(vb), path
        for k in va:
            _same(va[k], vb[k], f"{path}.{k}", seen)
    else:
        assert a == b or a is b, f"{path}: {a!r} != {b!r}"


def _roundtrip(m, tmp_path):
    save_module(m, str(tmp_path / "m.bigdl"))
    return load_module(str(tmp_path / "m.bigdl"), device=CPU)


def test_every_class_has_an_entry_and_a_case():
    by_class = serializer._tables()["by_class"]
    missing = [c.__qualname__ for c in serializer._port_classes()
               if c not in by_class and serializer._reference_name(c)
               .split("bigdl_tpu.", 1)[1] not in serializer._PORT_ONLY]
    assert missing == []
    # the models and their parts have tests of their own
    models = ("bigdl_tpu.models.", "bigdl_tpu.parallel.")
    named = {s.cls.__name__ for n, s in serializer._tables()["layers"]
             .items() if not n.startswith(models)}
    assert sorted(named - set(ALL)) == []


def test_table_names_are_reference_classes():
    from bigdl_tpu.parallel.sequence import MultiHeadAttention
    for name, spec in serializer._tables()["layers"].items():
        if spec.form is not None:
            continue                 # the name of a form, not a record
        mod, _, qual = name.partition(":")
        if "<locals>" in qual:
            assert qual == type(MultiHeadAttention(8, 2)).__qualname__
            continue
        obj = importlib.import_module(mod)
        for part in qual.split("."):
            obj = getattr(obj, part)
        assert isinstance(obj, type), name


@pytest.mark.parametrize("key", sorted(ALL))
def test_every_class_round_trips_in_the_port(key, tmp_path):
    m = _seeded(ALL[key]())
    got = _roundtrip(m, tmp_path)
    _same(m, got, key, set())


def test_int8_linear_is_written_inside_its_model_only(tmp_path):
    m = nn.Sequential(nn.Int8Linear(4, 3, device=CPU))
    with pytest.raises(TypeError, match="Int8Linear"):
        save_module(m, str(tmp_path / "m.bigdl"))


def test_a_function_off_the_table_is_refused_when_written(tmp_path):
    m = ops.WhileLoop(nn.Tanh(), lambda x: x.sum() < 3)
    with pytest.raises(TypeError, match="function"):
        save_module(m, str(tmp_path / "m.bigdl"))


# ------------------------------------------- checkpoints of trained models
def _bert_mlm():
    from bigdl_tpu_torch.models.transformer import BertForMLM
    from bigdl_tpu_torch import convert
    m = BertForMLM(vocab_size=31, hidden_size=16, n_layers=2, n_heads=2,
                   max_position=8, device=CPU)
    m.load_state_dict(convert.bert_params_from_jax(
        convert.init_bert_tree(m, seed=4)))
    rng = np.random.default_rng(5)
    x = rng.integers(0, 31, (32, 8)).astype(np.int64)
    y = np.where(rng.random((32, 8)) < 0.3, x, -1)
    y[:, 0] = x[:, 0]
    return m, x, y, nn.CrossEntropyCriterion()


def _tf_bert(tmp_path):
    import chip_smoke as cs
    from bigdl_tpu_torch.interop.tf_session import TFTrainingSession
    nodes, var = cs.bert_tf_graph(n_layers=1, hidden=16, heads=2, ffn=32,
                                  vocab=50, seq=8, classes=2, seed=3)
    pb = str(tmp_path / "g.pb")
    with open(pb, "wb") as f:
        f.write(cs.tf_graphdef(nodes))
    cs.write_npy_dir(str(tmp_path), var)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 50, (32, 8)).astype(np.int32)
    y = rng.integers(0, 2, 32).astype(np.int32)
    graph = TFTrainingSession(pb, ["input_ids"], ["output/logits"],
                              bin_dir=str(tmp_path), sample_input=x[:1],
                              device=CPU).graph
    return graph, x, y, nn.CrossEntropyCriterion()


def _conv_lstm():
    m = nn.Sequential(
        nn.Recurrent(nn.ConvLSTMPeephole(2, 3, 3, 3, device=CPU)),
        nn.Flatten(), nn.Linear(4 * 3 * 5 * 5, 3, device=CPU),
        nn.LogSoftMax()).reset(2)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((32, 4, 2, 5, 5)).astype(np.float32)
    y = rng.integers(0, 3, 32).astype(np.int32)
    return m, x, y, nn.ClassNLLCriterion()


def _train(make, tmp_path, fail_at=None):
    """The model trained two epochs by ``DistriOptimizer`` on two CPU
    replicas, checkpointed every iteration; with ``fail_at`` the batch of
    that number fails once. Returns ``(model, optimizer, reloads)``:
    ``(neval, state_dict)`` of each checkpoint the retry reloaded, the
    weights as the reload left them."""
    from bigdl_tpu_torch import optim as topt
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
    m, x, y, crit = make()
    ds = DataSet.array([Sample(x[i], y[i]) for i in range(len(x))],
                       distributed=True) >> SampleToMiniBatch(8)
    o = topt.Optimizer(model=m, dataset=ds, criterion=crit,
                       mesh=[CPU, CPU])
    o.set_optim_method(topt.SGD(learningrate=0.05, momentum=0.9))
    o.set_end_when(topt.Trigger.max_epoch(2))
    o.set_checkpoint(str(tmp_path), topt.Trigger.several_iteration(1))
    reloads = []
    if fail_at is not None:
        shard, count = o._shard_batch, {"n": 0}
        reload = o._reload_latest

        def failing(batch, *args):
            count["n"] += 1
            if count["n"] == fail_at:
                raise RuntimeError("injected executor failure")
            return shard(batch, *args)

        def reloading():
            latest = max(int(f.split(".")[1]) for f in os.listdir(tmp_path)
                         if f.startswith("model."))
            out = reload()
            reloads.append((latest, {k: v.clone() for k, v in
                                     o.model.state_dict().items()}))
            return out

        o._shard_batch = failing
        o._reload_latest = reloading
    o.optimize()
    return m, o, reloads


@pytest.mark.parametrize("model", ["bert_mlm", "tf_bert", "conv_lstm"])
def test_trained_model_checkpoints_and_resumes_through_a_retry(model,
                                                                tmp_path):
    """``DistriOptimizer`` checkpoints the model in the native format every
    iteration. A failure at the fifth batch reloads the latest ``model.N``
    through ``load_module``: the weights it restores are, bit for bit,
    those an uninterrupted run wrote at the same iteration, and the run
    goes on from them to its end. The last checkpoint of each run loads
    back as the trained model."""
    makers = {"bert_mlm": _bert_mlm,
              "tf_bert": lambda: _tf_bert(tmp_path / "tf"),
              "conv_lstm": _conv_lstm}
    (tmp_path / "tf").mkdir()
    want, _, _ = _train(makers[model], tmp_path / "a")
    got, o, reloads = _train(makers[model], tmp_path / "b", fail_at=5)
    assert o.retries == 1 and len(reloads) == 1
    neval, restored = reloads[0]
    ref = load_module(str(tmp_path / "a" / f"model.{neval}"), device=CPU)
    assert set(restored) == set(ref.state_dict())
    for k, v in ref.state_dict().items():
        assert torch.equal(restored[k], v), k
    for run, model_ in (("a", want), ("b", got)):
        last = max(int(f.split(".")[1]) for f in os.listdir(tmp_path / run)
                   if f.startswith("model."))
        back = load_module(str(tmp_path / run / f"model.{last}"), device=CPU)
        assert type(back) is type(model_)
        for k, v in model_.state_dict().items():
            assert torch.equal(back.state_dict()[k], v), k


# ------------------------------------------------- both ways, forward held
# key -> input shape, for classes whose forward takes one array: the
# reference loads the port's file, and the port the file the reference
# writes back from it, each forwarding the port module's output
SHAPES = {
    "Scale": (2, 3), "SpatialZeroPadding": (2, 3, 4, 5),
    "MulConstant": (2, 3), "AddConstant": (2, 3), "Power": (2, 3),
    "Tile": (2, 3), "Mean": (2, 3, 4), "Sum": (2, 3, 4),
    "BinaryThreshold": (2, 3), "InferReshape": (2, 4),
    "SpatialWithinChannelLRN": (2, 3, 5, 5), "Bottle": (2, 5, 4),
    "SpatialDilatedConvolution": (2, 3, 9, 9),
    "SpatialCrossMapLRN": (2, 3, 5, 5), "Recurrent": (2, 4, 3),
    "BiRecurrent": (2, 4, 3), "TemporalConvolution": (2, 6, 4),
    "LocallyConnected1D": (2, 6, 4), "Maxout": (2, 4), "Highway": (2, 4),
    "PReLU": (2, 3, 4, 4), "Narrow": (2, 4), "Squeeze": (2, 1, 3),
    "LSTMPeephole": (2, 4, 3), "ConvLSTMPeephole": (2, 3, 2, 5, 5),
    "Cosine": (2, 4), "Euclidean": (2, 4), "Normalize": (2, 5),
    "NormalizeScale": (2, 3, 4, 4), "PriorBox": (1, 3, 4, 4),
}
WRAPPED = {"LSTMPeephole", "ConvLSTMPeephole"}      # in a Recurrent


@pytest.mark.parametrize("key", sorted(SHAPES))
def test_port_file_forwards_alike_in_both_packages(key, tmp_path):
    import jax.numpy as jnp
    from bigdl_tpu.utils import serializer as jser
    m = _seeded(ALL[key]())
    m = (nn.Recurrent(m) if key in WRAPPED else m).eval()
    x = np.random.default_rng(0).standard_normal(SHAPES[key]) \
        .astype(np.float32)
    with torch.no_grad():
        want = m(torch.from_numpy(x)).numpy()
    save_module(m, str(tmp_path / "port.bigdl"))
    ref = jser.load_module(str(tmp_path / "port.bigdl")).evaluate()
    np.testing.assert_allclose(np.asarray(ref.forward(jnp.asarray(x))),
                               want, rtol=1e-5, atol=1e-6)
    jser.save_module(ref, str(tmp_path / "ref.bigdl"))
    back = load_module(str(tmp_path / "ref.bigdl"), device=CPU).eval()
    with torch.no_grad():
        np.testing.assert_allclose(back(torch.from_numpy(x)).numpy(), want,
                                   rtol=1e-5, atol=1e-6)


def test_tree_lstm_sentiment_model_forwards_alike_in_both_packages(
        tmp_path):
    """The sentiment model's trained parts (``LookupTable``,
    ``BinaryTreeLSTM``, ``Linear``) saved by the port: the port's load and
    the reference's give the port's root logits on 16 seeded trees."""
    import jax.numpy as jnp
    from bigdl_tpu.nn import TreeGather as JaxTreeGather
    from bigdl_tpu.utils import serializer as jser
    from bigdl_tpu.utils.table import T
    from test_text_treelstm import build_tree_batch
    rng = np.random.default_rng(0)
    seqs = [rng.integers(1, 11, int(rng.integers(2, 6))).tolist()
            for _ in range(16)]
    word, tree, roots = build_tree_batch(seqs, 8, rng)
    m = _seeded(nn.Sequential(nn.LookupTable(12, 8, device=CPU),
                              nn.BinaryTreeLSTM(8, 16, device=CPU),
                              nn.Linear(16, 2, device=CPU)), 3).eval()

    def port(model):
        with torch.no_grad():
            hs = model[1]([model[0](torch.from_numpy(word)),
                           torch.from_numpy(tree)])
            return model[2](nn.TreeGather()(
                [hs, torch.from_numpy(roots)])).numpy()

    want = port(m)
    save_module(m, str(tmp_path / "tree.bigdl"))
    np.testing.assert_array_equal(
        port(load_module(str(tmp_path / "tree.bigdl"), device=CPU).eval()),
        want)
    ref = jser.load_module(str(tmp_path / "tree.bigdl"))
    (emb, tl, head), params = ref.modules, ref.params
    hs = tl.call(params[1], T(emb.call(params[0], jnp.asarray(word)),
                              jnp.asarray(tree)))
    got = head.call(params[2], JaxTreeGather().call(
        (), T(hs, jnp.asarray(roots))))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-6)
