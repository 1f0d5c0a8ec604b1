"""The TF GraphDef importer of the port (``bigdl_tpu_torch/interop/
tf_loader.py``) and the TF half of its saver (``interop/savers.py``)
against the JAX reference's (``bigdl_tpu/interop``), on the CPU, mirroring
the reference's ``tests/test_tf_importer.py`` (``TestSwitchMergeImport``,
``TestWhileLoopImport``, ``TestNewOps``, ``TestMiniBERT``,
``TestSecondOpWave`` and the forward cases of ``TestWave3Ops`` and
``TestFinalWaveOps``), ``TestTFLoaderAttrs`` of
``tests/test_advice_fixes.py`` and the TF cases of ``tests/test_savers.py``.

Every GraphDef is built here from seeded numpy with ``chip_smoke.py``'s
builders (``tf_node``, ``tf_const``, ``tf_graphdef``), and both packages
load the same bytes. Outputs agree within 1e-6 of their largest magnitude
(integers and booleans exactly) with the reference's dtypes; gradients of
a seeded projection of the outputs with respect to every imported weight
and float input agree with ``jax.grad`` within 1e-4 of their largest
magnitude. Each op of ROADMAP A.11(d)(2)(b), which the port once
refused, imports and gives the reference's output.
"""

import io
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from bigdl_tpu.interop import save_tf as jsave
from bigdl_tpu.interop.tf_loader import load_tf as jload
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.interop import TensorflowSaver
from bigdl_tpu_torch.interop import load_tf as tload
from bigdl_tpu_torch.interop import save_tf as tsave
from bigdl_tpu_torch.interop import tf_loader as tl
from bigdl_tpu_torch.models import conv_routes, layer_walk, model_flops
from bigdl_tpu_torch.ops import tf_ops as tt

node, const, graphdef = cs.tf_node, cs.tf_const, cs.tf_graphdef


@pytest.fixture(autouse=True)
def _keep_library_calls():
    """Leave ``SpatialConvolution.library_calls``, a process-wide counter
    that other test files read, as each test found it."""
    saved = tnn.SpatialConvolution.library_calls.copy()
    yield
    tnn.SpatialConvolution.library_calls.clear()
    tnn.SpatialConvolution.library_calls.update(saved)

OUT_REL = 1e-6
GRAD_REL = 1e-4


def _np(y):
    return y.detach().numpy() if isinstance(y, torch.Tensor) \
        else np.asarray(y)


def _close(got, want, rel=OUT_REL, floor=1e-30):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if want.dtype.kind in "biu" or not want.size:
        np.testing.assert_array_equal(got, want)
        return
    scale = max(float(np.abs(want).max()), floor)
    assert float(np.abs(got - want).max()) <= rel * scale, \
        float(np.abs(got - want).max()) / scale


def _outs(y):
    if isinstance(y, dict):
        return [y[k] for k in sorted(y)]
    if isinstance(y, (list, tuple)):
        return list(y)
    return [y]


def _feeds(feed):
    """The numpy feed (one array or a list) as each package takes it."""
    if isinstance(feed, list):
        return (JT(*[jnp.asarray(a) for a in feed]),
                [torch.from_numpy(np.array(a)) for a in feed])
    return jnp.asarray(feed), torch.from_numpy(np.array(feed))


def _load_both(gd, inputs, outputs, feed, bin_dir=None):
    jx, _ = _feeds(feed)
    jg = jload(gd, inputs, outputs, bin_dir=bin_dir, sample_input=jx)
    tg = tload(gd, inputs, outputs, bin_dir=bin_dir, sample_input=feed,
               device="cpu")
    return jg, tg


def _param_pairs(tg, jg, jparams):
    """(port parameter, its module, leaf, the reference's array) for every
    imported weight, walking both graphs' nodes in order (loop frames'
    cond and body graphs too)."""
    assert len(tg.exec_order) == len(jg.exec_order)
    for tn, jn in zip(tg.exec_order, jg.exec_order):
        assert tn.module.get_name() == jn.module.name
        p = jparams[str(jn.id)]
        if isinstance(tn.module, tl._TFWhileModule):
            for key in ("cond", "body"):
                yield from _param_pairs(getattr(tn.module, f"{key}_graph"),
                                        getattr(jn.module, f"{key}_graph"),
                                        p[key])
            continue
        for leaf, t in tn.module.named_parameters(recurse=False):
            yield t, tn.module, leaf, p[leaf]


def _compare(gd, inputs, outputs, feed, grads=True, bin_dir=None):
    """Load ``gd`` in both packages, hold outputs, dtypes and gradients;
    returns the port's outputs."""
    jg, tg = _load_both(gd, inputs, outputs, feed, bin_dir)
    jx, tx = _feeds(feed)
    want = _outs(jg.apply(jg.params, jg.state, jx, training=False)[0])
    tins = tx if isinstance(tx, list) else [tx]
    for a in tins:
        if a.is_floating_point():
            a.requires_grad_(True)
    got = _outs(tg(tx))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)
    pairs = list(_param_pairs(tg, jg, jg.params))
    for t, m, leaf, a in pairs:      # the imported weights themselves
        _close(convert._leaf_to_jax(m, leaf, t), np.asarray(a))
    fl = [i for i, w in enumerate(want) if np.asarray(w).dtype.kind == "f"]
    if not (grads and fl):
        return got
    rng = np.random.default_rng(5)
    cots = {i: rng.standard_normal(np.shape(want[i])).astype(np.float32)
            for i in fl}
    fins = [i for i, a in enumerate(tins) if a.is_floating_point()]

    def loss(params, *xs):
        if isinstance(jx, dict):
            x = JT(*[xs[fins.index(i)] if i in fins else v
                     for i, v in enumerate(_outs(jx))])
        else:
            x = xs[0] if fins else jx
        y = _outs(jg.apply(params, jg.state, x, training=False)[0])
        return sum(jnp.sum(y[i] * cots[i]) for i in fl)

    jgrads = jax.jit(jax.grad(loss, argnums=tuple(range(1 + len(fins)))))(
        jg.params, *[_outs(jx)[i] for i in fins])
    total = sum((got[i] * torch.from_numpy(cots[i])).sum() for i in fl)
    params = [t for t, _, _, _ in pairs]
    need = [tins[i] for i in fins] + params
    if total.requires_grad:
        tg_ = torch.autograd.grad(total, need, allow_unused=True)
    else:
        tg_ = [None] * len(need)
    tg_ = [torch.zeros_like(n) if g is None else g
           for n, g in zip(need, tg_)]
    for k, i in enumerate(fins):
        _close(tg_[k], jgrads[1 + k], GRAD_REL)
    jpairs = list(_param_pairs(tg, jg, jgrads[0]))
    # a gradient that is zero analytically (a key bias under softmax's
    # shift invariance) is rounding in both packages: held to 1e-6 of the
    # graph's largest gradient
    floor = 1e-2 * max([float(np.abs(np.asarray(ja)).max())
                        for _, _, _, ja in jpairs] + [1e-30])
    for g, (t, m, leaf, ja) in zip(tg_[len(fins):], jpairs):
        _close(convert._leaf_to_jax(m, leaf, g), np.asarray(ja), GRAD_REL,
               floor)
    return got


R = np.random.default_rng(0)


def _f(*shape, scale=1.0):
    return (R.standard_normal(shape) * scale).astype(np.float32)


def _i32(*v):
    return np.asarray(v, np.int32)


def _lst(key, vals):
    return {"list": {key: list(vals)}}


# ---------------------------------------------------------- control flow

@pytest.mark.parametrize("pred", [True, False])
def test_switch_merge_cond_graph(pred):
    nodes = cs.switch_merge_graph()
    x = np.ones((2, 2), np.float32)
    out = _compare(graphdef(nodes), ["x", "pred"], ["merge"],
                   [x, np.asarray(pred)])
    np.testing.assert_allclose(_np(out[0]), 10.0 if pred else -1.0)


def test_malformed_loop_frame_rejected():
    nodes = [node("x", "Placeholder"),
             node("e", "Enter", ["x"], frame_name=b"loop")]
    for load in (jload, lambda *a: tload(*a, device="cpu")):
        with pytest.raises(ValueError, match="LoopCond"):
            load(graphdef(nodes), ["x"], ["e"])


def test_nested_frame_and_stray_loop_ops_rejected():
    nodes = [node("x", "Placeholder"), node("nx", "NextIteration", ["x"])]
    for load in (jload, lambda *a: tload(*a, device="cpu")):
        with pytest.raises(ValueError, match="malformed loop graph"):
            load(graphdef(nodes), ["x"], ["nx"])


def test_counter_loop_matches_oracle_and_reference():
    """i < 3: x = tanh(x @ W), a fixed 3 iterations (no host reads),
    differentiable through the loop."""
    W = _f(3, 3, scale=0.5)
    x0 = _f(2, 3)
    out = _compare(graphdef(cs.counter_loop_graph(W, 3)), ["x"], ["out"], x0)
    ref = x0.copy()
    for _ in range(3):
        ref = np.tanh(ref @ W)
    np.testing.assert_allclose(_np(out[0]), ref, rtol=1e-5, atol=1e-6)
    g = tload(graphdef(cs.counter_loop_graph(W, 3)), ["x"], ["out"],
              device="cpu")
    loop = [n.module for n in g.exec_order
            if isinstance(n.module, tl._TFWhileModule)][0]
    assert loop.trip == 3
    g(torch.from_numpy(x0))
    assert loop.host_syncs == 0


def test_tensorarray_loop_forwards_and_finetunes():
    """The reference's TensorArray acceptance graph: the in-loop MatMul
    weight gets the reference's gradient, and a step lowers the loss."""
    W = _f(3, 3, scale=0.5)
    x0 = _f(4, 3)
    gd = graphdef(cs.tensorarray_loop_graph(W, 4))
    out = _compare(gd, ["x"], ["gather"], x0)
    np.testing.assert_allclose(_np(out[0]), np.tanh(x0 @ W), rtol=1e-5,
                               atol=1e-6)
    g = tload(gd, ["x"], ["gather"], sample_input=x0, device="cpu")
    target = torch.from_numpy(_f(4, 3))
    opt = torch.optim.SGD(g.parameters(), lr=0.1)
    l0 = ((g(torch.from_numpy(x0)) - target) ** 2).mean()
    l0.backward()
    assert sum(float(p.grad.abs().sum()) for p in g.parameters()) > 0
    opt.step()
    l1 = ((g(torch.from_numpy(x0)) - target) ** 2).mean()
    assert float(l1) < float(l0)


def test_dynamic_loop_reads_its_condition_each_iteration():
    """A data-dependent condition: the loop reads it on the host before
    every iteration (4 ones doubled to 128: 6 reads)."""
    x0 = np.ones(4, np.float32)
    gd = graphdef(cs.dynamic_loop_graph())
    out = _compare(gd, ["x"], ["exit_x"], x0, grads=False)
    np.testing.assert_allclose(_np(out[0]), np.full(4, 32.0))
    g = tload(gd, ["x"], ["exit_x"], sample_input=x0, device="cpu")
    loop = [n.module for n in g.exec_order
            if isinstance(n.module, tl._TFWhileModule)][0]
    assert loop.trip is None and loop.host_syncs == 0
    g(torch.from_numpy(x0))
    assert loop.host_syncs == 6


# ----------------------------------------------------------- op graphs

def _unary(op, x, **attrs):
    return ([node("x", "Placeholder"), node("y", op, ["x"], **attrs)],
            ["x"], ["y"], x)


POS = np.abs(_f(3, 4)) + 0.5
A, B = _f(3, 4), _f(3, 4)
IMG = _f(2, 6, 7, 3)
INTS = _i32(7, -7, 9, -9, 5, -1)
INTS_B = _i32(2, 2, -4, -4, 3, 1)
DW = _f(3, 3, 3, 2, scale=0.3)
CW = _f(3, 3, 3, 4, scale=0.3)

GRAPHS = {
    "transpose_strided_slice_argmax": (
        [node("x", "Placeholder"),
         const("perm", _i32(0, 2, 1)),
         node("t", "Transpose", ["x", "perm"]),
         const("b", _i32(0, 0, 0)), const("e", _i32(2, 4, 1)),
         const("s", _i32(1, 1, 1)),
         node("ss", "StridedSlice", ["t", "b", "e", "s"],
              shrink_axis_mask=4),
         node("am", "ArgMax", ["ss", "dim"]),
         const("dim", np.asarray(1, np.int32))],
        ["x"], ["am", "ss"], np.arange(24, dtype=np.float32)
        .reshape(2, 3, 4)),
    "onehot_cast_tile": (
        [node("x", "Placeholder"),
         const("depth", np.asarray(3, np.int32)),
         const("on", np.asarray(1.0, np.float32)),
         const("off", np.asarray(0.0, np.float32)),
         node("oh", "OneHot", ["x", "depth", "on", "off"]),
         node("c", "Cast", ["oh"], DstT={"type": 3}),
         const("mult", _i32(1, 1, 2)),
         node("tl", "Tile", ["c", "mult"]),
         node("c64", "Cast", ["oh"], DstT={"type": 9})],
        ["x"], ["tl", "c64"], np.asarray([[0, 2]], np.int32)),
    "einsum_batchmatmul": (
        [node("x", "Placeholder"),
         node("bm", "BatchMatMul", ["x", "x"], adj_y=True),
         node("es", "Einsum", ["x", "x"], equation=b"bij,bkj->bik"),
         node("d", "Sub", ["bm", "es"]),
         node("bm2", "BatchMatMulV2", ["x", "x"], adj_x=True)],
        ["x"], ["d", "bm", "bm2"], _f(2, 3, 4)),
    "matmul_activations": (
        [node("x", "Placeholder"), node("y", "Placeholder"),
         node("mm", "MatMul", ["x", "y"], transpose_a=True,
              transpose_b=True)],
        ["x", "y"], ["mm"], [_f(4, 3), _f(5, 4)]),
    "invert_permutation_traced": (
        [node("x", "Placeholder"), node("inv", "InvertPermutation", ["x"])],
        ["x"], ["inv"], _i32(3, 4, 0, 2, 1)),
    "invert_permutation_folded": (
        [node("x", "Placeholder"), const("p", _i32(2, 0, 1)),
         node("inv", "InvertPermutation", ["p"]),
         node("t", "Transpose", ["x", "inv"])],
        ["x"], ["t"], _f(2, 3, 4)),
    "concat_offset_feeds_slice": (
        [node("x", "Placeholder"), const("dim", np.asarray(1, np.int32)),
         const("s0", _i32(2, 3)), const("s1", _i32(2, 4)),
         node("off", "ConcatOffset", ["dim", "s0", "s1"]),
         const("sz1", _i32(2, 4)),
         node("g1", "Slice", ["x", "off:1", "sz1"])],
        ["x"], ["g1"], np.arange(14, dtype=np.float32).reshape(2, 7)),
    "comparison_and_select": (
        [node("x", "Placeholder"),
         const("zero", np.zeros((3, 4), np.float32)),
         node("gt", "Greater", ["x", "zero"]),
         node("neg", "Neg", ["x"]),
         node("sel", "Select", ["gt", "x", "neg"]),
         node("sel2", "SelectV2", ["gt", "neg", "x"])],
        ["x"], ["sel", "sel2"], A),
    "comparisons_tables": (
        [node("x", "Placeholder"), node("y", "Placeholder"),
         node("ge", "GreaterEqual", ["x", "y"]),
         node("lt", "Less", ["x", "y"]), node("le", "LessEqual", ["x", "y"]),
         node("eq", "Equal", ["x", "y"]), node("ne", "NotEqual", ["x", "y"]),
         node("and", "LogicalAnd", ["ge", "ne"]),
         node("or", "LogicalOr", ["lt", "eq"]),
         node("not", "LogicalNot", ["or"]),
         node("ae", "ApproximateEqual", ["x", "y"])],
        ["x", "y"], ["ge", "le", "and", "not", "ae"],
        [A, np.where(R.random((3, 4)) > 0.5, A, B)]),
    "reductions": (
        [node("x", "Placeholder"), const("ax", _i32(1)),
         const("ax2", _i32(0, 1)),
         node("mx", "Max", ["x", "ax"], keep_dims=False),
         node("pr", "Prod", ["x", "ax"], keep_dims=True),
         node("mn", "Min", ["x", "ax2"]),
         node("gt", "Greater", ["x", "c1"]), const("c1", np.float32(1.0)),
         node("all", "All", ["gt", "ax"]), node("any", "Any", ["gt", "ax"]),
         node("sm", "Sum", ["x", "ax2"], keep_dims=True),
         node("me", "Mean", ["x", "ax"])],
        ["x"], ["mx", "pr", "mn", "all", "any", "sm", "me"], POS),
    "pack_unpack_ports": (
        [node("x", "Placeholder"),
         node("un", "Unpack", ["x"], axis=0, num=2),
         node("re", "Pack", ["un:1", "un:0"], axis=0),
         node("us", "Unstack", ["x"], axis=1, num=6),
         node("st", "Stack", ["us:5", "us:0"], axis=1)],
        ["x"], ["re", "st"], _f(2, 6)),
    "split_splitv": (
        [node("x", "Placeholder"), const("ax", np.asarray(1, np.int32)),
         node("sp", "Split", ["ax", "x"], num_split=2),
         node("add", "Add", ["sp:0", "sp:1"]),
         const("sizes", _i32(4, 4)),
         node("sv", "SplitV", ["x", "sizes", "ax"], num_split=2),
         node("sub", "Sub", ["sv:1", "sv:0"])],
        ["x"], ["add", "sub"], _f(2, 8)),
    "topk_ports": (
        [node("x", "Placeholder"), const("k", np.asarray(2, np.int32)),
         node("tk", "TopKV2", ["x", "k"]),
         node("tk1", "TopK", ["x"], k=3)],
        ["x"], ["tk:0", "tk:1", "tk1:1"],
        np.asarray([[3.0, 1.0, 4.0, 1.5], [2.0, 2.0, 1.0, 2.0]],
                   np.float32)),
    "in_topk_sce_ports": (
        [node("lg", "Placeholder"), node("lb", "Placeholder"),
         node("ids", "Placeholder"),
         node("sce", "SoftmaxCrossEntropyWithLogits", ["lg", "lb"]),
         node("loss", "Identity", ["sce:0"]),
         node("bp", "Identity", ["sce:1"]),
         node("itk", "InTopK", ["lg", "ids"], k=2)],
        ["lg", "lb", "ids"], ["loss", "bp", "itk"],
        [np.asarray([[1.0, 2.0, 0.5], [0.1, 0.2, 3.0]], np.float32),
         np.eye(3, dtype=np.float32)[[1, 2]], _i32(0, 2)]),
    "range_fill_const_folding": (
        [node("x", "Placeholder"),
         const("s", np.asarray(0, np.int32)),
         const("l", np.asarray(3, np.int32)),
         const("d", np.asarray(1, np.int32)),
         node("rng", "Range", ["s", "l", "d"]),
         const("dims", _i32(6)), const("val", np.asarray(2.0, np.float32)),
         node("fill", "Fill", ["dims", "val"]),
         node("add", "Add", ["x", "fill"]),
         node("pk", "Pack", ["l", "l"]),
         node("rs", "Reshape", ["x", "pk"]),
         node("perm", "Range", ["s", "l", "d"])],
        ["x"], ["add"], _f(6)),
    "activations": (
        [node("x", "Placeholder"),
         *[node(op.lower(), op, ["x"]) for op in (
             "LeakyRelu", "Elu", "Softplus", "Softsign", "Relu", "Relu6",
             "Sigmoid", "Tanh", "Softmax", "LogSoftmax", "Erf", "Neg",
             "Square", "Abs", "Exp", "Floor", "Ceil", "Sign", "Expm1",
             "Erfc", "Round", "Rint", "ZerosLike", "OnesLike", "IsFinite",
             "IsInf", "IsNan")],
         node("lr2", "LeakyRelu", ["x"], alpha=0.05)],
        ["x"], ["leakyrelu", "elu", "softplus", "softsign", "relu", "relu6",
                "sigmoid", "tanh", "softmax", "logsoftmax", "erf", "neg",
                "square", "abs", "exp", "floor", "ceil", "sign", "expm1",
                "erfc", "round", "rint", "zeroslike", "oneslike",
                "isfinite", "isinf", "isnan", "lr2"], A * 4),
    "positive_unary": (
        [node("x", "Placeholder"),
         *[node(op.lower(), op, ["x"]) for op in (
             "Sqrt", "Rsqrt", "Log", "Log1p", "Reciprocal", "Inv", "Digamma",
             "L2Loss", "Rank", "Shape")]],
        ["x"], ["sqrt", "rsqrt", "log", "log1p", "reciprocal", "inv",
                "digamma", "l2loss", "rank", "shape"], POS),
    "lrn_tf_formula": _unary("LRN", _f(1, 3, 3, 8) ** 2, depth_radius=2,
                             alpha=0.01, beta=0.5, bias=1.5),
    "resize_bilinear": (
        [node("x", "Placeholder"), const("size", _i32(8, 5)),
         node("y", "ResizeBilinear", ["x", "size"], align_corners=False),
         node("yc", "ResizeBilinear", ["x", "size"], align_corners=True)],
        ["x"], ["y", "yc"], IMG),
    "shape_and_zeros_like": (
        [node("x", "Placeholder"), node("z", "ZerosLike", ["x"]),
         node("y", "Add", ["x", "z"]), node("sh", "Shape", ["x"])],
        ["x"], ["y", "sh"], _f(3, 5)),
    "conv2d_bias_pools": (
        [node("x", "Placeholder"), const("w", CW), const("b", _f(4)),
         node("c", "Conv2D", ["x", "w"], strides=_lst("i", [1, 1, 1, 1]),
              padding=b"SAME"),
         node("cb", "BiasAdd", ["c", "b"]),
         node("cv", "Conv2D", ["x", "w"], strides=_lst("i", [1, 2, 1, 1]),
              padding=b"VALID"),
         node("mp", "MaxPool", ["cb"], ksize=_lst("i", [1, 3, 3, 1]),
              strides=_lst("i", [1, 2, 2, 1]), padding=b"SAME"),
         node("ap", "AvgPool", ["cb"], ksize=_lst("i", [1, 3, 2, 1]),
              strides=_lst("i", [1, 2, 2, 1]), padding=b"SAME"),
         node("av", "AvgPool", ["cb"], ksize=_lst("i", [1, 2, 2, 1]),
              strides=_lst("i", [1, 2, 2, 1]), padding=b"VALID")],
        ["x"], ["mp", "ap", "av", "cv"], IMG),
    "depthwise_batchnorm_pad": (
        [node("x", "Placeholder"), const("dw", DW),
         node("d", "DepthwiseConv2dNative", ["x", "dw"],
              strides=_lst("i", [1, 1, 1, 1]), padding=b"SAME"),
         const("sc", _f(6) + 1), const("of", _f(6)), const("mu", _f(6)),
         const("var", np.abs(_f(6)) + 0.5),
         node("bn", "FusedBatchNormV3", ["d", "sc", "of", "mu", "var"],
              epsilon=1e-3),
         const("pads", _i32(0, 0, 1, 2, 2, 1, 0, 0).reshape(4, 2)),
         node("pd", "Pad", ["bn", "pads"])],
        ["x"], ["pd"], IMG),
    "conv3d": (
        [node("x", "Placeholder"), const("w", _f(3, 3, 3, 2, 4, scale=0.3)),
         node("c3", "Conv3D", ["x", "w"],
              strides=_lst("i", [1, 1, 2, 1, 1]), padding=b"SAME")],
        ["x"], ["c3"], _f(1, 4, 5, 5, 2)),
    "dilation2d": (
        [node("x", "Placeholder"), const("w", _f(3, 2, 3)),
         node("d", "Dilation2D", ["x", "w"],
              strides=_lst("i", [1, 2, 1, 1]), rates=_lst("i", [1, 1, 2, 1]),
              padding=b"SAME")],
        ["x"], ["d"], IMG),
    "gathers": (
        [node("ids", "Placeholder"), node("t", "Placeholder"),
         const("table", _f(6, 3)), const("ax1", np.asarray(1, np.int32)),
         node("emb", "GatherV2", ["table", "ids", "ax0"]),
         const("ax0", np.asarray(0, np.int32)),
         node("g1", "GatherV2", ["t", "ids", "ax1"]),
         node("g0", "Gather", ["t", "ids"])],
        ["ids", "t"], ["emb", "g1", "g0"],
        [_i32(0, 5, 2, 2), _f(6, 6)]),
    "arith_consts_and_tables": (
        [node("x", "Placeholder"), node("y", "Placeholder"),
         const("two", np.float32(2.0)), const("v", _f(4)),
         node("m1", "Mul", ["two", "x"]), node("a1", "AddV2", ["x", "two"]),
         node("s1", "Sub", ["x", "two"]), node("s2", "Sub", ["two", "x"]),
         node("d1", "RealDiv", ["x", "two"]),
         node("q1", "SquaredDifference", ["x", "two"]),
         node("mv", "Mul", ["v", "x"]), node("av", "Add", ["x", "v"]),
         node("mx", "Maximum", ["x", "y"]), node("mn", "Minimum", ["x", "y"]),
         node("dv", "RealDiv", ["x", "y"]), node("dd", "Div", ["x", "y"]),
         node("sq", "SquaredDifference", ["x", "y"]),
         node("an", "AddN", ["x", "y", "m1"]),
         node("pw", "Pow", ["y", "two"]), node("pt", "Pow", ["y", "x"]),
         node("sg", "StopGradient", ["x"]), node("id", "Identity", ["sg"]),
         node("ck", "CheckNumerics", ["id"])],
        ["x", "y"], ["m1", "a1", "s1", "s2", "d1", "q1", "mv", "av", "mx",
                     "mn", "dv", "dd", "sq", "an", "pw", "pt", "ck"],
        [A, POS]),
    "integer_division": (
        [node("x", "Placeholder"), node("y", "Placeholder"),
         const("c", np.asarray(2, np.int32)),
         const("a", _i32(7, -7)), const("b", _i32(2, 2)),
         node("dc", "Div", ["x", "c"]), node("cd", "Div", ["c", "x"]),
         node("dt", "Div", ["x", "y"], T={"type": 3}),
         node("ab", "Div", ["a", "b"]),
         node("fd", "FloorDiv", ["x", "y"]), node("fm", "FloorMod", ["x", "y"]),
         node("md", "Mod", ["x", "y"]), node("td", "TruncateDiv", ["x", "y"]),
         node("tm", "TruncateMod", ["x", "y"]),
         node("fdc", "FloorDiv", ["x", "c"]),
         node("fmc", "FloorMod", ["c", "y"]), node("mdc", "Mod", ["x", "c"])],
        ["x", "y"], ["dc", "cd", "dt", "ab", "fd", "fm", "md", "td", "tm",
                     "fdc", "fmc", "mdc"], [INTS, INTS_B]),
    "slices_and_shapes": (
        [node("x", "Placeholder"), const("b", _i32(0, 1, 0)),
         const("s", _i32(2, -1, 2)), node("sl", "Slice", ["x", "b", "s"]),
         const("ax", np.asarray(-1, np.int32)),
         node("ed", "ExpandDims", ["x", "ax"]),
         node("sq", "Squeeze", ["ed"], squeeze_dims=_lst("i", [3])),
         node("sqa", "Squeeze", ["ed1"]),
         node("ed1", "ExpandDims", ["x", "zero"]),
         const("zero", np.asarray(0, np.int32)),
         const("cax", np.asarray(2, np.int32)),
         node("cat", "ConcatV2", ["x", "sq", "cax"]),
         node("cat1", "Concat", ["cax", "x", "x"]),
         const("shape", _i32(-1, 4)), node("rs", "Reshape", ["x", "shape"]),
         const("sb", _i32(1, 0, 0)), const("se", _i32(0, 3, 0)),
         const("st", _i32(1, 1, -1)),
         node("ss", "StridedSlice", ["x", "sb", "se", "st"],
              end_mask=1, begin_mask=4)],
        ["x"], ["sl", "sq", "sqa", "cat", "cat1", "rs", "ss"], _f(2, 3, 4)),
    "segment_sum_lgamma": (
        [node("x", "Placeholder"), const("ids", _i32(0, 0, 1, 1)),
         node("ss", "SegmentSum", ["x", "ids"]),
         node("lg", "Lgamma", ["x"]), node("dg", "Digamma", ["x"])],
        ["x"], ["ss", "dg"], np.abs(_f(4, 1)) + 1.0),
    "tensor_array_split_concat": (
        [node("x", "Placeholder"), const("c_size", np.int32(3)),
         const("lens", _i32(2, 2, 2)),
         node("ta", "TensorArrayV3", ["c_size"], dtype={"type": 1}),
         node("spl", "TensorArraySplitV3", ["ta", "x", "lens", "ta:1"]),
         node("r1", "TensorArrayReadV3", ["ta", "one", "spl"]),
         const("one", np.int32(1)),
         node("cat", "TensorArrayConcatV3", ["ta", "spl"])],
        ["x"], ["r1", "cat"], _f(6, 4)),
    "matmul_transpose_b_mean_keep_dims": (
        [node("x", "Placeholder"),
         const("w", np.arange(6, dtype=np.float32).reshape(3, 2)),
         node("mm", "MatMul", ["x", "w"], transpose_b=True),
         const("axes", _i32(1)),
         node("m", "Mean", ["mm", "axes"], keep_dims=True)],
        ["x"], ["mm", "m"], _f(2, 2)),
}


@pytest.mark.parametrize("name", list(GRAPHS))
def test_graph_against_reference(name):
    nodes, ins, outs, feed = GRAPHS[name]
    _compare(graphdef(nodes), ins, outs, feed)


def test_lgamma_within_xla_rounding():
    """The reference's XLA lgamma is a float32 approximation off by up to
    2e-6 of the true value; the port's is torch's (libm)."""
    x = np.abs(_f(4, 1)) + 1.0
    nodes = [node("x", "Placeholder"), node("lg", "Lgamma", ["x"])]
    jg, tg = _load_both(graphdef(nodes), ["x"], ["lg"], x)
    _close(tg(torch.from_numpy(x)), jg.forward(jnp.asarray(x)), 1e-5)


def test_oracles_of_the_reference_tests():
    """The reference tests' hand-written expectations hold for the
    port's loads too."""
    g = GRAPHS
    out = _compare(graphdef(g["transpose_strided_slice_argmax"][0]), ["x"],
                   ["am"], g["transpose_strided_slice_argmax"][3])
    expect = np.arange(24).reshape(2, 3, 4).transpose(0, 2, 1)[:, :, 0] \
        .argmax(axis=1)
    np.testing.assert_array_equal(_np(out[0]), expect)
    out = _compare(graphdef(g["onehot_cast_tile"][0]), ["x"], ["tl"],
                   g["onehot_cast_tile"][3])
    assert out[0].dtype == torch.int32
    np.testing.assert_array_equal(_np(out[0])[0, 0], [1, 0, 0, 1, 0, 0])
    x = g["concat_offset_feeds_slice"][3]
    out = _compare(graphdef(g["concat_offset_feeds_slice"][0]), ["x"],
                   ["g1"], x)
    np.testing.assert_array_equal(_np(out[0]), x[:, 3:7])
    out = _compare(graphdef(g["integer_division"][0]), ["x", "y"],
                   ["dc", "ab", "dt"], [INTS, INTS_B])
    np.testing.assert_array_equal(_np(out[0]), _i32(3, -3, 4, -4, 2, 0))
    np.testing.assert_array_equal(_np(out[1]), _i32(3, -3))
    np.testing.assert_array_equal(_np(out[2]), np.trunc(INTS / INTS_B))


def test_broadcast_gradient_args_folds_into_sum():
    """The TF-grad-graph chain Shape(x) + const shape ->
    BroadcastGradientArgs -> Sum axes folds into constants."""
    x = _f(2, 3)
    shape_attr = {"shape": {"dim": [{"size": 2}, {"size": 3}]}}
    nodes = [node("x", "Placeholder", shape=shape_attr),
             node("sx", "Shape", ["x"]),
             const("sy", _i32(3)),
             node("bga", "BroadcastGradientArgs", ["sx", "sy"]),
             node("s", "Sum", ["x", "bga:1"], keep_dims=False)]
    out = _compare(graphdef(nodes), ["x"], ["s"], x)
    np.testing.assert_allclose(_np(out[0]), x.sum(axis=0), rtol=1e-6)


def test_broadcast_gradient_args_helper():
    from bigdl_tpu.interop.tf_loader import _broadcast_gradient_args as ref
    for s0, s1 in (([2, 3, 5], [1, 5]), ([2, 1, 5], [3, 5]), ([4, 4], [4, 4]),
                   ([1, 3], [1, 1])):
        for a, b in zip(tl._broadcast_gradient_args(s0, s1), ref(s0, s1)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_random_uniform_source_nodes():
    """RandomUniform is a source node with the reference's seed rule;
    draws are the port's own (torch's generator): shape, range and dtype,
    repeated draws in evaluation mode without a generator, fresh draws
    from a generator, independent draws per unseeded node."""
    x = np.zeros((2, 3), np.float32)
    nodes = [node("x", "Placeholder"), const("shape", _i32(2, 3)),
             node("u", "RandomUniform", ["shape"], dtype={"type": 1},
                  seed=7),
             node("y", "Add", ["x", "u"])]
    g = tload(graphdef(nodes), ["x"], ["y"], sample_input=x, device="cpu")
    jg = jload(graphdef(nodes), ["x"], ["y"], sample_input=jnp.asarray(x))
    u = [n.module for n in g.exec_order if n.module.get_name() == "u"][0]
    ju = [n.module for n in jg.exec_order if n.module.name == "u"][0]
    assert u.seed == ju.seed and u.shape == ju.shape
    out = g(torch.from_numpy(x))
    ref = np.asarray(jg.forward(jnp.asarray(x)))
    assert out.shape == ref.shape and _np(out).dtype == ref.dtype
    assert float(out.min()) >= 0.0 and float(out.max()) < 1.0
    assert torch.equal(out, g(torch.from_numpy(x)))
    gen = torch.Generator().manual_seed(3)
    g.train()
    a, b = g(torch.from_numpy(x), generator=gen), \
        g(torch.from_numpy(x), generator=gen)
    assert float((a - b).abs().max()) > 1e-6
    x16 = np.zeros((1, 16), np.float32)
    nodes = [node("x", "Placeholder"), const("shape", _i32(1, 16)),
             node("u1", "RandomUniform", ["shape"], dtype={"type": 1}),
             node("u2", "RandomUniform", ["shape"], dtype={"type": 1}),
             node("s", "Sub", ["u1", "u2"]), node("y", "Add", ["x", "s"])]
    g = tload(graphdef(nodes), ["x"], ["y"], sample_input=x16, device="cpu")
    assert float(g(torch.from_numpy(x16)).abs().max()) > 1e-6


# ---------------------------------------------------------- mini-BERT

def test_mini_bert_matches_numpy_oracle():
    """The reference's TestMiniBERT graph (not slow here): the port's
    import against the numpy oracle (atol 1e-4) and the reference's
    import (outputs and every weight's gradient)."""
    import test_tf_importer as ref
    w = ref._bert_weights()
    gd = ref._bert_graphdef(w)
    ids = np.asarray([[1, 5, 2, 9], [3, 3, 0, 15]], np.int32)
    out = _compare(gd, ["ids"], ["out"], ids)
    np.testing.assert_allclose(_np(out[0]), ref._bert_numpy_oracle(w, ids),
                               atol=1e-4)


# ------------------------------------------------------ variables, (b)

def test_bin_dir_variables_and_a_missing_one(tmp_path):
    """Variables from an export_tf_checkpoint.py directory (``/`` as
    ``__``) become the weights; a variable missing from the directory
    raises as in the reference."""
    w = _f(3, 4)
    b = _f(4)
    np.save(tmp_path / "dense__kernel.npy", w)
    np.save(tmp_path / "dense__bias.npy", b)
    nodes = [node("x", "Placeholder"),
             *cs.tf_variable("dense/kernel"), *cs.tf_variable("dense/bias"),
             node("mm", "MatMul", ["x", "dense/kernel/read"]),
             node("y", "BiasAdd", ["mm", "dense/bias/read"])]
    x = _f(2, 3)
    out = _compare(graphdef(nodes), ["x"], ["y"], x,
                   bin_dir=str(tmp_path))
    np.testing.assert_allclose(_np(out[0]), x @ w + b, rtol=1e-5, atol=1e-6)
    os.remove(tmp_path / "dense__bias.npy")
    errs = []
    for load in (jload, lambda *a, **k: tload(*a, device="cpu", **k)):
        with pytest.raises(AttributeError, match="'NoneType'") as e:
            load(graphdef(nodes), ["x"], ["y"], bin_dir=str(tmp_path))
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    os.remove(tmp_path / "dense__kernel.npy")
    for load in (jload, lambda *a, **k: tload(*a, device="cpu", **k)):
        with pytest.raises(ValueError, match="unsupported TF op VariableV2"):
            load(graphdef(nodes[:4] + [nodes[5]]), ["x"], ["mm"],
                 bin_dir=str(tmp_path))


def _part_b_case(op):
    """A small graph naming ``op`` (an op of ROADMAP A.11(d)(2)(b)):
    (nodes, inputs, outputs, feed, host): ``host`` the class of a
    host-side op whose imported module is held by its forward, the
    reference's graph not running those."""
    r = np.random.default_rng(zlib.crc32(op.encode()))

    def f(*shape):
        return (r.standard_normal(shape)).astype(np.float32)

    x, g = node("x", "Placeholder"), node("g", "Placeholder")
    s1 = _lst("i", [1, 1, 1, 1])
    pairs = ("ReluGrad", "Relu6Grad", "EluGrad", "SoftplusGrad",
             "SoftsignGrad", "SigmoidGrad", "TanhGrad", "SqrtGrad",
             "RsqrtGrad", "ReciprocalGrad", "InvGrad")
    if op in pairs:
        return ([g, x, node("y", op, ["g", "x"])], ["g", "x"], ["y"],
                [f(2, 5) * 4, np.abs(f(2, 5)) * 4 + 0.25], None)
    if op == "BiasAddGrad":
        return [g, node("y", op, ["g"])], ["g"], ["y"], f(2, 3, 3, 4), None
    if op.startswith("FusedBatchNormGrad"):
        names = ["dy", "x", "scale", "mean", "var"]
        feed = [f(2, 3, 3, 4), f(2, 3, 3, 4), f(4), f(4) * 0.1,
                np.abs(f(4)) + 0.5]
        return ([node(n, "Placeholder") for n in names]
                + [node("y", op, names, epsilon=1e-3)], names,
                ["y:0", "y:1", "y:2"], feed, None)
    if op == "AvgPoolGrad":
        return ([const("sizes", _i32(1, 5, 5, 2)), g,
                 node("y", op, ["sizes", "g"], ksize=_lst("i", [1, 3, 3, 1]),
                      strides=_lst("i", [1, 2, 2, 1]), padding=b"SAME")],
                ["g"], ["y"], f(1, 3, 3, 2), None)
    if op == "MaxPoolGrad":
        win = dict(ksize=_lst("i", [1, 2, 2, 1]),
                   strides=_lst("i", [1, 2, 2, 1]), padding=b"VALID")
        return ([x, g, node("mp", "MaxPool", ["x"], **win),
                 node("y", op, ["x", "mp", "g"], **win)], ["x", "g"], ["y"],
                [f(1, 4, 4, 2), f(1, 2, 2, 2)], None)
    convs = {"Conv2D": ((2, 6, 6, 3), (3, 3, 3, 4), (2, 6, 6, 4), s1),
             "DepthwiseConv2dNative": ((2, 6, 6, 3), (3, 3, 3, 2),
                                       (2, 6, 6, 6), s1),
             "Conv3D": ((1, 3, 4, 4, 2), (3, 3, 3, 2, 3), (1, 3, 4, 4, 3),
                        _lst("i", [1, 1, 1, 1, 1]))}
    base = next((k for k in convs if op.startswith(k + "Backprop")), None)
    if base is not None:
        sizes, wshape, gshape, st = convs[base]
        if "Input" in op:
            return ([const("sizes", _i32(*sizes)), const("w", f(*wshape)),
                     g, node("y", op, ["sizes", "w", "g"], strides=st,
                             padding=b"SAME")], ["g"], ["y"], f(*gshape),
                    None)
        return ([x, const("fsizes", _i32(*wshape)), g,
                 node("y", op, ["x", "fsizes", "g"], strides=st,
                      padding=b"SAME")], ["x", "g"], ["y"],
                [f(*sizes), f(*gshape)], None)
    if op == "RandomShuffle":
        return [x, node("y", op, ["x"])], ["x"], ["y"], f(5, 3), None
    if op == "ResizeBilinearGrad":
        return ([g, x, node("y", op, ["g", "x"])], ["g", "x"], ["y"],
                [f(1, 6, 8, 2), f(1, 3, 4, 2)], None)
    if op == "LRNGrad":
        return ([g, x, node("y", op, ["g", "x", "x"], depth_radius=2,
                            bias=1.5, alpha=0.3, beta=0.75)],
                ["g", "x"], ["y"], [f(1, 2, 2, 7), f(1, 2, 2, 7)], None)
    if op.startswith("Dilation2DBackprop"):
        return ([x, const("w", f(3, 3, 2)), g,
                 node("y", op, ["x", "w", "g"], strides=s1, rates=s1,
                      padding=b"SAME")], ["x", "g"], ["y"],
                [f(1, 5, 5, 2), f(1, 5, 5, 2)], None)
    if op in ("QueueDequeueV2", "QueueDequeueManyV2", "ReaderReadV2"):
        return ([node("q", op), node("y", "Relu", ["q"])], ["q"], ["y"],
                f(2, 3), None)
    if op in ("QueueEnqueueV2", "QueueEnqueueManyV2"):
        return ([x, node("q", "FIFOQueueV2"), node("r", "Relu", ["x"]),
                 node("y", op, ["q", "r"])], ["x"], ["y"], f(2, 3), None)
    if op == "BroadcastGradientArgs":
        shape = {"shape": {"dim": [{"size": 2}, {"size": 3}]}}
        return ([node("x", "Placeholder", shape=shape),
                 node("sx", "Shape", ["x"]), const("sy", _i32(3)),
                 node("y", op, ["sx", "sy"]),
                 node("s", "Sum", ["x", "y:1"], keep_dims=False)],
                ["x"], ["s", "y:0", "y:1"], f(2, 3), None)
    strings = np.asarray([b"hello", b"tensor"], dtype=object)
    if op == "Substr":
        return ([x, const("pos", _i32(1)), const("len", _i32(3)),
                 node("y", op, ["x", "pos", "len"])], ["x"], ["y"],
                strings, tt.Substr)
    if op == "DecodeRaw":
        blobs = np.asarray([_i32(1, -2, 3).astype(">i4").tobytes(),
                            _i32(4, 5, 6).astype(">i4").tobytes()],
                           dtype=object)
        return ([x, node("y", op, ["x"], out_type={"type": 3},
                         little_endian=False)], ["x"], ["y"], blobs,
                tt.DecodeRaw)
    if op.startswith("Decode"):
        from PIL import Image
        frames = [Image.fromarray(r.integers(0, 255, (4, 3, 3),
                                             dtype=np.uint8))
                  for _ in range(2)]
        buf = io.BytesIO()
        if op == "DecodeGif":
            frames[0].save(buf, format="GIF", save_all=True,
                           append_images=frames[1:])
        else:
            frames[0].save(buf, format="PNG")
        return ([x, node("y", op, ["x"], channels=3)], ["x"], ["y"],
                buf.getvalue(), tt.DecodeImage)
    if op == "ParseExample":
        from bigdl_tpu_torch.interop import build_example
        blobs = np.asarray([build_example({"v": f(2), "k": np.asarray([i])})
                            for i in range(3)], dtype=object)
        return ([x, const("names", np.zeros(0, "S1")),
                 const("k0", np.asarray(b"k")), const("k1", np.asarray(b"v")),
                 const("d0", np.zeros(0, np.int64)),
                 const("d1", np.zeros(0, np.float32)),
                 node("y", op, ["x", "names", "k0", "k1", "d0", "d1"],
                      Nsparse=0, Ndense=2, Tdense=_lst("type", [9, 1]),
                      dense_shapes=_lst("shape", [{}, {"dim": [
                          {"size": 2}]}]))],
                ["x"], ["y:0", "y:1"], blobs, tt.ParseExampleOp)
    raise KeyError(op)


PART_B = (
    "ReluGrad", "Relu6Grad", "EluGrad", "SoftplusGrad", "SoftsignGrad",
    "SigmoidGrad", "TanhGrad", "SqrtGrad", "RsqrtGrad", "ReciprocalGrad",
    "InvGrad", "BiasAddGrad", "FusedBatchNormGrad", "FusedBatchNormGradV2",
    "AvgPoolGrad", "MaxPoolGrad", "Conv2DBackpropInput",
    "DepthwiseConv2dNativeBackpropInput", "Conv3DBackpropInput",
    "Conv3DBackpropInputV2", "Conv2DBackpropFilter",
    "DepthwiseConv2dNativeBackpropFilter", "Conv3DBackpropFilter",
    "Conv3DBackpropFilterV2", "RandomShuffle", "ResizeBilinearGrad",
    "LRNGrad", "Dilation2DBackpropInput", "Dilation2DBackpropFilter",
    "QueueDequeueV2", "QueueDequeueManyV2", "ReaderReadV2",
    "BroadcastGradientArgs", "Substr", "DecodeRaw", "DecodeJpeg",
    "DecodePng", "DecodeGif", "QueueEnqueueV2", "QueueEnqueueManyV2",
    "ParseExample")


@pytest.mark.parametrize("op", PART_B)
def test_op_of_part_b_imports_like_the_reference(op):
    """Every op the port's loader refused before ROADMAP A.11(d)(2)(b)
    imports, and the imported node's output is the reference's: through
    both graphs (gradient, queue and folded ops), or, for a host-side op,
    the port graph's output against the reference module's forward."""
    nodes, ins, outs, feed, host = _part_b_case(op)
    if host is None:
        _compare(graphdef(nodes), ins, outs, feed, grads=False)
        return
    tg = tload(graphdef(nodes), ins, outs, device="cpu")
    jg = jload(graphdef(nodes), ins, outs)
    jm = [n.module for n in jg.exec_order
          if type(n.module).__name__ == host.__name__]
    assert [type(n.module) for n in tg.exec_order].count(host) == 1
    want = _outs(jm[0].forward(feed))
    got = tg(feed)
    got = got if isinstance(got, list) else [got]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(b, np.ndarray) and b.dtype == object:
            assert a.tolist() == b.tolist()
        else:
            assert isinstance(a, torch.Tensor)
            _close(a, np.asarray(b).astype(
                {np.dtype(np.int64): np.int32}.get(np.asarray(b).dtype,
                                                   np.asarray(b).dtype)))


def test_unknown_op_raises_the_references_message():
    nodes = [node("x", "Placeholder"), node("y", "NoSuchOp", ["x"])]
    msgs = []
    for load in (jload, lambda *a: tload(*a, device="cpu")):
        with pytest.raises(ValueError, match="unsupported TF op") as e:
            load(graphdef(nodes), ["x"], ["y"])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "unsupported TF op NoSuchOp (y)"


def test_layers_are_seeded_until_weights_apply():
    """Without ``sample_input`` the graph's layers hold seeded weights;
    ``apply_tf_weights`` copies the imported ones in."""
    w = _f(3, 4)
    nodes = [node("x", "Placeholder"), const("w", w),
             node("y", "MatMul", ["x", "w"])]
    g = tload(graphdef(nodes), ["x"], ["y"], device="cpu")
    lin = g.exec_order[-1].module
    assert not np.allclose(_np(lin.weight), w.T)
    assert lin.weight.abs().max() > 0
    tl.apply_tf_weights(g)
    np.testing.assert_array_equal(_np(lin.weight), w.T)
    with pytest.raises(RuntimeError, match="CUDA|cuda"):
        tload(graphdef(nodes), ["x"], ["y"])


# ------------------------------------------------------------ routes

def test_routes_over_an_imported_vgg_graph(tmp_path):
    """``layer_walk``, ``conv_routes`` and ``model_flops`` walk an
    imported graph: NHWC convolutions are counted, pooling and a Pad
    change (h, w)."""
    nodes, var = cs.vgg16_tf_graph(blocks=((2, 8), (1, 16)), image=16,
                                   fc=32, classes=10, seed=1)
    cs.write_npy_dir(str(tmp_path), var)
    g = tload(graphdef(nodes), ["input"], ["vgg_16/fc8/squeezed"],
              bin_dir=str(tmp_path), device="cpu")
    walk = [(m.get_name(), hw, grad) for m, hw, grad in
            layer_walk(g, (16, 16)) if isinstance(m, tnn.SpatialConvolution)]
    assert walk == [("vgg_16/conv1/conv1_1/Conv2D", (16, 16), False),
                    ("vgg_16/conv1/conv1_2/Conv2D", (16, 16), True),
                    ("vgg_16/conv2/conv2_1/Conv2D", (8, 8), True),
                    ("vgg_16/fc6/Conv2D", (4, 4), True),
                    ("vgg_16/fc7/Conv2D", (1, 1), True),
                    ("vgg_16/fc8/Conv2D", (1, 1), True)]
    # conv1_1 forward only (its input is the images); conv1_2 and conv2_1
    # forward and input gradient, each on the kernel its channels pick
    from bigdl_tpu_torch.ops.conv3x3 import kernel_for
    want = {"i2c": 0, "k9": 0, "library": 3}
    for cin in (3, 8, 8, 8, 16):
        want[kernel_for(cin)] += 1
    assert conv_routes(g, (16, 16)) == want
    flops = 2 * (16 * 16 * 9 * 3 * 8 + 16 * 16 * 9 * 8 * 8
                 + 8 * 8 * 9 * 8 * 16 + 4 * 4 * 16 * 32 + 32 * 32
                 + 32 * 10)
    assert model_flops(g, (16, 16)) == flops
    pad = tl._PadModule(np.asarray([[0, 0], [1, 2], [3, 0], [0, 0]]))
    assert pad.output_hw(5, 6) == (8, 9)
    from bigdl_tpu_torch.ops.tf_ops import Dilation2D, ResizeBilinear
    assert ResizeBilinear((7, 9)).output_hw(3, 4) == (7, 9)
    assert Dilation2D(np.zeros((3, 3, 1)), (2, 2), (1, 1), "VALID") \
        .output_hw(9, 8) == (4, 3)


# -------------------------------------------------------------- save_tf

def _mlp(nn, dev):
    kw = {} if dev is None else {"device": dev}
    return nn.Sequential(nn.Linear(12, 8, **kw), nn.ReLU(),
                         nn.Linear(8, 5, **kw), nn.LogSoftMax())


def _nhwc_convnet(nn, dev):
    kw = {} if dev is None else {"device": dev}
    return nn.Sequential(
        nn.SpatialConvolution(3, 6, 3, 3, 1, 1, -1, -1, format="NHWC", **kw),
        nn.ReLU(),
        nn.SpatialMaxPooling(2, 2, 2, 2, format="NHWC"),
        nn.Flatten(),
        nn.Linear(7 * 7 * 6, 4, **kw))


SAVE_CASES = {"mlp": (_mlp, (4, 12), 4), "nhwc_convnet": (_nhwc_convnet,
                                                          (2, 14, 14, 3), 5)}


@pytest.mark.parametrize("case", list(SAVE_CASES))
def test_save_tf_cross(tmp_path, case):
    """The reference's TF round trips: the same module and weights in
    both packages give the same GraphDef bytes, and each package loads
    either file to the source's outputs (1e-5 of their largest
    magnitude)."""
    import bigdl_tpu.nn as jnn
    make, shape, seed = SAVE_CASES[case]
    jm = make(jnn, None).build(seed, shape)
    jm.evaluate()
    tm = make(tnn, "cpu")
    p = jax.tree_util.tree_map(np.asarray, jm.params)
    tm.load_state_dict(convert.module_params_from_jax(tm, p))
    x = np.random.RandomState(seed).randn(*shape).astype("float32")
    want = np.asarray(jm.forward(jnp.asarray(x)))
    tm.evaluate()
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), want, 1e-5)
    files, names = {}, {}
    for who, save, model in (("port", tsave, tm), ("ref", jsave, jm)):
        files[who] = str(tmp_path / f"{who}.pb")
        names[who] = save(model, files[who], shape)
    assert names["port"] == names["ref"]
    assert open(files["port"], "rb").read() == open(files["ref"], "rb")\
        .read()
    for path in files.values():
        tg = tload(path, ["input"], [names["port"]], sample_input=shape,
                   device="cpu")
        with torch.no_grad():
            _close(tg(torch.from_numpy(x)), want, 1e-5)
        jg = jload(path, ["input"], [names["port"]], sample_input=shape)
        _close(np.asarray(jg.forward(jnp.asarray(x))), want, 1e-5)


def test_save_tf_refusals(tmp_path):
    """NCHW convolutions and several outputs are refused with the
    reference's messages; an existing file needs overwrite."""
    import bigdl_tpu.nn as jnn
    jm = jnn.Sequential(jnn.SpatialConvolution(3, 6, 3, 3)) \
        .build(6, (1, 3, 8, 8))
    tm = tnn.Sequential(tnn.SpatialConvolution(3, 6, 3, 3, device="cpu"))
    tm.reset(0)
    errs = []
    for save, m in ((jsave, jm), (tsave, tm)):
        with pytest.raises(ValueError, match="NHWC") as e:
            save(m, str(tmp_path / "n.pb"), (1, 3, 8, 8), overwrite=True)
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    errs = []
    for nn, kw, build in ((jnn, {}, True), (tnn, {"device": "cpu"}, False)):
        inp = nn.Input()
        g = nn.Graph([inp], [nn.ReLU()(inp), nn.Tanh()(inp)])
        if build:
            g.build(0, (2, 3))
        with pytest.raises(ValueError, match="single-output") as e:
            (jsave if build else tsave)(g, str(tmp_path / "g.pb"), (2, 3),
                                        overwrite=True)
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    m = tnn.Sequential(tnn.ReLU())
    TensorflowSaver.save(m, str(tmp_path / "r.pb"), (1, 3))
    with pytest.raises(FileExistsError, match="overwrite=True"):
        tsave(m, str(tmp_path / "r.pb"), (1, 3))
    tsave(m, str(tmp_path / "r.pb"), (1, 3), overwrite=True)
