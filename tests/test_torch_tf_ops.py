"""The TF-style operation layers, control flow and new layers of the port
(``bigdl_tpu_torch/ops/tf_ops.py``, ``ops/control_ops.py``, the 12 layers
of ``nn/``) against the JAX reference's (``bigdl_tpu/ops``,
``bigdl_tpu/nn``), on the CPU, on the same seeded numpy inputs.

Forward outputs agree within 1e-6 of their largest magnitude (integers
and booleans exactly) and have the reference's dtypes (JAX without x64:
int32 where torch would give int64); gradients of a differentiable op
with respect to each float input (and a layer's parameters) agree with
``jax.vjp`` within 1e-4 of their largest magnitude. Also: the port
``Graph``'s source nodes and Table inputs in sorted-key order against
the reference's ``Graph``, ``Cond``'s zero gradients for the branch it did
not run, ``WhileLoop``'s ``max_iters``, ``convert`` of ``CMul``, and what
``RandomUniform`` can hold across packages (shape, range, dtype, draws
per node and per seed; the numbers themselves are torch's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu import ops as jops
from bigdl_tpu.ops import tf_ops as jt
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import ops as tops
from bigdl_tpu_torch.ops import tf_ops as tt
from bigdl_tpu_torch.utils.table import T as TT

OUT_REL = 1e-6
GRAD_REL = 1e-4


def _np(y):
    if isinstance(y, torch.Tensor):
        return y.detach().numpy()
    return np.asarray(y)


def _close(got, want, rel=OUT_REL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
        return
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    if fin.any():
        scale = max(float(np.abs(want[fin]).max()), 1e-30)
        assert float(np.abs(got[fin] - want[fin]).max()) <= rel * scale


def _outs(y):
    """A table output (a reference Table, a port list) as a list."""
    if isinstance(y, dict):
        return [y[k] for k in sorted(y)]
    if isinstance(y, (list, tuple)):
        return list(y)
    return [y]


def _ref_apply(m, xs, table):
    x = JT(*xs) if table else xs[0]
    return m.apply(m.params, m.state, x)[0]


def _check_op(make, xs, table=False, grads=True, rel=OUT_REL):
    """``make(package)`` in both packages on the numpy inputs ``xs``."""
    jm = make(jt).build(0, None)
    jx = [jnp.asarray(a) for a in xs]
    want = _ref_apply(jm, jx, table)
    tm = make(tt)
    tx = [torch.from_numpy(np.array(a)) for a in xs]
    for a in tx:
        if a.is_floating_point():
            a.requires_grad_(True)
    got = tm(tx) if table else tm(tx[0])
    for g, w in zip(_outs(got), _outs(want)):
        _close(g, w, rel)
    floats = [i for i, a in enumerate(xs) if np.asarray(a).dtype.kind == "f"]
    outs = [(i, w) for i, w in enumerate(_outs(want))
            if np.asarray(w).dtype.kind == "f"]
    if not (grads and floats and outs):
        return
    i_out, w = outs[0]
    cot = np.random.default_rng(3).standard_normal(np.shape(w)) \
        .astype(np.float32)

    def f(*fl):
        full = list(jx)
        for i, v in zip(floats, fl):
            full[i] = v
        return _outs(_ref_apply(jm, full, table))[i_out]

    _, vjp = jax.vjp(f, *[jx[i] for i in floats])
    jg = vjp(jnp.asarray(cot))
    y = _outs(got)[i_out]
    tg = (torch.autograd.grad(y, [tx[i] for i in floats],
                              torch.from_numpy(cot), allow_unused=True)
          if y.requires_grad else [None] * len(floats))
    for i, g, w in zip(floats, tg, jg):
        g = torch.zeros_like(tx[i]) if g is None else g
        _close(g, w, GRAD_REL)


R = np.random.default_rng(0)


def _f(*shape, lo=-2.0, hi=2.0):
    return R.uniform(lo, hi, shape).astype(np.float32)


A, B = _f(3, 4), _f(3, 4)
B[0, :2] = A[0, :2]                       # ties for the comparisons
POS = _f(3, 4, lo=0.5, hi=3.0)
HALVES = np.asarray([[-2.5, -1.5, -0.5, 0.5], [1.5, 2.5, 0.3, -0.7]],
                    np.float32)
BOOL_A = R.random((3, 4)) > 0.5
BOOL_B = R.random((3, 4)) > 0.5
INT_A = np.asarray([[7, -7, 9, -9], [5, -5, 3, 0]], np.int32)
INT_B = np.asarray([[2, 2, -4, -4], [3, 3, -2, 1]], np.int32)
IMG = _f(2, 4, 5, 3)
DIL_W = (_f(3, 2, 3), _f(2, 3, 3))

UNARY = {
    "LogicalNot": (lambda p: p.LogicalNot(), [BOOL_A]),
    "Pow_const": (lambda p: p.Pow(2.0), [A]),
    "Erf": (lambda p: p.Erf(), [A]),
    "Exp": (lambda p: p.Exp(), [A]),
    "Log1p": (lambda p: p.Log1p(), [POS]),
    "Floor": (lambda p: p.Floor(), [A]),
    "Ceil": (lambda p: p.Ceil(), [A]),
    "Round": (lambda p: p.Round(), [HALVES]),
    "Sign": (lambda p: p.Sign(), [A]),
    "Cast_int64": (lambda p: p.Cast(np.int64), [A * 3]),
    "Cast_float": (lambda p: p.Cast(np.float32), [INT_A]),
    "Cast_bool": (lambda p: p.Cast(np.bool_), [INT_A]),
    "Rank": (lambda p: p.Rank(), [IMG]),
    "Shape": (lambda p: p.Shape(), [IMG]),
    "All": (lambda p: p.All(axis=(1,), keep_dims=True), [BOOL_A]),
    "Any": (lambda p: p.Any(axis=(0, 1)), [BOOL_A]),
    "All_no_axes": (lambda p: p.All(axis=()), [BOOL_A]),
    "Prod": (lambda p: p.Prod(axis=(0, 2), keep_dims=True), [_f(2, 3, 4)]),
    "Prod_int": (lambda p: p.Prod(axis=(1,)), [INT_A]),
    "ArgMax": (lambda p: p.ArgMax(1), [A]),
    "ArgMin": (lambda p: p.ArgMin(0), [A]),
    "TopK": (lambda p: p.TopK(2), [np.asarray([[1., 5., 3., 5.],
                                               [2., 2., 2., 1.]],
                                              np.float32)]),
    "OneHot": (lambda p: p.OneHot(3, 2.0, -1.0),
               [np.asarray([[0, 2], [1, 5]], np.int32)]),
    "OneHot_axis0": (lambda p: p.OneHot(4, axis=0),
                     [np.asarray([3, 0, -1], np.int32)]),
    "Slice": (lambda p: p.Slice([1, 0, 2], [1, -1, 2]), [_f(3, 4, 5)]),
    "StridedSlice": (lambda p: p.StridedSlice(
        [0, 1, 4], [2, 3, 0], [1, 1, -2], begin_mask=1, end_mask=4,
        shrink_axis_mask=2), [_f(3, 4, 6)]),
    "ExpandDims": (lambda p: p.ExpandDims(-1), [A]),
    "Tile": (lambda p: p.Tile([2, 1, 3]), [_f(2, 3, 1)]),
    "InvertPermutation": (lambda p: p.InvertPermutation(),
                          [np.asarray([3, 4, 0, 2, 1], np.int32)]),
    "Reciprocal": (lambda p: p.Reciprocal(), [POS]),
    "Reciprocal_int": (lambda p: p.Reciprocal(), [INT_B]),
    "Expm1": (lambda p: p.Expm1(), [A]),
    "Erfc": (lambda p: p.Erfc(), [A]),
    "IsFinite": (lambda p: p.IsFinite(),
                 [np.asarray([1.0, np.inf, -np.inf, np.nan], np.float32)]),
    "IsInf": (lambda p: p.IsInf(),
              [np.asarray([1.0, np.inf, -np.inf, np.nan], np.float32)]),
    "IsNan": (lambda p: p.IsNan(),
              [np.asarray([1.0, np.inf, -np.inf, np.nan], np.float32)]),
    "ZerosLike": (lambda p: p.ZerosLike(), [INT_A]),
    "OnesLike": (lambda p: p.OnesLike(), [A]),
    "L2Loss": (lambda p: p.L2Loss(), [A]),
    "LeakyRelu": (lambda p: p.LeakyRelu(0.1), [A]),
    "Unpack": (lambda p: p.Unpack(axis=1, num=3), [_f(2, 3, 4)]),
    "SplitTF": (lambda p: p.SplitTF(2, axis=1), [A]),
    "ResizeBilinear_up": (lambda p: p.ResizeBilinear((8, 10)), [IMG]),
    "ResizeBilinear_down": (lambda p: p.ResizeBilinear((3, 2)),
                            [_f(2, 7, 5, 3)]),
    "ResizeBilinear_mixed": (lambda p: p.ResizeBilinear((9, 3)),
                             [_f(1, 4, 7, 2)]),
    "ResizeBilinear_width": (lambda p: p.ResizeBilinear((4, 9)), [IMG]),
    "ResizeBilinear_corners": (lambda p: p.ResizeBilinear(
        (7, 9), align_corners=True), [IMG]),
    "ReduceMax": (lambda p: p.ReduceMax(axis=(0, 2), keep_dims=True),
                  [np.round(_f(3, 2, 4))]),
    "ReduceMin": (lambda p: p.ReduceMin(axis=(1,)), [np.round(A)]),
    "Lgamma": (lambda p: p.Lgamma(), [POS]),
    "Digamma": (lambda p: p.Digamma(), [POS]),
    "SegmentSumConst": (lambda p: p.SegmentSumConst([0, 0, 2]), [A]),
    "Dilation2D_same": (lambda p: p.Dilation2D(DIL_W[0], (2, 1), (1, 2),
                                               "SAME"), [_f(2, 7, 6, 3)]),
    "Dilation2D_valid": (lambda p: p.Dilation2D(DIL_W[1], (1, 2), (2, 1),
                                                "VALID"), [_f(2, 7, 6, 3)]),
    "TensorArrayRead_const": (lambda p: p.TensorArrayRead(2), [_f(4, 3)]),
    "TensorArrayGather": (lambda p: p.TensorArrayGather([3, 0, 0]),
                          [_f(4, 3)]),
    "TensorArrayGather_arange": (lambda p: p.TensorArrayGather(
        np.arange(4)), [_f(4, 3)]),
    "TensorArrayScatter": (lambda p: p.TensorArrayScatter([2, 0, 1]),
                           [_f(3, 2)]),
    "TensorArrayConcat": (lambda p: p.TensorArrayConcat(), [_f(3, 2, 4)]),
    "TensorArraySplit": (lambda p: p.TensorArraySplit([2, 2, 2]),
                         [_f(6, 4)]),
}

TABLE = {
    "Greater": (lambda p: p.Greater(), [A, B]),
    "GreaterEqual": (lambda p: p.GreaterEqual(), [A, B]),
    "Less": (lambda p: p.Less(), [A, B]),
    "LessEqual": (lambda p: p.LessEqual(), [A, B]),
    "Equal": (lambda p: p.Equal(), [A, B]),
    "NotEqual": (lambda p: p.NotEqual(), [A, B]),
    "LogicalAnd": (lambda p: p.LogicalAnd(), [BOOL_A, BOOL_B]),
    "LogicalOr": (lambda p: p.LogicalOr(), [BOOL_A, BOOL_B]),
    "Pow": (lambda p: p.Pow(), [POS, B]),
    "InTopK": (lambda p: p.InTopK(2), [A, np.asarray([0, 3, 1], np.int32)]),
    "Gather": (lambda p: p.Gather(axis=1),
               [_f(3, 5, 2), np.asarray([[4, 0], [-1, 2]], np.int32)]),
    "SegmentSum": (lambda p: p.SegmentSum(4),
                   [A, np.asarray([0, 3, 0], np.int32)]),
    "Pack": (lambda p: p.Pack(axis=1), [A, B]),
    "FloorDiv_int": (lambda p: p.FloorDiv(), [INT_A, INT_B]),
    "FloorMod_int": (lambda p: p.FloorMod(), [INT_A, INT_B]),
    "TruncateDiv_int": (lambda p: p.TruncateDiv(), [INT_A, INT_B]),
    "TruncateMod_int": (lambda p: p.TruncateMod(), [INT_A, INT_B]),
    "FloorDiv": (lambda p: p.FloorDiv(), [A * 3, B]),
    "FloorMod": (lambda p: p.FloorMod(), [A * 3, POS]),
    "TruncateDiv": (lambda p: p.TruncateDiv(), [A * 3, B]),
    "ApproximateEqual": (lambda p: p.ApproximateEqual(0.5), [A, B]),
    "SoftmaxCrossEntropyWithLogits": (
        lambda p: p.SoftmaxCrossEntropyWithLogits(),
        [A, np.eye(4, dtype=np.float32)[[1, 3, 0]]]),
    "TensorArrayWrite": (lambda p: p.TensorArrayWrite(),
                         [np.asarray(2, np.int32), _f(3), _f(4, 3)]),
    "TensorArrayRead": (lambda p: p.TensorArrayRead(),
                        [np.asarray([1], np.int32), _f(4, 3)]),
}


# XLA's float32 lgamma is off by up to 2e-6 of the true value (a float64
# reference) at these inputs, torch's by 2e-8
SPECIAL_REL = {"Lgamma": 1e-5}


@pytest.mark.parametrize("name", list(UNARY))
def test_op_forward_and_grad(name):
    make, xs = UNARY[name]
    _check_op(make, xs, rel=SPECIAL_REL.get(name, OUT_REL))


@pytest.mark.parametrize("name", list(TABLE))
def test_table_op_forward_and_grad(name):
    make, xs = TABLE[name]
    _check_op(make, xs, table=True)


def test_truncate_mod_of_floats_is_fmod():
    """The reference computes ``a - trunc(a / b) * b`` in float32; the
    port's ``torch.fmod`` is exact: they agree within the reference's
    rounding."""
    a, b = A * 3, POS
    want = np.asarray(jt.TruncateMod().build(0, None).forward(
        JT(jnp.asarray(a), jnp.asarray(b))))
    got = tt.TruncateMod()([torch.from_numpy(a), torch.from_numpy(b)])
    _close(got, want, 1e-5)
    assert np.all(np.sign(_np(got)[_np(got) != 0])
                  == np.sign(a[_np(got) != 0]))


def test_tensor_array_split_refuses_uneven_lengths():
    for pkg in (jt, tt):
        with pytest.raises(ValueError, match="uneven"):
            pkg.TensorArraySplit([4, 2])


def test_tfconv3d_against_reference():
    x = _f(2, 4, 5, 6, 2)
    w = _f(3, 2, 3, 2, 4)
    for pad, st in (("SAME", (1, 2, 1)), ("VALID", (2, 1, 1))):
        jm = jt.TFConv3D(w.shape, st, pad).build(0, jnp.asarray(x))
        params = {"weight": jnp.asarray(w)}
        tm = tt.TFConv3D(w.shape, st, pad, device="cpu")
        with torch.no_grad():
            tm.weight.copy_(convert._leaf_from_jax(tm, "weight", w))
        xt = torch.from_numpy(x).requires_grad_(True)
        y = tm(xt)
        want, vjp = jax.vjp(lambda p, v: jm.apply(p, {}, v)[0], params,
                            jnp.asarray(x))
        _close(y, want, 1e-5)
        cot = np.random.default_rng(1).standard_normal(y.shape) \
            .astype(np.float32)
        gp, gx = vjp(jnp.asarray(cot))
        tgx, tgw = torch.autograd.grad(y, [xt, tm.weight],
                                       torch.from_numpy(cot))
        _close(tgx, gx, GRAD_REL)
        _close(convert._leaf_to_jax(tm, "weight", tgw), gp["weight"],
               GRAD_REL)


def test_const_source_values_and_dtypes():
    vals = (np.asarray([1, 2], np.int64), np.float64(2.5))
    want = jt.ConstSource(*vals).build(0, None).forward(None)
    got = tt.ConstSource(*vals, device="cpu")(None)
    for g, w in zip(got, _outs(want)):
        _close(g, w)
    one = tt.ConstSource(np.asarray([[3]], np.int64), device="cpu")
    assert one(None).dtype == torch.int32
    assert tt.ConstSource.is_source and tt.RandomUniform.is_source


def test_operation_backward_raises():
    m = tops.ArgMax()
    x = torch.tensor([[1.0, 2.0]])
    m(x)
    with pytest.raises(RuntimeError, match="Operation"):
        m.backward(x, torch.zeros(1, dtype=torch.int32))


def test_ops_package_exports_the_references_forward_names():
    """``bigdl_tpu_torch.ops`` exports every name of the reference's
    ``ops``, the feature columns included."""
    import bigdl_tpu.ops as ref
    for n in (n for n in dir(ref) if n[0].isupper()):
        assert hasattr(tops, n), n
    for n in ("BucketizedCol", "CategoricalColHashBucket",
              "CategoricalColVocaList", "CrossCol", "IndicatorCol",
              "MkString"):
        assert getattr(tops, n) is getattr(tt, n)
    from bigdl_tpu_torch.ops.flash_attention import flash_attention
    assert callable(flash_attention)


# ------------------------------------------------------------ new layers

LAYERS = {
    "CDivTable": (lambda p: p.CDivTable(), [A, POS], True),
    "CMinTable": (lambda p: p.CMinTable(), [A, B], True),
    "MM": (lambda p: p.MM(), [_f(2, 3, 4), _f(2, 4, 5)], True),
    "MM_trans": (lambda p: p.MM(trans_a=True, trans_b=True),
                 [_f(2, 4, 3), _f(2, 5, 4)], True),
    "MM_2d": (lambda p: p.MM(trans_b=True), [_f(3, 4), _f(5, 4)], True),
    "Squeeze": (lambda p: p.Squeeze(1), [_f(2, 1, 3)], False),
    "Squeeze_all": (lambda p: p.Squeeze(), [_f(1, 3, 1, 2)], False),
    "Squeeze_batch": (lambda p: p.Squeeze(0, batch_mode=True),
                      [_f(2, 1, 3)], False),
    "Mean": (lambda p: p.Mean(dimension=(0, 2), squeeze=False),
             [_f(2, 3, 4)], False),
    "Mean_int": (lambda p: p.Mean(dimension=1), [INT_A], False),
    "Sum": (lambda p: p.Sum(dimension=(1,)), [_f(2, 3, 4)], False),
    "Sum_int": (lambda p: p.Sum(dimension=(0, 1), squeeze=False), [INT_A],
                False),
    "Sum_average": (lambda p: p.Sum(dimension=2, size_average=True),
                    [_f(2, 3, 4)], False),
    "Sum_no_axes": (lambda p: p.Sum(dimension=()), [INT_A], False),
    "ReLU6": (lambda p: p.ReLU6(), [A * 5], False),
    "SoftSign": (lambda p: p.SoftSign(), [A], False),
    "Square": (lambda p: p.Square(), [A], False),
    "Sqrt": (lambda p: p.Sqrt(), [POS], False),
    "Negative": (lambda p: p.Negative(), [A], False),
}


def _carry(tm, jp):
    """The reference layer's params ``jp`` into the port's layer ``tm``."""
    sd = convert.module_params_from_jax(
        tnn.Sequential(tm), [jax.tree_util.tree_map(np.asarray, jp)])
    tm.load_state_dict({k[2:]: v for k, v in sd.items()})
    return tm


def _check_layer(make, xs, table, params=None):
    jm = make(jnn)
    jx = [jnp.asarray(a) for a in xs]
    x = JT(*jx) if table else jx[0]
    jm.build(0, x)
    jp = params if params is not None else jm.params
    tm = make(tnn)
    if params is not None:
        _carry(tm, jp)
    tx = [torch.from_numpy(np.array(a)) for a in xs]
    for a in tx:
        if a.is_floating_point():
            a.requires_grad_(True)
    y = tm(tx) if table else tm(tx[0])
    want = jm.apply(jp, jm.state, x)[0]
    _close(y, want)
    floats = [i for i, a in enumerate(xs) if np.asarray(a).dtype.kind == "f"]
    if not floats or not y.is_floating_point():
        return
    cot = np.random.default_rng(4).standard_normal(tuple(y.shape)) \
        .astype(np.float32)

    def f(p, *fl):
        full = list(jx)
        for i, v in zip(floats, fl):
            full[i] = v
        return jm.apply(p, jm.state, JT(*full) if table else full[0])[0]

    _, vjp = jax.vjp(f, jp, *[jx[i] for i in floats])
    jg = vjp(jnp.asarray(cot))
    tp = list(tm.parameters())
    tg = torch.autograd.grad(y, [tx[i] for i in floats] + tp,
                             torch.from_numpy(cot))
    for g, w in zip(tg, jg[1:]):
        _close(g, w, GRAD_REL)
    for (name, _), g in zip(tm.named_parameters(), tg[len(floats):]):
        _close(convert._leaf_to_jax(tm, name, g), jg[0][name], GRAD_REL)


@pytest.mark.parametrize("name", list(LAYERS))
def test_new_layer_against_reference(name):
    make, xs, table = LAYERS[name]
    _check_layer(make, xs, table)


@pytest.mark.parametrize("size", [(4,), (3, 4), (1, 1, 4)])
def test_cmul_against_reference_and_convert(size):
    """CMul's weight crosses through ``convert`` untransposed (a 2-D one
    too) both ways, and computes the reference's forward and gradients."""
    w = _f(*size)
    _check_layer(lambda p: p.CMul(size) if p is jnn
                 else p.CMul(size, device="cpu"), [_f(2, 3, 4)], False,
                 params={"weight": jnp.asarray(w)})
    tm = tnn.Sequential(tnn.CMul(size, device="cpu"))
    sd = convert.module_params_from_jax(tm, [{"weight": w}])
    assert tuple(sd["0.weight"].shape) == size
    tm.load_state_dict(sd)
    params, _ = convert.module_params_to_jax(tm)
    np.testing.assert_array_equal(params[0]["weight"], w)
    fresh = tnn.CMul(size, device="cpu")
    tnn.Sequential(fresh).reset(3)
    bound = 1.0 / np.sqrt(np.prod(size))
    assert float(fresh.weight.abs().max()) <= bound


def test_squeeze_refuses_an_axis_of_size_not_one():
    with pytest.raises(ValueError, match="size not equal to one"):
        jnn.Squeeze(1).build(0, None).forward(jnp.ones((2, 3)))
    with pytest.raises(ValueError, match="size not equal to one"):
        tnn.Squeeze(1)(torch.ones(2, 3))


# ---------------------------------------------------------- control flow

def _linear_pair(seed):
    jl = jnn.Linear(3, 3)
    jl.build(seed, jnp.ones((2, 3)))
    tl = _carry(tnn.Linear(3, 3, device="cpu"), jl.params)
    return jl, tl


@pytest.mark.parametrize("pred", [True, False])
def test_cond_against_reference_with_zero_grads(pred):
    """Cond runs the selected branch; the other branch's parameters get
    zero gradients (not None), as lax.cond's gradient gives them."""
    jthen, tthen = _linear_pair(1)
    jelse, telse = _linear_pair(2)
    jm = jops.Cond(jthen, jelse)
    x = _f(2, 3)
    jm.build(0, JT(jnp.asarray(True), jnp.asarray(x)))
    params = {"then": jthen.params, "else": jelse.params}
    tm = tops.Cond(tthen, telse)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tm([torch.tensor(pred), xt])
    want, vjp = jax.vjp(lambda p, v: jm.apply(
        p, jm.state, JT(jnp.asarray(pred), v))[0], params, jnp.asarray(x))
    _close(y, want)
    cot = np.ones(tuple(y.shape), np.float32)
    gp, gx = vjp(jnp.asarray(cot))
    names = [("then", tthen), ("else", telse)]
    tg = torch.autograd.grad(
        y, [xt] + [p for _, m in names for p in m.parameters()],
        torch.from_numpy(cot))
    _close(tg[0], gx, GRAD_REL)
    i = 1
    for key, m in names:
        for leaf, _ in m.named_parameters():
            g = tg[i]
            i += 1
            assert g is not None
            _close(convert._leaf_to_jax(m, leaf, g), gp[key][leaf], GRAD_REL)
    taken = tthen if pred else telse
    other = telse if pred else tthen
    for g, (_, p) in zip(tg[1:], [(k, p) for k, m in names
                                  for p in m.parameters()]):
        owner = tthen if any(p is q for q in tthen.parameters()) else telse
        assert (float(g.abs().max()) > 0) == (owner is taken)
    assert taken is not other


def test_cond_with_pred_fn_and_adam_steps_every_parameter():
    """Through the port's train step (Adam), the branch not taken keeps
    its weights: a zero gradient gives Adam a zero update."""
    from bigdl_tpu_torch.optim import Adam, make_train_step
    tthen = tnn.Linear(3, 3, device="cpu")
    telse = tnn.Linear(3, 3, device="cpu")
    m = tops.Cond(tthen, telse, pred_fn=lambda v: v.sum() > 0)
    tnn.Sequential(m).reset(0)
    before = {k: v.clone() for k, v in m.state_dict().items()}
    opt = Adam(learningrate=0.1)
    state = opt.init_state(dict(m.named_parameters()))
    step = make_train_step(m, lambda out, y: ((out - y) ** 2).mean(), opt)
    x = torch.ones(2, 3)
    step(state, x, torch.zeros(2, 3))
    after = m.state_dict()
    for k in before:
        moved = not torch.equal(before[k], after[k])
        assert moved == k.startswith("then_module"), k


def test_while_loop_against_reference():
    jm = jops.WhileLoop(jnn.MulConstant(2.0),
                        cond_fn=lambda v: v.sum() < 100.0)
    jm.build(0, (2,))
    want = jm.forward(jnp.ones((2,)))
    tm = tops.WhileLoop(tnn.MulConstant(2.0),
                        cond_fn=lambda v: v.sum() < 100.0)
    got = tm(torch.ones(2))
    _close(got, want)
    assert tm.host_syncs == 7


@pytest.mark.parametrize("max_iters", [0, 1, 5])
def test_while_loop_max_iters(max_iters):
    jm = jops.WhileLoop(jnn.MulConstant(2.0), cond_fn=lambda v: True,
                        max_iters=max_iters)
    jm.build(0, (1,))
    want = jm.forward(jnp.ones((1,)))
    got = tops.WhileLoop(tnn.MulConstant(2.0), cond_fn=lambda v: True,
                         max_iters=max_iters)(torch.ones(1))
    _close(got, want)
    assert float(got[0]) == 2.0 ** max_iters


def test_select_against_reference():
    c = np.asarray([True, False, True])
    a, b = _f(3), _f(3)
    want = jops.Select().build(0, None).forward(
        JT(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b)))
    for x in ([torch.from_numpy(c), torch.from_numpy(a),
               torch.from_numpy(b)],
              TT(torch.from_numpy(c), torch.from_numpy(a),
                 torch.from_numpy(b))):
        _close(tops.Select()(x), want)


# ---------------------------------------------------------------- graphs

def test_graph_table_input_in_sorted_key_order():
    """The reference's TestGraphTableInputOrder on both packages: a Table
    built out of order feeds the inputs by sorted key. Before the repair
    the port's Graph read ``list(table)``, the keys."""
    x1, x2 = np.ones((1, 2), np.float32), np.full((1, 2), 2.0, np.float32)
    outs = []
    for nn, T, arr in ((jnn, JT, jnp.asarray), (tnn, TT, torch.from_numpy)):
        i1, i2 = nn.Input(), nn.Input()
        a = nn.MulConstant(10.0)(i1)
        b = nn.MulConstant(100.0)(i2)
        g = nn.Graph([i1, i2], nn.CAddTable()(a, b))
        t = T()
        t[2] = arr(x2)
        t[1] = arr(x1)
        if nn is jnn:
            g.build(0, T(arr(x1), arr(x2)))
        outs.append(_np(g.forward(t)))
        outs.append(_np(g.forward([arr(x1), arr(x2)])))
    for o in outs:
        np.testing.assert_allclose(o, 10.0 * 1 + 100.0 * 2)


def test_graph_source_nodes():
    """A node with no inputs whose module sets ``is_source`` gets None, as
    in the reference; any other such node raises the reference's
    message."""
    x = _f(2, 3)
    c = np.asarray([[1.0, 2.0, 3.0]], np.float32)
    outs = []
    for nn, pkg, kw in ((jnn, jt, {}), (tnn, tt, {"device": "cpu"})):
        inp = nn.Input()
        src = nn.Node(pkg.ConstSource(c, **kw)) if nn is tnn \
            else __import__("bigdl_tpu.nn.graph", fromlist=["Node"]) \
            .Node(pkg.ConstSource(c))
        g = nn.Graph([inp], nn.CAddTable()(inp, src))
        if nn is jnn:
            g.build(0, jnp.asarray(x))
            outs.append(np.asarray(g.forward(jnp.asarray(x))))
        else:
            outs.append(_np(g(torch.from_numpy(x))))
    _close(outs[1], outs[0])
    inp = tnn.Input()
    lone = tnn.Node(tnn.MulConstant(2.0).set_name("lone"))
    with pytest.raises(ValueError, match="has no inputs and is not a graph "
                                         "input"):
        tnn.Graph([inp], tnn.CAddTable()(inp, lone))(torch.ones(1))


# -------------------------------------------------------- RandomUniform

def test_random_uniform():
    """What the reference's tests hold (tests/test_tf_importer.py
    RandomUniform cases), in the port: shape, range and dtype; repeated
    draws without a generator (the op's seed); fresh draws from a
    generator; independent draws per node; the same draws for the same
    seed. ``jax.random`` and ``torch.Generator`` draw different numbers,
    so the two packages' values are not compared."""
    ref = np.asarray(jt.RandomUniform((2, 3), seed=7).build(0, None)
                     .forward(None))
    m = tt.RandomUniform((2, 3), seed=7, device="cpu")
    a = m(None)
    assert tuple(a.shape) == ref.shape and a.dtype == torch.float32
    assert _np(a).dtype == ref.dtype
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
    assert torch.equal(a, m(None))
    g = torch.Generator().manual_seed(0)
    b, c = m(None, generator=g), m(None, generator=g)
    assert not torch.equal(b, c)
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(b, m(None, generator=g2))
    other = tt.RandomUniform((2, 3), seed=8, device="cpu")
    assert not torch.equal(other(None), a)
    assert torch.equal(tt.RandomUniform((2, 3), seed=7, device="cpu")(None),
                       a)
    lo = tt.RandomUniform((1000,), minval=-2.0, maxval=3.0, seed=1,
                          dtype=np.float64, device="cpu")(None)
    assert lo.dtype == torch.float32
    assert float(lo.min()) >= -2.0 and float(lo.max()) < 3.0
    assert float(lo.min()) < -1.5 and float(lo.max()) > 2.5
