"""The port's post-training quantisation (``bigdl_tpu_torch/nn/
quantized.py``: ``QuantizedLinear``, ``QuantizedSpatialConvolution``,
``QuantizedSpatialDilatedConvolution``, ``Quantizer``) against the JAX
reference's on the CPU, on the same float weights
(``convert.module_params_from_jax``).

Bars: the int8 weights, scales, static ``in_scale``s, the int8 activation
and the int32 accumulator equal the reference's exactly (an int8 product
summed in int32 is exact in both); a layer's output within 1e-6 of its
largest reference magnitude (the same float32 dequantising multiply);
calibration amaxes within 1e-6 relative. Whole quantised models are held
to the reference's quantised model on the same input: log-probabilities
within ``MODEL_TOL`` absolute, because a float difference of one ulp
upstream (a BN, a pooling) can move one activation across an int8
rounding boundary, which moves the log-probabilities by about 1e-3 on
these models; and their top-1 must agree with the float model's on at
least ``TOP1_AGREE`` of the rows (the card's ``infer_int8`` phase holds
ResNet-50 to these two bars against the port on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import bigdl_tpu.nn as jnn
from bigdl_tpu.models.lenet import lenet_graph as jlenet_graph
from bigdl_tpu.models.resnet import ResNet as JResNet
from bigdl_tpu.nn.conv import _pair_padding
from bigdl_tpu.nn.quantized import Quantizer as JQuantizer
from bigdl_tpu.nn.quantized import _quant_input
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models import ResNet, lenet_graph
from bigdl_tpu_torch.nn.quantized import im2col

LAYER_REL = 1e-6
AMAX_REL = 1e-6
MODEL_TOL = 1e-2
TOP1_AGREE = 0.9


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, rel=LAYER_REL):
    want = np.asarray(want)
    if torch.is_tensor(got):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-12))


def _port_layer(layer, params):
    """``layer`` loaded with a reference layer's ``params``."""
    sd = convert.module_params_from_jax(tnn.Sequential().add(layer),
                                        [_np(params)])
    layer.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    return layer


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("calibrated", [False, True])
def test_quantized_linear_int8_and_int32_equal_reference(calibrated):
    jl = jnn.Linear(32, 16).build(0, (4, 32))
    tl = _port_layer(tnn.Linear(32, 16, device="cpu"), jl.params)
    x = _x((5, 32), 1)
    if calibrated:
        jl._calib_amax = tl._calib_amax = float(np.abs(x).max() * 0.8)
    jq = jnn.QuantizedLinear.from_float(jl, jl.params)
    tq = tnn.QuantizedLinear.from_float(tl)
    assert repr(tq) == repr(jq) == "QuantizedLinear(32 -> 16)"
    got = convert.module_params_to_jax(tnn.Sequential().add(tq))[0][0]
    assert set(got) == set(jq.params)
    for k, v in jq.params.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    xq, _ = _quant_input(jq.params, jnp.asarray(x))
    txq, _ = tnn.quantized._quant_input(torch.from_numpy(x), tq.in_scale)
    np.testing.assert_array_equal(txq.numpy(), np.asarray(xq))
    acc = lax.dot_general(xq, jq.params["weight"], (((1,), (0,)), ((), ())),
                          preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(tq.accumulate(txq).numpy(),
                                  np.asarray(acc))
    _close(tq(torch.from_numpy(x)).detach(), jq.forward(jnp.asarray(x)))


CONV_CASES = {
    "nchw_3x3_pad1": (dict(n_in=4, n_out=8, k=3, s=1, p=1), "NCHW", 9),
    "nhwc_3x3_same_s2": (dict(n_in=4, n_out=8, k=3, s=2, p=-1), "NHWC", 9),
    "nhwc_7x7_s2_stem": (dict(n_in=3, n_out=16, k=7, s=2, p=3), "NHWC",
                         15),
    "nchw_1x1_s2": (dict(n_in=8, n_out=6, k=1, s=2, p=0), "NCHW", 8),
    "nchw_5x5_groups2": (dict(n_in=6, n_out=4, k=5, s=1, p=2, g=2), "NCHW",
                         7),
    "nhwc_3x3_dilated2": (dict(n_in=4, n_out=8, k=3, s=1, p=2, d=2), "NHWC",
                          9),
    "nchw_3x3_same_dilated2": (dict(n_in=3, n_out=8, k=3, s=1, p=-1, d=2),
                               "NCHW", 10),
}


def _conv_pair(case, seed=0):
    geo, fmt, hw = CONV_CASES[case]
    kw = dict(n_group=geo.get("g", 1), format=fmt,
              dilation_w=geo.get("d", 1), dilation_h=geo.get("d", 1))
    args = (geo["n_in"], geo["n_out"], geo["k"], geo["k"], geo["s"],
            geo["s"], geo["p"], geo["p"])
    jc = jnn.SpatialConvolution(*args, **kw)
    shape = (2, hw, hw, geo["n_in"]) if fmt == "NHWC" else \
        (2, geo["n_in"], hw, hw)
    jc.build(seed, shape)
    tc = _port_layer(tnn.SpatialConvolution(*args, device="cpu", **kw),
                     jc.params)
    return jc, tc, _x(shape, seed + 1)


def _ref_conv_acc(jq, xq):
    dn = lax.conv_dimension_numbers(
        xq.shape, (jq.kernel_h, jq.kernel_w, jq.n_input_plane // jq.n_group,
                   jq.n_output_plane), (jq.format, "HWIO", jq.format))
    return lax.conv_general_dilated(
        xq, jq.params["weight"], (jq.stride_h, jq.stride_w),
        _pair_padding(jq.pad_h, jq.pad_w, jq.kernel_h, jq.kernel_w),
        rhs_dilation=(jq.dilation_h, jq.dilation_w), dimension_numbers=dn,
        feature_group_count=jq.n_group, preferred_element_type=jnp.int32)


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_quantized_conv_int32_accumulator_equals_reference(case,
                                                           calibrated):
    jc, tc, x = _conv_pair(case)
    if calibrated:
        jc._calib_amax = tc._calib_amax = float(np.abs(x).max() * 0.7)
    jq = jnn.QuantizedSpatialConvolution.from_float(jc, jc.params)
    tq = tnn.QuantizedSpatialConvolution.from_float(tc)
    got = convert.module_params_to_jax(tnn.Sequential().add(tq))[0][0]
    assert set(got) == set(jq.params)
    for k, v in jq.params.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    xq, _ = _quant_input(jq.params, jnp.asarray(x))
    txq, _ = tnn.quantized._quant_input(torch.from_numpy(x), tq.in_scale)
    np.testing.assert_array_equal(txq.numpy(), np.asarray(xq))
    acc = tq.accumulate(txq)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(),
                                  np.asarray(_ref_conv_acc(jq, xq)))
    _close(tq(torch.from_numpy(x)), jq.forward(jnp.asarray(x)))


def test_im2col_product_equals_a_float64_convolution():
    """The lowering alone, on int8 values whose sums pass 2^24: the
    im2col product equals a float64 convolution (exact here) of the same
    values, where a float32 one would round."""
    g = torch.Generator().manual_seed(0)
    x = torch.randint(0, 128, (2, 7, 7, 512), generator=g,
                      dtype=torch.int8)
    w = torch.full((8, 512, 3, 3), 127, dtype=torch.int8)
    cols, (n, ho, wo) = im2col(x, (3, 3), padding=((1, 1), (1, 1)))
    acc = tnn.quantized._int_mm(cols,
                                w.permute(0, 2, 3, 1).reshape(8, -1).t())
    want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2).double(),
                                      w.double(), padding=1)
    torch.testing.assert_close(acc.reshape(n, ho, wo, 8).permute(0, 3, 1, 2)
                               .double(), want, rtol=0, atol=0)
    assert want.abs().max() > 2 ** 24


def test_dilated_convolution_swaps_to_its_own_type():
    x = np.random.RandomState(0).randn(2, 3, 12, 12).astype("float32")
    jm = jnn.Sequential(jnn.SpatialDilatedConvolution(
        3, 8, 3, 3, 1, 1, 2, 2, dilation_w=2, dilation_h=2),
        jnn.ReLU()).build(1, x.shape)
    tm = tnn.Sequential(tnn.SpatialDilatedConvolution(
        3, 8, 3, 3, 1, 1, 2, 2, dilation_w=2, dilation_h=2, device="cpu"),
        tnn.ReLU())
    tm.load_state_dict(convert.module_params_from_jax(tm, _np(jm.params)))
    jq, tq = JQuantizer.quantize(jm), tnn.Quantizer.quantize(tm)
    assert type(tq[0]) is tnn.QuantizedSpatialDilatedConvolution
    assert repr(tq[0]) == repr(jq.modules[0])
    _close(tq(torch.from_numpy(x)).detach(), jq.forward(jnp.asarray(x)))


# ------------------------------------------------------------- quantizer
def _class_data(n=256, d=16, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((classes, d)).astype(np.float32) * 2.0
    y = rng.integers(0, classes, n).astype(np.int32)
    return (centers[y] + rng.standard_normal((n, d)).astype(np.float32)
            * 0.5), y


def _mlp(n, act, **kw):
    return (n.Sequential().add(n.Linear(16, 32, **kw)).add(act())
            .add(n.Linear(32, 4, **kw)).add(n.LogSoftMax()))


def _models(build, shape, graph=False):
    """(reference model built, port model with its weights)."""
    jm = build(jnn, {})
    jm.build(0, shape)
    tm = build(tnn, {"device": "cpu"})
    params, state = _np(jm.params), _np(jm.state)
    if graph:
        params = [params[str(nd.id)] for nd in jm.exec_order]
        state = [state[str(nd.id)] for nd in jm.exec_order]
    tm.load_state_dict(convert.module_params_from_jax(tm, params, state))
    return jm.evaluate(), tm.eval()


def _hold_models(jq, tq, x, float_out=None):
    want = np.asarray(jq.forward(jnp.asarray(x)))
    got = tq(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=MODEL_TOL)
    if float_out is not None:
        agree = (got.argmax(-1) == float_out.argmax(-1)).mean()
        assert agree >= TOP1_AGREE, agree
    return got


def _swappable_order(tq):
    return [m for m in tq.modules() if isinstance(
        m, (tnn.QuantizedLinear, tnn.QuantizedSpatialConvolution))]


def test_calibration_amaxes_and_static_scales_match_reference():
    x, _ = _class_data()
    jm, tm = _models(lambda n, kw: _mlp(n, n.Tanh, **kw), (8, 16))
    jq = JQuantizer.quantize(jm, calib_input=jnp.asarray(x[:64]))
    tq = tnn.Quantizer.quantize(tm, calib_input=torch.from_numpy(x[:64]))
    want = [float(p["in_scale"]) for p in jq.params if "in_scale" in p]
    got = [float(m.in_scale) for m in _swappable_order(tq)]
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=AMAX_REL, atol=0)
    amax = tnn.Quantizer._calibrate(tm, torch.from_numpy(x[:64]))
    np.testing.assert_allclose(
        [amax[id(tm[0])], amax[id(tm[2])]],
        [float(np.abs(x[:64]).max()),
         float(np.abs(np.tanh(x[:64] @ np.asarray(jm.params[0]["weight"])
                               + np.asarray(jm.params[0]["bias"]))).max())],
        rtol=AMAX_REL)
    _hold_models(jq, tq, x[:128])


def test_lenet_conv_stack_matches_reference():
    def lenet(n, kw):
        return (n.Sequential()
                .add(n.SpatialConvolution(1, 6, 3, 3, 1, 1, 1, 1, **kw))
                .add(n.ReLU()).add(n.SpatialMaxPooling(2, 2))
                .add(n.Reshape((6 * 6 * 6,))).add(n.Linear(6 * 6 * 6, 3, **kw))
                .add(n.LogSoftMax()))
    x = _x((64, 1, 12, 12), 2)
    jm, tm = _models(lenet, (4, 1, 12, 12))
    with torch.no_grad():
        f = tm(torch.from_numpy(x)).numpy()
    for calib in (None, x[:32]):
        jq = JQuantizer.quantize(
            jm, None if calib is None else jnp.asarray(calib))
        tq = tnn.Quantizer.quantize(
            tm, None if calib is None else torch.from_numpy(calib))
        assert type(tq[0]) is tnn.QuantizedSpatialConvolution
        assert type(tq[4]) is tnn.QuantizedLinear
        _hold_models(jq, tq, x, f)


def test_graph_model_matches_reference():
    x = _x((16, 1, 28, 28), 3)
    jm = jlenet_graph(10)
    jm.build(0, (2, 1, 28, 28))
    tm = lenet_graph(10, device="cpu")
    tm.load_state_dict(convert.module_params_from_jax(
        tm, [_np(jm.params[str(nd.id)]) for nd in jm.exec_order],
        [_np(jm.state[str(nd.id)]) for nd in jm.exec_order]))
    jm.evaluate()
    tm.eval()
    with torch.no_grad():
        f = tm(torch.from_numpy(x)).numpy()
    jq = JQuantizer.quantize(jm, calib_input=jnp.asarray(x))
    tq = tnn.Quantizer.quantize(tm, calib_input=torch.from_numpy(x))
    kinds = [type(nd.module).__name__ for nd in tq.exec_order]
    assert kinds == [type(nd.module).__name__ for nd in jq.exec_order]
    assert "QuantizedSpatialConvolution" in kinds
    assert all(nd.module is tq._modules[str(i)]
               for i, nd in enumerate(tq.exec_order))
    _hold_models(jq, tq, x, f)


@pytest.mark.parametrize("calibrated", [False, True])
def test_deep_graph_resnet_matches_reference(calibrated):
    kw = dict(class_num=10, depth=20, format="NHWC", data_set="cifar10")
    x = _x((8, 32, 32, 3), 4)
    jm = JResNet(**kw)
    jm.build(0, (2, 32, 32, 3))
    by_name = {nd.module.name: _np(jm.params[str(nd.id)])
               for nd in jm.exec_order if jm.params[str(nd.id)]}
    st = {nd.module.name: _np(jm.state[str(nd.id)])
          for nd in jm.exec_order if jm.state[str(nd.id)]}
    tm = ResNet(device="cpu", **kw)
    tm.load_state_dict(convert.resnet_params_from_jax(by_name, st))
    jm.evaluate()
    tm.eval()
    with torch.no_grad():
        f = tm(torch.from_numpy(x)).numpy()
    calib = x if calibrated else None
    jq = JQuantizer.quantize(jm, None if calib is None else jnp.asarray(calib))
    tq = tnn.Quantizer.quantize(
        tm, None if calib is None else torch.from_numpy(calib))
    n_conv = sum(isinstance(m, tnn.QuantizedSpatialConvolution)
                 for m in tq.modules())
    assert n_conv == sum(isinstance(m, tnn.SpatialConvolution)
                         for m in tm.modules()) == 21
    assert all(m.in_scale is not None for m in _swappable_order(tq)) \
        == calibrated
    with torch.no_grad():
        _hold_models(jq, tq, x, f)


def test_bf16_activations_preserved():
    jm, tm = _models(lambda n, kw: n.Sequential().add(n.Linear(16, 8, **kw)),
                     (4, 16))
    out = tnn.Quantizer.quantize(tm)(torch.ones(4, 16, dtype=torch.bfloat16))
    want = JQuantizer.quantize(jm).forward(jnp.ones((4, 16), jnp.bfloat16))
    assert out.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(out.float().detach().numpy(),
                                  np.asarray(want, np.float32))


def test_calibration_restores_hooks_even_when_the_forward_raises():
    _, tm = _models(lambda n, kw: n.Sequential().add(n.Linear(16, 8, **kw)),
                    (4, 16))
    tnn.Quantizer.quantize(tm, calib_input=torch.ones(4, 16))
    assert not tm[0]._forward_pre_hooks and tm.training is False
    tm.train()
    with pytest.raises(RuntimeError):
        tnn.Quantizer.quantize(tm, calib_input=torch.ones(4, 5))
    assert not tm[0]._forward_pre_hooks and tm.training is True


def test_calibration_does_not_stick_to_source_model():
    x, _ = _class_data()
    jm, tm = _models(lambda n, kw: n.Sequential().add(n.Linear(16, 8, **kw)),
                     (8, 16))
    q_cal = tnn.Quantizer.quantize(tm, calib_input=torch.from_numpy(x[:32]))
    jq_cal = JQuantizer.quantize(jm, calib_input=jnp.asarray(x[:32]))
    assert q_cal[0].in_scale is not None and "in_scale" in jq_cal.params[0]
    assert type(tm[0]) is tnn.Linear and not hasattr(tm[0], "_calib_amax")
    q_dyn = tnn.Quantizer.quantize(tm)
    assert q_dyn[0].in_scale is None
    assert "in_scale" not in JQuantizer.quantize(jm).params[0]
    _hold_models(jq_cal, q_cal, x[:64])


def test_zero_calibration_input_still_bakes_scale():
    jm, tm = _models(lambda n, kw: n.Sequential().add(n.Linear(16, 8, **kw)),
                     (4, 16))
    qm = tnn.Quantizer.quantize(tm, calib_input=torch.zeros(4, 16))
    jq = JQuantizer.quantize(jm, calib_input=jnp.zeros((4, 16)))
    assert float(qm[0].in_scale) == float(jq.params[0]["in_scale"])
    out = qm(torch.ones(4, 16)).detach().numpy()
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out, np.asarray(jq.forward(
        jnp.ones((4, 16)))))


def test_reference_quantised_params_load_into_the_port():
    """``convert`` carries a reference quantised tree (int8 weights,
    scales, in_scale) into the port's quantised model and back."""
    x, _ = _class_data()
    jm, tm = _models(lambda n, kw: _mlp(n, n.ReLU, **kw), (8, 16))
    jq = JQuantizer.quantize(jm, calib_input=jnp.asarray(x[:64]))
    tq = tnn.Quantizer.quantize(tm, calib_input=torch.from_numpy(x[:64]))
    fresh = tnn.Quantizer.quantize(tm, calib_input=torch.zeros(2, 16))
    fresh.load_state_dict(convert.module_params_from_jax(
        fresh, _np(jq.params)))
    for a, b in zip(tq.state_dict().values(), fresh.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    back = convert.module_params_to_jax(fresh)[0]
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(_np(jq.params))):
        np.testing.assert_array_equal(a, b)
