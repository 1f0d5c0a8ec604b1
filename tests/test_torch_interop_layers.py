"""The 22 layers the Caffe and Torch7 files name (``bigdl_tpu_torch/nn``
``basic.py``, ``activation.py``, ``table_ops.py``, ``conv.py``
``SpatialFullConvolution``, ``normalization.py``
``SpatialWithinChannelLRN``, ``misc.py``) against the JAX reference on the
CPU, and the pooling's ceil rule the Caffe loader relies on.

Each case runs the same seeded numpy input (and, for a layer with
parameters, the same seeded numpy parameters, carried into the port by
``convert.module_params_from_jax``) through both packages. Outputs agree
within 1e-6 of the reference output's largest magnitude; the gradients of
a seeded weighted sum of the output, for the input and for every
parameter (back in the reference's layout through
``convert.module_params_to_jax``), within 1e-4 of each one's largest
magnitude. ``SpatialFullConvolution`` is held at groups 1 and 2, strides
1 and 2, and ``adj`` 0 and 1 (adj 1 at stride 1 is past what torch's
``output_padding`` takes: the port cuts the unpadded result instead).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.nn.misc import BinaryThreshold as JBinaryThreshold
from bigdl_tpu.nn.misc import InferReshape as JInferReshape
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn as tnn

OUT_REL = 1e-6
GRAD_REL = 1e-4
POSITIVE = "positive"       # inputs uniform in [0.1, 1.1): Log, Power

# name: (reference layer, port layer, input shape(s), input kind)
CASES = {
    "View": (lambda: jnn.View(4, 6), lambda: tnn.View(4, 6), (3, 24), None),
    "View_tuple": (lambda: jnn.View((2, 3, 4)), lambda: tnn.View((2, 3, 4)),
                   (2, 24), None),
    "Narrow": (lambda: jnn.Narrow(1, 1, 3), lambda: tnn.Narrow(1, 1, 3),
               (2, 6, 5), None),
    "Narrow_negative": (lambda: jnn.Narrow(1, 1, -2),
                        lambda: tnn.Narrow(1, 1, -2), (2, 6, 5), None),
    "Tile": (lambda: jnn.Tile(1, 3), lambda: tnn.Tile(1, 3), (2, 3, 4), None),
    "SpatialZeroPadding": (lambda: jnn.SpatialZeroPadding(1, 2, 0, 3),
                           lambda: tnn.SpatialZeroPadding(1, 2, 0, 3),
                           (2, 3, 5, 4), None),
    "SpatialZeroPadding_even": (lambda: jnn.SpatialZeroPadding(2),
                                lambda: tnn.SpatialZeroPadding(2),
                                (1, 2, 3, 3), None),
    "Scale": (lambda: jnn.Scale((1, 4, 1, 1)),
              lambda: tnn.Scale((1, 4, 1, 1), device="cpu"),
              (2, 4, 3, 3), None),
    "Scale_2d": (lambda: jnn.Scale((3, 5)),
                 lambda: tnn.Scale((3, 5), device="cpu"), (2, 3, 5), None),
    "CAdd": (lambda: jnn.CAdd((1, 4, 1, 1)),
             lambda: tnn.CAdd((1, 4, 1, 1), device="cpu"),
             (2, 4, 3, 3), None),
    "AddConstant": (lambda: jnn.AddConstant(1.5),
                    lambda: tnn.AddConstant(1.5, ip=True), (3, 4), None),
    "MulConstant": (lambda: jnn.MulConstant(-2.5),
                    lambda: tnn.MulConstant(-2.5), (3, 4), None),
    "Abs": (lambda: jnn.Abs(), lambda: tnn.Abs(), (3, 7), None),
    "Exp": (lambda: jnn.Exp(), lambda: tnn.Exp(), (3, 7), None),
    "Log": (lambda: jnn.Log(), lambda: tnn.Log(), (3, 7), POSITIVE),
    "Power": (lambda: jnn.Power(2.0, 0.5, 1.0),
              lambda: tnn.Power(2.0, 0.5, 1.0), (3, 7), None),
    "Power_fractional": (lambda: jnn.Power(0.5, 2.0, 0.25),
                         lambda: tnn.Power(0.5, 2.0, 0.25), (3, 7),
                         POSITIVE),
    "ELU": (lambda: jnn.ELU(0.7), lambda: tnn.ELU(0.7, ip=True), (3, 7),
            None),
    "PReLU_shared": (lambda: jnn.PReLU(), lambda: tnn.PReLU(device="cpu"),
                     (2, 4, 3, 3), None),
    "PReLU_channels": (lambda: jnn.PReLU(4),
                       lambda: tnn.PReLU(4, device="cpu"), (2, 4, 3, 3),
                       None),
    "SoftPlus": (lambda: jnn.SoftPlus(), lambda: tnn.SoftPlus(), (3, 7),
                 None),
    "SoftPlus_beta": (lambda: jnn.SoftPlus(2.0), lambda: tnn.SoftPlus(2.0),
                      (3, 7), None),
    "CMulTable": (lambda: jnn.CMulTable(), lambda: tnn.CMulTable(),
                  [(3, 4), (3, 4), (3, 4)], None),
    "CSubTable": (lambda: jnn.CSubTable(), lambda: tnn.CSubTable(),
                  [(3, 4), (3, 4)], None),
    "CMaxTable": (lambda: jnn.CMaxTable(), lambda: tnn.CMaxTable(),
                  [(3, 4), (3, 4), (3, 4)], None),
    "SpatialWithinChannelLRN": (
        lambda: jnn.SpatialWithinChannelLRN(3, 0.5, 0.75),
        lambda: tnn.SpatialWithinChannelLRN(3, 0.5, 0.75), (2, 3, 6, 5),
        None),
    "SpatialWithinChannelLRN_even": (
        lambda: jnn.SpatialWithinChannelLRN(4, 2.0, 0.6),
        lambda: tnn.SpatialWithinChannelLRN(4, 2.0, 0.6), (1, 2, 5, 5),
        None),
    "BinaryThreshold": (lambda: JBinaryThreshold(0.1),
                        lambda: tnn.BinaryThreshold(0.1), (4, 5), None),
    "InferReshape": (lambda: JInferReshape((0, 3, -1)),
                     lambda: tnn.InferReshape((0, 3, -1)), (2, 12), None),
    "InferReshape_batch": (lambda: JInferReshape((0, -1, 2), batch_mode=True),
                           lambda: tnn.InferReshape((0, -1, 2),
                                                    batch_mode=True),
                           (2, 3, 4, 2), None),
}
for _g in (1, 2):
    for _s in (1, 2):
        for _a in (0, 1):
            CASES[f"SpatialFullConvolution_g{_g}_s{_s}_adj{_a}"] = (
                lambda g=_g, s=_s, a=_a: jnn.SpatialFullConvolution(
                    4, 6, 3, 3, s, s, 1, 1, a, a, n_group=g),
                lambda g=_g, s=_s, a=_a: tnn.SpatialFullConvolution(
                    4, 6, 3, 3, s, s, 1, 1, a, a, n_group=g, device="cpu"),
                (2, 4, 5, 4), None)
CASES["SpatialFullConvolution_nhwc_nobias"] = (
    lambda: jnn.SpatialFullConvolution(4, 2, 4, 2, 2, 1, 1, 0, 1, 0,
                                       no_bias=True, format="NHWC"),
    lambda: tnn.SpatialFullConvolution(4, 2, 4, 2, 2, 1, 1, 0, 1, 0,
                                       no_bias=True, format="NHWC",
                                       device="cpu"),
    (2, 5, 4, 4), None)
CASES["SpatialFullConvolution_wide_adj"] = (     # adj past the stride
    lambda: jnn.SpatialFullConvolution(3, 4, 3, 3, 2, 2, 0, 1, 2, 3),
    lambda: tnn.SpatialFullConvolution(3, 4, 3, 3, 2, 2, 0, 1, 2, 3,
                                       device="cpu"),
    (1, 3, 4, 5), None)


def _inputs(shapes, kind, seed):
    rng = np.random.default_rng(seed)

    def one(shape):
        if kind == POSITIVE:
            return rng.uniform(0.1, 1.1, shape).astype(np.float32)
        return rng.standard_normal(shape).astype(np.float32)
    if isinstance(shapes, list):
        return [one(s) for s in shapes]
    return one(shapes)


def _params(jm, x, seed):
    """The reference's params of ``jm`` with seeded normal values."""
    spec = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, jnp.float32), x)
    params, _ = jm.setup(jax.random.PRNGKey(0), spec)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)


def _close(got, want, rel, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


@pytest.mark.parametrize("name", list(CASES))
def test_layer_matches_reference(name):
    jctor, tctor, shapes, kind = CASES[name]
    seed = sum(map(ord, name))
    x = _inputs(shapes, kind, seed)
    jm, tm = jctor(), tctor()
    params = _params(jm, x, seed + 1)
    seq = tnn.Sequential(tm)
    if params:
        seq.load_state_dict(convert.module_params_from_jax(seq, [params]))
    jx = jax.tree_util.tree_map(jnp.asarray, x)
    jy = np.asarray(jm.apply(params, (), jx, training=False)[0])
    tx = [torch.from_numpy(a).requires_grad_() for a in x] \
        if isinstance(x, list) else torch.from_numpy(x).requires_grad_()
    ty = tm(tx)
    _close(ty.detach().numpy(), jy, OUT_REL, f"{name} output")
    if not ty.requires_grad:            # BinaryThreshold: no gradient
        return
    w = np.random.default_rng(seed + 2).standard_normal(jy.shape) \
        .astype(np.float32)

    def f(p, xx):
        return jnp.sum(jm.apply(p, (), xx, training=False)[0] * w)

    jg_p, jg_x = jax.grad(f, argnums=(0, 1))(params, jx)
    (ty * torch.from_numpy(w)).sum().backward()
    tg_x = [t.grad.numpy() for t in tx] if isinstance(tx, list) \
        else [tx.grad.numpy()]
    jg_x = jg_x if isinstance(jg_x, list) else [jg_x]
    for i, (g, j) in enumerate(zip(tg_x, jg_x)):
        _close(g, np.asarray(j), GRAD_REL, f"{name} input {i} gradient")
    if params:
        grads = {f"0.{k}": p.grad for k, p in tm.named_parameters()}
        tg_p = convert.module_params_to_jax(seq, grads)[0][0]
        assert sorted(tg_p) == sorted(jg_p)
        for k in jg_p:
            _close(tg_p[k], np.asarray(jg_p[k]), GRAD_REL,
                   f"{name} {k} gradient")


@pytest.mark.parametrize("name", [n for n in CASES
                                  if n.startswith(("Scale", "CAdd", "PReLU",
                                                   "SpatialFull"))])
def test_parameters_cross_both_ways(name):
    """A parameterised layer's reference params go into the port and come
    back unchanged (``convert`` through ``nn.module.jax_layout``)."""
    jctor, tctor, shapes, kind = CASES[name]
    x = _inputs(shapes, kind, 0)
    params = _params(jctor(), x, 7)
    seq = tnn.Sequential(tctor())
    seq.load_state_dict(convert.module_params_from_jax(seq, [params]))
    back = convert.module_params_to_jax(seq)[0][0]
    assert sorted(back) == sorted(params)
    for k in params:
        np.testing.assert_array_equal(back[k], params[k])


def test_full_convolution_weight_is_a_deconvolution_blob():
    """With groups the port's weight is ``F.conv_transpose2d``'s (and a
    Caffe Deconvolution blob's) ``(I, O / G, kh, kw)``: group ``g``'s
    output channels come from its input channels alone."""
    m = tnn.SpatialFullConvolution(4, 6, 3, 3, 2, 2, n_group=2,
                                   device="cpu").reset(3)
    assert tuple(m.weight.shape) == (4, 3, 3, 3)
    x = torch.zeros(1, 4, 3, 3)
    x[0, :2] = torch.randn(2, 3, 3)          # group 0's inputs only
    with torch.no_grad():
        y = m(x) - m.bias.reshape(1, -1, 1, 1)
    assert float(y[0, 3:].abs().max()) == 0.0
    assert float(y[0, :3].abs().max()) > 0.0
    assert m.output_hw(3, 3) == tuple(y.shape[2:])


@pytest.mark.parametrize("size", [112, 56, 28, 14, 7, 13, 9])
@pytest.mark.parametrize("window", [(3, 2, 0), (3, 1, 1), (2, 2, 0),
                                    (3, 2, 1)])
def test_ceil_pooling_matches_reference(size, window):
    """Caffe pooling rounds up: the port's ``SpatialMaxPooling(...).ceil()``
    and ``SpatialAveragePooling(ceil_mode=True)`` give the reference's
    sizes and values on odd and even maps (112 -> 56 -> 28 -> 14 -> 7 at
    3/2, the inception modules' 3/1/1), including a padded window that
    would start past the image."""
    k, s, p = window
    x = np.random.default_rng(size * 7 + k).standard_normal(
        (1, 2, size, size)).astype(np.float32)
    for jm, tm in ((jnn.SpatialMaxPooling(k, k, s, s, p, p).ceil(),
                    tnn.SpatialMaxPooling(k, k, s, s, p, p).ceil()),
                   (jnn.SpatialAveragePooling(k, k, s, s, p, p,
                                              ceil_mode=True),
                    tnn.SpatialAveragePooling(k, k, s, s, p, p,
                                              ceil_mode=True))):
        want = np.asarray(jm.apply({}, (), jnp.asarray(x))[0])
        got = tm(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape
        assert tm.output_hw(size, size) == want.shape[2:]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if (k, s, p) == (3, 2, 0) and size in (112, 56, 28, 14):
        assert want.shape[2] == size // 2
