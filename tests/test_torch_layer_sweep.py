"""The port's activation, tensor-plumbing and utility layers
(``bigdl_tpu_torch/nn/activation.py``, ``basic.py``, ``misc.py``) against
the reference's (``bigdl_tpu/nn/...``) on the CPU, modelled on the
reference's ``tests/test_layer_sweep.py`` and ``test_misc_layers.py``.

- Every class is a case of one parametrised test: the same seeded numpy
  input (a table of them where the layer takes one) through the JAX layer
  and the port's, with the JAX layer's parameters carried over by
  ``convert.module_params_from_jax``; the outputs, the input gradients
  under a seeded cotangent and the parameter gradients are held within
  1e-5 of the reference's largest magnitude (float32; the two libraries
  sum in other orders). A random layer runs in evaluation mode here.
- The random layers in training mode draw from different generators in
  the two packages, so each is held by its moments: both packages' draws
  against the distribution's (the share of dropped channels, the noise's
  mean and deviation), and the port's same seed giving the same draws.
- Ties: ``Max``/``Min`` share a tied maximum's gradient as JAX does; the
  gradient-only layers (``GradientReversal``, ``L1Penalty``,
  ``ActivityRegularization``) are held on a zero cotangent too, which
  leaves only their own term.
- ``MaskedSelect`` (host-side in the reference) gives the same elements on
  the input's device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.nn.basic import ErrorInfo as JErrorInfo
from bigdl_tpu.utils.table import T, Table, sorted_items
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn as tnn

CPU = "cpu"
REL = 1e-5


def _x(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _masked(seed=0):
    x = _x(3, 4, 6, seed=seed)
    x[0, 1] = 0.0
    x[2, 3] = 0.0
    return x


def _tie():
    x = _x(3, 6)
    x[:, 4] = x[:, 1] = np.abs(x).max() + 1.0
    return x


# name -> (JAX layer, port layer, inputs: one array or a list (a table))
# each a thunk; ``table`` inputs go in as T(...) / a list; ``grad`` lists
# the table entries that are differentiable (default every float one)
CASES = {
    # nn/activation.py
    "HardTanh": (lambda: jnn.HardTanh(-0.5, 0.7),
                 lambda: tnn.HardTanh(-0.5, 0.7), lambda: _x(4, 6)),
    "HardSigmoid": (jnn.HardSigmoid, tnn.HardSigmoid,
                    lambda: _x(4, 6, scale=3.0)),
    "SoftMin": (lambda: jnn.SoftMin(1), lambda: tnn.SoftMin(1),
                lambda: _x(3, 5, 4)),
    "LogSigmoid": (jnn.LogSigmoid, tnn.LogSigmoid,
                   lambda: _x(4, 6, scale=4.0)),
    "GELU": (jnn.GELU, tnn.GELU, lambda: _x(4, 6, scale=2.0)),
    "Threshold": (lambda: jnn.Threshold(0.1, -0.3),
                  lambda: tnn.Threshold(0.1, -0.3), lambda: _x(4, 6)),
    "RReLU": (lambda: jnn.RReLU(0.1, 0.3), lambda: tnn.RReLU(0.1, 0.3),
              lambda: _x(4, 6)),
    "SReLU": (lambda: jnn.SReLU((6,)), lambda: tnn.SReLU((6,), device=CPU),
              lambda: _x(4, 6, scale=2.0)),
    "HardShrink": (lambda: jnn.HardShrink(0.3), lambda: tnn.HardShrink(0.3),
                   lambda: _x(4, 6)),
    "SoftShrink": (lambda: jnn.SoftShrink(0.3), lambda: tnn.SoftShrink(0.3),
                   lambda: _x(4, 6)),
    "TanhShrink": (jnn.TanhShrink, tnn.TanhShrink, lambda: _x(4, 6)),
    "Clamp": (lambda: jnn.Clamp(-0.4, 0.6), lambda: tnn.Clamp(-0.4, 0.6),
              lambda: _x(4, 6)),
    # nn/basic.py
    "Transpose": (lambda: jnn.Transpose([(1, 2), (0, 3)]),
                  lambda: tnn.Transpose([(1, 2), (0, 3)]),
                  lambda: _x(2, 3, 4, 5)),
    "Unsqueeze": (lambda: jnn.Unsqueeze(1), lambda: tnn.Unsqueeze(1),
                  lambda: _x(3, 6)),
    "Index": (lambda: jnn.Index(1), lambda: tnn.Index(1),
              lambda: [_x(3, 6, 2),
                       np.array([[4, 0, 4], [1, 5, 2]], np.int32)]),
    "Replicate": (lambda: jnn.Replicate(3, 1), lambda: tnn.Replicate(3, 1),
                  lambda: _x(3, 6)),
    "Reverse": (lambda: jnn.Reverse(1), lambda: tnn.Reverse(1),
                lambda: _x(3, 6)),
    "Contiguous": (jnn.Contiguous, tnn.Contiguous, lambda: _x(3, 6)),
    "Padding": (lambda: jnn.Padding(1, -2, value=0.5),
                lambda: tnn.Padding(1, -2, value=0.5), lambda: _x(3, 6, 2)),
    "Padding_after": (lambda: jnn.Padding(2, 3), lambda: tnn.Padding(2, 3),
                      lambda: _x(3, 6, 2)),
    "SpatialDropout2D": (lambda: jnn.SpatialDropout2D(0.4),
                         lambda: tnn.SpatialDropout2D(0.4),
                         lambda: _x(2, 3, 4, 4)),
    "GaussianNoise": (lambda: jnn.GaussianNoise(0.3),
                      lambda: tnn.GaussianNoise(0.3), lambda: _x(3, 6)),
    "GaussianDropout": (lambda: jnn.GaussianDropout(0.3),
                        lambda: tnn.GaussianDropout(0.3), lambda: _x(3, 6)),
    "Max": (lambda: jnn.Max(1), lambda: tnn.Max(1), lambda: _x(3, 6, 4)),
    "Max_tie": (lambda: jnn.Max(1), lambda: tnn.Max(1), _tie),
    "Min": (lambda: jnn.Min(-1), lambda: tnn.Min(-1), lambda: _x(3, 6, 4)),
    "Min_tie": (lambda: jnn.Min(1), lambda: tnn.Min(1), lambda: -_tie()),
    "Add": (lambda: jnn.Add(6), lambda: tnn.Add(6, device=CPU),
            lambda: _x(3, 6)),
    "Mul": (jnn.Mul, lambda: tnn.Mul(device=CPU), lambda: _x(3, 6)),
    "Masking": (lambda: jnn.Masking(0.0), lambda: tnn.Masking(0.0),
                _masked),
    "Echo": (jnn.Echo, tnn.Echo, lambda: _x(3, 6)),
    "ErrorInfo": (JErrorInfo, tnn.ErrorInfo, lambda: _x(3, 6)),
    # nn/misc.py
    "BifurcateSplitTable": (lambda: jnn.BifurcateSplitTable(1),
                            lambda: tnn.BifurcateSplitTable(1),
                            lambda: _x(3, 7)),
    "NarrowTable": (lambda: jnn.NarrowTable(1, 2),
                    lambda: tnn.NarrowTable(1, 2),
                    lambda: [_x(3, 4, seed=i) for i in range(4)]),
    "NarrowTable_one": (lambda: jnn.NarrowTable(2),
                        lambda: tnn.NarrowTable(2),
                        lambda: [_x(3, 4, seed=i) for i in range(3)]),
    "CrossProduct": (jnn.CrossProduct, tnn.CrossProduct,
                     lambda: [_x(3, 5, seed=i) for i in range(4)]),
    "PairwiseDistance": (lambda: jnn.PairwiseDistance(2),
                         lambda: tnn.PairwiseDistance(2),
                         lambda: [_x(4, 6, seed=1), _x(4, 6, seed=2)]),
    "PairwiseDistance_L1": (lambda: jnn.PairwiseDistance(1),
                            lambda: tnn.PairwiseDistance(1),
                            lambda: [_x(4, 6, seed=1), _x(4, 6, seed=2)]),
    "GradientReversal": (lambda: jnn.GradientReversal(0.7),
                         lambda: tnn.GradientReversal(0.7),
                         lambda: _x(3, 6)),
    "L1Penalty": (lambda: jnn.L1Penalty(0.1, size_average=True),
                  lambda: tnn.L1Penalty(0.1, size_average=True),
                  lambda: _x(3, 6)),
    "ActivityRegularization": (lambda: jnn.ActivityRegularization(0.1, 0.2),
                               lambda: tnn.ActivityRegularization(0.1, 0.2),
                               lambda: _x(3, 6)),
    "Cropping3D": (lambda: jnn.Cropping3D((1, 0), (0, 2), (1, 1)),
                   lambda: tnn.Cropping3D((1, 0), (0, 2), (1, 1)),
                   lambda: _x(2, 3, 4, 5, 6)),
    "UpSampling3D": (lambda: jnn.UpSampling3D((1, 2, 3)),
                     lambda: tnn.UpSampling3D((1, 2, 3)),
                     lambda: _x(2, 2, 3, 2, 2)),
    "SpatialDropout3D": (lambda: jnn.SpatialDropout3D(0.3),
                         lambda: tnn.SpatialDropout3D(0.3),
                         lambda: _x(2, 3, 2, 3, 3)),
    "SpatialSubtractiveNormalization": (
        lambda: jnn.SpatialSubtractiveNormalization(3),
        lambda: tnn.SpatialSubtractiveNormalization(3),
        lambda: _x(2, 3, 12, 12)),
    "SpatialDivisiveNormalization": (
        lambda: jnn.SpatialDivisiveNormalization(3),
        lambda: tnn.SpatialDivisiveNormalization(3),
        lambda: _x(2, 3, 12, 12)),
    "SpatialContrastiveNormalization": (
        lambda: jnn.SpatialContrastiveNormalization(3),
        lambda: tnn.SpatialContrastiveNormalization(3),
        lambda: np.abs(_x(2, 3, 12, 12)) + 1.0),
    "SpatialContrastiveNormalization_3x3": (
        lambda: jnn.SpatialContrastiveNormalization(
            2, np.ones((3, 3), np.float32), 0.5, 0.25),
        lambda: tnn.SpatialContrastiveNormalization(
            2, np.ones((3, 3), np.float32), 0.5, 0.25),
        lambda: _x(2, 2, 7, 9)),
    "SpatialConvolutionMap": (
        lambda: jnn.SpatialConvolutionMap([[0, 0], [0, 1], [1, 1], [2, 0]],
                                          3, 3, pad_w=1, pad_h=1),
        lambda: tnn.SpatialConvolutionMap([[0, 0], [0, 1], [1, 1], [2, 0]],
                                          3, 3, pad_w=1, pad_h=1,
                                          device=CPU),
        lambda: _x(2, 3, 6, 7)),
    "SpatialConvolutionMap_5x5_s2": (
        lambda: jnn.SpatialConvolutionMap([[0, 1], [1, 0], [1, 2]], 5, 3,
                                          2, 1, 2, 0),
        lambda: tnn.SpatialConvolutionMap([[0, 1], [1, 0], [1, 2]], 5, 3,
                                          2, 1, 2, 0, device=CPU),
        lambda: _x(2, 2, 9, 8)),
    "LeakyReLU": (lambda: jnn.LeakyReLU(0.1), lambda: tnn.LeakyReLU(0.1),
                  lambda: _x(4, 6)),
    "Cropping2D": (lambda: jnn.Cropping2D((1, 2), (2, 1)),
                   lambda: tnn.Cropping2D((1, 2), (2, 1)),
                   lambda: _x(2, 3, 6, 8)),
    "Cropping2D_NHWC": (lambda: jnn.Cropping2D((1, 0), (0, 2), "NHWC"),
                        lambda: tnn.Cropping2D((1, 0), (0, 2), "NHWC"),
                        lambda: _x(2, 6, 8, 3)),
    "UpSampling1D": (lambda: jnn.UpSampling1D(3),
                     lambda: tnn.UpSampling1D(3), lambda: _x(2, 4, 5)),
    "UpSampling2D": (lambda: jnn.UpSampling2D((2, 3)),
                     lambda: tnn.UpSampling2D((2, 3)),
                     lambda: _x(2, 3, 2, 4)),
    "UpSampling2D_NHWC": (lambda: jnn.UpSampling2D((3, 1), "NHWC"),
                          lambda: tnn.UpSampling2D((3, 1), "NHWC"),
                          lambda: _x(2, 2, 4, 3)),
    "SpatialDropout1D": (lambda: jnn.SpatialDropout1D(0.5),
                         lambda: tnn.SpatialDropout1D(0.5),
                         lambda: _x(2, 5, 4)),
}


def _listed(y):
    """A JAX output as an array or a list of them (a Table in key
    order)."""
    if isinstance(y, Table):
        return [v for _, v in sorted_items(y)]
    return y


def _np(t):
    return [_np(v) for v in t] if isinstance(t, (list, tuple)) \
        else np.asarray(t.detach() if isinstance(t, torch.Tensor) else t)


def _close(got, want, what):
    if isinstance(want, list):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{what}[{i}]")
        return
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * scale,
                               err_msg=what)


def _pair(name):
    """``(JAX layer, its params, port layer on them, inputs)``."""
    jctor, tctor, data = CASES[name]
    x = data()
    ref = jctor()
    spec = (T(*[jnp.asarray(a) for a in x]) if isinstance(x, list)
            else jnp.asarray(x))
    ref.build(1, spec)
    params = jax.tree_util.tree_map(np.asarray, ref.params)
    port = tctor()
    if params:
        port.load_state_dict(convert.module_params_from_jax(port, params))
    return ref, params, port.eval(), x


def _floats(x):
    return [i for i, a in enumerate(x) if np.asarray(a).dtype.kind == "f"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_the_reference(name):
    """Forward, input gradient and parameter gradients of the port's layer
    against the JAX layer's on the same seeded inputs and parameters,
    within 1e-5 of the reference's largest magnitude."""
    ref, params, port, x = _pair(name)
    table = isinstance(x, list)
    xs = x if table else [x]
    live = _floats(xs)

    def jfwd(p, *args):
        full = list(xs)
        for i, a in zip(live, args):
            full[i] = a
        inp = T(*[jnp.asarray(a) for a in full]) if table \
            else jnp.asarray(full[0])
        return _listed(ref.apply(p, ref.state, inp, training=False)[0])

    y_ref, vjp = jax.vjp(jfwd, ref.params,
                         *[jnp.asarray(xs[i]) for i in live])
    y_ref = jax.tree_util.tree_map(np.asarray, y_ref)
    cot = jax.tree_util.tree_map(
        lambda a: _x(*a.shape, seed=7).astype(a.dtype), y_ref)
    g_ref = vjp(jax.tree_util.tree_map(jnp.asarray, cot))

    ts = [torch.tensor(np.asarray(a), requires_grad=i in live)
          for i, a in enumerate(xs)]
    y = port(ts) if table else port(ts[0])
    _close(_np(y), _listed(y_ref), f"{name} forward")
    outs = list(y) if isinstance(y, (list, tuple)) else [y]
    cots = cot if isinstance(cot, list) else [cot]
    leaves = [ts[i] for i in live] + list(port.parameters())
    grads = torch.autograd.grad(outs, leaves,
                                [torch.from_numpy(c) for c in cots],
                                allow_unused=True)
    for k, i in enumerate(live):
        want = np.asarray(g_ref[1 + k])
        got = grads[k] if grads[k] is not None else torch.zeros(want.shape)
        _close(got.numpy(), want, f"{name} input gradient {i}")
    if params:
        got = dict(zip([n for n, _ in port.named_parameters()],
                       grads[len(live):]))
        want_tree = jax.tree_util.tree_map(np.asarray, g_ref[0])
        want = convert.module_params_from_jax(port, want_tree)
        for k, w in want.items():
            _close(got[k].numpy(), w.numpy(), f"{name} gradient of {k}")


@pytest.mark.parametrize("name", ["GradientReversal", "L1Penalty",
                                  "ActivityRegularization"])
def test_gradient_only_layers_on_a_zero_cotangent(name):
    """With a zero cotangent the input gradient is the layer's own term
    alone: 0, ``l1 * sign(x) / size``, ``l1 * sign(x) + 2 * l2 * x``."""
    ref, _, port, x = _pair(name)
    _, vjp = jax.vjp(lambda v: ref.apply((), (), v)[0], jnp.asarray(x))
    want = np.asarray(vjp(jnp.zeros(x.shape, jnp.float32))[0])
    t = torch.tensor(x, requires_grad=True)
    got, = torch.autograd.grad(port(t), t, torch.zeros(x.shape))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert torch.equal(port(torch.from_numpy(x)), torch.from_numpy(x))


def test_masked_select_gives_the_reference_elements():
    x = _x(3, 5)
    mask = (np.random.default_rng(1).random((3, 5)) < 0.4).astype(np.int32)
    want = np.asarray(jnn.MaskedSelect().forward(
        T(jnp.asarray(x), jnp.asarray(mask))))
    got = tnn.MaskedSelect()([torch.from_numpy(x), torch.from_numpy(mask)])
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


# name -> (JAX layer, port layer, input shape, moment check of (x, y))
def _dropped_channels(p, axes):
    def check(x, y):
        kept = np.abs(y).sum(axis=axes) > 0
        share = 1.0 - kept.mean()
        assert abs(share - p) < 0.05, share
        k = np.broadcast_to(np.expand_dims(kept, axes), y.shape) \
            if axes else kept
        np.testing.assert_allclose(y[k], x[k] / (1.0 - p), rtol=1e-6)
        assert (y[~k] == 0).all()
    return check


def _noise(std, mult):
    def check(x, y):
        r = (y / x - 1.0) if mult else (y - x)
        assert abs(r.mean()) < 5.0 * std / np.sqrt(r.size), r.mean()
        assert abs(r.std() - std) < 0.05 * std, (r.std(), std)
    return check


def _rrelu(lo, hi):
    def check(x, y):
        neg = x < 0
        a = y[neg] / x[neg]
        assert a.min() >= lo and a.max() < hi
        assert abs(a.mean() - (lo + hi) / 2) < 0.01
        assert abs(a.var() - (hi - lo) ** 2 / 12) < 1e-3
        np.testing.assert_array_equal(y[~neg], x[~neg])
    return check


RANDOM = {
    "SpatialDropout2D": (lambda: jnn.SpatialDropout2D(0.3),
                         lambda: tnn.SpatialDropout2D(0.3), (64, 48, 2, 2),
                         _dropped_channels(0.3, (2, 3))),
    "SpatialDropout2D_NHWC": (lambda: jnn.SpatialDropout2D(0.3, "NHWC"),
                              lambda: tnn.SpatialDropout2D(0.3, "NHWC"),
                              (64, 2, 2, 48), _dropped_channels(0.3, (1, 2))),
    "SpatialDropout3D": (lambda: jnn.SpatialDropout3D(0.4),
                         lambda: tnn.SpatialDropout3D(0.4), (64, 48, 2, 2, 2),
                         _dropped_channels(0.4, (2, 3, 4))),
    "SpatialDropout1D": (lambda: jnn.SpatialDropout1D(0.5),
                         lambda: tnn.SpatialDropout1D(0.5), (64, 3, 48),
                         _dropped_channels(0.5, (1,))),
    "GaussianNoise": (lambda: jnn.GaussianNoise(0.3),
                      lambda: tnn.GaussianNoise(0.3), (200, 100),
                      _noise(0.3, False)),
    "GaussianDropout": (lambda: jnn.GaussianDropout(0.2),
                        lambda: tnn.GaussianDropout(0.2), (200, 100),
                        _noise(0.5, True)),
    "RReLU": (lambda: jnn.RReLU(0.1, 0.3), lambda: tnn.RReLU(0.1, 0.3),
              (200, 100), _rrelu(0.1, 0.3)),
}


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_layer_in_training_mode(name):
    """Both packages' draws against the distribution; the port's same
    seed gives the same draws, another seed others; evaluation mode is
    the identity (RReLU: the mean slope) in both."""
    jctor, tctor, shape, check = RANDOM[name]
    x = np.abs(_x(*shape)) + 0.5 if name == "GaussianDropout" \
        else _x(*shape)
    ref = jctor()
    ref.build(0, jnp.asarray(x))
    y_ref = np.asarray(ref.apply((), (), jnp.asarray(x), training=True,
                                 rng=jax.random.key(3))[0])
    check(x, y_ref)
    port = tctor().train()
    t = torch.from_numpy(x)
    y = port(t, generator=torch.Generator().manual_seed(3)).numpy()
    check(x, y)
    again = port(t, generator=torch.Generator().manual_seed(3)).numpy()
    other = port(t, generator=torch.Generator().manual_seed(4)).numpy()
    np.testing.assert_array_equal(again, y)
    assert not np.array_equal(other, y)
    want = np.asarray(ref.apply((), (), jnp.asarray(x), training=False)[0])
    np.testing.assert_allclose(port.eval()(t).numpy(), want, rtol=1e-6)
    np.testing.assert_array_equal(port.train()(t).numpy(),
                                  want if name != "RReLU"
                                  else port.eval()(t).numpy())


def test_gaussian_sampler_by_its_moments():
    """``mean + exp(log_var / 2) * eps``: the sample's standardised noise
    is N(0, 1) in both packages; with no generator the port draws from
    seed 0 each call, as the reference from ``key(0)``."""
    rng = np.random.default_rng(0)
    mean = rng.standard_normal((200, 100)).astype(np.float32)
    log_var = rng.uniform(-2, 1, (200, 100)).astype(np.float32)
    ref = jnn.GaussianSampler()
    ref.build(0)
    y_ref = np.asarray(ref.apply((), (), T(jnp.asarray(mean),
                                           jnp.asarray(log_var)),
                                 training=True, rng=jax.random.key(1))[0])
    port = tnn.GaussianSampler()
    ins = [torch.from_numpy(mean), torch.from_numpy(log_var)]
    y = port(ins, generator=torch.Generator().manual_seed(1)).numpy()
    bar = 5.0 / np.sqrt(mean.size)        # five standard errors
    for out in (y_ref, y):
        eps = (out - mean) / np.exp(0.5 * log_var)
        assert abs(eps.mean()) < bar and abs(eps.std() - 1.0) < bar
    np.testing.assert_array_equal(port(ins).numpy(), port(ins).numpy())
    # its gradient: d/dmean = 1, d/dlog_var = (y - mean) / 2
    m, lv = (torch.tensor(a, requires_grad=True) for a in (mean, log_var))
    out = port([m, lv], generator=torch.Generator().manual_seed(1))
    gm, glv = torch.autograd.grad(out.sum(), (m, lv))
    np.testing.assert_array_equal(gm.numpy(), np.ones_like(mean))
    np.testing.assert_allclose(glv.numpy(), (y - mean) / 2, rtol=1e-5,
                               atol=1e-6)


def test_echo_prints_the_shape_as_the_reference(capsys):
    tnn.Echo()(torch.zeros(2, 3))
    assert capsys.readouterr().out == "Echo: shape=(2, 3)\n"


def test_layers_default_to_the_card(monkeypatch):
    """A layer with parameters resolves ``device=None`` to the card and
    raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tnn.Add(3), tnn.Mul, lambda: tnn.SReLU((2,)),
                 lambda: tnn.SpatialConvolutionMap([[0, 0]], 3, 3)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
