"""The port's ``SpatialSeparableConvolution`` and ``SpatialShareConvolution``
(``bigdl_tpu_torch/nn/conv.py``) against the reference's
(``bigdl_tpu/nn/conv.py``) on the CPU, modelled on the reference's
``tests/test_layer_sweep.py`` and ``test_misc_layers.py``.

- Each geometry is a case of one parametrised test: the same seeded
  input and the reference's weights (``convert.module_params_from_jax``:
  the halves' HWIO weights to OIHW), forward, input gradient and every
  parameter gradient within 1e-5 of the reference's largest magnitude
  (float32).
- The depthwise half at 3x3 stride 1 pad 1 runs rows 8-9's route once a
  group, each group one input channel to ``depth_multiplier`` outputs:
  the plain versions of the kernels at (Cin 1, Cout 1) and (1, 2) against
  ``scripts/perf_pallas_conv.py``'s Pallas kernels in interpret mode, both
  directions; ``models.conv_routes`` counts the launches (``input_grad``:
  a block in the middle of a network) and no SAME 3x3 reaches
  ``F.conv2d``.
- Xception's middle-flow block (Chollet, 2017) at a small width: 3 x
  [ReLU, separable 3x3] with the residual add, against the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import bigdl_tpu.nn as jnn
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models import routes
from bigdl_tpu_torch.ops import conv3x3 as cv
from scripts.perf_pallas_conv import conv_pallas9, conv_pallas_i2c

CPU = "cpu"
REL = 1e-5


@pytest.fixture(autouse=True)
def _keep_library_calls():
    """Leave the process-wide ``SpatialConvolution.library_calls`` as each
    test found it."""
    saved = tnn.SpatialConvolution.library_calls.copy()
    yield
    tnn.SpatialConvolution.library_calls.clear()
    tnn.SpatialConvolution.library_calls.update(saved)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * scale,
                               err_msg=what)


# name -> (constructor arguments after the class, input shape)
SEPARABLE = {
    "3x3_pad1_dm1": ((4, 6, 1, 3, 3, 1, 1, 1, 1), {}, (2, 4, 7, 6)),
    "3x3_pad1_dm2": ((3, 5, 2, 3, 3, 1, 1, 1, 1), {}, (2, 3, 6, 5)),
    "3x3_same_nobias": ((3, 4, 2, 3, 3, 1, 1, -1, -1),
                        {"has_bias": False}, (1, 3, 5, 6)),
    "3x3_pad1_NHWC": ((4, 3, 2, 3, 3, 1, 1, 1, 1), {"format": "NHWC"},
                      (2, 5, 6, 4)),
    "5x5_pad2": ((3, 4, 1, 5, 5, 1, 1, 2, 2), {}, (2, 3, 8, 7)),
    "3x3_stride2": ((4, 4, 2, 3, 3, 2, 2, 1, 1), {}, (2, 4, 9, 8)),
    "3x3_valid": ((2, 3, 3, 3, 3), {}, (2, 2, 6, 6)),
}
SHARE = {
    "3x3_pad1": ((3, 4, 3, 3, 1, 1, 1, 1), {}, (2, 3, 6, 7)),
    "1x1": ((4, 5, 1, 1), {"with_bias": False}, (2, 4, 5, 5)),
    "5x5_s2_NHWC": ((3, 4, 5, 5, 2, 2, 2, 2), {"format": "NHWC"},
                    (2, 9, 9, 3)),
}


def _run(ref, port, x):
    """``(port's forward, input gradient, parameter gradients)`` and the
    reference's, under one seeded cotangent."""
    ref.build(1, jnp.asarray(x))
    params = jax.tree_util.tree_map(np.asarray, ref.params)
    port.load_state_dict(convert.module_params_from_jax(port, params))
    y_ref, vjp = jax.vjp(lambda p, v: ref.apply(p, ref.state, v)[0],
                         ref.params, jnp.asarray(x))
    cot = _x(*y_ref.shape, seed=5)
    gp_ref, gx_ref = vjp(jnp.asarray(cot))
    t = torch.tensor(x, requires_grad=True)
    y = port(t)
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(y, [t] + list(port.parameters()),
                                torch.from_numpy(cot))
    want_p = convert.module_params_from_jax(
        port, jax.tree_util.tree_map(np.asarray, gp_ref))
    return ((y.detach().numpy(), grads[0].numpy(),
             dict(zip(names, (g.numpy() for g in grads[1:])))),
            (np.asarray(y_ref), np.asarray(gx_ref),
             {k: v.numpy() for k, v in want_p.items()}))


def _held(name, got, want):
    (y, gx, gp), (y_ref, gx_ref, gp_ref) = got, want
    _close(y, y_ref, f"{name} forward")
    _close(gx, gx_ref, f"{name} input gradient")
    assert sorted(gp) == sorted(gp_ref), name
    for k in gp:
        _close(gp[k], gp_ref[k], f"{name} gradient of {k}")


@pytest.mark.parametrize("name", sorted(SEPARABLE))
def test_separable_matches_the_reference(name):
    args, kw, shape = SEPARABLE[name]
    ref = jnn.SpatialSeparableConvolution(*args, **kw)
    port = tnn.SpatialSeparableConvolution(*args, **kw, device=CPU)
    _held(name, *_run(ref, port, _x(*shape)))


@pytest.mark.parametrize("name", sorted(SHARE))
def test_share_matches_the_reference(name):
    args, kw, shape = SHARE[name]
    ref = jnn.SpatialShareConvolution(*args, **kw)
    port = tnn.SpatialShareConvolution(*args, **kw, device=CPU)
    _held(name, *_run(ref, port, _x(*shape)))


def test_the_reference_spelling_is_the_same_class():
    assert tnn.SpatialSeperableConvolution is tnn.SpatialSeparableConvolution
    assert issubclass(tnn.SpatialShareConvolution, tnn.SpatialConvolution)


PALLAS = {"k9": conv_pallas9, "i2c": conv_pallas_i2c}
PLAIN = {"k9": cv.conv3x3_k9_ref, "i2c": cv.conv3x3_i2c_ref}


@pytest.mark.parametrize("kind", ["k9", "i2c"])
@pytest.mark.parametrize("cout", [1, 2])
@pytest.mark.parametrize("flip", [False, True])
def test_depthwise_shapes_on_rows_8_9_plain_vs_pallas(kind, cout, flip):
    """One depthwise group's convolution (Cin 1 to Cout 1 or 2) and its
    input gradient (the flip: Cout in, 1 out) through the kernels' plain
    versions against the Pallas kernels on the rotated weights, float32
    atol 1e-5."""
    n, h, w = 2, 9, 7
    cin_op, cout_op = (cout, 1) if flip else (1, cout)
    x = _x(n, h, w, cin_op, seed=1)
    ohwi = _x(cout, 3, 3, 1, seed=2) * 0.5     # the layer's (O, 3, 3, I)
    # the operation's HWIO taps: the weights, or rotated with I/O swapped
    taps = (ohwi[:, ::-1, ::-1, :].transpose(1, 2, 0, 3) if flip
            else ohwi.transpose(1, 2, 3, 0))
    assert taps.shape == (3, 3, cin_op, cout_op)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(PALLAS[kind](jnp.asarray(x),
                                       jnp.asarray(np.ascontiguousarray(
                                           taps))))
    got = PLAIN[kind](torch.from_numpy(x),
                      torch.from_numpy(np.ascontiguousarray(ohwi)), flip)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _xception_block(make, c, dev=None):
    """3 x [ReLU, separable 3x3 pad 1] with the residual add."""
    kw = {} if dev is None else {"device": dev}
    body = make.Sequential()
    for _ in range(3):
        body.add(make.ReLU())
        body.add(make.SpatialSeparableConvolution(c, c, 1, 3, 3, 1, 1, 1, 1,
                                                  **kw))
    return make.Sequential().add(
        make.ConcatTable().add(body).add(make.Identity())) \
        .add(make.CAddTable())


def test_xception_middle_flow_block_matches_the_reference():
    c, shape = 8, (2, 8, 6, 6)
    ref = _xception_block(jnn, c)
    port = _xception_block(tnn, c, CPU)
    _held("xception block", *_run(ref, port, _x(*shape)))


def test_conv_routes_count_the_depthwise_groups():
    """The block's route table: each separable layer's depthwise half one
    i2c launch a group forward and one a group for the input gradient
    (the first layer's too with ``input_grad``), its 1x1 one library
    call; a forward and backward on the CPU sends no SAME 3x3 to
    ``F.conv2d``."""
    c = 8
    block = _xception_block(tnn, c, CPU).reset(0)
    want = {"i2c": 3 * c + 2 * c, "k9": 0, "library": 3}
    assert routes.conv_routes(block, (6, 6)) == want
    assert routes.conv_routes(block, (6, 6), input_grad=True) == \
        {**want, "i2c": 6 * c}
    assert routes.conv_routes(block, (6, 6), dtype=torch.bfloat16) == {
        "i2c": {"tc": 0, "simt": 5 * c}, "k9": {"tc": 0, "simt": 0},
        "library": 3}
    tnn.SpatialConvolution.library_calls.clear()
    x = torch.tensor(_x(2, c, 6, 6), requires_grad=True)
    block(x).sum().backward()
    calls = dict(tnn.SpatialConvolution.library_calls)
    assert calls == {"1x1/s1": 3}, calls
    # the layer walk sees the halves in order
    walk = [type(m).__name__ for m, _, _ in routes.layer_walk(block, (6, 6))]
    assert walk.count("SpatialConvolution") == 6
