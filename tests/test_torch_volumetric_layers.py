"""The 3-D, temporal, locally-connected, Maxout and Highway layers of the
port (``bigdl_tpu_torch/nn/{conv,pooling,normalization,locally_connected,
activation,misc}.py``) against their reference classes on the CPU.

Each case builds the reference layer, draws its params with ``setup``,
carries them into the port layer through ``convert.module_params_from_jax``
and feeds both the same seeded input. The forward outputs agree within
1e-5 of the output's largest magnitude (float32 sums of at most a few
hundred terms, in another order), and so do the gradients of a seeded
weighted sum of the output for the input and every parameter (each
parameter's gradient mapped back to the reference's layout), within 1e-4
of each one's largest magnitude. The batch norm also runs in training
mode: its output, gradients and updated running statistics are held the
same way. Each layer's ``reset`` draws weights of the reference's shapes,
random where the reference's are.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn as tnn

OUT_REL = 1e-5
GRAD_REL = 1e-4

# name -> (reference layer, port layer, input shape)
CASES = {
    "volumetric_conv": (
        lambda: jnn.VolumetricConvolution(2, 3, 2, 3, 2, 1, 2, 1, 1, 0, 1),
        lambda: tnn.VolumetricConvolution(2, 3, 2, 3, 2, 1, 2, 1, 1, 0, 1,
                                          device="cpu"),
        (2, 2, 5, 6, 5)),
    "volumetric_conv_same": (
        lambda: jnn.VolumetricConvolution(2, 3, 3, 3, 3, 2, 2, 2, -1, -1, -1,
                                          with_bias=False),
        lambda: tnn.VolumetricConvolution(2, 3, 3, 3, 3, 2, 2, 2, -1, -1, -1,
                                          with_bias=False, device="cpu"),
        (1, 2, 5, 6, 7)),
    "volumetric_full_conv": (
        lambda: jnn.VolumetricFullConvolution(3, 2, 2, 3, 2, 2, 1, 2, 0, 1,
                                              0, 1, 0, 1),
        lambda: tnn.VolumetricFullConvolution(3, 2, 2, 3, 2, 2, 1, 2, 0, 1,
                                              0, 1, 0, 1, device="cpu"),
        (2, 3, 3, 4, 3)),
    "volumetric_full_conv_wide_adj": (
        lambda: jnn.VolumetricFullConvolution(2, 2, 3, 3, 3, 2, 2, 2, 1, 1,
                                              1, 2, 0, 2, no_bias=True),
        lambda: tnn.VolumetricFullConvolution(2, 2, 3, 3, 3, 2, 2, 2, 1, 1,
                                              1, 2, 0, 2, no_bias=True,
                                              device="cpu"),
        (1, 2, 3, 3, 3)),
    "temporal_conv": (
        lambda: jnn.TemporalConvolution(4, 5, 3, 2, dilation=2),
        lambda: tnn.TemporalConvolution(4, 5, 3, 2, dilation=2,
                                        device="cpu"),
        (2, 13, 4)),
    "volumetric_max_pool": (
        lambda: jnn.VolumetricMaxPooling(2, 3, 2, 2, 1, 2, 1, 1, 0),
        lambda: tnn.VolumetricMaxPooling(2, 3, 2, 2, 1, 2, 1, 1, 0),
        (2, 2, 5, 6, 5)),
    "volumetric_avg_pool": (
        lambda: jnn.VolumetricAveragePooling(2, 2, 3, 1, 2, 2, 1, 1, 1),
        lambda: tnn.VolumetricAveragePooling(2, 2, 3, 1, 2, 2, 1, 1, 1),
        (2, 2, 4, 5, 6)),
    "volumetric_avg_pool_exclude_pad": (
        lambda: jnn.VolumetricAveragePooling(3, 3, 3, 2, 2, 2, 1, 1, 1,
                                             count_include_pad=False),
        lambda: tnn.VolumetricAveragePooling(3, 3, 3, 2, 2, 2, 1, 1, 1,
                                             count_include_pad=False),
        (1, 3, 5, 5, 5)),
    "temporal_max_pool": (
        lambda: jnn.TemporalMaxPooling(3, 2),
        lambda: tnn.TemporalMaxPooling(3, 2),
        (2, 9, 4)),
    "volumetric_bn": (
        lambda: jnn.VolumetricBatchNormalization(3),
        lambda: tnn.VolumetricBatchNormalization(3, device="cpu"),
        (4, 3, 2, 3, 3)),
    "locally_connected_1d": (
        lambda: jnn.LocallyConnected1D(7, 3, 4, 3, 2),
        lambda: tnn.LocallyConnected1D(7, 3, 4, 3, 2, device="cpu"),
        (2, 7, 3)),
    "locally_connected_2d": (
        lambda: jnn.LocallyConnected2D(2, 6, 5, 3, 3, 2, 1, 2, 1, 0),
        lambda: tnn.LocallyConnected2D(2, 6, 5, 3, 3, 2, 1, 2, 1, 0,
                                       device="cpu"),
        (2, 2, 6, 5)),
    "locally_connected_2d_nhwc": (
        lambda: jnn.LocallyConnected2D(3, 5, 5, 2, 2, 3, 2, 1, 0, 1,
                                       with_bias=False, format="NHWC"),
        lambda: tnn.LocallyConnected2D(3, 5, 5, 2, 2, 3, 2, 1, 0, 1,
                                       with_bias=False, format="NHWC",
                                       device="cpu"),
        (2, 5, 5, 3)),
    "maxout": (
        lambda: jnn.Maxout(4, 6, 3),
        lambda: tnn.Maxout(4, 6, 3, device="cpu"),
        (5, 4)),
    "highway": (
        lambda: jnn.Highway(5),
        lambda: tnn.Highway(5, device="cpu"),
        (3, 5)),
    "highway_relu_no_bias": (
        lambda: jnn.Highway(5, with_bias=False, activation=jnn.ReLU()),
        lambda: tnn.Highway(5, with_bias=False, activation=tnn.ReLU(),
                            device="cpu"),
        (3, 5)),
}


@pytest.fixture(autouse=True)
def _keep_library_calls():
    """Leave ``SpatialConvolution.library_calls``, a process-wide counter
    that other test files read, as each test found it."""
    saved = tnn.SpatialConvolution.library_calls.copy()
    yield
    tnn.SpatialConvolution.library_calls.clear()
    tnn.SpatialConvolution.library_calls.update(saved)


def _pair(name, seed):
    make_ref, make_port, shape = CASES[name]
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jm = make_ref()
    params, state = jm.setup(jax.random.PRNGKey(seed),
                             jax.ShapeDtypeStruct(shape, jnp.float32))
    tm = make_port()
    params_np = jax.tree_util.tree_map(np.asarray, params)
    state_np = jax.tree_util.tree_map(np.asarray, state)
    tm.load_state_dict(convert.module_params_from_jax(tm, params_np,
                                                      state_np))
    return jm, params, state, tm, x


def _close(got, want, rel, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.max(np.abs(want))), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_reference(name, training):
    jm, params, state, tm, x = _pair(name, seed=len(name))
    tm.train(training)
    jx = jnp.asarray(x)
    jy, jstate = jm.apply(params, state, jx, training=training)
    w = np.random.default_rng(7).standard_normal(jy.shape).astype(np.float32)

    def f(p, xx):
        y, _ = jm.apply(p, state, xx, training=training)
        return jnp.sum(y * w)

    jg_p, jg_x = jax.grad(f, argnums=(0, 1))(params, jx)
    tx = torch.from_numpy(x).requires_grad_()
    ty = tm(tx)
    (ty * torch.from_numpy(w)).sum().backward()

    _close(ty.detach().numpy(), jy, OUT_REL, f"{name} forward")
    _close(tx.grad.numpy(), jg_x, GRAD_REL, f"{name} input gradient")
    grads = {k: p.grad for k, p in tm.named_parameters()}
    tg, _ = convert.module_params_to_jax(tm, grads)
    jg = jax.tree_util.tree_map(np.asarray, jg_p)
    assert sorted(tg or {}) == sorted(jg or {}), name
    for leaf in sorted(tg or {}):
        _close(tg[leaf], jg[leaf], GRAD_REL, f"{name} {leaf} gradient")
    _, tstate = convert.module_params_to_jax(tm)
    for leaf in sorted(tstate or {}):
        _close(tstate[leaf], jstate[leaf], OUT_REL, f"{name} {leaf}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_reset_draws_the_reference_shapes(name):
    jm, params, _, tm, _ = _pair(name, seed=1)
    tm.reset(3)
    tp, _ = convert.module_params_to_jax(tm)
    ref = jax.tree_util.tree_map(np.asarray, params)
    assert sorted(tp or {}) == sorted(ref or {})
    for leaf, a in (tp or {}).items():
        assert a.shape == ref[leaf].shape and np.isfinite(a).all()
        # a drawn leaf draws (a constant one, BN's, stays constant)
        assert (np.std(a) > 0) == (np.std(ref[leaf]) > 0), f"{name} {leaf}"
