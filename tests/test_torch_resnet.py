"""The port's ResNet layers and models (``bigdl_tpu_torch/nn/{conv,
normalization,pooling,activation,basic,table_ops}.py``,
``models/resnet.py``, ``convert.py``) against the JAX reference on the
same seeded inputs and weights, in both image layouts.

The reference's convolutions are ``lax.conv_general_dilated``; the port's
3x3 stride-1 pad-1 ones run the kernels' plain versions on the CPU and the
rest ``F.conv2d``. Tolerances, float32 on both sides: layers rtol 1e-5 /
atol 1e-5; whole models rtol 1e-4 / atol 1e-5 (sums over up to 4608 terms
in another order, through up to 53 BN layers, each dividing by a batch
standard deviation); BN running statistics rtol 1e-4 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.models.resnet import ResNet as JaxResNet
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models import ResNet, conv_routes, resnet_flops

FORMATS = ["NCHW", "NHWC"]
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)
STATE_TOL = dict(rtol=1e-4, atol=1e-6)


def _image(fmt, n, c, h, w, seed=0):
    x = np.random.default_rng(seed).standard_normal((n, c, h, w)).astype(
        np.float32)
    return x if fmt == "NCHW" else np.ascontiguousarray(
        x.transpose(0, 2, 3, 1))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# ------------------------------------------------------------------ layers
CONVS = {  # (n_in, n_out, k, stride, pad, bias, H, W)
    "3x3_pad1_kernel_route": (5, 7, 3, 1, 1, False, 6, 9),
    "3x3_same_kernel_route": (4, 6, 3, 1, -1, True, 7, 5),
    "3x3_stride2_pad1": (4, 6, 3, 2, 1, False, 8, 8),
    "3x3_stride2_same_asymmetric": (3, 5, 3, 2, -1, True, 8, 7),
    "5x5_pad2_bias": (3, 4, 5, 1, 2, True, 7, 6),
    "7x7_stride2_pad3": (3, 8, 7, 2, 3, False, 12, 12),
    "1x1_stride2": (6, 4, 1, 2, 0, False, 7, 7),
}


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("case", list(CONVS))
def test_spatial_convolution(fmt, case):
    n_in, n_out, k, s, p, bias, h, w = CONVS[case]
    jm = jnn.SpatialConvolution(n_in, n_out, k, k, s, s, p, p,
                                with_bias=bias, format=fmt)
    params = jm.make_params(jax.random.PRNGKey(1), None)
    if bias:
        params["bias"] = jnp.asarray(np.random.default_rng(2).standard_normal(
            n_out).astype(np.float32))
    x = _image(fmt, 2, n_in, h, w)
    want = jm.call(params, jnp.asarray(x))
    tm = tnn.SpatialConvolution(n_in, n_out, k, k, s, s, p, p,
                                with_bias=bias, format=fmt, device="cpu")
    sd = convert.resnet_params_from_jax(
        {"c": jax.tree_util.tree_map(np.asarray, params)})
    tm.load_state_dict({k_.split(".", 1)[1]: v for k_, v in sd.items()})
    assert tm.weight.is_contiguous(memory_format=torch.channels_last)
    before = sum(tnn.SpatialConvolution.library_calls.values())
    got = tm(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    _close(got, want, **LAYER_TOL)
    kernel = k == 3 and s == 1
    assert tm.uses_kernel(h, w) == kernel
    after = sum(tnn.SpatialConvolution.library_calls.values())
    assert after - before == (0 if kernel else 1)
    hw = (got.shape[1:3] if fmt == "NHWC" else got.shape[2:4])
    assert tm.output_hw(h, w) == tuple(hw)


def _bn_pair(fmt, c, seed=3):
    """The reference BN and the port's, both with the same non-trivial
    affine params and running statistics."""
    rng = np.random.default_rng(seed)
    jm = jnn.SpatialBatchNormalization(c, format=fmt)
    params = {"weight": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": rng.standard_normal(c).astype(np.float32)}
    state = {"running_mean": rng.standard_normal(c).astype(np.float32),
             "running_var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    tm = tnn.SpatialBatchNormalization(c, format=fmt, device="cpu")
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in
                        {**params, **state}.items()})
    return jm, params, state, tm


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_spatial_batch_normalization(fmt, training):
    jm, params, state, tm = _bn_pair(fmt, 6)
    x = _image(fmt, 3, 6, 5, 4) * 2.0 + 0.5
    want, new_state = jm.apply(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, state), jnp.asarray(x),
        training=training)
    tm.train(training)
    got = tm(torch.from_numpy(x))
    _close(got, want, **LAYER_TOL)
    for k in ("running_mean", "running_var"):
        _close(getattr(tm, k), new_state[k], **STATE_TOL)
    if not training:
        np.testing.assert_array_equal(tm.running_mean.numpy(),
                                      state["running_mean"])


@pytest.mark.parametrize("affine", [True, False])
def test_batch_normalization_1d_two_steps(affine):
    jm = jnn.BatchNormalization(5, affine=affine)
    params = jm.make_params(None, None)
    state = jm.make_state(None)
    tm = tnn.BatchNormalization(5, affine=affine, device="cpu")
    assert len(list(tm.parameters())) == (2 if affine else 0)
    tm.train()
    for seed in (0, 1):
        x = np.random.default_rng(seed).standard_normal((8, 5)).astype(
            np.float32) * 3.0 - 1.0
        want, state = jm.apply(params, state, jnp.asarray(x), training=True)
        _close(tm(torch.from_numpy(x)), want, **LAYER_TOL)
    for k in ("running_mean", "running_var"):
        _close(getattr(tm, k), state[k], **STATE_TOL)


POOLS = {  # name: (reference ctor, port ctor, C, H, W)
    "max_3s2p1": (lambda f: jnn.SpatialMaxPooling(3, 3, 2, 2, 1, 1, format=f),
                  lambda f: tnn.SpatialMaxPooling(3, 3, 2, 2, 1, 1, format=f),
                  3, 9, 8),
    "max_ceil": (lambda f: jnn.SpatialMaxPooling(3, 3, 2, 2, format=f).ceil(),
                 lambda f: tnn.SpatialMaxPooling(3, 3, 2, 2,
                                                 format=f).ceil(), 2, 8, 6),
    "max_same": (lambda f: jnn.SpatialMaxPooling(3, 3, 2, 2, -1, -1,
                                                 format=f),
                 lambda f: tnn.SpatialMaxPooling(3, 3, 2, 2, -1, -1,
                                                 format=f), 2, 8, 7),
    "max_global": (lambda f: jnn.SpatialMaxPooling(
                       2, 2, global_pooling=True, format=f),
                   lambda f: tnn.SpatialMaxPooling(
                       2, 2, global_pooling=True, format=f), 3, 5, 4),
    "avg_global": (lambda f: jnn.SpatialAveragePooling(
                       7, 7, global_pooling=True, format=f),
                   lambda f: tnn.SpatialAveragePooling(
                       7, 7, global_pooling=True, format=f), 4, 7, 7),
    "avg_ceil_include_pad": (
        lambda f: jnn.SpatialAveragePooling(3, 3, 2, 2, 1, 1, ceil_mode=True,
                                            format=f),
        lambda f: tnn.SpatialAveragePooling(3, 3, 2, 2, 1, 1, ceil_mode=True,
                                            format=f), 2, 8, 8),
    "avg_exclude_pad": (
        lambda f: jnn.SpatialAveragePooling(3, 3, 2, 2, 1, 1,
                                            count_include_pad=False,
                                            format=f),
        lambda f: tnn.SpatialAveragePooling(3, 3, 2, 2, 1, 1,
                                            count_include_pad=False,
                                            format=f), 2, 7, 9),
    "avg_sum_no_divide": (
        lambda f: jnn.SpatialAveragePooling(3, 3, 2, 2, 1, 1, divide=False,
                                            format=f),
        lambda f: tnn.SpatialAveragePooling(3, 3, 2, 2, 1, 1, divide=False,
                                            format=f), 2, 6, 7),
    "avg_sum_ceil_exclude_pad": (
        lambda f: jnn.SpatialAveragePooling(2, 2, 2, 2, ceil_mode=True,
                                            count_include_pad=False,
                                            format=f),
        lambda f: tnn.SpatialAveragePooling(2, 2, 2, 2, ceil_mode=True,
                                            count_include_pad=False,
                                            format=f), 2, 5, 7),
}


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("case", list(POOLS))
def test_pooling(fmt, case):
    make_ref, make_port, c, h, w = POOLS[case]
    x = _image(fmt, 2, c, h, w, seed=4)
    want = make_ref(fmt).call((), jnp.asarray(x))
    port = make_port(fmt)
    got = port(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    _close(got, want, **LAYER_TOL)
    hw = got.shape[1:3] if fmt == "NHWC" else got.shape[2:4]
    assert port.output_hw(h, w) == tuple(hw)


def test_activations_reshape_and_add():
    x = np.random.default_rng(5).standard_normal((3, 4, 2)).astype(
        np.float32)
    t = torch.from_numpy(x)
    _close(tnn.ReLU()(t), jnn.ReLU().call((), jnp.asarray(x)), rtol=0,
           atol=0)
    _close(tnn.LogSoftMax()(t), jnn.LogSoftMax().call((), jnp.asarray(x)),
           **LAYER_TOL)
    _close(tnn.Reshape((8,))(t), jnn.Reshape((8,)).call((), jnp.asarray(x)),
           rtol=0, atol=0)
    assert tnn.Reshape((24,), batch_mode=False)(t).shape == (24,)
    _close(tnn.CAddTable()(t, t * 2, t), 4 * x, rtol=1e-6, atol=0)


# ------------------------------------------------------------------ models
def _reference(jm, shape):
    """The reference model's params and BN state, keyed by layer name."""
    params, state = jm.setup(jax.random.PRNGKey(0),
                             jax.ShapeDtypeStruct(shape, jnp.float32))
    names = [n.module.name for n in jm.exec_order]
    assert len(names) == len(set(names)), "layer names must be unique"
    by_name = {n.module.name: jax.tree_util.tree_map(np.asarray,
                                                     params[str(n.id)])
               for n in jm.exec_order if params[str(n.id)]}
    st = {n.module.name: jax.tree_util.tree_map(np.asarray,
                                                state[str(n.id)])
          for n in jm.exec_order if state[str(n.id)]}
    return params, state, by_name, st


def _state_by_name(jm, state):
    return {n.module.name: state[str(n.id)] for n in jm.exec_order
            if state[str(n.id)]}


def _port_model(by_name, st, **kw):
    tm = ResNet(device="cpu", **kw)
    missing = tm.load_state_dict(convert.resnet_params_from_jax(by_name, st))
    assert not missing.missing_keys and not missing.unexpected_keys
    return tm


def _check_bn_state(tm, jm, new_state, tol=STATE_TOL):
    want = _state_by_name(jm, new_state)
    assert want, "the reference model has BN layers"
    for name, s in want.items():
        for k in ("running_mean", "running_var"):
            _close(getattr(tm, name).__getattr__(k), s[k],
                   err_msg=f"{name}.{k}", **tol)


@pytest.mark.parametrize("fmt", FORMATS)
def test_cifar_resnet8(fmt):
    kw = dict(class_num=10, depth=8, data_set="CIFAR-10", format=fmt)
    x = _image(fmt, 4, 3, 16, 16, seed=6)
    jm = JaxResNet(**kw)
    params, state, by_name, st = _reference(jm, x.shape)
    tm = _port_model(by_name, st, **kw)
    assert set(by_name) >= {"conv1", "res2_0_conv1", "res3_0_proj",
                            "Linear"}
    for training in (True, False):
        want, new_state = jm.apply(params, state, jnp.asarray(x),
                                   training=training)
        tm.train(training)
        got = tm(torch.from_numpy(x))
        assert got.shape == (4, 10)
        _close(got, want, **MODEL_TOL)
        _check_bn_state(tm, jm, new_state)
        state = new_state
    # the CIFAR stem reads the images through the kernel route: no input
    # gradient there
    assert conv_routes(tm, (16, 16)) == {"i2c": 9, "k9": 0, "library": 4}


@pytest.mark.parametrize("shortcut_type,n_proj", [("A", 2), ("C", 6)])
def test_cifar_resnet14_shortcut_types(shortcut_type, n_proj):
    """Type A projects where the shape changes, as B does; type C projects
    every shortcut. Same layer names and evaluation logits as the
    reference."""
    kw = dict(class_num=10, depth=14, data_set="CIFAR-10", format="NHWC",
              shortcut_type=shortcut_type)
    x = _image("NHWC", 2, 3, 16, 16, seed=8)
    jm = JaxResNet(**kw)
    params, state, by_name, st = _reference(jm, x.shape)
    assert sum(name.endswith("_proj") for name in by_name) == n_proj
    tm = _port_model(by_name, st, **kw)
    want, _ = jm.apply(params, state, jnp.asarray(x), training=False)
    _close(tm.eval()(torch.from_numpy(x)), want, **MODEL_TOL)


def _resnet50(x):
    kw = dict(class_num=1000, depth=50, format="NHWC")
    jm = JaxResNet(**kw)
    params, state, by_name, st = _reference(jm, x.shape)
    return jm, params, state, _port_model(by_name, st, **kw)


def test_imagenet_resnet50_nhwc_eval():
    x = _image("NHWC", 2, 3, 32, 32, seed=7)
    jm, params, state, tm = _resnet50(x)
    want, _ = jm.apply(params, state, jnp.asarray(x), training=False)
    tm.eval()
    got = tm(torch.from_numpy(x))
    assert got.shape == (2, 1000)
    _close(got, want, **MODEL_TOL)
    # 13 stride-1 3x3 convolutions: 3 on 64 channels (i2c), 10 above (k9),
    # each forward and input gradient; 40 other convolutions
    assert conv_routes(tm) == {"i2c": 6, "k9": 20, "library": 40}


# Training mode normalises by batch statistics through 53 BN layers; at
# 32 x 32 the last stage sees 1 x 1 images, 2 values a channel, and its
# one-pass variance cancels: a 2^-23 relative change of the input alone
# moves the port's log-probs by up to 1.8 there, so summation order cannot
# be held. At 64 x 64 the same change moves them by 1.8e-4 and the port
# and the reference differ by 6.4e-4 (both measured on the CPU); the bar
# is atol 1e-3 on log-probs of magnitude ~7 (1.4e-4 of their scale), and
# atol 1e-4 on running statistics of magnitude up to ~1 (the last stage's
# running means differ by up to 2.3e-5 where the batch sees 8 values a
# channel).
TRAIN_TOL = dict(rtol=1e-4, atol=1e-3)
TRAIN_STATE_TOL = dict(rtol=1e-4, atol=1e-4)


def test_imagenet_resnet50_nhwc_train():
    x = _image("NHWC", 2, 3, 64, 64, seed=7)
    jm, params, state, tm = _resnet50(x)
    want, new_state = jm.apply(params, state, jnp.asarray(x), training=True)
    got = tm(torch.from_numpy(x))
    _close(got, want, **TRAIN_TOL)
    _check_bn_state(tm, jm, new_state, TRAIN_STATE_TOL)


def test_state_dict_names_are_the_reference_names():
    jm = JaxResNet(class_num=1000, depth=50, format="NHWC")
    _, _, by_name, st = _reference(jm, (1, 32, 32, 3))
    tm = ResNet(class_num=1000, depth=50, format="NHWC", device="cpu")
    want = {f"{n}.{leaf}" for n, leaves in by_name.items() for leaf in leaves}
    want |= {f"{n}.{leaf}" for n, leaves in st.items() for leaf in leaves}
    assert set(tm.state_dict()) == want
    # the port's random init has the reference's leaves and shapes
    init_p, init_s = convert.init_resnet_tree(tm, seed=0)
    assert init_p.keys() == by_name.keys() and init_s.keys() == st.keys()
    for name, leaves in by_name.items():
        for leaf, a in leaves.items():
            assert init_p[name][leaf].shape == a.shape, (name, leaf)


def test_params_round_trip():
    jm = JaxResNet(class_num=10, depth=8, data_set="CIFAR-10",
                   format="NHWC")
    _, _, by_name, st = _reference(jm, (1, 16, 16, 3))
    back_p, back_s = convert.resnet_params_to_jax(
        convert.resnet_params_from_jax(by_name, st))
    assert back_p.keys() == by_name.keys() and back_s.keys() == st.keys()
    for tree, back in ((by_name, back_p), (st, back_s)):
        for name, leaves in tree.items():
            assert back[name].keys() == leaves.keys()
            for leaf, a in leaves.items():
                np.testing.assert_array_equal(back[name][leaf], a)


def test_init_draws_the_reference_distributions():
    tm = ResNet(class_num=10, depth=8, data_set="CIFAR-10", device="cpu")
    params, state = convert.init_resnet_tree(tm, seed=0)
    w = params["res3_0_conv1"]["weight"]                  # 3x3, 16 -> 32
    bound = np.sqrt(6.0 / (9 * 16 + 9 * 32))
    assert w.shape == (3, 3, 16, 32) and np.abs(w).max() <= bound
    assert np.abs(w).max() > 0.9 * bound
    fc = params["Linear"]
    assert np.abs(fc["weight"]).max() <= 1 / 8 and fc["bias"].any()
    np.testing.assert_array_equal(params["conv1_bn"]["weight"], 1.0)
    np.testing.assert_array_equal(state["conv1_bn"]["running_var"], 1.0)
    again, _ = convert.init_resnet_tree(tm, seed=0)
    np.testing.assert_array_equal(again["conv1"]["weight"],
                                  params["conv1"]["weight"])


@pytest.mark.parametrize("depth,want", [(50, 8_178_368_512),
                                        (18, 3_628_146_688)])
def test_resnet_flops(depth, want):
    """2 operations per multiply-add; ResNet-50 at 224 x 224 is about
    8.2e9, twice the 4.089e9 multiply-adds ``bench.py`` counts."""
    tm = ResNet(class_num=1000, depth=depth, format="NHWC", device="cpu")
    assert resnet_flops(tm, (224, 224)) == want


def test_default_format_follows_the_flag(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_ENABLE_NHWC", "1")
    assert ResNet(10, 8, data_set="cifar10", device="cpu").format == "NHWC"
    monkeypatch.delenv("BIGDL_TPU_ENABLE_NHWC")
    assert ResNet(10, 8, data_set="cifar10", device="cpu").format == "NCHW"
