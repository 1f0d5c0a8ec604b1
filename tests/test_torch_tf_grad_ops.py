"""The gradient, feature-column, string and data ops of the port's
``bigdl_tpu_torch/ops/tf_ops.py`` against the JAX reference's
(``bigdl_tpu/ops/tf_ops.py``), on the CPU, on the same seeded numpy
inputs, modelled on the reference's ``tests/test_tf_importer.py``
(``TestWave3Ops``, ``TestGradOpsWave4``, ``TestFinalWaveOps``).

A gradient op agrees with the reference's within 1e-5 of the largest
magnitude of its output; the 3x3 stride-1 SAME ``ConvBackpropInput`` also
equals the flip kernels' plain versions (``ops.conv3x3``) and reaches no
library call. Feature columns, strings, ``DecodeRaw``, ``ParseExampleOp``
and ``DecodeImage`` agree exactly. ``RandomShuffle``'s numbers are
torch's: the test holds that its output is a row permutation of its
input, the identity without a generator, and the same for one seed.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.interop.tf_record import build_example as jbuild
from bigdl_tpu.ops import tf_ops as jt
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.interop.tf_record import build_example
from bigdl_tpu_torch.ops import conv3x3 as c3
from bigdl_tpu_torch.ops import tf_ops as tt

REL = 1e-5


@pytest.fixture(autouse=True)
def _keep_library_calls():
    """Leave ``SpatialConvolution.library_calls``, a process-wide counter
    that other test files read, as each test found it."""
    saved = tnn.SpatialConvolution.library_calls.copy()
    yield
    tnn.SpatialConvolution.library_calls.clear()
    tnn.SpatialConvolution.library_calls.update(saved)


def _np(y):
    return y.detach().numpy() if isinstance(y, torch.Tensor) \
        else np.asarray(y)


def _close(got, want, rel=REL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
        return
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, err / scale


def _f(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(make, xs):
    """``make(package)`` called on the numpy inputs ``xs`` (a table when
    more than one) in both packages: (port's output, reference's)."""
    jm, tm = make(jt), make(tt)
    jx = [jnp.asarray(a) for a in xs]
    want = jm.call((), jx if len(xs) > 1 else jx[0])
    tx = [torch.from_numpy(np.array(a)) for a in xs]
    got = tm(tx) if len(xs) > 1 else tm(tx[0])
    return got, want


def _outs(y):
    if isinstance(y, dict):
        return [y[k] for k in sorted(y)]
    return list(y) if isinstance(y, (list, tuple)) else [y]


# ------------------------------------------------------- elementwise pairs

PAIRS = ["ReluGrad", "Relu6Grad", "EluGrad", "SoftplusGrad", "SoftsignGrad",
         "SigmoidGrad", "TanhGrad", "SqrtGrad", "RsqrtGrad",
         "ReciprocalGrad"]


@pytest.mark.parametrize("op", PAIRS)
def test_grad_pair_matches_reference(op):
    rng = np.random.default_rng(1)
    a = _f(rng, 3, 7, scale=4.0)
    b = _f(rng, 3, 7, scale=4.0)
    if op in ("SqrtGrad", "RsqrtGrad", "ReciprocalGrad", "SigmoidGrad",
              "TanhGrad"):
        a = np.abs(a) + 0.25        # these take (y, dy): y of its range
    got, want = _both(lambda p: getattr(p, op)(), [a, b])
    _close(got, want)


def test_bias_add_grad():
    g = _f(np.random.default_rng(2), 2, 5, 5, 6)
    got, want = _both(lambda p: p.BiasAddGrad(), [g])
    _close(got, want)


def test_fused_batch_norm_grad():
    rng = np.random.default_rng(3)
    dy, x = _f(rng, 2, 4, 4, 3), _f(rng, 2, 4, 4, 3)
    scale, mean = _f(rng, 3), _f(rng, 3, scale=0.1)
    var = np.abs(_f(rng, 3)) + 0.5
    got, want = _both(lambda p: p.FusedBatchNormGrad(1e-3),
                      [dy, x, scale, mean, var])
    for g, w in zip(got, _outs(want)):
        _close(g, w)


@pytest.mark.parametrize("padding,shape,k,s", [
    ("SAME", (1, 5, 5, 2), 3, 2), ("VALID", (2, 6, 6, 3), 2, 2),
    ("SAME", (1, 4, 6, 2), 2, 1)])
def test_avg_pool_grad(padding, shape, k, s):
    mk = lambda p: p.AvgPoolGrad(shape, (k, k), (s, s), padding)  # noqa
    pooled = tt.AvgPoolGrad(shape, (k, k), (s, s), padding)._pool(
        torch.zeros(shape))
    g = _f(np.random.default_rng(4), *pooled.shape)
    got, want = _both(mk, [g])
    _close(got, want)


@pytest.mark.parametrize("padding,shape,k,s", [
    ("VALID", (2, 4, 4, 3), 2, 2), ("SAME", (1, 5, 5, 2), 3, 2)])
def test_max_pool_grad(padding, shape, k, s):
    rng = np.random.default_rng(5)
    x = _f(rng, *shape)
    mk = lambda p: p.MaxPoolGrad((k, k), (s, s), padding)  # noqa
    y = tt.MaxPoolGrad((k, k), (s, s), padding)._pool(torch.from_numpy(x))
    g = _f(rng, *y.shape)
    got, want = _both(mk, [x, y.numpy(), g])
    _close(got, want)


def test_max_pool_grad_ties_go_to_the_first_maximum():
    """A window of equal values (a ReLU's zeros) routes its gradient to
    its first element, as XLA's ``select_and_scatter`` does."""
    x = np.zeros((1, 4, 4, 1), np.float32)
    g = np.ones((1, 2, 2, 1), np.float32)
    got, want = _both(lambda p: p.MaxPoolGrad((2, 2), (2, 2), "VALID"),
                      [x, np.zeros_like(g), g])
    _close(got, want)
    assert float(_np(got)[0, 0, 0, 0]) == 1.0


# ------------------------------------------------------------- convolutions

CONV_CASES = {   # name: (input sizes, filter, strides, padding, depthwise)
    "3x3_s1_same": ((2, 8, 8, 3), (3, 3, 3, 4), (1, 1), "SAME", False),
    "3x3_s1_same_wide": ((1, 6, 7, 72), (3, 3, 72, 80), (1, 1), "SAME",
                         False),
    "3x3_s2_same": ((2, 8, 8, 3), (3, 3, 3, 4), (2, 2), "SAME", False),
    "3x3_s1_valid": ((1, 7, 7, 2), (3, 3, 2, 5), (1, 1), "VALID", False),
    "5x5_s2_same_odd": ((1, 9, 7, 2), (5, 5, 2, 3), (2, 2), "SAME", False),
    "1x1_valid": ((2, 4, 4, 6), (1, 1, 6, 5), (1, 1), "VALID", False),
    "7x7_valid": ((2, 7, 7, 4), (7, 7, 4, 8), (1, 1), "VALID", False),
    "depthwise_3x3_s1": ((2, 6, 6, 3), (3, 3, 3, 2), (1, 1), "SAME", True),
    "depthwise_3x3_s2": ((1, 7, 7, 3), (3, 3, 3, 2), (2, 2), "SAME", True),
    "3d_same": ((1, 4, 5, 5, 2), (3, 3, 3, 2, 4), (1, 1, 1), "SAME",
                False),
    "3d_s2_valid": ((1, 5, 6, 6, 2), (2, 3, 3, 2, 3), (2, 2, 1), "VALID",
                    False),
}


def _conv_out(sizes, wshape, strides, padding, depthwise):
    """The forward convolution's output shape."""
    nd = len(strides)
    sp = []
    for s, k, st in zip(sizes[1:1 + nd], wshape[:nd], strides):
        sp.append(-(-s // st) if padding == "SAME" else (s - k) // st + 1)
    cout = wshape[-2] * wshape[-1] if depthwise else wshape[-1]
    return (sizes[0], *sp, cout)


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv_backprop_input(case):
    sizes, wshape, strides, padding, dw = CONV_CASES[case]
    rng = np.random.default_rng(6)
    w = _f(rng, *wshape)
    g = _f(rng, *_conv_out(sizes, wshape, strides, padding, dw))
    nd = len(strides)
    mk = lambda p: p.ConvBackpropInput(  # noqa
        sizes, w, strides, padding, depthwise=dw, spatial_dims=nd,
        **({"device": "cpu"} if p is tt else {}))
    before = sum(tnn.SpatialConvolution.library_calls.values())
    got, want = _both(mk, [g])
    _close(got, want)
    m = mk(tt)
    calls = sum(tnn.SpatialConvolution.library_calls.values()) - before
    assert calls == (0 if m.uses_kernel() or nd == 3 else 1)
    assert m.uses_kernel() == case.endswith(("s1_same", "same_wide",
                                             "depthwise_3x3_s1"))


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv_backprop_filter(case):
    sizes, wshape, strides, padding, dw = CONV_CASES[case]
    rng = np.random.default_rng(7)
    x = _f(rng, *sizes)
    g = _f(rng, *_conv_out(sizes, wshape, strides, padding, dw))
    mk = lambda p: p.ConvBackpropFilter(  # noqa
        wshape, strides, padding, depthwise=dw, spatial_dims=len(strides))
    got, want = _both(mk, [x, g])
    _close(got, want)


@pytest.mark.parametrize("cin,cout", [(3, 64), (64, 128), (128, 32)])
def test_3x3_backprop_input_is_the_flip_kernel(cin, cout):
    """The 3x3 stride-1 SAME input gradient is ``conv3x3``'s flip path:
    on the CPU the plain version of the kernel ``kernel_for`` picks by the
    gradient's channels (both plain versions agree)."""
    rng = np.random.default_rng(8)
    w = _f(rng, 3, 3, cin, cout, scale=0.1)
    g = _f(rng, 2, 6, 5, cout)
    op = tt.ConvBackpropInput((2, 6, 5, cin), w, (1, 1), "SAME",
                              device="cpu")
    got = op(torch.from_numpy(g))
    w_ohwi = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 0, 1, 2)))
    for ref in (c3.conv3x3_k9_ref, c3.conv3x3_i2c_ref):
        _close(got, ref(torch.from_numpy(g), w_ohwi, flip=True), 1e-6)
    want = jt.ConvBackpropInput((2, 6, 5, cin), w, (1, 1), "SAME").call(
        (), jnp.asarray(g))
    _close(got, want)


def test_resize_bilinear_grad():
    rng = np.random.default_rng(9)
    for ac, (gs, xs) in [(False, ((1, 8, 8, 2), (1, 4, 4, 2))),
                         (False, ((2, 3, 5, 1), (2, 6, 4, 1))),
                         (True, ((1, 7, 5, 2), (1, 4, 3, 2)))]:
        got, want = _both(lambda p: p.ResizeBilinearGrad(ac),
                          [_f(rng, *gs), _f(rng, *xs)])
        _close(got, want)


def test_lrn_grad():
    rng = np.random.default_rng(10)
    g, x = _f(rng, 2, 3, 3, 7), _f(rng, 2, 3, 3, 7)
    got, want = _both(lambda p: p.LRNGrad(2, 1.5, 0.3, 0.75), [g, x, x])
    _close(got, want)


@pytest.mark.parametrize("wrt", ["input", "filter"])
@pytest.mark.parametrize("padding,strides", [("SAME", (1, 1)),
                                             ("VALID", (2, 1))])
def test_dilation2d_backprop(wrt, padding, strides):
    rng = np.random.default_rng(11)
    x, w = _f(rng, 1, 6, 6, 2), _f(rng, 3, 3, 2)
    fwd = tt.Dilation2D(w, strides, (1, 1), padding)
    g = _f(rng, *fwd(torch.from_numpy(x)).shape)
    got, want = _both(lambda p: p.Dilation2DBackprop(
        w, strides, (1, 1), padding, wrt=wrt,
        **({"device": "cpu"} if p is tt else {})), [x, g])
    _close(got, want)


# ------------------------------------------------------------ RandomShuffle

def test_random_shuffle_permutes_rows():
    x = torch.arange(40, dtype=torch.float32).reshape(10, 4)
    op = tt.RandomShuffle()
    assert torch.equal(op(x), x)            # no generator: the identity
    ys = [op(x, generator=torch.Generator().manual_seed(s))
          for s in (3, 3, 4)]
    for y in ys:
        assert sorted(y[:, 0].tolist()) == x[:, 0].tolist()
        assert torch.equal(y, x[(y[:, 0] / 4).long()])
    assert torch.equal(ys[0], ys[1])
    assert not torch.equal(ys[0], ys[2])
    # the reference's is the identity without an rng too
    want = jt.RandomShuffle().apply((), (), jnp.asarray(x.numpy()))[0]
    _close(op(x), want)


# ---------------------------------------------------------- feature columns

def test_hash_bucket_matches_reference():
    x = np.asarray([["apple", "pear"], ["kiwi", b"fig"]], dtype=object)
    got = tt.CategoricalColHashBucket(97)(x)
    want = jt.CategoricalColHashBucket(97).forward(x)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


def test_bucketized_indicator_cross_columns():
    x = np.asarray([[-1.0, 0.5, 2.0], [3.5, 1.0, 0.0]], np.float32)
    got, want = _both(lambda p: p.BucketizedCol([0.0, 1.0, 2.5]), [x])
    _close(got, want)
    ids = np.asarray([1, 0, 3, -1], np.int32)
    got, want = _both(lambda p: p.IndicatorCol(4), [ids])
    _close(got, want)
    multi = np.asarray([[0, 2], [1, 1], [3, 0]], np.int32)
    got, want = _both(lambda p: p.IndicatorCol(5), [multi])
    _close(got, want)
    a = np.asarray([5, -3, 2 ** 30, 7], np.int32)
    b = np.asarray([1, 9, -2 ** 31, 0], np.int32)
    got, want = _both(lambda p: p.CrossCol(1009), [a, b, a])
    _close(got, want)


@pytest.mark.parametrize("mode", [{}, {"is_set_default": True},
                                  {"num_oov_buckets": 3}])
def test_vocabulary_list_column(mode):
    voca = ["a", "b", "c"]
    x = np.asarray(["a,b", "z", "c,q,a", ""], dtype=object)
    got = tt.CategoricalColVocaList(voca, **mode)(x)
    want = jt.CategoricalColVocaList(voca, **mode).forward(x)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.values.numpy(),
                                  np.asarray(want.values))
    assert got.dense_shape == want.dense_shape
    np.testing.assert_array_equal(got.to_dense().numpy(),
                                  np.asarray(want.to_dense()))


def test_vocabulary_list_refusals():
    for kw in ({"num_oov_buckets": -1},
               {"is_set_default": True, "num_oov_buckets": 1}):
        with pytest.raises(ValueError):
            tt.CategoricalColVocaList(["a"], **kw)
    with pytest.raises(ValueError, match="duplicate"):
        tt.CategoricalColVocaList(["a", "a"])


def test_mk_string_and_kv2tensor():
    x = np.asarray([[1, 2, 3], [4, 5, 6]], np.int32)
    got = tt.MkString("-")(torch.from_numpy(x))
    want = jt.MkString("-").forward(x)
    assert list(got) == list(want)
    kv = np.asarray(["0:1.5,3:2", "1:4", ""], dtype=object)
    for dim in (-1, 2, 6):
        got = tt.Kv2Tensor(dim=dim)(kv)
        want = jt.Kv2Tensor(dim=dim).forward(kv)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, np.asarray(want))


# ------------------------------------------------------ strings and decoding

def test_substr():
    x = np.asarray([[b"hello", b"world"], [b"ab", b"tensor"]], dtype=object)
    got = tt.Substr(1, 3)(x)
    want = jt.Substr(1, 3).forward(x)
    assert got.shape == want.shape and got.tolist() == want.tolist()


@pytest.mark.parametrize("dtype,little", [(np.int32, True),
                                          (np.int32, False),
                                          (np.float32, False),
                                          (np.uint8, True),
                                          (np.int64, True)])
def test_decode_raw(dtype, little):
    vals = np.asarray([[1, -2, 3], [7, 8, -9]]).astype(dtype)
    order = "<" if little else ">"
    blobs = [v.astype(vals.dtype.newbyteorder(order)).tobytes()
             for v in vals]
    for x in (blobs[0], np.asarray(blobs, dtype=object)):
        got = tt.DecodeRaw(dtype, little_endian=little)(x)
        want = jt.DecodeRaw(dtype, little_endian=little).forward(x)
        assert got.dtype == want.dtype and got.dtype.isnative
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, vals)


def test_parse_example_dense_features_and_defaults():
    feats = [{"img": b"\x01\x02", "label": np.asarray([3]),
              "vec": np.asarray([1.5, 2.5, 3.5], np.float32)},
             {"img": b"\x07", "label": np.asarray([9]),
              "vec": np.asarray([0.0, -1.0, 4.0], np.float32)},
             {"img": b"", "label": np.asarray([1])}]
    blobs = np.asarray([build_example(f) for f in feats], dtype=object)
    assert list(blobs) == [jbuild(f) for f in feats]
    args = (["img", "label", "vec"], [(), (), (3,)],
            [np.bytes_, np.int64, np.float32])
    dflt = [None, None, np.asarray([9.0, 9.0, 9.0], np.float32)]
    got = tt.ParseExampleOp(*args, dense_defaults=dflt)(blobs)
    want = _outs(jt.ParseExampleOp(*args, dense_defaults=dflt)
                 .forward(blobs))
    assert len(got) == 3
    assert got[0].tolist() == list(want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[2][2], [9.0, 9.0, 9.0])
    with pytest.raises(KeyError, match="missing key 'vec'"):
        tt.ParseExampleOp(*args)(blobs)
    bad = (["vec"], [(-1,)], [np.float32])
    with pytest.raises(ValueError, match="unknown"):
        tt.ParseExampleOp(*bad, dense_defaults=[np.zeros(3, np.float32)])(
            blobs)
    with pytest.raises(ValueError, match="does not fit"):
        tt.ParseExampleOp(["vec"], [(2,)], [np.float32])(blobs[:1])


def test_decode_image_png_gif_and_grey():
    from PIL import Image
    rng = np.random.RandomState(3)
    img = rng.randint(0, 255, (5, 4, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    for ch in (0, 1, 3, 4):
        got = tt.DecodeImage(ch)(buf.getvalue())
        want = jt.DecodeImage(ch).forward(buf.getvalue())
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tt.DecodeImage(3)(buf.getvalue()), img)
    frames = [Image.fromarray(rng.randint(0, 255, (4, 3, 3),
                                          dtype=np.uint8))
              for _ in range(3)]
    gif = io.BytesIO()
    frames[0].save(gif, format="GIF", save_all=True,
                   append_images=frames[1:])
    got = tt.DecodeImage(all_frames=True)(gif.getvalue())
    want = jt.DecodeImage(all_frames=True).forward(gif.getvalue())
    assert got.shape == (3, 4, 3, 3)
    np.testing.assert_array_equal(got, want)
    one = tt.DecodeImage(0)(gif.getvalue())      # a palette frame: RGB
    np.testing.assert_array_equal(
        one, jt.DecodeImage(0).forward(gif.getvalue()))


def test_kernel_route_hands_the_kernels_aligned_tensors(monkeypatch):
    """A depthwise 3x3 convolution's groups are slices of its weight that
    start mid-storage; the kernels need 16-byte aligned rows, so the
    route copies such a slice (forward and flipped input gradient)."""
    seen = []

    def kernel(plain):
        def run(x, w, flip=False):
            seen.append((x.data_ptr() % 16, w.data_ptr() % 16,
                         x.is_contiguous() and w.is_contiguous()))
            return plain(x, w, flip)
        return run

    monkeypatch.setitem(c3.KERNELS, "i2c", kernel(c3.conv3x3_i2c_ref))
    monkeypatch.setitem(c3.KERNELS, "k9", kernel(c3.conv3x3_k9_ref))
    rng = np.random.default_rng(12)
    w = _f(rng, 3, 3, 5, 2)
    g = _f(rng, 2, 6, 6, 10)
    op = tt.ConvBackpropInput((2, 6, 6, 5), w, (1, 1), "SAME",
                              depthwise=True, device="cpu")
    got = op(torch.from_numpy(g))
    conv = tnn.SpatialConvolution(5, 10, 3, 3, 1, 1, -1, -1, n_group=5,
                                  with_bias=False, format="NHWC",
                                  device="cpu")
    with torch.no_grad():
        conv.weight.copy_(op.weight)
    conv(torch.from_numpy(_f(rng, 2, 6, 6, 5)))
    assert len(seen) == 10
    assert all(s == (0, 0, True) for s in seen), seen
    want = jt.ConvBackpropInput((2, 6, 6, 5), w, (1, 1), "SAME",
                                depthwise=True).call((), jnp.asarray(g))
    _close(got, want)
    t = torch.zeros(40)[2:10]
    assert t.data_ptr() % 16 and c3._aligned(t).data_ptr() % 16 == 0
