"""The port's 3x3 convolution (``bigdl_tpu_torch/ops/conv3x3.py``) against
the TPU kernels it replaces, ``conv_pallas9`` and ``conv_pallas_i2c`` of
``scripts/perf_pallas_conv.py``, run in Pallas interpret mode on the CPU,
and against ``jax.vjp`` of ``conv_xla`` for the gradients.

On the CPU the kernel wrappers run their plain versions (nine shifted
float32 products; one float32 product over an explicit patch matrix), so
these tests hold the arithmetic the CUDA kernels repeat on the card.
Tolerances: float32 atol 1e-5 (the same float32 sums in another order,
over at most 9 * 40 terms of unit size); bfloat16 2e-2 of the largest
reference magnitude, the script's own bar (``perf_pallas_conv.py:176``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bigdl_tpu_torch.ops import conv3x3 as cv
from scripts.perf_pallas_conv import conv_pallas9, conv_pallas_i2c, conv_xla

# (N, H, W, Cin, Cout): N = 2, H != W, the CIFAR stem's Cin = 3,
# Cin != Cout, a Cin that is a multiple of 8 but not of 16, and one of 64
SHAPES = [(2, 8, 6, 3, 5), (1, 5, 7, 16, 16), (2, 4, 4, 24, 40),
          (1, 3, 4, 64, 8)]
PALLAS = {"k9": conv_pallas9, "i2c": conv_pallas_i2c}
PLAIN = {"k9": cv.conv3x3_k9_ref, "i2c": cv.conv3x3_i2c_ref}
WRAPPER = {"k9": cv.conv3x3_k9, "i2c": cv.conv3x3_i2c}


def _inputs(shape, seed=0):
    """Seeded x (N, H, W, Cin) and HWIO weights, float32 numpy."""
    n, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, cin, cout)) * 0.2).astype(np.float32)
    return x, wt


def _ohwi(w_hwio):
    """The kernels' OHWI weights of HWIO ``w_hwio``."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(w_hwio).transpose(3, 0, 1, 2)))


def _pallas(kind, x, w, dtype):
    with pltpu.force_tpu_interpret_mode():
        out = PALLAS[kind](jnp.asarray(x, dtype), jnp.asarray(w, dtype))
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("kind", ["k9", "i2c"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_matches_pallas_kernel_float32(kind, shape):
    x, w = _inputs(shape)
    want = _pallas(kind, x, w, jnp.float32)
    got = PLAIN[kind](torch.from_numpy(x), _ohwi(w))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # on CPU tensors the wrapper is the plain version
    torch.testing.assert_close(WRAPPER[kind](torch.from_numpy(x), _ohwi(w)),
                               got, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["k9", "i2c"])
@pytest.mark.parametrize("shape", SHAPES[:3], ids=str)
def test_plain_matches_pallas_kernel_bfloat16(kind, shape):
    x, w = _inputs(shape, seed=1)
    want = _pallas(kind, x, w, jnp.bfloat16)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = _ohwi(w).to(torch.bfloat16)
    got = PLAIN[kind](xb, wb)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max(), err


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_k9_and_i2c_plain_versions_agree(shape):
    x, w = _inputs(shape, seed=2)
    a = cv.conv3x3_k9_ref(torch.from_numpy(x), _ohwi(w))
    b = cv.conv3x3_i2c_ref(torch.from_numpy(x), _ohwi(w))
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["k9", "i2c"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_flip_equals_an_explicitly_flipped_weight(kind, shape):
    """flip reads w rotated by 180 degrees with in and out swapped: the
    same as the unflipped kernel on that weight, copied out."""
    n, h, wd, cin, cout = shape
    _, w = _inputs(shape, seed=3)
    w = _ohwi(w)                                    # (Cout, 3, 3, Cin)
    dy = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (n, h, wd, cout)).astype(np.float32))
    flipped = w.flip(1, 2).permute(3, 1, 2, 0).contiguous()  # (Cin,3,3,Cout)
    got = PLAIN[kind](dy, w, flip=True)
    assert got.shape == (n, h, wd, cin)
    torch.testing.assert_close(got, PLAIN[kind](dy, flipped), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_autograd_matches_jax_vjp(shape):
    """conv3x3 (forward, dX through the flipped kernels, dW through
    conv2d_weight) against jax.vjp of conv_xla on the same inputs."""
    x, w = _inputs(shape, seed=5)
    n, h, wd, _, cout = shape
    g = np.random.default_rng(6).standard_normal((n, h, wd, cout)).astype(
        np.float32)
    y_ref, vjp = jax.vjp(conv_xla, jnp.asarray(x), jnp.asarray(w))
    dx_ref, dw_ref = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    # an OIHW weight kept channels-last, as nn.SpatialConvolution keeps it
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))).to(
        memory_format=torch.channels_last).requires_grad_(True)
    y = cv.conv3x3(xt, wt)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_ref), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy().transpose(2, 3, 1, 0),
                               np.asarray(dw_ref), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("cin,kernel", [(3, "i2c"), (16, "i2c"),
                                        (64, "i2c"), (65, "k9"),
                                        (128, "k9"), (512, "k9")])
def test_dispatch_rule(cin, kernel):
    assert cv.kernel_for(cin) == kernel


@pytest.mark.parametrize("cin,cout,forward,backward",
                         [(64, 64, "i2c", "i2c"), (64, 128, "i2c", "k9"),
                          (128, 64, "k9", "i2c"), (256, 256, "k9", "k9")])
def test_forward_and_input_gradient_take_the_rule(monkeypatch, cin, cout,
                                                  forward, backward):
    """The forward takes the kernel of Cin, the input gradient (flip) the
    kernel of Cout: the operation's input channels each time."""
    calls = []

    def spy(kind):
        def run(x, w, flip=False):
            calls.append((kind, flip))
            return PLAIN[kind](x, w, flip)
        return run

    monkeypatch.setitem(cv.KERNELS, "k9", spy("k9"))
    monkeypatch.setitem(cv.KERNELS, "i2c", spy("i2c"))
    x = torch.randn(1, 3, 3, cin, requires_grad=True)
    w = torch.randn(cout, cin, 3, 3, requires_grad=True)
    cv.conv3x3(x, w).sum().backward()
    assert calls == [(forward, False), (backward, True)]


def test_wrappers_check_their_arguments():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="channels"):
        cv.conv3x3_k9(x, torch.zeros(16, 3, 3, 4))
    with pytest.raises(ValueError, match="channels"):
        cv.conv3x3_i2c(x, torch.zeros(16, 3, 3, 8), flip=True)
    with pytest.raises(ValueError, match=r"\(O, 3, 3, I\)"):
        cv.conv3x3_k9(x, torch.zeros(16, 1, 1, 8))
    assert cv.conv3x3_i2c(x, torch.zeros(8, 3, 3, 3), flip=True).shape \
        == (1, 4, 4, 3)


def test_bytes_and_flops():
    x = torch.zeros(256, 56, 56, 64, dtype=torch.bfloat16)
    w = torch.zeros(64, 3, 3, 64, dtype=torch.bfloat16)
    nbytes, flops = cv.bytes_and_flops(x, w)
    assert flops == 2 * 256 * 56 * 56 * 9 * 64 * 64 == 59_190_018_048
    assert nbytes == 2 * (2 * 256 * 56 * 56 * 64 + 9 * 64 * 64)
    # flip: output channels are the weight's input channels
    nbytes, flops = cv.bytes_and_flops(torch.zeros(1, 2, 2, 8),
                                       torch.zeros(8, 3, 3, 4), flip=True)
    assert flops == 2 * 4 * 9 * 8 * 4 and nbytes == 4 * (32 + 288 + 16)
