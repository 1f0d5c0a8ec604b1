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


# ------------------------------------------- the tensor-core path's host side
@pytest.mark.parametrize("dtype,cin,cout,flip,tc", [
    (torch.bfloat16, 64, 64, False, True),
    (torch.bfloat16, 512, 512, True, True),
    (torch.bfloat16, 8, 136, False, True),
    (torch.bfloat16, 16, 24, True, True),
    (torch.float32, 64, 64, False, False),      # float32: CUDA cores
    (torch.float32, 64, 64, True, False),
    (torch.bfloat16, 3, 16, False, False),      # the CIFAR stem's Cin = 3
    (torch.bfloat16, 16, 12, False, False),     # Cout % 8
    (torch.bfloat16, 12, 16, True, False),      # Cin % 8, with flip
])
def test_tensor_core_eligibility(dtype, cin, cout, flip, tc):
    """bfloat16 with the operation's Cin and Cout multiples of 8 takes the
    tensor cores (either kernel, any width up to TC_K9_MAX_W); float32 and
    other bfloat16 shapes the CUDA cores. ``cin``/``cout`` are the
    operation's: with flip the weight holds them swapped."""
    x = torch.zeros(1, 7, 7, cin, dtype=dtype)
    w = torch.zeros((cin, 3, 3, cout) if flip else (cout, 3, 3, cin),
                    dtype=dtype)
    for kind in ("k9", "i2c"):
        assert cv.tc_eligible(kind, x, w, flip) is tc


def test_tap_sum_width_limit():
    """The tap-sum halo (128 + 2W + 2 rows of 128 bytes, double-buffered)
    fits a CTA's shared memory up to W = TC_K9_MAX_W = 255; im2col has no
    halo and takes any width."""
    assert cv.TC_K9_MAX_W == 255
    for w, fits in ((cv.TC_K9_MAX_W, True), (cv.TC_K9_MAX_W + 1, False)):
        plan = cv.tc_plan("k9", 1, 2, w, 128, 128)
        assert (plan["smem_bytes"] <= cv.TC_MAX_SMEM) is fits
        x = torch.zeros(1, 2, w, 128, dtype=torch.bfloat16)
        wt = torch.zeros(128, 3, 3, 128, dtype=torch.bfloat16)
        assert cv.tc_eligible("k9", x, wt) is fits
        assert cv.tc_eligible("i2c", x, wt)


# (kind, N, H, W, Cin, Cout) -> grid, tile_n, stages, halo rows, bytes
TC_PLANS = [
    # ResNet-50's four stride-1 3x3 shapes at batch 256, on their kernels
    (("i2c", 256, 56, 56, 64, 64), (6272, 1), 64, 9, 0,
     1024 + 4 * 64 * 128 + 4 * 128 * 128),
    (("k9", 256, 28, 28, 128, 128), (1568, 1), 128, 18, 186,
     1024 + 4 * 128 * 128 + 2 * 24 * 1024 + 128),
    (("k9", 256, 14, 14, 256, 256), (392, 2), 128, 36, 158,
     1024 + 4 * 128 * 128 + 2 * 20 * 1024 + 128),
    (("k9", 256, 7, 7, 512, 512), (98, 4), 128, 72, 144,
     1024 + 4 * 128 * 128 + 2 * 18 * 1024 + 128),
    # ragged: one 7x7 image (49 pixels: one partial tile), Cin not a
    # multiple of 64, Cout not of the channel tile
    (("k9", 1, 7, 7, 72, 80), (1, 1), 128, 18, 144,
     1024 + 4 * 128 * 128 + 2 * 18 * 1024 + 128),
    (("i2c", 1, 7, 7, 8, 8), (1, 1), 64, 2, 0,
     1024 + 4 * 64 * 128 + 4 * 128 * 128),
    (("i2c", 3, 7, 9, 40, 200), (2, 2), 128, 6, 0,
     1024 + 4 * 128 * 128 + 4 * 128 * 128),
    # the CIFAR stem's shape (Cin 3): planned, though not eligible
    (("i2c", 128, 32, 32, 3, 16), (1024, 1), 64, 1, 0,
     1024 + 4 * 64 * 128 + 4 * 128 * 128),
]


@pytest.mark.parametrize("args,grid,tile_n,stages,halo_rows,smem", TC_PLANS,
                         ids=[str(p[0]) for p in TC_PLANS])
def test_tensor_core_plan(args, grid, tile_n, stages, halo_rows, smem):
    """Every host-side quantity of a tensor-core launch: 128-pixel tiles,
    64 output channels a CTA up to Cout 64 and 128 above, depth stages
    of 64 (tap-sum: 9 taps x ceil(Cin / 64); im2col: ceil(9 Cin / 64)),
    the tap-sum halo of 128 + 2W + 2 pixel rows, and the dynamic shared
    memory (alignment slack, 4 weight stages, 4 patch stages or two halo
    buffers rounded to 1 KiB and a zero row), under the 232,448 bytes a
    CTA may use."""
    plan = cv.tc_plan(*args)
    assert plan == {"tile_m": 128, "tile_n": tile_n, "grid": grid,
                    "stages": stages, "halo_rows": halo_rows,
                    "smem_bytes": smem}
    assert smem <= cv.TC_MAX_SMEM == 232448


class _FakeLib:
    """Records the C entry called and its arguments; launches nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize("kind", ["k9", "i2c"])
@pytest.mark.parametrize("dtype,cin,cout,flip,tc", [
    (torch.bfloat16, 64, 64, False, True),
    (torch.bfloat16, 128, 64, True, True),
    (torch.float32, 64, 64, True, False),
    (torch.bfloat16, 3, 64, False, False),
])
def test_launch_takes_one_path_and_moves_its_counter(monkeypatch, kind, dtype,
                                                     cin, cout, flip, tc):
    """The wrapper's card branch: the C entry it calls (the tensor-core
    entry with the kernel's mode, or the CUDA-core entry of its kernel
    with the dtype code) and the counter
    it moves (``tc_launches`` or ``launches``), decided before the launch
    from the shape and type alone. The library and the card are faked."""
    lib = _FakeLib()
    monkeypatch.setattr(cv, "_check_cuda", lambda fn, x, w: None)
    monkeypatch.setattr(cv._build, "load", lambda name, declare: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 7}))
    fn = cv.KERNELS[kind]
    monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(fn, "tc_launches", 0)
    op_cin = cout if flip else cin
    x = torch.zeros(2, 5, 7, op_cin, dtype=dtype)
    w = torch.zeros(cout, 3, 3, cin, dtype=dtype)
    y, ran_tc = cv._launch(f"conv3x3_{kind}", kind, x, w, flip)
    cv._count(fn, ran_tc)
    op_cout = cin if flip else cout
    assert ran_tc is tc and y.shape == (2, 5, 7, op_cout)
    assert (fn.tc_launches, fn.launches) == ((1, 0) if tc else (0, 1))
    [(name, args)] = lib.calls
    head = (2, 5, 7, op_cin, op_cout, int(flip))
    assert args[3:9] == head and args[-1] == 7
    if tc:
        assert name == "bigdl_conv3x3_tc" and len(args) == 11
        assert args[9] == {"k9": 0, "i2c": 1}[kind]
    else:
        assert name == f"bigdl_conv3x3_simt_{kind}"
        assert args[9] == {torch.float32: 0, torch.bfloat16: 1}[dtype]
