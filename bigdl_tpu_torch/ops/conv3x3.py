"""3x3 stride-1 SAME convolution over NHWC activations (the port of the
Pallas kernels in ``scripts/perf_pallas_conv.py``: ``_k9_kernel``, nine tap
products accumulated in float32, and ``_i2c_kernel``, one product over an
on-chip im2col patch matrix).

Layouts: activations ``x`` (N, H, W, Cin); the kernels' weights are OHWI,
``w`` (Cout, 3, 3, Cin), which is the memory order of an OIHW weight kept
in ``torch.channels_last``, so ``weight.permute(0, 2, 3, 1)`` of such a
parameter costs no copy. With ``flip=True`` a kernel reads ``w`` rotated by
180 degrees with in and out swapped: its input then has ``Cout`` channels
and its output ``Cin``, and it computes the input gradient of the
convolution without a copy of the weights.

- :func:`conv3x3_k9` and :func:`conv3x3_i2c` are the two kernel wrappers
  (``ops/csrc/conv3x3.cu``). For CPU tensors each runs its plain version,
  :func:`conv3x3_k9_ref` (nine shifted products summed in float32) or
  :func:`conv3x3_i2c_ref` (an explicit patch matrix and one product). For
  CUDA tensors each launches one of its two hand-written paths (or
  raises), chosen from the shape and type before the launch by
  :func:`tc_eligible`: the tensor-core kernel (wgmma, bfloat16, Cin and
  Cout multiples of 8; for k9 an image at most ``TC_K9_MAX_W`` wide),
  counted in ``.tc_launches``, else the CUDA-core kernel (float32 FMAs),
  counted in ``.launches``. float32 or bfloat16 in, float32 accumulation,
  the input type out. A bias is added by the caller.
- :func:`tc_plan` mirrors, for the host and its tests, the plan the
  tensor-core kernel's C entry makes for itself (tile, grid, stages, halo
  rows, dynamic shared memory).
- :func:`conv3x3` is the differentiable convolution of an NHWC ``x`` with
  an OIHW weight: forward through :func:`kernel_for` the operation's input
  channels (``i2c`` up to ``I2C_MAX_CIN``, ``k9`` above, the script's own
  reasoning: the in-VMEM im2col exists "for small Cin"); the input
  gradient through the same rule with ``flip``; the weight gradient through
  ``torch.nn.grad.conv2d_weight`` (the reference has no kernel for it).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the operation's input channels up to which the im2col kernel runs
I2C_MAX_CIN = 64

# the tensor-core kernel's tiling (ops/csrc/conv3x3.cu kTc*): pixels a CTA,
# depth of one pipeline stage, ring stages; and a CTA's shared memory limit
TC_TILE_M = 128
TC_DEPTH = 64
TC_STAGES = 4
TC_MAX_SMEM = 232448
_MODES = {"k9": 0, "i2c": 1}


def _declare(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.bigdl_conv3x3_simt_k9, lib.bigdl_conv3x3_simt_i2c):
        fn.argtypes = [ptr, ptr, ptr] + [i32] * 7 + [ptr]
        fn.restype = ctypes.c_int
    lib.bigdl_conv3x3_tc.argtypes = [ptr, ptr, ptr] + [i32] * 7 + [ptr]
    lib.bigdl_conv3x3_tc.restype = ctypes.c_int


def _channels(w, flip):
    """(input, output) channels of the operation on OHWI ``w``."""
    return (w.shape[0], w.shape[3]) if flip else (w.shape[3], w.shape[0])


# ------------------------------------------------------ plain versions --
def _taps(w, flip):
    """The operation's taps as float32 HWIO (3, 3, Cin, Cout)."""
    w = w.float()
    if flip:
        return w.flip(1, 2).permute(1, 2, 0, 3)
    return w.permute(1, 2, 3, 0)


def _shifted(x):
    """The nine (dy, dx) windows of ``x`` zero-padded by one, float32."""
    n, h, wd, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    return [xp[:, dy:dy + h, dx:dx + wd, :] for dy in range(3)
            for dx in range(3)]


def conv3x3_k9_ref(x, w, flip=False):
    """Plain tap-sum: nine shifted (pixels x Cin) . (Cin x Cout) products
    summed in float32, cast to ``x.dtype``."""
    taps = _taps(w, flip).reshape(9, *_channels(w, flip))
    acc = None
    for window, tap in zip(_shifted(x), taps):
        part = window @ tap
        acc = part if acc is None else acc + part
    return acc.to(x.dtype)


def conv3x3_i2c_ref(x, w, flip=False):
    """Plain im2col: the (pixels x 9*Cin) patch matrix times the (9*Cin x
    Cout) taps in float32, cast to ``x.dtype``."""
    cin, cout = _channels(w, flip)
    patches = torch.cat(_shifted(x), dim=-1)
    return (patches @ _taps(w, flip).reshape(9 * cin, cout)).to(x.dtype)


# ----------------------------------------------------------- wrappers --
def _check(fn, x, w, flip):
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[1:3]) != (3, 3):
        raise ValueError(f"{fn}: x must be (N, H, W, C) and w (O, 3, 3, I), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    cin, _ = _channels(w, flip)
    if x.shape[3] != cin:
        raise ValueError(f"{fn}: x has {x.shape[3]} channels, the weights "
                         f"(flip={flip}) take {cin}")


def _check_cuda(fn, x, w):
    if not x.is_cuda:
        raise ValueError(f"{fn}: x is on {x.device}; the kernel needs a "
                         f"CUDA tensor")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"{fn}: x and w must share a dtype in (float32, "
                        f"bfloat16), got {x.dtype} and {w.dtype}")
    for name, t in (("x", x), ("w", w)):
        if t.device != x.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be contiguous and 16-byte "
                             f"aligned")


def _ceil_div(a, b):
    return -(-a // b)


def tc_plan(kind, n, h, w, cin, cout):
    """Host-side plan of a tensor-core launch of kernel ``kind`` ("k9" or
    "i2c") on an (n, h, w, cin) input with ``cout`` output channels:
    ``tile_m`` x ``tile_n`` (64 when cout <= 64, else 128) per CTA, the
    ``grid`` (pixel tiles, channel tiles), the depth ``stages`` of 64, the
    tap-sum ``halo_rows`` (0 for i2c), and ``smem_bytes``: 1 KiB of
    alignment slack, TC_STAGES weight stages of tile_n x 128 bytes, then
    TC_STAGES patch stages of 128 x 128 bytes (i2c) or two halo buffers
    rounded to 1 KiB and a 128-byte zero row (k9). The kernel's C entry
    (``tc_smem_bytes``) makes the same plan from the same shape."""
    tile_n = 64 if cout <= 64 else 128
    row = TC_DEPTH * 2                  # one bfloat16 row of a stage
    if kind == "k9":
        halo_rows = TC_TILE_M + 2 * w + 2
        halo_bytes = _ceil_div(halo_rows * row, 1024) * 1024
        a_bytes = 2 * halo_bytes + 128
        stages = 9 * _ceil_div(cin, TC_DEPTH)
    else:
        halo_rows = 0
        a_bytes = TC_STAGES * TC_TILE_M * row
        stages = _ceil_div(9 * cin, TC_DEPTH)
    return {"tile_m": TC_TILE_M, "tile_n": tile_n,
            "grid": (_ceil_div(n * h * w, TC_TILE_M),
                     _ceil_div(cout, tile_n)),
            "stages": stages, "halo_rows": halo_rows,
            "smem_bytes": 1024 + TC_STAGES * tile_n * row + a_bytes}


# the widest image whose tap-sum halo fits in TC_MAX_SMEM at the wider
# channel tile (128)
TC_K9_MAX_W = max(w for w in range(1, 1024)
                  if tc_plan("k9", 1, 1, w, TC_DEPTH, 128)["smem_bytes"]
                  <= TC_MAX_SMEM)


def tc_path(kind, dtype, width, cin, cout):
    """Does kernel ``kind`` take the tensor-core path for an operation of
    ``cin`` input and ``cout`` output channels on ``dtype`` images
    ``width`` wide? bfloat16, both channel counts multiples of 8 (16-byte
    copies and stores), and for k9 an image no wider than TC_K9_MAX_W (its
    halo must fit in a CTA's shared memory)."""
    if dtype != torch.bfloat16 or cin % 8 or cout % 8:
        return False
    return kind != "k9" or width <= TC_K9_MAX_W


def tc_eligible(kind, x, w, flip=False):
    """:func:`tc_path` for ``x`` and OHWI ``w``."""
    return tc_path(kind, x.dtype, x.shape[2], *_channels(w, flip))


def _launch(fn, kind, x, w, flip):
    """Launch ``kind``'s tensor-core kernel where :func:`tc_eligible`, else
    its CUDA-core kernel; returns (y, True if the tensor cores ran)."""
    _check_cuda(fn, x, w)
    n, h, wd, cin = x.shape
    cout = _channels(w, flip)[1]
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    lib = _build.load("conv3x3", _declare)
    args = (x.data_ptr(), w.data_ptr(), y.data_ptr(), n, h, wd, cin, cout,
            int(bool(flip)))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    tc = tc_eligible(kind, x, w, flip)
    if tc:
        err = lib.bigdl_conv3x3_tc(*args, _MODES[kind], stream)
    else:
        err = getattr(lib, f"bigdl_conv3x3_simt_{kind}")(
            *args, _DTYPES[x.dtype], stream)
    if err != 0:
        path = "tensor-core" if tc else "CUDA-core"
        raise RuntimeError(f"{fn} {path} kernel launch failed: cudaError_t "
                           f"{err}")
    return y, tc


def _count(fn, tc):
    if tc:
        fn.tc_launches += 1
    else:
        fn.launches += 1


def conv3x3_k9(x, w, flip=False):
    """Tap-sum kernel (row 8): NHWC ``x`` with OHWI ``w`` (see module
    docstring)."""
    _check("conv3x3_k9", x, w, flip)
    if x.device.type == "cpu":
        return conv3x3_k9_ref(x, w, flip)
    y, tc = _launch("conv3x3_k9", "k9", x, w, flip)
    _count(conv3x3_k9, tc)
    return y


def conv3x3_i2c(x, w, flip=False):
    """im2col kernel (row 9): the same function as :func:`conv3x3_k9`."""
    _check("conv3x3_i2c", x, w, flip)
    if x.device.type == "cpu":
        return conv3x3_i2c_ref(x, w, flip)
    y, tc = _launch("conv3x3_i2c", "i2c", x, w, flip)
    _count(conv3x3_i2c, tc)
    return y


# launches of each kernel's CUDA-core path (.launches) and tensor-core
# path (.tc_launches)
conv3x3_k9.launches = conv3x3_k9.tc_launches = 0
conv3x3_i2c.launches = conv3x3_i2c.tc_launches = 0

KERNELS = {"k9": conv3x3_k9, "i2c": conv3x3_i2c}


def kernel_for(cin):
    """The kernel ("i2c" or "k9") an operation with ``cin`` input channels
    takes."""
    return "i2c" if cin <= I2C_MAX_CIN else "k9"


def _run(x, w, flip):
    return KERNELS[kernel_for(_channels(w, flip)[0])](x, w, flip)


class _Conv3x3(torch.autograd.Function):
    """NHWC ``x`` with OHWI ``w``: forward and input gradient through the
    kernels, weight gradient through ``conv2d_weight``."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _run(x, w, flip=False)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _run(dy, w, flip=True)
        if ctx.needs_input_grad[1]:
            cout, _, _, cin = w.shape
            dw = torch.nn.grad.conv2d_weight(
                x.permute(0, 3, 1, 2), (cout, cin, 3, 3),
                dy.permute(0, 3, 1, 2), stride=1, padding=1)
            dw = dw.permute(0, 2, 3, 1)
        return dx, dw


def conv3x3(x, weight):
    """3x3 stride-1 pad-1 convolution of NHWC ``x`` (N, H, W, Cin) with an
    OIHW ``weight`` (Cout, Cin, 3, 3), differentiable in both: (N, H, W,
    Cout). A channels-last ``weight`` is read in place."""
    if weight.dim() != 4 or tuple(weight.shape[2:]) != (3, 3):
        raise ValueError(f"conv3x3: weight must be (Cout, Cin, 3, 3), got "
                         f"{tuple(weight.shape)}")
    return _Conv3x3.apply(x.contiguous(),
                          weight.permute(0, 2, 3, 1).contiguous())


def bytes_and_flops(x, w, flip=False):
    """The least HBM bytes and operations of one call on ``x`` and OHWI
    ``w``: x, w and y each moved once; 2 * N * H * W * 9 * Cin * Cout."""
    n, h, wd, cin = x.shape
    cout = _channels(w, flip)[1]
    es = x.element_size()
    nbytes = (x.numel() + w.numel() + n * h * wd * cout) * es
    return nbytes, 2 * n * h * wd * 9 * cin * cout


__all__ = ["conv3x3", "conv3x3_k9", "conv3x3_i2c", "conv3x3_k9_ref",
           "conv3x3_i2c_ref", "kernel_for", "bytes_and_flops",
           "tc_eligible", "tc_path", "tc_plan", "I2C_MAX_CIN", "KERNELS",
           "TC_K9_MAX_W", "TC_MAX_SMEM"]
