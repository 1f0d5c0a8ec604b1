"""2-D convolution (the port of ``bigdl_tpu/nn/conv.py``, the whole file:
``SpatialConvolution`` and ``SpatialDilatedConvolution``, any ``n_group``,
any dilation; ``SpatialShareConvolution``, the same layer under the
reference's other name; ``SpatialSeparableConvolution``, a depthwise and a
pointwise ``SpatialConvolution``; ``SpatialFullConvolution``, the
transposed convolution; and the 1-D and 3-D ones at the end of this
module).

The weight is OIHW, ``(O, I / n_group, kh, kw)`` as torch's ``F.conv2d``
takes it (the reference's HWIO ``(kh, kw, I / n_group, O)``), kept in
``torch.channels_last`` memory order (O, H, W, I): the order the 3x3
kernels read, so neither route copies it. ``convert.py`` turns the
reference's HWIO weights into it. ``format`` is the activations' layout,
"NCHW" or "NHWC"; ``pad = -1`` means SAME, as in the reference.

Routes:

- a 3x3, stride-1, pad-1 (or SAME) convolution goes to
  ``ops.conv3x3.conv3x3``, the hand-written kernels on the card, forward
  and input gradient; a grouped one runs them once per group, on the
  group's channels of the input and its rows of the weight, and
  concatenates the groups' outputs;
- every other one (the ResNet stem's 7x7, the 1x1s, stride-2 3x3s,
  AlexNet's grouped 5x5, a dilated 3x3) is ``F.conv2d``
  (``groups=n_group``, ``dilation``), as the reference leaves those to XLA
  outside any Pallas kernel. An NHWC input goes in as the channels-last
  NCHW view ``x.permute(0, 3, 1, 2)``, which cuDNN takes without a copy.
  ``SpatialConvolution.library_calls`` counts these calls by geometry
  (``"3x3/s2"``, ``"3x3/s1/d2"``, ...; a 3x3 stride-1 one that is not
  SAME by its padding, ``"3x3/s1/valid"`` or ``"3x3/s1/pad0,1,0,1"``), so
  a run can show that no kernel-route convolution reached the library
  (no ``"3x3/s1"``).

:func:`takes_kernels` is that rule, and :func:`conv2d` that choice for a
bare NCHW or NHWC tensor and an OIHW weight; the convolutional LSTM cells
(``nn/recurrent.py``) call it. :func:`conv2d_input` is its input gradient
by the same choice, for the gradient ops a TF training graph writes
(``ops.tf_ops.ConvBackpropInput``).

An NCHW input in ``torch.channels_last`` memory order is NHWC in memory,
so the kernels read it without a copy.

``w_regularizer``/``b_regularizer`` join the training loss
(``nn.module.regularization_loss``). With ``pad = -1`` a dilated
convolution's SAME padding is over its dilated extent, as XLA's.
"""

from __future__ import annotations

import collections

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn.module import Module, from_jax_layout
from bigdl_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_input_grad
from bigdl_tpu_torch.utils.device import resolve_device


def same_padding(size, k, s):
    """XLA's SAME (lo, hi) padding of one spatial axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def takes_kernels(kernel_hw, stride, padding, dilation=(1, 1)):
    """Does a convolution of this geometry take the 3x3 kernels: 3x3,
    stride 1, undilated, padded by 1 on every side (``padding``
    ((top, bottom), (left, right)))?"""
    return (tuple(kernel_hw) == (3, 3) and tuple(stride) == (1, 1)
            and tuple(dilation) == (1, 1)
            and tuple(map(tuple, padding)) == ((1, 1), (1, 1)))


def conv2d(x, weight, stride=(1, 1), padding=((0, 0), (0, 0)),
           dilation=(1, 1), groups=1, nhwc=False):
    """``x`` (NCHW, or NHWC with ``nhwc``) convolved with the OIHW
    ``weight``, no bias, in ``x``'s layout: through the hand-written
    kernels (once a group) where :func:`takes_kernels`, else through
    ``F.conv2d`` and counted in ``SpatialConvolution.library_calls``
    (module docstring). ``padding`` is ((top, bottom), (left, right))."""
    kh, kw = weight.shape[2:]
    if takes_kernels((kh, kw), stride, padding, dilation):
        y = _kernel_route(x if nhwc else x.permute(0, 2, 3, 1), weight,
                          groups)
        return y if nhwc else y.permute(0, 3, 1, 2)
    geometry = f"{kh}x{kw}/s{stride[0]}"
    (t, b), (l, r) = padding
    if tuple(dilation) != (1, 1):
        geometry += f"/d{dilation[0]}"
    elif (kh, kw) == (3, 3) and tuple(stride) == (1, 1) \
            and (t, b, l, r) != (1, 1, 1, 1):
        geometry += ("/valid" if (t, b, l, r) == (0, 0, 0, 0)
                     else f"/pad{t},{b},{l},{r}")
    SpatialConvolution.library_calls[geometry] += 1
    xc = x.permute(0, 3, 1, 2) if nhwc else x
    if t == b and l == r:
        pad = (t, l)
    else:
        xc, pad = F.pad(xc, (l, r, t, b)), (0, 0)
    y = F.conv2d(xc, weight, None, tuple(stride), pad, tuple(dilation),
                 groups)
    return y.permute(0, 2, 3, 1) if nhwc else y


def _kernel_route(x, weight, groups):
    """The 3x3 kernels on NHWC ``x``, once per group."""
    if groups == 1:
        return conv3x3(x, weight)
    ci, co = x.shape[-1] // groups, weight.shape[0] // groups
    return torch.cat([conv3x3(x[..., i * ci:(i + 1) * ci],
                              weight[i * co:(i + 1) * co])
                      for i in range(groups)], dim=-1)


def conv2d_input(grad, weight, input_hw, stride=(1, 1),
                 padding=((0, 0), (0, 0)), groups=1):
    """The gradient of :func:`conv2d` (NHWC) with respect to its input of
    spatial size ``input_hw``, for the NHWC ``grad`` and the OIHW
    ``weight``: through the flip kernels where :func:`takes_kernels` (once
    a group, by the gradient's channels, as ``conv3x3``'s backward), else
    through ``torch.nn.grad.conv2d_input`` on the padded size, cropped,
    and counted in ``SpatialConvolution.library_calls`` as
    ``"<kh>x<kw>/s<stride>/input_grad"``."""
    kh, kw = weight.shape[2:]
    if takes_kernels((kh, kw), stride, padding):
        w = weight.permute(0, 2, 3, 1)      # OHWI
        if groups == 1:
            return conv3x3_input_grad(grad, w)
        co = w.shape[0] // groups
        return torch.cat([conv3x3_input_grad(grad[..., i * co:(i + 1) * co],
                                             w[i * co:(i + 1) * co])
                          for i in range(groups)], dim=-1)
    geometry = f"{kh}x{kw}/s{stride[0]}/input_grad"
    SpatialConvolution.library_calls[geometry] += 1
    (t, b), (l, r) = padding
    h, w = input_hw
    size = (grad.shape[0], weight.shape[1] * groups, h + t + b, w + l + r)
    dx = torch.nn.grad.conv2d_input(size, weight, grad.permute(0, 3, 1, 2),
                                    tuple(stride), groups=groups)
    return dx[:, :, t:t + h, l:l + w].permute(0, 2, 3, 1)


class SpatialConvolution(Module):
    """Reference ``nn/SpatialConvolution.scala:54`` (see module
    docstring)."""

    library_calls = collections.Counter()

    def __init__(self, n_input_plane, n_output_plane, kernel_w, kernel_h,
                 stride_w=1, stride_h=1, pad_w=0, pad_h=0, n_group=1,
                 propagate_back=True, w_regularizer=None, b_regularizer=None,
                 with_bias=True, format="NCHW", dilation_w=1, dilation_h=1,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer
        if format not in ("NCHW", "NHWC"):
            raise ValueError(f"format must be NCHW or NHWC, got {format!r}")
        if n_input_plane % n_group or n_output_plane % n_group:
            raise ValueError(f"n_group {n_group} must divide the input and "
                             f"output planes ({n_input_plane}, "
                             f"{n_output_plane})")
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.n_group = n_group
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.dilation_w, self.dilation_h = dilation_w, dilation_h
        self.format = format
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(
            n_output_plane, n_input_plane // n_group, kernel_h, kernel_w,
            device=device, dtype=dtype).to(
                memory_format=torch.channels_last))
        if with_bias:
            self.bias = nn.Parameter(torch.zeros(n_output_plane, device=device,
                                                 dtype=dtype))
        else:
            self.register_parameter("bias", None)

    def _extent(self):
        """The dilated kernel's (height, width)."""
        return ((self.kernel_h - 1) * self.dilation_h + 1,
                (self.kernel_w - 1) * self.dilation_w + 1)

    def padding(self, h, w):
        """((top, bottom), (left, right)) for an h x w input."""
        if self.pad_h == -1 or self.pad_w == -1:
            eh, ew = self._extent()
            return (same_padding(h, eh, self.stride_h),
                    same_padding(w, ew, self.stride_w))
        return (self.pad_h, self.pad_h), (self.pad_w, self.pad_w)

    def output_hw(self, h, w):
        (t, b), (l, r) = self.padding(h, w)
        eh, ew = self._extent()
        return ((h + t + b - eh) // self.stride_h + 1,
                (w + l + r - ew) // self.stride_w + 1)

    def uses_kernel(self, h, w):
        """Does an h x w input take the 3x3 kernels?"""
        return takes_kernels((self.kernel_h, self.kernel_w),
                             (self.stride_h, self.stride_w),
                             self.padding(h, w),
                             (self.dilation_h, self.dilation_w))

    def conv_launches(self, h, w, grad):
        """A training step's 3x3 kernel launches on an h x w input, as
        ``[(cin, cout, width, n)]`` (``models.routes.conv_routes``): the
        forward, and the input gradient where ``grad``, once a group; None
        where it is one library call."""
        if not self.uses_kernel(h, w):
            return None
        ci, co = (self.n_input_plane // self.n_group,
                  self.n_output_plane // self.n_group)
        return ([(ci, co, w, self.n_group)]
                + ([(co, ci, w, self.n_group)] if grad else []))

    def forward(self, x):
        nhwc = self.format == "NHWC"
        h, w = x.shape[1:3] if nhwc else x.shape[2:4]
        y = conv2d(x, self.weight, (self.stride_h, self.stride_w),
                   self.padding(h, w), (self.dilation_h, self.dilation_w),
                   self.n_group, nhwc)
        if self.bias is not None:
            y = y + self.bias.reshape((1, 1, 1, -1) if nhwc else (1, -1, 1, 1))
        return y

    def init_arrays(self, rng):
        # Glorot-uniform over one group's fans, as the reference's Xavier
        # takes them
        kk = self.kernel_h * self.kernel_w
        cin = self.n_input_plane // self.n_group
        bound = np.sqrt(6.0 / (kk * cin
                               + kk * self.n_output_plane // self.n_group))
        hwio = rng.uniform(-bound, bound, (self.kernel_h, self.kernel_w,
                                           cin, self.n_output_plane))
        out = {"weight": hwio.transpose(3, 2, 0, 1)}
        if self.bias is not None:
            out["bias"] = np.zeros(self.n_output_plane)
        return out

    def extra_repr(self):
        return (f"{self.n_input_plane} -> {self.n_output_plane}, "
                f"{self.kernel_w}x{self.kernel_h}, "
                f"{self.stride_w},{self.stride_h}, {self.pad_w},{self.pad_h}, "
                f"{self.format}"
                + (f", groups={self.n_group}" if self.n_group > 1 else "")
                + (f", dilation {self.dilation_w}x{self.dilation_h}"
                   if (self.dilation_w, self.dilation_h) != (1, 1) else ""))


class SpatialDilatedConvolution(SpatialConvolution):
    """Reference ``nn/SpatialDilatedConvolution.scala``: the same layer
    with the reference's short argument names."""

    def __init__(self, n_input_plane, n_output_plane, kw, kh, dw=1, dh=1,
                 pad_w=0, pad_h=0, dilation_w=1, dilation_h=1, **kwargs):
        super().__init__(n_input_plane, n_output_plane, kw, kh, dw, dh,
                         pad_w, pad_h, dilation_w=dilation_w,
                         dilation_h=dilation_h, **kwargs)


class SpatialShareConvolution(SpatialConvolution):
    """Reference ``nn/SpatialShareConvolution.scala``: the same arithmetic
    as ``SpatialConvolution`` (the reference's variant shares im2col
    buffers between model replicas, which the allocator owns here), kept
    as its own type for the loaders and the native format."""


class SpatialSeparableConvolution(Module):
    """Depthwise, then pointwise (reference
    ``nn/SpatialSeperableConvolution.scala``): ``depthwise`` a
    ``SpatialConvolution`` of ``n_input_channel`` groups, each one input
    channel to ``depth_multiplier`` outputs, without bias; ``pointwise`` a
    1x1 ``SpatialConvolution`` to ``n_output_channel`` with ``has_bias``.
    At 3x3 stride 1 pad 1 the depthwise half takes rows 8-9 once a group,
    forward and input gradient (``conv_launches``); the 1x1 is one
    library call. ``models.conv_routes`` walks the two halves in order.
    The reference's params are ``{"depthwise": {...}, "pointwise":
    {...}}`` (``param_children``)."""

    param_children = (("depthwise", "depthwise"), ("pointwise", "pointwise"))

    def __init__(self, n_input_channel, n_output_channel, depth_multiplier,
                 kw, kh, sw=1, sh=1, pw=0, ph=0, has_bias=True,
                 format="NCHW", w_regularizer=None, b_regularizer=None,
                 p_regularizer=None, device=None, dtype=torch.float32):
        super().__init__()
        self.n_input_channel = n_input_channel
        self.n_output_channel = n_output_channel
        self.depth_multiplier = depth_multiplier
        self.kw, self.kh, self.sw, self.sh = kw, kh, sw, sh
        self.pw, self.ph = pw, ph
        self.has_bias = has_bias
        self.format = format
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer
        self.p_regularizer = p_regularizer
        mid = n_input_channel * depth_multiplier
        kw_ = dict(format=format, device=device, dtype=dtype)
        self.depthwise = SpatialConvolution(
            n_input_channel, mid, kw, kh, sw, sh, pw, ph,
            n_group=n_input_channel, with_bias=False,
            w_regularizer=w_regularizer, **kw_)
        self.pointwise = SpatialConvolution(
            mid, n_output_channel, 1, 1, 1, 1, 0, 0, with_bias=has_bias,
            w_regularizer=p_regularizer, b_regularizer=b_regularizer, **kw_)

    def regularized_leaves(self):
        return []               # the halves carry them

    def output_hw(self, h, w):
        return self.pointwise.output_hw(*self.depthwise.output_hw(h, w))

    def forward(self, x):
        return self.pointwise(self.depthwise(x))

    def extra_repr(self):
        return (f"{self.n_input_channel} -> {self.n_output_channel}, "
                f"x{self.depth_multiplier}, {self.kw}x{self.kh}")


# the reference spells it "Seperable" (nn/SpatialSeperableConvolution.scala)
# and keeps that alias
SpatialSeperableConvolution = SpatialSeparableConvolution


class SpatialFullConvolution(Module):
    """Transposed convolution (reference ``nn/SpatialFullConvolution.scala``),
    ``F.conv_transpose2d``: the reference computes it with
    ``lax.conv_general_dilated`` outside any Pallas kernel, and it never
    takes the 3x3 kernels.

    The weight is ``(I, O / n_group, kh, kw)``, as ``F.conv_transpose2d``
    and a Caffe ``Deconvolution`` blob take it. The reference's is ``(kh,
    kw, I / n_group, O)`` and runs forward over the stride-dilated input
    with the flipped kernel; with groups its output block of group ``g`` is
    the last axis's ``g``-th slice, so the two layouts are a permutation of
    5-D views (:meth:`jax_layout`), not of the tensors. ``adj`` adds rows
    and columns after the end (torch's ``output_padding``; where torch
    refuses one as large as the stride, the unpadded result is cut to the
    window instead). ``format`` is "NCHW" or "NHWC"."""

    def __init__(self, n_input_plane, n_output_plane, kw, kh, dw=1, dh=1,
                 pad_w=0, pad_h=0, adj_w=0, adj_h=0, n_group=1,
                 no_bias=False, w_regularizer=None, b_regularizer=None,
                 format="NCHW", init_weight=None, init_bias=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        if format not in ("NCHW", "NHWC"):
            raise ValueError(f"format must be NCHW or NHWC, got {format!r}")
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.kernel_w, self.kernel_h = kw, kh
        self.stride_w, self.stride_h = dw, dh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.adj_w, self.adj_h = adj_w, adj_h
        self.n_group = n_group
        self.format = format
        self.w_regularizer, self.b_regularizer = w_regularizer, b_regularizer
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(
            n_input_plane, n_output_plane // n_group, kh, kw, device=device,
            dtype=dtype))
        if no_bias:
            self.register_parameter("bias", None)
        else:
            self.bias = nn.Parameter(torch.zeros(n_output_plane,
                                                 device=device, dtype=dtype))

    def jax_layout(self, leaf, shape):
        """``(view, perm, reference shape)`` of ``leaf`` (``nn.module.
        jax_layout``): the weight viewed as ``(G, I / G, O / G, kh, kw)``
        and permuted to ``(kh, kw, I / G, G, O / G)``."""
        if leaf != "weight":
            return None
        g = self.n_group
        cin, cout_g, kh, kw = shape
        return ((g, cin // g, cout_g, kh, kw), (3, 4, 1, 0, 2),
                (kh, kw, cin // g, g * cout_g))

    def output_hw(self, h, w):
        return ((h - 1) * self.stride_h - 2 * self.pad_h + self.kernel_h
                + self.adj_h,
                (w - 1) * self.stride_w - 2 * self.pad_w + self.kernel_w
                + self.adj_w)

    def forward(self, x):
        nhwc = self.format == "NHWC"
        xc = x.permute(0, 3, 1, 2) if nhwc else x
        stride = (self.stride_h, self.stride_w)
        if self.adj_h < self.stride_h and self.adj_w < self.stride_w:
            y = F.conv_transpose2d(xc, self.weight, self.bias, stride,
                                   (self.pad_h, self.pad_w),
                                   (self.adj_h, self.adj_w), self.n_group)
        else:
            full = F.conv_transpose2d(xc, self.weight, None, stride, 0, 0,
                                      self.n_group)
            y = F.pad(full, (-self.pad_w, self.adj_w - self.pad_w,
                             -self.pad_h, self.adj_h - self.pad_h))
            if self.bias is not None:
                y = y + self.bias.reshape(1, -1, 1, 1)
        return y.permute(0, 2, 3, 1) if nhwc else y

    def init_arrays(self, rng):
        # Glorot-uniform over one group's fans, drawn in the reference's
        # layout, as its Xavier draws them
        kk = self.kernel_h * self.kernel_w
        g = self.n_group
        bound = np.sqrt(6.0 / (kk * self.n_input_plane // g
                               + kk * self.n_output_plane // g))
        ref = rng.uniform(-bound, bound, (self.kernel_h, self.kernel_w,
                                          self.n_input_plane // g,
                                          self.n_output_plane))
        out = {"weight": from_jax_layout(
            self.jax_layout("weight", tuple(self.weight.shape)),
            tuple(self.weight.shape), ref)}
        if self.bias is not None:
            out["bias"] = np.zeros(self.n_output_plane)
        return out

    def extra_repr(self):
        return (f"{self.n_input_plane} -> {self.n_output_plane}, "
                f"{self.kernel_w}x{self.kernel_h}, "
                f"{self.stride_w},{self.stride_h}, {self.pad_w},{self.pad_h}"
                + (f", adj {self.adj_w},{self.adj_h}"
                   if (self.adj_w, self.adj_h) != (0, 0) else "")
                + (f", groups={self.n_group}" if self.n_group > 1 else ""))


def _xavier(rng, shape, fan_in, fan_out):
    """Glorot-uniform in the reference's layout ``shape`` (its Xavier)."""
    bound = np.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-bound, bound, shape)


class TemporalConvolution(Module):
    """1-D convolution over ``(batch, time, feature)`` (reference
    ``nn/TemporalConvolution.scala``): VALID windows of ``kernel_w``
    frames, ``stride_w`` apart, taps ``dilation`` apart, through
    ``F.conv1d`` (the reference's ``lax.conv_general_dilated``, outside
    any Pallas kernel). The weight is ``(out, in, kernel_w)``; the
    reference's is ``(kernel_w, in, out)``."""

    jax_perms = {"weight": (2, 1, 0)}

    def __init__(self, input_frame_size, output_frame_size, kernel_w,
                 stride_w=1, propagate_back=True, w_regularizer=None,
                 b_regularizer=None, init_weight=None, init_bias=None,
                 with_bias=True, dilation=1, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.input_frame_size = input_frame_size
        self.output_frame_size = output_frame_size
        self.kernel_w, self.stride_w = kernel_w, stride_w
        self.dilation = dilation
        self.w_regularizer, self.b_regularizer = w_regularizer, b_regularizer
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(
            output_frame_size, input_frame_size, kernel_w, device=device,
            dtype=dtype))
        if with_bias:
            self.bias = nn.Parameter(torch.zeros(output_frame_size,
                                                 device=device, dtype=dtype))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        y = F.conv1d(x.transpose(1, 2), self.weight, self.bias,
                     self.stride_w, 0, self.dilation)
        return y.transpose(1, 2)

    def init_arrays(self, rng):
        fan_in = self.kernel_w * self.input_frame_size
        ref = _xavier(rng, (self.kernel_w, self.input_frame_size,
                            self.output_frame_size), fan_in,
                      self.output_frame_size)
        out = {"weight": ref.transpose(2, 1, 0)}
        if self.bias is not None:
            out["bias"] = np.zeros(self.output_frame_size)
        return out

    def extra_repr(self):
        return (f"{self.input_frame_size} -> {self.output_frame_size}, "
                f"k={self.kernel_w}, s={self.stride_w}, d={self.dilation}")


class VolumetricConvolution(Module):
    """3-D convolution over NCDHW (reference
    ``nn/VolumetricConvolution.scala``) through ``F.conv3d``. The weight
    is OIDHW; the reference's DHWIO. A pad of -1 on any axis means SAME
    on every axis, as the reference reads it. The reference takes
    ``w_regularizer``/``b_regularizer`` and keeps neither: so does this
    layer."""

    jax_perms = {"weight": (2, 3, 4, 1, 0)}

    def __init__(self, n_input_plane, n_output_plane, k_t, k_w, k_h,
                 d_t=1, d_w=1, d_h=1, pad_t=0, pad_w=0, pad_h=0,
                 with_bias=True, format="NCDHW", init_weight=None,
                 init_bias=None, w_regularizer=None, b_regularizer=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.k = (k_t, k_h, k_w)
        self.stride = (d_t, d_h, d_w)
        self.pad = (pad_t, pad_h, pad_w)
        self.format = format
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(
            (n_output_plane, n_input_plane) + self.k, device=device,
            dtype=dtype))
        if with_bias:
            self.bias = nn.Parameter(torch.zeros(n_output_plane,
                                                 device=device, dtype=dtype))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        if any(p == -1 for p in self.pad):
            lo_hi = [same_padding(n, k, s) for n, k, s
                     in zip(x.shape[2:], self.k, self.stride)]
            x = F.pad(x, [v for lo, hi in reversed(lo_hi) for v in (lo, hi)])
            pad = 0
        else:
            pad = self.pad
        return F.conv3d(x, self.weight, self.bias, self.stride, pad)

    def init_arrays(self, rng):
        kk = int(np.prod(self.k))
        ref = _xavier(rng, self.k + (self.n_input_plane, self.n_output_plane),
                      kk * self.n_input_plane, kk * self.n_output_plane)
        out = {"weight": ref.transpose(4, 3, 0, 1, 2)}
        if self.bias is not None:
            out["bias"] = np.zeros(self.n_output_plane)
        return out

    def extra_repr(self):
        return (f"{self.n_input_plane} -> {self.n_output_plane}, "
                f"k={self.k}, s={self.stride}, pad={self.pad}")


class VolumetricFullConvolution(Module):
    """3-D transposed convolution over NCDHW (reference
    ``nn/VolumetricFullConvolution.scala``) through
    ``F.conv_transpose3d``. The weight is ``(I, O, kt, kh, kw)``; the
    reference's is ``(kt, kh, kw, I, O)`` run forward over the
    stride-dilated input with the flipped kernel, the same map. ``adj``
    adds planes after the end (torch's ``output_padding``; where torch
    refuses one as large as the stride, the unpadded result is padded or
    cut to the window instead, as ``SpatialFullConvolution`` does)."""

    jax_perms = {"weight": (2, 3, 4, 0, 1)}

    def __init__(self, n_input_plane, n_output_plane, k_t, k_w, k_h,
                 d_t=1, d_w=1, d_h=1, pad_t=0, pad_w=0, pad_h=0,
                 adj_t=0, adj_w=0, adj_h=0, no_bias=False,
                 w_regularizer=None, b_regularizer=None, init_weight=None,
                 init_bias=None, device=None, dtype=torch.float32):
        super().__init__()
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.k = (k_t, k_h, k_w)
        self.stride = (d_t, d_h, d_w)
        self.pad = (pad_t, pad_h, pad_w)
        self.adj = (adj_t, adj_h, adj_w)
        self.w_regularizer, self.b_regularizer = w_regularizer, b_regularizer
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(
            (n_input_plane, n_output_plane) + self.k, device=device,
            dtype=dtype))
        if no_bias:
            self.register_parameter("bias", None)
        else:
            self.bias = nn.Parameter(torch.zeros(n_output_plane,
                                                 device=device, dtype=dtype))

    def forward(self, x):
        if all(a < s for a, s in zip(self.adj, self.stride)):
            return F.conv_transpose3d(x, self.weight, self.bias, self.stride,
                                      self.pad, self.adj)
        full = F.conv_transpose3d(x, self.weight, None, self.stride)
        cuts = []
        for p, a in reversed(list(zip(self.pad, self.adj))):
            cuts += [-p, a - p]
        y = F.pad(full, cuts)
        if self.bias is not None:
            y = y + self.bias.reshape(1, -1, 1, 1, 1)
        return y

    def init_arrays(self, rng):
        kk = int(np.prod(self.k))
        ref = _xavier(rng, self.k + (self.n_input_plane, self.n_output_plane),
                      kk * self.n_input_plane, kk * self.n_output_plane)
        out = {"weight": ref.transpose(3, 4, 0, 1, 2)}
        if self.bias is not None:
            out["bias"] = np.zeros(self.n_output_plane)
        return out

    def extra_repr(self):
        return (f"{self.n_input_plane} -> {self.n_output_plane}, "
                f"k={self.k}, s={self.stride}, pad={self.pad}, "
                f"adj={self.adj}")
