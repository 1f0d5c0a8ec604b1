"""2-D convolution (the port of ``bigdl_tpu/nn/conv.py``
``SpatialConvolution``: groups 1, dilation 1).

The weight is OIHW, as torch's ``F.conv2d`` takes it, kept in
``torch.channels_last`` memory order (O, H, W, I): the order the 3x3
kernels read, so neither route copies it. ``convert.py`` turns the
reference's HWIO weights into it. ``format`` is the activations' layout,
"NCHW" or "NHWC"; ``pad = -1`` means SAME, as in the reference.

Routes:

- a 3x3, stride-1, pad-1 (or SAME) convolution goes to
  ``ops.conv3x3.conv3x3``, the hand-written kernels on the card, forward
  and input gradient;
- every other one (the ResNet stem's 7x7, the 1x1s, stride-2 3x3s) is
  ``F.conv2d``, as the reference leaves those to XLA outside any Pallas
  kernel. An NHWC input goes in as the channels-last NCHW view
  ``x.permute(0, 3, 1, 2)``, which cuDNN takes without a copy.
  ``SpatialConvolution.library_calls`` counts these calls by geometry
  (``"3x3/s2"``, ...), so a run can show that no kernel-route convolution
  reached the library.
"""

from __future__ import annotations

import collections

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.ops.conv3x3 import conv3x3
from bigdl_tpu_torch.utils.device import resolve_device


def same_padding(size, k, s):
    """XLA's SAME (lo, hi) padding of one spatial axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class SpatialConvolution(nn.Module):
    """Reference ``nn/SpatialConvolution.scala:54`` (see module
    docstring)."""

    library_calls = collections.Counter()

    def __init__(self, n_input_plane, n_output_plane, kernel_w, kernel_h,
                 stride_w=1, stride_h=1, pad_w=0, pad_h=0, n_group=1,
                 with_bias=True, format="NCHW", dilation_w=1, dilation_h=1,
                 device=None, dtype=torch.float32):
        super().__init__()
        if n_group != 1 or dilation_w != 1 or dilation_h != 1:
            raise NotImplementedError("grouped and dilated convolutions are "
                                      "not ported (ROADMAP A.11)")
        if format not in ("NCHW", "NHWC"):
            raise ValueError(f"format must be NCHW or NHWC, got {format!r}")
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.format = format
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(
            n_output_plane, n_input_plane, kernel_h, kernel_w, device=device,
            dtype=dtype).to(memory_format=torch.channels_last))
        if with_bias:
            self.bias = nn.Parameter(torch.zeros(n_output_plane, device=device,
                                                 dtype=dtype))
        else:
            self.register_parameter("bias", None)

    def padding(self, h, w):
        """((top, bottom), (left, right)) for an h x w input."""
        if self.pad_h == -1 or self.pad_w == -1:
            return (same_padding(h, self.kernel_h, self.stride_h),
                    same_padding(w, self.kernel_w, self.stride_w))
        return (self.pad_h, self.pad_h), (self.pad_w, self.pad_w)

    def output_hw(self, h, w):
        (t, b), (l, r) = self.padding(h, w)
        return ((h + t + b - self.kernel_h) // self.stride_h + 1,
                (w + l + r - self.kernel_w) // self.stride_w + 1)

    def uses_kernel(self, h, w):
        """Does an h x w input take the 3x3 kernels?"""
        return (self.kernel_h == self.kernel_w == 3
                and self.stride_h == self.stride_w == 1
                and self.padding(h, w) == ((1, 1), (1, 1)))

    def forward(self, x):
        nhwc = self.format == "NHWC"
        h, w = x.shape[1:3] if nhwc else x.shape[2:4]
        if self.uses_kernel(h, w):
            y = conv3x3(x if nhwc else x.permute(0, 2, 3, 1), self.weight)
            if not nhwc:
                y = y.permute(0, 3, 1, 2)
        else:
            SpatialConvolution.library_calls[
                f"{self.kernel_h}x{self.kernel_w}/s{self.stride_h}"] += 1
            xc = x.permute(0, 3, 1, 2) if nhwc else x
            (t, b), (l, r) = self.padding(h, w)
            if t == b and l == r:
                pad = (t, l)
            else:
                xc, pad = F.pad(xc, (l, r, t, b)), (0, 0)
            y = F.conv2d(xc, self.weight, None,
                         (self.stride_h, self.stride_w), pad)
            if nhwc:
                y = y.permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.reshape((1, 1, 1, -1) if nhwc else (1, -1, 1, 1))
        return y

    def extra_repr(self):
        return (f"{self.n_input_plane} -> {self.n_output_plane}, "
                f"{self.kernel_w}x{self.kernel_h}, "
                f"{self.stride_w},{self.stride_h}, {self.pad_w},{self.pad_h}, "
                f"{self.format}")
