"""Locally-connected (untied-weight) layers (the port of
``bigdl_tpu/nn/locally_connected.py``, reference
``nn/LocallyConnected1D.scala`` and ``nn/LocallyConnected2D.scala``):
convolutions whose kernel weights differ at every output position.

Both extract every window in one ``unfold`` and contract it with the
per-position weight bank in one ``einsum``, as the reference does with
``lax.conv_general_dilated_patches`` outside any Pallas kernel. The
weights keep the reference's layout, so ``convert`` moves them as they
are: ``weight`` is ``(positions, window, out)`` with the window flattened
``(kernel_w, in)`` in 1-D and ``(in, kernel_h, kernel_w)`` in 2-D, and
``bias`` is ``(positions, out)``. Initial weights are Glorot-uniform over
``(window, out)`` and biases 0, the reference's ``Xavier`` and ``Zeros``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.device import resolve_device


class _Untied(Module):
    def _params(self, positions, window, out, with_bias, device, dtype):
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(positions, window, out,
                                               device=device, dtype=dtype))
        if with_bias:
            self.bias = nn.Parameter(torch.zeros(positions, out,
                                                 device=device, dtype=dtype))
        else:
            self.register_parameter("bias", None)

    def _contract(self, patches):
        y = torch.einsum("blk,lko->blo", patches, self.weight)
        return y + self.bias if self.bias is not None else y

    def init_arrays(self, rng):
        positions, window, out = self.weight.shape
        bound = np.sqrt(6.0 / (window + out))
        arrays = {"weight": rng.uniform(-bound, bound,
                                        (positions, window, out))}
        if self.bias is not None:
            arrays["bias"] = np.zeros((positions, out))
        return arrays


class LocallyConnected1D(_Untied):
    """``(batch, n_input_frame, input_frame_size)`` to ``(batch, L,
    output_frame_size)``, ``L`` the VALID windows of ``kernel_w`` frames
    ``stride_w`` apart."""

    def __init__(self, n_input_frame, input_frame_size, output_frame_size,
                 kernel_w, stride_w=1, with_bias=True, w_regularizer=None,
                 b_regularizer=None, init_weight=None, init_bias=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.n_input_frame = n_input_frame
        self.input_frame_size = input_frame_size
        self.output_frame_size = output_frame_size
        self.kernel_w, self.stride_w = kernel_w, stride_w
        self.w_regularizer, self.b_regularizer = w_regularizer, b_regularizer
        positions = (n_input_frame - kernel_w) // stride_w + 1
        self._params(positions, kernel_w * input_frame_size,
                     output_frame_size, with_bias, device, dtype)

    def forward(self, x):
        # (B, L, C, k) windows, flattened k-major as the weight is
        win = x.unfold(1, self.kernel_w, self.stride_w)
        return self._contract(win.transpose(2, 3).reshape(
            x.shape[0], win.shape[1], -1))

    def extra_repr(self):
        return (f"{self.input_frame_size} -> {self.output_frame_size}, "
                f"k={self.kernel_w}, s={self.stride_w}")


class LocallyConnected2D(_Untied):
    """An ``input_height`` x ``input_width`` image of ``n_input_plane``
    channels ("NCHW", or "NHWC" by ``format``) to ``n_output_plane``
    channels at every window position, each with its own weights."""

    def __init__(self, n_input_plane, input_height, input_width,
                 n_output_plane, kernel_w, kernel_h, stride_w=1, stride_h=1,
                 pad_w=0, pad_h=0, with_bias=True, w_regularizer=None,
                 b_regularizer=None, init_weight=None, init_bias=None,
                 format="NCHW", device=None, dtype=torch.float32):
        super().__init__()
        if format not in ("NCHW", "NHWC"):
            raise ValueError(f"format must be NCHW or NHWC, got {format!r}")
        self.n_input_plane = n_input_plane
        self.input_height, self.input_width = input_height, input_width
        self.n_output_plane = n_output_plane
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.format = format
        self.w_regularizer, self.b_regularizer = w_regularizer, b_regularizer
        oh, ow = self.output_hw(input_height, input_width)
        self._params(oh * ow, n_input_plane * kernel_h * kernel_w,
                     n_output_plane, with_bias, device, dtype)

    def output_hw(self, h, w):
        return ((h + 2 * self.pad_h - self.kernel_h) // self.stride_h + 1,
                (w + 2 * self.pad_w - self.kernel_w) // self.stride_w + 1)

    def forward(self, x):
        nhwc = self.format == "NHWC"
        xc = x.permute(0, 3, 1, 2) if nhwc else x
        oh, ow = self.output_hw(*xc.shape[2:])
        # (B, C * kh * kw, L): the window flattened channel-major
        cols = F.unfold(xc, (self.kernel_h, self.kernel_w),
                        padding=(self.pad_h, self.pad_w),
                        stride=(self.stride_h, self.stride_w))
        y = self._contract(cols.transpose(1, 2)).reshape(
            x.shape[0], oh, ow, self.n_output_plane)
        return y if nhwc else y.permute(0, 3, 1, 2)

    def extra_repr(self):
        return (f"{self.n_input_plane} -> {self.n_output_plane}, "
                f"{self.kernel_w}x{self.kernel_h} on "
                f"{self.input_height}x{self.input_width}, {self.format}")
