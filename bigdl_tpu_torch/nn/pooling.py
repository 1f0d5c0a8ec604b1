"""Spatial pooling (the port of ``bigdl_tpu/nn/pooling.py``
``SpatialMaxPooling`` and ``SpatialAveragePooling``).

Windows follow the reference's ``_pool_padding``: SAME for ``pad = -1``,
else ``pad`` before and as much after as the last window needs, which
``ceil_mode`` may make more than ``pad``. An average that counts the
padding divides every window by ``kw * kh``, as the reference's
``reduce_window`` sum does, including a ceil-mode window that runs past
the padded edge. ``format`` is "NCHW" or "NHWC"; an NHWC input is pooled
through its channels-last NCHW view.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Module


def _pool_padding(size, k, s, pad, ceil_mode):
    """(lo, hi) padding for one spatial dim, Torch/BigDL semantics."""
    if pad == -1:  # SAME
        out = math.ceil(size / s)
        total = max((out - 1) * s + k - size, 0)
        return (total // 2, total - total // 2)
    if ceil_mode:
        out = math.ceil((size + 2 * pad - k) / s) + 1
        if (out - 1) * s >= size + pad:
            out -= 1
    else:
        out = math.floor((size + 2 * pad - k) / s) + 1
    hi = max((out - 1) * s + k - size - pad, pad)
    return (pad, hi)


class _Pool2D(Module):
    def __init__(self, kw, kh, dw=None, dh=None, pad_w=0, pad_h=0,
                 format="NCHW"):
        super().__init__()
        self.kw, self.kh = kw, kh
        self.dw = dw if dw is not None else kw
        self.dh = dh if dh is not None else kh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.format = format
        self.ceil_mode = False
        self.global_pooling = False

    def ceil(self):
        self.ceil_mode = True
        return self

    def floor(self):
        self.ceil_mode = False
        return self

    def _axes(self):
        return (1, 2) if self.format == "NHWC" else (2, 3)

    def padding(self, h, w):
        return (_pool_padding(h, self.kh, self.dh, self.pad_h, self.ceil_mode),
                _pool_padding(w, self.kw, self.dw, self.pad_w, self.ceil_mode))

    def output_hw(self, h, w):
        if self.global_pooling:
            return 1, 1
        (t, b), (l, r) = self.padding(h, w)
        return ((h + t + b - self.kh) // self.dh + 1,
                (w + l + r - self.kw) // self.dw + 1)

    def _windows(self, x, pool, fill):
        """``pool(x_nchw, kernel, stride, padding)`` over the reference's
        windows: torch's own symmetric padding where it can take it, else
        an explicit pad with ``fill``."""
        nhwc = self.format == "NHWC"
        xc = x.permute(0, 3, 1, 2) if nhwc else x
        (t, b), (l, r) = self.padding(*xc.shape[2:])
        k, s = (self.kh, self.kw), (self.dh, self.dw)
        if t == b and l == r and 2 * t <= self.kh and 2 * l <= self.kw:
            y = pool(xc, k, s, (t, l))
        else:
            y = pool(F.pad(xc, (l, r, t, b), value=fill), k, s, (0, 0))
        return y.permute(0, 2, 3, 1) if nhwc else y


class SpatialMaxPooling(_Pool2D):
    def __init__(self, kw, kh, dw=None, dh=None, pad_w=0, pad_h=0,
                 global_pooling=False, format="NCHW"):
        super().__init__(kw, kh, dw, dh, pad_w, pad_h, format)
        self.global_pooling = global_pooling

    def forward(self, x):
        if self.global_pooling:
            return torch.amax(x, dim=self._axes(), keepdim=True)
        return self._windows(
            x, lambda v, k, s, p: F.max_pool2d(v, k, s, p), float("-inf"))


class SpatialAveragePooling(_Pool2D):
    """``count_include_pad`` mirrors the reference's Caffe-compatible
    toggle."""

    def __init__(self, kw, kh, dw=None, dh=None, pad_w=0, pad_h=0,
                 global_pooling=False, ceil_mode=False,
                 count_include_pad=True, divide=True, format="NCHW"):
        super().__init__(kw, kh, dw, dh, pad_w, pad_h, format)
        self.ceil_mode = ceil_mode
        self.global_pooling = global_pooling
        self.count_include_pad = count_include_pad
        self.divide = divide

    def _sum(self, x):
        # window sums over the reference's zero-padded windows
        return self._windows(x, lambda v, k, s, p: F.avg_pool2d(
            v, k, s, p, count_include_pad=True, divisor_override=1), 0.0)

    def forward(self, x):
        if self.global_pooling:
            return torch.mean(x, dim=self._axes(), keepdim=True)
        summed = self._sum(x)
        if not self.divide:
            return summed
        if self.count_include_pad:
            return summed / (self.kw * self.kh)
        return summed / self._sum(torch.ones_like(x))


class TemporalMaxPooling(Module):
    """Max over VALID windows of ``k_w`` frames, ``d_w`` apart (default
    ``k_w``), of ``(batch, time, feature)`` (reference
    ``nn/TemporalMaxPooling.scala``)."""

    def __init__(self, k_w, d_w=None):
        super().__init__()
        self.k_w = k_w
        self.d_w = d_w if d_w is not None else k_w

    def forward(self, x):
        return F.max_pool1d(x.transpose(1, 2), self.k_w,
                            self.d_w).transpose(1, 2)


class _Pool3D(Module):
    """NCDHW windows ``k`` = (kt, kh, kw), strides ``s`` (default ``k``)
    and ``pad`` on both sides of each axis, the reference's
    ``reduce_window`` ones: the padding is made explicit with the pool's
    fill, so any pad works (torch's own takes at most half a window)."""

    def __init__(self, k_t, k_w, k_h, d_t=None, d_w=None, d_h=None,
                 pad_t=0, pad_w=0, pad_h=0):
        super().__init__()
        self.k = (k_t, k_h, k_w)
        self.s = (d_t or k_t, d_h or k_h, d_w or k_w)
        self.pad = (pad_t, pad_h, pad_w)

    def _padded(self, x, fill):
        if not any(self.pad):
            return x
        return F.pad(x, [v for p in reversed(self.pad) for v in (p, p)],
                     value=fill)

    def extra_repr(self):
        return f"k={self.k}, s={self.s}, pad={self.pad}"


class VolumetricMaxPooling(_Pool3D):
    """Reference ``nn/VolumetricMaxPooling.scala`` (``_Pool3D``'s
    windows)."""

    def forward(self, x):
        return F.max_pool3d(self._padded(x, float("-inf")), self.k, self.s)


class VolumetricAveragePooling(_Pool3D):
    """Reference ``nn/VolumetricAveragePooling.scala``: each window's sum
    over the zero-padded input divided by ``kt * kh * kw``, or with
    ``count_include_pad=False`` by the count of its input elements."""

    def __init__(self, k_t, k_w, k_h, d_t=None, d_w=None, d_h=None,
                 pad_t=0, pad_w=0, pad_h=0, count_include_pad=True):
        super().__init__(k_t, k_w, k_h, d_t, d_w, d_h, pad_t, pad_w, pad_h)
        self.count_include_pad = count_include_pad

    def _sum(self, x):
        return F.avg_pool3d(self._padded(x, 0.0), self.k, self.s,
                            divisor_override=1)

    def forward(self, x):
        summed = self._sum(x)
        if self.count_include_pad:
            return summed / (self.k[0] * self.k[1] * self.k[2])
        return summed / self._sum(torch.ones_like(x))
