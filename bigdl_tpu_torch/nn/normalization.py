"""Normalization layers (the port of ``bigdl_tpu/nn/normalization.py``).

- ``LayerNormalization``: ``(x - mean) / sqrt(var + eps) * w + b`` over
  the last axis with the biased variance, ``eps = 1e-5``;
- ``BatchNormalization`` (feature axis last) and
  ``SpatialBatchNormalization`` (axis 1 for "NCHW", last for "NHWC"), with
  the reference's arithmetic rather than ``F.batch_norm``'s: training
  statistics in float32 from one pass, ``var = max(E[x^2] - E[x]^2, 0)``,
  mean and variance cast back to the input type; running statistics
  ``(1 - m) * old + m * batch`` with the variance unbiased by
  ``n / (n - 1)``, kept as float32 buffers and updated in place in
  training mode; evaluation normalises with them;
- ``SpatialCrossMapLRN``: ``x * (k + alpha / size * S) ** -beta``, ``S``
  the sum of ``x^2`` over a window of ``size`` channels, zero-padded by
  ``(size - 1) // 2`` before and the rest after, as the reference's
  ``reduce_window`` pads it (``F.local_response_norm`` pads ``size // 2``
  before, which differs for an even ``size``). Plain tensor operations:
  the reference computes it outside any Pallas kernel;
- ``SpatialWithinChannelLRN``: ``x * (1 + alpha * M) ** -beta``, ``M`` the
  mean of ``x^2`` over a ``size`` x ``size`` window of each NCHW channel,
  zero-padded as the cross-map window is (the sum over the window divided
  by ``size^2``, as the reference's ``reduce_window`` then divides);
- ``Normalize``: ``x / (||x||_p + eps)`` over the last axis (the max of
  ``|x|`` for ``p = inf``), and ``NormalizeScale`` (SSD's conv4_3 norm):
  the same over axis 1, times a learned ``scale`` of shape ``size``
  (``(1,)`` by default) that starts at the ``scale`` argument. Both keep
  ``eps`` added to the norm, as the reference does (``F.normalize``
  clamps the norm instead).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.device import resolve_device


class LayerNormalization(Module):
    def __init__(self, hidden_size, eps=1e-5, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.hidden_size = hidden_size
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(hidden_size, device=device,
                                             dtype=dtype))

    def forward(self, x):
        # F.layer_norm normalizes with the biased variance, as the
        # reference's jnp.var does
        return F.layer_norm(x, (self.hidden_size,), self.weight, self.bias,
                            self.eps)


class BatchNormalization(Module):
    """Batch norm over every axis but the feature axis (reference
    ``nn/BatchNormalization.scala:51``; see module docstring)."""

    feature_axis = -1

    def __init__(self, n_output, eps=1e-5, momentum=0.1, affine=True,
                 device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.n_output = n_output
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        if affine:
            self.weight = nn.Parameter(torch.ones(n_output, device=device,
                                                  dtype=dtype))
            self.bias = nn.Parameter(torch.zeros(n_output, device=device,
                                                 dtype=dtype))
        self.register_buffer("running_mean", torch.zeros(
            n_output, device=device, dtype=torch.float32))
        self.register_buffer("running_var", torch.ones(
            n_output, device=device, dtype=torch.float32))

    def forward(self, x):
        ax = self.feature_axis % x.dim()
        axes = [i for i in range(x.dim()) if i != ax]
        bshape = [1] * x.dim()
        bshape[ax] = self.n_output
        if self.training:
            x32 = x.float()
            mean = torch.mean(x32, dim=axes)
            var = torch.clamp_min(torch.mean(torch.square(x32), dim=axes)
                                  - torch.square(mean), 0.0)
            mean, var = mean.to(x.dtype), var.to(x.dtype)
            with torch.no_grad():
                m = self.momentum
                n = x.numel() // self.n_output
                unbiased = var * n / max(n - 1, 1)
                self.running_mean.copy_((1 - m) * self.running_mean
                                        + m * mean)
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps)
        y = (x - mean.reshape(bshape)) * inv.reshape(bshape)
        if self.affine:
            y = y * self.weight.reshape(bshape) + self.bias.reshape(bshape)
        return y

    def init_arrays(self, rng):
        out = {"running_mean": np.zeros(self.n_output),
               "running_var": np.ones(self.n_output)}
        if self.affine:
            out.update(weight=np.ones(self.n_output),
                       bias=np.zeros(self.n_output))
        return out

    def extra_repr(self):
        return f"{self.n_output}, eps={self.eps}, momentum={self.momentum}"


class SpatialBatchNormalization(BatchNormalization):
    """BN over the channel axis of images (reference
    ``nn/SpatialBatchNormalization.scala``)."""

    def __init__(self, n_output, eps=1e-5, momentum=0.1, affine=True,
                 format="NCHW", device=None, dtype=torch.float32):
        super().__init__(n_output, eps, momentum, affine, device, dtype)
        self.feature_axis = 1 if format == "NCHW" else -1


class SpatialCrossMapLRN(Module):
    """Local response normalization across channels (reference
    ``nn/SpatialCrossMapLRN.scala``; see module docstring). ``format`` is
    "NCHW" (channels on axis 1) or "NHWC" (the last axis)."""

    def __init__(self, size=5, alpha=1.0, beta=0.75, k=1.0, format="NCHW"):
        super().__init__()
        if format not in ("NCHW", "NHWC"):
            raise ValueError(f"format must be NCHW or NHWC, got {format!r}")
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.format = format

    def forward(self, x):
        ax = 1 if self.format == "NCHW" else x.dim() - 1
        c = x.shape[ax]
        sq = torch.square(x)
        before = (self.size - 1) // 2
        pad = [0, 0] * (x.dim() - 1 - ax) + [before,
                                             self.size - 1 - before]
        sq = F.pad(sq, pad)
        window = sq.narrow(ax, 0, c)
        for i in range(1, self.size):
            window = window + sq.narrow(ax, i, c)
        return x * torch.pow(self.k + self.alpha / self.size * window,
                             -self.beta)

    def extra_repr(self):
        return (f"size={self.size}, alpha={self.alpha}, beta={self.beta}, "
                f"k={self.k}, {self.format}")


class SpatialWithinChannelLRN(Module):
    """Local response normalization within each channel (reference
    ``nn/SpatialWithinChannelLRN.scala``; see module docstring)."""

    def __init__(self, size=5, alpha=1.0, beta=0.75):
        super().__init__()
        self.size, self.alpha, self.beta = size, alpha, beta

    def forward(self, x):
        before = (self.size - 1) // 2
        after = self.size - 1 - before
        sq = F.pad(torch.square(x), (before, after, before, after))
        window_sum = F.avg_pool2d(sq, self.size, 1, divisor_override=1)
        mean_sq = window_sum / (self.size * self.size)
        return x * torch.pow(1.0 + self.alpha * mean_sq, -self.beta)

    def extra_repr(self):
        return f"size={self.size}, alpha={self.alpha}, beta={self.beta}"


class VolumetricBatchNormalization(BatchNormalization):
    """BN over the channel axis (1) of NCDHW volumes (reference
    ``nn/normalization.py`` ``VolumetricBatchNormalization``)."""

    feature_axis = 1


def _p_norm(x, p, dim):
    return torch.pow(torch.pow(torch.abs(x), p).sum(dim, keepdim=True),
                     1.0 / p)


class Normalize(Module):
    """Lp normalisation over the last axis (module docstring)."""

    def __init__(self, p=2.0, eps=1e-10):
        super().__init__()
        self.p, self.eps = p, eps

    def forward(self, x):
        if self.p == float("inf"):
            norm = torch.abs(x).amax(-1, keepdim=True)
        else:
            norm = _p_norm(x, self.p, -1)
        return x / (norm + self.eps)

    def extra_repr(self):
        return f"p={self.p}, eps={self.eps}"


class NormalizeScale(Module):
    """Lp normalisation over axis 1 times a learned ``scale`` (module
    docstring)."""

    def __init__(self, p=2.0, eps=1e-10, scale=1.0, size=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.p, self.eps, self.scale_init = p, eps, scale
        self.size = None if size is None else tuple(size)
        self.scale = nn.Parameter(torch.full(self.size or (1,), float(scale),
                                             device=device, dtype=dtype))

    def forward(self, x):
        return x / (_p_norm(x, self.p, 1) + self.eps) * self.scale

    def regularized_leaves(self):
        return []

    def init_arrays(self, rng):
        return {"scale": np.full(self.size or (1,), self.scale_init)}

    def extra_repr(self):
        return f"p={self.p}, eps={self.eps}, size={self.size}"
