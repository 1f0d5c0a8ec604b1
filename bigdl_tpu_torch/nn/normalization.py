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
  training mode; evaluation normalises with them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.utils.device import resolve_device


class LayerNormalization(nn.Module):
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


class BatchNormalization(nn.Module):
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

    def extra_repr(self):
        return f"{self.n_output}, eps={self.eps}, momentum={self.momentum}"


class SpatialBatchNormalization(BatchNormalization):
    """BN over the channel axis of images (reference
    ``nn/SpatialBatchNormalization.scala``)."""

    def __init__(self, n_output, eps=1e-5, momentum=0.1, affine=True,
                 format="NCHW", device=None, dtype=torch.float32):
        super().__init__(n_output, eps, momentum, affine, device, dtype)
        self.feature_axis = 1 if format == "NCHW" else -1
