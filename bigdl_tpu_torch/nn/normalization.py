"""Layer normalization (the port of ``bigdl_tpu/nn/normalization.py``
``LayerNormalization``): ``(x - mean) / sqrt(var + eps) * w + b`` over
the last axis with the biased variance, ``eps = 1e-5``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class LayerNormalization(nn.Module):
    def __init__(self, hidden_size, eps=1e-5, device=None,
                 dtype=torch.float32):
        super().__init__()
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
