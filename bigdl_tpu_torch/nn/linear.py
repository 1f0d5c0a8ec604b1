"""Linear layer (the port of ``bigdl_tpu/nn/linear.py`` ``Linear``).

The reference stores its weight ``(in, out)`` and computes ``x @ W + b``;
this one keeps torch's ``(out, in)`` layout and ``F.linear``.
``convert.params_from_jax`` transposes the reference's weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.utils.device import resolve_device


class Linear(nn.Module):
    def __init__(self, input_size, output_size, with_bias=True, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.input_size = input_size
        self.output_size = output_size
        self.weight = nn.Parameter(torch.empty(output_size, input_size,
                                               device=device, dtype=dtype))
        if with_bias:
            self.bias = nn.Parameter(torch.zeros(output_size, device=device,
                                                 dtype=dtype))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"{self.input_size} -> {self.output_size}, "
                f"bias={self.bias is not None}")
