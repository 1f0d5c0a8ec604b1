"""Linear layers (the port of ``bigdl_tpu/nn/linear.py``: ``Linear``,
``Cosine``, ``Euclidean`` and ``Bilinear``).

The reference's ``Linear`` stores its weight ``(in, out)`` and computes
``x @ W + b``; the port's keeps torch's ``(out, in)`` layout and
``F.linear``, and ``convert.params_from_jax`` transposes the reference's
weights. The pair layers keep the reference's layouts: ``Cosine``'s
weight ``(out, in)``, ``Euclidean``'s ``(in, out)``, ``Bilinear``'s
``(out, in1, in2)``. ``w_regularizer``/``b_regularizer`` join the training
loss (``nn.module.regularization_loss``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.device import resolve_device


class Linear(Module):
    def __init__(self, input_size, output_size, with_bias=True,
                 w_regularizer=None, b_regularizer=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.input_size = input_size
        self.output_size = output_size
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer
        self.weight = nn.Parameter(torch.empty(output_size, input_size,
                                               device=device, dtype=dtype))
        if with_bias:
            self.bias = nn.Parameter(torch.zeros(output_size, device=device,
                                                 dtype=dtype))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def init_arrays(self, rng):
        bound = 1.0 / np.sqrt(self.input_size)
        out = {"weight": rng.uniform(-bound, bound, (self.input_size,
                                                     self.output_size)).T}
        if self.bias is not None:
            out["bias"] = rng.uniform(-bound, bound, self.output_size)
        return out

    def extra_repr(self):
        return (f"{self.input_size} -> {self.output_size}, "
                f"bias={self.bias is not None}")


def _xavier(rng, shape, fan_in, fan_out):
    bound = np.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-bound, bound, shape)


class Cosine(Module):
    """Cosine similarity to learned templates: ``out[b, j] = cos(x_b,
    w_j)`` for a weight ``(output_size, input_size)``, each norm floored
    at 1e-12 (reference ``nn/Cosine.scala``); Glorot-uniform at first."""

    jax_perms = {"weight": None}

    def __init__(self, input_size, output_size, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.input_size, self.output_size = input_size, output_size
        self.weight = nn.Parameter(torch.empty(output_size, input_size,
                                               device=device, dtype=dtype))

    def forward(self, x):
        xn = x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True),
                                 1e-12)
        w = self.weight
        wn = w / torch.clamp_min(torch.linalg.norm(w, dim=-1, keepdim=True),
                                 1e-12)
        return xn @ wn.T

    def regularized_leaves(self):
        return []

    def init_arrays(self, rng):
        return {"weight": _xavier(rng, (self.output_size, self.input_size),
                                  self.input_size, self.output_size)}

    def extra_repr(self):
        return f"{self.input_size} -> {self.output_size}"


class Euclidean(Module):
    """Euclidean distance to learned centres: ``out[b, j] = sqrt(sum_i
    (x_bi - w_ij)^2 + 1e-12)`` for a weight ``(input_size, output_size)``
    (reference ``nn/Euclidean.scala``); Glorot-uniform at first.
    ``fast_backward`` is kept for the reference's API: autograd gives the
    gradient."""

    jax_perms = {"weight": None}

    def __init__(self, input_size, output_size, fast_backward=True,
                 device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.input_size, self.output_size = input_size, output_size
        self.fast_backward = fast_backward
        self.weight = nn.Parameter(torch.empty(input_size, output_size,
                                               device=device, dtype=dtype))

    def forward(self, x):
        diff = x[..., :, None] - self.weight
        return torch.sqrt((diff * diff).sum(-2) + 1e-12)

    def regularized_leaves(self):
        return []

    def init_arrays(self, rng):
        return {"weight": _xavier(rng, (self.input_size, self.output_size),
                                  self.input_size, self.output_size)}

    def extra_repr(self):
        return f"{self.input_size} -> {self.output_size}"


class Bilinear(Module):
    """Bilinear form of an input pair (a table of x1 (N, in1) and x2 (N,
    in2)): ``out[n, k] = x1_n^T W_k x2_n + b_k``, weight ``(out, in1,
    in2)`` Glorot-uniform over fans ``in1 * in2`` and ``out``, bias 0
    (reference ``nn/Bilinear.scala``)."""

    jax_perms = {"weight": None}

    def __init__(self, input_size1, input_size2, output_size, bias_res=True,
                 w_regularizer=None, b_regularizer=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.input_size1, self.input_size2 = input_size1, input_size2
        self.output_size = output_size
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer
        self.weight = nn.Parameter(torch.empty(
            output_size, input_size1, input_size2, device=device,
            dtype=dtype))
        if bias_res:
            self.bias = nn.Parameter(torch.zeros(output_size, device=device,
                                                 dtype=dtype))
        else:
            self.register_parameter("bias", None)

    def forward(self, *xs):
        from bigdl_tpu_torch.nn.table_ops import _elems
        x1, x2 = _elems(xs)[:2]
        y = torch.einsum("ni,kij,nj->nk", x1, self.weight, x2)
        if self.bias is not None:
            y = y + self.bias
        return y

    def init_arrays(self, rng):
        fan_in = self.input_size1 * self.input_size2
        out = {"weight": _xavier(rng, (self.output_size, self.input_size1,
                                       self.input_size2), fan_in,
                                 self.output_size)}
        if self.bias is not None:
            out["bias"] = np.zeros(self.output_size)
        return out

    def extra_repr(self):
        return (f"{self.input_size1} x {self.input_size2} -> "
                f"{self.output_size}, bias={self.bias is not None}")
