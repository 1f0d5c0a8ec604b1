"""Activations (the port of ``bigdl_tpu/nn/activation.py``: ``ReLU``,
``Tanh``, ``Sigmoid``, ``SoftMax``, ``LogSoftMax``, ``Identity``, ``Abs``,
``Exp``, ``Log``, ``Power``, ``ELU``, ``PReLU``, ``SoftPlus``, ``ReLU6``,
``SoftSign``, ``Square``, ``Sqrt`` and ``Negative``).

``SoftPlus`` is ``logaddexp(beta * x, 0) / beta`` at every ``x``, as
``jax.nn.softplus`` computes it (``F.softplus`` turns linear past a
threshold). ``PReLU`` holds one slope a channel (axis 1), or one shared
slope when ``n_output_plane`` is 0, each 0.25 at first, as the
reference's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.device import resolve_device


class ReLU(Module):
    def __init__(self, ip=False):
        super().__init__()
        self.ip = ip

    def forward(self, x):
        return torch.relu(x)


class ReLU6(Module):
    """``min(max(x, 0), 6)``."""

    def forward(self, x):
        return torch.clamp(x, 0.0, 6.0)


class Tanh(Module):
    def forward(self, x):
        return torch.tanh(x)


class Sigmoid(Module):
    def forward(self, x):
        return torch.sigmoid(x)


class SoftMax(Module):
    """softmax over axis ``pos`` (the last by default)."""

    def __init__(self, pos=-1):
        super().__init__()
        self.pos = pos

    def forward(self, x):
        return F.softmax(x, dim=self.pos)


class LogSoftMax(Module):
    """log-softmax over the last axis."""

    def forward(self, x):
        return F.log_softmax(x, dim=-1)


class Identity(Module):
    def forward(self, x):
        return x


class Abs(Module):
    def forward(self, x):
        return torch.abs(x)


class Exp(Module):
    def forward(self, x):
        return torch.exp(x)


class Log(Module):
    def forward(self, x):
        return torch.log(x)


class Power(Module):
    """``(shift + scale * x) ** power`` (reference ``nn/Power.scala``)."""

    def __init__(self, power, scale=1.0, shift=0.0):
        super().__init__()
        self.power, self.scale, self.shift = power, scale, shift

    def forward(self, x):
        return torch.pow(self.shift + self.scale * x, self.power)

    def extra_repr(self):
        return f"power={self.power}, scale={self.scale}, shift={self.shift}"


class ELU(Module):
    """``x`` above 0, else ``alpha * (exp(x) - 1)``; ``ip`` is accepted for
    the reference's API."""

    def __init__(self, alpha=1.0, ip=False):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.elu(x, self.alpha)


class PReLU(Module):
    """Learnable leak (reference ``nn/PReLU.scala``; see module
    docstring)."""

    def __init__(self, n_output_plane=0, device=None, dtype=torch.float32):
        super().__init__()
        self.n_output_plane = n_output_plane
        self.weight = nn.Parameter(torch.full(
            (max(n_output_plane, 1),), 0.25, device=resolve_device(device),
            dtype=dtype))

    def forward(self, x):
        w = self.weight
        if self.n_output_plane > 0:
            shape = [1] * x.dim()
            shape[1] = self.n_output_plane
            w = w.reshape(shape)
        return torch.where(x > 0, x, w * x)

    def init_arrays(self, rng):
        return {"weight": np.full(max(self.n_output_plane, 1), 0.25)}

    def extra_repr(self):
        return f"{self.n_output_plane}"


class SoftPlus(Module):
    """``log(1 + exp(beta * x)) / beta`` (see module docstring)."""

    def __init__(self, beta=1.0):
        super().__init__()
        self.beta = beta

    def forward(self, x):
        return torch.logaddexp(self.beta * x, torch.zeros_like(x)) / self.beta


class SoftSign(Module):
    """``x / (1 + |x|)``."""

    def forward(self, x):
        return x / (1 + torch.abs(x))


class Square(Module):
    def forward(self, x):
        return torch.square(x)


class Sqrt(Module):
    def forward(self, x):
        return torch.sqrt(x)


class Negative(Module):
    """``-x``; ``inplace`` is accepted for the reference's API (the result
    is a new tensor)."""

    def __init__(self, inplace=False):
        super().__init__()

    def forward(self, x):
        return -x


class Maxout(Module):
    """A linear map to ``output_size * maxout_number`` units, then the max
    over each unit's ``maxout_number`` pieces (reference
    ``nn/Maxout.scala``). The reference holds the map as a ``Linear``
    child whose params are the layer's own; here ``weight`` (out *
    pieces, in) and ``bias`` are the layer's, in ``Linear``'s layout and
    with its initial distribution."""

    def __init__(self, input_size, output_size, maxout_number,
                 with_bias=True, device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.input_size = input_size
        self.output_size = output_size
        self.maxout_number = maxout_number
        width = output_size * maxout_number
        self.weight = nn.Parameter(torch.empty(width, input_size,
                                               device=device, dtype=dtype))
        if with_bias:
            self.bias = nn.Parameter(torch.zeros(width, device=device,
                                                 dtype=dtype))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        y = F.linear(x, self.weight, self.bias)
        return torch.amax(y.reshape(y.shape[:-1] + (self.output_size,
                                                    self.maxout_number)),
                          dim=-1)

    def init_arrays(self, rng):
        bound = 1.0 / np.sqrt(self.input_size)
        width = self.output_size * self.maxout_number
        out = {"weight": rng.uniform(-bound, bound,
                                     (self.input_size, width)).T}
        if self.bias is not None:
            out["bias"] = rng.uniform(-bound, bound, width)
        return out

    def extra_repr(self):
        return (f"{self.input_size} -> {self.output_size} "
                f"x {self.maxout_number}")
