"""Activations (the port of ``bigdl_tpu/nn/activation.py``: ``ReLU``,
``Tanh``, ``Sigmoid``, ``SoftMax``, ``LogSoftMax``, ``Identity``, ``Abs``,
``Exp``, ``Log``, ``Power``, ``ELU``, ``PReLU``, ``SoftPlus``, ``ReLU6``,
``SoftSign``, ``Square``, ``Sqrt``, ``Negative``, ``Maxout``, ``HardTanh``,
``HardSigmoid``, ``SoftMin``, ``LogSigmoid``, ``GELU``, ``Threshold``,
``RReLU``, ``SReLU``, ``HardShrink``, ``SoftShrink``, ``TanhShrink`` and
``Clamp``: the whole file).

``SoftPlus`` is ``logaddexp(beta * x, 0) / beta`` at every ``x``, as
``jax.nn.softplus`` computes it (``F.softplus`` turns linear past a
threshold). ``PReLU`` holds one slope a channel (axis 1), or one shared
slope when ``n_output_plane`` is 0, each 0.25 at first, as the
reference's. ``GELU`` is ``jax.nn.gelu``'s default, the tanh
approximation. ``RReLU`` draws its slopes from the ``generator`` it is
given in training mode (uniform in ``[lower, upper)``), as the reference
draws them from its step's rng, and uses ``(lower + upper) / 2``
otherwise. ``SReLU`` holds four learnable tensors of ``shape``: ``tl``
(0), ``al`` (0.2), ``tr`` (1) and ``ar`` (1).
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


class HardTanh(Module):
    """``x`` clipped to ``[min_value, max_value]``; ``ip`` is accepted
    for the reference's API."""

    def __init__(self, min_value=-1.0, max_value=1.0, ip=False):
        super().__init__()
        self.min_value, self.max_value = min_value, max_value

    def forward(self, x):
        return torch.clamp(x, self.min_value, self.max_value)


class HardSigmoid(Module):
    """``clip(0.2 * x + 0.5, 0, 1)``."""

    def forward(self, x):
        return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


class SoftMin(Module):
    """softmax of ``-x`` over axis ``pos``."""

    def __init__(self, pos=-1):
        super().__init__()
        self.pos = pos

    def forward(self, x):
        return F.softmax(-x, dim=self.pos)


class LogSigmoid(Module):
    def forward(self, x):
        return F.logsigmoid(x)


class GELU(Module):
    """The tanh approximation, as ``jax.nn.gelu`` computes by default."""

    def forward(self, x):
        return F.gelu(x, approximate="tanh")


class Threshold(Module):
    """``x`` where ``x > th``, else ``v``."""

    def __init__(self, th=1e-6, v=0.0, ip=False):
        super().__init__()
        self.th, self.v = th, v

    def forward(self, x):
        return torch.where(x > self.th, x,
                           torch.full((), self.v, dtype=x.dtype,
                                      device=x.device))


class RReLU(Module):
    """Randomised leaky ReLU (reference ``nn/RReLU.scala``; see module
    docstring)."""

    def __init__(self, lower=1.0 / 8, upper=1.0 / 3, ip=False):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x, generator=None):
        if self.training and generator is not None:
            a = torch.empty_like(x).uniform_(self.lower, self.upper,
                                             generator=generator)
        else:
            a = (self.lower + self.upper) / 2.0
        return torch.where(x >= 0, x, a * x)


class SReLU(Module):
    """S-shaped ReLU (reference ``nn/SReLU.scala``): ``tr + ar * (x -
    tr)`` at or above ``tr``, ``tl + al * (x - tl)`` at or below ``tl``,
    else ``x``; the four tensors of ``shape`` broadcast against the
    input's trailing axes."""

    _INIT = {"tl": 0.0, "al": 0.2, "tr": 1.0, "ar": 1.0}
    jax_perms = {"tl": None, "al": None, "tr": None, "ar": None}

    def __init__(self, shape, device=None, dtype=torch.float32):
        super().__init__()
        self.shape = tuple(shape)
        device = resolve_device(device)
        for name, v in self._INIT.items():
            setattr(self, name, nn.Parameter(torch.full(
                self.shape, v, device=device, dtype=dtype)))

    def forward(self, x):
        tl, al, tr, ar = self.tl, self.al, self.tr, self.ar
        return torch.where(x >= tr, tr + ar * (x - tr),
                           torch.where(x <= tl, tl + al * (x - tl), x))

    def regularized_leaves(self):
        return []

    def init_arrays(self, rng):
        return {k: np.full(self.shape, v) for k, v in self._INIT.items()}

    def extra_repr(self):
        return f"{self.shape}"


class HardShrink(Module):
    """``x`` where ``|x| > lambd``, else 0."""

    def __init__(self, lambd=0.5):
        super().__init__()
        self.lambd = lambd

    def forward(self, x):
        return torch.where(torch.abs(x) > self.lambd, x,
                           torch.zeros((), dtype=x.dtype, device=x.device))


class SoftShrink(Module):
    """``sign(x) * max(|x| - lambd, 0)``."""

    def __init__(self, lambd=0.5):
        super().__init__()
        self.lambd = lambd

    def forward(self, x):
        return torch.sign(x) * torch.clamp_min(torch.abs(x) - self.lambd, 0.0)


class TanhShrink(Module):
    """``x - tanh(x)``."""

    def forward(self, x):
        return x - torch.tanh(x)


class Clamp(Module):
    """``x`` clipped to ``[min_value, max_value]``."""

    def __init__(self, min_value, max_value):
        super().__init__()
        self.min_value, self.max_value = min_value, max_value

    def forward(self, x):
        return torch.clamp(x, self.min_value, self.max_value)
