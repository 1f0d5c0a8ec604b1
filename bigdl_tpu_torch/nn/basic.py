"""Shape, noise and constant layers (the port of ``bigdl_tpu/nn/basic.py``
``Reshape``, ``View``, ``Flatten``, ``Narrow``, ``Tile``,
``SpatialZeroPadding``, ``Input``, ``Dropout``, ``AddConstant``,
``MulConstant``, ``CAdd``, ``CMul``, ``Scale``, ``Squeeze``, ``Mean`` and
``Sum``).

Axes are 0-based Python axes, as in the reference. ``CAdd`` and ``Scale``
hold parameters of the shape they are given (a Caffe ``Scale`` or ``Bias``
layer's ``(1, C, 1, 1)``), broadcast against the input; their initial
values are the reference's (``Scale`` weight 1 and bias 0, ``CAdd`` bias
0; ``CMul`` weight uniform in +-1/sqrt(its size), as ``Linear``'s). ``Mean``
and ``Sum`` reduce over ``dimension``, an axis or a tuple of them (an
empty tuple reduces nothing), and return the reference's dtypes: an
integer or boolean sum is int32 (JAX without x64), a mean float32.
``Flatten`` remembers the rank of the last input it flattened, which
``interop.save_torch`` writes as a Torch7 ``nn.View``'s ``numInputDims``
(the reference reads it from its build-time input spec).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.device import resolve_device


class Reshape(Module):
    """Reshape to ``size``, keeping the batch axis unless ``batch_mode`` is
    False (reference ``nn/Reshape.scala``)."""

    def __init__(self, size, batch_mode=None):
        super().__init__()
        self.size = tuple(size)
        self.batch_mode = batch_mode

    def forward(self, x):
        if self.batch_mode is False:
            return x.reshape(self.size)
        return x.reshape((x.shape[0],) + self.size)

    def extra_repr(self):
        return f"{self.size}"


class View(Module):
    """Reshape to ``(batch,) + sizes`` (reference ``nn/View.scala``)."""

    def __init__(self, *sizes):
        super().__init__()
        if len(sizes) == 1 and isinstance(sizes[0], (tuple, list)):
            sizes = tuple(sizes[0])
        self.sizes = sizes

    def forward(self, x):
        return x.reshape((x.shape[0],) + tuple(self.sizes))

    def extra_repr(self):
        return f"{self.sizes}"


class Flatten(Module):
    """Every axis but the batch axis flattened into one."""

    def forward(self, x):
        self._input_rank = x.dim() - 1      # per sample, for save_torch
        return x.reshape(x.shape[0], -1)


class Narrow(Module):
    """``[offset, offset + length)`` along ``dim`` (reference
    ``nn/Narrow.scala``); a negative ``length`` counts from the end, -1
    running to the last element."""

    def __init__(self, dim, offset, length):
        super().__init__()
        self.dim, self.offset, self.length = dim, offset, length

    def forward(self, x):
        length = self.length
        if length < 0:
            length = x.shape[self.dim] - self.offset + length + 1
        return x.narrow(self.dim, self.offset, length)

    def extra_repr(self):
        return f"dim={self.dim}, offset={self.offset}, length={self.length}"


class Tile(Module):
    """``copies`` copies of the input along ``dim`` (reference
    ``nn/Tile.scala``)."""

    def __init__(self, dim, copies=2):
        super().__init__()
        self.dim, self.copies = dim, copies

    def forward(self, x):
        reps = [1] * x.dim()
        reps[self.dim] = self.copies
        return x.repeat(*reps)


class SpatialZeroPadding(Module):
    """Zeros around the last two axes of an NCHW input (reference
    ``nn/SpatialZeroPadding.scala``); the right, top and bottom pads
    default to the left one."""

    def __init__(self, pad_left, pad_right=None, pad_top=None,
                 pad_bottom=None):
        super().__init__()
        self.l = pad_left
        self.r = pad_right if pad_right is not None else pad_left
        self.t = pad_top if pad_top is not None else pad_left
        self.b = pad_bottom if pad_bottom is not None else pad_left

    def output_hw(self, h, w):
        return h + self.t + self.b, w + self.l + self.r

    def forward(self, x):
        return F.pad(x, (self.l, self.r, self.t, self.b))

    def extra_repr(self):
        return f"l={self.l}, r={self.r}, t={self.t}, b={self.b}"


class Input(Module):
    """Graph input placeholder (reference ``nn/Input.scala``): the
    identity."""

    def forward(self, x):
        return x


class Dropout(Module):
    """Inverted dropout (reference ``nn/Dropout.scala``): in training mode,
    with a ``generator`` and ``p > 0``, each element is kept with
    probability ``1 - p`` (a uniform draw from ``generator`` below ``1 -
    p``) and, with ``scale``, divided by ``1 - p``; otherwise the identity,
    as the reference is without an rng. The mask is drawn in the input's
    memory order (a channels-last input stays channels-last). ``ip`` is
    accepted for the reference's API; the result is a new tensor."""

    def __init__(self, init_p=0.5, ip=False, scale=True):
        super().__init__()
        self.p = init_p
        self.scale = scale

    def set_p(self, p):
        self.p = p
        return self

    def forward(self, x, generator=None):
        if not self.training or self.p <= 0.0 or generator is None:
            return x
        u = torch.empty_like(x, dtype=torch.float32)
        keep = u.uniform_(generator=generator) < 1.0 - self.p
        y = torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                             device=x.device))
        return y / (1.0 - self.p) if self.scale else y

    def extra_repr(self):
        return f"p={self.p}"


class AddConstant(Module):
    """``x + constant_scalar``; ``ip`` is accepted for the reference's API
    (the result is a new tensor)."""

    def __init__(self, constant_scalar, ip=False):
        super().__init__()
        self.constant = constant_scalar

    def forward(self, x):
        return x + self.constant

    def extra_repr(self):
        return f"{self.constant}"


class MulConstant(Module):
    """``x * scalar``; ``ip`` as in ``AddConstant``."""

    def __init__(self, scalar, ip=False):
        super().__init__()
        self.scalar = scalar

    def forward(self, x):
        return x * self.scalar

    def extra_repr(self):
        return f"{self.scalar}"


class CAdd(Module):
    """A learnable bias of shape ``size``, broadcast against the input
    (reference ``nn/CAdd.scala``)."""

    def __init__(self, size, device=None, dtype=torch.float32):
        super().__init__()
        self.size = tuple(size)
        self.bias = nn.Parameter(torch.zeros(
            self.size, device=resolve_device(device), dtype=dtype))

    def forward(self, x):
        return x + self.bias

    def init_arrays(self, rng):
        return {"bias": np.zeros(self.size)}

    def extra_repr(self):
        return f"{self.size}"


class CMul(Module):
    """A learnable gain of shape ``size``, broadcast against the input
    (reference ``nn/CMul.scala``)."""

    jax_perms = {"weight": None}    # the same shape in both packages

    def __init__(self, size, device=None, dtype=torch.float32):
        super().__init__()
        self.size = tuple(int(s) for s in size)
        self.weight = nn.Parameter(torch.empty(
            self.size, device=resolve_device(device), dtype=dtype))

    def forward(self, x):
        return x * self.weight

    def init_arrays(self, rng):
        bound = 1.0 / np.sqrt(max(int(np.prod(self.size)), 1))
        return {"weight": rng.uniform(-bound, bound, self.size)}

    def extra_repr(self):
        return f"{self.size}"


def _axes(dimension):
    return (tuple(int(d) for d in dimension)
            if isinstance(dimension, (tuple, list)) else (int(dimension),))


class Squeeze(Module):
    """Drop axis ``dim`` (0-based; past the batch axis with
    ``batch_mode``), which must have size 1, or every axis of size 1
    without ``dim`` (reference ``nn/Squeeze.scala``)."""

    def __init__(self, dim=None, batch_mode=False):
        super().__init__()
        self.dim = dim
        self.batch_mode = batch_mode

    def forward(self, x):
        if self.dim is None:
            return x.reshape([s for s in x.shape if s != 1])
        dim = self.dim
        if self.batch_mode and dim >= 0:
            dim += 1
        if x.shape[dim] != 1:
            raise ValueError(f"cannot select an axis to squeeze out which "
                             f"has size not equal to one, got "
                             f"shape={tuple(x.shape)} and dimensions="
                             f"({dim},)")
        return x.squeeze(dim)

    def extra_repr(self):
        return f"dim={self.dim}"


class Mean(Module):
    """Mean over ``dimension`` (module docstring); ``squeeze=False`` keeps
    the reduced axes."""

    def __init__(self, dimension=0, n_input_dims=-1, squeeze=True):
        super().__init__()
        self.dimension, self.squeeze = dimension, squeeze

    def forward(self, x):
        if not x.is_floating_point():
            x = x.to(torch.float32)
        axes = _axes(self.dimension)
        if not axes:
            return x
        return torch.mean(x, dim=axes, keepdim=not self.squeeze)


class Sum(Module):
    """Sum over ``dimension`` (module docstring), the mean with
    ``size_average``; ``squeeze=False`` keeps the reduced axes."""

    def __init__(self, dimension=0, n_input_dims=-1, size_average=False,
                 squeeze=True):
        super().__init__()
        self.dimension, self.size_average, self.squeeze = (
            dimension, size_average, squeeze)

    def forward(self, x):
        if self.size_average:
            return Mean(self.dimension, squeeze=self.squeeze)(x)
        axes = _axes(self.dimension)
        dtype = None if x.is_floating_point() else torch.int32
        if not axes:
            return x if dtype is None else x.to(dtype)
        return torch.sum(x, dim=axes, keepdim=not self.squeeze, dtype=dtype)


class Scale(Module):
    """``x * weight + bias``, both of shape ``size`` (reference
    ``nn/Scale.scala``: ``CMul`` then ``CAdd``)."""

    jax_perms = {"weight": None}    # the same shape in both packages

    def __init__(self, size, device=None, dtype=torch.float32):
        super().__init__()
        self.size = tuple(size)
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.ones(self.size, device=device,
                                              dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(self.size, device=device,
                                             dtype=dtype))

    def forward(self, x):
        return x * self.weight + self.bias

    def init_arrays(self, rng):
        return {"weight": np.ones(self.size), "bias": np.zeros(self.size)}

    def extra_repr(self):
        return f"{self.size}"
