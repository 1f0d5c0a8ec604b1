"""Shape, noise and constant layers (the port of ``bigdl_tpu/nn/basic.py``
``Reshape``, ``View``, ``Flatten``, ``Narrow``, ``Tile``,
``SpatialZeroPadding``, ``Input``, ``Dropout``, ``AddConstant``,
``MulConstant``, ``CAdd``, ``CMul``, ``Scale``, ``Squeeze``, ``Mean``,
``Sum``, ``Transpose``, ``Unsqueeze``, ``Index``, ``Replicate``,
``Reverse``, ``Contiguous``, ``Padding``, ``SpatialDropout2D``,
``GaussianNoise``, ``GaussianDropout``, ``Max``, ``Min``, ``Add``, ``Mul``,
``Masking``, ``Echo`` and ``ErrorInfo``: the whole file but ``Select``,
which ``ops.control_ops`` ports).

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

The random layers (``Dropout``, ``SpatialDropout2D``, ``GaussianNoise``,
``GaussianDropout``) draw from the ``generator`` their forward is given,
in training mode only, as the reference's draw from the step's rng; with
no generator, or in evaluation mode, they are the identity. ``Max`` and
``Min`` are ``amax``/``amin``: a tie shares its gradient evenly among the
tied elements, as JAX's ``max`` does.
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


class Transpose(Module):
    """Swap each listed pair of axes in turn (reference
    ``nn/Transpose.scala``; Python axes, the batch axis included)."""

    def __init__(self, permutations):
        super().__init__()
        self.permutations = permutations

    def forward(self, x):
        perm = list(range(x.dim()))
        for a, b in self.permutations:
            perm[a], perm[b] = perm[b], perm[a]
        return x.permute(*perm)

    def extra_repr(self):
        return f"{self.permutations}"


class Unsqueeze(Module):
    """A new axis of size 1 at ``pos`` (a Python axis)."""

    def __init__(self, pos, num_input_dims=None):
        super().__init__()
        self.pos = pos

    def forward(self, x):
        return x.unsqueeze(self.pos)


class Index(Module):
    """The table ``[tensor, indices]`` gathered along ``dim`` (reference
    ``nn/Index.scala``): ``tensor.shape[:dim] + indices.shape +
    tensor.shape[dim + 1:]``, as ``jnp.take``."""

    def __init__(self, dim):
        super().__init__()
        self.dim = dim

    def forward(self, *xs):
        from bigdl_tpu_torch.nn.table_ops import _elems
        t, idx = _elems(xs)[:2]
        idx = torch.as_tensor(idx, device=t.device).long()
        dim = self.dim % t.dim()
        out = torch.index_select(t, dim, idx.reshape(-1))
        return out.reshape(t.shape[:dim] + idx.shape + t.shape[dim + 1:])


class Replicate(Module):
    """``n_features`` copies of the input along a new axis ``dim``."""

    def __init__(self, n_features, dim=0):
        super().__init__()
        self.n_features, self.dim = n_features, dim

    def forward(self, x):
        y = x.unsqueeze(self.dim)
        reps = [1] * y.dim()
        reps[self.dim] = self.n_features
        return y.repeat(*reps)


class Reverse(Module):
    """The input reversed along ``dim``."""

    def __init__(self, dim=0):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        return torch.flip(x, (self.dim,))


class Contiguous(Module):
    """The input in contiguous memory."""

    def forward(self, x):
        return x.contiguous()


class Padding(Module):
    """``|pad|`` entries of ``value`` along ``dim``: before the input where
    ``pad`` is negative, after it otherwise (reference
    ``nn/Padding.scala``)."""

    def __init__(self, dim, pad, n_input_dim=None, value=0.0, n_index=1):
        super().__init__()
        self.dim, self.pad, self.value = dim, pad, value

    def forward(self, x):
        widths = (-self.pad, 0) if self.pad < 0 else (0, self.pad)
        y = F.pad(x.movedim(self.dim, -1), widths, value=self.value)
        return y.movedim(-1, self.dim)


def channel_dropout(module, x, shape, generator):
    """``x`` with the entries of a ``shape`` mask (broadcast against it)
    dropped, each kept with probability ``1 - module.p`` (a uniform draw
    from ``generator`` below ``1 - p``) and the rest scaled by ``1 / (1 -
    p)``, in training mode with a generator; else ``x``."""
    p = module.p
    if not module.training or p <= 0.0 or generator is None:
        return x
    keep = torch.empty(shape, dtype=torch.float32, device=x.device) \
        .uniform_(generator=generator) < 1.0 - p
    return torch.where(keep, x / (1.0 - p),
                       torch.zeros((), dtype=x.dtype, device=x.device))


class SpatialDropout2D(Module):
    """Whole channels dropped and the rest scaled by ``1 / (1 - p)``
    (reference ``nn/SpatialDropout2D.scala``); ``format`` "NCHW" or
    "NHWC"."""

    def __init__(self, init_p=0.5, format="NCHW"):
        super().__init__()
        self.p = init_p
        self.format = format

    def forward(self, x, generator=None):
        shape = ((x.shape[0], x.shape[1], 1, 1) if self.format == "NCHW"
                 else (x.shape[0], 1, 1, x.shape[3]))
        return channel_dropout(self, x, shape, generator)


class GaussianNoise(Module):
    """``x + stddev * N(0, 1)`` in training mode."""

    def __init__(self, stddev):
        super().__init__()
        self.stddev = stddev

    def forward(self, x, generator=None):
        if not self.training or generator is None:
            return x
        noise = torch.empty_like(x).normal_(generator=generator)
        return x + self.stddev * noise


class GaussianDropout(Module):
    """``x * (1 + sqrt(rate / (1 - rate)) * N(0, 1))`` in training
    mode."""

    def __init__(self, rate):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator=None):
        if not self.training or generator is None:
            return x
        stddev = (self.rate / (1.0 - self.rate)) ** 0.5
        noise = torch.empty_like(x).normal_(generator=generator)
        return x * (1.0 + stddev * noise)


class Max(Module):
    """The maximum over ``dim`` (see module docstring)."""

    def __init__(self, dim=0, num_input_dims=-1):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        return torch.amax(x, dim=self.dim)


class Min(Module):
    """The minimum over ``dim`` (see module docstring)."""

    def __init__(self, dim=0, num_input_dims=-1):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        return torch.amin(x, dim=self.dim)


class Add(Module):
    """A learnable bias of ``input_size`` (reference ``nn/Add.scala``),
    uniform in +-1/sqrt(input_size) at first."""

    def __init__(self, input_size, device=None, dtype=torch.float32):
        super().__init__()
        self.input_size = input_size
        self.bias = nn.Parameter(torch.empty(
            input_size, device=resolve_device(device), dtype=dtype))

    def forward(self, x):
        return x + self.bias

    def init_arrays(self, rng):
        bound = 1.0 / np.sqrt(self.input_size)
        return {"bias": rng.uniform(-bound, bound, self.input_size)}

    def extra_repr(self):
        return f"{self.input_size}"


class Mul(Module):
    """One learnable gain (reference ``nn/Mul.scala``), uniform in
    [-1, 1) at first."""

    def __init__(self, device=None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            1, device=resolve_device(device), dtype=dtype))

    def forward(self, x):
        return x * self.weight

    def init_arrays(self, rng):
        return {"weight": rng.uniform(-1.0, 1.0, 1)}


class Masking(Module):
    """Every step whose features all equal ``mask_value`` set to 0
    (reference ``nn/Masking.scala``)."""

    def __init__(self, mask_value=0.0):
        super().__init__()
        self.mask_value = mask_value

    def forward(self, x):
        keep = torch.any(x != self.mask_value, dim=-1, keepdim=True)
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                device=x.device))


class Echo(Module):
    """The identity that prints the input's shape (reference
    ``nn/Echo.scala``), as ``jax.debug.print`` prints it."""

    def forward(self, x):
        print(f"Echo: shape={tuple(x.shape)}", flush=True)
        return x


class ErrorInfo(Module):
    """The identity."""

    def forward(self, x):
        return x
