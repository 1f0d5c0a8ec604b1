"""Utility layers (the port of ``bigdl_tpu/nn/misc.py``: every class but
``ResizeBilinear``, which ``ops.tf_ops`` ports).

Tables are Python lists, as in ``nn/table_ops.py``: ``BifurcateSplitTable``
gives ``[left, right]``, ``NarrowTable`` a list (or its one entry), and
the layers that take a table take a list, a tuple, a dict or a
``utils.table.Table`` (read in key order).

``GradientReversal``, ``L1Penalty`` and ``ActivityRegularization`` are the
identity forward and change only the gradient, each a
``torch.autograd.Function`` as the reference's ``custom_vjp``.

The three LeCun normalisations convolve each channel with the normalised
kernel (a 9 x 9 Gaussian by default, ``gaussian_kernel2d``) divided by
the number of planes, sum the planes and divide by the kernel mass inside
the image (the reference's border ``coef`` map). The depthwise
convolution goes through ``nn.conv.conv2d``: a 9 x 9 one is one
``F.conv2d`` call, counted in ``SpatialConvolution.library_calls``; a 3 x
3 kernel takes rows 8-9, once a plane.

``SpatialConvolutionMap`` is a ``SpatialConvolution`` whose OIHW weight is
multiplied by the connection table's (out, in) mask at every forward, so
a 3x3 stride-1 pad-1 map takes rows 8-9 as any convolution does.
``MaskedSelect`` is host-side in the reference (a data-dependent length);
here its forward returns the selected elements on the input's device.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from bigdl_tpu_torch.nn.basic import channel_dropout
from bigdl_tpu_torch.nn.conv import SpatialConvolution, conv2d
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.table_ops import _elems
from bigdl_tpu_torch.utils.device import resolve_device


class BinaryThreshold(Module):
    """1 where ``x > th``, else 0, in float32 (reference
    ``nn/BinaryThreshold.scala``)."""

    def __init__(self, th=1e-6):
        super().__init__()
        self.th = th

    def forward(self, x):
        return (x > self.th).to(torch.float32)

    def extra_repr(self):
        return f"th={self.th}"


class InferReshape(Module):
    """Reshape to ``size``, where 0 copies the input's axis and -1 is
    inferred (reference ``nn/InferReshape.scala``); with ``batch_mode``
    the batch axis is kept and ``size`` indexes the rest."""

    def __init__(self, size, batch_mode=False):
        super().__init__()
        self.size = tuple(size)
        self.batch_mode = batch_mode

    def forward(self, x):
        in_shape = x.shape[1:] if self.batch_mode else x.shape
        dims = tuple(int(in_shape[i]) if d == 0 else int(d)
                     for i, d in enumerate(self.size))
        if self.batch_mode:
            return x.reshape((x.shape[0],) + dims)
        return x.reshape(dims)

    def extra_repr(self):
        return f"{self.size}, batch_mode={self.batch_mode}"


class Highway(Module):
    """``t * g(x @ w_h + b_h) + (1 - t) * x`` with ``t = sigmoid(x @ w_t +
    b_t)`` (reference ``nn/Highway.scala``); ``g`` is ``activation`` (a
    parameter-free layer) or tanh. ``w_t``/``w_h`` are ``(size, size)``
    in the reference's (in, out) layout, Glorot-uniform at first; ``b_t``
    starts at -1, so the layer starts near the identity, and ``b_h`` at
    0."""

    def __init__(self, size, with_bias=True, activation=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.size = int(size)
        self.activation = activation
        d = self.size
        for name in ("w_t", "w_h"):
            setattr(self, name, nn.Parameter(torch.empty(
                d, d, device=device, dtype=dtype)))
        if with_bias:
            self.b_t = nn.Parameter(torch.full((d,), -1.0, device=device,
                                               dtype=dtype))
            self.b_h = nn.Parameter(torch.zeros(d, device=device,
                                                dtype=dtype))
        else:
            self.register_parameter("b_t", None)
            self.register_parameter("b_h", None)

    def forward(self, x):
        t = x @ self.w_t
        h = x @ self.w_h
        if self.b_t is not None:
            t = t + self.b_t
            h = h + self.b_h
        t = torch.sigmoid(t)
        h = self.activation(h) if self.activation is not None \
            else torch.tanh(h)
        return t * h + (1.0 - t) * x

    def regularized_leaves(self):
        return []

    def init_arrays(self, rng):
        d = self.size
        bound = np.sqrt(6.0 / (d + d))
        out = {"w_t": rng.uniform(-bound, bound, (d, d)),
               "w_h": rng.uniform(-bound, bound, (d, d))}
        if self.b_t is not None:
            out.update(b_t=np.full(d, -1.0), b_h=np.zeros(d))
        return out

    def extra_repr(self):
        return f"{self.size}"


class BifurcateSplitTable(Module):
    """``[left, right]``: the input split in half along ``dimension`` (a
    Python axis), the left half ``n // 2`` long (reference
    ``nn/BifurcateSplitTable.scala``)."""

    def __init__(self, dimension):
        super().__init__()
        self.dimension = dimension

    def forward(self, x):
        n = x.shape[self.dimension]
        return list(torch.split(x, [n // 2, n - n // 2], dim=self.dimension))


class NarrowTable(Module):
    """Entries ``[offset, offset + length)`` of a table (0-based), or the
    entry itself where that is one (reference ``nn/NarrowTable.scala``)."""

    def __init__(self, offset, length=1):
        super().__init__()
        self.offset, self.length = offset, length

    def forward(self, *xs):
        elems = _elems(xs)[self.offset:self.offset + self.length]
        return elems[0] if len(elems) == 1 else elems


class CrossProduct(Module):
    """The dot products of every pair ``i < j`` of a table's entries over
    the last axis, as columns in pair order (reference
    ``nn/CrossProduct.scala``)."""

    def __init__(self, num_tensor=None, embedding_size=None):
        super().__init__()
        self.num_tensor = num_tensor

    def forward(self, *xs):
        elems = _elems(xs)
        outs = [torch.sum(elems[i] * elems[j], dim=-1, keepdim=True)
                for i in range(len(elems))
                for j in range(i + 1, len(elems))]
        return torch.cat(outs, dim=-1)


class PairwiseDistance(Module):
    """``(sum |a - b + 1e-12| ^ norm) ^ (1 / norm)`` a row of the table
    ``[a, b]`` (reference ``nn/PairwiseDistance.scala``; ``|a - b| +
    1e-12`` keeps the root differentiable)."""

    def __init__(self, norm=2):
        super().__init__()
        self.norm = norm

    def forward(self, *xs):
        a, b = _elems(xs)[:2]
        d = torch.abs(a - b) + 1e-12
        return torch.pow(torch.sum(torch.pow(d, self.norm), dim=-1),
                         1.0 / self.norm)


class _Reversed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lam):
        ctx.lam = lam
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.lam * g, None


class GradientReversal(Module):
    """The identity forward, the gradient times ``-the_lambda`` (reference
    ``nn/GradientReversal.scala``)."""

    def __init__(self, the_lambda=1.0):
        super().__init__()
        self.the_lambda = the_lambda

    def set_lambda(self, lam):
        self.the_lambda = lam
        return self

    def forward(self, x):
        return _Reversed.apply(x, self.the_lambda)


class _Penalised(torch.autograd.Function):
    """The identity whose gradient adds ``l1 * sign(x) + 2 * l2 * x``."""

    @staticmethod
    def forward(ctx, x, l1, l2):
        ctx.save_for_backward(x)
        ctx.l1, ctx.l2 = l1, l2
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        out = g + ctx.l1 * torch.sign(x)
        if ctx.l2:
            out = out + 2.0 * ctx.l2 * x
        return out, None, None


class L1Penalty(Module):
    """The identity whose gradient adds ``l1weight * sign(x)`` (divided by
    the input's size with ``size_average``; reference
    ``nn/L1Penalty.scala``)."""

    def __init__(self, l1weight, size_average=False, provide_output=True):
        super().__init__()
        self.l1weight = float(l1weight)
        self.size_average = size_average

    def forward(self, x):
        w = self.l1weight / x.numel() if self.size_average else self.l1weight
        return _Penalised.apply(x, w, 0.0)


class ActivityRegularization(Module):
    """The identity whose gradient adds ``l1 * sign(x) + 2 * l2 * x``
    (reference ``nn/ActivityRegularization.scala``)."""

    def __init__(self, l1=0.0, l2=0.0):
        super().__init__()
        self.l1, self.l2 = float(l1), float(l2)

    def forward(self, x):
        return _Penalised.apply(x, self.l1, self.l2)


class GaussianSampler(Module):
    """``mean + exp(log_var / 2) * N(0, 1)`` over the table ``[mean,
    log_var]`` (reference ``nn/GaussianSampler.scala``). The noise comes
    from ``generator``; without one, from a generator seeded 0 on the
    input's device, as the reference takes ``key(0)`` without an rng. It
    samples in evaluation mode too, as the reference does."""

    def forward(self, *xs, generator=None):
        mean, log_var = _elems(xs)[:2]
        if generator is None:
            generator = torch.Generator(mean.device).manual_seed(0)
        eps = torch.empty_like(mean).normal_(generator=generator)
        return mean + torch.exp(0.5 * log_var) * eps


class Cropping3D(Module):
    """NCDHW input with ``(before, after)`` cut from each of the last three
    axes (reference ``nn/Cropping3D.scala``)."""

    def __init__(self, dim1_crop=(1, 1), dim2_crop=(1, 1), dim3_crop=(1, 1)):
        super().__init__()
        self.crops = (tuple(dim1_crop), tuple(dim2_crop), tuple(dim3_crop))

    def forward(self, x):
        sl = [slice(None), slice(None)]
        for (lo, hi), size in zip(self.crops, x.shape[2:]):
            sl.append(slice(lo, size - hi))
        return x[tuple(sl)]


class UpSampling3D(Module):
    """NCDHW input with each of the last three axes' entries repeated
    ``size[i]`` times (reference ``nn/UpSampling3D.scala``)."""

    def __init__(self, size=(2, 2, 2)):
        super().__init__()
        self.size = tuple(size)

    def forward(self, x):
        for ax, s in zip((2, 3, 4), self.size):
            x = torch.repeat_interleave(x, s, dim=ax)
        return x


class SpatialDropout3D(Module):
    """Whole 3-D feature maps of NCDHW input dropped (reference
    ``nn/VolumetricDropout``)."""

    def __init__(self, init_p=0.5):
        super().__init__()
        self.p = init_p

    def forward(self, x, generator=None):
        return channel_dropout(self, x, x.shape[:2] + (1, 1, 1), generator)


def gaussian_kernel2d(size):
    """The reference's normalised ``size`` x ``size`` Gaussian (sigma
    ``size / 4``), float32."""
    ax = np.arange(size) - (size - 1) / 2.0
    sigma = size / 4.0
    g = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float32)


class SpatialSubtractiveNormalization(Module):
    """``x`` less its local weighted mean over every plane, NCHW (module
    docstring; reference ``nn/SpatialSubtractiveNormalization.scala``)."""

    def __init__(self, n_input_plane=1, kernel=None):
        super().__init__()
        self.n_input_plane = n_input_plane
        self.kernel = np.asarray(kernel if kernel is not None
                                 else gaussian_kernel2d(9), np.float32)

    def _local_mean(self, x):
        k = torch.as_tensor(self.kernel, dtype=torch.float32,
                            device=x.device)
        k = k / (k.sum() * self.n_input_plane)
        kh, kw = k.shape
        c = self.n_input_plane
        w = k.to(x.dtype).expand(c, 1, kh, kw).contiguous(
            memory_format=torch.channels_last)
        pad = (((kh - 1) // 2, kh // 2), ((kw - 1) // 2, kw // 2))

        def dconv(v):
            return conv2d(v, w, padding=pad, groups=c)

        mean = torch.sum(dconv(x), dim=1, keepdim=True)
        ones = torch.ones((1,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        coef = torch.sum(dconv(ones), dim=1, keepdim=True)
        return (mean / torch.clamp_min(coef, 1e-8)).expand(x.shape)

    def forward(self, x):
        return x - self._local_mean(x)


class SpatialDivisiveNormalization(SpatialSubtractiveNormalization):
    """``x`` over the larger of its local weighted standard deviation and
    that deviation's mean over the image, a denominator below
    ``threshold`` replaced by ``thresval`` (reference
    ``nn/SpatialDivisiveNormalization.scala``)."""

    def __init__(self, n_input_plane=1, kernel=None, threshold=1e-4,
                 thresval=1e-4):
        super().__init__(n_input_plane, kernel)
        self.threshold, self.thresval = threshold, thresval

    def forward(self, x):
        local_sd = torch.sqrt(torch.clamp_min(self._local_mean(x * x), 0.0))
        mean_sd = torch.mean(local_sd, dim=(2, 3), keepdim=True)
        denom = torch.maximum(local_sd, mean_sd)
        denom = torch.where(denom < self.threshold,
                            torch.full((), self.thresval, dtype=x.dtype,
                                       device=x.device), denom)
        return x / denom


class SpatialContrastiveNormalization(Module):
    """Subtractive, then divisive normalisation (reference
    ``nn/SpatialContrastiveNormalization.scala``)."""

    def __init__(self, n_input_plane=1, kernel=None, threshold=1e-4,
                 thresval=1e-4):
        super().__init__()
        self.sub = SpatialSubtractiveNormalization(n_input_plane, kernel)
        self.div = SpatialDivisiveNormalization(n_input_plane, kernel,
                                                threshold, thresval)

    def forward(self, x):
        return self.div(self.sub(x))


class SpatialConvolutionMap(SpatialConvolution):
    """A convolution with an explicit table of ``(in, out)`` connections
    (reference ``nn/SpatialConvolutionMap.scala``; module docstring),
    NCHW. The weight is drawn uniform in +-1/sqrt(kw * kh * pairs /
    n_out) and masked, the bias uniform in the same range."""

    def __init__(self, conn_table, kw, kh, dw=1, dh=1, pad_w=0, pad_h=0,
                 device=None, dtype=torch.float32):
        table = np.asarray(conn_table, np.int32).reshape(-1, 2)
        n_in = int(table[:, 0].max()) + 1
        n_out = int(table[:, 1].max()) + 1
        super().__init__(n_in, n_out, kw, kh, dw, dh, pad_w, pad_h,
                         device=device, dtype=dtype)
        self.conn_table = table
        self.kw, self.kh, self.dw, self.dh = kw, kh, dw, dh
        self.n_in, self.n_out = n_in, n_out
        mask = torch.zeros(n_out, n_in, dtype=dtype)
        mask[torch.from_numpy(table[:, 1]).long(),
             torch.from_numpy(table[:, 0]).long()] = 1.0
        self.register_buffer("mask", mask.to(self.weight.device)[
            :, :, None, None], persistent=False)

    def forward(self, x):
        h, w = x.shape[2:4]
        y = conv2d(x, self.weight * self.mask, (self.dh, self.dw),
                   self.padding(h, w))
        return y + self.bias.reshape(1, -1, 1, 1)

    def init_arrays(self, rng):
        std = 1.0 / (self.kw * self.kh * len(self.conn_table)
                     / self.n_out) ** 0.5
        hwio = rng.uniform(-std, std, (self.kh, self.kw, self.n_in,
                                       self.n_out))
        mask = self.mask.cpu().numpy()[:, :, 0, 0].T        # (in, out)
        return {"weight": (hwio * mask).transpose(3, 2, 0, 1),
                "bias": rng.uniform(-std, std, self.n_out)}

    def extra_repr(self):
        return (f"{len(self.conn_table)} connections, {self.n_in} -> "
                f"{self.n_out}, {self.kw}x{self.kh}, {self.dw},{self.dh}, "
                f"{self.pad_w},{self.pad_h}")


class MaskedSelect(Module):
    """The elements of ``x`` where ``mask`` is nonzero, in memory order,
    from the table ``[x, mask]`` (module docstring; reference
    ``nn/MaskedSelect.scala``)."""

    def forward(self, *xs):
        x, mask = _elems(xs)[:2]
        mask = torch.as_tensor(mask, device=x.device)
        return x[mask != 0]


class LeakyReLU(Module):
    """``x`` at or above 0, else ``negval * x`` (reference
    ``nn/LeakyReLU.scala``)."""

    def __init__(self, negval=0.01, inplace=False):
        super().__init__()
        self.negval = float(negval)

    def forward(self, x):
        return torch.where(x >= 0, x, self.negval * x)


class Cropping2D(Module):
    """``(top, bottom)`` and ``(left, right)`` cut from the spatial axes of
    NCHW or NHWC input (reference ``nn/Cropping2D.scala``)."""

    def __init__(self, height_crop=(0, 0), width_crop=(0, 0),
                 format="NCHW"):
        super().__init__()
        self.height_crop = tuple(height_crop)
        self.width_crop = tuple(width_crop)
        self.format = format

    def forward(self, x):
        h_ax, w_ax = (2, 3) if self.format == "NCHW" else (1, 2)
        sl = [slice(None)] * 4
        (t, b), (l, r) = self.height_crop, self.width_crop
        sl[h_ax] = slice(t, x.shape[h_ax] - b)
        sl[w_ax] = slice(l, x.shape[w_ax] - r)
        return x[tuple(sl)]


class UpSampling1D(Module):
    """Each step of (B, T, F) input repeated ``length`` times (reference
    ``nn/UpSampling1D.scala``)."""

    def __init__(self, length=2):
        super().__init__()
        self.length = int(length)

    def forward(self, x):
        return torch.repeat_interleave(x, self.length, dim=1)


class UpSampling2D(Module):
    """Each row and column of NCHW or NHWC input repeated ``size`` times
    (reference ``nn/UpSampling2D.scala``)."""

    def __init__(self, size=(2, 2), format="NCHW"):
        super().__init__()
        self.size = tuple(size)
        self.format = format

    def forward(self, x):
        axes = (2, 3) if self.format == "NCHW" else (1, 2)
        for ax, s in zip(axes, self.size):
            x = torch.repeat_interleave(x, s, dim=ax)
        return x


class SpatialDropout1D(Module):
    """Whole feature columns of (B, T, F) input dropped (reference
    ``nn/SpatialDropout1D.scala``)."""

    def __init__(self, init_p=0.5):
        super().__init__()
        self.p = init_p

    def forward(self, x, generator=None):
        return channel_dropout(self, x, (x.shape[0], 1, x.shape[2]),
                                generator)
