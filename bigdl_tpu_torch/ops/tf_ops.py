"""TF-style operation layers (the port of ``bigdl_tpu/ops/tf_ops.py``:
reference ``nn/ops/``, inference ops whose ``Operation`` base has a
throwing backward, used by imported TF graphs and feature-column
pipelines).

Each op is a small torch expression with the reference's arithmetic and
the reference's dtypes: the reference runs JAX without x64, so an int64
input or constant is int32 there, and ``Shape``, ``Rank``, ``ArgMax``,
``ArgMin``, the ``TopK`` indices and ``InvertPermutation`` give int32; an
integer ``Sum`` is int32 (``nn.Sum``); ``Cast`` to a 64-bit type gives
the 32-bit one (:func:`jax_dtype`). A table input is a list, a tuple or a
``utils.table.Table`` (its values in sorted-key order); a table output is
a list. Constants closed over by an op are moved to its input's device
when it runs; ``ConstSource`` and ``RandomUniform``, which take no input,
are made on ``device`` (default the card).

``ResizeBilinear`` is ``jax.image.resize``'s bilinear rule (half-pixel
centres, a triangle kernel widened when downsampling), not
``F.interpolate``'s; ``Dilation2D`` the reference's max-plus unroll with
-inf padding; ``TruncateMod`` of integers is float32, as the reference's
``a - trunc(a / b) * b`` gives it. ``RandomUniform`` draws from the
``generator`` its forward is given (``Graph.forward(..., generator=)``),
else from a generator seeded with the op's seed, so evaluation draws
repeat; the numbers are torch's, not ``jax.random``'s.

The feature-column string ops, ``Substr``, ``DecodeRaw``, ``DecodeImage``
and ``ParseExampleOp`` run on the host, as in the reference (their class
sets ``host_side``): they take numpy object arrays of strings or bytes
and give numpy arrays, which a ``Graph`` hands to the next tensor op as
tensors on its device. ``CategoricalColHashBucket`` hashes with
``zlib.crc32``, so its bucket ids are the reference's bit for bit.

The gradient ops TF writes into a training graph compute what the
reference's ``jax.vjp`` of each forward gives: ``ConvBackpropInput`` of a
2-D 3x3 stride-1 SAME convolution through the flip kernels of
``ops/conv3x3.py`` (``nn.conv.conv2d_input``: once a group for a
depthwise one, as its forward), any other and ``ConvBackpropFilter``
through ``torch.nn.grad``; the pooling, resize, LRN and dilation
gradients as ``torch.autograd.grad`` of the port's own forward.
``ConvBackpropInput`` and ``Dilation2DBackprop`` hold the filter the
loader read (a buffer made on ``device``), as the reference's hold theirs.
``RandomShuffle`` permutes rows with the generator it is given, and is
the identity without one.
"""

from __future__ import annotations

import math
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.device import resolve_device
from bigdl_tpu_torch.utils.table import Table, sorted_items

# numpy dtype -> the torch dtype of the reference's array of it (JAX
# without x64 keeps 32-bit types)
_JAX_DTYPES = {np.dtype(np.float16): torch.float16,
               np.dtype(np.float32): torch.float32,
               np.dtype(np.float64): torch.float32,
               np.dtype(np.int8): torch.int8,
               np.dtype(np.int16): torch.int16,
               np.dtype(np.int32): torch.int32,
               np.dtype(np.int64): torch.int32,
               np.dtype(np.uint8): torch.uint8,
               np.dtype(np.bool_): torch.bool}


def jax_dtype(dtype):
    """The torch dtype the reference gives an array of numpy (or torch)
    ``dtype``: 64-bit types as their 32-bit ones."""
    if isinstance(dtype, torch.dtype):
        return {torch.float64: torch.float32,
                torch.int64: torch.int32}.get(dtype, dtype)
    return _JAX_DTYPES[np.dtype(dtype)]


def as_tensor(a, device=None):
    """The array ``a`` as a tensor of :func:`jax_dtype` on ``device``."""
    a = np.array(a)
    return torch.as_tensor(a, device=device).to(jax_dtype(a.dtype))


def _elems(xs):
    """A table's elements: ``forward(*xs)`` got one list, tuple or Table,
    or the elements themselves."""
    if len(xs) == 1:
        x = xs[0]
        if isinstance(x, Table):
            return [v for _, v in sorted_items(x)]
        if isinstance(x, (list, tuple)):
            return list(x)
    return list(xs)


def _axes(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (tuple, list)):
        return tuple(int(a) for a in axis)
    return (int(axis),)


class Operation(Module):
    """Marker base (reference ``Operation.scala:32``). ``backward`` raises:
    these layers exist for imported inference graphs (autograd still runs
    through the ones that are differentiable)."""

    def backward(self, x, grad_output):
        raise RuntimeError(
            f"{type(self).__name__} is an inference Operation — backward is "
            "not defined (reference Operation.scala:42)")


class _Binary(Operation):
    fn = None

    def forward(self, *xs):
        a, b = _elems(xs)
        return type(self).fn(a, b)


class Greater(_Binary):
    fn = staticmethod(torch.gt)


class GreaterEqual(_Binary):
    fn = staticmethod(torch.ge)


class Less(_Binary):
    fn = staticmethod(torch.lt)


class LessEqual(_Binary):
    fn = staticmethod(torch.le)


class Equal(_Binary):
    fn = staticmethod(torch.eq)


class NotEqual(_Binary):
    fn = staticmethod(torch.ne)


class LogicalAnd(_Binary):
    fn = staticmethod(torch.logical_and)


class LogicalOr(_Binary):
    fn = staticmethod(torch.logical_or)


class LogicalNot(Operation):
    def forward(self, x):
        return torch.logical_not(x)


class Pow(Operation):
    def __init__(self, exponent=None):
        super().__init__()
        self.exponent = exponent

    def forward(self, *xs):
        if self.exponent is not None:
            return torch.pow(xs[0], self.exponent)
        a, b = _elems(xs)
        return torch.pow(a, b)


class Erf(Module):
    """Differentiable (BERT's exact-GELU building block)."""

    def forward(self, x):
        return torch.erf(x)


class Exp(Module):
    def forward(self, x):
        return torch.exp(x)


class Log1p(Module):
    def forward(self, x):
        return torch.log1p(x)


class Floor(Operation):
    def forward(self, x):
        return torch.floor(x)


class Ceil(Operation):
    def forward(self, x):
        return torch.ceil(x)


class Round(Operation):
    """Half to even, as ``jnp.round``."""

    def forward(self, x):
        return torch.round(x)


class Sign(Operation):
    def forward(self, x):
        return torch.sign(x)


class Cast(Operation):
    def __init__(self, dtype):
        super().__init__()
        self.dtype = jax_dtype(dtype)

    def forward(self, x):
        return x.to(self.dtype)


class Rank(Operation):
    def forward(self, x):
        return torch.tensor(x.dim(), dtype=torch.int32, device=x.device)


class _Reduce(Operation):
    def __init__(self, axis=None, keep_dims=False):
        super().__init__()
        self.axis, self.keep_dims = axis, keep_dims

    def forward(self, x):
        axes = _axes(self.axis, x.dim())
        if not axes:
            return self.empty(x)
        return self.reduce(x, axes)


class All(_Reduce):
    def empty(self, x):
        return x.bool()

    def reduce(self, x, axes):
        return torch.all(x.bool(), dim=axes, keepdim=self.keep_dims)


class Any(_Reduce):
    def empty(self, x):
        return x.bool()

    def reduce(self, x, axes):
        return torch.any(x.bool(), dim=axes, keepdim=self.keep_dims)


class Prod(Module):
    def __init__(self, axis=None, keep_dims=False):
        super().__init__()
        self.axis, self.keep_dims = axis, keep_dims

    def forward(self, x):
        dtype = None if x.is_floating_point() else torch.int32
        for a in sorted((a % x.dim() for a in _axes(self.axis, x.dim())),
                        reverse=True):
            x = torch.prod(x, dim=a, keepdim=self.keep_dims, dtype=dtype)
        return x if dtype is None else x.to(dtype)


class ArgMax(Operation):
    def __init__(self, axis=-1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return torch.argmax(x, dim=self.axis).to(torch.int32)


class ArgMin(Operation):
    def __init__(self, axis=-1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return torch.argmin(x, dim=self.axis).to(torch.int32)


def _top_k(x, k):
    """``lax.top_k``: the k largest along the last axis, largest first,
    ties in index order."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


class TopK(Operation):
    """``[values, indices]`` (reference ``nn/ops/TopK.scala``)."""

    def __init__(self, k, sorted=True):
        super().__init__()
        self.k = k

    def forward(self, x):
        v, i = _top_k(x, self.k)
        return [v, i.to(torch.int32)]


class InTopK(Operation):
    def __init__(self, k):
        super().__init__()
        self.k = k

    def forward(self, *xs):
        predictions, targets = _elems(xs)
        _, idx = _top_k(predictions, self.k)
        return torch.any(idx == targets[:, None].long(), dim=-1)


class OneHot(Module):
    """``jax.nn.one_hot`` (float32; an index outside ``[0, depth)`` gives
    a row of ``off_value``) scaled to ``on_value``/``off_value``."""

    def __init__(self, depth, on_value=1.0, off_value=0.0, axis=-1):
        super().__init__()
        self.depth = depth
        self.on_value, self.off_value = on_value, off_value
        self.axis = axis

    def forward(self, x):
        idx = x.to(torch.int32).unsqueeze(-1)
        oh = (idx == torch.arange(self.depth, dtype=torch.int32,
                                  device=x.device)).to(torch.float32)
        oh = oh.movedim(-1, self.axis % oh.dim())
        return oh * (self.on_value - self.off_value) + self.off_value


def _take(table, indices, axis):
    """``jnp.take(table, indices, axis)`` (negative indices wrap)."""
    axis = axis % table.dim()
    idx = indices.long()
    idx = torch.where(idx < 0, idx + table.shape[axis], idx)
    out = torch.index_select(table, axis, idx.reshape(-1))
    return out.reshape(table.shape[:axis] + idx.shape
                       + table.shape[axis + 1:])


class Gather(Module):
    """Rows of ``table`` at integer ``indices``; differentiable in the
    table."""

    def __init__(self, axis=0):
        super().__init__()
        self.axis = axis

    def forward(self, *xs):
        table, indices = _elems(xs)
        return _take(table, indices, self.axis)


class Slice(Module):
    def __init__(self, begin, size):
        super().__init__()
        self.begin, self.size = tuple(begin), tuple(size)

    def forward(self, x):
        for i, (b, s) in enumerate(zip(self.begin, self.size)):
            x = x.narrow(i, b, x.shape[i] - b if s == -1 else s)
        return x


class StridedSlice(Module):
    """Static strided slice (reference ``nn/tf/StrideSlice.scala``); masks
    follow TF for begin/end/shrink_axis."""

    def __init__(self, begin, end, strides=None, begin_mask=0, end_mask=0,
                 shrink_axis_mask=0, new_axis_mask=0, ellipsis_mask=0):
        super().__init__()
        if ellipsis_mask or new_axis_mask:
            raise ValueError("ellipsis/new_axis masks not supported")
        self.begin, self.end = list(begin), list(end)
        self.strides = list(strides) if strides else [1] * len(self.begin)
        self.begin_mask, self.end_mask = begin_mask, end_mask
        self.shrink_axis_mask = shrink_axis_mask

    def forward(self, x):
        out, dim = x, 0
        for i in range(x.dim()):
            if i >= len(self.begin):
                dim += 1
                continue
            if self.shrink_axis_mask & (1 << i):
                out = out.select(dim, int(self.begin[i]))
                continue
            b = None if self.begin_mask & (1 << i) else int(self.begin[i])
            e = None if self.end_mask & (1 << i) else int(self.end[i])
            s = int(self.strides[i])
            if s > 0:
                idx = [slice(None)] * dim + [slice(b, e, s)]
                out = out[tuple(idx)]
            else:   # torch slices take no negative step: pick the rows
                rows = list(range(*slice(b, e, s).indices(out.shape[dim])))
                out = torch.index_select(out, dim, torch.tensor(
                    rows, dtype=torch.long, device=out.device))
            dim += 1
        return out


class ExpandDims(Module):
    def __init__(self, axis):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return torch.unsqueeze(x, self.axis)


class Tile(Module):
    def __init__(self, multiples):
        super().__init__()
        self.multiples = tuple(multiples)

    def forward(self, x):
        return torch.tile(x, self.multiples)


def _segment_sum(data, ids, num_segments):
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    keep = (ids >= 0) & (ids < num_segments)
    return out.index_add(0, ids[keep].long(), data[keep])


class SegmentSum(Module):
    """(reference ``nn/ops/SegmentSum.scala``) ``[data, segment_ids]``;
    ``num_segments`` rows out."""

    def __init__(self, num_segments):
        super().__init__()
        self.num_segments = num_segments

    def forward(self, *xs):
        data, seg = _elems(xs)
        return _segment_sum(data, seg, self.num_segments)


# ------------------------------------------------------ feature-column ops

def _objects(x):
    """``x`` (an array, a list or a tensor) as a numpy object array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=object)


class CategoricalColHashBucket(Operation):
    """String column -> hashed bucket ids, int32 (reference
    ``nn/ops/CategoricalColHashBucket.scala``), on the host."""

    host_side = True

    def __init__(self, hash_bucket_size):
        super().__init__()
        self.hash_bucket_size = hash_bucket_size

    def forward(self, x):
        arr = _objects(x)
        ids = [zlib.crc32(s.encode() if isinstance(s, str) else bytes(s))
               % self.hash_bucket_size for s in arr.ravel()]
        return np.asarray(ids, np.int32).reshape(arr.shape)


class BucketizedCol(Operation):
    """Numeric column -> bucket index by ``boundaries``, int32 (reference
    ``nn/ops/BucketizedCol.scala``)."""

    def __init__(self, boundaries):
        super().__init__()
        self.boundaries = np.asarray(boundaries)

    def forward(self, x):
        b = as_tensor(self.boundaries, x.device)
        dtype = torch.promote_types(b.dtype, x.dtype)
        return torch.searchsorted(b.to(dtype), x.to(dtype).contiguous(),
                                  right=True).to(torch.int32)


class IndicatorCol(Operation):
    """Category ids -> multi-hot indicator, float32 (reference
    ``nn/ops/IndicatorCol.scala``): one-hot rows, their maximum over the
    next-to-last axis when there are more than two axes."""

    def __init__(self, feat_len):
        super().__init__()
        self.feat_len = feat_len

    def forward(self, x):
        oh = (x.to(torch.int32).unsqueeze(-1) == torch.arange(
            self.feat_len, dtype=torch.int32, device=x.device)) \
            .to(torch.float32)
        return torch.amax(oh, dim=-2) if oh.dim() > 2 else oh


class CrossCol(Operation):
    """Several integer columns crossed into one hashed id space (reference
    ``nn/ops/CrossCol.scala``): the reference's uint32 multiplicative mix,
    modulo ``hash_bucket_size``, int32."""

    def __init__(self, hash_bucket_size):
        super().__init__()
        self.hash_bucket_size = hash_bucket_size

    def forward(self, *xs):
        cols = [c.to(torch.int64) & 0xFFFFFFFF for c in _elems(xs)]
        mixed = cols[0]
        for c in cols[1:]:
            mixed = ((mixed * 1000003) & 0xFFFFFFFF) ^ c
        return (mixed % self.hash_bucket_size).to(torch.int32)


class CategoricalColVocaList(Operation):
    """String column -> ids by a vocabulary list, a ``SparseTensor`` of
    (rows, columns), on the host (reference
    ``nn/ops/CategoricalColVocaList.scala:40``). A cell may hold several
    values joined by ``str_delimiter``. Out of the vocabulary a value is
    dropped, or mapped to ``len(vocabulary)`` with ``is_set_default``, or
    hashed (``zlib.crc32``) into ``num_oov_buckets`` ids after the
    vocabulary's, as the reference's."""

    host_side = True

    def __init__(self, vocabulary, str_delimiter=",", is_set_default=False,
                 num_oov_buckets=0):
        super().__init__()
        if num_oov_buckets < 0:
            raise ValueError("num_oov_buckets is a negative integer")
        if is_set_default and num_oov_buckets != 0:
            raise ValueError(
                "default value and num_oov_buckets are both specified")
        if not len(vocabulary):
            raise ValueError("the vocabulary list is empty")
        if len(set(vocabulary)) != len(vocabulary):
            raise ValueError("the vocabulary list contains duplicate keys")
        self.vocabulary = list(vocabulary)
        self.str_delimiter = str_delimiter
        self.is_set_default = is_set_default
        self.num_oov_buckets = num_oov_buckets
        self._voca_map = {v: i for i, v in enumerate(self.vocabulary)}

    def forward(self, x):
        from bigdl_tpu_torch.nn.sparse import SparseTensor
        arr = _objects(x).ravel()
        n_voca = len(self.vocabulary)
        if self.num_oov_buckets:
            cols = n_voca + self.num_oov_buckets
        else:
            cols = n_voca + 1 if self.is_set_default else n_voca
        rows_idx, cols_idx, values = [], [], []
        for i, cell in enumerate(arr):
            feats = str(cell).split(self.str_delimiter)
            if not self.is_set_default and self.num_oov_buckets == 0:
                feats = [f for f in feats if f in self._voca_map]
            for j, f in enumerate(feats):
                if f in self._voca_map:
                    v = self._voca_map[f]
                elif self.num_oov_buckets:
                    v = zlib.crc32(f.encode()) % self.num_oov_buckets \
                        + n_voca
                else:
                    v = n_voca   # is_set_default
                rows_idx.append(i)
                cols_idx.append(j)
                values.append(v)
        indices = (np.stack([np.asarray(rows_idx, np.int32),
                             np.asarray(cols_idx, np.int32)], axis=1)
                   if values else np.zeros((0, 2), np.int32))
        return SparseTensor(indices, np.asarray(values, np.int32),
                            (len(arr), cols))


class MkString(Operation):
    """Each row joined into one string by ``str_delimiter``, a numpy
    object array, on the host (reference ``nn/ops/MkString.scala``)."""

    host_side = True

    def __init__(self, str_delimiter=","):
        super().__init__()
        self.str_delimiter = str_delimiter

    def forward(self, x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return np.asarray([self.str_delimiter.join(str(v) for v in row)
                           for row in np.asarray(x)], dtype=object)


class Kv2Tensor(Operation):
    """``"k:v,k:v"`` string column -> dense float32 rows, on the host
    (reference ``nn/ops/Kv2Tensor.scala``); ``dim <= 0`` takes the largest
    key + 1."""

    host_side = True

    def __init__(self, kv_delimiter=",", item_delimiter=":", dim=-1):
        super().__init__()
        self.kv_delimiter = kv_delimiter
        self.item_delimiter = item_delimiter
        self.dim = dim

    def forward(self, x):
        rows = [r[0] if isinstance(r, (list, np.ndarray)) else r
                for r in _objects(x)]
        parsed = []
        for row in rows:
            kv = {}
            for item in str(row).split(self.kv_delimiter):
                if not item:
                    continue
                k, _, v = item.partition(self.item_delimiter)
                kv[int(k)] = float(v)
            parsed.append(kv)
        dim = self.dim if self.dim > 0 else (
            max((max(kv) for kv in parsed if kv), default=-1) + 1)
        out = np.zeros((len(parsed), dim), np.float32)
        for i, kv in enumerate(parsed):
            for k, v in kv.items():
                if k < dim:
                    out[i, k] = v
        return out


class InvertPermutation(Operation):
    """Permutation vector -> its inverse (reference
    ``utils/tf/loaders/ArrayOps.scala:29``): argsort for a valid
    permutation."""

    def forward(self, x):
        return torch.argsort(x.to(torch.int32)).to(torch.int32)


class Reciprocal(Operation):
    """(reference ``loaders/Reciprocal.scala`` / Inv)"""

    def forward(self, x):
        return 1.0 / x


class Expm1(Operation):
    def forward(self, x):
        return torch.expm1(x)


class Erfc(Operation):
    def forward(self, x):
        return torch.erfc(x)


class IsFinite(Operation):
    def forward(self, x):
        return torch.isfinite(x)


class IsInf(Operation):
    def forward(self, x):
        return torch.isinf(x)


class IsNan(Operation):
    def forward(self, x):
        return torch.isnan(x)


class ZerosLike(Operation):
    def forward(self, x):
        return torch.zeros_like(x)


class OnesLike(Operation):
    def forward(self, x):
        return torch.ones_like(x)


class Shape(Operation):
    """The input's shape as an int32 vector (reference
    ``loaders/Shape.scala``)."""

    def forward(self, x):
        return torch.tensor(tuple(x.shape), dtype=torch.int32,
                            device=x.device)


class L2Loss(Operation):
    """sum(x^2) / 2 (reference ``loaders/L2Loss.scala``)."""

    def forward(self, x):
        return torch.sum(torch.square(x)) / 2.0


class LeakyRelu(Operation):
    def __init__(self, alpha=0.2):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha * x)


class Pack(Operation):
    """Stack the table's tensors along ``axis`` (reference
    ``loaders/Pack.scala``)."""

    def __init__(self, axis=0):
        super().__init__()
        self.axis = axis

    def forward(self, *xs):
        return torch.stack(_elems(xs), dim=self.axis)


class Unpack(Operation):
    """Unstack into a list (reference ``loaders/Unpack.scala``)."""

    def __init__(self, axis=0, num=None):
        super().__init__()
        self.axis = axis
        self.num = num

    def forward(self, x):
        n = self.num if self.num is not None else x.shape[self.axis]
        return [p.squeeze(self.axis)
                for p in _split_even(x, n, self.axis)]


def _split_even(x, n, axis):
    if x.shape[axis] % n:
        raise ValueError("array split does not result in an equal division")
    return list(torch.split(x, x.shape[axis] // n, dim=axis))


class SplitTF(Operation):
    """Even split into a list (reference ``loaders/Split.scala``)."""

    def __init__(self, num_split, axis=0):
        super().__init__()
        self.num_split = num_split
        self.axis = axis

    def forward(self, x):
        return _split_even(x, self.num_split, self.axis)


def _resize_weights(in_size, out_size):
    """``jax.image``'s bilinear weight matrix (in_size, out_size), float32:
    half-pixel sample points, a triangle kernel widened by the
    downsampling factor, each column normalised, samples outside the
    input zeroed."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = ((np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale
              - f32(0.0) * inv_scale - f32(0.5))
    x = (np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None])
         / kernel_scale)
    w = np.maximum(f32(0.0), f32(1.0) - x).astype(f32)
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


class ResizeBilinear(Operation):
    """NHWC bilinear resize (reference ``loaders/ResizeBilinear.scala``;
    module docstring)."""

    def __init__(self, size, align_corners=False):
        super().__init__()
        self.size = tuple(int(s) for s in size)
        self.align_corners = align_corners

    def output_hw(self, h, w):
        return self.size

    def forward(self, x):
        n, ih, iw, c = x.shape
        h, w = self.size
        if not x.is_floating_point():
            x = x.to(torch.float32)
        if not self.align_corners:
            if (ih, iw) == (h, w):
                return x
            wh = torch.from_numpy(_resize_weights(ih, h)).to(x)
            ww = torch.from_numpy(_resize_weights(iw, w)).to(x)
            if ih == h:
                return torch.einsum("nhwc,wW->nhWc", x, ww)
            if iw == w:
                return torch.einsum("nhwc,hH->nHwc", x, wh)
            return torch.einsum("nhwc,hH,wW->nHWc", x, wh, ww)
        # align_corners: sample the exact corner grid
        ys = torch.linspace(0.0, ih - 1.0, h, device=x.device)
        xs = torch.linspace(0.0, iw - 1.0, w, device=x.device)
        y0 = torch.clamp(torch.floor(ys).long(), 0, ih - 1)
        y1 = torch.clamp(y0 + 1, 0, ih - 1)
        x0 = torch.clamp(torch.floor(xs).long(), 0, iw - 1)
        x1 = torch.clamp(x0 + 1, 0, iw - 1)
        wy = (ys - y0).reshape(1, -1, 1, 1).to(x.dtype)
        wx = (xs - x0).reshape(1, 1, -1, 1).to(x.dtype)
        top = x[:, y0][:, :, x0] * (1 - wx) + x[:, y0][:, :, x1] * wx
        bot = x[:, y1][:, :, x0] * (1 - wx) + x[:, y1][:, :, x1] * wx
        return top * (1 - wy) + bot * wy


def _floor_div(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _truncate_div(a, b):
    """``trunc(a / b)`` in ``a``'s dtype, as the reference's."""
    return torch.div(a, b, rounding_mode="trunc").to(a.dtype)


def _truncate_mod(a, b):
    """C-style remainder (the sign of the dividend), TF Mod; float32 for
    integer operands, the dtype of the reference's ``a - trunc(a / b) *
    b``."""
    r = torch.fmod(a, b)
    return r if r.is_floating_point() else r.to(torch.float32)


class FloorDiv(_Binary):
    fn = staticmethod(_floor_div)


class FloorMod(_Binary):
    fn = staticmethod(torch.remainder)


class TruncateDiv(_Binary):
    fn = staticmethod(_truncate_div)


class TruncateMod(_Binary):
    fn = staticmethod(_truncate_mod)


class ApproximateEqual(Operation):
    def __init__(self, tolerance=1e-5):
        super().__init__()
        self.tolerance = tolerance

    def forward(self, *xs):
        a, b = _elems(xs)
        return torch.abs(a - b) < self.tolerance

    # the _Binary surface for the TF loader's const-operand path (TF's
    # default tolerance)
    fn = staticmethod(lambda a, b: torch.abs(a - b) < 1e-5)


class ReduceMax(_Reduce):
    def empty(self, x):
        return x

    def reduce(self, x, axes):
        return torch.amax(x, dim=axes, keepdim=self.keep_dims)


class ReduceMin(_Reduce):
    def empty(self, x):
        return x

    def reduce(self, x, axes):
        return torch.amin(x, dim=axes, keepdim=self.keep_dims)


class Lgamma(Operation):
    def forward(self, x):
        return torch.lgamma(x)


class Digamma(Operation):
    def forward(self, x):
        return torch.digamma(x)


class SegmentSumConst(Operation):
    """Segment sum with constant segment ids closed over, the TF loader's
    form of :class:`SegmentSum` (reference
    ``utils/tf/loaders/SegmentSum.scala``)."""

    def __init__(self, segment_ids):
        super().__init__()
        self.segment_ids = np.asarray(segment_ids, np.int32)
        self.num_segments = int(self.segment_ids.max()) + 1 \
            if self.segment_ids.size else 0

    def forward(self, x):
        ids = torch.as_tensor(self.segment_ids, device=x.device)
        return _segment_sum(x, ids, self.num_segments)


class SoftmaxCrossEntropyWithLogits(Operation):
    """``[logits, labels]`` -> ``[loss (N,), backprop (N, C)]``, both TF
    output ports (reference ``utils/tf/loaders/
    SoftmaxCrossEntropyWithLogits.scala``)."""

    def forward(self, *xs):
        logits, labels = _elems(xs)
        logp = F.log_softmax(logits, dim=-1)
        loss = -torch.sum(labels * logp, dim=-1)
        backprop = F.softmax(logits, dim=-1) - labels
        return [loss, backprop]


def _dilation2d(x, wt, strides, rates, padding, kshape):
    """Max-plus morphological dilation, unrolled over the (kh, kw) taps
    (the reference's)."""
    kh, kw = kshape
    sh, sw = strides
    rh, rw = rates
    eff_h, eff_w = (kh - 1) * rh + 1, (kw - 1) * rw + 1
    n, h, w, c = x.shape
    if padding == "SAME":
        oh, ow = -(-h // sh), -(-w // sw)
        ph = max((oh - 1) * sh + eff_h - h, 0)
        pw = max((ow - 1) * sw + eff_w - w, 0)
        x = F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2),
                  value=-math.inf)
    else:
        oh = (h - eff_h) // sh + 1
        ow = (w - eff_w) // sw + 1
    out = torch.full((n, oh, ow, c), -math.inf, dtype=x.dtype,
                     device=x.device)
    for dy in range(kh):
        for dx in range(kw):
            sl = x[:, dy * rh:dy * rh + (oh - 1) * sh + 1:sh,
                   dx * rw:dx * rw + (ow - 1) * sw + 1:sw, :]
            out = torch.maximum(out, sl + wt[dy, dx])
    return out


class Dilation2D(Operation):
    """Morphological dilation: out = max over the window of (x + w)
    (reference ``utils/tf/loaders/Dilation2D.scala``); NHWC, ``weight``
    (kh, kw, C) a constant."""

    def __init__(self, weight, strides=(1, 1), rates=(1, 1), padding="SAME"):
        super().__init__()
        self.weight = np.asarray(weight)
        self.strides = strides
        self.rates = rates
        self.padding = padding

    def output_hw(self, h, w):
        kh, kw = self.weight.shape[:2]
        (sh, sw), (rh, rw) = self.strides, self.rates
        if self.padding == "SAME":
            return -(-h // sh), -(-w // sw)
        return ((h - (kh - 1) * rh - 1) // sh + 1,
                (w - (kw - 1) * rw - 1) // sw + 1)

    def forward(self, x):
        wt = torch.as_tensor(self.weight, device=x.device).to(x.dtype)
        return _dilation2d(x, wt, self.strides, self.rates, self.padding,
                           self.weight.shape[:2])


# ---------------------------------------------- the gradient ops TF writes
# into a training graph (reference ``utils/tf/loaders/ReluGrad.scala`` ...)

def _vjp(fn, primals, cot):
    """``jax.vjp(fn, *primals)[1](cot)``: ``cot`` pulled back to every
    primal, itself differentiable while autograd records."""
    record = torch.is_grad_enabled()
    with torch.enable_grad():
        ps = [p if record and p.requires_grad
              else p.detach().requires_grad_() for p in primals]
        return torch.autograd.grad(fn(*ps), ps, cot, create_graph=record)


def _same_pads(sizes, ksize, strides, padding):
    """((lo, hi), ...) padding of each spatial axis, XLA's SAME or none."""
    from bigdl_tpu_torch.nn.conv import same_padding
    if padding != "SAME":
        return tuple((0, 0) for _ in sizes)
    return tuple(same_padding(int(s), int(k), int(st))
                 for s, k, st in zip(sizes, ksize, strides))


def _pad_nchw(x, pads, value=0.0):
    """NCHW ``x`` padded by ((top, bottom), (left, right))."""
    (t, b), (l, r) = pads
    if t == b == l == r == 0:
        return x
    return F.pad(x, (l, r, t, b), value=value)


class _GradPair(Operation):
    """Elementwise (grad, ref) -> grad' (TF's argument order per op)."""
    fn = None

    def forward(self, *xs):
        g, r = _elems(xs)
        return type(self).fn(g, r)


class ReluGrad(_GradPair):
    fn = staticmethod(lambda g, x: g * (x > 0).to(g.dtype))


class Relu6Grad(_GradPair):
    fn = staticmethod(lambda g, x: g * ((x > 0) & (x < 6)).to(g.dtype))


class EluGrad(_GradPair):
    # TF order: (gradients, outputs)
    fn = staticmethod(lambda g, y: g * torch.where(y > 0, 1.0, y + 1.0))


class SoftplusGrad(_GradPair):
    fn = staticmethod(lambda g, x: g * torch.sigmoid(x))


class SoftsignGrad(_GradPair):
    fn = staticmethod(lambda g, x: g / torch.square(1.0 + torch.abs(x)))


class SigmoidGrad(_GradPair):
    # TF order: (y, dy)
    fn = staticmethod(lambda y, dy: dy * y * (1.0 - y))


class TanhGrad(_GradPair):
    fn = staticmethod(lambda y, dy: dy * (1.0 - torch.square(y)))


class SqrtGrad(_GradPair):
    fn = staticmethod(lambda y, dy: dy * 0.5 / y)


class RsqrtGrad(_GradPair):
    fn = staticmethod(lambda y, dy: dy * -0.5 * y * y * y)


class ReciprocalGrad(_GradPair):
    fn = staticmethod(lambda y, dy: -dy * y * y)


class BiasAddGrad(Operation):
    """The bias gradient: the sum over every axis but the last."""

    def forward(self, x):
        return torch.sum(x, dim=tuple(range(x.dim() - 1)))


class FusedBatchNormGrad(Operation):
    """``[dy, x, scale, saved_mean, saved_var]`` -> ``[dx, dscale,
    doffset]`` (reference ``utils/tf/loaders/FusedBatchNormGrad.scala``)."""

    def __init__(self, eps=1e-4):
        super().__init__()
        self.eps = eps

    def forward(self, *xs):
        dy, xv, scale, mean, var = _elems(xs)
        axes = tuple(range(xv.dim() - 1))
        n = xv.numel() // xv.shape[-1]
        inv = torch.rsqrt(var + self.eps)
        xc = xv - mean
        dscale = torch.sum(dy * xc * inv, dim=axes)
        doffset = torch.sum(dy, dim=axes)
        dx = scale * inv / n * (
            n * dy - doffset - xc * inv * inv * torch.sum(dy * xc, dim=axes))
        return [dx, dscale, doffset]


class AvgPoolGrad(Operation):
    """``[orig_input_shape, grad]`` -> dx of the NHWC average pool (padding
    not counted, as ``lax.reduce_window``'s), its adjoint at zeros
    (reference ``utils/tf/loaders/AvgPoolGrad.scala``)."""

    def __init__(self, input_shape, ksize, strides, padding):
        super().__init__()
        self.input_shape = tuple(int(s) for s in input_shape)
        self.ksize, self.strides, self.padding = ksize, strides, padding

    def _pool(self, x):
        pads = _same_pads(x.shape[1:3], self.ksize, self.strides,
                          self.padding)
        xc = x.permute(0, 3, 1, 2)
        s = F.avg_pool2d(_pad_nchw(xc, pads), self.ksize, self.strides,
                         divisor_override=1)
        cnt = F.avg_pool2d(_pad_nchw(torch.ones_like(xc), pads), self.ksize,
                           self.strides, divisor_override=1)
        return (s / cnt).permute(0, 2, 3, 1)

    def forward(self, *xs):
        g = _elems(xs)[-1]
        zeros = torch.zeros(self.input_shape, dtype=g.dtype, device=g.device)
        return _vjp(self._pool, (zeros,), g)[0]


class MaxPoolGrad(Operation):
    """``[orig_input, orig_output, grad]`` -> dx of the NHWC max pool at
    ``orig_input`` (reference ``utils/tf/loaders/MaxPoolGrad.scala``);
    a window's gradient goes to its first maximum, as XLA's."""

    def __init__(self, ksize, strides, padding):
        super().__init__()
        self.ksize, self.strides, self.padding = ksize, strides, padding

    def _pool(self, x):
        pads = _same_pads(x.shape[1:3], self.ksize, self.strides,
                          self.padding)
        xc = _pad_nchw(x.permute(0, 3, 1, 2), pads, -math.inf)
        return F.max_pool2d(xc, self.ksize, self.strides).permute(0, 2, 3, 1)

    def forward(self, *xs):
        xv, _, g = _elems(xs)
        return _vjp(self._pool, (xv,), g)[0]


# ---------------------------------------------- TensorArray (the reference's
# static stacked form of ``nn/tf/DataFlowOps.scala:45,176-257``: the "flow"
# value IS the (size, ...) stacked tensor)

def _scalar_index(idx):
    return idx.reshape(1).long()


class TensorArrayWrite(Operation):
    """``[index, value, flow]`` -> ``flow`` with row ``index`` replaced."""

    def forward(self, *xs):
        idx, val, flow = _elems(xs)
        return torch.index_copy(flow, 0, _scalar_index(idx),
                                val.to(flow.dtype).unsqueeze(0))


class TensorArrayRead(Operation):
    """``[index, flow]`` -> ``flow[index]``; or ``flow`` ->
    ``flow[index]`` for a constant ``index``."""

    def __init__(self, index=None):
        super().__init__()
        self.index = index

    def forward(self, *xs):
        if self.index is not None:
            return xs[0][self.index]
        idx, flow = _elems(xs)
        return torch.index_select(flow, 0, _scalar_index(idx)).squeeze(0)


def _is_arange(indices, n):
    return (indices is None or (indices.ndim == 1 and indices.size == n
                                and (indices == np.arange(n)).all()))


class TensorArrayGather(Operation):
    """``flow`` -> ``flow[indices]`` (constant indices; the identity for
    an arange)."""

    def __init__(self, indices=None):
        super().__init__()
        self.indices = None if indices is None else np.asarray(indices)

    def forward(self, flow):
        if _is_arange(self.indices, flow.shape[0]):
            return flow
        return _take(flow, torch.as_tensor(self.indices, device=flow.device),
                     0)


class TensorArrayScatter(Operation):
    """``values`` -> ``flow`` (rows placed at constant ``indices``)."""

    def __init__(self, indices=None):
        super().__init__()
        self.indices = None if indices is None else np.asarray(indices)

    def forward(self, values):
        if _is_arange(self.indices, values.shape[0]):
            return values
        idx = torch.as_tensor(self.indices.reshape(-1), dtype=torch.long,
                              device=values.device)
        return torch.index_copy(torch.zeros_like(values), 0, idx, values)


class TensorArrayConcat(Operation):
    """``flow`` (n, d0, ...) -> (n * d0, ...)."""

    def forward(self, flow):
        return flow.reshape((-1,) + tuple(flow.shape[2:]))


class TensorArraySplit(Operation):
    """``value`` (sum(lengths), ...) -> ``flow`` (n, length, ...), the
    inverse of :class:`TensorArrayConcat` (reference
    ``utils/tf/loaders/DataFlowOps.scala`` ``TensorArraySplitV3``); the
    constant ``lengths`` must all be equal, as the reference's static
    shapes need."""

    def __init__(self, lengths):
        super().__init__()
        self.lengths = np.ravel(np.asarray(lengths)).astype(int)
        if len(set(self.lengths.tolist())) != 1:
            raise ValueError(
                "TensorArraySplit: uneven lengths are unsupported (each "
                "TensorArray element needs the same static shape)")

    def forward(self, value):
        n = len(self.lengths)
        return value.reshape((n, int(self.lengths[0]))
                             + tuple(value.shape[1:]))


class TFConv3D(Module):
    """NDHWC Conv3D with a trainable filter (reference
    ``utils/tf/loaders/Conv3D.scala`` -> VolumetricConvolution). The
    weight is OIDHW, as ``F.conv3d`` takes it (the reference's DHWIO);
    ``padding`` is "SAME" or "VALID", SAME split as XLA splits it."""

    jax_perms = {"weight": (2, 3, 4, 1, 0)}

    def __init__(self, weight_shape, strides, padding, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight_shape = tuple(int(s) for s in weight_shape)
        self.strides = tuple(strides)
        self.padding = padding
        kd, kh, kw, ci, co = self.weight_shape
        self.weight = torch.nn.Parameter(torch.zeros(
            co, ci, kd, kh, kw, device=resolve_device(device), dtype=dtype))

    def forward(self, x):
        from bigdl_tpu_torch.nn.conv import same_padding
        xc = x.permute(0, 4, 1, 2, 3)
        if self.padding == "SAME":
            pads = []
            for size, k, s in reversed(list(zip(xc.shape[2:],
                                                self.weight_shape[:3],
                                                self.strides))):
                pads.extend(same_padding(size, k, s))
            xc = F.pad(xc, pads)
        y = F.conv3d(xc, self.weight.to(x.dtype), None, self.strides)
        return y.permute(0, 2, 3, 4, 1)

    def init_arrays(self, rng):
        kd, kh, kw, ci, co = self.weight_shape
        return {"weight": np.zeros((co, ci, kd, kh, kw))}


class ConstSource(Operation):
    """A node with no input that gives fixed values (one tensor, or a list
    of them), made on ``device``: the TF loader's form of a folded
    multi-port op (``BroadcastGradientArgs``, an integer ``Div`` of two
    constants) when a graph consumes it."""

    is_source = True

    def __init__(self, *values, device=None):
        super().__init__()
        device = resolve_device(device)
        self._n = len(values)
        for i, v in enumerate(values):
            self.register_buffer(f"value{i}", as_tensor(v, device),
                                 persistent=False)

    @property
    def values(self):
        return [getattr(self, f"value{i}") for i in range(self._n)]

    def forward(self, x=None):
        vals = self.values
        return vals[0] if len(vals) == 1 else vals


class RandomUniform(Operation):
    """Uniform draws of ``shape`` in [minval, maxval) (reference
    ``utils/tf/loaders/RandomUniform.scala`` -> ``nn/ops/RandomUniform``),
    a node with no input, made on ``device``; see the module docstring for
    its generator."""

    is_source = True

    def __init__(self, shape, minval=0.0, maxval=1.0, seed=0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.shape = tuple(int(s) for s in shape)
        self.minval, self.maxval = float(minval), float(maxval)
        self.seed = int(seed)
        self.dtype = jax_dtype(dtype)
        self.register_buffer("_anchor", torch.empty(
            0, device=resolve_device(device)), persistent=False)

    def forward(self, x=None, generator=None):
        device = self._anchor.device
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(self.seed)
        u = torch.rand(self.shape, generator=generator, device=device,
                       dtype=self.dtype)
        return u * (self.maxval - self.minval) + self.minval


# ------------------------------------- convolution and other gradient ops

def _torch_filter(w, depthwise):
    """A TF filter (HWIO, or DHWIO) in torch's (O, I / groups, ...) layout;
    a depthwise (kh, kw, C, mult) one as its grouped (C * mult, 1, kh,
    kw)."""
    w = np.asarray(w, np.float32)
    if depthwise:
        kh, kw, cin, mult = w.shape
        w = w.reshape(kh, kw, 1, cin * mult)
    nd = w.ndim - 2
    return np.ascontiguousarray(
        w.transpose((nd + 1, nd) + tuple(range(nd))))


class ConvBackpropInput(Operation):
    """TF ``Conv2DBackpropInput``, ``DepthwiseConv2dNativeBackpropInput``
    and ``Conv3DBackpropInput``: the gradient with respect to the input
    (of ``input_sizes``, NHWC or NDHWC) of the convolution with the
    filter read at load (reference ``utils/tf/loaders/
    Conv2DBackpropInput.scala``). 2-D: ``nn.conv.conv2d_input`` (a 3x3
    stride-1 SAME one on the flip kernels); 3-D: ``torch.nn.grad``."""

    writes_input_grads = True     # models.routes.conv_routes

    @classmethod
    def native_spec(cls):
        """The native format's entry (``utils/serializer.py``): the
        reference keeps the TF filter as ``weight``."""
        from bigdl_tpu_torch.utils.serializer import NativeSpec
        return NativeSpec("bigdl_tpu.ops.tf_ops:ConvBackpropInput", cls,
                          get={"weight": lambda m: m.tf_filter()})

    def tf_filter(self):
        """The filter in TF's layout, as the constructor took it."""
        w = self.weight.detach().cpu().numpy()
        nd = w.ndim - 2
        w = w.transpose(tuple(range(2, nd + 2)) + (1, 0))
        return np.ascontiguousarray(w.reshape(self.weight_shape))

    def __init__(self, input_sizes, weight, strides, padding,
                 depthwise=False, spatial_dims=2, device=None):
        super().__init__()
        self.input_sizes = tuple(int(s) for s in input_sizes)
        self.weight_shape = tuple(np.shape(weight))
        self.strides = tuple(int(s) for s in strides)
        self.padding = padding
        self.depthwise = depthwise
        self.spatial_dims = spatial_dims
        self.groups = self.weight_shape[-2] if depthwise else 1
        self.register_buffer("weight", torch.as_tensor(
            _torch_filter(weight, depthwise), device=resolve_device(device)),
            persistent=False)

    def _pads(self):
        return _same_pads(self.input_sizes[1:-1], self.weight_shape,
                          self.strides, self.padding)

    def uses_kernel(self):
        """Does it run on the flip kernels (``nn.conv.conv2d_input``)?"""
        from bigdl_tpu_torch.nn.conv import takes_kernels
        return self.spatial_dims == 2 and takes_kernels(
            self.weight_shape[:2], self.strides, self._pads())

    def conv_launches(self, h, w, grad):
        """Its flip launches, ``[(cin, cout, width, n)]`` by the gradient's
        channels, once a group (``models.routes.conv_routes``; ``h, w,
        grad`` are the walk's and unused: it knows its sizes); None where
        a 2-D one is one library call, none for a 3-D one."""
        if self.uses_kernel():
            co, ci = self.weight.shape[0] // self.groups, self.weight.shape[1]
            return [(co, ci, self.input_sizes[2], self.groups)]
        return None if self.spatial_dims == 2 else []

    def forward(self, g):
        from bigdl_tpu_torch.nn.conv import conv2d_input
        w = self.weight.to(g.dtype)
        sizes = self.input_sizes[1:-1]
        pads = self._pads()
        if self.spatial_dims == 2:
            return conv2d_input(g, w, sizes, self.strides, pads,
                                self.groups)
        size = (g.shape[0], w.shape[1] * self.groups) + tuple(
            s + lo + hi for s, (lo, hi) in zip(sizes, pads))
        dx = torch.nn.grad.conv3d_input(size, w, g.permute(0, 4, 1, 2, 3),
                                        self.strides, groups=self.groups)
        crop = tuple(slice(lo, lo + s) for s, (lo, _) in zip(sizes, pads))
        return dx[(slice(None), slice(None)) + crop].permute(0, 2, 3, 4, 1)


class ConvBackpropFilter(Operation):
    """``[x, out_backprop]`` -> the filter gradient of TF's convolution,
    in TF's layout (reference ``utils/tf/loaders/
    Conv2DBackpropFilter.scala``): ``torch.nn.grad.conv2d_weight`` or
    ``conv3d_weight``, a library call (the reference has no kernel for
    it)."""

    def __init__(self, filter_sizes, strides, padding, depthwise=False,
                 spatial_dims=2):
        super().__init__()
        self.filter_sizes = tuple(int(s) for s in filter_sizes)
        self.strides = tuple(int(s) for s in strides)
        self.padding = padding
        self.depthwise = depthwise
        self.spatial_dims = spatial_dims

    def forward(self, *xs):
        xv, g = _elems(xs)
        nd = self.spatial_dims
        *ks, cin, cout = self.filter_sizes
        groups = cin if self.depthwise else 1
        shape = ((cin * cout, 1) if self.depthwise else (cout, cin)) \
            + tuple(ks)
        pads = _same_pads(xv.shape[1:-1], ks, self.strides, self.padding)
        perm = (0, nd + 1) + tuple(range(1, nd + 1))
        xc = F.pad(xv.permute(perm),
                   [v for lo_hi in reversed(pads) for v in lo_hi])
        grad_weight = (torch.nn.grad.conv2d_weight if nd == 2
                       else torch.nn.grad.conv3d_weight)
        dw = grad_weight(xc, shape, g.permute(perm), self.strides,
                         groups=groups)
        return dw.permute(tuple(range(2, nd + 2)) + (1, 0)) \
            .reshape(self.filter_sizes)


class RandomShuffle(Operation):
    """Rows permuted along axis 0 by the ``generator`` the forward is
    given (``Graph.forward(..., generator=)``), the identity without one
    (reference ``utils/tf/loaders/RandomShuffle.scala``); torch's
    permutation, not ``jax.random``'s."""

    def forward(self, x, generator=None):
        if generator is None:
            return x
        perm = torch.randperm(x.shape[0], generator=generator,
                              device=generator.device)
        return x[perm.to(x.device)]


class ResizeBilinearGrad(Operation):
    """``[grad, orig_image]`` -> dx of :class:`ResizeBilinear` to the
    gradient's size, its adjoint at zeros (reference
    ``utils/tf/loaders/ResizeBilinearGrad.scala``)."""

    def __init__(self, align_corners=False):
        super().__init__()
        self.align_corners = align_corners

    def forward(self, *xs):
        g, orig = _elems(xs)
        rb = ResizeBilinear(g.shape[1:3], self.align_corners)
        return _vjp(rb, (torch.zeros_like(orig),), g)[0]


class LRNGrad(Operation):
    """``[grads, x, y]`` -> dx of TF's LRN over NHWC at ``x`` (reference
    ``utils/tf/loaders/LRNGrad.scala``), through ``nn.SpatialCrossMapLRN``
    as the loader's ``LRN``."""

    def __init__(self, depth_radius=5, bias=1.0, alpha=1.0, beta=0.5):
        super().__init__()
        self.size = 2 * int(depth_radius) + 1
        self.bias, self.alpha, self.beta = bias, alpha, beta

    def forward(self, *xs):
        from bigdl_tpu_torch.nn.normalization import SpatialCrossMapLRN
        g, xv = _elems(xs)[:2]
        lrn = SpatialCrossMapLRN(self.size, self.alpha * self.size,
                                 self.beta, self.bias, format="NHWC")
        return _vjp(lrn, (xv,), g)[0]


class Dilation2DBackprop(Operation):
    """``[x, grad]`` -> the gradient of :class:`Dilation2D` with respect
    to the input (``wrt="input"``) or the filter read at load
    (``wrt="filter"``), at the actual values (reference
    ``utils/tf/loaders/Dilation2DBackpropInput.scala`` / ``Filter``); the
    filter is a buffer on ``device`` (default the card)."""

    @classmethod
    def native_spec(cls):
        """The native format's entry (``utils/serializer.py``): the filter
        is a buffer here, the reference's ``weight`` attribute."""
        from bigdl_tpu_torch.utils.serializer import NativeSpec
        return NativeSpec("bigdl_tpu.ops.tf_ops:Dilation2DBackprop", cls,
                          get={"weight": lambda m: m.weight.cpu().numpy()})

    def __init__(self, weight, strides, rates, padding, wrt="input",
                 device=None):
        super().__init__()
        self.register_buffer("weight", torch.as_tensor(
            np.array(weight, np.float32), device=resolve_device(device)),
            persistent=False)
        self.strides, self.rates, self.padding = strides, rates, padding
        self.wrt = wrt

    def forward(self, *xs):
        xv, g = _elems(xs)

        def fwd(x, w):
            return _dilation2d(x, w, self.strides, self.rates, self.padding,
                               self.weight.shape[:2])

        dx, dw = _vjp(fwd, (xv, self.weight.to(xv.dtype)), g)
        return dx if self.wrt == "input" else dw


# ---------------------------------------------------- host-side data ops

class Substr(Operation):
    """Byte-string slices ``[pos, pos + length)``, on the host (reference
    ``utils/tf/loaders/Substr.scala``)."""

    host_side = True

    def __init__(self, pos, length):
        super().__init__()
        self.pos, self.length = int(pos), int(length)

    def forward(self, x):
        arr = _objects(x)
        out = np.asarray([bytes(s)[self.pos:self.pos + self.length]
                          for s in arr.ravel()], dtype=object)
        return out.reshape(arr.shape)


class DecodeRaw(Operation):
    """Bytes -> a vector of ``out_type`` per string, in the native byte
    order, on the host (reference ``utils/tf/loaders/DecodeRaw.scala``):
    one string gives its vector, an array of them the stacked rows."""

    host_side = True

    @classmethod
    def native_spec(cls):
        """The native format's entry (``utils/serializer.py``): built from
        ``out_dtype`` and the byte order (a file's type names carry
        none)."""
        from bigdl_tpu_torch.utils.serializer import NativeSpec
        return NativeSpec(
            "bigdl_tpu.ops.tf_ops:DecodeRaw", cls,
            args={"out_type": "out_dtype"},
            get={"little_endian": lambda m: m.wire_dtype.byteorder != ">"},
            build=lambda a, make, at: cls(a["out_dtype"],
                                          a.get("little_endian", True)))

    def __init__(self, out_type, little_endian=True):
        super().__init__()
        self.out_dtype = np.dtype(out_type)
        self.wire_dtype = (self.out_dtype.newbyteorder("<") if little_endian
                           else self.out_dtype.newbyteorder(">"))

    def forward(self, x):
        one = isinstance(x, (bytes, bytearray))
        blobs = [x] if one else list(_objects(x).ravel())
        rows = [np.frombuffer(bytes(b), self.wire_dtype)
                .astype(self.out_dtype) for b in blobs]
        return rows[0] if one else np.stack(rows)


class DecodeImage(Operation):
    """Encoded image bytes -> an HWC uint8 array through PIL, on the host:
    the reference's ``DecodeJpeg``/``DecodePng``/``DecodeGif`` (channels
    0 keeps the image's, 1 grey, 3 RGB, 4 RGBA; ``all_frames`` gives a
    GIF's (frames, H, W, 3) stack). PIL is imported only here."""

    host_side = True

    def __init__(self, channels=0, all_frames=False):
        super().__init__()
        self.channels = int(channels)
        self.all_frames = bool(all_frames)

    def forward(self, x):
        import io

        from PIL import Image
        img = Image.open(io.BytesIO(bytes(x)))
        if self.all_frames:
            from PIL import ImageSequence
            return np.stack([np.asarray(f.convert("RGB"))
                             for f in ImageSequence.Iterator(img)])
        mode = {1: "L", 3: "RGB", 4: "RGBA"}.get(self.channels)
        if mode is not None:
            img = img.convert(mode)
        elif img.mode == "P":
            # a palette image with channels 0: colour samples, as TF
            img = img.convert("RGB")
        arr = np.asarray(img)
        return arr[:, :, None] if arr.ndim == 2 else arr


class ParseExampleOp(Operation):
    """Serialized tf.Examples -> the list of their dense features, on the
    host (reference ``nn/tf/ParsingOps.scala`` ParseExample; decoded by
    ``interop/tf_record.py``): a bytes feature as an object array, a
    numeric one stacked in its ``dense_types`` and ``dense_shapes`` (TF's
    -1 dims inferred). A missing key takes its default, or raises."""

    host_side = True

    def __init__(self, dense_keys, dense_shapes, dense_types,
                 dense_defaults=None):
        super().__init__()
        self.dense_keys = [k.decode() if isinstance(k, bytes) else str(k)
                           for k in dense_keys]
        self.dense_shapes = [tuple(int(d) for d in s) for s in dense_shapes]
        self.dense_types = list(dense_types)
        self.dense_defaults = list(dense_defaults or
                                   [None] * len(self.dense_keys))

    def forward(self, x):
        from bigdl_tpu_torch.interop.tf_record import parse_example
        blobs = ([bytes(x)] if isinstance(x, (bytes, bytearray))
                 else [bytes(b) for b in _objects(x).ravel()])
        cols = {k: [] for k in self.dense_keys}
        for blob in blobs:
            feats = parse_example(blob)
            for k, shape, dt, dflt in zip(self.dense_keys,
                                          self.dense_shapes,
                                          self.dense_types,
                                          self.dense_defaults):
                v = feats.get(k)
                if v is None or (not isinstance(v, list)
                                 and np.asarray(v).size == 0):
                    if dflt is None:
                        raise KeyError(
                            f"ParseExample: missing key {k!r} and no "
                            "default")
                    if any(d < 0 for d in shape):
                        raise ValueError(
                            f"ParseExample: key {k!r} missing and its "
                            f"dense_shape {shape} has unknown (-1) dims — "
                            "a default cannot be broadcast to a partial "
                            "shape")
                    v = np.broadcast_to(np.asarray(dflt, dt), shape)
                if isinstance(v, list):   # a bytes feature
                    cols[k].append(v[0] if len(v) == 1 else v)
                else:
                    cols[k].append(self._fit(np.asarray(v, dt), shape, k))
        return [np.asarray(col, dtype=object)
                if col and isinstance(col[0], (bytes, list))
                else np.stack(col) for col in cols.values()]

    @staticmethod
    def _fit(arr, shape, key):
        """``arr`` in ``shape`` (TF's -1 dims inferred), a mismatch
        raised with the feature's key."""
        try:
            return arr.reshape(shape)
        except ValueError as e:
            raise ValueError(
                f"ParseExample: value of size {arr.size} for {key!r} does "
                f"not fit dense_shape {shape}: {e}") from None
