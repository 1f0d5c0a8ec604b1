"""Sparse tensors and their layers (the port of ``bigdl_tpu/nn/sparse.py``:
``SparseTensor``, ``dense_to_sparse``, ``DenseToSparse``, ``SparseLinear``
and ``SparseJoinTable``; reference ``tensor/SparseTensor.scala``,
``nn/SparseLinear.scala``, ``nn/SparseJoinTable.scala``,
``nn/DenseToSparse.scala``).

A sparse tensor is the reference's COO triple: ``indices`` (nnz, ndim)
int32, ``values`` (nnz,) and ``dense_shape``, the triple
``CategoricalColVocaList`` gives too. Its number of entries depends on the
data, so ``dense_to_sparse`` (and ``DenseToSparse``) reads the input once
to find them, as the reference's host-side extraction does; the result
lives on the input's device.

``SparseLinear`` is the reference's gather and ``segment_sum``: each entry's
value times its column's weight row, summed into its row with
``index_add`` (no dense (N, in) matrix). On the card ``index_add`` adds
with atomics, so the order of a row's sums, and their last bits, may
differ from run to run. The weight keeps the reference's (in, out) layout,
the rows the gather reads; a dense input is ``x @ weight``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.table_ops import _elems
from bigdl_tpu_torch.utils.device import resolve_device


class SparseTensor:
    """Static-shape COO sparse tensor: ``indices`` (nnz, ndim) int32,
    ``values`` (nnz,), ``dense_shape``."""

    def __init__(self, indices, values, dense_shape):
        self.indices = torch.as_tensor(indices).to(torch.int32)
        self.values = torch.as_tensor(values)
        self.dense_shape = tuple(int(d) for d in dense_shape)

    @property
    def shape(self):
        return self.dense_shape

    def to_dense(self):
        out = torch.zeros(self.dense_shape, dtype=self.values.dtype,
                          device=self.values.device)
        idx = tuple(self.indices[:, i].long()
                    for i in range(self.indices.shape[1]))
        return out.index_put(idx, self.values, accumulate=True)

    def __repr__(self):
        return (f"SparseTensor(nnz={self.values.shape[0]}, "
                f"shape={self.dense_shape})")


def dense_to_sparse(x):
    """The nonzero entries of ``x`` (a tensor, or anything numpy takes) in
    row-major order as a :class:`SparseTensor` on ``x``'s device."""
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x)
    idx = torch.nonzero(x != 0).to(torch.int32)
    vals = x[tuple(idx.long().T)]
    return SparseTensor(idx, vals, x.shape)


class DenseToSparse(Module):
    """:func:`dense_to_sparse` as a layer (reference
    ``nn/DenseToSparse.scala``)."""

    def forward(self, x):
        return dense_to_sparse(x)


class SparseLinear(Module):
    """``y[b] = sum over row b's entries of value * weight[col] (+ bias)``
    over an (N, in) sparse input (module docstring). The weight is (in,
    out), Glorot-uniform at first, the bias 0."""

    jax_perms = {"weight": None}        # the reference's (in, out)

    def __init__(self, input_size, output_size, with_bias=True,
                 init_weight=None, init_bias=None, w_regularizer=None,
                 b_regularizer=None, device=None, dtype=torch.float32):
        super().__init__()
        self.input_size, self.output_size = input_size, output_size
        self.with_bias = with_bias
        self.w_regularizer, self.b_regularizer = w_regularizer, b_regularizer
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(input_size, output_size,
                                               device=device, dtype=dtype))
        if with_bias:
            self.bias = nn.Parameter(torch.zeros(output_size, device=device,
                                                 dtype=dtype))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        if not isinstance(x, SparseTensor):
            y = x @ self.weight
        else:
            rows = x.indices[:, 0].long()
            cols = x.indices[:, 1].long()
            contrib = x.values[:, None].to(self.weight.dtype) \
                * self.weight.index_select(0, cols)
            y = torch.zeros(x.dense_shape[0], self.output_size,
                            dtype=contrib.dtype, device=contrib.device) \
                .index_add(0, rows, contrib)
        return y + self.bias if self.bias is not None else y

    def init_arrays(self, rng):
        bound = np.sqrt(6.0 / (self.input_size + self.output_size))
        out = {"weight": rng.uniform(-bound, bound,
                                     (self.input_size, self.output_size))}
        if self.bias is not None:
            out["bias"] = np.zeros(self.output_size)
        return out

    def extra_repr(self):
        return f"{self.input_size} -> {self.output_size}"


class SparseJoinTable(Module):
    """Sparse tensors concatenated along ``dimension`` (a Python axis;
    reference ``nn/SparseJoinTable.scala``): their entries in table order,
    each index along ``dimension`` shifted by the sizes before it."""

    def __init__(self, dimension=1):
        super().__init__()
        self.dimension = dimension

    def forward(self, *xs):
        elems = _elems(xs)
        dim = self.dimension
        offset = 0
        all_idx, all_vals = [], []
        shape = list(elems[0].dense_shape)
        for t in elems:
            idx = t.indices.clone()
            idx[:, dim] += offset
            all_idx.append(idx)
            all_vals.append(t.values)
            offset += t.dense_shape[dim]
        shape[dim] = offset
        return SparseTensor(torch.cat(all_idx), torch.cat(all_vals), shape)
