"""Sparse tensors (the port of ``SparseTensor`` from
``bigdl_tpu/nn/sparse.py``: reference ``tensor/SparseTensor.scala``), the
COO triple ``CategoricalColVocaList`` gives. Its layers (``SparseLinear``,
``SparseJoinTable``, ``DenseToSparse``) are not ported yet (ROADMAP
A.11(d)(4))."""

from __future__ import annotations

import torch


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
