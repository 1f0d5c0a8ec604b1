"""Table layers (the port of ``bigdl_tpu/nn/table_ops.py`` ``CAddTable``,
``CSubTable``, ``CMulTable``, ``CDivTable``, ``CMaxTable``, ``CMinTable``,
``JoinTable``, ``SelectTable`` and ``MM``).

The reference's Table (keys 1..n) is a Python list here: containers and
graphs hand a table layer one list. ``CAddTable`` also takes its inputs as
separate arguments, as the port's ResNet calls it.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import Module


def _elems(xs):
    if len(xs) == 1 and isinstance(xs[0], (list, tuple)):
        return list(xs[0])
    return list(xs)


class _ReduceTable(Module):
    """Its inputs folded left to right by ``op``."""

    def forward(self, *xs):
        xs = _elems(xs)
        acc = xs[0]
        for x in xs[1:]:
            acc = self.op(acc, x)
        return acc


class CAddTable(_ReduceTable):
    """Element-wise sum of its inputs, in order."""

    op = staticmethod(torch.add)

    def __init__(self, inplace=False):
        super().__init__()


class CSubTable(_ReduceTable):
    op = staticmethod(torch.subtract)


class CMulTable(_ReduceTable):
    op = staticmethod(torch.multiply)


class CDivTable(_ReduceTable):
    op = staticmethod(torch.divide)


class CMaxTable(_ReduceTable):
    op = staticmethod(torch.maximum)


class CMinTable(_ReduceTable):
    op = staticmethod(torch.minimum)


class JoinTable(Module):
    """Concatenation of the table's tensors along ``dimension`` (0-based,
    as in the reference)."""

    def __init__(self, dimension, n_input_dims=-1):
        super().__init__()
        self.dimension = dimension

    def forward(self, *xs):
        return torch.cat(_elems(xs), dim=self.dimension)


class SelectTable(Module):
    """Element ``index`` (1-based, as in the reference) of the table."""

    def __init__(self, index):
        super().__init__()
        self.index = index

    def forward(self, *xs):
        return _elems(xs)[self.index - 1]


class MM(Module):
    """Matrix product of a two-tensor table, batched over the leading
    axes (reference ``nn/MM.scala``); ``trans_a``/``trans_b`` swap the
    last two axes of an operand first."""

    def __init__(self, trans_a=False, trans_b=False):
        super().__init__()
        self.trans_a, self.trans_b = trans_a, trans_b

    def forward(self, *xs):
        a, b = _elems(xs)
        if self.trans_a:
            a = a.transpose(-1, -2)
        if self.trans_b:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)

    def extra_repr(self):
        return f"trans_a={self.trans_a}, trans_b={self.trans_b}"
