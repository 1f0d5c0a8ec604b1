"""Table layers (the port of ``bigdl_tpu/nn/table_ops.py``: all 16 of its
classes).

The reference's Table (keys 1..n) is a Python list here: containers and
graphs hand a table layer one list, and a layer that gives a table
(``SplitTable``, ``FlattenTable``) gives a list. A ``utils.table.Table``
or a dict is read in key order. ``CAddTable`` also takes its inputs as
separate arguments, as the port's ResNet calls it.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.table import sorted_items


def _table(x):
    """A table's entries: a dict's in key order, a list's as they are."""
    if isinstance(x, dict):
        return [v for _, v in sorted_items(x)]
    return list(x)


def _elems(xs):
    """The table a layer's positional arguments give: one list, tuple or
    dict, or the arguments themselves."""
    if len(xs) == 1 and isinstance(xs[0], (list, tuple, dict)):
        return _table(xs[0])
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


class CAveTable(Module):
    """Element-wise mean of its inputs."""

    def forward(self, *xs):
        xs = _elems(xs)
        return sum(xs) / len(xs)


class SplitTable(Module):
    """A tensor split along ``dimension`` (0-based) into the list of its
    slices, the axis dropped."""

    def __init__(self, dimension, n_input_dims=-1):
        super().__init__()
        self.dimension = dimension

    def forward(self, x):
        return list(x.unbind(self.dimension))


class FlattenTable(Module):
    """A nested table flattened, depth first, into one list."""

    def forward(self, *xs):
        out = []

        def rec(v):
            if isinstance(v, (list, tuple, dict)):
                for e in _table(v):
                    rec(e)
            else:
                out.append(v)

        rec(_elems(xs))
        return out


class MixtureTable(Module):
    """Experts mixed by gater weights: input (gater (B, E), a table of E
    expert outputs (B, ...)); ``sum_e gater[:, e] * expert_e``."""

    def __init__(self, dim=None):
        super().__init__()

    def forward(self, *xs):
        gater, experts = _elems(xs)
        stacked = torch.stack(_table(experts), dim=1)       # (B, E, ...)
        g = gater.reshape(tuple(gater.shape)
                          + (1,) * (stacked.dim() - gater.dim()))
        return (stacked * g).sum(1)


class DotProduct(Module):
    """Row-wise dot product of a pair over the last axis."""

    def forward(self, *xs):
        a, b = _elems(xs)
        return (a * b).sum(-1)


class CosineDistance(Module):
    """Row-wise cosine of a pair over the last axis, each norm plus
    1e-12."""

    def forward(self, *xs):
        a, b = _elems(xs)
        an = a / (torch.linalg.norm(a, dim=-1, keepdim=True) + 1e-12)
        bn = b / (torch.linalg.norm(b, dim=-1, keepdim=True) + 1e-12)
        return (an * bn).sum(-1)


class MV(Module):
    """Matrix-vector product of a pair (m (..., i, j), v (..., j)),
    batched over the leading axes; ``trans`` swaps m's last two axes
    first (reference ``nn/MV.scala``)."""

    def __init__(self, trans=False):
        super().__init__()
        self.trans = trans

    def forward(self, *xs):
        m, v = _elems(xs)
        if self.trans:
            m = m.transpose(-1, -2)
        return torch.einsum("...ij,...j->...i", m, v)

    def extra_repr(self):
        return f"trans={self.trans}"
