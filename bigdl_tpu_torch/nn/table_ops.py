"""Table reductions (the port of ``bigdl_tpu/nn/table_ops.py``
``CAddTable``): the reference's table input is the argument list here."""

from __future__ import annotations

from torch import nn


class CAddTable(nn.Module):
    """Element-wise sum of its inputs, in order."""

    def forward(self, *xs):
        acc = xs[0]
        for x in xs[1:]:
            acc = acc + x
        return acc
