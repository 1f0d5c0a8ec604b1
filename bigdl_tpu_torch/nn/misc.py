"""Utility layers (the port of ``bigdl_tpu/nn/misc.py``'s
``BinaryThreshold`` and ``InferReshape``, the two that the Caffe loader
builds; the file's other classes are not ported yet).
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import Module


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
