"""Shape layers (the port of ``bigdl_tpu/nn/basic.py`` ``Reshape``)."""

from __future__ import annotations

from torch import nn


class Reshape(nn.Module):
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
