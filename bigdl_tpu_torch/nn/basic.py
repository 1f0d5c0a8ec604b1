"""Shape and noise layers (the port of ``bigdl_tpu/nn/basic.py``
``Reshape``, ``Flatten``, ``Input`` and ``Dropout``)."""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import Module


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


class Flatten(Module):
    """Every axis but the batch axis flattened into one."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


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
