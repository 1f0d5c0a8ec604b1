"""Utility layers (the port of ``bigdl_tpu/nn/misc.py``'s
``BinaryThreshold`` and ``InferReshape``, the two that the Caffe loader
builds, and ``Highway``; the file's other classes are not ported yet).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from bigdl_tpu_torch.nn.module import Module
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
