"""Activations (the port of ``bigdl_tpu/nn/activation.py``: ``ReLU``,
``Tanh``, ``Sigmoid``, ``SoftMax``, ``LogSoftMax`` and ``Identity``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Module


class ReLU(Module):
    def __init__(self, ip=False):
        super().__init__()
        self.ip = ip

    def forward(self, x):
        return torch.relu(x)


class Tanh(Module):
    def forward(self, x):
        return torch.tanh(x)


class Sigmoid(Module):
    def forward(self, x):
        return torch.sigmoid(x)


class SoftMax(Module):
    """softmax over axis ``pos`` (the last by default)."""

    def __init__(self, pos=-1):
        super().__init__()
        self.pos = pos

    def forward(self, x):
        return F.softmax(x, dim=self.pos)


class LogSoftMax(Module):
    """log-softmax over the last axis."""

    def forward(self, x):
        return F.log_softmax(x, dim=-1)


class Identity(Module):
    def forward(self, x):
        return x
