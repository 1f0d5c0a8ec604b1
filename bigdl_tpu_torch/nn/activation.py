"""Activations (the port of ``bigdl_tpu/nn/activation.py`` ``ReLU`` and
``LogSoftMax``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class ReLU(nn.Module):
    def forward(self, x):
        return torch.relu(x)


class LogSoftMax(nn.Module):
    """log-softmax over the last axis."""

    def forward(self, x):
        return F.log_softmax(x, dim=-1)
