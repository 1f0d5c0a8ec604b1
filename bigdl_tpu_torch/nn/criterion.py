"""Criterions (the port of ``bigdl_tpu/nn/criterion.py``
``ClassNLLCriterion``, ``CrossEntropyCriterion`` and
``TimeDistributedCriterion``).

Labels are 0-based class indices; a label equal to ``padding_value``
contributes nothing. With ``size_average`` the sum is divided by the
weight of the unpadded labels, floored at 1e-8, so an all-padding batch
gives 0 (``F.cross_entropy(ignore_index=...)`` would give NaN).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class ClassNLLCriterion(nn.Module):
    """Negative log-likelihood of log-probabilities ``input`` (..., C)
    at ``target`` (...); ``weights`` (C,) weighs each class. With
    ``log_prob_as_input=False`` the input is probabilities, and the
    criterion takes ``log(input + 1e-8)``, as the reference does."""

    def __init__(self, weights=None, size_average=True,
                 log_prob_as_input=True, padding_value=-1):
        super().__init__()
        self.weights = (None if weights is None
                        else torch.as_tensor(weights, dtype=torch.float32))
        self.size_average = size_average
        self.log_prob_as_input = log_prob_as_input
        self.padding_value = padding_value

    def forward(self, input, target):
        if not self.log_prob_as_input:
            input = torch.log(input + 1e-8)
        logp = input.reshape(-1, input.shape[-1])
        target = torch.as_tensor(target, device=logp.device).reshape(-1).long()
        pad = target == self.padding_value
        safe = torch.where(pad, torch.zeros_like(target), target)
        picked = logp.gather(1, safe[:, None])[:, 0]
        if self.weights is None:
            w = torch.ones_like(picked)
        else:
            w = self.weights.to(logp.device, logp.dtype)[safe]
        mask = (~pad).to(logp.dtype)
        losses = -picked * w * mask
        if self.size_average:
            return losses.sum() / torch.clamp_min((w * mask).sum(), 1e-8)
        return losses.sum()


class CrossEntropyCriterion(nn.Module):
    """LogSoftMax + ClassNLL over logits ``input`` (..., C)."""

    def __init__(self, weights=None, size_average=True):
        super().__init__()
        self.nll = ClassNLLCriterion(weights, size_average)

    def forward(self, input, target):
        return self.nll(F.log_softmax(input, dim=-1), target)


class TimeDistributedCriterion(nn.Module):
    """``critrn`` at every step of axis ``dimension`` of (batch, time,
    ...) inputs and targets, summed in step order, divided by the steps
    with ``size_average`` (reference ``nn/TimeDistributedCriterion.scala``)."""

    def __init__(self, critrn, size_average=False, dimension=1):
        super().__init__()
        self.critrn = critrn
        self.size_average = size_average
        self.dimension = dimension

    def forward(self, input, target):
        target = torch.as_tensor(target, device=input.device)
        steps = input.shape[self.dimension]
        total = 0.0
        for s in range(steps):
            total = total + self.critrn(input.select(self.dimension, s),
                                        target.select(self.dimension, s))
        return total / steps if self.size_average else total
