"""Classification criterions (the port of ``bigdl_tpu/nn/criterion.py``
``ClassNLLCriterion`` and ``CrossEntropyCriterion``).

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
    at ``target`` (...); ``weights`` (C,) weighs each class."""

    def __init__(self, weights=None, size_average=True, padding_value=-1):
        super().__init__()
        self.weights = (None if weights is None
                        else torch.as_tensor(weights, dtype=torch.float32))
        self.size_average = size_average
        self.padding_value = padding_value

    def forward(self, input, target):
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
