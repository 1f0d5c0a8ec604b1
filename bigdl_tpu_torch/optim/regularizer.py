"""Weight regularizers (the port of ``bigdl_tpu/optim/regularizer.py``,
reference ``optim/Regularizer.scala``): a penalty of a weight tensor that
the train step adds to the loss (``nn.module.regularization_loss``), so
autograd adds its gradient, as the reference's jitted step does."""

from __future__ import annotations

import torch


class Regularizer:
    def __call__(self, w):
        raise NotImplementedError


class L1Regularizer(Regularizer):
    def __init__(self, l1):
        self.l1 = l1

    def __call__(self, w):
        return self.l1 * torch.sum(torch.abs(w))


class L2Regularizer(Regularizer):
    def __init__(self, l2):
        self.l2 = l2

    def __call__(self, w):
        return 0.5 * self.l2 * torch.sum(torch.square(w))


class L1L2Regularizer(Regularizer):
    def __init__(self, l1, l2):
        self.l1, self.l2 = l1, l2

    def __call__(self, w):
        return (self.l1 * torch.sum(torch.abs(w))
                + 0.5 * self.l2 * torch.sum(torch.square(w)))
