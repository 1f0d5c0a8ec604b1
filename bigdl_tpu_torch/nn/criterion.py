"""Criterions (the port of ``bigdl_tpu/nn/criterion.py``: all 39 of its
classes, on the :class:`~bigdl_tpu_torch.nn.module.Criterion` base).

Every criterion's ``forward(input, target)`` is the reference's pure
``apply``: the scalar loss, its gradient from autograd (``backward``).
Labels are 0-based class indices. A table input or target (the reference's
``Table``) is a list, a tuple, or a ``utils.table.Table`` / dict, read in
key order (``sorted_items``). A floating target takes the input's type, as
the reference's float32 arrays do; an integer one stays as it is.

``ClassNLLCriterion``: a label equal to ``padding_value`` contributes
nothing; with ``size_average`` the sum is divided by the weight of the
unpadded labels, floored at 1e-8, so an all-padding batch gives 0
(``F.cross_entropy(ignore_index=...)`` would give NaN).
``SoftmaxWithCriterion``: the reference gathers with numpy's negative
indexing (a label of -1 reads the last class, which the ignore mask then
zeroes), so a negative label is wrapped the same way before the gather
(``torch.gather`` refuses it).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Criterion
from bigdl_tpu_torch.nn.table_ops import _table as _elems


def _reduce(x, size_average):
    return x.mean() if size_average else x.sum()


def _pair(x):
    a, b = _elems(x)[:2]
    return a, b


def _like(t, x):
    """Target ``t`` as a tensor on ``x``'s device; a floating one in
    ``x``'s type."""
    t = torch.as_tensor(t, device=x.device)
    return t.to(x.dtype) if t.is_floating_point() else t


def _weights(w, x):
    return None if w is None else _like(w, x)


def _unit(x):
    """``x`` over its last-axis L2 norm, floored at 1e-12."""
    return x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True),
                               1e-12)


class ClassNLLCriterion(Criterion):
    """Negative log-likelihood of log-probabilities ``input`` (..., C)
    at ``target`` (...); ``weights`` (C,) weighs each class. With
    ``log_prob_as_input=False`` the input is probabilities, and the
    criterion takes ``log(input + 1e-8)``, as the reference does."""

    def __init__(self, weights=None, size_average=True,
                 log_prob_as_input=True, padding_value=-1):
        super().__init__(size_average)
        self.weights = (None if weights is None
                        else torch.as_tensor(weights, dtype=torch.float32))
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


class CrossEntropyCriterion(Criterion):
    """LogSoftMax + ClassNLL over logits ``input`` (..., C)."""

    def __init__(self, weights=None, size_average=True):
        super().__init__(size_average)
        self.nll = ClassNLLCriterion(weights, size_average)

    def forward(self, input, target):
        return self.nll(F.log_softmax(input, dim=-1), target)


class MSECriterion(Criterion):
    def forward(self, input, target):
        return _reduce(torch.square(input - _like(target, input)),
                       self.size_average)


class AbsCriterion(Criterion):
    def forward(self, input, target):
        return _reduce(torch.abs(input - _like(target, input)),
                       self.size_average)


class BCECriterion(Criterion):
    """Binary cross entropy of probabilities, ``log(p + 1e-12)``, with
    optional per-element ``weights``."""

    def __init__(self, weights=None, size_average=True):
        super().__init__(size_average)
        self.weights = weights

    def forward(self, input, target):
        eps = 1e-12
        t = _like(target, input)
        loss = -(t * torch.log(input + eps)
                 + (1.0 - t) * torch.log(1.0 - input + eps))
        if self.weights is not None:
            loss = loss * _weights(self.weights, input)
        return _reduce(loss, self.size_average)


class BCECriterionWithLogits(Criterion):
    def forward(self, input, target):
        t = _like(target, input)
        loss = (torch.clamp_min(input, 0) - input * t
                + torch.log1p(torch.exp(-torch.abs(input))))
        return _reduce(loss, self.size_average)


class SmoothL1Criterion(Criterion):
    def __init__(self, size_average=True, sigma=1.0):
        super().__init__(size_average)
        self.sigma2 = sigma * sigma

    def forward(self, input, target):
        d = torch.abs(input - _like(target, input))
        loss = torch.where(d < 1.0 / self.sigma2,
                           0.5 * self.sigma2 * torch.square(d),
                           d - 0.5 / self.sigma2)
        return _reduce(loss, self.size_average)


class MarginCriterion(Criterion):
    """Hinge loss; ``squared`` gives the L2-SVM's."""

    def __init__(self, margin=1.0, size_average=True, squared=False):
        super().__init__(size_average)
        self.margin, self.squared = margin, squared

    def forward(self, input, target):
        loss = torch.clamp_min(self.margin - input * _like(target, input),
                               0.0)
        if self.squared:
            loss = torch.square(loss)
        return _reduce(loss, self.size_average)


class MarginRankingCriterion(Criterion):
    """input = a table (x1, x2); target +-1."""

    def __init__(self, margin=1.0, size_average=True):
        super().__init__(size_average)
        self.margin = margin

    def forward(self, input, target):
        x1, x2 = _pair(input)
        t = _like(target, x1)
        loss = torch.clamp_min(-t * (x1 - x2) + self.margin, 0.0)
        return _reduce(loss, self.size_average)


class CosineEmbeddingCriterion(Criterion):
    def __init__(self, margin=0.0, size_average=True):
        super().__init__(size_average)
        self.margin = margin

    def forward(self, input, target):
        x1, x2 = _pair(input)
        t = _like(target, x1)
        cos = (x1 * x2).sum(-1) / (torch.linalg.norm(x1, dim=-1)
                                   * torch.linalg.norm(x2, dim=-1) + 1e-12)
        loss = torch.where(t > 0, 1.0 - cos,
                           torch.clamp_min(cos - self.margin, 0.0))
        return _reduce(loss, self.size_average)


class HingeEmbeddingCriterion(Criterion):
    def __init__(self, margin=1.0, size_average=True):
        super().__init__(size_average)
        self.margin = margin

    def forward(self, input, target):
        loss = torch.where(_like(target, input) > 0, input,
                           torch.clamp_min(self.margin - input, 0.0))
        return _reduce(loss, self.size_average)


class SoftMarginCriterion(Criterion):
    def forward(self, input, target):
        return _reduce(torch.log1p(torch.exp(-input * _like(target, input))),
                       self.size_average)


class MultiMarginCriterion(Criterion):
    """Multi-class hinge over (N, C) scores and 0-based labels; ``p`` 1 or
    2; ``weights`` (C,) scale each row by its label's weight."""

    def __init__(self, p=1, weights=None, margin=1.0, size_average=True):
        super().__init__(size_average)
        self.p, self.weights, self.margin = p, weights, margin

    def forward(self, input, target):
        x = input.reshape(-1, input.shape[-1])
        t = torch.as_tensor(target, device=x.device).reshape(-1).long()
        correct = x.gather(1, t[:, None])
        diff = torch.clamp_min(self.margin - correct + x, 0.0)
        if self.p == 2:
            diff = torch.square(diff)
        if self.weights is not None:
            diff = diff * _weights(self.weights, x)[t][:, None]
        onehot = F.one_hot(t, x.shape[-1]).to(x.dtype)
        loss = (diff * (1.0 - onehot)).sum(1) / x.shape[-1]
        return _reduce(loss, self.size_average)


class MultiLabelMarginCriterion(Criterion):
    """Hinge of every negative class against the row's lowest-scoring
    positive; ``target`` multi-hot {0, 1}."""

    def forward(self, input, target):
        t = _like(target, input)
        pos = torch.where(t > 0, input, torch.full_like(input, math.inf)) \
            .amin(-1, keepdim=True)
        loss = torch.clamp_min(1.0 - pos + input, 0.0) * (1.0 - t)
        return _reduce(loss.sum(-1) / input.shape[-1], self.size_average)


class MultiLabelSoftMarginCriterion(Criterion):
    def __init__(self, weights=None, size_average=True):
        super().__init__(size_average)
        self.weights = weights

    def forward(self, input, target):
        t = _like(target, input)
        loss = -(t * F.logsigmoid(input) + (1 - t) * F.logsigmoid(-input))
        if self.weights is not None:
            loss = loss * _weights(self.weights, input)
        return _reduce(loss.mean(-1), self.size_average)


class DistKLDivCriterion(Criterion):
    """KL(target || input), ``input`` log-probabilities; entries whose
    target is not positive contribute 0; ``size_average`` divides by the
    batch."""

    def forward(self, input, target):
        t = _like(target, input)
        loss = torch.where(t > 0, t * (torch.log(t + 1e-12) - input),
                           torch.zeros_like(input))
        if self.size_average:
            return loss.sum() / input.shape[0]
        return loss.sum()


class KLDCriterion(Criterion):
    """The VAE's KL to a unit gaussian; input = a table (mean, log_var);
    summed, divided by the batch."""

    def forward(self, input, target=None):
        mean, log_var = _pair(input)
        kl = 0.5 * (torch.square(mean) + torch.exp(log_var) - 1.0
                    - log_var).sum(-1)
        return kl.sum() / mean.shape[0]


class GaussianCriterion(Criterion):
    """Gaussian negative log-likelihood of ``target``; input = a table
    (mean, log_var); summed, divided by the batch."""

    def forward(self, input, target):
        mean, log_var = _pair(input)
        t = _like(target, mean)
        nll = 0.5 * (math.log(2 * math.pi) + log_var
                     + torch.square(t - mean) / torch.exp(log_var))
        return nll.sum() / mean.shape[0]


class L1Cost(Criterion):
    def forward(self, input, target=None):
        return torch.abs(input).sum()


class DiceCoefficientCriterion(Criterion):
    def __init__(self, size_average=True, epsilon=1.0):
        super().__init__(size_average)
        self.epsilon = epsilon

    def forward(self, input, target):
        x = input.reshape(input.shape[0], -1)
        t = _like(target, input).reshape(x.shape[0], -1)
        inter = (x * t).sum(1)
        union = x.sum(1) + t.sum(1)
        dice = (2.0 * inter + self.epsilon) / (union + self.epsilon)
        return _reduce(1.0 - dice, self.size_average)


class PGCriterion(Criterion):
    """Policy-gradient loss, ``-log(prob + 1e-12) * reward``, summed
    unless ``sizeAverage``."""

    def __init__(self, sizeAverage=False):
        super().__init__(sizeAverage)

    def forward(self, input, target):
        return _reduce(-torch.log(input + 1e-12) * _like(target, input),
                       self.size_average)


class MultiCriterion(Criterion):
    """Weighted sum of criterions on the same (input, target); ``add``
    returns the criterion. The criterions are a plain list, as in the
    reference."""

    def __init__(self):
        super().__init__()
        self.criterions = []
        self.weights = []

    def add(self, criterion, weight=1.0):
        self.criterions.append(criterion)
        self.weights.append(weight)
        return self

    def forward(self, input, target):
        return sum(w * c(input, target)
                   for c, w in zip(self.criterions, self.weights))


class ParallelCriterion(Criterion):
    """Criterion ``i`` on entry ``i`` of the input and target tables (in
    key order), weighted and summed; with ``repeat_target`` every one
    takes the whole target."""

    def __init__(self, repeat_target=False):
        super().__init__()
        self.repeat_target = repeat_target
        self.criterions = []
        self.weights = []

    def add(self, criterion, weight=1.0):
        self.criterions.append(criterion)
        self.weights.append(weight)
        return self

    def forward(self, input, target):
        ins = _elems(input)
        tgts = ([target] * len(ins) if self.repeat_target
                else _elems(target))
        return sum(w * c(i, t) for c, w, i, t in
                   zip(self.criterions, self.weights, ins, tgts))


class TimeDistributedCriterion(Criterion):
    """``critrn`` at every step of axis ``dimension`` of (batch, time,
    ...) inputs and targets, summed in step order, divided by the steps
    with ``size_average`` (reference ``nn/TimeDistributedCriterion.scala``)."""

    def __init__(self, critrn, size_average=False, dimension=1):
        super().__init__(size_average)
        self.critrn = critrn
        self.dimension = dimension

    def forward(self, input, target):
        target = torch.as_tensor(target, device=input.device)
        steps = input.shape[self.dimension]
        total = 0.0
        for s in range(steps):
            total = total + self.critrn(input.select(self.dimension, s),
                                        target.select(self.dimension, s))
        return total / steps if self.size_average else total


def _evaluate(module, x):
    """``module(x)`` in evaluation mode (the reference applies a
    transformer with ``training=False``), its own mode restored."""
    mode = module.training
    module.eval()
    try:
        return module(x)
    finally:
        module.train(mode)


class TransformerCriterion(Criterion):
    """``criterion`` after ``input_transformer`` on the input and
    ``target_transformer`` on the target (each in evaluation mode)."""

    def __init__(self, criterion, input_transformer=None,
                 target_transformer=None):
        super().__init__()
        self.criterion = criterion
        self.input_transformer = input_transformer
        self.target_transformer = target_transformer

    def forward(self, input, target):
        if self.input_transformer is not None:
            input = _evaluate(self.input_transformer, input)
        if self.target_transformer is not None:
            target = _evaluate(self.target_transformer, target)
        return self.criterion(input, target)


class SoftmaxWithCriterion(Criterion):
    """Caffe's softmax loss over class axis 1 of (N, C, ...) logits and
    (N, ...) labels; labels equal to ``ignore_label`` contribute nothing.
    ``normalize_mode`` "VALID" divides by the labels kept (at least 1;
    all of them without an ``ignore_label``), "FULL" by all of them."""

    def __init__(self, ignore_label=None, normalize_mode="VALID"):
        super().__init__()
        self.ignore_label = ignore_label
        self.normalize_mode = normalize_mode

    def forward(self, input, target):
        logp = F.log_softmax(input, dim=1)
        t = torch.as_tensor(target, device=input.device).long()
        # numpy's negative indexing, as the reference's gather takes it
        safe = torch.where(t < 0, t + input.shape[1], t)
        picked = logp.gather(1, safe[:, None])[:, 0]
        if self.ignore_label is not None:
            mask = (t != self.ignore_label).to(logp.dtype)
            picked = picked * mask
            denom = torch.clamp_min(mask.sum(), 1.0)
        else:
            denom = picked.numel()
        if self.normalize_mode == "FULL":
            denom = picked.numel()
        return -picked.sum() / denom


class ClassSimplexCriterion(Criterion):
    """MSE to a regular-simplex embedding of the classes: class ``k`` is
    vertex ``k`` of an (N-1)-simplex, zero-padded to N dimensions, built
    on the host in float64 (the reference's ``_build_simplex``)."""

    def __init__(self, n_classes):
        super().__init__()
        if n_classes <= 1:
            raise ValueError("ClassSimplexCriterion needs n_classes > 1")
        self.n_classes = n_classes
        self.simplex = self._build_simplex(n_classes)

    @staticmethod
    def _build_simplex(n_classes):
        n = n_classes - 1
        a = np.zeros((n + 1, n), dtype=np.float64)
        for k in range(1, n + 1):
            if k == 1:
                a[0, 0] = 1.0
            else:
                nrm = np.linalg.norm(a[k - 1, :k - 1])
                a[k - 1, k - 1] = np.sqrt(1.0 - nrm * nrm)
            akk = a[k - 1, k - 1]
            c = (akk * akk - 1.0 - 1.0 / n) / akk
            a[k:, k - 1] = c
        simplex = np.zeros((n_classes, n_classes), dtype=np.float32)
        simplex[:, :n] = a
        return torch.from_numpy(simplex)

    def forward(self, input, target):
        t = torch.as_tensor(target, device=input.device).reshape(-1).long()
        emb = self.simplex.to(input.device, input.dtype)[t]
        diff = input.reshape(emb.shape) - emb
        loss = (diff * diff).sum()
        return loss / diff.numel() if self.size_average else loss


class L1HingeEmbeddingCriterion(Criterion):
    """L1 distance of a pair (x1, x2) for target +1, its hinge at
    ``margin`` for -1."""

    def __init__(self, margin=1.0):
        super().__init__()
        self.margin = margin

    def forward(self, input, target):
        x1, x2 = _pair(input)
        dist = torch.abs(x1 - x2).sum(-1)
        y = _like(target, dist).reshape(dist.shape)
        loss = torch.where(y > 0, dist,
                           torch.clamp_min(self.margin - dist, 0.0))
        return _reduce(loss, self.size_average)


class CosineDistanceCriterion(Criterion):
    """``1 - cos(input, target)`` over the last axis."""

    def forward(self, input, target):
        loss = 1.0 - (_unit(input) * _unit(_like(target, input))).sum(-1)
        return _reduce(loss, self.size_average)


class CosineProximityCriterion(Criterion):
    """Keras's cosine proximity: ``-mean(cos(input, target))``."""

    def forward(self, input, target):
        return -(_unit(input) * _unit(_like(target, input))).sum(-1).mean()


class DotProductCriterion(Criterion):
    """``-sum(input * target)``, over the batch with ``size_average``."""

    def forward(self, input, target):
        s = -(input * _like(target, input)).sum()
        return s / input.shape[0] if self.size_average else s


class PoissonCriterion(Criterion):
    """``pred - target * log(pred + 1e-8)``."""

    def forward(self, input, target):
        loss = input - _like(target, input) * torch.log(input + 1e-8)
        return _reduce(loss, self.size_average)


class KullbackLeiblerDivergenceCriterion(Criterion):
    """Keras's ``kld`` over probability vectors, both clipped to [1e-7,
    1] (``DistKLDivCriterion`` takes log-probabilities)."""

    def forward(self, input, target):
        eps = 1e-7
        p = torch.clamp(_like(target, input), eps, 1.0)
        q = torch.clamp(input, eps, 1.0)
        loss = (p * torch.log(p / q)).sum(-1)
        return _reduce(loss, self.size_average)


class MeanAbsolutePercentageCriterion(Criterion):
    """Keras's MAPE."""

    def forward(self, input, target):
        t = _like(target, input)
        diff = torch.abs(t - input) / torch.clamp_min(torch.abs(t), 1e-7)
        return 100.0 * diff.mean()


class MeanSquaredLogarithmicCriterion(Criterion):
    """Keras's MSLE."""

    def forward(self, input, target):
        a = torch.log(torch.clamp_min(_like(target, input), 1e-7) + 1.0)
        b = torch.log(torch.clamp_min(input, 1e-7) + 1.0)
        return torch.square(a - b).mean()


class CategoricalCrossEntropy(Criterion):
    """Cross entropy of probability vectors, clipped to [1e-7, 1 - 1e-7],
    at 0-based class labels."""

    def forward(self, input, target):
        eps = 1e-7
        q = torch.clamp(input, eps, 1.0 - eps)
        t = torch.as_tensor(target, device=input.device).reshape(-1).long()
        picked = q.reshape(-1, q.shape[-1]).gather(1, t[:, None])[:, 0]
        return -torch.log(picked).mean()


class SmoothL1CriterionWithWeights(Criterion):
    """Fast R-CNN's box loss: smooth L1 at ``sigma`` of ``inside * (input
    - target)``, times ``outside``, summed, divided by ``num`` when it is
    positive. ``target`` is a table (target, inside weights, outside
    weights), the weights 1 where absent, or the target alone."""

    def __init__(self, sigma=1.0, num=0):
        super().__init__()
        self.sigma2 = sigma * sigma
        self.num = num

    def forward(self, input, target):
        elems = ([_like(v, input) for v in _elems(target)]
                 if isinstance(target, (dict, list, tuple))
                 else [_like(target, input)])
        t = elems[0]
        w_in = elems[1] if len(elems) > 1 else torch.ones_like(t)
        w_out = elems[2] if len(elems) > 2 else torch.ones_like(t)
        d = w_in * (input - t)
        ad = torch.abs(d)
        loss = torch.where(ad < 1.0 / self.sigma2,
                           0.5 * self.sigma2 * d * d,
                           ad - 0.5 / self.sigma2)
        s = (w_out * loss).sum()
        return s / self.num if self.num > 0 else s


class NegativeEntropyPenalty(Criterion):
    """``beta * sum(p log p)``, ``p`` clipped to [1e-8, 1]; no target."""

    def __init__(self, beta=0.01):
        super().__init__()
        self.beta = beta

    def forward(self, input, target=None):
        p = torch.clamp(input, 1e-8, 1.0)
        return self.beta * (p * torch.log(p)).sum()


class TimeDistributedMaskCriterion(Criterion):
    """``criterion`` on every (batch, time) slice of (B, T, ...) inputs
    and targets, each slice's loss weighted by its target elements that
    are not ``padding_value``, divided by their count (at least 1)."""

    def __init__(self, criterion, padding_value=0):
        super().__init__()
        self.criterion = criterion
        self.padding_value = padding_value

    def forward(self, input, target):
        b, t = input.shape[0], input.shape[1]
        target = torch.as_tensor(target, device=input.device)
        if target.is_floating_point():
            target = target.to(input.dtype)
        flat_in = input.reshape((b * t,) + tuple(input.shape[2:]))
        flat_t = target.reshape((b * t,) + tuple(target.shape[2:]))
        mask = (flat_t != self.padding_value).reshape(b * t, -1)
        losses = torch.stack([self.criterion(flat_in[i:i + 1],
                                             flat_t[i:i + 1])
                              for i in range(b * t)])
        w = mask.to(losses.dtype).sum(1)
        return (losses * w).sum() / torch.clamp_min(w.sum(), 1.0)
