"""Validation methods and their results (the port of
``bigdl_tpu/optim/validation.py``, reference
``optim/ValidationMethod.scala:72-332``): ``Top1Accuracy``,
``Top5Accuracy``, ``Loss``, ``MAE`` and ``TreeNNAccuracy``, whose results
add up across batches.

``counters(output, target, valid=None)`` gives ``(value, count)`` as
tensors; ``valid``, a per-sample bool vector, masks a padded tail's
repeated rows out of both, expanded to per-token rows for sequence
outputs (``_row_mask``).
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion


class ValidationResult:
    def result(self):
        """(value, count)"""
        raise NotImplementedError

    def __add__(self, other):
        raise NotImplementedError

    def __float__(self):
        return float(self.result()[0])


class AccuracyResult(ValidationResult):
    def __init__(self, correct, count):
        self.correct, self.count = int(correct), int(count)

    def result(self):
        return (self.correct / max(self.count, 1), self.count)

    def __add__(self, other):
        return AccuracyResult(self.correct + other.correct,
                              self.count + other.count)

    def __repr__(self):
        v, c = self.result()
        return f"Accuracy({self.correct}/{c} = {v:.4f})"


class LossResult(ValidationResult):
    def __init__(self, loss, count):
        self.loss, self.count = float(loss), int(count)

    def result(self):
        return (self.loss / max(self.count, 1), self.count)

    def __add__(self, other):
        return LossResult(self.loss + other.loss, self.count + other.count)

    def __repr__(self):
        v, _ = self.result()
        return f"Loss({v:.4f})"


def _row_mask(valid, nrows):
    """A per-sample bool vector expanded to ``nrows`` flattened output
    rows (rows = batch * steps for sequence outputs)."""
    v = torch.as_tensor(valid).reshape(-1)
    if v.shape[0] != nrows:
        if nrows % v.shape[0]:
            raise ValueError(
                f"validation mask of {v.shape[0]} samples cannot align to "
                f"{nrows} output rows (rows must be a multiple of the "
                "batch)")
        v = torch.repeat_interleave(v, nrows // v.shape[0])
    return v


def _hits(hit, valid):
    if valid is None:
        return hit.sum(), torch.tensor(hit.shape[0])
    v = _row_mask(valid, hit.shape[0]).to(hit.device)
    return (hit & v).sum(), v.sum()


class ValidationMethod:
    name = "ValidationMethod"

    def __call__(self, output, target):
        return self.make_result(*self.counters(output, target))

    def counters(self, output, target, valid=None):
        raise NotImplementedError

    def make_result(self, value, count):
        raise NotImplementedError

    def __repr__(self):
        return self.name


class Top1Accuracy(ValidationMethod):
    name = "Top1Accuracy"

    def counters(self, output, target, valid=None):
        pred = torch.argmax(output.reshape(-1, output.shape[-1]), dim=-1)
        t = torch.as_tensor(target, device=pred.device).reshape(-1).long()
        return _hits(pred == t, valid)

    def make_result(self, value, count):
        return AccuracyResult(int(value), int(count))


class Top5Accuracy(ValidationMethod):
    name = "Top5Accuracy"

    def counters(self, output, target, valid=None):
        out = output.reshape(-1, output.shape[-1])
        t = torch.as_tensor(target, device=out.device).reshape(-1).long()
        top5 = torch.topk(out, min(5, out.shape[-1]), dim=-1).indices
        return _hits((top5 == t[:, None]).any(dim=-1), valid)

    def make_result(self, value, count):
        return AccuracyResult(int(value), int(count))


class Loss(ValidationMethod):
    """The criterion's loss (``ClassNLLCriterion`` by default) weighed by
    rows: a full batch takes the batched criterion, a padded tail the
    criterion of each real row alone."""

    name = "Loss"

    def __init__(self, criterion=None):
        self.criterion = criterion or ClassNLLCriterion()

    def counters(self, output, target, valid=None):
        n = output.shape[0]
        target = torch.as_tensor(target, device=output.device)
        if valid is None or bool(torch.as_tensor(valid).all()):
            return self.criterion(output, target) * n, torch.tensor(n)
        per = torch.stack([self.criterion(output[i:i + 1], target[i:i + 1])
                           for i in range(n)])
        v = _row_mask(valid, n).to(per.device, per.dtype)
        return (per * v).sum(), v.sum()

    def make_result(self, value, count):
        return LossResult(float(value), int(count))


class MAE(ValidationMethod):
    name = "MAE"

    def counters(self, output, target, valid=None):
        n = output.shape[0]
        target = torch.as_tensor(target, device=output.device)
        per = torch.mean(torch.abs(output - target).reshape(n, -1), dim=1)
        if valid is None:
            return per.sum(), torch.tensor(n)
        v = _row_mask(valid, n).to(per.device, per.dtype)
        return (per * v).sum(), v.sum()

    def make_result(self, value, count):
        return LossResult(float(value), int(count))


class TreeNNAccuracy(ValidationMethod):
    """Accuracy of a tree output's first node (reference
    ``ValidationMethod.scala`` ``TreeNNAccuracy``): ``output`` (B, N, C)
    or (B, C)."""

    name = "TreeNNAccuracy"

    def counters(self, output, target, valid=None):
        out = output[:, 0, :] if output.dim() == 3 else output
        pred = torch.argmax(out, dim=-1)
        t = torch.as_tensor(target, device=pred.device).reshape(-1).long()
        return _hits(pred == t, valid)

    def make_result(self, value, count):
        return AccuracyResult(int(value), int(count))
