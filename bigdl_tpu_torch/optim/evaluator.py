"""Evaluator, Predictor and LocalValidator (the port of
``bigdl_tpu/optim/evaluator.py``, reference ``optim/Evaluator.scala:37``
and ``optim/Predictor.scala:130``).

Each runs the model in eval mode under ``torch.no_grad()`` on the device
of its parameters, batch by batch, and drops a padded tail's repeated rows
(``MiniBatch.real_size``) so that every sample counts once. A model that
was training is put back in training mode. ``DistriPredictor`` /
``DistriValidator`` wait for ROADMAP queue A.10.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from bigdl_tpu_torch.dataset.transformer import host_tensor


def model_device(model):
    """The device of ``model``'s parameters (the CPU without any)."""
    p = next(model.parameters(), None)
    return p.device if p is not None else torch.device("cpu")


@contextlib.contextmanager
def _inference(model):
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            yield model_device(model)
    finally:
        model.train(was_training)


def _on(a, device):
    """A batch array on ``device``; float64 arrives as float32, as in
    training (``dataset.transformer.host_tensor``)."""
    return host_tensor(a).to(device)


class Evaluator:
    """(reference ``optim/Evaluator.scala:37``)"""

    def __init__(self, model):
        self.model = model

    def evaluate(self, dataset, methods, batch_size=None):
        """``{method name: ValidationResult}`` over ``dataset``'s batches,
        in the order of ``methods``. ``batch_size`` is the reference's
        keyword, unused there too: the dataset's batches are evaluated."""
        agg = {m.name: None for m in methods}
        with _inference(self.model) as device:
            for batch in dataset.data(train=False):
                out = self.model(_on(batch.get_input(), device))
                y = _on(batch.get_target(), device)
                real = getattr(batch, "real_size", out.shape[0])
                if real < out.shape[0]:
                    out, y = out[:real], y[:real]
                for m in methods:
                    r = m(out, y)
                    agg[m.name] = r if agg[m.name] is None else agg[m.name] + r
        return {name: r for name, r in agg.items() if r is not None}


class Predictor:
    """(reference ``optim/Predictor.scala:130``; ``batch_size`` is the
    reference's keyword, unused there too)"""

    def __init__(self, model, batch_size=32):
        self.model = model

    def predict(self, dataset):
        """The outputs of every real sample, stacked (numpy)."""
        outs = []
        with _inference(self.model) as device:
            for batch in dataset.data(train=False):
                out = self.model(_on(batch.get_input(), device))
                real = getattr(batch, "real_size", out.shape[0])
                outs.append(out[:real].float().cpu().numpy())
        return np.concatenate(outs, axis=0) if outs else np.empty((0,))

    def predict_class(self, dataset):
        return np.argmax(self.predict(dataset), axis=-1)


class Validator:
    """(reference ``optim/Validator.scala:43``): ``test(methods)`` runs
    them over the dataset."""

    def __init__(self, model, dataset):
        self.model = model
        self.dataset = dataset

    def test(self, methods, batch_size=None):
        return Evaluator(self.model).evaluate(self.dataset, methods)


class LocalValidator(Validator):
    """(reference ``optim/LocalValidator.scala``)"""
