"""Evaluator, Predictor and LocalValidator (the port of
``bigdl_tpu/optim/evaluator.py``, reference ``optim/Evaluator.scala:37``
and ``optim/Predictor.scala:130``).

Each runs the model in eval mode under ``torch.no_grad()`` on the device
of its parameters, batch by batch, and drops a padded tail's repeated rows
(``MiniBatch.real_size``) so that every sample counts once. A model that
was training is put back in training mode.

``Predictor(mesh=)`` and ``DistriPredictor`` (reference
``optim/Predictor.scala`` on Spark executors) split each batch's rows over
copies of the model on the mesh's devices (a list; a device may repeat)
and join the outputs in row order; a batch whose rows the mesh does not
divide runs unsplit on the model itself. ``DistriValidator`` is the
reference's facade over ``Evaluator``.
"""

from __future__ import annotations

import contextlib
import copy

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
    """(reference ``optim/Predictor.scala:130``; ``batch_size`` and
    ``axis``, the mesh axis name, are the reference's keywords, unused
    here). ``mesh``: None, or the devices whose model copies share each
    batch's rows (module docstring)."""

    def __init__(self, model, batch_size=32, mesh=None, axis="data"):
        self.model = model
        self.mesh = None if mesh is None else [torch.device(d) for d in mesh]

    def predict(self, dataset):
        """The outputs of every real sample, stacked (numpy)."""
        outs = []
        replicas = ([] if self.mesh is None else
                    [copy.deepcopy(self.model).to(d).eval()
                     for d in self.mesh])
        with _inference(self.model) as device:
            for batch in dataset.data(train=False):
                x = host_tensor(batch.get_input())
                if replicas and x.shape[0] % len(replicas) == 0:
                    rows = x.shape[0] // len(replicas)
                    out = torch.cat([
                        r(x[p * rows:(p + 1) * rows].to(d)).float().cpu()
                        for p, (r, d) in enumerate(zip(replicas,
                                                       self.mesh))])
                else:
                    out = self.model(x.to(device))
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


class DistriPredictor(Predictor):
    """The mesh's Predictor (reference ``optim/Predictor.scala`` on Spark
    executors): ``mesh`` defaults to every visible card."""

    def __init__(self, model, batch_size=32, mesh=None, axis="data"):
        if mesh is None:
            from bigdl_tpu_torch.parallel.distri_optimizer import \
                visible_cards
            mesh = visible_cards()
        super().__init__(model, batch_size, mesh=mesh, axis=axis)


class LocalValidator(Validator):
    """(reference ``optim/LocalValidator.scala``)"""


class DistriValidator(Validator):
    """(reference ``optim/DistriValidator.scala:25``): ``test(methods)``
    over the dataset. During training the in-mesh path is the
    ``DistriOptimizer``'s (``_validate_inmesh``); this facade tests a
    model on a dataset."""
