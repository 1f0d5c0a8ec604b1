"""Learning-rate schedules (the port of ``bigdl_tpu/optim/schedules.py``;
``Default`` only so far, the others wait for ROADMAP A.9).

A schedule maps ``(base_lr, step, epoch)`` to the learning rate; ``step``
and ``epoch`` are the optimizer state's int32 tensors, so the rate is a
float32 tensor on their device and reading it costs no host sync.
"""

from __future__ import annotations


class Default:
    """lr / (1 + step * decay) (reference ``SGD.Default``)."""

    def __init__(self, learning_rate_decay=0.0):
        self.decay = learning_rate_decay

    def __call__(self, base_lr, step, epoch):
        return base_lr / (1.0 + step * self.decay)
