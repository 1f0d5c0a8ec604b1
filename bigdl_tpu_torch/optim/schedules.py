"""Learning-rate schedules (the port of ``bigdl_tpu/optim/schedules.py``:
``Default``, ``Step``, ``MultiStep``, ``Poly``, ``Warmup`` and
``SequentialSchedule``; the others wait for ROADMAP A.9).

A schedule maps ``(base_lr, step, epoch)`` to the learning rate; ``step``
and ``epoch`` are the optimizer state's int32 tensors (or Python ints), so
the rate is a float32 tensor on their device and reading it costs no host
sync.
"""

from __future__ import annotations

import torch


def _pow(base, exponent):
    """float32 ``base ** exponent`` for an integer tensor ``exponent``."""
    exponent = torch.as_tensor(exponent)
    return torch.pow(torch.tensor(base, dtype=torch.float32,
                                  device=exponent.device), exponent)


class Default:
    """lr / (1 + step * decay) (reference ``SGD.Default``)."""

    def __init__(self, learning_rate_decay=0.0):
        self.decay = learning_rate_decay

    def __call__(self, base_lr, step, epoch):
        return base_lr / (1.0 + step * self.decay)


class Step:
    """lr * gamma ^ floor(step / step_size)."""

    def __init__(self, step_size, gamma):
        self.step_size, self.gamma = step_size, gamma

    def __call__(self, base_lr, step, epoch):
        return base_lr * _pow(self.gamma,
                              torch.as_tensor(step) // self.step_size)


class MultiStep:
    """lr * gamma ^ (number of ``step_sizes`` boundaries reached)."""

    def __init__(self, step_sizes, gamma):
        self.step_sizes = list(step_sizes)
        self.gamma = gamma

    def __call__(self, base_lr, step, epoch):
        step = torch.as_tensor(step)
        bounds = torch.tensor(self.step_sizes, device=step.device)
        return base_lr * _pow(self.gamma, torch.sum(step >= bounds))


class Poly:
    """lr * (1 - min(step / max_iteration, 1)) ^ power."""

    def __init__(self, power, max_iteration):
        self.power, self.max_iteration = power, max_iteration

    def __call__(self, base_lr, step, epoch):
        frac = torch.clamp_max(torch.as_tensor(step) / self.max_iteration,
                               1.0)
        return base_lr * torch.pow(1.0 - frac, self.power)


class Warmup:
    """lr + delta * step: linear warm-up, to be combined in a
    ``SequentialSchedule`` (reference ``SGD.Warmup``)."""

    def __init__(self, delta):
        self.delta = delta

    def __call__(self, base_lr, step, epoch):
        return base_lr + self.delta * torch.as_tensor(step)


class SequentialSchedule:
    """Run schedule i for its iteration budget, then the next; each sees a
    step counter relative to its own start, and past the last budget the
    last schedule's final value holds (reference
    ``SGD.SequentialSchedule``)."""

    def __init__(self, iteration_per_epoch=1):
        self.iteration_per_epoch = iteration_per_epoch
        self.schedules = []   # (schedule, max_iterations)

    def add(self, schedule, max_iteration):
        self.schedules.append((schedule, max_iteration))
        return self

    def __call__(self, base_lr, step, epoch):
        step = torch.as_tensor(step)
        lr = torch.tensor(base_lr, dtype=torch.float32, device=step.device)
        offset = 0
        for sched, budget in self.schedules:
            local = torch.clamp(step - offset, 0, budget)
            active = (step >= offset) & (step < offset + budget)
            lr = torch.where(active, sched(base_lr, local, epoch), lr)
            offset += budget
        if self.schedules:
            sched, budget = self.schedules[-1]
            last = sched(base_lr, torch.full_like(step, budget), epoch)
            lr = torch.where(step >= offset, last, lr)
        return lr
