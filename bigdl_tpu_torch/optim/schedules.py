"""Learning-rate schedules (the port of ``bigdl_tpu/optim/schedules.py``:
``Default``, ``Step``, ``MultiStep``, ``EpochStep``, ``EpochDecay``,
``Poly``, ``Exponential``, ``NaturalExp``, ``EpochSchedule`` with its
``Regime`` rows, ``Plateau``, ``Warmup`` and ``SequentialSchedule``).

A schedule maps ``(base_lr, step, epoch)`` to the learning rate; ``step``
and ``epoch`` are the optimizer state's int32 tensors (or Python ints), so
the rate is a float32 tensor on their device and reading it costs no host
sync.
"""

from __future__ import annotations

import torch


def _pow(base, exponent):
    """float32 ``base ** exponent`` for a tensor (or number)
    ``exponent``."""
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


class EpochStep:
    """lr * gamma ^ floor(epoch / step_size)."""

    def __init__(self, step_size, gamma):
        self.step_size, self.gamma = step_size, gamma

    def __call__(self, base_lr, step, epoch):
        return base_lr * _pow(self.gamma,
                              torch.as_tensor(epoch) // self.step_size)


class EpochDecay:
    """lr * 0.1 ^ decay_fn(epoch): ``decay_fn`` takes the epoch tensor
    (reference ``SGD.EpochDecay`` takes a closure)."""

    def __init__(self, decay_fn):
        self.decay_fn = decay_fn

    def __call__(self, base_lr, step, epoch):
        return base_lr * _pow(0.1, self.decay_fn(torch.as_tensor(epoch)))


class Exponential:
    """lr * decay_rate ^ (step / decay_step), the exponent floored with
    ``stair_case``."""

    def __init__(self, decay_step, decay_rate, stair_case=False):
        self.decay_step, self.decay_rate = decay_step, decay_rate
        self.stair_case = stair_case

    def __call__(self, base_lr, step, epoch):
        exponent = torch.as_tensor(step) / self.decay_step
        if self.stair_case:
            exponent = torch.floor(exponent)
        return base_lr * _pow(self.decay_rate, exponent)


class NaturalExp:
    """lr * exp(-gamma * floor(step / decay_step))."""

    def __init__(self, decay_step, gamma):
        self.decay_step, self.gamma = decay_step, gamma

    def __call__(self, base_lr, step, epoch):
        n = (torch.as_tensor(step) // self.decay_step).float()
        return base_lr * torch.exp(-self.gamma * n)


class Regime:
    """(start_epoch, end_epoch, config) row of an ``EpochSchedule``
    (reference ``SGD.Regime``); ``config["learningRate"]`` is the rate."""

    def __init__(self, start_epoch, end_epoch, config):
        self.start_epoch, self.end_epoch = start_epoch, end_epoch
        self.config = config


class EpochSchedule:
    """The learning rate of the regime whose epochs hold ``epoch``; the
    base rate outside every regime."""

    def __init__(self, regimes):
        self.regimes = list(regimes)

    def __call__(self, base_lr, step, epoch):
        epoch = torch.as_tensor(epoch)
        lr = torch.tensor(base_lr, dtype=torch.float32, device=epoch.device)
        for r in self.regimes:
            inside = (epoch >= r.start_epoch) & (epoch <= r.end_epoch)
            lr = torch.where(inside, torch.tensor(
                float(r.config.get("learningRate", base_lr)),
                dtype=torch.float32, device=epoch.device), lr)
        return lr


class Plateau:
    """Reduce on a validation metric's plateau (reference ``SGD.Plateau``).

    Host-driven: the optimizer calls ``record(metric)`` after each
    validation and writes the returned factor into the optimizer state's
    ``plateau_mult``, which ``OptimMethod.current_lr`` multiplies in
    (clamped below at ``min_lr``). The schedule itself returns the base
    rate."""

    def __init__(self, monitor="score", factor=0.1, patience=10, mode="min",
                 epsilon=1e-4, cooldown=0, min_lr=0.0):
        self.monitor, self.factor, self.patience = monitor, factor, patience
        self.mode, self.epsilon, self.cooldown = mode, epsilon, cooldown
        self.min_lr = min_lr
        self.multiplier = 1.0
        self.best = None
        self.wait = 0
        self.cooldown_counter = 0

    def record(self, metric):
        metric = float(metric)
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        improved = (self.best is None
                    or (self.mode == "min" and metric < self.best - self.epsilon)
                    or (self.mode == "max" and metric > self.best + self.epsilon))
        if improved:
            self.best = metric
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                self.multiplier *= self.factor
                self.cooldown_counter = self.cooldown
                self.wait = 0
        return self.multiplier

    def __call__(self, base_lr, step, epoch):
        return base_lr
