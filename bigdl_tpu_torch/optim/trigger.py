"""Triggers: when to stop, validate or checkpoint (the port's copy of
``bigdl_tpu/optim/trigger.py``).

Reference: ``optim/Trigger.scala:30-127`` — everyEpoch, severalIteration,
maxEpoch, maxIteration, maxScore, minLoss. A trigger is a host-side predicate
over the driver state dict {"epoch", "neval", "loss", "score",
"epoch_finished"}, evaluated between steps.
"""

from __future__ import annotations


class Trigger:
    def __call__(self, state) -> bool:
        raise NotImplementedError

    # factories (mirror the reference's object Trigger)
    @staticmethod
    def every_epoch():
        return _EveryEpoch()

    @staticmethod
    def several_iteration(n):
        return _SeveralIteration(n)

    @staticmethod
    def max_epoch(n):
        return _MaxEpoch(n)

    @staticmethod
    def max_iteration(n):
        return _MaxIteration(n)

    @staticmethod
    def max_score(s):
        return _MaxScore(s)

    @staticmethod
    def min_loss(l):
        return _MinLoss(l)

    @staticmethod
    def and_(*triggers):
        return _And(triggers)

    @staticmethod
    def or_(*triggers):
        return _Or(triggers)


class _EveryEpoch(Trigger):
    def __init__(self):
        self._last_epoch = None

    def __call__(self, state):
        return bool(state.get("epoch_finished", False))


class _SeveralIteration(Trigger):
    def __init__(self, n):
        self.n = n

    def __call__(self, state):
        neval = int(state.get("neval", 0))
        return neval > 0 and neval % self.n == 0


class _MaxEpoch(Trigger):
    def __init__(self, n):
        self.n = n

    def __call__(self, state):
        return int(state.get("epoch", 1)) > self.n


class _MaxIteration(Trigger):
    def __init__(self, n):
        self.n = n

    def __call__(self, state):
        # neval starts at 1; "maxIteration(n)" means run n steps
        # (reference Trigger.maxIteration uses strict >)
        return int(state.get("neval", 0)) > self.n


class _MaxScore(Trigger):
    def __init__(self, s):
        self.s = s

    def __call__(self, state):
        score = state.get("score")
        return score is not None and float(score) > self.s


class _MinLoss(Trigger):
    def __init__(self, l):
        self.l = l

    def __call__(self, state):
        loss = state.get("loss")
        return loss is not None and float(loss) < self.l


class _And(Trigger):
    def __init__(self, triggers):
        self.triggers = triggers

    def __call__(self, state):
        return all(t(state) for t in self.triggers)


class _Or(Trigger):
    def __init__(self, triggers):
        self.triggers = triggers

    def __call__(self, state):
        return any(t(state) for t in self.triggers)
