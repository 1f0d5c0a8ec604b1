"""Optimization methods (the port of ``bigdl_tpu/optim/methods.py``:
``OptimMethod``, ``SGD``, ``Adam``, ``AdamW``).

The reference's methods are pure pytree transforms. Here parameters,
gradients and slots are dicts of tensors keyed by parameter name (e.g.
``dict(model.named_parameters())``), and

    init_state(params) -> opt_state
    update(grads, opt_state, params) -> (params, opt_state)

updates ``params`` and the state's slots IN PLACE under
``torch.no_grad()`` and returns the same objects: a step keeps one copy of
the weights on the card instead of two. The step and epoch counters live
in ``opt_state`` as int32 tensors on the parameters' device, as in the
reference, so the learning rate and Adam's bias correction are float32
tensors computed there.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.optim.schedules import Default


def _device(params):
    return next(iter(params.values())).device


class OptimMethod:
    def __init__(self, learningrate=1e-3, learningrate_schedule=None,
                 weightdecay=0.0):
        self.learningrate = learningrate
        self.schedule = learningrate_schedule or Default(0.0)
        self.weightdecay = weightdecay

    def init_state(self, params):
        dev = _device(params)
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "epoch": torch.ones((), dtype=torch.int32, device=dev),
                **self.init_slots(params)}

    def init_slots(self, params):
        return {}

    def current_lr(self, opt_state):
        return self.schedule(self.learningrate, opt_state["step"],
                             opt_state["epoch"])

    @torch.no_grad()
    def update(self, grads, opt_state, params):
        """One step in place (see module docstring); L2 ``weightdecay``
        is added to the gradients."""
        lr = self.current_lr(opt_state)
        if self.weightdecay:
            grads = {k: g + self.weightdecay * params[k]
                     for k, g in grads.items()}
        self.apply_update(grads, opt_state, params, lr)
        opt_state["step"] += 1
        return params, opt_state

    def apply_update(self, grads, opt_state, params, lr):
        raise NotImplementedError


class SGD(OptimMethod):
    """SGD with momentum/dampening/nesterov (reference
    ``optim/SGD.scala:39``)."""

    def __init__(self, learningrate=1e-3, learningrate_decay=0.0,
                 weightdecay=0.0, momentum=0.0, dampening=None,
                 nesterov=False, learningrate_schedule=None):
        super().__init__(learningrate,
                         learningrate_schedule or Default(learningrate_decay),
                         weightdecay)
        self.momentum = momentum
        self.dampening = momentum if dampening is None else dampening
        self.nesterov = nesterov
        if nesterov and (momentum <= 0 or self.dampening != 0):
            raise ValueError("nesterov requires momentum > 0 and "
                             "dampening = 0")

    def init_slots(self, params):
        if self.momentum > 0:
            return {"velocity": {k: torch.zeros_like(p)
                                 for k, p in params.items()}}
        return {}

    def apply_update(self, grads, opt_state, params, lr):
        for k, g in grads.items():
            if self.momentum > 0:
                vel = opt_state["velocity"][k]
                vel.mul_(self.momentum).add_((1 - self.dampening) * g)
                g = g + self.momentum * vel if self.nesterov else vel
            params[k].sub_(lr * g)


class Adam(OptimMethod):
    """Reference ``optim/Adam.scala``: bias correction with ``t = step +
    1`` in float32."""

    def __init__(self, learningrate=1e-3, learningrate_decay=0.0,
                 beta1=0.9, beta2=0.999, epsilon=1e-8, weightdecay=0.0,
                 learningrate_schedule=None):
        super().__init__(learningrate,
                         learningrate_schedule or Default(learningrate_decay),
                         weightdecay)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_slots(self, params):
        return {"m": {k: torch.zeros_like(p) for k, p in params.items()},
                "v": {k: torch.zeros_like(p) for k, p in params.items()}}

    def apply_update(self, grads, opt_state, params, lr):
        b1, b2 = self.beta1, self.beta2
        t = (opt_state["step"] + 1).float()
        bc1 = 1 - torch.pow(b1, t)
        bc2 = 1 - torch.pow(b2, t)
        for k, g in grads.items():
            m, v = opt_state["m"][k], opt_state["v"][k]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            params[k].sub_(lr * (m / bc1)
                           / (torch.sqrt(v / bc2) + self.epsilon))


class AdamW(Adam):
    """Adam with decoupled weight decay: each parameter also moves by
    ``-lr * weightdecay * p`` of its value before the step (applied
    first, so no copy of the old weights is kept)."""

    @torch.no_grad()
    def update(self, grads, opt_state, params):
        lr = self.current_lr(opt_state)
        if self.weightdecay:
            for p in params.values():
                p.sub_(lr * self.weightdecay * p)
        self.apply_update(grads, opt_state, params, lr)
        opt_state["step"] += 1
        return params, opt_state
