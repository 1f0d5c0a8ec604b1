"""Optimization methods (the port of ``bigdl_tpu/optim/methods.py``:
``OptimMethod`` with ``save``/``load``, ``SGD``, ``Adam``, ``AdamW``,
``Adagrad``, ``Adadelta``, ``Adamax``, ``RMSprop``, ``Ftrl`` and
``LBFGS``).

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
tensors computed there. With a ``Plateau`` schedule the state also holds
``plateau_mult`` (float32), which the optimizer facade writes after each
validation; the facade advances ``epoch`` at each epoch's end.
"""

from __future__ import annotations

import pickle

import torch

from bigdl_tpu_torch.optim.schedules import Default, Plateau
from bigdl_tpu_torch.utils.fileio import file_exists, file_open


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
        state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
                 "epoch": torch.ones((), dtype=torch.int32, device=dev),
                 **self.init_slots(params)}
        if isinstance(self.schedule, Plateau):
            state["plateau_mult"] = torch.ones((), dtype=torch.float32,
                                               device=dev)
        return state

    def init_slots(self, params):
        return {}

    def current_lr(self, opt_state):
        lr = self.schedule(self.learningrate, opt_state["step"],
                           opt_state["epoch"])
        if "plateau_mult" in opt_state:
            lr = torch.clamp_min(lr * opt_state["plateau_mult"],
                                 self.schedule.min_lr)
        return lr

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

    # -- persistence (reference OptimMethod.save/load) ----------------------
    def save(self, path, opt_state=None, overwrite=False):
        """Pickle ``{"method": self, "state": opt_state}`` to ``path``,
        the state's tensors as CPU copies, as the reference pickles its
        numpy state."""
        if file_exists(path) and not overwrite:
            raise FileExistsError(path)
        payload = {"method": self,
                   "state": None if opt_state is None
                   else cpu_copy(opt_state)}
        with file_open(path, "wb") as f:
            pickle.dump(payload, f)

    @staticmethod
    def load(path):
        """``(method, state)`` from a file of :meth:`save`; the state's
        tensors are on the CPU."""
        with file_open(path, "rb") as f:
            payload = pickle.load(f)
        return payload["method"], payload["state"]


def cpu_copy(tree):
    """A synchronous host copy of nested dicts of tensors (an optimizer
    state, a ``state_dict``): memory the next step cannot change."""
    if isinstance(tree, dict):
        return {k: cpu_copy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


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


class Adagrad(OptimMethod):
    """Reference ``optim/Adagrad.scala``: ``p -= lr * g / (sqrt(accum) +
    1e-10)`` with ``accum += g^2``."""

    def __init__(self, learningrate=1e-3, learningrate_decay=0.0,
                 weightdecay=0.0):
        super().__init__(learningrate, Default(learningrate_decay),
                         weightdecay)

    def init_slots(self, params):
        return {"accum": {k: torch.zeros_like(p) for k, p in params.items()}}

    def apply_update(self, grads, opt_state, params, lr):
        for k, g in grads.items():
            a = opt_state["accum"][k]
            a.add_(torch.square(g))
            params[k].sub_(lr * g / (torch.sqrt(a) + 1e-10))


class Adadelta(OptimMethod):
    """Reference ``optim/Adadelta.scala`` (learning rate 1)."""

    def __init__(self, decayrate=0.9, epsilon=1e-10):
        super().__init__(1.0)
        self.rho, self.epsilon = decayrate, epsilon

    def init_slots(self, params):
        return {"accum": {k: torch.zeros_like(p) for k, p in params.items()},
                "delta_accum": {k: torch.zeros_like(p)
                                for k, p in params.items()}}

    def apply_update(self, grads, opt_state, params, lr):
        rho, eps = self.rho, self.epsilon
        for k, g in grads.items():
            a, d = opt_state["accum"][k], opt_state["delta_accum"][k]
            a.mul_(rho).add_((1 - rho) * torch.square(g))
            delta = g * torch.sqrt(d + eps) / torch.sqrt(a + eps)
            d.mul_(rho).add_((1 - rho) * torch.square(delta))
            params[k].sub_(lr * delta)


class Adamax(OptimMethod):
    """Reference ``optim/Adamax.scala``: ``u = max(beta2 * u, |g| +
    eps)``, ``p -= lr / (1 - beta1^t) * m / u``."""

    def __init__(self, learningrate=2e-3, beta1=0.9, beta2=0.999,
                 epsilon=1e-38):
        super().__init__(learningrate)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_slots(self, params):
        return {"m": {k: torch.zeros_like(p) for k, p in params.items()},
                "u": {k: torch.zeros_like(p) for k, p in params.items()}}

    def apply_update(self, grads, opt_state, params, lr):
        b1 = self.beta1
        bc = 1 - torch.pow(b1, (opt_state["step"] + 1).float())
        for k, g in grads.items():
            m, u = opt_state["m"][k], opt_state["u"][k]
            m.mul_(b1).add_((1 - b1) * g)
            torch.maximum(self.beta2 * u, torch.abs(g) + self.epsilon,
                          out=u)
            params[k].sub_((lr / bc) * m / u)


class RMSprop(OptimMethod):
    """Reference ``optim/RMSprop.scala``: ``accum = rho * accum + (1 -
    rho) * g^2``, ``p -= lr * g / (sqrt(accum) + eps)``."""

    def __init__(self, learningrate=1e-2, learningrate_decay=0.0,
                 decayrate=0.99, epsilon=1e-8):
        super().__init__(learningrate, Default(learningrate_decay))
        self.rho, self.epsilon = decayrate, epsilon

    def init_slots(self, params):
        return {"accum": {k: torch.zeros_like(p) for k, p in params.items()}}

    def apply_update(self, grads, opt_state, params, lr):
        for k, g in grads.items():
            a = opt_state["accum"][k]
            a.mul_(self.rho).add_((1 - self.rho) * torch.square(g))
            params[k].sub_(lr * g / (torch.sqrt(a) + self.epsilon))


class Ftrl(OptimMethod):
    """Follow-the-regularized-leader, the reference's formulas."""

    def __init__(self, learningrate=1e-3, learningrate_power=-0.5,
                 initial_accumulator_value=0.1, l1_strength=0.0,
                 l2_strength=0.0):
        super().__init__(learningrate)
        self.lr_power = learningrate_power
        self.init_accum = initial_accumulator_value
        self.l1, self.l2 = l1_strength, l2_strength

    def init_slots(self, params):
        return {"accum": {k: torch.full_like(p, self.init_accum)
                          for k, p in params.items()},
                "linear": {k: torch.zeros_like(p)
                           for k, p in params.items()}}

    def apply_update(self, grads, opt_state, params, lr):
        lp = self.lr_power
        for k, g in grads.items():
            a, lin, p = opt_state["accum"][k], opt_state["linear"][k], \
                params[k]
            new_a = a + torch.square(g)
            sigma = (torch.pow(new_a, -lp) - torch.pow(a, -lp)) / lr
            lin.copy_(lin + g - sigma * p)
            quad = torch.pow(new_a, -lp) / lr + 2 * self.l2
            pre = torch.clamp(lin, -self.l1, self.l1) - lin
            p.copy_(pre / quad)
            a.copy_(new_a)


class LBFGS(OptimMethod):
    """Limited-memory BFGS (reference ``optim/LBFGS.scala``).

    :meth:`optimize` is the host-driven two-loop recursion over a history
    of (s, y) pairs on flat parameter vectors, with the fixed step of
    Torch's default (no line search), as in the reference. Inside the
    generic train step (``update``) it takes a plain gradient step, as the
    reference's does.
    """

    def __init__(self, max_iter=20, max_eval=None, tolfun=1e-5, tolx=1e-9,
                 ncorrection=100, learningrate=1.0):
        super().__init__(learningrate)
        self.max_iter = max_iter
        self.ncorrection = ncorrection
        self.tolfun, self.tolx = tolfun, tolx

    @torch.no_grad()
    def optimize(self, feval, x0):
        """``feval(x) -> (loss, grad)`` on flat tensors; returns ``(x,
        losses)``."""
        x = x0
        hist_s, hist_y = [], []
        loss, g = feval(x)
        losses = [float(loss)]
        for _ in range(self.max_iter):
            q = g
            alphas = []
            for s, y in zip(reversed(hist_s), reversed(hist_y)):
                rho = 1.0 / (torch.dot(y, s) + 1e-10)
                alpha = rho * torch.dot(s, q)
                q = q - alpha * y
                alphas.append((alpha, rho))
            if hist_s:
                s, y = hist_s[-1], hist_y[-1]
                q = q * (torch.dot(s, y) / (torch.dot(y, y) + 1e-10))
            for (alpha, rho), (s, y) in zip(reversed(alphas),
                                            zip(hist_s, hist_y)):
                beta = rho * torch.dot(y, q)
                q = q + (alpha - beta) * s
            x_new = x + self.learningrate * -q
            loss_new, g_new = feval(x_new)
            s, y = x_new - x, g_new - g
            if float(torch.dot(s, y)) > 1e-10:
                hist_s.append(s)
                hist_y.append(y)
                if len(hist_s) > self.ncorrection:
                    hist_s.pop(0)
                    hist_y.pop(0)
            done = abs(float(loss_new) - float(loss)) < self.tolfun
            x, loss, g = x_new, loss_new, g_new
            losses.append(float(loss))
            if done:
                break
        return x, losses

    def apply_update(self, grads, opt_state, params, lr):
        for k, g in grads.items():
            params[k].sub_(lr * g)
