"""Gradient clipping and the single-device train step (the port of
``bigdl_tpu/optim/optimizer.py``: ``clip_by_global_norm``,
``clip_by_value`` and ``make_train_step``; ``make_train_loop`` and the
``Optimizer``/``LocalOptimizer`` facade wait for ROADMAP A.9).

Gradients are dicts of tensors keyed by parameter name, as in
``optim/methods.py``. PyTorch runs eagerly, so a step is a Python function
and not a compiled program: forward, backward, clipping and the in-place
update run one after another on the card.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from bigdl_tpu_torch.utils.remat import checkpoint


def clip_by_global_norm(grads, max_norm):
    """``grads`` scaled by ``min(1, max_norm / (norm + 1e-12))``, ``norm``
    the L2 norm of all of them together."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads.values()))
    scale = torch.clamp_max(max_norm / (norm + 1e-12), 1.0)
    return {k: g * scale for k, g in grads.items()}


def clip_by_value(grads, min_value, max_value):
    return {k: torch.clamp(g, min_value, max_value) for k, g in grads.items()}


def make_loss_and_grads(module, criterion, compute_dtype=None, remat=False,
                        accumulate_steps=1):
    """``fn(x, y, generator=None) -> (loss, grads)``: the loss of
    ``criterion(module(x), y)`` in training mode and the gradient of every
    parameter of ``module`` (float32 master weights; the port of the
    reference's ``_loss_and_grads`` with ``scan_microbatches``).

    - ``compute_dtype`` (e.g. ``torch.bfloat16``): the forward runs on a
      cast view of the parameters through ``torch.func.functional_call``;
      the cast is differentiated, so the gradients come back float32, and
      the outputs are cast to float32 before the criterion;
    - ``remat=True``: the whole forward is recomputed in the backward pass;
    - ``accumulate_steps=K``: the batch rows split into K micro-batches
      (K must divide them); gradients and losses are averaged over them.
    """
    params = dict(module.named_parameters())

    def forward(x, generator):
        if compute_dtype is None:
            return module(x, generator=generator)
        cast = {k: p.to(compute_dtype) for k, p in params.items()}
        return functional_call(module, cast, (x,),
                               {"generator": generator}).float()

    def loss_and_grads(x, y, generator=None):
        module.train()
        for p in params.values():
            p.grad = None
        k = accumulate_steps
        if x.shape[0] % k:
            raise ValueError(f"accumulate_steps={k} does not divide the "
                             f"batch of {x.shape[0]} rows")
        xs = x.reshape(k, x.shape[0] // k, *x.shape[1:])
        ys = y.reshape(k, y.shape[0] // k, *y.shape[1:])
        total = 0.0
        for i in range(k):
            out = (checkpoint(forward, generator, xs[i]) if remat
                   else forward(xs[i], generator))
            loss = criterion(out, ys[i])
            loss.backward()
            total = total + loss.detach()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        if k > 1:
            grads = {n: g / k for n, g in grads.items()}
            total = total / k
        return total, grads

    return loss_and_grads


def make_train_step(module, criterion, optim_method, clipping=None,
                    compute_dtype=None, remat=False, accumulate_steps=1):
    """The single-device train step ``step(opt_state, x, y,
    generator=None) -> loss``: loss and gradients as
    :func:`make_loss_and_grads` computes them, then ``clipping(grads)``
    if given, then ``optim_method.update``, which changes ``module``'s
    parameters and ``opt_state`` in place. ``opt_state`` comes from
    ``optim_method.init_state(dict(module.named_parameters()))``; the
    labels ``y`` are as the criterion takes them (flattened (B*T,) for a
    GPT)."""
    loss_and_grads = make_loss_and_grads(module, criterion, compute_dtype,
                                         remat, accumulate_steps)
    params = dict(module.named_parameters())

    def step(opt_state, x, y, generator=None):
        loss, grads = loss_and_grads(x, y, generator)
        if clipping is not None:
            grads = clipping(grads)
        optim_method.update(grads, opt_state, params)
        return loss

    return step
