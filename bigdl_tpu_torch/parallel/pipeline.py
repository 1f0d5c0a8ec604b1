"""Pipeline parallelism: GPipe microbatching over a list of stage devices
(the port of ``bigdl_tpu/parallel/pipeline.py``: ``pipeline_apply`` and
``make_pipeline_train_step``).

The reference runs one SPMD program: every device of a ``pipe`` mesh axis
is a stage, and a ``lax.scan`` over ``n_micro + n_stages - 1`` ticks hands
each stage's output to the next with ``ppermute``; the bubble ticks run on
clipped inputs and write nothing. The port is single-controller, as its
other parallel forms are (``parallel/sequence.py``): a mesh is a list of
devices, one a stage (a device may repeat), each stage holds its own copy
of the stage module and its parameters on its device, and one thread
walks the same ticks, stage ``s`` running microbatch ``t - s`` at tick
``t`` and handing its output to stage ``s + 1`` by a copy. The bubble
ticks are skipped: they write nothing in the reference either. Autograd
differentiates the whole schedule, each stage's gradient landing on its
device, so the loss and gradients are the sequential oracle's: the stages
applied in turn to each microbatch, one criterion call over all of them.

Stages are structurally identical (one ``stage_module`` and its
parameters stacked with a leading ``(n_stages,)`` axis), as in the
reference. A stage's parameters are its own tensors: on one card
``.to(device)`` aliases, so each stage's are cloned, never views of the
stacked input or of another stage's.
"""

from __future__ import annotations

import copy

import torch
from torch.func import functional_call

from bigdl_tpu_torch.utils.device import resolve_device


def pipeline_apply(stage_fns, xs):
    """The GPipe schedule over microbatches (module docstring):
    ``stage_fns`` one callable a stage (``fn(x) -> y``, ``y`` of ``x``'s
    shape), ``xs`` the (n_micro, micro_batch, ...) stream, or a list of
    microbatches. Returns the last stage's outputs stacked as ``xs``, on
    the last stage's device, with ``devices[s]`` the device stage ``s``
    takes its input on (``stage_fns[s].device`` where it has one, else
    the input's)."""
    n_stages, n_micro = len(stage_fns), len(xs)
    devices = [getattr(fn, "device", None) for fn in stage_fns]
    held = [None] * n_stages             # the activation a stage takes next
    outs = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        # the later stages first, so each reads what the earlier one
        # handed over at the previous tick
        for s in reversed(range(n_stages)):
            m = t - s
            if not 0 <= m < n_micro:
                continue
            x = xs[m] if s == 0 else held[s]
            if devices[s] is not None:
                x = x.to(devices[s])
            y = stage_fns[s](x)
            if s + 1 < n_stages:
                held[s + 1] = y
            else:
                outs[m] = y
    return torch.stack(outs)


class _Stage:
    """One stage: its module copy, run on the parameters it is given."""

    def __init__(self, module, device):
        self.module = module
        self.device = device
        self.params = None

    def __call__(self, x):
        return functional_call(self.module, self.params, (x,))


def make_pipeline_train_step(stage_module, criterion, optim_method, mesh,
                             axis="pipe", n_micro=4):
    """The pipeline-parallel train step (module docstring). ``mesh`` is the
    stages' devices, one a stage (``axis`` names it, as in the
    reference). Returns ``factory(stacked_params) -> (step,
    sharded_params, sharded_opt_state)``:

    - ``stacked_params``: ``{name: (n_stages, ...) tensor}`` over
      ``stage_module``'s parameter names, in the port's layouts
      (``convert.pipeline_params_from_jax`` makes it from the
      reference's stacked tree);
    - ``sharded_params``: one ``{name: parameter}`` a stage on its device,
      its own copies; ``sharded_opt_state``: one ``optim_method`` state a
      stage, over that stage's parameters (the scalar counters are each
      stage's copy, replicated as in the reference);
    - ``step(sharded_params, sharded_opt_state, xs, ys) -> (params,
      opt_state, loss)``: ``xs``/``ys`` (n_micro, micro_batch, ...); the
      loss is ``criterion`` over the last stage's outputs of every
      microbatch against ``ys``, both flattened to (n_micro *
      micro_batch, ...); each stage updates its own parameters and slots
      in place, and the same objects come back."""
    devices = [resolve_device(d) for d in mesh]
    if not devices:
        raise ValueError("a pipeline needs at least one stage device")

    def factory(stacked_params):
        stages, params, opt_states = [], [], []
        for s, dev in enumerate(devices):
            module = copy.deepcopy(stage_module).to(dev)
            mine = {k: torch.nn.Parameter(
                v[s].detach().to(dev, copy=True).contiguous())
                for k, v in stacked_params.items()}
            stages.append(_Stage(module, dev))
            params.append(mine)
            opt_states.append(optim_method.init_state(mine))

        def step(sharded_params, sharded_opt_state, xs, ys):
            if len(xs) != n_micro:
                raise ValueError(f"the step takes {n_micro} microbatches, "
                                 f"got {len(xs)}")
            for stage, p in zip(stages, sharded_params):
                stage.params = p
            with torch.enable_grad():
                outs = pipeline_apply(stages, xs)
                y = ys.to(outs.device)
                loss = criterion(outs.reshape((-1,) + outs.shape[2:]),
                                 y.reshape((-1,) + y.shape[2:]))
                leaves = [t for p in sharded_params for t in p.values()]
                grads = iter(torch.autograd.grad(loss, leaves))
            for p, opt in zip(sharded_params, sharded_opt_state):
                optim_method.update({k: next(grads) for k in p}, opt, p)
            return sharded_params, sharded_opt_state, loss.detach()

        return step, params, opt_states

    return factory


__all__ = ["make_pipeline_train_step", "pipeline_apply"]
