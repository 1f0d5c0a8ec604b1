"""Rematerialisation (the port's ``jax.checkpoint``): recompute a
function's activations in the backward pass instead of storing them.

``torch.utils.checkpoint`` replays the default generators' random state
in the recomputation, but not an explicit ``torch.Generator`` such as the
one dropout draws from here. :func:`checkpoint` does that too: the
recomputation starts from the generator state the forward started from,
so it draws the same masks, and leaves the generator where it found it.
"""

from __future__ import annotations

import torch.utils.checkpoint


def checkpoint(fn, generator, *args):
    """``fn(*args, generator)`` under non-reentrant activation
    checkpointing; the recomputation replays ``generator``'s draws (see
    module docstring)."""
    if generator is None:
        return torch.utils.checkpoint.checkpoint(
            lambda *a: fn(*a, None), *args, use_reentrant=False)
    start = generator.get_state()
    ran = []

    def run(*a):
        if not ran:                   # the forward: draws advance the state
            ran.append(True)
            return fn(*a, generator)
        after = generator.get_state()  # the recomputation in backward
        generator.set_state(start)
        try:
            return fn(*a, generator)
        finally:
            generator.set_state(after)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)


def checkpoint_list(fn, generator, xs):
    """``fn(xs, generator)``, a function of a list of tensors that returns
    a list (one layer over a sequence-parallel group's shards), under
    :func:`checkpoint`."""
    def run(*args):
        return tuple(fn(list(args[:-1]), args[-1]))
    return list(checkpoint(run, generator, *xs))
