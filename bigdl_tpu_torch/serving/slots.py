"""Slot table and per-slot token selection (the port of ``bigdl_tpu/
serving/slots.py``: ``select_tokens`` and the host-side parts of
``SlotManager`` that the paged manager inherits).

Only the paged manager (``serving/paging.py``) is ported; the dense
``SlotManager`` with its preallocated (slots, max_position) cache is
still to be ported (ROADMAP queue A).
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from bigdl_tpu_torch.ops.sampling import fused_sample_logits, gumbel_noise


def select_tokens(logits, temps, generator, top_k, top_p):
    """Per-slot greedy/sampled selection over (S, V) device ``logits``.

    ``temps`` is the host (S,) float32 temperature table. Greedy rows
    take ``torch.argmax`` (first index on ties, like ``jnp.argmax``).
    When any row samples, one gumbel draw from ``generator`` feeds the
    fused sampling kernel for the whole batch and the sampled rows take
    its tokens; an all-greedy batch launches no sampling work at all (the
    reference's ``lax.cond`` is this host-side check). Returns (S,) int32
    tokens on the logits' device."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    sampled_rows = temps > 0.0
    if not sampled_rows.any():
        return greedy
    dev = logits.device
    gumbel = gumbel_noise(logits.shape, generator, dev, logits.dtype)
    t = torch.from_numpy(np.maximum(temps, 1e-6).astype(np.float32)).to(dev)
    sampled = fused_sample_logits(logits, gumbel, t, top_k, top_p)
    return torch.where(torch.from_numpy(sampled_rows).to(dev), sampled,
                       greedy)


class SlotManager:
    """Host-side slot table over ``max_slots`` decode rows: per-slot
    ``lengths``/``active``/``temps``, a lowest-first free heap and an
    occupancy counter. Subclasses own the device state and dispatches.

    Thread model: NOT thread-safe — exactly one thread (the scheduler
    loop) mutates it; :meth:`occupancy` and :meth:`free_slots` read
    plain integers and are safe from any thread."""

    paged = False

    def __init__(self, model, max_slots, window=4, steps_per_sync=1,
                 top_k=None, top_p=None, seed=0):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.model = model
        self.device = model.device
        self.max_slots = int(max_slots)
        self.window = max(1, min(int(window), self.max_slots))
        self.steps_per_sync = max(1, int(steps_per_sync))
        self.block_span = self.steps_per_sync
        self.top_k = top_k
        self.top_p = top_p
        self.max_position = model.gpt.max_position
        self._seed = int(seed)
        self._alloc()

    def _alloc(self):
        self.lengths = np.zeros(self.max_slots, np.int32)
        self.active = np.zeros(self.max_slots, bool)
        self.temps = np.zeros(self.max_slots, np.float32)
        self._free = list(range(self.max_slots))   # heap: lowest slot first
        self._occupied = 0

    def free_slots(self):
        return self.max_slots - self._occupied

    def occupancy(self):
        """Active slot count (an owner-maintained integer)."""
        return self._occupied

    def retire(self, slot):
        """Free a slot row (host bookkeeping only)."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        self.active[slot] = False
        self.lengths[slot] = 0
        self.temps[slot] = 0.0
        heapq.heappush(self._free, int(slot))
        self._occupied -= 1
