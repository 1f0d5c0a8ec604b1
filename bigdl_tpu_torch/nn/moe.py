"""Mixture-of-experts FFN with top-k gating and expert parallelism (the
port of ``bigdl_tpu/nn/moe.py``: ``_topk_dispatch`` and ``MoE``).

Routing (:func:`topk_route`) is the reference's: ``k`` rounds of argmax
over the float32 gate probabilities (a tie goes to the first expert), each
round's pick removed before the next; a token's position in its expert's
buffer is the count of earlier tokens that picked that expert in this
round plus every pick of the earlier rounds (the reference's cursor), and
a token at a position past the capacity ``C = ceil(k * N * factor / E)``
is dropped for that choice.

The reference moves tokens with one-hot ``(N, E, C)`` products. A product
with a one-hot sums one nonzero term, so the port moves them by index
instead, with the same result: the kept tokens are written to their
``(expert, position)`` rows of an ``(E, C, d)`` buffer (``index_add`` into
zeros, one token a row), the experts run as two batched products with the
tanh GELU between, and each token gathers its rows back weighted by its
gates. A dropped choice adds nothing; a token dropped by every choice
gives a zero row.

The Switch load-balance loss ``E * sum_e f_e * P_e / k`` (``f_e`` the share
of the tokens routed to ``e`` and kept, ``P_e`` its mean probability) is
the layer's ``state["aux_loss"]`` after each forward; add about 1e-2 of it
to the objective.

Expert parallelism is single-controller, as sequence parallelism is
(``parallel/sequence.py``): ``expert_parallel=(axis, mesh)`` with ``mesh``
a list of ``ndev`` devices (one a shard; a device may repeat; an int
``ndev`` repeats this layer's device). ``forward`` then takes the list of
the shards' token blocks, one on each device, and returns theirs. Shard
``s`` holds experts ``[s * E / ndev, (s + 1) * E / ndev)`` (slices of the
global ``w1``/``w2`` copied to its device) and routes its own tokens at
its own capacity, as the reference's ``shard_map`` body does; the
reference's two ``all_to_all``s are copies in shard order, each expert's
buffer the source shards' rows concatenated in source order. ``state``
then holds each shard's aux loss in a list.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.device import resolve_device


def topk_route(probs, k, capacity):
    """The routing decisions of ``probs`` (N, E): a list of ``k``
    ``(expert, position, keep)`` triples of (N,) tensors (int64, int64,
    bool), one a choice (module docstring)."""
    n, e = probs.shape
    remaining = probs
    base = torch.zeros(e, dtype=torch.long, device=probs.device)
    out = []
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)
        onehot = F.one_hot(idx, e)
        before = torch.cumsum(onehot, dim=0) - onehot
        pos = before.gather(1, idx[:, None])[:, 0] + base[idx]
        out.append((idx, pos, pos < capacity))
        base = base + onehot.sum(0)
        remaining = remaining.masked_fill(onehot.bool(), 0.0)
    return out


class MoE(Module):
    """Top-k mixture-of-experts GELU MLP (module docstring).

    Input (B, T, d) or (N, d), output the same shape. ``wg`` (d, E) is
    drawn N(0, 0.02^2), ``w1`` (E, d, h) N(0, 2 / d), ``w2`` (E, h, d) N(0,
    2 / h), in the reference's layouts."""

    jax_perms = {"wg": None, "w1": None, "w2": None}

    def __init__(self, hidden_size, ffn_size, n_experts, k=2,
                 capacity_factor=1.25, expert_parallel=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        if k < 1 or k > n_experts:
            raise ValueError(f"k={k} outside [1, {n_experts}]")
        self.hidden_size = hidden_size
        self.ffn_size = ffn_size
        self.n_experts = n_experts
        self.k = k
        self.capacity_factor = capacity_factor
        device = resolve_device(device)
        if expert_parallel is not None:
            ndev = expert_parallel[1]
            ndev = ndev if isinstance(ndev, int) else len(ndev)
            if n_experts % ndev:
                raise ValueError(f"{n_experts} experts do not split over "
                                 f"{ndev} shards")
        self.expert_parallel = expert_parallel
        d, h, e = hidden_size, ffn_size, n_experts
        self.wg = nn.Parameter(torch.empty(d, e, device=device, dtype=dtype))
        self.w1 = nn.Parameter(torch.empty(e, d, h, device=device,
                                           dtype=dtype))
        self.w2 = nn.Parameter(torch.empty(e, h, d, device=device,
                                           dtype=dtype))
        self._aux = None

    @property
    def state(self):
        """``{"aux_loss": ...}`` of the last forward (module docstring)."""
        return {"aux_loss": self._aux}

    @property
    def mesh(self):
        """The expert-parallel shards' devices, or None."""
        if self.expert_parallel is None:
            return None
        m = self.expert_parallel[1]
        if isinstance(m, int):
            return [self.wg.device] * m
        return [resolve_device(d) for d in m]

    def capacity(self, n_tokens):
        """C = ceil(k * N * capacity_factor / E), at least 1."""
        return max(int(math.ceil(self.k * n_tokens * self.capacity_factor
                                 / self.n_experts)), 1)

    def regularized_leaves(self):
        return []

    def init_arrays(self, rng):
        d, h, e = self.hidden_size, self.ffn_size, self.n_experts
        return {"wg": rng.standard_normal((d, e)) * 0.02,
                "w1": rng.standard_normal((e, d, h)) * (2.0 / d) ** 0.5,
                "w2": rng.standard_normal((e, h, d)) * (2.0 / h) ** 0.5}

    def route(self, tokens, wg=None):
        """``(probs, decisions)`` of (N, d) ``tokens``: the float32 gate
        probabilities and :func:`topk_route`'s decisions at this layer's
        capacity for N tokens."""
        wg = self.wg if wg is None else wg
        probs = torch.softmax((tokens @ wg.to(tokens.dtype)).float(), dim=-1)
        with torch.no_grad():
            decisions = topk_route(probs, self.k,
                                   self.capacity(tokens.shape[0]))
        return probs, decisions

    def _experts(self, buf, w1, w2):
        """(E_local, C, d) -> (E_local, C, d): the batched GELU MLP."""
        h = F.gelu(torch.bmm(buf, w1.to(buf.dtype)), approximate="tanh")
        return torch.bmm(h, w2.to(buf.dtype))

    def _dispatch(self, tokens, probs, decisions):
        """The (E, C, d) buffer, each choice's (slot, gate weight) and the
        aux loss of one shard's tokens. A dropped choice writes to a spare
        last row, cut off after the writes."""
        n, d = tokens.shape
        cap = self.capacity(n)
        spare = self.n_experts * cap
        buf = tokens.new_zeros(spare + 1, d)
        routed = 0
        choices = []
        for idx, pos, keep in decisions:
            buf = buf.index_add(0, torch.where(keep, idx * cap + pos,
                                               spare), tokens)
            gate = probs.gather(1, idx[:, None])[:, 0]
            slot = torch.where(keep, idx * cap + pos, 0)
            choices.append((slot, (gate * keep).to(tokens.dtype)))
            routed = routed + (F.one_hot(idx, self.n_experts)
                               * keep[:, None]).sum(0)
        f = routed.to(probs.dtype) / n
        aux = self.n_experts * torch.sum(f * probs.mean(0)) / self.k
        return buf[:spare].reshape(self.n_experts, cap, d), choices, aux

    @staticmethod
    def _combine(out, choices):
        """Each token's gate-weighted sum of its choices' rows of ``out``
        (E, C, d)."""
        flat = out.reshape(-1, out.shape[-1])
        y = None
        for slot, w in choices:
            part = flat.index_select(0, slot) * w[:, None]
            y = part if y is None else y + part
        return y

    def forward(self, x, decisions=None):
        """``x`` through the layer: one input, or under expert parallelism
        the list of the shards' inputs. ``decisions`` replays a routing
        (:meth:`route`'s, one a shard under expert parallelism) in place
        of this input's own."""
        if self.expert_parallel is not None:
            return self._forward_shards(list(x), decisions)
        shape = x.shape
        tokens = x.reshape(-1, shape[-1])
        probs, own = self.route(tokens)
        buf, choices, aux = self._dispatch(
            tokens, probs, own if decisions is None else decisions)
        y = self._combine(self._experts(buf, self.w1, self.w2), choices)
        self._aux = aux
        return y.reshape(shape)

    def _forward_shards(self, xs, decisions=None):
        mesh = self.mesh
        if len(xs) != len(mesh):
            raise ValueError(f"an expert-parallel MoE takes one input a "
                             f"shard ({len(mesh)}), got {len(xs)}")
        counts = [x.reshape(-1, x.shape[-1]).shape[0] for x in xs]
        if len(set(counts)) != 1:
            # each shard's capacity comes from its own token count, and
            # the return trip slices every shard's rows at one capacity
            raise ValueError(f"an expert-parallel MoE takes the same number "
                             f"of tokens on every shard, got {counts}")
        ndev, e_loc = len(mesh), self.n_experts // len(mesh)
        bufs, plans = [], []
        for s, (x, dev) in enumerate(zip(xs, mesh)):
            tokens = x.reshape(-1, x.shape[-1])
            probs, own = self.route(tokens, self.wg.to(dev))
            buf, choices, aux = self._dispatch(
                tokens, probs, own if decisions is None else decisions[s])
            bufs.append(buf)
            plans.append((choices, aux))
        cap = bufs[0].shape[1]
        outs = []
        for t, dev in enumerate(mesh):
            # all_to_all: expert shard t gathers its experts' rows from
            # every source shard, in source order along C
            mine = torch.cat([b[t * e_loc:(t + 1) * e_loc].to(dev)
                              for b in bufs], dim=1)
            w1 = self.w1[t * e_loc:(t + 1) * e_loc].to(dev)
            w2 = self.w2[t * e_loc:(t + 1) * e_loc].to(dev)
            outs.append(self._experts(mine, w1, w2))
        ys = []
        for s, (x, dev) in enumerate(zip(xs, mesh)):
            # and back: source shard s takes its C rows of every expert
            out = torch.cat([o[:, s * cap:(s + 1) * cap].to(dev)
                             for o in outs], dim=0)
            ys.append(self._combine(out, plans[s][0]).reshape(x.shape))
        self._aux = [aux for _, aux in plans]
        return ys

    def extra_repr(self):
        return (f"{self.hidden_size} -> {self.ffn_size}, {self.n_experts} "
                f"experts, k={self.k}, capacity x{self.capacity_factor}")


__all__ = ["MoE", "topk_route"]
