"""Tensor-parallel layout: which dimension of each tensor is split over
the shards, the devices the shards live on, and the three collectives the
sharded model needs (the port of ``bigdl_tpu/parallel/layout.py`` without
its training mesh, ``build_mesh``).

The reference names a 1-axis ``("tp",)`` device mesh and lets GSPMD place
every tensor and insert the collectives. The port is single-controller in
the same way: one host thread drives every shard. Here:

- :class:`SpecLayout` is the reference's per-role table, written for
  torch's ``(out, in)`` Linear layout: each role names the torch dimension
  it splits over tp, or None (replicated). Megatron-style: QKV and FFN-up
  are column-parallel (their output dim), attention-output and FFN-down
  row-parallel (their input dim); the token embedding splits its vocab
  rows; the K/V pools and the int8 scale planes split their head axis, so
  one host page table drives every shard.
- :class:`ModelLayout` binds the table to a list of devices, one per
  shard (a device may repeat: several shards on one card). It fits a role
  to a real shape (the reference's replicate fallback: a vocab of 61 at
  tp=2 stays whole) and splits state dicts.
- :func:`serving_mesh` takes the first ``tp`` cards.
- :func:`all_reduce_sum`, :func:`gather` and :func:`broadcast` take the
  place of GSPMD's psum and all-gather. The sum adds the parts on the
  first shard's device in shard order, then copies the one result to
  every other shard's device, so every shard holds the same bits (a
  replicated residual stream summed in a different order on each shard
  would drift apart). On one card the copies are no-ops; across cards
  they are device-to-device copies.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.utils.device import broadcast, resolve_device


class SpecLayout:
    """Per-role split dimension over tp (None: replicated).

    ========================  =====================  =========
    role                      torch shape            split dim
    ========================  =====================  =========
    embeddings (tok_emb)      (vocab, H)             0
    position embeddings       (max_pos, H)           None
    QKV projection            (heads*D, H)           0
    attention output (wo)     (H, heads*D)           1
    FFN up (fc1.weight)       (4H, H)                0
    FFN up bias               (4H,)                  0
    FFN down (fc2.weight)     (H, 4H)                1
    FFN down bias / norms     --                     None
    paged K/V pool            (pages, heads, ps, D)  1
    int8 pool scale plane     (pages, heads, ps)     1
    ========================  =====================  =========

    The reference's untied LM head and its replicated serving logits
    table have no role here: the port's head is tied, and its logits
    table lives on the first shard's device only.

    Why this is exact for temperature-0 serving, as in the reference: the
    vocab-split embedding sums one nonzero partial per token; the tied
    logits contract over the replicated hidden axis (no reduction); and
    attention never contracts over the head axis. Only the two row-parallel
    sums (after ``wo`` and ``fc2``) reorder float additions.
    """

    def embeddings(self):
        return 0

    def position_embeddings(self):
        return None

    def qkv_projection(self):
        return 0

    def attention_output(self):
        return 1

    def ffn_up(self):
        return 0

    def ffn_up_bias(self):
        return 0

    def ffn_down(self):
        return 1

    def norm(self):
        return None

    def kv_pool(self):
        return 1

    def kv_pool_scale(self):
        return 1


# ------------------------------------------------------------------ meshes
def serving_mesh(tp):
    """The first ``tp`` visible cards, one per shard."""
    tp, have = int(tp), torch.cuda.device_count()
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if tp > have:
        raise ValueError(
            f"mesh needs {tp} device(s) but only {have} are visible; pass "
            f"mesh=[...] with one device per shard (a device may repeat, "
            f"placing several shards on one card)")
    return [torch.device("cuda", i) for i in range(tp)]


# ------------------------------------------------------------- collectives
def reduce_sum(parts):
    """Sum of the per-shard ``parts`` on the first part's device, added in
    shard order."""
    root = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(root)
    return total


def all_reduce_sum(parts):
    """:func:`reduce_sum` of ``parts``, the same bits on every shard's
    device."""
    return broadcast(reduce_sum(parts), [p.device for p in parts])


def gather(parts, dim):
    """The per-shard ``parts`` concatenated along ``dim`` on the first
    part's device."""
    root = parts[0].device
    return torch.cat([p.to(root) for p in parts], dim)


# ------------------------------------------------------------------ layout
class ModelLayout:
    """A :class:`SpecLayout` bound to the shards' devices (a sequence,
    one per shard; a device may repeat).

    The single-device path passes no layout at all; an active layout
    splits the weights and the K/V pools ``tp`` ways."""

    def __init__(self, devices):
        devices = [resolve_device(d) for d in devices]
        if not devices:
            raise ValueError("ModelLayout needs at least one device")
        self.devices = devices
        self.spec = SpecLayout()

    @property
    def tp(self):
        """Tensor-parallel degree: the number of shards."""
        return len(self.devices)

    def describe(self):
        """Flat summary for metrics and logs."""
        return {"tp_degree": self.tp,
                "distinct_devices": len(set(self.devices)),
                "shard_devices": [str(d) for d in self.devices]}

    def validate_heads(self, n_heads):
        """The K/V head axis must divide exactly: a silent replicate
        fallback there would erase the whole memory win."""
        if int(n_heads) % self.tp:
            raise ValueError(
                f"tensor-parallel serving shards the K/V head axis: "
                f"n_heads ({n_heads}) must be divisible by tp "
                f"({self.tp})")

    def fit(self, dim, shape):
        """The split dimension of a role (``dim``, from :class:`SpecLayout`)
        for a real ``shape``: None when the role is replicated, tp is 1,
        or ``shape[dim]`` does not divide by tp (the replicate fallback;
        the K/V head axis never takes it: :meth:`validate_heads`)."""
        if dim is None or self.tp == 1 or dim >= len(shape):
            return None
        return None if shape[dim] % self.tp else dim

    def split(self, t, dim):
        """``t`` cut into ``tp`` equal parts along ``dim`` (or copied
        whole when ``dim`` is None), part ``i`` on shard ``i``'s device.
        Every part is a contiguous tensor of its own, never a view."""
        parts = ([t] * self.tp if dim is None
                 else t.chunk(self.tp, dim))
        return [p.detach().to(d, memory_format=torch.contiguous_format,
                              copy=True)
                for p, d in zip(parts, self.devices)]

    def split_pool(self, pool):
        """One layer's whole K/V pool (``{"k", "v"}`` and an int8 pool's
        scale planes) as one pool per shard, every plane cut on its head
        axis into tensors of their own (the serving path allocates each
        shard's pool directly; this is for checking it against a whole
        one)."""
        parts = {name: self.split(v, self.spec.kv_pool() if v.dim() == 4
                                  else self.spec.kv_pool_scale())
                 for name, v in pool.items()}
        return [{name: p[i] for name, p in parts.items()}
                for i in range(self.tp)]

    def split_dims(self, state_dict):
        """``{name: split dim or None}`` of a GPT ``state_dict``: the
        model's roles (``models.gpt.partition_specs``) fitted to the real
        shapes."""
        # models.gpt imports this module for SpecLayout
        from bigdl_tpu_torch.models.gpt import partition_specs
        specs = partition_specs(state_dict)
        return {name: self.fit(specs[name], tuple(t.shape))
                for name, t in state_dict.items()}

    def shard_state_dict(self, state_dict):
        """One state_dict per shard, on its device, each tensor split on
        its :meth:`split_dims` dimension."""
        dims = self.split_dims(state_dict)
        shards = [{} for _ in self.devices]
        for name, t in state_dict.items():
            for sd, part in zip(shards, self.split(t, dims[name])):
                sd[name] = part
        return shards


__all__ = ["SpecLayout", "ModelLayout", "serving_mesh", "reduce_sum",
           "all_reduce_sum", "gather", "broadcast"]
