"""Tensor-parallel paged GPT serving: one shard module per device, driven
by one host thread (the port of what GSPMD does for the reference's
``ServingEngine(tp=N)``; there is no reference module to mirror).

:class:`TensorParallelCausalLM` splits a ``GPTForCausalLM`` over a
``parallel.layout.ModelLayout``: shard ``i`` is a ``GPTForCausalLM(tp=N)``
on ``layout.devices[i]`` holding ``n_heads / N`` of the heads (their
``wq``/``wk``/``wv`` rows and ``wo`` columns), ``intermediate / N`` of the
MLP's inner width (``fc1`` rows and bias, ``fc2`` columns) and, where the
vocabulary divides by N, ``vocab / N`` rows of the token embedding;
everything else is a whole copy. Its ``gpt`` (:class:`TensorParallelGPT`)
serves the interface ``serving.paging.PagedSlotManager`` calls:
``init_paged_pool``, ``paged_prefill_chunk``, ``paged_decode_step``,
``pool_planes`` (for copying a page in every shard and counting bytes),
and ``_lm_logits`` on the model.

The paged paths are ``models.gpt``'s own (``paged_chunk_states``,
``paged_step_states``, ``TransformerDecoderBlock.paged_layer``), run over
the shards: per layer, with ``all_reduce_sum`` summing on the first
shard's device in shard order and copying the one result to every shard
(the same bits everywhere),

- each shard writes its heads' K/V into its own pools and computes its
  queries; one ``ops.paged_attention`` call with ``mesh=`` launches the
  paged-attention kernel once per shard, on the shard's own contiguous
  pool, with no collective (the attention is head-local);
- ``x += all_reduce_sum(wo partials)``;
- ``x += all_reduce_sum(fc2 partials) + fc2.bias``: the replicated bias is
  added once, after the sum, as GSPMD does.

Replicated work (the LayerNorms, GELU's input, the residual stream) runs
on every shard on identical inputs, so the shards keep identical bits;
the final LayerNorm and the LM head run once, on the first shard's
device, where the serving logits table lives. A vocabulary-split
embedding is a masked lookup on each shard plus ``all_reduce_sum``
(exact: one partial is nonzero); the tied head is then vocab-parallel,
the shards' logit columns gathered on the first shard's device. A
replicated vocabulary (GPT-2's 50257 at tp 2 or 4) is looked up on each
shard and projected once.

The source model is only read: its state dict is split and copied to
the shards' devices. Build it on the CPU (``device="cpu"``) so that no
card holds a whole copy beside the shards.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.models.gpt import (GPT, GPTForCausalLM, last_valid,
                                        paged_chunk_states,
                                        paged_step_states)
from bigdl_tpu_torch.parallel.layout import broadcast, gather


class TensorParallelGPT(nn.Module):
    """The decoder stack over its shards (``GPTForCausalLM(tp=N)``
    modules, one per ``layout.devices`` entry); see module docstring.
    Pools are per shard, then per layer: ``pools[shard][layer]``."""

    def __init__(self, shards, layout, vocab_size):
        super().__init__()
        self.shards = nn.ModuleList(shards)
        self.layout = layout
        self.vocab_size = vocab_size
        first = shards[0].gpt
        self.max_position = first.max_position
        self.hidden_size = first.hidden_size
        self.vocab_rows = first.vocab_size
        self.vocab_split = self.vocab_rows != vocab_size

    # the unsharded GPT's read-only surface, from the first shard: the
    # configuration (layer count, ``attn.n_heads``, ``attn.head_dim``) and
    # the parameter type
    @property
    def layers(self):
        return self.shards[0].gpt.layers

    @property
    def tok_emb(self):
        return self.shards[0].gpt.tok_emb

    @property
    def device(self):
        return self.layout.devices[0]

    def _gpts(self):
        return [s.gpt for s in self.shards]

    def init_paged_pool(self, num_pages, page_size, dtype=None):
        """Each shard's per-layer pools, on its device, holding its heads:
        every plane a tensor of its own (the kernel takes only contiguous
        pools)."""
        return [g.init_paged_pool(num_pages, page_size, dtype)
                for g in self._gpts()]

    @staticmethod
    def pool_planes(pools):
        """Every tensor of ``pools``, per shard."""
        return [GPT.pool_planes(p)[0] for p in pools]

    def paged_prefill_chunk(self, pools, page_table, ids, start, nvalid,
                            write_from, page_size):
        """``GPT.paged_prefill_chunk`` over the shards: returns ``(h_last,
        pools)``, ``h_last`` (W, hidden) on the first shard's device."""
        h = paged_chunk_states(self._gpts(), pools, page_table, ids, start,
                               nvalid, write_from, page_size,
                               self.layout.devices, self.vocab_split)
        return last_valid(h, nvalid), pools

    def paged_decode_step(self, pools, page_table, tok, pos, page_size):
        """``GPT.paged_decode_step`` over the shards: returns the (B,
        hidden) final-norm states on the first shard's device and the
        pools."""
        return paged_step_states(self._gpts(), pools, page_table, tok, pos,
                                 page_size, self.layout.devices,
                                 self.vocab_split), pools

    def lm_logits(self, h):
        """(..., hidden) on the first shard's device -> (..., vocab) there,
        through the tied head: vocab-parallel when the embedding is split,
        else one product on the first shard."""
        if not self.vocab_split:
            return F.linear(h, self.tok_emb)
        hs = broadcast(h, self.layout.devices)
        return gather([F.linear(x, g.tok_emb)
                       for x, g in zip(hs, self._gpts())], -1)


class TensorParallelCausalLM(nn.Module):
    """``model`` (a ``GPTForCausalLM`` with its weights loaded) split over
    ``layout`` (``parallel.layout.ModelLayout``) for paged serving; see
    module docstring."""

    def __init__(self, model, layout):
        super().__init__()
        gpt = model.gpt
        attn = gpt.layers[0].attn
        layout.validate_heads(attn.n_heads)
        shards = []
        for dev, sd in zip(layout.devices,
                           layout.shard_state_dict(model.state_dict())):
            shard = GPTForCausalLM(
                vocab_size=sd["gpt.tok_emb"].shape[0],
                hidden_size=gpt.hidden_size, n_layers=len(gpt.layers),
                n_heads=attn.n_heads, max_position=gpt.max_position,
                intermediate_size=gpt.intermediate_size, tp=layout.tp,
                device=dev, dtype=gpt.tok_emb.dtype)
            shard.load_state_dict(sd)
            shards.append(shard)
        self.layout = layout
        self.vocab_size = model.vocab_size
        self.gpt = TensorParallelGPT(shards, layout, model.vocab_size)

    @property
    def device(self):
        return self.layout.devices[0]

    def _lm_logits(self, h):
        return self.gpt.lm_logits(h)


__all__ = ["TensorParallelGPT", "TensorParallelCausalLM"]
