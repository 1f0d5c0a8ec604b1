"""Tensor-parallel GPT serving, dense and paged: one shard module per
device, driven by one host thread (the port of what GSPMD does for the
reference's ``ServingEngine(tp=N)``; there is no reference module to
mirror).

:class:`TensorParallelCausalLM` splits a ``GPTForCausalLM`` over a
``parallel.layout.ModelLayout``: shard ``i`` is a ``GPTForCausalLM(tp=N)``
on ``layout.devices[i]`` holding ``n_heads / N`` of the heads (their
``wq``/``wk``/``wv`` rows and ``wo`` columns), ``intermediate / N`` of the
MLP's inner width (``fc1`` rows and bias, ``fc2`` columns) and, where the
vocabulary divides by N, ``vocab / N`` rows of the token embedding and of
an untied LM head (``tie_embeddings=False``); everything else is a whole
copy. An int8 model (``nn.quantize_model``, quantised before it is split,
as the reference quantises before it shards) splits each ``Int8Linear``'s int8 ``weight`` and its ``scale``
by the same rules: a column-parallel layer's scales with its rows, a
row-parallel layer's scales whole. Its ``gpt`` (:class:`TensorParallelGPT`)
serves the interfaces ``serving.slots.SlotManager`` (``init_cache``,
``prefill``, ``decode_step``, ``decode_chunk``, ``cache_planes``) and
``serving.paging.PagedSlotManager`` (``init_paged_pool``,
``paged_prefill_chunk``, ``paged_decode_step``, ``paged_verify_chunk``,
``pool_planes``, for copying a page in every shard and counting bytes)
call, and ``_lm_logits`` on the model.

The dense and paged paths are ``models.gpt``'s own
(``dense_prefill_states``, ``dense_step_states``, ``dense_chunk_states``,
``paged_chunk_states``, ``paged_step_states``, one layer body
``block_rest``), run over the shards: per layer, with the sums taken on
the first shard's device in shard order and the one result copied to every
shard (the same bits everywhere),

- each shard writes its heads' K/V into its own caches or pools and
  attends over its heads: the dense path in plain PyTorch, the paged
  path through one ``ops.paged_attention`` call with ``mesh=``, which
  launches the paged-attention kernel once per shard, on the shard's own
  contiguous pool, with no collective (the attention is head-local);
- ``x += sum(wo partials)``;
- ``x += sum(fc2 partials) + fc2.bias``: the replicated bias is added
  once, after the sum, as GSPMD does. For int8 weights both sums are
  ``nn.quantized.qmatmul_row_parallel``: one amax over the shards, the
  int32 accumulators summed, one dequantising multiply.

Replicated work (the LayerNorms, GELU's input, the residual stream) runs
on every shard on identical inputs, so the shards keep identical bits;
the final LayerNorm and the LM head run once, on the first shard's
device, where the serving logits table lives. A vocabulary-split
embedding is a masked lookup on each shard plus ``all_reduce_sum``
(exact: one partial is nonzero); the head, tied or untied, is then
vocab-parallel, the shards' logit columns gathered on the first shard's
device. A replicated vocabulary (GPT-2's 50257 at tp 2 or 4) is looked up
on each shard and projected once, by the first shard's copy of the
head.

A speculative verify chunk (``decode_chunk``, ``paged_verify_chunk``) is
split by head like any chunk; the draft and the acceptance run once, on
the first shard's device, where the logits are.

Every cache method takes an optional ``lora``: the dispatch's LoRA slab
trees, one a shard, each holding the shard's part of every slab
(``models.lora.split_slab``: B's output columns of a column-parallel
target, A's input rows of a row-parallel one). A column-parallel
target's delta needs no copy between shards; a row-parallel one's copies
only its rank-r partials ``x_i @ A_i`` to the first shard, where they are
summed and B is applied once (``models.gpt._row_parallel``).

The source model is only read: its state dict is split and copied to
the shards' devices. Build it on the CPU (``device="cpu"``) so that no
card holds a whole copy beside the shards.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.models.gpt import (GPT, GPTForCausalLM,
                                        dense_chunk_states,
                                        dense_prefill_states,
                                        dense_step_states, last_valid,
                                        paged_chunk_states,
                                        paged_step_states, verify_args)
from bigdl_tpu_torch.nn.quantized import Int8Linear, quantize_model
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

    def init_cache(self, batch, dtype=None):
        """Each shard's per-layer dense K/V buffers, on its device, holding
        its heads."""
        return [g.init_cache(batch, dtype) for g in self._gpts()]

    @staticmethod
    def cache_planes(caches):
        """Every tensor of ``caches``, per shard."""
        return [GPT.cache_planes(c)[0] for c in caches]

    def prefill(self, caches, ids, prompt_len, rows=None, lora=None):
        """``GPT.prefill`` over the shards: returns ``(h_last, caches)``,
        ``h_last`` (B, hidden) on the first shard's device."""
        h = dense_prefill_states(self._gpts(), caches, ids, rows,
                                 self.layout.devices, self.vocab_split, lora)
        return last_valid(h, prompt_len), caches

    def decode_step(self, caches, tok, pos, lora=None):
        """``GPT.decode_step`` over the shards: returns the (B, hidden)
        final-norm states on the first shard's device and the caches."""
        return dense_step_states(self._gpts(), caches, tok, pos,
                                 self.layout.devices,
                                 self.vocab_split, lora), caches

    def decode_chunk(self, caches, toks, pos, lora=None):
        """``GPT.decode_chunk`` over the shards: returns the (B, C, hidden)
        final-norm states on the first shard's device and the caches."""
        return dense_chunk_states(self._gpts(), caches, toks, pos,
                                  self.layout.devices,
                                  self.vocab_split, lora), caches

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
                            write_from, page_size, lora=None):
        """``GPT.paged_prefill_chunk`` over the shards: returns ``(h_last,
        pools)``, ``h_last`` (W, hidden) on the first shard's device."""
        h = paged_chunk_states(self._gpts(), pools, page_table, ids, start,
                               nvalid, write_from, page_size,
                               self.layout.devices, self.vocab_split, lora)
        return last_valid(h, nvalid), pools

    def paged_decode_step(self, pools, page_table, tok, pos, page_size,
                          lora=None):
        """``GPT.paged_decode_step`` over the shards: returns the (B,
        hidden) final-norm states on the first shard's device and the
        pools."""
        return paged_step_states(self._gpts(), pools, page_table, tok, pos,
                                 page_size, self.layout.devices,
                                 self.vocab_split, lora), pools

    def paged_verify_chunk(self, pools, page_table, toks, pos, page_size,
                           lora=None):
        """``GPT.paged_verify_chunk`` over the shards: returns the (B, C,
        hidden) final-norm states on the first shard's device and the
        pools."""
        return paged_chunk_states(self._gpts(), pools, *verify_args(
            page_table, toks, pos), page_size, self.layout.devices,
            self.vocab_split, lora), pools

    def _head(self, shard, h):
        if shard.head is not None:
            return shard.head(h)
        return F.linear(h, shard.gpt.tok_emb)

    def lm_logits(self, h):
        """(..., hidden) on the first shard's device -> (..., vocab) there,
        through the tied head or the untied ``head``: vocab-parallel when
        the vocabulary is split, else one product on the first shard."""
        if not self.vocab_split:
            return self._head(self.shards[0], h)
        hs = broadcast(h, self.layout.devices)
        return gather([self._head(s, x) for x, s in zip(hs, self.shards)],
                      -1)


class TensorParallelCausalLM(nn.Module):
    """``model`` (a ``GPTForCausalLM`` with its weights loaded, int8 ones
    too) split over ``layout`` (``parallel.layout.ModelLayout``) for dense
    or paged serving; see module docstring."""

    def __init__(self, model, layout):
        super().__init__()
        gpt = model.gpt
        attn = gpt.layers[0].attn
        layout.validate_heads(attn.n_heads)
        int8 = any(isinstance(m, Int8Linear) for m in model.modules())
        shards = []
        for dev, sd in zip(layout.devices,
                           layout.shard_state_dict(model.state_dict())):
            shard = GPTForCausalLM(
                vocab_size=sd["gpt.tok_emb"].shape[0],
                hidden_size=gpt.hidden_size, n_layers=len(gpt.layers),
                n_heads=attn.n_heads, max_position=gpt.max_position,
                intermediate_size=gpt.intermediate_size, tp=layout.tp,
                device=dev, dtype=gpt.tok_emb.dtype,
                tie_embeddings=model.head is None)
            if int8:
                # the int8 modules' shapes; the split weights overwrite them
                quantize_model(shard)
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
