"""Decoder-only transformer, GPT-2 style pre-LN causal LM (the port of
``bigdl_tpu/models/gpt.py``: the training forward, the dense K/V-cache
methods with ``generate``, and the paged-serving methods).

``GPTForCausalLM.forward(ids)`` is the training path: token and position
embeddings, the causal blocks (attention through the flash kernels), the
final norm and the tied head, giving (B*T, vocab) logits. ``dropout``
(default 0.0, as in the reference) applies after each block's attention
and MLP when the module is in training mode and the caller passes a
``torch.Generator`` (the reference's ``rng``); ``remat=True`` recomputes
each block's activations in the backward pass.

``sequence_parallel`` takes ``MultiHeadAttention``'s three forms
(``parallel/sequence.py``), causal. Under ``("ring_inner", axis, n)`` the
model is one shard of a sequence-parallel group, as ``models/
transformer.py``'s BERT is: its forward takes the group's list of ``n``
chunks of ids, shard ``s`` at global positions from ``s * T_local``, and
``make_sp_train_step`` drives it. ``generate`` on a sequence-parallel model
takes the sliding loop, as the reference's does, and fails where that
fails: a ``ring_inner`` model takes no whole sequence, and the ring and
Ulysses forms need a length that splits over the mesh. Serving refuses
such a model.

Index arguments of the paged methods (page tables, positions, chunk
bounds) are host values, numpy arrays or CPU tensors, as the serving
engine keeps them: masks and write indices are computed on the host
(:func:`chunk_plan`, :func:`decode_plan`), and each call moves what the
device needs in a few small copies. Token ids of the decode step may
already live on the device (the sampler's output).

``GPT.init_cache`` / ``prefill`` / ``decode_step`` are the dense K/V-cache
path (one ``(B, H, max_position, D)`` buffer pair per layer, written in
place), which ``GPTForCausalLM.generate`` and the dense serving manager
(``serving/slots.py``) drive. Speculative decoding (``models/spec.py``)
adds the verify forwards: ``GPT.decode_chunk`` on the dense cache
(:func:`dense_chunk_states`) and ``GPT.paged_verify_chunk`` through the
page table (a :func:`paged_chunk_states` chunk written from each row's
committed length), and ``generate(spec_tokens=)`` drives the first.

``tp > 1`` builds one tensor-parallel shard of the model (its attention
heads, its slice of the MLP's inner width and, when the caller gives it
``vocab_size / tp`` rows, its slice of the vocabulary);
``parallel/tensor_parallel.py`` drives the shards. The dense and paged
paths are written once, over a list of shards (:func:`dense_prefill_states`,
:func:`dense_step_states`, :func:`dense_chunk_states`,
:func:`paged_chunk_states`, :func:`paged_step_states`), every block through
one layer body
(:func:`_layers`: each path's attention, then :func:`block_rest`): the
unsharded model is the list of one. The body's two row-parallel sums
(``wo`` and ``fc2``) add float partials in shard order, or, for int8
weights, the shards' int32 accumulators before one dequantising multiply
(``nn.quantized.qmatmul_row_parallel``), which gives the unsharded int8
product bit for bit. :func:`partition_specs` names each parameter's role
in ``parallel/layout.py``'s table.

Multi-tenant LoRA (``models/lora.py``): every cache-path method and states
function takes an optional ``lora``, the dispatch's slab tree (per shard
under tp), and every target projection of every layer adds its delta
(``nn.quantized.lora_linear``; a row-parallel target's delta partials are
summed over the shards after the base product's). Without it the path
runs exactly the operations it ran before LoRA was ported.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.models.lora import layer_lora
from bigdl_tpu_torch.models.spec import (NGramDraft, accept_serving, commit,
                                         spec_config)
from bigdl_tpu_torch.nn import LayerNormalization, Linear
from bigdl_tpu_torch.nn.quantized import (Int8Linear, lora_down,
                                          lora_linear, lora_up,
                                          qmatmul_row_parallel,
                                          quantize_model)
from bigdl_tpu_torch.ops.paged_attention import paged_pool_attention
from bigdl_tpu_torch.ops.sampling import fused_sample_logits, gumbel_noise
from bigdl_tpu_torch.parallel.layout import (SpecLayout, all_reduce_sum,
                                             broadcast, reduce_sum)
from bigdl_tpu_torch.parallel.sequence import (MultiHeadAttention,
                                               attention_group,
                                               paged_write_index,
                                               sequence_forward)
from bigdl_tpu_torch.utils.device import resolve_device
from bigdl_tpu_torch.utils.profiling import DispatchCounters
from bigdl_tpu_torch.utils.remat import checkpoint_list


def _host(x, dtype=torch.long):
    return torch.as_tensor(x).to("cpu", dtype)


class TransformerDecoderBlock(nn.Module):
    """Pre-LN causal block: x += attn(ln1(x)); x += mlp(ln2(x)). A
    ``tp > 1`` shard holds its heads and ``intermediate_size / tp`` of the
    MLP's inner width (``fc1`` column-parallel, ``fc2`` row-parallel with
    the whole, replicated bias)."""

    @classmethod
    def native_spec(cls):
        """The native format's entry (``utils/serializer.py``): the
        reference's block record; :class:`GPTForCausalLM` builds it."""
        from bigdl_tpu_torch.utils.serializer import NativeSpec, built_inside
        return NativeSpec("bigdl_tpu.models.gpt:TransformerDecoderBlock",
                          cls, "hidden_size attn ln1 ln2 fc1 fc2 dropout",
                          get={"hidden_size": lambda m: m.ln1.hidden_size},
                          build=built_inside("GPTForCausalLM"))

    def __init__(self, hidden_size, n_heads, intermediate_size=None,
                 dropout=0.0, sequence_parallel=None, tp=1, device=None,
                 dtype=torch.float32):
        super().__init__()
        inter = intermediate_size or 4 * hidden_size
        if inter % tp:
            raise ValueError(f"intermediate_size ({inter}) must be divisible "
                             f"by tp ({tp})")
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.dropout = dropout
        self.attn = MultiHeadAttention(hidden_size, n_heads, causal=True,
                                       sequence_parallel=sequence_parallel,
                                       tp=tp, **kw)
        self.ln1 = LayerNormalization(hidden_size, **kw)
        self.ln2 = LayerNormalization(hidden_size, **kw)
        self.fc1 = Linear(hidden_size, inter // tp, **kw)
        self.fc2 = Linear(inter // tp, hidden_size, **kw)

    def _inner(self, x, lora=None):
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(lora_linear(self.fc1, self.ln2(x),
                                  None if lora is None else lora.get("fc1")),
                      approximate="tanh")

    def _mlp(self, x, lora=None):
        return lora_linear(self.fc2, self._inner(x, lora),
                           None if lora is None else lora.get("fc2"))

    def _drop(self, h, generator):
        """Inverted dropout of ``h`` in training mode with a generator;
        otherwise ``h`` unchanged."""
        if not (self.training and self.dropout > 0 and generator is not None):
            return h
        keep = torch.rand(h.shape, generator=generator,
                          device=h.device) < 1 - self.dropout
        return torch.where(keep, h / (1 - self.dropout), torch.zeros_like(h))

    def forward(self, x, generator=None):
        """x (B, T, hidden) through the block (training forward); a
        ``ring_inner`` block takes and returns its group's list of
        chunks."""
        if self.attn.ring_inner:
            return decoder_group([self] * len(x), list(x), generator)
        return decoder_group([self], [x], generator)[0]


def decoder_group(blocks, xs, generator=None):
    """One block over a sequence-parallel group's shards: ``blocks`` each
    shard's copy of the block, ``xs`` their inputs (one block, one input,
    unsharded)."""
    hs = attention_group([b.attn for b in blocks],
                         [b.ln1(x) for b, x in zip(blocks, xs)])
    xs = [x + b._drop(h, generator) for b, x, h in zip(blocks, xs, hs)]
    return [x + b._drop(b._mlp(x), generator) for b, x in zip(blocks, xs)]


def _row_parallel(linears, xs, los=None):
    """A row-parallel projection (``wo`` or ``fc2``) of the shards' inputs
    ``xs`` without its bias, summed over the shards on the first shard's
    device: float partials added in shard order, or, for ``Int8Linear``
    shards, :func:`nn.quantized.qmatmul_row_parallel`; then, with ``los``
    (each shard's ``(a, b, scale)`` of this target: A its input rows, B
    whole), the LoRA delta as the reference's layout computes it: the
    shards' rank-r partials ``x_i @ A_i`` summed in shard order, then B
    and the scale applied once, on the first shard. The same bits are
    copied to every shard's device."""
    if isinstance(linears[0], Int8Linear):
        y = qmatmul_row_parallel(xs, [lin.weight for lin in linears],
                                 linears[0].scale)
    else:
        y = reduce_sum([F.linear(x, lin.weight)
                        for lin, x in zip(linears, xs)])
    if los is not None:
        u = reduce_sum([lora_down(x, lo[0]) for x, lo in zip(xs, los)])
        y = y + lora_up(u, *los[0][1:])
    return broadcast(y, [x.device for x in xs])


def _target(los, tgt):
    """Each shard's ``(a, b, scale)`` of ``tgt`` in a layer's LoRA batches
    ``los``, or None."""
    if los is None or tgt not in los[0]:
        return None
    return [lo[tgt] for lo in los]


def _at(los, j):
    return None if los is None else los[j]


def block_rest(blocks, xs, outs, los=None):
    """A block after its attention, over the shards: ``outs`` the shards'
    attention outputs (B, H_shard, C, D), ``xs`` their residual streams,
    ``los`` each shard's LoRA batch of the layer (or None).
    x += wo(attention); x += fc2(gelu(fc1(ln2(x)))). One shard: the
    block's own modules. Several: ``wo`` and ``fc2`` row-parallel
    (:func:`_row_parallel`), the replicated ``fc2`` bias added once after
    the sum, so every shard keeps the same bits."""
    if len(blocks) == 1:
        blk, x, lo = blocks[0], xs[0], _at(los, 0)
        x = x + blk.attn.project_heads(outs[0], lo)
        return [x + blk._mlp(x, lo)]
    attn = _row_parallel([blk.attn.wo for blk in blocks],
                         [blk.attn.merge_heads(o)
                          for blk, o in zip(blocks, outs)],
                         _target(los, "wo"))
    xs = [x + a for x, a in zip(xs, attn)]
    mlp = _row_parallel([blk.fc2 for blk in blocks],
                        [blk._inner(x, _at(los, j))
                         for j, (blk, x) in enumerate(zip(blocks, xs))],
                        _target(los, "fc2"))
    return [x + (m + blk.fc2.bias) for x, m, blk in zip(xs, mlp, blocks)]


class GPT(nn.Module):
    """GPT-2-style decoder stack returning final-norm hidden states."""

    @classmethod
    def native_spec(cls):
        """The native format's entry (``utils/serializer.py``): the
        reference's stack record; :class:`GPTForCausalLM` builds it."""
        from bigdl_tpu_torch.utils.serializer import NativeSpec, built_inside
        return NativeSpec("bigdl_tpu.models.gpt:GPT", cls,
                          "vocab_size hidden_size max_position layers ln_f "
                          "remat", get={"layers": lambda m: list(m.layers)},
                          build=built_inside("GPTForCausalLM"))

    def __init__(self, vocab_size=50257, hidden_size=768, n_layers=12,
                 n_heads=12, max_position=1024, intermediate_size=None,
                 dropout=0.0, remat=False, sequence_parallel=None, tp=1,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.max_position = max_position
        self.remat = remat
        self.sequence_parallel = sequence_parallel
        self.intermediate_size = intermediate_size or 4 * hidden_size
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.tok_emb = nn.Parameter(torch.empty(vocab_size, hidden_size,
                                                **kw))
        self.pos_emb = nn.Parameter(torch.empty(max_position, hidden_size,
                                                **kw))
        self.layers = nn.ModuleList(
            TransformerDecoderBlock(hidden_size, n_heads,
                                    self.intermediate_size, dropout,
                                    sequence_parallel, tp=tp, **kw)
            for _ in range(n_layers))
        self.ln_f = LayerNormalization(hidden_size, **kw)

    @property
    def device(self):
        return self.tok_emb.device

    def forward(self, ids, generator=None):
        """Final-norm hidden states (B, T, hidden) of token ids (B, T),
        T <= ``max_position``."""
        return sequence_forward(self, ids, generator)

    @staticmethod
    def group_forward(gpts, xs, generator=None):
        """The final-norm states of each shard's ids ``xs[s]`` through its
        copy ``gpts[s]``, shard ``s`` at global positions from ``s *
        T_local``."""
        hs = []
        for s, (g, ids) in enumerate(zip(gpts, xs)):
            ids = torch.as_tensor(ids, device=g.device).long()
            t = ids.shape[1]
            if (s + 1) * t > g.max_position:
                raise ValueError(f"sequence of {(s + 1) * t} tokens is "
                                 f"longer than max_position "
                                 f"{g.max_position}")
            hs.append(F.embedding(ids, g.tok_emb)
                      + g.pos_emb[s * t:(s + 1) * t])
        for i in range(len(gpts[0].layers)):
            blocks = [g.layers[i] for g in gpts]
            if gpts[0].remat:
                hs = checkpoint_list(functools.partial(decoder_group, blocks),
                                     generator, hs)
            else:
                hs = decoder_group(blocks, hs, generator)
        return [g.ln_f(h) for g, h in zip(gpts, hs)]

    def init_cache(self, batch, dtype=None):
        """Per-layer dense K/V buffers sized for the whole position table:
        ``n_layers`` dicts of (batch, local heads, max_position, head_dim)
        zeros on the model's device, in ``dtype`` (default the
        model's)."""
        dtype = self.tok_emb.dtype if dtype is None else dtype
        return [l.attn.init_cache(batch, self.max_position, dtype,
                                  self.device) for l in self.layers]

    def prefill(self, cache, ids, prompt_len, rows=None, lora=None):
        """Fill ``cache`` from (bucket-padded) prompts ``ids`` (B, T) in one
        causal forward (:func:`dense_prefill_states`; ``rows`` as there;
        ``lora`` the dispatch's LoRA slab tree or None, as in every cache
        method here) and return ``(h_last, cache)``: the final-norm states
        (B, hidden) at each row's last real position ``prompt_len - 1`` (an
        int, or one length a row)."""
        h = dense_prefill_states([self], [cache], ids, rows=rows,
                                 lora=_one(lora))
        return last_valid(h, prompt_len), cache

    def decode_step(self, cache, tok, pos, lora=None):
        """One incremental token a row: embed ``tok`` (B,) at ``pos`` (an
        int, or (B,) host positions), write its K/V at ``pos`` and attend
        over positions [0, pos] (:func:`dense_step_states`). Returns the
        (B, hidden) final-norm states and the cache."""
        return dense_step_states([self], [cache], tok, pos,
                                 lora=_one(lora)), cache

    def decode_chunk(self, cache, toks, pos, lora=None):
        """The speculative verify on the dense cache: C tokens a row,
        ``toks`` (B, C) (on any device; the draft's proposals) at absolute
        positions ``pos[b] + j`` (``pos`` host (B,) ints, each row's
        committed length), through every layer with their K/V written in
        place (:func:`dense_chunk_states`: writes at or past
        ``max_position`` are dropped and the position embedding clipped, so
        an overshooting row computes masked junk). Returns the (B, C,
        hidden) final-norm states and the cache."""
        return dense_chunk_states([self], [cache], toks, pos,
                                  lora=_one(lora)), cache

    def init_paged_pool(self, num_pages, page_size, dtype=None):
        """Per-layer K/V page pools on the model's device: ``n_layers``
        dicts of (num_pages, local heads, page_size, head_dim), in
        ``dtype`` (default the model's; ``torch.int8`` adds the scale
        planes). A page index names the same page in every layer, so one
        page table per slot covers the stack."""
        dtype = self.tok_emb.dtype if dtype is None else dtype
        return [l.attn.init_paged_pool(num_pages, page_size, dtype,
                                       self.device) for l in self.layers]

    @staticmethod
    def cache_planes(cache):
        """Every tensor of a dense ``cache``, per shard: one shard here."""
        return [[v for layer in cache for v in layer.values()]]

    @staticmethod
    def pool_planes(pools):
        """Every tensor of ``pools``, per shard: one shard here (the
        serving path copies pages and counts bytes through this)."""
        return [[v for pl in pools for v in pl.values()]]

    def paged_prefill_chunk(self, pools, page_table, ids, start, nvalid,
                            write_from, page_size, lora=None):
        """One chunk of chunked prefill over W rows: ``ids`` (W, C), row
        ``i`` covering positions ``[start[i], start[i] + nvalid[i])``;
        K/V written only at positions ``>= write_from[i]`` (the shared
        prefix boundary; :func:`paged_chunk_states`). Returns ``(h_last,
        pools)``, ``h_last`` (W, hidden) the final-norm state at each
        row's last valid offset."""
        h = paged_chunk_states([self], [pools], page_table, ids, start,
                               nvalid, write_from, page_size,
                               lora=_one(lora))
        return last_valid(h, nvalid), pools

    def paged_decode_step(self, pools, page_table, tok, pos, page_size,
                          lora=None):
        """One token per slot: embed ``tok`` (B,) at ``pos`` (B,), write
        its K/V at page ``page_table[s, pos // page_size]`` offset ``pos %
        page_size`` (a sentinel entry drops the write) and attend through
        the table (:func:`paged_step_states`). Returns the (B, hidden)
        final-norm states and pools."""
        return paged_step_states([self], [pools], page_table, tok, pos,
                                 page_size, lora=_one(lora)), pools

    def paged_verify_chunk(self, pools, page_table, toks, pos, page_size,
                           lora=None):
        """The speculative verify through the page table: ``toks`` (B, C)
        proposals a slot from its committed length ``pos`` (B,) on, written
        through ``page_table`` (a sentinel entry drops the write, so
        rejected tokens land only in pages the slot owns) and attended with
        the per-query mask (:func:`paged_chunk_states` with ``nvalid = C``
        and ``write_from = pos``). Returns ALL (B, C, hidden) final-norm
        states and the pools."""
        return paged_chunk_states([self], [pools], *verify_args(
            page_table, toks, pos), page_size, lora=_one(lora)), pools


def _one(lora):
    """An unsharded model's LoRA slab tree as the list of one shard's."""
    return None if lora is None else [lora]


def _embed(gpts, ids, pos, vocab_split):
    """Per-shard token plus position embeddings of per-shard ids and
    clipped positions (the same values on every shard; a 0-d position
    applies to every id). ``vocab_split``:
    shard ``i`` holds rows ``i * rows ... (i + 1) * rows - 1`` of the
    table, looks up the ids it holds (zeros for the rest), and
    ``all_reduce_sum`` joins the lookups (exact: one partial is
    nonzero)."""
    if not vocab_split:
        return [g.tok_emb[t] + g.pos_emb[p]
                for g, t, p in zip(gpts, ids, pos)]
    rows = gpts[0].tok_emb.shape[0]
    parts = []
    for i, (g, t) in enumerate(zip(gpts, ids)):
        local = t - i * rows
        miss = (local < 0) | (local >= rows)
        parts.append(g.tok_emb[local.clamp(0, rows - 1)]
                     .masked_fill(miss[..., None], 0))
    return [x + g.pos_emb[p]
            for x, g, p in zip(all_reduce_sum(parts), gpts, pos)]


def _layers(gpts, xs, attend, lora=None):
    """Every block over the shards, then the final norm once, on the first
    shard's device: ``attend(i, blocks, hs, los)`` gives the shards'
    attention outputs (B, H_shard, C, D) of ``hs = ln1(x)`` in layer ``i``
    (writing their K/V), and :func:`block_rest` does the rest. ``lora``:
    the dispatch's LoRA slab trees, one a shard (None: no adapter), of
    which ``los`` is layer ``i``'s. The one layer body of the dense and
    the paged paths."""
    for i in range(len(gpts[0].layers)):
        blocks = [g.layers[i] for g in gpts]
        los = None if lora is None else [layer_lora(t, i) for t in lora]
        outs = attend(i, blocks, [blk.ln1(x) for blk, x in zip(blocks, xs)],
                      los)
        xs = block_rest(blocks, xs, outs, los)
    return gpts[0].ln_f(xs[0])


def _paged_attend(pools, index, table, start, mesh):
    """The paged paths' attention for :func:`_layers`: each shard writes its
    heads' K/V into its layer pool at ``index`` and computes its queries;
    the paged-attention kernel then runs once per shard (``mesh``: the
    shards' devices, ``ops.paged_attention``'s ``mesh=``; None: one
    unsharded model). ``index``, ``table`` and ``start`` hold one
    device-side copy per shard."""
    def attend(i, blocks, hs, los):
        layer = [p[i] for p in pools]
        qs = [blk.attn.paged_qkv(h, pool, ix, _at(los, j))[0]
              for j, (blk, h, pool, ix) in enumerate(zip(blocks, hs, layer,
                                                         index))]
        if mesh is None:
            return [paged_pool_attention(qs[0], layer[0], table[0],
                                         start[0])]
        return paged_pool_attention(qs, layer, table, start, mesh=mesh)
    return attend


def paged_chunk_states(gpts, pools, page_table, ids, start, nvalid,
                       write_from, page_size, mesh=None, vocab_split=False,
                       lora=None):
    """The paged prefill chunk over tensor-parallel shards: ``gpts`` (one
    ``GPT`` per shard; ``[model.gpt]`` unsharded) with ``pools`` (per
    shard, then per layer), ``mesh`` the shards' devices (None for one
    unsharded ``GPT``), ``vocab_split`` whether the shards split the
    token embedding and ``lora`` the dispatch's LoRA slab trees, one a
    shard (None: no adapter). The host's :func:`chunk_plan` is copied once
    to each device. Returns the (W, C, hidden) final-norm states on the
    first shard's device; the pools are written in place."""
    devices = mesh or [gpts[0].device]
    ids, pos_c, index, table, start = [broadcast(t, devices) for t in
                                       chunk_plan(
        page_table, ids, start, nvalid, write_from, page_size,
        pools[0][0]["k"].shape[0], gpts[0].max_position)]
    xs = _embed(gpts, ids, pos_c, vocab_split)
    return _layers(gpts, xs, _paged_attend(pools, index, table, start, mesh),
                   lora)


def paged_step_states(gpts, pools, page_table, tok, pos, page_size,
                      mesh=None, vocab_split=False, lora=None):
    """The paged decode step over shards (arguments as
    :func:`paged_chunk_states`; ``tok`` may live on any device, the
    sampler's output on the first shard's). Returns the (B, hidden)
    final-norm states on the first shard's device."""
    devices = mesh or [gpts[0].device]
    pos_d, index, table, pos_i = [broadcast(t, devices) for t in decode_plan(
        page_table, pos, page_size, pools[0][0]["k"].shape[0])]
    tok = broadcast(torch.as_tensor(tok).long(), devices)
    xs = [x[:, None, :] for x in _embed(gpts, tok, pos_d, vocab_split)]
    return _layers(gpts, xs, _paged_attend(pools, index, table, pos_i,
                                           mesh), lora)[:, 0]


def verify_args(page_table, toks, pos):
    """``paged_chunk_states``' chunk arguments of a verify chunk: every
    proposal valid, writes from the committed length ``pos`` on."""
    pos = _host(pos)
    c = torch.as_tensor(toks).shape[1]
    return page_table, toks, pos, torch.full_like(pos, c), pos


def dense_prefill_states(gpts, caches, ids, rows=None, mesh=None,
                         vocab_split=False, lora=None):
    """The dense prefill over tensor-parallel shards: ``gpts`` (one ``GPT``
    per shard; ``[model.gpt]`` unsharded), ``caches`` (per shard, then per
    layer), ``mesh`` the shards' devices (None: the first GPT's), token
    ids (B, T) at positions [0, T). Each layer writes the K/V of every
    position into its cache (``rows`` None: row ``i`` into cache row
    ``i``; else the host (n,) cache rows that ids' first n rows land in,
    the rest padding) and attends causally
    (``MultiHeadAttention.prefill_heads``); ``lora`` as
    :func:`paged_chunk_states`. Returns the (B, T, hidden) final-norm
    states on the first shard's device."""
    devices = mesh or [gpts[0].device]
    ids = broadcast(_host(ids), devices)
    pos = broadcast(torch.arange(ids[0].shape[1]), devices)
    rows = None if rows is None else broadcast(_host(rows), devices)
    xs = _embed(gpts, ids, pos, vocab_split)
    return _layers(gpts, xs, lambda i, blocks, hs, los: [
        blk.attn.prefill_heads(h, c[i], None if rows is None else rows[j],
                               _at(los, j))
        for j, (blk, h, c) in enumerate(zip(blocks, hs, caches))], lora)


def dense_step_states(gpts, caches, tok, pos, mesh=None, vocab_split=False,
                      lora=None):
    """The dense decode step over shards (arguments as
    :func:`dense_prefill_states`): ``tok`` (B,) on any device (the
    sampler's output), ``pos`` an int (every row's position) or host (B,)
    positions. Returns the (B, hidden) final-norm states on the first
    shard's device."""
    devices = mesh or [gpts[0].device]
    tok = broadcast(torch.as_tensor(tok).long(), devices)
    pos = broadcast(_host(pos), devices)
    xs = [x[:, None, :] for x in _embed(gpts, tok, pos, vocab_split)]
    return _layers(gpts, xs, lambda i, blocks, hs, los: [
        blk.attn.decode_heads(h, c[i], p, _at(los, j))
        for j, (blk, h, c, p) in enumerate(zip(blocks, hs, caches, pos))],
        lora)[:, 0]


def dense_chunk_states(gpts, caches, toks, pos, mesh=None,
                       vocab_split=False, lora=None):
    """The dense speculative verify over shards (arguments as
    :func:`dense_prefill_states`): ``toks`` (B, C) on any device (the
    draft's proposals), ``pos`` host (B,) committed lengths. Each layer
    writes the chunk's K/V at :func:`dense_chunk_plan`'s index and attends
    with the per-query mask (``MultiHeadAttention.chunk_heads``). Returns
    the (B, C, hidden) final-norm states on the first shard's device."""
    devices = mesh or [gpts[0].device]
    toks = torch.as_tensor(toks).long()
    pos_c, q_pos, index = [broadcast(t, devices) for t in dense_chunk_plan(
        pos, toks.shape[0], toks.shape[1], gpts[0].max_position)]
    xs = _embed(gpts, broadcast(toks, devices), pos_c, vocab_split)
    return _layers(gpts, xs, lambda i, blocks, hs, los: [
        blk.attn.chunk_heads(h, c[i], ix, qp, _at(los, j))
        for j, (blk, h, c, ix, qp) in enumerate(zip(blocks, hs, caches,
                                                    index, q_pos))], lora)


def dense_chunk_plan(pos, b, c, max_position):
    """The host side of a dense verify chunk (see
    :func:`dense_chunk_states`): ``pos`` (an int, or host (B,) ints) the
    rows' committed lengths, C tokens a row. Returns CPU int64 tensors:
    the clipped positions (B, C) for the embedding, the absolute positions
    (B, C) for the attention mask, and the write index (3, n): flat token,
    cache row and position of every token below ``max_position`` (the
    reference drops the others)."""
    pos = _host(pos).reshape(-1).expand(b)
    q_pos = pos[:, None] + torch.arange(c)[None, :]
    tok = (q_pos.reshape(-1) < max_position).nonzero().reshape(-1)
    index = torch.stack([tok, tok // c, q_pos.reshape(-1)[tok]])
    return q_pos.clamp(0, max_position - 1), q_pos, index


def chunk_plan(page_table, ids, start, nvalid, write_from, page_size,
               num_pages, max_position):
    """The host side of a prefill or verify chunk (see
    :func:`paged_chunk_states`), as tensors for the caller to move: token
    ids (W, C) int64 where they lie (the host's prompt tokens, or the
    draft's proposals on the card), and on the CPU clipped positions (W,
    C) int64; the write index (3, n) of :func:`paged_write_index`; the
    page table (W, P) and the rows' starts (W,), both int32."""
    ids = torch.as_tensor(ids).long()
    c = ids.shape[1]
    table = _host(page_table, torch.int32)
    p = table.shape[1]
    start = _host(start)
    nvalid = _host(nvalid)
    write_from = _host(write_from)
    j = torch.arange(c)[None, :]
    pos = start[:, None] + j                                      # (W, C)
    # the reference clips the position-embedding read
    pos_c = pos.clamp(0, max_position - 1)
    writable = ((j < nvalid[:, None]) & (pos >= write_from[:, None])
                & (pos < max_position))
    page_idx = (pos // page_size).clamp(0, p - 1)
    pages = torch.where(writable, torch.gather(table.long(), 1, page_idx),
                        torch.full_like(pos, num_pages))
    index = paged_write_index(pages, pos % page_size, num_pages, "cpu")
    return ids, pos_c, index, table, start.to(torch.int32)


def last_valid(h, nvalid):
    """(W, hidden): row ``i`` of ``h`` (W, C, hidden) at its last valid
    offset ``nvalid[i] - 1`` (host ints)."""
    last = (_host(nvalid) - 1).clamp(0, h.shape[1] - 1)
    return h[torch.arange(h.shape[0], device=h.device), last.to(h.device)]


def decode_plan(page_table, pos, page_size, num_pages):
    """The host side of a decode step (see ``GPT.paged_decode_step``), as
    CPU tensors: positions (B,) int64, the write index (3, n), the page
    table (B, P) int32 and the positions (B,) int32."""
    table = _host(page_table, torch.int32)
    pos = _host(pos)
    pages = torch.gather(table.long(), 1, (pos // page_size)[:, None])
    index = paged_write_index(pages, (pos % page_size)[:, None], num_pages,
                              "cpu")
    return pos, index, table, pos.to(torch.int32)


def partition_specs(state_dict):
    """``{name: split dim or None}`` for a GPT ``state_dict`` (any mapping
    keyed by the port's parameter names): the reference's
    ``GPTForCausalLM.partition_specs`` name -> role mapping, with
    ``parallel/layout.SpecLayout`` giving each role's torch dimension. An
    int8 weight's per-output-channel ``scale`` takes the weight's
    output-dim split: a column-parallel weight's scales split with its
    rows."""
    spec = SpecLayout()

    def role(name):
        parts = name.split(".")
        leaf, parent = parts[-1], parts[-2] if len(parts) > 1 else None
        if leaf == "tok_emb":
            return spec.embeddings()
        if leaf == "pos_emb":
            return spec.position_embeddings()
        if parent in ("wq", "wk", "wv"):
            return spec.qkv_projection()       # weight (out, in); scale
        if parent == "wo":                     # scale: replicated
            return spec.attention_output() if leaf == "weight" \
                else spec.norm()
        if parent == "fc1":
            return spec.ffn_up() if leaf == "weight" else spec.ffn_up_bias()
        if parent == "fc2":
            return spec.ffn_down() if leaf == "weight" else spec.norm()
        if parent == "head":                   # weight (vocab, H); scale
            return spec.lm_head()
        return spec.norm()            # ln1/ln2/ln_f and anything else

    return {name: role(name) for name in state_dict}


def prompt_bucket(t, max_position):
    """Padded prefill length for a ``t``-token prompt: the next power of
    two (floor 16), capped at ``max_position``."""
    b = 16
    while b < t:
        b <<= 1
    return min(b, max_position) if max_position >= t else t


def sample_logits(logits, gumbel, temperature=1.0, top_k=None, top_p=None):
    """The reference's multi-op sampling chain (``bigdl_tpu/models/gpt.py``
    ``sample_logits``) in plain PyTorch, with the categorical draw written
    as ``argmax(logits + gumbel)`` over caller-given noise. Kept for the
    tests as a second oracle of ``ops.sampling``; the serving path never
    calls it."""
    t = torch.as_tensor(temperature, dtype=logits.dtype,
                        device=logits.device)
    logits = logits / torch.clamp_min(t, 1e-6)
    ninf = torch.full_like(logits, float("-inf"))
    if top_k is not None and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, ninf, logits)
    if top_p is not None and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = ((cum - probs) < top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, keep - 1)
        logits = torch.where(logits < cutoff, ninf, logits)
    return torch.argmax(logits + gumbel, dim=-1)


class GPTForCausalLM(nn.Module):
    """GPT + the LM head: tied to the token embedding (GPT-2's, the
    default), or with ``tie_embeddings=False`` a ``head`` Linear of its own
    without bias, as the reference's. ``device`` defaults to the card; pass
    ``device="cpu"`` for the CPU."""

    @classmethod
    def native_spec(cls):
        """The native format's entry (``utils/serializer.py``): the
        reference's record of the model and its parts, built back here at
        the file's widths and tensor type; the weights in ``convert``'s
        GPT layout, each tensor's type kept (int8 weights as the
        reference's ``{"q", "scale"}`` leaves, loaded into a model that
        ``quantize_model`` swapped)."""
        from bigdl_tpu_torch import convert
        from bigdl_tpu_torch.utils.serializer import NativeSpec
        return NativeSpec(
            "bigdl_tpu.models.gpt:GPTForCausalLM", cls,
            "vocab_size tie_embeddings gpt head", build=_native_build,
            trees=lambda m, sd: (convert.params_to_jax(sd, tensors=True),
                                 ()),
            load_trees=_native_load_trees)

    def __init__(self, vocab_size=50257, hidden_size=768, n_layers=12,
                 n_heads=12, max_position=1024, intermediate_size=None,
                 dropout=0.0, remat=False, sequence_parallel=None, tp=1,
                 device=None, dtype=torch.float32, tie_embeddings=True):
        super().__init__()
        self.vocab_size = vocab_size
        self.tie_embeddings = tie_embeddings
        device = resolve_device(device)
        self.gpt = GPT(vocab_size=vocab_size, hidden_size=hidden_size,
                       n_layers=n_layers, n_heads=n_heads,
                       max_position=max_position,
                       intermediate_size=intermediate_size, dropout=dropout,
                       remat=remat, sequence_parallel=sequence_parallel,
                       tp=tp, device=device, dtype=dtype)
        self.head = None if tie_embeddings else Linear(
            hidden_size, vocab_size, with_bias=False, device=device,
            dtype=dtype)

    @property
    def device(self):
        return self.gpt.device

    @property
    def sequence_parallel(self):
        return self.gpt.sequence_parallel

    def forward(self, ids, generator=None):
        """(B*T, vocab) next-token logits of token ids (B, T); pair them
        with ``CrossEntropyCriterion`` and the labels flattened to
        (B*T,)."""
        return sequence_forward(self, ids, generator)

    @staticmethod
    def group_forward(models, xs, generator=None):
        hs = GPT.group_forward([m.gpt for m in models], xs, generator)
        return [m._lm_logits(h).reshape(-1, m.vocab_size)
                for m, h in zip(models, hs)]

    def _lm_logits(self, h):
        """(..., hidden) -> (..., vocab) through the tied head or
        ``head``."""
        if self.head is not None:
            return self.head(h)
        return F.linear(h, self.gpt.tok_emb)

    @property
    def decode_stats(self):
        """``generate``'s counters on the dense cache path (a
        ``DispatchCounters``): ``prefill_traces``, the prefill passes run
        (one per call); ``decode_traces``, the decode loops run (one per
        call); ``dispatches``, their sum (two per call, as the reference's
        two jitted halves). Eager PyTorch compiles nothing, so unlike the
        reference's trace counts these grow on every call. The sliding
        fallback counts nothing, as in the reference."""
        stats = getattr(self, "_decode_stats", None)
        if stats is None:
            stats = self._decode_stats = DispatchCounters("prefill_traces",
                                                          "decode_traces")
        return stats

    def _next_tokens(self, logits, greedy, temperature, generator, top_k,
                     top_p):
        """(B,) int32 tokens of (B, vocab) logits: argmax (first index on
        ties) when greedy, else the fused sampler (its kernel on the card)
        over gumbel noise from ``generator``."""
        if greedy:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        dev = logits.device
        noise = gumbel_noise(logits.shape, generator, dev, logits.dtype)
        temps = torch.full((logits.shape[0],), max(float(temperature), 1e-6),
                           dtype=torch.float32, device=dev)
        return fused_sample_logits(logits, noise, temps, top_k, top_p)

    @torch.no_grad()
    def generate(self, ids, n_new, temperature=0.0, generator=None,
                 top_k=None, top_p=None, spec_tokens=None):
        """``ids`` (B, T) (or (T,)) followed by ``n_new`` generated tokens,
        as a (B, T + n_new) int32 CPU tensor: greedy at temperature 0, else
        temperature / top-k / top-p sampling through the fused sampler
        with gumbel noise from ``generator`` (a ``torch.Generator`` on the
        model's device; None: one seeded 0).

        K/V-cache decoding, as the reference: the prompt is right-padded
        to its ``prompt_bucket`` and prefilled in one causal forward
        (``GPT.prefill``; flash on the card where ``flash_profitable``
        holds), then the decode loop emits the tokens one at a time
        against the dense cache (``GPT.decode_step``): the prefill's
        logits give the first, each of ``n_new - 1`` decode steps the
        next. A generation that would pass ``max_position``, or any on a
        sequence-parallel model, takes :meth:`_generate_sliding`.

        ``spec_tokens > 1`` (or ``BIGDL_TPU_SPEC_DECODE`` with
        ``BIGDL_TPU_SPEC_TOKENS``; an explicit ``spec_tokens`` wins) makes
        greedy generation speculative (:meth:`_generate_spec`), with the
        same tokens; sampled generation ignores it, as the reference
        does (keeping the sampled distribution would need a rejection
        rule)."""
        ids = torch.as_tensor(ids).to("cpu", torch.int32)
        if ids.dim() == 1:
            ids = ids[None]
        if n_new <= 0:
            return ids
        greedy = temperature is None or float(temperature) <= 0.0
        gamma = (max(int(spec_tokens), 1) if spec_tokens is not None
                 else spec_config())
        dev = self.device
        if generator is None and not greedy:
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)
        b, t = ids.shape
        gpt = self.gpt
        if t + n_new > gpt.max_position or gpt.sequence_parallel is not None:
            return self._generate_sliding(ids, n_new, temperature,
                                          generator, top_k, top_p)
        bucket = prompt_bucket(t, gpt.max_position)
        padded = torch.zeros((b, bucket), dtype=torch.int32)
        padded[:, :t] = ids
        if greedy and gamma > 1:
            return self._generate_spec(ids, padded, n_new, gamma)
        cache = gpt.init_cache(b)
        h, cache = gpt.prefill(cache, padded, t)
        logits = self._lm_logits(h)
        self.decode_stats.tick("prefill_traces")
        toks = []
        for step in range(n_new):
            tok = self._next_tokens(logits, greedy, temperature, generator,
                                    top_k, top_p)
            toks.append(tok)
            if step + 1 < n_new:
                h, cache = gpt.decode_step(cache, tok, t + step)
                logits = self._lm_logits(h)
        self.decode_stats.tick("decode_traces")
        return torch.cat([ids, torch.stack(toks, 1).cpu()], 1)

    @torch.no_grad()
    def _generate_spec(self, ids, padded, n_new, gamma):
        """Greedy speculative decoding (the reference's ``_spec_fns``):
        ``ids`` (B, T) int32 on the CPU, ``padded`` them at their bucket.
        The prefill also primes an ``NGramDraft`` from the prompts. Each
        iteration of the loop proposes ``gamma`` tokens a row from the
        argmax of the carried logits, verifies them in one
        ``GPT.decode_chunk`` at each row's committed length, commits the
        longest agreeing prefix (``models.spec.accept_serving``) and
        teaches the draft the committed pairs (``models.spec.commit``). A
        row with ``n_new`` tokens freezes; the loop ends when the slowest
        row has them, its one readback an iteration (the proposals and the
        commit counts) standing in for the reference's ``while_loop``
        condition.
        ``decode_stats`` counts the prefill and the loop, as for the
        plain path. Returns (B, T + n_new) int32 on the CPU."""
        gpt, dev = self.gpt, self.device
        b, t = ids.shape
        draft = NGramDraft(self.vocab_size)
        h, cache = gpt.prefill(gpt.init_cache(b), padded, t)
        logits = self._lm_logits(h)
        table = draft.prime(draft.init_state(b, dev), padded,
                            torch.full((b,), t))
        last = ids[:, t - 1].to(dev, torch.int32)
        self.decode_stats.tick("prefill_traces")
        out = np.zeros((b, n_new + gamma), np.int32)
        count = np.zeros(b, np.int64)
        while count.min() < n_new:
            props = draft.propose(table, torch.argmax(logits, dim=-1), gamma)
            h, cache = gpt.decode_chunk(cache, props, t + count)
            adv, carry = accept_serving(
                props, self._lm_logits(h),
                live=torch.from_numpy(count < n_new).to(dev))
            last, logits, got = commit(draft, table, props, adv, carry, last,
                                       logits)
            for r in range(b):
                n = int(got[r, -1])
                out[r, count[r]:count[r] + n] = got[r, :n]
            count += got[:, -1]
        self.decode_stats.tick("decode_traces")
        return torch.cat([ids, torch.from_numpy(out[:, :n_new])], 1)

    @torch.no_grad()
    def _generate_sliding(self, ids, n_new, temperature, generator,
                          top_k=None, top_p=None):
        """Full-recompute decoding over the last ``max_position`` tokens,
        one forward (``GPT.forward``: flash on the card) a token, for
        generations that pass ``max_position`` (a static cache cannot
        shift positions). ``ids``: (B, T) int32 on the CPU; returns (B, T
        + n_new) int32 on the CPU."""
        window = self.gpt.max_position
        greedy = temperature is None or float(temperature) <= 0.0
        cur = ids.to(self.device, torch.long)
        for _ in range(n_new):
            h = self.gpt(cur[:, -window:])
            logits = self._lm_logits(h[:, -1])
            tok = self._next_tokens(logits, greedy, temperature, generator,
                                    top_k, top_p)
            cur = torch.cat([cur, tok[:, None].long()], 1)
        return cur.cpu().to(torch.int32)


def gpt2_small(**kw):
    """GPT-2 124M config (12 layers, hidden 768, 12 heads, vocab 50257,
    1024 context)."""
    return GPTForCausalLM(**kw)


def gpt_flops_per_token(n_layers=12, h=768, s=1024, vocab=50257,
                        inter=None):
    """Analytic forward FLOPs per token (the reference's formula): QKV+O
    8h^2, the two MLP products 4*h*inter, the attention products 4*s*h
    per layer, and the tied vocab projection 2*h*vocab. A training step
    costs three times this per token."""
    inter = inter or 4 * h
    per_layer = 8 * h * h + 4 * h * inter + 4 * s * h
    return n_layers * per_layer + 2 * h * vocab


def _native_build(a, make, at):
    """A :class:`GPTForCausalLM` of a native file's record (its parts'
    records give the widths)."""
    g = a["gpt"].attrs
    block = g["layers"][0].attrs if g["layers"] else None
    attn = block["attn"].attrs if block else {}
    return GPTForCausalLM(
        vocab_size=a["vocab_size"], hidden_size=g["hidden_size"],
        n_layers=len(g["layers"]), n_heads=attn.get("n_heads", 1),
        max_position=g["max_position"],
        intermediate_size=(block["fc1"].attrs["output_size"]
                           if block else None),
        dropout=block["dropout"] if block else 0.0, remat=g["remat"],
        tie_embeddings=a["tie_embeddings"], device=at.device,
        dtype=at.dtype or torch.float32)


def _native_load_trees(model, params, state):
    """The state_dict of a native file's params for ``model``, which
    becomes int8 first where the file's weights are."""
    from bigdl_tpu_torch import convert
    sd = convert.params_from_jax(params)
    if any(k.endswith(".scale") for k in sd):
        quantize_model(model)
    return sd
