"""Decoder-only transformer, GPT-2 style pre-LN causal LM (the port of
``bigdl_tpu/models/gpt.py``: the training forward and the paged-serving
methods).

``GPTForCausalLM.forward(ids)`` is the training path: token and position
embeddings, the causal blocks (attention through the flash kernels), the
final norm and the tied head, giving (B*T, vocab) logits. ``dropout``
(default 0.0, as in the reference) applies after each block's attention
and MLP when the module is in training mode and the caller passes a
``torch.Generator`` (the reference's ``rng``); ``remat=True`` recomputes
each block's activations in the backward pass.

Index arguments of the paged methods (page tables, positions, chunk
bounds) are host values, numpy arrays or CPU tensors, as the serving
engine keeps them: masks and write indices are computed on the host
(:func:`chunk_plan`, :func:`decode_plan`), and each call moves what the
device needs in a few small copies. Token ids of the decode step may
already live on the device (the sampler's output).

``tp > 1`` builds one tensor-parallel shard of the model (its attention
heads, its slice of the MLP's inner width and, when the caller gives it
``vocab_size / tp`` rows, its slice of the vocabulary);
``parallel/tensor_parallel.py`` drives the shards. The paged paths are
written once, over a list of shards (:func:`paged_chunk_states`,
:func:`paged_step_states`, ``TransformerDecoderBlock.paged_layer``): the
unsharded model is the list of one. :func:`partition_specs` names each
parameter's role in ``parallel/layout.py``'s table.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn import LayerNormalization, Linear
from bigdl_tpu_torch.ops.paged_attention import paged_pool_attention
from bigdl_tpu_torch.parallel.layout import (SpecLayout, all_reduce_sum,
                                             broadcast)
from bigdl_tpu_torch.parallel.sequence import (MultiHeadAttention,
                                               paged_write_index)
from bigdl_tpu_torch.utils.device import resolve_device
from bigdl_tpu_torch.utils.remat import checkpoint


def _host(x, dtype=torch.long):
    return torch.as_tensor(x).to("cpu", dtype)


class TransformerDecoderBlock(nn.Module):
    """Pre-LN causal block: x += attn(ln1(x)); x += mlp(ln2(x)). A
    ``tp > 1`` shard holds its heads and ``intermediate_size / tp`` of the
    MLP's inner width (``fc1`` column-parallel, ``fc2`` row-parallel with
    the whole, replicated bias)."""

    def __init__(self, hidden_size, n_heads, intermediate_size=None,
                 dropout=0.0, tp=1, device=None, dtype=torch.float32):
        super().__init__()
        inter = intermediate_size or 4 * hidden_size
        if inter % tp:
            raise ValueError(f"intermediate_size ({inter}) must be divisible "
                             f"by tp ({tp})")
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.dropout = dropout
        self.attn = MultiHeadAttention(hidden_size, n_heads, causal=True,
                                       tp=tp, **kw)
        self.ln1 = LayerNormalization(hidden_size, **kw)
        self.ln2 = LayerNormalization(hidden_size, **kw)
        self.fc1 = Linear(hidden_size, inter // tp, **kw)
        self.fc2 = Linear(inter // tp, hidden_size, **kw)

    def _inner(self, x):
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(self.fc1(self.ln2(x)), approximate="tanh")

    def _mlp(self, x):
        return self.fc2(self._inner(x))

    def mlp_partial(self, x):
        """A shard's MLP without ``fc2``'s bias: its pre-reduction
        partial, which the caller sums over the shards before adding the
        bias once."""
        return F.linear(self._inner(x), self.fc2.weight)

    def _drop(self, h, generator):
        """Inverted dropout of ``h`` in training mode with a generator;
        otherwise ``h`` unchanged."""
        if not (self.training and self.dropout > 0 and generator is not None):
            return h
        keep = torch.rand(h.shape, generator=generator,
                          device=h.device) < 1 - self.dropout
        return torch.where(keep, h / (1 - self.dropout), torch.zeros_like(h))

    def forward(self, x, generator=None):
        """x (B, T, hidden) through the block (training forward)."""
        x = x + self._drop(self.attn(self.ln1(x)), generator)
        return x + self._drop(self._mlp(x), generator)

    @staticmethod
    def paged_layer(blocks, pools, xs, index, page_table, start, mesh=None):
        """One block of the paged chunk and decode paths over its
        tensor-parallel shards: ``blocks``, ``pools``, ``xs`` (B, C,
        hidden) and the device-side ``index``, ``page_table`` and
        ``start`` hold one entry per shard (one entry and ``mesh`` None:
        the whole block). x += attn(ln1(x)); x += mlp(ln2(x)). Each shard
        writes its heads' K/V into its pool and computes its queries; the
        paged-attention kernel then runs once per shard (``mesh``: the
        shards' devices, ``ops.paged_attention``'s ``mesh=``). The ``wo``
        and ``fc2`` partials are summed by ``all_reduce_sum`` (the
        identity for one shard), and a shard's ``fc2`` bias, replicated,
        is added once after the sum. Returns the per-shard states; the
        pools are written in place."""
        qs = [blk.attn.paged_qkv(blk.ln1(x), pool, ix)[0]
              for blk, x, pool, ix in zip(blocks, xs, pools, index)]
        if mesh is None:
            outs = [paged_pool_attention(qs[0], pools[0], page_table[0],
                                         start[0])]
        else:
            outs = paged_pool_attention(qs, pools, page_table, start,
                                        mesh=mesh)
        attn = all_reduce_sum([blk.attn.paged_out(o)
                               for blk, o in zip(blocks, outs)])
        xs = [x + a for x, a in zip(xs, attn)]
        if mesh is None:
            return [xs[0] + blocks[0]._mlp(xs[0])]
        mlp = all_reduce_sum([blk.mlp_partial(x)
                              for blk, x in zip(blocks, xs)])
        return [x + (m + blk.fc2.bias) for x, m, blk in zip(xs, mlp, blocks)]


class GPT(nn.Module):
    """GPT-2-style decoder stack returning final-norm hidden states."""

    def __init__(self, vocab_size=50257, hidden_size=768, n_layers=12,
                 n_heads=12, max_position=1024, intermediate_size=None,
                 dropout=0.0, remat=False, tp=1, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.max_position = max_position
        self.remat = remat
        self.intermediate_size = intermediate_size or 4 * hidden_size
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.tok_emb = nn.Parameter(torch.empty(vocab_size, hidden_size,
                                                **kw))
        self.pos_emb = nn.Parameter(torch.empty(max_position, hidden_size,
                                                **kw))
        self.layers = nn.ModuleList(
            TransformerDecoderBlock(hidden_size, n_heads,
                                    self.intermediate_size, dropout, tp=tp,
                                    **kw) for _ in range(n_layers))
        self.ln_f = LayerNormalization(hidden_size, **kw)

    @property
    def device(self):
        return self.tok_emb.device

    def forward(self, ids, generator=None):
        """Final-norm hidden states (B, T, hidden) of token ids (B, T),
        T <= ``max_position``."""
        ids = torch.as_tensor(ids, device=self.device).long()
        t = ids.shape[1]
        if t > self.max_position:
            raise ValueError(f"sequence of {t} tokens is longer than "
                             f"max_position {self.max_position}")
        h = F.embedding(ids, self.tok_emb) + self.pos_emb[:t]
        for layer in self.layers:
            if self.remat:
                h = checkpoint(layer, generator, h)
            else:
                h = layer(h, generator)
        return self.ln_f(h)

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
    def pool_planes(pools):
        """Every tensor of ``pools``, per shard: one shard here (the
        serving path copies pages and counts bytes through this)."""
        return [[v for pl in pools for v in pl.values()]]

    def paged_prefill_chunk(self, pools, page_table, ids, start, nvalid,
                            write_from, page_size):
        """One chunk of chunked prefill over W rows: ``ids`` (W, C), row
        ``i`` covering positions ``[start[i], start[i] + nvalid[i])``;
        K/V written only at positions ``>= write_from[i]`` (the shared
        prefix boundary; :func:`paged_chunk_states`). Returns ``(h_last,
        pools)``, ``h_last`` (W, hidden) the final-norm state at each
        row's last valid offset."""
        h = paged_chunk_states([self], [pools], page_table, ids, start,
                               nvalid, write_from, page_size)
        return last_valid(h, nvalid), pools

    def paged_decode_step(self, pools, page_table, tok, pos, page_size):
        """One token per slot: embed ``tok`` (B,) at ``pos`` (B,), write
        its K/V at page ``page_table[s, pos // page_size]`` offset ``pos %
        page_size`` (a sentinel entry drops the write) and attend through
        the table (:func:`paged_step_states`). Returns the (B, hidden)
        final-norm states and pools."""
        return paged_step_states([self], [pools], page_table, tok, pos,
                                 page_size), pools


def _paged_embed(gpts, ids, pos, vocab_split):
    """Per-shard token plus position embeddings of per-shard ids and
    clipped positions (the same values on every shard). ``vocab_split``:
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


def _paged_layers(gpts, pools, xs, index, table, start, mesh):
    """Every block (``TransformerDecoderBlock.paged_layer``), then the
    final norm once, on the first shard's device."""
    for i in range(len(gpts[0].layers)):
        xs = TransformerDecoderBlock.paged_layer(
            [g.layers[i] for g in gpts], [p[i] for p in pools], xs, index,
            table, start, mesh)
    return gpts[0].ln_f(xs[0])


def paged_chunk_states(gpts, pools, page_table, ids, start, nvalid,
                       write_from, page_size, mesh=None, vocab_split=False):
    """The paged prefill chunk over tensor-parallel shards: ``gpts`` (one
    ``GPT`` per shard; ``[model.gpt]`` unsharded) with ``pools`` (per
    shard, then per layer), ``mesh`` the shards' devices (None for one
    unsharded ``GPT``) and ``vocab_split`` whether the shards split the
    token embedding. The host's :func:`chunk_plan` is copied once to each
    device. Returns the (W, C, hidden) final-norm states on the first
    shard's device; the pools are written in place."""
    devices = mesh or [gpts[0].device]
    ids, pos_c, index, table, start = [broadcast(t, devices) for t in
                                       chunk_plan(
        page_table, ids, start, nvalid, write_from, page_size,
        pools[0][0]["k"].shape[0], gpts[0].max_position)]
    xs = _paged_embed(gpts, ids, pos_c, vocab_split)
    return _paged_layers(gpts, pools, xs, index, table, start, mesh)


def paged_step_states(gpts, pools, page_table, tok, pos, page_size,
                      mesh=None, vocab_split=False):
    """The paged decode step over shards (arguments as
    :func:`paged_chunk_states`; ``tok`` may live on any device, the
    sampler's output on the first shard's). Returns the (B, hidden)
    final-norm states on the first shard's device."""
    devices = mesh or [gpts[0].device]
    pos_d, index, table, pos_i = [broadcast(t, devices) for t in decode_plan(
        page_table, pos, page_size, pools[0][0]["k"].shape[0])]
    tok = broadcast(torch.as_tensor(tok).long(), devices)
    xs = [x[:, None, :] for x in _paged_embed(gpts, tok, pos_d, vocab_split)]
    return _paged_layers(gpts, pools, xs, index, table, pos_i, mesh)[:, 0]


def chunk_plan(page_table, ids, start, nvalid, write_from, page_size,
               num_pages, max_position):
    """The host side of a prefill chunk (see :func:`paged_chunk_states`),
    as CPU tensors for the caller to move: token ids (W, C) and clipped
    positions (W, C), both int64; the write index (3, n) of
    :func:`paged_write_index`; the page table (W, P) and the rows' starts
    (W,), both int32."""
    ids = _host(ids)
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
    """GPT + the tied-embedding LM head (GPT-2 ties the output projection
    to the token embedding). ``device`` defaults to the card; pass
    ``device="cpu"`` for the CPU."""

    def __init__(self, vocab_size=50257, hidden_size=768, n_layers=12,
                 n_heads=12, max_position=1024, intermediate_size=None,
                 dropout=0.0, remat=False, tp=1, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.vocab_size = vocab_size
        self.gpt = GPT(vocab_size=vocab_size, hidden_size=hidden_size,
                       n_layers=n_layers, n_heads=n_heads,
                       max_position=max_position,
                       intermediate_size=intermediate_size, dropout=dropout,
                       remat=remat, tp=tp, device=resolve_device(device),
                       dtype=dtype)

    @property
    def device(self):
        return self.gpt.device

    def forward(self, ids, generator=None):
        """(B*T, vocab) next-token logits of token ids (B, T); pair them
        with ``CrossEntropyCriterion`` and the labels flattened to
        (B*T,)."""
        return self._lm_logits(self.gpt(ids, generator)).reshape(
            -1, self.vocab_size)

    def _lm_logits(self, h):
        """(..., hidden) -> (..., vocab) through the tied head."""
        return F.linear(h, self.gpt.tok_emb)


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
