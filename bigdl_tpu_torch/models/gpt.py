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
engine keeps them: masks and write indices are computed on the host, and
each call moves what the device needs in a few small copies. Token ids
of the decode step may already live on the device (the sampler's
output).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn import LayerNormalization, Linear
from bigdl_tpu_torch.parallel.sequence import (MultiHeadAttention,
                                               paged_write_index)
from bigdl_tpu_torch.utils.device import resolve_device
from bigdl_tpu_torch.utils.remat import checkpoint


def _host(x, dtype=torch.long):
    return torch.as_tensor(x).to("cpu", dtype)


class TransformerDecoderBlock(nn.Module):
    """Pre-LN causal block: x += attn(ln1(x)); x += mlp(ln2(x))."""

    def __init__(self, hidden_size, n_heads, intermediate_size=None,
                 dropout=0.0, device=None, dtype=torch.float32):
        super().__init__()
        inter = intermediate_size or 4 * hidden_size
        kw = dict(device=device, dtype=dtype)
        self.dropout = dropout
        self.attn = MultiHeadAttention(hidden_size, n_heads, causal=True,
                                       **kw)
        self.ln1 = LayerNormalization(hidden_size, **kw)
        self.ln2 = LayerNormalization(hidden_size, **kw)
        self.fc1 = Linear(hidden_size, inter, **kw)
        self.fc2 = Linear(inter, hidden_size, **kw)

    def _mlp(self, x):
        # jax.nn.gelu defaults to the tanh approximation
        return self.fc2(F.gelu(self.fc1(self.ln2(x)), approximate="tanh"))

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

    def paged_prefill_chunk(self, pool, x, index, page_table, start):
        h, pool = self.attn.paged_prefill_chunk(self.ln1(x), pool, index,
                                                page_table, start)
        x = x + h
        return x + self._mlp(x), pool

    def paged_decode_step(self, pool, x, index, page_table, pos):
        h, pool = self.attn.paged_decode_step(self.ln1(x), pool, index,
                                              page_table, pos)
        x = x + h
        return x + self._mlp(x), pool


class GPT(nn.Module):
    """GPT-2-style decoder stack returning final-norm hidden states."""

    def __init__(self, vocab_size=50257, hidden_size=768, n_layers=12,
                 n_heads=12, max_position=1024, intermediate_size=None,
                 dropout=0.0, remat=False, device=None, dtype=torch.float32):
        super().__init__()
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.max_position = max_position
        self.remat = remat
        self.intermediate_size = intermediate_size or 4 * hidden_size
        kw = dict(device=device, dtype=dtype)
        self.tok_emb = nn.Parameter(torch.empty(vocab_size, hidden_size,
                                                **kw))
        self.pos_emb = nn.Parameter(torch.empty(max_position, hidden_size,
                                                **kw))
        self.layers = nn.ModuleList(
            TransformerDecoderBlock(hidden_size, n_heads, intermediate_size,
                                    dropout, **kw) for _ in range(n_layers))
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
        dicts of (num_pages, n_heads, page_size, head_dim), in ``dtype``
        (default the model's; ``torch.int8`` adds the scale planes). A
        page index names the same page in every layer, so one page table
        per slot covers the stack."""
        dtype = self.tok_emb.dtype if dtype is None else dtype
        return [l.attn.init_paged_pool(num_pages, page_size, dtype,
                                       self.device) for l in self.layers]

    def _paged_chunk(self, pools, page_table, ids, start, nvalid,
                     write_from, page_size):
        """Run C tokens per row through every block against the pools,
        writing positions ``[max(start, write_from), start + nvalid)``
        (and ``< max_position``) through the table; every other token's
        write is filtered out. Returns the (W, C, hidden) final-norm
        hidden states and the pools (updated in place)."""
        dev = self.device
        ids = _host(ids)
        w, c = ids.shape
        table = _host(page_table, torch.int32)
        p = table.shape[1]
        start = _host(start)
        nvalid = _host(nvalid)
        write_from = _host(write_from)
        num_pages = pools[0]["k"].shape[0]
        j = torch.arange(c)[None, :]
        pos = start[:, None] + j                                  # (W, C)
        # the reference clips the position-embedding read
        pos_c = pos.clamp(0, self.max_position - 1)
        h = (self.tok_emb[ids.to(dev)] + self.pos_emb[pos_c.to(dev)])
        writable = ((j < nvalid[:, None]) & (pos >= write_from[:, None])
                    & (pos < self.max_position))
        page_idx = (pos // page_size).clamp(0, p - 1)
        pages = torch.where(writable,
                            torch.gather(table.long(), 1, page_idx),
                            torch.full_like(pos, num_pages))
        index = paged_write_index(pages, pos % page_size, num_pages, dev)
        table_d = table.to(dev)
        start_d = start.to(dev, torch.int32)
        for i, layer in enumerate(self.layers):
            h, pools[i] = layer.paged_prefill_chunk(pools[i], h, index,
                                                    table_d, start_d)
        return self.ln_f(h), pools

    def paged_prefill_chunk(self, pools, page_table, ids, start, nvalid,
                            write_from, page_size):
        """One chunk of chunked prefill over W rows: ``ids`` (W, C), row
        ``i`` covering positions ``[start[i], start[i] + nvalid[i])``;
        K/V written only at positions ``>= write_from[i]`` (the shared
        prefix boundary). Returns ``(h_last, pools)``, ``h_last`` (W,
        hidden) the final-norm state at each row's last valid offset."""
        h, pools = self._paged_chunk(pools, page_table, ids, start, nvalid,
                                     write_from, page_size)
        c = h.shape[1]
        last = (_host(nvalid) - 1).clamp(0, c - 1)
        return (h[torch.arange(h.shape[0], device=h.device), last.to(h.device)],
                pools)

    def paged_decode_step(self, pools, page_table, tok, pos, page_size):
        """One token per slot: embed ``tok`` (B,) at ``pos`` (B,), write
        its K/V at page ``page_table[s, pos // page_size]`` offset ``pos %
        page_size`` (a sentinel entry drops the write) and attend through
        the table. Returns the (B, hidden) final-norm states and pools."""
        dev = self.device
        table = _host(page_table, torch.int32)
        pos = _host(pos)
        num_pages = pools[0]["k"].shape[0]
        pos_d = pos.to(dev)
        h = (self.tok_emb[torch.as_tensor(tok, device=dev).long()]
             + self.pos_emb[pos_d])[:, None, :]
        pages = torch.gather(table.long(), 1, (pos // page_size)[:, None])
        index = paged_write_index(pages, (pos % page_size)[:, None],
                                  num_pages, dev)
        table_d = table.to(dev)
        pos_i = pos_d.to(torch.int32)
        for i, layer in enumerate(self.layers):
            h, pools[i] = layer.paged_decode_step(pools[i], h, index,
                                                  table_d, pos_i)
        return self.ln_f(h)[:, 0], pools


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
                 dropout=0.0, remat=False, device=None, dtype=torch.float32):
        super().__init__()
        self.vocab_size = vocab_size
        self.gpt = GPT(vocab_size=vocab_size, hidden_size=hidden_size,
                       n_layers=n_layers, n_heads=n_heads,
                       max_position=max_position,
                       intermediate_size=intermediate_size, dropout=dropout,
                       remat=remat, device=resolve_device(device),
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
