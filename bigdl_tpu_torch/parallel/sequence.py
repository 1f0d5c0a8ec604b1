"""Attention (the port of ``bigdl_tpu/parallel/sequence.py``:
``full_attention``, ``paged_gather``, ``paged_write``, ``paged_attention``
and ``MultiHeadAttention``'s full-sequence ``forward`` and paged methods).

The full-sequence forward (training) attends through ``ops.
flash_attention``: the hand-written kernels on the card, their plain
versions on the CPU. The reference picks its flash kernel by a shape
heuristic or the ``BIGDL_TPU_FLASH_ATTENTION`` flag; the port reads
neither: on the card it always takes its kernel. :func:`full_attention`
is the reference's oracle, kept for the tests.

K/V live in one pool per layer, ``(num_pages, H, page_size, D)``; slots
reach their tokens through int32 page tables whose entries ``>=
num_pages`` are the "no page" sentinel.

Two traps of the reference's XLA semantics are explicit here:

- out-of-bounds WRITES: JAX drops a scatter to a sentinel page
  (``mode="drop"``); a CUDA scatter would hit a device-side assert. So
  :func:`paged_write_index` filters the masked tokens out on the host,
  once per dispatch, before :func:`paged_write` scatters;
- out-of-bounds READS: JAX clips them (``mode="clip"``); the gathers
  here clamp explicitly.

The serving path attends through ``ops.paged_attention``
(:meth:`MultiHeadAttention._paged_attend`): the hand-written kernel on the
card, its plain version on the CPU, both with the kernel's ``NEG_INF``
fill. :func:`paged_gather` + :func:`paged_attention` are the reference's
XLA path, with its ``-inf`` fill (a fully masked row gives NaN there), and
are kept for the tests.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from bigdl_tpu_torch.nn import Linear
from bigdl_tpu_torch.ops.flash_attention import flash_attention
from bigdl_tpu_torch.ops.paged_attention import paged_pool_attention


def full_attention(q, k, v, causal=False):
    """Single-device reference attention over (B, H, S, D), the oracle of
    the flash kernels: softmax of the scaled scores, ``-inf`` above the
    diagonal when causal."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        tq, tk = q.shape[2], k.shape[2]
        seen = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~seen, float("-inf"))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1), v)


def paged_gather(pool, page_table):
    """(B, H, P*page_size, D) per-row K or V views from ``pool`` (N, H,
    page_size, D) through ``page_table`` (B, P); sentinel entries clamp
    to the last page (junk the caller's mask must exclude)."""
    b, p = page_table.shape
    n, h, ps, d = pool.shape
    idx = page_table.to(pool.device, torch.long).clamp(0, n - 1)
    out = pool[idx]                                         # (B,P,H,ps,D)
    return out.permute(0, 2, 1, 3, 4).reshape(b, h, p * ps, d)


def paged_write_index(pages, offsets, num_pages, device):
    """The writes that land: ``(rows, pages, offsets)`` on ``device``,
    where ``rows`` index the flattened (B*C) tokens whose page is real
    (``0 <= page < num_pages``). ``pages``/``offsets``: (B, C) ints.
    The filter runs where ``pages`` live (the host, on the serving path)
    and the result moves in one copy."""
    pg = torch.as_tensor(pages).reshape(-1).long()
    off = torch.as_tensor(offsets).reshape(-1).long().to(pg.device)
    rows = ((pg >= 0) & (pg < num_pages)).nonzero().reshape(-1)
    return torch.stack([rows, pg[rows], off[rows]]).to(device)


def paged_write(pool, new, index):
    """Scatter token K or V values ``new`` (B, H, C, D) into ``pool`` in
    place at the writes of ``index`` (from :func:`paged_write_index`);
    masked tokens were filtered out there. Returns ``pool``."""
    b, h, c, d = new.shape
    rows, pg, off = index
    vals = new.transpose(1, 2).reshape(b * c, h, d)[rows]
    pool[pg, :, off, :] = vals.to(pool.dtype)
    return pool


def paged_attention(q, k, v, q_pos):
    """The reference's XLA chunk attention against gathered K/V: key
    ``j`` is visible to the query at absolute position ``p`` iff ``j <=
    p``; masked scores are ``-inf``. ``q``: (B, H, C, D); ``k``/``v``:
    (B, H, S, D); ``q_pos``: (B, C)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = k.shape[2]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    pos = torch.as_tensor(q_pos, device=q.device).long()
    valid = (torch.arange(s, device=q.device)[None, None, None, :]
             <= pos[:, None, :, None])
    scores = scores.masked_fill(~valid, float("-inf"))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1), v)


class MultiHeadAttention(nn.Module):
    """Multi-head self-attention: :meth:`forward` over whole sequences
    (``causal`` masks later keys) and the paged methods, which are always
    causal. ``wq``, ``wk``, ``wv``, ``wo`` are bias-free, as in the
    reference. ``sequence_parallel`` (ring/Ulysses attention) is not
    ported yet."""

    def __init__(self, hidden_size, n_heads, causal=False,
                 sequence_parallel=None, device=None, dtype=torch.float32):
        super().__init__()
        if hidden_size % n_heads:
            raise ValueError(f"hidden_size {hidden_size} must be divisible "
                             f"by n_heads {n_heads}")
        if sequence_parallel is not None:
            raise NotImplementedError(
                "sequence_parallel (ring/Ulysses attention) is not ported "
                "yet: ROADMAP A.10/A.11")
        self.causal = causal
        self.hidden_size = hidden_size
        self.n_heads = n_heads
        self.head_dim = hidden_size // n_heads
        kw = dict(with_bias=False, device=device, dtype=dtype)
        self.wq = Linear(hidden_size, hidden_size, **kw)
        self.wk = Linear(hidden_size, hidden_size, **kw)
        self.wv = Linear(hidden_size, hidden_size, **kw)
        self.wo = Linear(hidden_size, hidden_size, **kw)

    def _qkv(self, x):
        b, t, _ = x.shape

        def split(proj):
            return (proj(x).reshape(b, t, self.n_heads, self.head_dim)
                    .transpose(1, 2).contiguous())

        return split(self.wq), split(self.wk), split(self.wv)

    def forward(self, x):
        """Self-attention over x (B, T, hidden) through the flash kernel
        (the reference's ``call`` without sequence parallelism)."""
        b, t, hs = x.shape
        q, k, v = self._qkv(x)
        out = flash_attention(q, k, v, causal=self.causal)
        return self.wo(out.transpose(1, 2).reshape(b, t, hs))

    def init_paged_pool(self, num_pages, page_size, dtype, device):
        """One layer's K/V page pool: ``{"k", "v"}`` of (num_pages,
        n_heads, page_size, head_dim) zeros (so never-written slots hold
        finite values)."""
        shape = (num_pages, self.n_heads, page_size, self.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def _paged_write(self, pool, k, v, index):
        """Write new K/V through the page table, in place."""
        paged_write(pool["k"], k, index)
        paged_write(pool["v"], v, index)
        return pool

    def _paged_attend(self, q, k, v, pool, index, page_table, start):
        """Write-then-attend core of the chunk and step paths: the chunk's
        own K/V land in the pool first, then the queries attend through
        the page table (``ops.paged_attention``)."""
        pool = self._paged_write(pool, k, v, index)
        return paged_pool_attention(q, pool, page_table, start), pool

    def paged_prefill_chunk(self, x, pool, index, page_table, start):
        """C tokens per row (x: (B, C, hidden)) write their K/V at
        ``index`` and attend to every visible position at or before their
        own (``start[b] + c``) through ``page_table`` (B, P) int32.
        Returns (output, pool)."""
        b, t, hs = x.shape
        q, k, v = self._qkv(x)
        out, pool = self._paged_attend(q, k, v, pool, index, page_table,
                                       start)
        return self.wo(out.transpose(1, 2).reshape(b, t, hs)), pool

    def paged_decode_step(self, x, pool, index, page_table, pos):
        """ONE token per row (x: (B, 1, hidden)) at position ``pos`` (B,):
        the C == 1 case of :meth:`paged_prefill_chunk`."""
        return self.paged_prefill_chunk(x, pool, index, page_table, pos)
