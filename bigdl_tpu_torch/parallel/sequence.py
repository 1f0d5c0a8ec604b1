"""Attention (the port of ``bigdl_tpu/parallel/sequence.py``:
``flash_profitable``, ``full_attention``, ``cached_attention``,
``paged_gather``, ``paged_write``, ``paged_write_quant``,
``paged_gather_dequant``, ``paged_attention`` and ``MultiHeadAttention``'s
full-sequence ``forward``, its dense K/V-cache methods and its paged
methods).

The full-sequence forward (training) attends through ``ops.
flash_attention``: the hand-written kernels on the card, their plain
versions on the CPU. The reference picks its flash kernel by a shape
heuristic or the ``BIGDL_TPU_FLASH_ATTENTION`` flag; the port reads
neither: on the card it always takes its kernel. :func:`full_attention`
is the reference's oracle, kept for the tests.

K/V live in one pool per layer, ``(num_pages, H, page_size, D)``; slots
reach their tokens through int32 page tables whose entries ``>=
num_pages`` are the "no page" sentinel. An int8 pool (``init_paged_pool(
dtype=torch.int8)``) adds float32 ``k_scale``/``v_scale`` planes of (num_pages,
H, page_size): every written token and head is quantised against its own
amax (:func:`paged_write_quant`), and readers dequantise ``int8 * scale``.

Two traps of the reference's XLA semantics are explicit here:

- out-of-bounds WRITES: JAX drops a scatter to a sentinel page
  (``mode="drop"``); a CUDA scatter would hit a device-side assert. So
  :func:`paged_write_index` filters the masked tokens out on the host,
  once per dispatch, before :func:`paged_write` scatters;
- out-of-bounds READS: JAX clips them (``mode="clip"``); the gathers
  here clamp explicitly.

The paged serving path attends through ``ops.paged_attention`` between
:meth:`MultiHeadAttention.paged_qkv` and
:meth:`MultiHeadAttention.project_heads` (``models.gpt``'s layer body):
the hand-written kernel on the card, its plain version on the CPU, both with the kernel's ``NEG_INF``
fill. :func:`paged_gather` + :func:`paged_attention` are the reference's
XLA path, with its ``-inf`` fill (a fully masked row gives NaN there),
and are kept for the tests.

The dense K/V cache (``generate`` and the dense serving engine) is one
``(B, H, max_len, D)`` pair of buffers per layer, written in place:
:meth:`MultiHeadAttention.prefill` writes a prompt's K/V at positions
``[0, T)`` and attends causally, through the flash kernel on the card
exactly where the reference's gate (:func:`flash_profitable`) takes its
Pallas kernel, else through :func:`full_attention`;
:meth:`MultiHeadAttention.decode_step` writes one token's K/V at
``index`` (a scalar, or one position a row) and attends through
:func:`cached_attention`. Those two are plain PyTorch, as the reference
leaves them to XLA.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from bigdl_tpu_torch.nn import Linear
from bigdl_tpu_torch.nn.quantized import scale_of
from bigdl_tpu_torch.ops.flash_attention import flash_attention
from bigdl_tpu_torch.utils.device import resolve_device


def flash_profitable(t, causal=False):
    """The reference's shape gate for its flash kernel in a dense prefill
    or forward: ``t % 128 == 0`` and ``t >= 2048`` causal (8192 full). The
    port's dense prefill takes its flash kernel exactly there, when its
    tensors are on the card (the reference's other condition is a TPU
    backend)."""
    return t % 128 == 0 and t >= (2048 if causal else 8192)


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


def cached_attention(q, k, v, cur_len):
    """Single-query attention against a preallocated K/V cache (the decode
    step's inner op): ``q`` (B, H, 1, D); ``k``/``v`` (B, H, S, D) of which
    the first ``cur_len`` positions hold keys, the rest masked with
    ``-inf``. ``cur_len`` is an int or a 0-d tensor (every row at the same
    length: ``generate``), or a (B,) tensor (each row at its own: the
    serving engine's slot batch)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = k.shape[2]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    cur = torch.as_tensor(cur_len, device=q.device).reshape(-1, 1)
    valid = torch.arange(s, device=q.device)[None, :] < cur      # (1|B, S)
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
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


def paged_write_quant(pool, scales, new, index):
    """Quantise-on-write :func:`paged_write` for int8 pools: each written
    (token, head) vector of ``new`` (B, H, C, D) is quantised against its
    own amax (``scale = max(amax, 1e-8) / 127``, round half to even, clip
    to +-127); the int8 values land in ``pool`` (N, H, page_size, D) and
    the float32 scale in ``scales`` (N, H, page_size) at the same (page,
    head, offset), in place, at the writes of ``index``. Returns
    ``(pool, scales)``."""
    b, h, c, d = new.shape
    rows, pg, off = index
    vals = new.transpose(1, 2).reshape(b * c, h, d)[rows].float()
    sc = scale_of(vals.abs().amax(dim=-1))                       # (n, H)
    pool[pg, :, off, :] = torch.clamp(torch.round(vals / sc[..., None]),
                                      -127, 127).to(torch.int8)
    scales[pg, :, off] = sc
    return pool, scales


def paged_gather_dequant(pool, scales, page_table, dtype):
    """The reference's XLA read of an int8 pool, kept for the tests: the
    :func:`paged_gather` view of ``pool`` times the gathered ``scales``
    (same clamped table), in ``dtype``: (B, H, P*page_size, D)."""
    k = paged_gather(pool, page_table)
    b, p = page_table.shape
    _, h, ps = scales.shape
    idx = page_table.to(scales.device, torch.long).clamp(0, scales.shape[0]
                                                         - 1)
    s = scales[idx].permute(0, 2, 1, 3).reshape(b, h, p * ps)
    return k.to(dtype) * s[..., None].to(dtype)


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
    ported yet.

    ``tp > 1`` builds one tensor-parallel shard of the layer: it holds
    ``local_heads = n_heads // tp`` of the heads (``wq``/``wk``/``wv``
    hidden -> local_heads * head_dim, ``wo`` back to hidden), its dense
    caches and paged pools hold those heads, and its cache methods return
    ``wo``'s partial, which the caller sums over the shards
    (``parallel/tensor_parallel.py``). ``n_heads`` stays the model's."""

    def __init__(self, hidden_size, n_heads, causal=False,
                 sequence_parallel=None, tp=1, device=None,
                 dtype=torch.float32):
        super().__init__()
        if hidden_size % n_heads:
            raise ValueError(f"hidden_size {hidden_size} must be divisible "
                             f"by n_heads {n_heads}")
        if n_heads % tp:
            raise ValueError(f"n_heads ({n_heads}) must be divisible by tp "
                             f"({tp})")
        if sequence_parallel is not None:
            raise NotImplementedError(
                "sequence_parallel (ring/Ulysses attention) is not ported "
                "yet: ROADMAP A.10/A.11")
        self.causal = causal
        self.hidden_size = hidden_size
        self.n_heads = n_heads
        self.local_heads = n_heads // tp
        self.head_dim = hidden_size // n_heads
        local = self.local_heads * self.head_dim
        kw = dict(with_bias=False, device=resolve_device(device),
                  dtype=dtype)
        self.wq = Linear(hidden_size, local, **kw)
        self.wk = Linear(hidden_size, local, **kw)
        self.wv = Linear(hidden_size, local, **kw)
        self.wo = Linear(local, hidden_size, **kw)

    def _qkv(self, x):
        b, t, _ = x.shape

        def split(proj):
            return (proj(x).reshape(b, t, self.local_heads, self.head_dim)
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
        local_heads, page_size, head_dim) zeros (so never-written slots
        hold finite values); ``dtype=torch.int8`` adds the float32
        ``k_scale`` and ``v_scale`` planes of (num_pages, local_heads,
        page_size). Every plane is a tensor of its own."""
        shape = (num_pages, self.local_heads, page_size, self.head_dim)
        pool = {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
        if dtype == torch.int8:
            for name in ("k_scale", "v_scale"):
                pool[name] = torch.zeros(shape[:3], dtype=torch.float32,
                                         device=device)
        return pool

    def _paged_write(self, pool, k, v, index):
        """Write new K/V through the page table, in place; an int8 pool
        (marked by its scale planes) quantises on write."""
        if "k_scale" in pool:
            paged_write_quant(pool["k"], pool["k_scale"], k, index)
            paged_write_quant(pool["v"], pool["v_scale"], v, index)
        else:
            paged_write(pool["k"], k, index)
            paged_write(pool["v"], v, index)
        return pool

    def paged_qkv(self, x, pool, index):
        """The first half of the paged chunk and decode paths: the queries
        (B, H, C, D) of x (B, C, hidden), with the chunk's own K/V written
        into ``pool`` at ``index`` first, so that the queries attending
        through the page table (``ops.paged_attention``, every visible
        position at or before their own) see them. Returns (q, pool)."""
        q, k, v = self._qkv(x)
        return q, self._paged_write(pool, k, v, index)

    def merge_heads(self, out):
        """The attention output (B, H, C, D) as ``wo``'s input (B, C,
        H * D)."""
        b, _, t, _ = out.shape
        return out.transpose(1, 2).reshape(b, t,
                                           self.local_heads * self.head_dim)

    def project_heads(self, out):
        """The attention output (B, H, C, D) through ``wo`` (a shard's
        pre-reduction partial when tp > 1): the second half of the paged
        and dense cache paths."""
        return self.wo(self.merge_heads(out))

    # ------------------------------------------------ dense K/V cache --
    def init_cache(self, batch, max_len, dtype, device):
        """Preallocated K/V buffers for incremental decoding: ``{"k",
        "v"}`` of (batch, local_heads, max_len, head_dim) zeros."""
        shape = (batch, self.local_heads, max_len, self.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def prefill_heads(self, x, cache, rows=None):
        """The prompt pass before ``wo``: the causal attention output (B,
        H, T, D) of x (B, T, hidden), with the prompt's K/V written into
        ``cache`` at positions [0, T), in place. ``rows`` None writes row
        ``i`` of x into cache row ``i``; else ``rows`` (n,) names the
        cache rows that x's first n rows land in (the rest of x's rows
        are padding and write nothing). On the card, the flash kernel
        where :func:`flash_profitable` holds; else :func:`full_attention`."""
        if not self.causal:
            raise ValueError("KV-cache prefill requires causal attention")
        t = x.shape[1]
        q, k, v = self._qkv(x)
        for name, new in (("k", k), ("v", v)):
            buf = cache[name]
            if rows is None:
                buf[:, :, :t] = new.to(buf.dtype)
            else:
                buf[rows, :, :t] = new[:rows.shape[0]].to(buf.dtype)
        if x.is_cuda and flash_profitable(t, True):
            return flash_attention(q, k, v, causal=True)
        return full_attention(q, k, v, causal=True)

    def prefill(self, x, cache):
        """Prompt pass of K/V-cache decoding (the reference's ``prefill``):
        ``(wo(attention), cache)``; see :meth:`prefill_heads`."""
        return self.project_heads(self.prefill_heads(x, cache)), cache

    def decode_heads(self, x, cache, index):
        """One query token per row (x: (B, 1, hidden)) before ``wo``: its
        K/V written at ``index`` (an int: every row's position; or a (B,)
        tensor: each row's own), in place, then :func:`cached_attention`
        over positions [0, index]. Returns (B, H, 1, D)."""
        q, k, v = self._qkv(x)
        idx = torch.as_tensor(index, device=x.device)
        for name, new in (("k", k), ("v", v)):
            buf = cache[name]
            if idx.dim() == 0:
                buf[:, :, idx] = new[:, :, 0].to(buf.dtype)
            else:
                buf[torch.arange(buf.shape[0], device=x.device), :, idx] = \
                    new[:, :, 0].to(buf.dtype)
        return cached_attention(q, cache["k"], cache["v"], idx + 1)

    def decode_step(self, x, cache, index):
        """Incremental mode (the reference's ``decode_step``): ``(wo(
        attention), cache)``; see :meth:`decode_heads`."""
        return self.project_heads(self.decode_heads(x, cache, index)), cache
