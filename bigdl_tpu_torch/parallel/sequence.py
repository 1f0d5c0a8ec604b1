"""Attention (the port of ``bigdl_tpu/parallel/sequence.py``:
``flash_profitable``, ``full_attention``, ``cached_attention``,
``paged_gather``, ``paged_write``, ``paged_write_quant``,
``paged_gather_dequant``, ``paged_attention``, ``ring_attention`` with its
two ring bodies, ``ulysses_attention``, ``sequence_attention`` and
``MultiHeadAttention``: its full-sequence ``forward`` in the three
sequence-parallel forms, its dense K/V-cache methods with the speculative
``decode_chunk``, and its paged methods).

The full-sequence forward (training) attends through ``ops.
flash_attention``: the hand-written kernels on the card, their plain
versions on the CPU. The reference picks its flash kernel by a shape
heuristic or the ``BIGDL_TPU_FLASH_ATTENTION`` flag; the port reads
neither: on the card it always takes its kernel. :func:`full_attention`
is the reference's oracle, kept for the tests.

Sequence parallelism is single-controller, as tensor parallelism is
(``parallel/layout.py``): a mesh is a list of devices (one a shard; a
device may repeat), each shard's chunk of the sequence lives on its
device, and the reference's ``ppermute`` and ``all_to_all`` are copies
and concatenations in shard order. :func:`ring_attention` runs
:func:`ring_local_flash`, the arithmetic of the reference's
``_ring_local_flash``: every (query chunk, key chunk) pair through
``flash_attention_with_lse`` and the chunks merged by logsumexp in
float32, so the backward feeds the merge's lse cotangent to the kernels.
A causal ring skips the pairs whose keys all lie after the queries, which
the reference computes and then drops with ``lse = -inf``: the same
result from ``n (n + 1) / 2`` pairs instead of ``n^2``. :func:`ring_local`
is the reference's plain online-softmax body (what its ``ring_inner``
layers run), kept for the tests. A chunk received from another shard is
only read, never written: on one card ``.to(device)`` returns the sender's
own tensor.

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
:func:`cached_attention`; :meth:`MultiHeadAttention.chunk_heads` (the
speculative verify) writes C tokens a row and attends through
:func:`paged_attention`'s per-query mask. Those three are plain PyTorch,
as the reference leaves them to XLA.

Multi-tenant LoRA (``models/lora.py``): the cache-path methods take an
optional ``lora``, one layer's ``{target: (a, b, scale)}``, and add each
target projection's delta (``nn.quantized.lora_linear``); without it they
run exactly the operations they ran before LoRA was ported.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from bigdl_tpu_torch.nn import Linear
from bigdl_tpu_torch.nn.quantized import lora_linear, scale_of
from bigdl_tpu_torch.ops.flash_attention import (flash_attention,
                                                 flash_attention_with_lse)
from bigdl_tpu_torch.parallel.layout import gather
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


def shard_sequence(x, mesh):
    """``x`` (B, H, T, D) split along T into one chunk a device of
    ``mesh``, each chunk on its device (what the reference's ``shard_map``
    hands each device). T must divide by the shard count, as there."""
    n, t = len(mesh), x.shape[2]
    if t % n:
        raise ValueError(f"sequence of {t} positions does not split evenly "
                         f"over {n} shards")
    return [c.to(d) for c, d in zip(x.chunk(n, 2), mesh)]


def ring_local_flash(qs, ks, vs, causal=False):
    """The ring body over a sequence-parallel group: ``qs``, ``ks``, ``vs``
    one (B, H, T_local, D) chunk a shard, in sequence order, each on its
    shard's device. Shard ``my`` attends to chunk ``(my - i) % n`` at ring
    step ``i`` through ``flash_attention_with_lse`` (causal only at step
    0, its own chunk; a causal ring stops after step ``my``: the later
    chunks' keys all follow its queries), then merges the steps' outputs
    by their logsumexp in float32. Returns each shard's output (B, H,
    T_local, D) in ``q``'s type on its device."""
    outs = []
    for my, q in enumerate(qs):
        steps = my + 1 if causal else len(qs)
        os_, lses = [], []
        for i in range(steps):
            src = (my - i) % len(qs)
            o, lse = flash_attention_with_lse(
                q, ks[src].to(q.device), vs[src].to(q.device),
                causal=causal and i == 0)
            os_.append(o.float())
            lses.append(lse)
        lse = torch.stack(lses)                          # (steps, B, H, T)
        w = torch.exp(lse - lse.amax(dim=0))
        denom = w.sum(dim=0).clamp_min(1e-30)
        out = sum(w[i][..., None] * os_[i] for i in range(steps))
        outs.append((out / denom[..., None]).to(q.dtype))
    return outs


def ring_local(qs, ks, vs, causal=False):
    """The reference's plain ring body (``_ring_local``: an online softmax
    over the ring steps in float32, the causal mask from global positions),
    over the same per-shard lists as :func:`ring_local_flash`; kept for the
    tests."""
    n, t = len(qs), qs[0].shape[2]
    scale = 1.0 / math.sqrt(qs[0].shape[-1])
    outs = []
    for my, q in enumerate(qs):
        dev = q.device
        o = torch.zeros(q.shape, dtype=torch.float32, device=dev)
        l = torch.zeros(q.shape[:3], dtype=torch.float32, device=dev)
        m = torch.full(q.shape[:3], float("-inf"), device=dev)
        for i in range(n):
            src = (my - i) % n
            k, v = ks[src].to(dev), vs[src].to(dev)
            s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
            if causal:
                q_pos = my * t + torch.arange(t, device=dev)
                k_pos = src * t + torch.arange(t, device=dev)
                s = s.masked_fill(~(q_pos[:, None] >= k_pos[None, :]),
                                  float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            safe_m = torch.where(torch.isfinite(m_new), m_new,
                                 torch.zeros_like(m_new))
            p = torch.exp(s - safe_m[..., None])
            p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
            corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m),
                               torch.zeros_like(m))
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + p @ v.float()
            m = m_new
        outs.append((o / l[..., None].clamp_min(1e-20)).to(q.dtype))
    return outs


def ring_attention(q, k, v, mesh, axis="seq", causal=False):
    """Attention over (B, H, T, D) with the sequence split over ``mesh``
    (a list of devices; ``axis`` is the reference's mesh-axis name, one
    axis here): :func:`ring_local_flash` over the chunks, whose outputs
    are joined along T on the first device, as the reference's sharded
    output holds them."""
    return gather(ring_local_flash(shard_sequence(q, mesh),
                                   shard_sequence(k, mesh),
                                   shard_sequence(v, mesh), causal), 2)


def ulysses_attention(q, k, v, mesh, axis="seq", causal=False):
    """All-to-all sequence parallelism (Ulysses) over ``mesh`` (a list of
    devices): each shard's sequence chunk of every head goes to the shard
    of its head group (heads ``j * H/n ... (j + 1) * H/n - 1`` to shard
    ``j``, the chunks joined along T in shard order: the reference's
    ``all_to_all(split_axis=1, concat_axis=2, tiled=True)``), each shard
    runs ``flash_attention`` over the whole sequence of its heads, and
    the inverse exchange returns each shard its chunk of every head. The
    chunks are joined along T on the first device. The heads must divide
    the shards."""
    n, h = len(mesh), q.shape[1]
    if h % n:
        raise ValueError(f"heads {h} not divisible by mesh axis {n}")
    hl = h // n

    def to_heads(x):
        chunks = shard_sequence(x, mesh)
        return [torch.cat([c[:, j * hl:(j + 1) * hl].to(dev)
                           for c in chunks], 2)
                for j, dev in enumerate(mesh)]

    outs = [flash_attention(qf, kf, vf, causal) for qf, kf, vf in
            zip(to_heads(q), to_heads(k), to_heads(v))]
    t = q.shape[2] // n
    return gather([torch.cat([o[:, :, s * t:(s + 1) * t].to(dev)
                              for o in outs], 1)
                   for s, dev in enumerate(mesh)], 2)


def sequence_attention(q, k, v, mesh, axis="seq", causal=False):
    """The reference's choice between the two: Ulysses when the heads
    divide the shards, else the ring."""
    if q.shape[1] % len(mesh) == 0:
        return ulysses_attention(q, k, v, mesh, axis, causal)
    return ring_attention(q, k, v, mesh, axis, causal)


def ring_inner_attention(mhas, xs):
    """Self-attention over a sequence-parallel group: ``mhas`` the group's
    ``MultiHeadAttention`` layers, one a shard (each shard's own copy of
    the layer, on its device), ``xs`` their (B, T_local, hidden) chunks of
    the sequence in order. Each shard projects its chunk, the ring runs
    across the group (:func:`ring_local_flash`), and each shard projects
    its output through its ``wo``. Returns the shards' outputs."""
    qkv = [m._qkv(x) for m, x in zip(mhas, xs)]
    outs = ring_local_flash(*[[t[i] for t in qkv] for i in range(3)],
                            causal=mhas[0].causal)
    return [m.wo(m.merge_heads(o)) for m, o in zip(mhas, outs)]


def attention_group(mhas, xs):
    """Each shard's attention output of its input: the ring across the
    group for ``ring_inner`` layers (:func:`ring_inner_attention`), else
    each layer's own forward."""
    if mhas[0].ring_inner:
        return ring_inner_attention(mhas, xs)
    return [m(x) for m, x in zip(mhas, xs)]


def sequence_forward(model, x, generator=None):
    """``model``'s forward through its class's ``group_forward(models, xs,
    generator)``: a ``ring_inner`` model is one shard of a sequence-parallel
    group and takes the group's list of chunks (it stands in for every
    shard's copy) and returns the list; any other model takes one input,
    the group of one."""
    sp = model.sequence_parallel
    if sp is None or sp[0] != "ring_inner":
        return type(model).group_forward([model], [x], generator)[0]
    n = sp[2]
    if not isinstance(x, (list, tuple)) or len(x) != n:
        raise ValueError(f"a ring_inner model takes its sequence-parallel "
                         f"group's list of {n} chunks")
    return type(model).group_forward([model] * n, list(x), generator)


SEQUENCE_PARALLEL_KINDS = ("ring", "ulysses", "ring_inner")


class MultiHeadAttention(nn.Module):
    """Multi-head self-attention: :meth:`forward` over whole sequences
    (``causal`` masks later keys) and the paged methods, which are always
    causal. ``wq``, ``wk``, ``wv``, ``wo`` are bias-free, as in the
    reference.

    ``sequence_parallel`` takes the reference's three forms, a mesh being
    a list of devices here:

    - ``("ring", mesh, axis)`` / ``("ulysses", mesh, axis)``: ``forward``
      takes a whole (B, T, hidden) input and attends through
      :func:`ring_attention` / :func:`ulysses_attention` over ``mesh``;
    - ``("ring_inner", axis, n)``: the layer is one shard of a
      sequence-parallel group of ``n``; ``forward`` takes the group's list
      of ``n`` chunks and returns the list (:func:`ring_inner_attention`
      with this layer standing in for every shard's copy).

    The dense and paged cache methods refuse a sequence-parallel layer,
    as the reference's ``prefill`` does.

    ``tp > 1`` builds one tensor-parallel shard of the layer: it holds
    ``local_heads = n_heads // tp`` of the heads (``wq``/``wk``/``wv``
    hidden -> local_heads * head_dim, ``wo`` back to hidden), its dense
    caches and paged pools hold those heads, and its cache methods return
    ``wo``'s partial, which the caller sums over the shards
    (``parallel/tensor_parallel.py``). ``n_heads`` stays the model's."""

    @classmethod
    def native_spec(cls):
        """The native format's entry (``utils/serializer.py``): the
        reference's attention record, the class its ``MultiHeadAttention``
        makes; the model that holds the layer builds it."""
        from bigdl_tpu_torch.utils.serializer import NativeSpec, built_inside
        return NativeSpec(
            "bigdl_tpu.parallel.sequence:MultiHeadAttention.__new__."
            "<locals>._MHA", cls,
            "hidden_size n_heads head_dim causal sequence_parallel "
            "use_flash use_paged_kernel paged_kernel_mesh",
            extra={"use_flash": lambda m: None,
                   "use_paged_kernel": lambda m: False,
                   "paged_kernel_mesh": lambda m: None},
            build=built_inside("model"), name="_MHA")

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
            if sequence_parallel[0] not in SEQUENCE_PARALLEL_KINDS:
                raise ValueError(f"sequence_parallel kind "
                                 f"{sequence_parallel[0]!r} not in "
                                 f"{SEQUENCE_PARALLEL_KINDS}")
            if tp > 1:
                raise ValueError("sequence_parallel does not compose with "
                                 "tp")
        self.sequence_parallel = sequence_parallel
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

    def _qkv(self, x, lora=None):
        b, t, _ = x.shape

        def split(name):
            y = lora_linear(getattr(self, name), x,
                            None if lora is None else lora.get(name))
            return (y.reshape(b, t, self.local_heads, self.head_dim)
                    .transpose(1, 2).contiguous())

        return split("wq"), split("wk"), split("wv")

    @property
    def ring_inner(self):
        sp = self.sequence_parallel
        return sp is not None and sp[0] == "ring_inner"

    def _refuse_sequence_parallel(self):
        if self.sequence_parallel is not None:
            raise ValueError("KV-cache decoding does not compose with "
                             "sequence_parallel; build the model without it "
                             "for generation")

    def forward(self, x):
        """Self-attention over x (B, T, hidden) (the reference's ``call``):
        through the flash kernel, or over ``sequence_parallel``'s mesh; a
        ``ring_inner`` layer takes and returns its group's list of
        chunks (see the class docstring)."""
        sp = self.sequence_parallel
        if self.ring_inner:
            if len(x) != sp[2]:
                raise ValueError(f"a ring_inner layer of {sp[2]} shards got "
                                 f"{len(x)} chunks")
            return ring_inner_attention([self] * len(x), list(x))
        b, t, hs = x.shape
        q, k, v = self._qkv(x)
        if sp is None:
            out = flash_attention(q, k, v, causal=self.causal)
        else:
            kind, mesh, axis = sp
            attend = ring_attention if kind == "ring" else ulysses_attention
            out = attend(q, k, v, mesh, axis, causal=self.causal).to(x.device)
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

    def paged_qkv(self, x, pool, index, lora=None):
        """The first half of the paged chunk and decode paths: the queries
        (B, H, C, D) of x (B, C, hidden), with the chunk's own K/V written
        into ``pool`` at ``index`` first, so that the queries attending
        through the page table (``ops.paged_attention``, every visible
        position at or before their own) see them. Returns (q, pool)."""
        self._refuse_sequence_parallel()
        q, k, v = self._qkv(x, lora)
        return q, self._paged_write(pool, k, v, index)

    def merge_heads(self, out):
        """The attention output (B, H, C, D) as ``wo``'s input (B, C,
        H * D)."""
        b, _, t, _ = out.shape
        return out.transpose(1, 2).reshape(b, t,
                                           self.local_heads * self.head_dim)

    def project_heads(self, out, lora=None):
        """The attention output (B, H, C, D) through ``wo`` (a shard's
        pre-reduction partial when tp > 1): the second half of the paged
        and dense cache paths."""
        return lora_linear(self.wo, self.merge_heads(out),
                           None if lora is None else lora.get("wo"))

    # ------------------------------------------------ dense K/V cache --
    def init_cache(self, batch, max_len, dtype, device):
        """Preallocated K/V buffers for incremental decoding: ``{"k",
        "v"}`` of (batch, local_heads, max_len, head_dim) zeros."""
        shape = (batch, self.local_heads, max_len, self.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def prefill_heads(self, x, cache, rows=None, lora=None):
        """The prompt pass before ``wo``: the causal attention output (B,
        H, T, D) of x (B, T, hidden), with the prompt's K/V written into
        ``cache`` at positions [0, T), in place. ``rows`` None writes row
        ``i`` of x into cache row ``i``; else ``rows`` (n,) names the
        cache rows that x's first n rows land in (the rest of x's rows
        are padding and write nothing). On the card, the flash kernel
        where :func:`flash_profitable` holds; else :func:`full_attention`."""
        self._refuse_sequence_parallel()
        if not self.causal:
            raise ValueError("KV-cache prefill requires causal attention")
        t = x.shape[1]
        q, k, v = self._qkv(x, lora)
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

    def decode_heads(self, x, cache, index, lora=None):
        """One query token per row (x: (B, 1, hidden)) before ``wo``: its
        K/V written at ``index`` (an int: every row's position; or a (B,)
        tensor: each row's own), in place, then :func:`cached_attention`
        over positions [0, index]. Returns (B, H, 1, D)."""
        self._refuse_sequence_parallel()
        q, k, v = self._qkv(x, lora)
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

    def chunk_heads(self, x, cache, index, q_pos, lora=None):
        """The speculative verify before ``wo`` (the reference's
        ``decode_chunk``): C query tokens a row (x: (B, C, hidden)) write
        their K/V at ``index`` ((3, n) from ``models.gpt.dense_chunk_plan``:
        flat token, cache row, position; positions at or past the cache
        length were left out, the reference's dropped writes), in place,
        then attend through :func:`paged_attention`'s per-query mask at
        absolute positions ``q_pos`` (B, C). Returns (B, H, C, D)."""
        self._refuse_sequence_parallel()
        q, k, v = self._qkv(x, lora)
        tok, row, pos = index
        for name, new in (("k", k), ("v", v)):
            buf = cache[name]
            b, h, c, d = new.shape
            buf[row, :, pos] = new.transpose(1, 2).reshape(
                b * c, h, d)[tok].to(buf.dtype)
        return paged_attention(q, cache["k"], cache["v"], q_pos)
