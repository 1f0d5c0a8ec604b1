"""Paged attention: chunk/decode attention straight against the paged
K/V pool (the port of ``bigdl_tpu/ops/paged_attention.py``).

The serving path stores K/V in one pool per layer, ``(num_pages, H,
page_size, D)``, and each slot reaches its tokens through an int32 page
table whose entries ``>= num_pages`` mean "no page". Query ``c`` of row
``b`` sits at absolute position ``start[b] + c`` (the reference's chunk
contract ``q_pos[b, c] == q_pos[b, 0] + c``) and sees key position ``j``
iff ``j <= start[b] + c`` and ``j``'s table entry is a real page.

An int8 pool (``{"k", "v"}`` int8 plus float32 ``{"k_scale", "v_scale"}``
of (num_pages, H, page_size)) is read as ``k.float() * k_scale[..., None]``
(the reference's ``_decode_kernel_quant``); the rest is the same.

- :func:`paged_pool_attention` is the wrapper: for CUDA tensors it
  launches the hand-written kernel ``ops/csrc/paged_attention.cuh`` for
  the pool's type (or raises), through ``paged_attention.cu`` for a float
  pool and ``paged_attention_int8.cu`` for an int8 one (two sources, built
  in parallel), for CPU tensors it runs
  :func:`paged_pool_attention_ref`. ``paged_pool_attention.launches``
  counts launches over float pools, ``.int8_launches`` over int8 pools;
  an int8 pool is never dequantised into a float one for the kernel.
- :func:`paged_pool_attention_ref` is the plain PyTorch version: gather
  through the clamped table (dequantising an int8 pool), mask with
  ``NEG_INF``, softmax, weighted sum.
- :func:`paged_plan` mirrors the kernel's launch on the host: a cluster of
  SPLIT CTAs per (slot, head, query tile), each walking its run of the
  tile's visible pages (:func:`page_split`, which depends on the row
  alone), the built width a head dim runs on (:func:`kernel_width`), the
  ring's stages, the bytes of one staging copy and the dynamic shared
  memory of each instantiation.

The kernel is built at the widths ``KERNEL_HEAD_DIMS`` (32, 64, 96, 128
and 256) and runs any head_dim up to 256 on the narrowest at or above it,
over pools that keep their true row width: the staged rows' columns past
the head_dim are zeros, and nothing past it is written. A head_dim above
256 raises, naming the ROADMAP queue C item that keeps it open.

A row with no visible key at all (an all-sentinel table row: padding and
inactive slots) comes out as zeros on both paths; callers discard it.

Tensor parallelism (the reference's ``mesh=`` branch, which runs its
kernel under ``shard_map``, one copy on each chip's head shard): with
``mesh=`` (one device per shard) every argument is a per-shard sequence,
each shard's pool its own tensors holding that shard's heads, and its
copy of the shared page table and starts on its device (the caller
copies them once per dispatch, not once per layer). The grid is
head-local, so the wrapper launches the same kernel once per shard, on
the shard's device, over the shard's own pool; there are no
collectives, and the shards' outputs, joined on the head axis, are the
unsharded call's. ``paged_pool_attention.sharded_calls`` counts these
calls (on any device; each shard's launch counts in ``launches`` or
``int8_launches`` as above).
"""

from __future__ import annotations

import ctypes

import torch

from bigdl_tpu_torch.ops import NEG_INF, _build

# (page_size, built width) pairs the CUDA kernel is instantiated for: pages
# of 8, 16 (the default) and 32 tokens at every multiple of 32 up to 128
# (GPT-2's 64 among them) and at 256; a head_dim runs on the narrowest
# width at or above it
PAGE_SIZES = (8, 16, 32)
KERNEL_HEAD_DIMS = (32, 64, 96, 128, 256)
KERNEL_SHAPES = tuple((ps, d) for d in KERNEL_HEAD_DIMS for ps in PAGE_SIZES)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the kernel's launch (ops/csrc/paged_attention.cuh): CTAs of a cluster (the
# splits of one page walk), threads a CTA, pages in its ring, queries of a
# chunk CTA (a decode CTA takes the one query), bytes after a staged row
SPLIT = 8
THREADS = 128
STAGES = 4
QUERY_TILE = 16
ROW_PAD = 16
MAX_SMEM = 232448
# the most bytes a ring of STAGES pages may take; past it the ring holds 2
RING_BYTES = 160 * 1024


def _declare(lib):
    fn = lib.bigdl_paged_attention
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int


def _declare_int8(lib):
    fn = lib.bigdl_paged_attention_int8
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int


def _is_int8(pool):
    return "k_scale" in pool


def paged_pool_attention_ref(q, pool, page_table, start, sm_scale=None):
    """Plain PyTorch paged attention (see module docstring).

    ``q``: (B, H, C, D); ``pool``: ``{"k", "v"}`` of (N, H, page_size,
    D), int8 ones with ``{"k_scale", "v_scale"}`` of (N, H, page_size);
    ``page_table``: (B, P) int; ``start``: (B,) int. Returns (B, H, C, D)
    in ``q.dtype``, computed in float32."""
    b, h, c, d = q.shape
    n, _, ps, _ = pool["k"].shape
    p = page_table.shape[1]
    if sm_scale is None:
        sm_scale = d ** -0.5
    table = page_table.to(q.device, torch.long)
    real = (table >= 0) & (table < n)                          # (B, P)
    idx = table.clamp(0, n - 1)

    def gather(name):
        g = pool[name][idx].float()                            # (B,P,H,ps,D)
        if _is_int8(pool):
            g = g * pool[f"{name}_scale"][idx][..., None]
        return g.permute(0, 2, 1, 3, 4).reshape(b, h, p * ps, d)

    kf, vf = gather("k"), gather("v")
    s = torch.einsum("bhcd,bhkd->bhck", q.float(), kf) * sm_scale
    kpos = torch.arange(p * ps, device=q.device)
    qpos = (start.to(q.device, torch.long)[:, None]
            + torch.arange(c, device=q.device)[None, :])       # (B, C)
    valid = ((kpos[None, None, :] <= qpos[:, :, None])
             & real.repeat_interleave(ps, dim=1)[:, None, :])  # (B, C, K)
    s = torch.where(valid[:, None], s, torch.full_like(s, NEG_INF))
    out = torch.einsum("bhck,bhkd->bhcd", torch.softmax(s, dim=-1), vf)
    seen = valid.any(dim=-1)[:, None, :, None]                 # (B,1,C,1)
    out = torch.where(seen, out, torch.zeros_like(out))
    return out.to(q.dtype)


def page_split(npages):
    """The runs of a walk over ``npages`` pages that the SPLIT CTAs of a
    cluster take: CTA ``r`` walks pages ``[lo, hi)`` of the r-th pair.
    Each run holds ``ceil(npages / SPLIT)`` pages; the last ones hold
    fewer, or none."""
    per = -(-npages // SPLIT)
    return [(min(npages, r * per), min(npages, (r + 1) * per))
            for r in range(SPLIT)]


def kernel_width(head_dim):
    """The built width that runs ``head_dim``: the narrowest of
    KERNEL_HEAD_DIMS at or above it, or None above 256."""
    return next((w for w in KERNEL_HEAD_DIMS if 0 < head_dim <= w), None)


def copy_bytes(head_dim, elt):
    """Bytes of one staging copy of a pool row of ``head_dim`` values of
    ``elt`` bytes: the largest of 16, 8 and 4 that divides the row (the
    kernel's cp.async sizes), else 1 (plain loads)."""
    row = head_dim * elt
    return next(n for n in (16, 8, 4, 1) if row % n == 0)


def paged_plan(b, h, c, d, page_size, table_width, starts, kv_dtype):
    """Host-side plan of one kernel launch on (b, h, c, d) queries over a
    pool of ``kv_dtype`` ("float32", "bfloat16" or "int8") with pages of
    ``page_size``, a page table ``table_width`` wide and the rows' starts,
    as the C entry makes it:

    - grid (SPLIT, b * h, query tiles), a cluster of SPLIT CTAs of THREADS
      per (slot, head, query tile); decode (c == 1) takes one query a CTA,
      a chunk QUERY_TILE;
    - ``splits[row][tile]``: the tile's pages, ``min(table_width, (start +
      last query) // page_size + 1)``, cut by :func:`page_split`. They
      depend on the row alone, never on b, h or a head shard;
    - ``head_dim``: the built width :func:`kernel_width` names for ``d``;
      ``copy_bytes``: one staging copy of a row of ``d`` values
      (:func:`copy_bytes`);
    - shared memory: ``stages`` ring stages (STAGES, or 2 where STAGES
      stages would pass RING_BYTES), each the page's K and V rows (room
      for the built width and ROW_PAD bytes) and an int8 page's two scale
      rows; the queries in float32 at the built width; the partial states
      (m, l, acc) of the four warps (decode) or of each query (chunk); and
      the slot's table row (``table_width`` int32, rounded up to 16
      bytes)."""
    w = kernel_width(d)
    if w is None:
        raise ValueError(f"paged_plan: head_dim {d} above "
                         f"{KERNEL_HEAD_DIMS[-1]}")
    tile = 1 if c == 1 else QUERY_TILE
    elt = {"float32": 4, "bfloat16": 2, "int8": 1}[kv_dtype]
    row = w * elt + ROW_PAD
    stage = 2 * page_size * row + (2 * page_size * 4 if elt == 1 else 0)
    stages = STAGES if STAGES * stage <= RING_BYTES else 2
    smem = (stages * stage + tile * w * 4
            + (4 if tile == 1 else tile) * (w + 2) * 4
            + -(-table_width * 4 // 16) * 16)
    tiles = -(-c // tile)
    splits = []
    for st in starts:
        row_splits = []
        for t in range(tiles):
            last = st + min(c, (t + 1) * tile) - 1
            row_splits.append(page_split(
                min(table_width, last // page_size + 1)))
        splits.append(row_splits)
    return {"grid": (SPLIT, b * h, tiles), "cluster": SPLIT,
            "threads": THREADS, "query_tile": tile, "stages": stages,
            "head_dim": w, "copy_bytes": copy_bytes(d, elt),
            "smem_bytes": smem, "splits": splits}


def _check_cuda_args(q, pool, page_table, start):
    dev = q.device
    k, v = pool["k"], pool["v"]
    for name, t in ([(f"pool {n}", t) for n, t in pool.items()]
                    + [("page_table", page_table), ("start", start)]):
        if t.device != dev:
            raise ValueError(f"paged_pool_attention: {name} is on "
                             f"{t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"paged_pool_attention: {name} must be "
                             f"contiguous")
        if name.startswith("pool") and t.data_ptr() % 16:
            raise ValueError(f"paged_pool_attention: {name} must be "
                             f"16-byte aligned (the kernel stages pages by "
                             f"16-byte copies)")
    if not q.is_contiguous():
        raise ValueError("paged_pool_attention: q must be contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_pool_attention: q dtype {q.dtype} not in "
                        f"(float32, bfloat16)")
    kv_dtype = torch.int8 if _is_int8(pool) else q.dtype
    if k.dtype != kv_dtype or v.dtype != kv_dtype:
        raise TypeError(f"paged_pool_attention: pool dtypes ({k.dtype}, "
                        f"{v.dtype}) for q {q.dtype}: want {kv_dtype}")
    if _is_int8(pool):
        for name in ("k_scale", "v_scale"):
            sc = pool[name]
            if sc.dtype != torch.float32 or sc.shape != k.shape[:3]:
                raise ValueError(f"paged_pool_attention: {name} must be "
                                 f"float32 of {tuple(k.shape[:3])}")
    if page_table.dtype != torch.int32 or start.dtype != torch.int32:
        raise TypeError("paged_pool_attention: page_table and start must "
                        "be int32")
    b, h, c, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[1] != h \
            or k.shape[3] != d:
        raise ValueError(f"paged_pool_attention: pool shape {tuple(k.shape)}"
                         f" does not match q {tuple(q.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or tuple(start.shape) != (b,):
        raise ValueError("paged_pool_attention: page_table must be (B, P) "
                         "and start (B,)")
    if k.shape[2] not in PAGE_SIZES:
        raise ValueError(f"paged_pool_attention: page_size {k.shape[2]} not "
                         f"in {PAGE_SIZES}")
    if kernel_width(d) is None:
        raise ValueError(f"paged_pool_attention: head_dim {d} above "
                         f"{KERNEL_HEAD_DIMS[-1]}; larger head dims wait for "
                         f"ROADMAP queue C, 'flash and paged head dims above "
                         f"256'")


def paged_pool_attention(q, pool, page_table, start, sm_scale=None,
                         mesh=None):
    """Chunk/decode attention against the paged pool: the CUDA kernel for
    CUDA tensors, :func:`paged_pool_attention_ref` for CPU tensors.

    ``q``: (B, H, C, D) float32 or bfloat16; ``pool``: ``{"k", "v"}`` of
    (N, H, page_size, D) in ``q``'s dtype, or int8 with float32 ``{"k_scale",
    "v_scale"}`` of (N, H, page_size); ``page_table``: (B, P) int32 with
    sentinel ``>= N``; ``start``: (B,) int32 absolute position of each
    row's first query. Returns (B, H, C, D) in ``q.dtype``.

    ``mesh``: None, or the shards' devices (one per shard; a device may
    repeat). Then ``q``, ``pool``, ``page_table`` and ``start`` are
    per-shard sequences, shard ``i``'s on ``mesh[i]`` (its ``q`` and
    ``pool`` with that shard's heads), and the call returns the list of
    per-shard outputs (see module docstring)."""
    if mesh is not None:
        return _sharded(q, pool, page_table, start, sm_scale, mesh)
    if q.dim() != 4:
        raise ValueError("paged_pool_attention expects q of (B, H, C, D)")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        return paged_pool_attention_ref(q, pool, page_table, start,
                                        sm_scale)
    _check_cuda_args(q, pool, page_table, start)
    b, h, c, d = q.shape
    k, v = pool["k"], pool["v"]
    n, _, ps, _ = k.shape
    out = torch.empty_like(q)
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    tail = (page_table.data_ptr(), start.data_ptr(), out.data_ptr(), b, h,
            c, d, n, ps, page_table.shape[1], float(sm_scale),
            _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if _is_int8(pool):
        lib = _build.load("paged_attention_int8", _declare_int8)
        err = lib.bigdl_paged_attention_int8(
            *head, pool["k_scale"].data_ptr(), pool["v_scale"].data_ptr(),
            *tail)
    else:
        lib = _build.load("paged_attention", _declare)
        err = lib.bigdl_paged_attention(*head, *tail)
    if err != 0:
        raise RuntimeError(f"paged attention kernel launch failed: "
                           f"cudaError_t {err}")
    if _is_int8(pool):
        paged_pool_attention.int8_launches += 1
    else:
        paged_pool_attention.launches += 1
    return out


paged_pool_attention.launches = 0
paged_pool_attention.int8_launches = 0
paged_pool_attention.sharded_calls = 0


def _sharded(qs, pools, tables, starts, sm_scale, mesh):
    """The ``mesh=`` branch: one call of the unsharded wrapper per shard,
    on the shard's device and its own pool."""
    devices = [torch.device(d) for d in mesh]
    args = (qs, pools, tables, starts)
    if not all(isinstance(a, (list, tuple)) for a in args):
        raise ValueError("paged_pool_attention(mesh=...) takes per-shard "
                         "sequences of q, pool, page_table and start")
    if {len(a) for a in args} != {len(devices)}:
        raise ValueError(f"paged_pool_attention: {[len(a) for a in args]} "
                         f"shards of q, pool, page_table and start for a "
                         f"mesh of {len(devices)}")
    heads = {q.shape[1] for q in qs}
    if len(heads) != 1:
        raise ValueError(f"paged_pool_attention: shards hold different "
                         f"head counts {sorted(heads)}")
    if sm_scale is None:
        sm_scale = qs[0].shape[-1] ** -0.5
    outs = []
    for q, pool, table, st, dev in zip(qs, pools, tables, starts, devices):
        if q.device != dev:
            raise ValueError(f"paged_pool_attention: a query shard is on "
                             f"{q.device}, its mesh device is {dev}")
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                outs.append(paged_pool_attention(q, pool, table, st,
                                                 sm_scale))
        else:
            outs.append(paged_pool_attention(q, pool, table, st, sm_scale))
    paged_pool_attention.sharded_calls += 1
    return outs


def bytes_and_flops(q, pool, page_table, start):
    """The least HBM bytes and the float operations one call needs on
    these inputs: q read and out written once, the table and starts read
    once, and each distinct visible (page, offset) of K and V read once
    (an int8 pool: 1 byte an element plus its 4-byte (token, head)
    scale); 4*D flops per (query, visible key) pair. Used for the roofline
    bound of the kernel's timing. Per-shard sequences of ``q`` and
    ``pool`` (a ``mesh=`` call) give the unsharded call's figures: the
    work is the same, split by heads."""
    if isinstance(q, (list, tuple)):
        h = sum(x.shape[1] for x in q)
        q, pool = q[0], pool[0]
        b, _, c, d = q.shape
    else:
        b, h, c, d = q.shape
    k = pool["k"]
    n, _, ps, _ = k.shape
    elt = q.element_size()
    kv_row = d + 4 if _is_int8(pool) else d * k.element_size()
    table = page_table.cpu().long()
    st = start.cpu().long()
    seen, pairs = set(), 0
    for row in range(b):
        last = int(st[row]) + c - 1
        for pos in range(min(last + 1, table.shape[1] * ps)):
            page = int(table[row, pos // ps])
            if 0 <= page < n:
                seen.add((page, pos % ps))
                # queries of this row that see key `pos`
                pairs += min(c, last - pos + 1)
    kv_bytes = 2 * len(seen) * h * kv_row
    io_bytes = 2 * b * h * c * d * elt + 4 * (table.numel() + st.numel())
    return kv_bytes + io_bytes, 4 * d * h * pairs


__all__ = ["paged_pool_attention", "paged_pool_attention_ref",
           "bytes_and_flops", "page_split", "paged_plan", "kernel_width",
           "copy_bytes", "KERNEL_SHAPES", "KERNEL_HEAD_DIMS", "PAGE_SIZES"]
