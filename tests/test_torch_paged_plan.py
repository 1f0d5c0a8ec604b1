"""The host side of the port's paged-attention kernel
(``bigdl_tpu_torch/ops/paged_attention.py``, ``ops/csrc/paged_attention.cu``):

- ``paged_plan`` mirrors the launch: a cluster of SPLIT CTAs per (slot,
  head, query tile), each walking its run of the tile's visible pages.
  The runs depend on the row alone, the same at every B, H and head
  shard (what keeps a tp launch bit-equal to the unsharded one), and
  every instantiation's shared memory fits a CTA;
- a plain PyTorch emulation of the kernel's split and merge (each CTA's
  and, at decode, each warp's partial softmax state over its keys, merged
  in the kernel's fixed order) matches the plain version and the
  reference's Pallas kernel in interpret mode, over float32 and int8
  pools, decode and a chunk of two query tiles. Tolerance 1e-5 (atol =
  rtol): the same float32 arithmetic summed in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.paged_attention import \
    paged_pool_attention as jax_paged_pool_attention
from bigdl_tpu.parallel.sequence import \
    paged_write_quant as jax_paged_write_quant
from bigdl_tpu_torch.ops import NEG_INF
from bigdl_tpu_torch.ops import paged_attention as pa

# the chip cases' decode rows (chip_smoke.py `_paged_cases`)
DECODE_LEN = [24, 100, 300, 310, 700, 1000, 513, 0]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("c", [1, 64], ids=["decode", "chunk"])
def test_splits_depend_on_the_row_alone(c, ps, d):
    """A row's runs are the same whatever the batch around it, the head
    count or the head shard (tp 2 and 4 of 12 heads), and the head size."""
    starts = [max(n - c, 0) for n in DECODE_LEN]
    width = 1024 // ps
    whole = pa.paged_plan(8, 12, c, d, ps, width, starts, "float32")
    for h in (12, 6, 3):                       # unsharded, tp 2, tp 4
        plan = pa.paged_plan(8, h, c, d, ps, width, starts, "float32")
        assert plan["splits"] == whole["splits"]
        assert plan["grid"] == (pa.SPLIT, 8 * h, whole["grid"][2])
    for row, st in enumerate(starts):           # each row alone, B = 1
        alone = pa.paged_plan(1, 12, c, d, ps, width, [st], "float32")
        assert alone["splits"] == [whole["splits"][row]]
    other = pa.paged_plan(8, 12, c, 32, ps, width, starts, "float32")
    assert other["splits"] == whole["splits"]


@pytest.mark.parametrize("npages", [0, 1, 2, 7, 8, 9, 15, 16, 17, 63, 64])
def test_page_split_covers_the_walk_once_in_order(npages):
    runs = pa.page_split(npages)
    assert len(runs) == pa.SPLIT
    assert [p for lo, hi in runs for p in range(lo, hi)] == \
        list(range(npages))
    assert max(hi - lo for lo, hi in runs) == -(-npages // pa.SPLIT)


def test_split_of_the_longest_decode_row():
    """The 1000-token decode row at pages of 16: 63 pages, 8 a CTA (the
    last 7), where the whole row had been one CTA's walk."""
    plan = pa.paged_plan(8, 12, 1, 64, 16, 64,
                         [max(n - 1, 0) for n in DECODE_LEN], "float32")
    assert plan["splits"][5] == [[(8 * r, min(63, 8 * r + 8))
                                  for r in range(8)]]
    assert plan["query_tile"] == 1 and plan["grid"] == (8, 96, 1)


# (kv dtype, page size, decode, head dim) -> dynamic shared memory bytes:
# STAGES x (K and V rows of D values + 16 bytes [+ 2 scale rows]) +
# queries + partial states + the table row (1024 positions a row: 128 /
# 64 / 32 int32 entries at pages of 8 / 16 / 32)
SMEM = {("float32", 16, True, 64): 4 * 2 * 16 * 272 + 256 + 4 * 66 * 4 + 256,
        ("float32", 32, False, 64): (4 * 2 * 32 * 272 + 4096 + 16 * 66 * 4
                                     + 128),
        ("bfloat16", 16, False, 64): (4 * 2 * 16 * 144 + 4096 + 16 * 66 * 4
                                      + 256),
        ("int8", 8, True, 64): 4 * (2 * 8 * 80 + 64) + 256 + 4 * 66 * 4 + 512,
        ("int8", 32, False, 64): (4 * (2 * 32 * 80 + 256) + 4096
                                  + 16 * 66 * 4 + 128),
        # the largest: D 128, pages of 32, a float32 pool, a chunk
        ("float32", 32, False, 128): (4 * 2 * 32 * 528 + 16 * 128 * 4
                                      + 16 * 130 * 4 + 128),
        ("int8", 8, True, 32): 4 * (2 * 8 * 48 + 64) + 128 + 4 * 34 * 4 + 512,
        ("bfloat16", 16, True, 96): (4 * 2 * 16 * 208 + 384 + 4 * 98 * 4
                                     + 256)}


@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("decode", [True, False], ids=["decode", "chunk"])
@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
def test_shared_memory_fits_each_instantiation(kv, ps, decode, d):
    """Every (pool type, page size, decode or chunk, head size) the kernel
    is instantiated for fits a CTA's 232,448 bytes."""
    assert (ps, d) in pa.KERNEL_SHAPES
    c = 1 if decode else 64
    plan = pa.paged_plan(4, 12, c, d, ps, 1024 // ps, [0, 5, 9, 600], kv)
    assert plan["smem_bytes"] <= pa.MAX_SMEM
    assert plan["threads"] == 128 and plan["stages"] == 4
    assert plan["query_tile"] == (1 if decode else 16)
    assert plan["grid"] == (8, 48, 1 if decode else 4)
    if (kv, ps, decode, d) in SMEM:
        assert plan["smem_bytes"] == SMEM[(kv, ps, decode, d)]


# a small pool for the emulation: pages of 8 at D 16, rows whose walks
# split into runs of several pages, shared pages, a sentinel tail and an
# inactive row
H, D, PS, N, P = 4, 16, 8, 48, 32
LENGTHS = [5, 100, 180, 0, 61]


def _table():
    rows, nxt = [], 0
    for n in LENGTHS:
        row = [N] * P
        for j in range(-(-n // PS)):
            row[j] = nxt
            nxt += 1
        rows.append(row)
    rows[2][:12] = rows[1][:12]                    # a shared 96-token prefix
    return np.array(rows, np.int32)


def _jax_pool(k, v, int8):
    if not int8:
        return {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    pages = np.repeat(np.arange(N, dtype=np.int32), PS)[None]
    offs = np.tile(np.arange(PS, dtype=np.int32), N)[None]
    pool = {}
    for name, x in (("k", k), ("v", v)):
        new = jnp.asarray(x.transpose(1, 0, 2, 3).reshape(1, H, N * PS, D))
        q, sc = jax_paged_write_quant(
            jnp.zeros((N, H, PS, D), jnp.int8),
            jnp.zeros((N, H, PS), jnp.float32), new, jnp.asarray(pages),
            jnp.asarray(offs))
        pool[name], pool[f"{name}_scale"] = q, sc
    return pool


def _page(pool, name, page):
    """Page ``page`` of plane ``name`` as float32 (H, PS, D), dequantised
    as the kernel reads it."""
    x = pool[name][page].float()
    if "k_scale" in pool:
        x = x * pool[f"{name}_scale"][page][..., None]
    return x


def split_and_merge(q, pool, table, start, sm_scale):
    """The kernel's split and merge in plain PyTorch: per (slot, query
    tile) each CTA of the cluster takes its run of pages from
    ``paged_plan``; at decode each of its four warps takes its quarter of
    every page's keys; each leaves (m, l, acc) over its keys for its
    queries, and the states are merged in the kernel's order (ranks, then
    warps)."""
    b, h, c, d = q.shape
    n = pool["k"].shape[0]
    ps = pool["k"].shape[2]
    plan = pa.paged_plan(b, h, c, d, ps, table.shape[1], start.tolist(),
                         "int8" if "k_scale" in pool else "float32")
    tile = plan["query_tile"]
    parts = 4 if tile == 1 else 1
    out = torch.zeros(b, h, c, d)
    for row in range(b):
        for t, runs in enumerate(plan["splits"][row]):
            c0, c1 = t * tile, min(c, (t + 1) * tile)
            qt = q[row, :, c0:c1].float()                     # (H, nq, D)
            qpos = int(start[row]) + torch.arange(c0, c1)
            states = []
            for lo, hi in runs:
                for w in range(parts):
                    keys = range(w * ps // parts, (w + 1) * ps // parts)
                    kk, vv, pos = [], [], []
                    for p in range(lo, hi):
                        page = int(table[row, p])
                        if not 0 <= page < n:
                            continue
                        kk.append(_page(pool, "k", page)[:, keys])
                        vv.append(_page(pool, "v", page)[:, keys])
                        pos += [p * ps + j for j in keys]
                    m = torch.full((h, c1 - c0), NEG_INF)
                    l = torch.zeros(h, c1 - c0)
                    acc = torch.zeros(h, c1 - c0, d)
                    if pos:
                        k_, v_ = torch.cat(kk, 1), torch.cat(vv, 1)
                        s = torch.einsum("hqd,hkd->hqk", qt, k_) * sm_scale
                        valid = (torch.tensor(pos)[None, :]
                                 <= qpos[:, None])[None]
                        s = torch.where(valid, s, torch.tensor(NEG_INF))
                        m = s.amax(-1)
                        p_ = torch.where(valid, torch.exp(s - m[..., None]),
                                         torch.tensor(0.0))
                        l, acc = p_.sum(-1), p_ @ v_
                    states.append((m, l, acc))
            mm = torch.stack([s_[0] for s_ in states]).amax(0)
            ll = torch.zeros_like(mm)
            o = torch.zeros(h, c1 - c0, d)
            for m, l, acc in states:
                sc = torch.exp(m - mm)
                ll = ll + l * sc
                o = o + acc * sc[..., None]
            out[row, :, c0:c1] = o / ll.clamp_min(1e-30)[..., None]
    return out


@pytest.mark.parametrize("int8", [False, True], ids=["float32", "int8"])
@pytest.mark.parametrize("c", [1, 20], ids=["decode", "chunk"])
def test_split_and_merge_matches_plain_and_pallas(c, int8):
    rng = np.random.default_rng(7 + c + int8)
    k = rng.standard_normal((N, H, PS, D), dtype=np.float32) * 2.0
    v = rng.standard_normal((N, H, PS, D), dtype=np.float32)
    q = rng.standard_normal((len(LENGTHS), H, c, D), dtype=np.float32)
    start = np.array([max(n - c, 0) for n in LENGTHS], np.int32)
    table = _table()
    jpool = _jax_pool(k, v, int8)
    tpool = {name: torch.from_numpy(np.array(a)) for name, a in jpool.items()}
    tq, tt, ts = (torch.from_numpy(a) for a in (q, table, start))
    got = split_and_merge(tq, tpool, tt, ts, D ** -0.5).numpy()
    plain = pa.paged_pool_attention_ref(tq, tpool, tt, ts).numpy()
    q_pos = start[:, None] + np.arange(c, dtype=np.int32)[None]
    pallas = np.asarray(jax_paged_pool_attention(
        jnp.asarray(q), jpool, jnp.asarray(table), jnp.asarray(q_pos),
        interpret=True))
    seen = np.array([n > 0 for n in LENGTHS])
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[seen], pallas[seen], rtol=1e-5, atol=1e-5)
    assert (got[~seen] == 0).all()
    # the walks really split: the longest row's runs are several pages
    plan = pa.paged_plan(len(LENGTHS), H, c, D, PS, P, start.tolist(),
                         "float32")
    assert max(hi - lo for lo, hi in plan["splits"][2][0]) >= 3


@pytest.mark.parametrize("d,ok", [(32, True), (64, True), (96, True),
                                  (128, True), (80, False), (160, False),
                                  (256, False)])
@pytest.mark.parametrize("int8", [False, True], ids=["float32", "int8"])
def test_wrapper_takes_the_instantiated_head_dims(int8, d, ok):
    """The card branch's shape check takes every head size the kernel is
    built for (multiples of 32 up to 128) and refuses the rest, naming
    the ROADMAP queue C item."""
    q = torch.zeros((2, 4, 1, d))
    table = torch.zeros((2, 3), dtype=torch.int32)
    start = torch.zeros(2, dtype=torch.int32)
    dtype = torch.int8 if int8 else torch.float32
    pool = {"k": torch.zeros((6, 4, 16, d), dtype=dtype),
            "v": torch.zeros((6, 4, 16, d), dtype=dtype)}
    if int8:
        pool.update(k_scale=torch.zeros((6, 4, 16)),
                    v_scale=torch.zeros((6, 4, 16)))
    if ok:
        pa._check_cuda_args(q, pool, table, start)
    else:
        with pytest.raises(ValueError, match=r"queue C, 'flash and paged "
                                             r"head dims above 128'"):
            pa._check_cuda_args(q, pool, table, start)
