"""The port's int8 K/V path against the JAX reference, on the CPU.

- ``paged_write_quant`` (quantise-on-write, one scale per written token and
  head) is bit-equal to the reference's: int8 values, float32 scales, and
  the sentinel writes that drop;
- the int8 plain version of ``paged_pool_attention`` (what the CUDA kernel
  is held against on the card, and what the wrapper runs on CPU tensors)
  matches the reference's ``paged_pool_attention`` over the same int8 pool
  in interpret mode, which runs the Pallas ``_decode_kernel_quant``, and
  its XLA ``paged_gather_dequant`` path: decode (C=1) and chunk (C=4),
  shared pages, sentinel tails and a fully masked row (compared on visible
  rows). float32 queries: atol = rtol = 1e-5, the same arithmetic in
  another summation order; bfloat16 queries: atol = rtol = 1e-2, both
  outputs rounded to bfloat16 (2^-8 relative) from float32 math.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.paged_attention import \
    paged_pool_attention as jax_paged_pool_attention
from bigdl_tpu.parallel.sequence import paged_attention as jax_paged_attention
from bigdl_tpu.parallel.sequence import \
    paged_gather_dequant as jax_paged_gather_dequant
from bigdl_tpu.parallel.sequence import \
    paged_write_quant as jax_paged_write_quant
from bigdl_tpu_torch.ops.paged_attention import (bytes_and_flops,
                                                 paged_pool_attention,
                                                 paged_pool_attention_ref)
from bigdl_tpu_torch.parallel.sequence import (paged_gather_dequant,
                                               paged_write_index,
                                               paged_write_quant)

H, D, PS, N = 4, 16, 8, 8
S = N                                   # the "no page" sentinel
TABLE = np.array([[0, S, S, S],
                  [1, 2, 3, S],
                  [1, 2, 4, 5],
                  [6, S, S, S],
                  [S, S, S, S]], np.int32)
LENGTHS = [5, 17, 32, 1, 0]
VISIBLE = np.array([n > 0 for n in LENGTHS])
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _jax_pool(k, v):
    """The reference's int8 pool with every (page, offset) written from
    the float K/V (N, H, PS, D) through its ``paged_write_quant``."""
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


def _inputs(c, seed=0):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((N, H, PS, D), dtype=np.float32) * 2.0
    v = rng.standard_normal((N, H, PS, D), dtype=np.float32)
    q = rng.standard_normal((len(LENGTHS), H, c, D), dtype=np.float32)
    start = np.array([max(n - c, 0) for n in LENGTHS], np.int32)
    jpool = _jax_pool(k, v)
    tpool = {n: torch.from_numpy(np.array(a)) for n, a in jpool.items()}
    return q, jpool, tpool, start


def _port(q, tpool, start, dtype):
    tq = torch.from_numpy(q).to(getattr(torch, dtype))
    return paged_pool_attention_ref(tq, tpool, torch.from_numpy(TABLE),
                                    torch.from_numpy(start)).float().numpy()


def test_paged_write_quant_bit_equal_with_sentinel_drops():
    rng = np.random.default_rng(4)
    pool = rng.integers(-127, 128, (N, H, PS, D)).astype(np.int8)
    scales = rng.uniform(0.01, 0.1, (N, H, PS)).astype(np.float32)
    new = rng.standard_normal((3, H, 2, D), dtype=np.float32) * 5.0
    new[1, :, 1] = 0.0                    # an all-zero vector: scale 1e-8/127
    new[2, 0, 0, 3] = 1e-3                # tiny values: rounding near 0
    pages = np.array([[3, 3], [S, 5], [np.iinfo(np.int32).max, 0]],
                     np.int32)
    offsets = np.array([[0, 1], [2, 7], [4, 6]], np.int32)
    want_q, want_s = jax_paged_write_quant(
        jnp.asarray(pool), jnp.asarray(scales), jnp.asarray(new),
        jnp.asarray(pages), jnp.asarray(offsets))
    got_q, got_s = torch.from_numpy(pool.copy()), torch.from_numpy(
        scales.copy())
    index = paged_write_index(torch.from_numpy(pages),
                              torch.from_numpy(offsets), N, "cpu")
    out_q, out_s = paged_write_quant(got_q, got_s, torch.from_numpy(new),
                                     index)
    assert out_q is got_q and out_s is got_s          # in place
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    # the dropped writes left their pages as they were
    np.testing.assert_array_equal(got_q.numpy()[4], pool[4])
    assert (got_q.numpy()[3, :, :2] != pool[3, :, :2]).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [1, 4], ids=["decode", "chunk"])
def test_ref_matches_jax_quant_kernel(c, dtype):
    q, jpool, tpool, start = _inputs(c)
    q_pos = start[:, None] + np.arange(c, dtype=np.int32)[None]
    want = np.asarray(jax_paged_pool_attention(
        jnp.asarray(q).astype(dtype), jpool, jnp.asarray(TABLE),
        jnp.asarray(q_pos), interpret=True).astype(jnp.float32))
    got = _port(q, tpool, start, dtype)
    np.testing.assert_allclose(got[VISIBLE], want[VISIBLE], rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("c", [1, 4], ids=["decode", "chunk"])
def test_ref_matches_jax_gather_dequant_path(c):
    q, jpool, tpool, start = _inputs(c, seed=1)
    q_pos = start[:, None] + np.arange(c, dtype=np.int32)[None]
    table = jnp.asarray(TABLE)
    kf = jax_paged_gather_dequant(jpool["k"], jpool["k_scale"], table,
                                  jnp.float32)
    vf = jax_paged_gather_dequant(jpool["v"], jpool["v_scale"], table,
                                  jnp.float32)
    want = np.asarray(jax_paged_attention(jnp.asarray(q), kf, vf,
                                          jnp.asarray(q_pos)))
    got = _port(q, tpool, start, "float32")
    np.testing.assert_allclose(got[VISIBLE], want[VISIBLE], rtol=1e-5,
                               atol=1e-5)
    # the port's copy of the dequantising gather is the reference's
    tt = torch.from_numpy(TABLE)
    port_kf = paged_gather_dequant(tpool["k"], tpool["k_scale"], tt,
                                   torch.float32)
    np.testing.assert_array_equal(port_kf.numpy(), np.asarray(kf))


def test_fully_masked_row_is_zero_and_finite():
    q, _, tpool, start = _inputs(4, seed=2)
    got = _port(q, tpool, start, "float32")
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[~VISIBLE], 0.0)


def test_wrapper_on_cpu_runs_plain_version_without_launching():
    q, _, tpool, start = _inputs(1, seed=3)
    before = (paged_pool_attention.launches,
              paged_pool_attention.int8_launches)
    got = paged_pool_attention(torch.from_numpy(q), tpool,
                               torch.from_numpy(TABLE),
                               torch.from_numpy(start))
    np.testing.assert_array_equal(got.numpy(),
                                  _port(q, tpool, start, "float32"))
    assert (paged_pool_attention.launches,
            paged_pool_attention.int8_launches) == before


def test_bytes_count_one_byte_per_element_plus_scales():
    q, _, tpool, start = _inputs(1, seed=5)
    tq, tt, ts = (torch.from_numpy(q), torch.from_numpy(TABLE),
                  torch.from_numpy(start))
    fpool = {"k": tpool["k"].float(), "v": tpool["v"].float()}
    b8, f8 = bytes_and_flops(tq, tpool, tt, ts)
    b32, f32 = bytes_and_flops(tq, fpool, tt, ts)
    seen = len({(int(TABLE[r, j // PS]), j % PS)
                for r, n in enumerate(LENGTHS) for j in range(n)})
    io = 2 * q.nbytes + 4 * (TABLE.size + start.size)
    assert b8 - io == 2 * seen * H * (D + 4)
    assert b32 - io == 2 * seen * H * D * 4
    assert f8 == f32
