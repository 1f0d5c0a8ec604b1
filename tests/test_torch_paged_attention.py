"""The port's paged attention (``bigdl_tpu_torch/ops/paged_attention.py``)
against the JAX reference.

``paged_pool_attention_ref`` — the plain version the CUDA kernel is held
against on the card, and what the wrapper runs on CPU tensors — must match
the reference's Pallas kernel (interpret mode, as the JAX tests run it)
and its XLA gather path, for decode (C=1) and chunk (C>1) shapes, with
shared pages, sentinel tails and a fully masked row (compared on visible
rows only). Float32, atol = rtol = 1e-5: the same arithmetic in another
summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.paged_attention import \
    paged_pool_attention as jax_paged_pool_attention
from bigdl_tpu.parallel.sequence import paged_attention as jax_paged_attention
from bigdl_tpu.parallel.sequence import paged_gather as jax_paged_gather
from bigdl_tpu.parallel.sequence import paged_write as jax_paged_write
from bigdl_tpu_torch.ops.paged_attention import (paged_pool_attention,
                                                 paged_pool_attention_ref)
from bigdl_tpu_torch.parallel.sequence import (paged_attention, paged_gather,
                                               paged_write,
                                               paged_write_index)

H, D, PS, N = 4, 16, 8, 8
S = N                                   # the "no page" sentinel
# rows: partial page / multi-page / full row sharing row 1's first two
# pages / single token / all sentinel (nothing visible)
TABLE = np.array([[0, S, S, S],
                  [1, 2, 3, S],
                  [1, 2, 4, 5],
                  [6, S, S, S],
                  [S, S, S, S]], np.int32)
LENGTHS = [5, 17, 32, 1, 0]
VISIBLE = np.array([n > 0 for n in LENGTHS])


def _inputs(c, seed=0):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((N, H, PS, D), dtype=np.float32)
    v = rng.standard_normal((N, H, PS, D), dtype=np.float32)
    q = rng.standard_normal((len(LENGTHS), H, c, D), dtype=np.float32)
    # the chunk ends at each row's write frontier
    start = np.array([max(n - c, 0) for n in LENGTHS], np.int32)
    return q, k, v, start


def _port(q, k, v, start):
    pool = {"k": torch.from_numpy(k), "v": torch.from_numpy(v)}
    return paged_pool_attention_ref(torch.from_numpy(q), pool,
                                    torch.from_numpy(TABLE),
                                    torch.from_numpy(start)).numpy()


@pytest.mark.parametrize("c", [1, 4], ids=["decode", "chunk"])
def test_ref_matches_jax_pallas_kernel(c):
    q, k, v, start = _inputs(c)
    q_pos = start[:, None] + np.arange(c, dtype=np.int32)[None]
    want = np.asarray(jax_paged_pool_attention(
        jnp.asarray(q), {"k": jnp.asarray(k), "v": jnp.asarray(v)},
        jnp.asarray(TABLE), jnp.asarray(q_pos), interpret=True))
    got = _port(q, k, v, start)
    np.testing.assert_allclose(got[VISIBLE], want[VISIBLE], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("c", [1, 4], ids=["decode", "chunk"])
def test_ref_matches_jax_gather_path(c):
    q, k, v, start = _inputs(c, seed=1)
    q_pos = start[:, None] + np.arange(c, dtype=np.int32)[None]
    table = jnp.asarray(TABLE)
    want = np.asarray(jax_paged_attention(
        jnp.asarray(q), jax_paged_gather(jnp.asarray(k), table),
        jax_paged_gather(jnp.asarray(v), table), jnp.asarray(q_pos)))
    got = _port(q, k, v, start)
    np.testing.assert_allclose(got[VISIBLE], want[VISIBLE], rtol=1e-5,
                               atol=1e-5)
    # the port's own copy of the gather path agrees too
    tq, tt = torch.from_numpy(q), torch.from_numpy(TABLE)
    port_gather = paged_attention(
        tq, paged_gather(torch.from_numpy(k), tt),
        paged_gather(torch.from_numpy(v), tt), torch.from_numpy(q_pos))
    np.testing.assert_allclose(port_gather.numpy()[VISIBLE], want[VISIBLE],
                               rtol=1e-5, atol=1e-5)


def test_fully_masked_row_is_zero_and_finite():
    q, k, v, start = _inputs(4, seed=2)
    got = _port(q, k, v, start)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[~VISIBLE], 0.0)


def test_wrapper_on_cpu_runs_plain_version_without_launching():
    q, k, v, start = _inputs(1, seed=3)
    before = paged_pool_attention.launches
    pool = {"k": torch.from_numpy(k), "v": torch.from_numpy(v)}
    got = paged_pool_attention(torch.from_numpy(q), pool,
                               torch.from_numpy(TABLE),
                               torch.from_numpy(start))
    np.testing.assert_array_equal(got.numpy(), _port(q, k, v, start))
    assert paged_pool_attention.launches == before


def test_paged_write_drops_sentinel_writes_like_jax():
    rng = np.random.default_rng(4)
    pool = rng.standard_normal((N, H, PS, D), dtype=np.float32)
    new = rng.standard_normal((3, H, 2, D), dtype=np.float32)
    # a real page, the sentinel, and the int32.max sentinel of the chunk
    # path: only the real ones land
    pages = np.array([[3, 3], [S, 5], [np.iinfo(np.int32).max, 0]],
                     np.int32)
    offsets = np.array([[0, 1], [2, 7], [4, 6]], np.int32)
    want = np.asarray(jax_paged_write(jnp.asarray(pool), jnp.asarray(new),
                                      jnp.asarray(pages),
                                      jnp.asarray(offsets)))
    got = torch.from_numpy(pool.copy())
    index = paged_write_index(torch.from_numpy(pages),
                              torch.from_numpy(offsets), N, "cpu")
    paged_write(got, torch.from_numpy(new), index)
    np.testing.assert_array_equal(got.numpy(), want)
