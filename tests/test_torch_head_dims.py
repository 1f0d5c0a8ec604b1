"""Head dims between and above the paged kernel's old widths, on the
CPU: the port's plain paged attention (``ops/paged_attention.py``
``paged_pool_attention_ref``, what the kernel is held against on the card)
at head dims 33, 36, 80 and 256 (on the card their rows are staged by
copies of 1, 4 and 16 bytes), over float32 and int8 pools, against the
reference's XLA gather path; and the kernel's way of running a head dim
``d`` on a wider built width (columns ``d`` and up of the staged rows and
the queries zero, nothing past ``d`` written), emulated in plain PyTorch,
against the true-width result.

Tolerances: float32 atol = rtol = 1e-5 (the same arithmetic summed in
another order); the zero-column emulation within 1e-6 (zero products
leave each dot product as it was).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.parallel.sequence import paged_attention as jax_paged_attention
from bigdl_tpu.parallel.sequence import paged_gather as jax_paged_gather
from bigdl_tpu.parallel.sequence import \
    paged_gather_dequant as jax_paged_gather_dequant
from bigdl_tpu.parallel.sequence import \
    paged_write_quant as jax_paged_write_quant
from bigdl_tpu_torch.ops import paged_attention as pa

H, PS, N = 2, 8, 8
S = N                                   # the "no page" sentinel
TABLE = np.array([[0, S, S, S],
                  [1, 2, 3, S],
                  [1, 2, 4, 5],
                  [S, S, S, S]], np.int32)
LENGTHS = [5, 17, 32, 0]
VISIBLE = np.array([n > 0 for n in LENGTHS])


def _inputs(d, c, seed):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((N, H, PS, d), dtype=np.float32)
    v = rng.standard_normal((N, H, PS, d), dtype=np.float32)
    q = rng.standard_normal((len(LENGTHS), H, c, d), dtype=np.float32)
    start = np.array([max(n - c, 0) for n in LENGTHS], np.int32)
    return q, k, v, start


def _int8_pool(k, v):
    """The reference's int8 pool written from float K/V through its own
    ``paged_write_quant``, every (page, offset)."""
    d = k.shape[-1]
    pages = np.repeat(np.arange(N, dtype=np.int32), PS)[None]
    offs = np.tile(np.arange(PS, dtype=np.int32), N)[None]
    pool = {}
    for name, x in (("k", k), ("v", v)):
        new = jnp.asarray(x.transpose(1, 0, 2, 3).reshape(1, H, N * PS, d))
        qv, sc = jax_paged_write_quant(
            jnp.zeros((N, H, PS, d), jnp.int8),
            jnp.zeros((N, H, PS), jnp.float32), new, jnp.asarray(pages),
            jnp.asarray(offs))
        pool[name], pool[f"{name}_scale"] = qv, sc
    return pool


@pytest.mark.parametrize("int8", [False, True], ids=["float32", "int8"])
@pytest.mark.parametrize("c", [1, 4], ids=["decode", "chunk"])
@pytest.mark.parametrize("d", [33, 36, 80, 256])
def test_plain_paged_attention_matches_reference_gather_path(d, c, int8):
    q, k, v, start = _inputs(d, c, seed=d + c)
    q_pos = start[:, None] + np.arange(c, dtype=np.int32)[None]
    table = jnp.asarray(TABLE)
    if int8:
        jpool = _int8_pool(k, v)
        kf, vf = [jax_paged_gather_dequant(jpool[n], jpool[f"{n}_scale"],
                                           table, jnp.float32)
                  for n in ("k", "v")]
        tpool = {n: torch.from_numpy(np.array(a)) for n, a in jpool.items()}
    else:
        kf, vf = [jax_paged_gather(jnp.asarray(x), table) for x in (k, v)]
        tpool = {"k": torch.from_numpy(k), "v": torch.from_numpy(v)}
    want = np.asarray(jax_paged_attention(jnp.asarray(q), kf, vf,
                                          jnp.asarray(q_pos)))
    got = pa.paged_pool_attention_ref(torch.from_numpy(q), tpool,
                                      torch.from_numpy(TABLE),
                                      torch.from_numpy(start)).numpy()
    np.testing.assert_allclose(got[VISIBLE], want[VISIBLE], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("int8", [False, True], ids=["float32", "int8"])
@pytest.mark.parametrize("d", [33, 36, 72, 80, 160, 200])
def test_zero_columns_past_the_head_dim_are_exact(d, int8):
    """What the kernel computes at head dim ``d`` on its built width
    (``kernel_width``): the queries and the staged K/V rows zero past
    ``d``, the softmax scale of the true ``d``, the output sliced to
    ``d``; equal to the plain version at the true ``d``."""
    width = pa.kernel_width(d)
    assert width == (64 if d <= 64 else 96 if d <= 96 else 256)
    q, k, v, start = _inputs(d, 4, seed=d)
    tq = torch.from_numpy(q)
    if int8:
        pool = {n: torch.from_numpy(np.array(a))
                for n, a in _int8_pool(k, v).items()}
    else:
        pool = {"k": torch.from_numpy(k), "v": torch.from_numpy(v)}
    table, st = torch.from_numpy(TABLE), torch.from_numpy(start)
    want = pa.paged_pool_attention_ref(tq, pool, table, st)

    def wide(x):
        return torch.nn.functional.pad(x, (0, width - d))

    wpool = {n: (wide(t) if t.dim() == 4 else t) for n, t in pool.items()}
    got = pa.paged_pool_attention_ref(wide(tq), wpool, table, st,
                                      sm_scale=d ** -0.5)[..., :d]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
