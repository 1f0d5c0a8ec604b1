"""The port's head-sharded paged attention (the ``mesh=`` branch of
``bigdl_tpu_torch/ops/paged_attention.py``) against the JAX reference's
(``paged_pool_attention(..., mesh=(serving_mesh(tp), "tp"))``, its Pallas
kernel under ``shard_map`` in interpret mode), on the CPU.

At tp 1, 2 and 4, over float32 and int8 pools, for decode (C=1) and a
chunk (C>1), with shared pages, sentinel tails and an all-sentinel row,
the shards' outputs joined on the head axis must match the reference
within 1e-6 (the reference's own tp test's bar) on the rows that see a
key, and equal the port's unsharded call. Each shard's pool is its own
contiguous tensor, and CPU tensors launch no kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.paged_attention import \
    paged_pool_attention as jax_paged_pool_attention
from bigdl_tpu.parallel.layout import serving_mesh as jax_serving_mesh
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models.gpt import GPTForCausalLM
from bigdl_tpu_torch.ops.paged_attention import (bytes_and_flops,
                                                 paged_pool_attention)
from bigdl_tpu_torch.parallel.layout import ModelLayout, broadcast
from bigdl_tpu_torch.parallel.tensor_parallel import TensorParallelCausalLM

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


def _inputs(c, int8, seed=0):
    rng = np.random.default_rng(seed)
    if int8:
        pool = {n: rng.integers(-127, 128, (N, H, PS, D), dtype=np.int8)
                for n in ("k", "v")}
        for n in ("k_scale", "v_scale"):
            pool[n] = rng.uniform(0.001, 0.03, (N, H, PS)).astype(np.float32)
    else:
        pool = {n: rng.standard_normal((N, H, PS, D), dtype=np.float32)
                for n in ("k", "v")}
    q = rng.standard_normal((len(LENGTHS), H, c, D), dtype=np.float32)
    start = np.array([max(n - c, 0) for n in LENGTHS], np.int32)
    return q, pool, start


def _port_sharded(q, pool, start, tp):
    lay = ModelLayout(["cpu"] * tp)
    qs = lay.split(torch.from_numpy(q), 1)                # the head axis
    pools = lay.split_pool({k: torch.from_numpy(v) for k, v in pool.items()})
    outs = paged_pool_attention(
        qs, pools, broadcast(torch.from_numpy(TABLE), lay.devices),
        broadcast(torch.from_numpy(start), lay.devices), mesh=lay.devices)
    return qs, pools, outs


@pytest.mark.parametrize("int8", [False, True], ids=["float32", "int8"])
@pytest.mark.parametrize("c", [1, 4], ids=["decode", "chunk"])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_sharded_matches_jax_mesh_kernel(multi_device_cpu, tp, c, int8):
    q, pool, start = _inputs(c, int8, seed=tp + 10 * c)
    q_pos = start[:, None] + np.arange(c, dtype=np.int32)[None, :]
    want = np.asarray(jax_paged_pool_attention(
        jnp.asarray(q), {k: jnp.asarray(v) for k, v in pool.items()},
        jnp.asarray(TABLE), jnp.asarray(q_pos),
        mesh=(jax_serving_mesh(tp), "tp")))
    _, _, outs = _port_sharded(q, pool, start, tp)
    assert len(outs) == tp
    assert all(o.shape == (len(LENGTHS), H // tp, c, D) for o in outs)
    got = torch.cat(outs, 1).numpy()
    np.testing.assert_allclose(got[VISIBLE], want[VISIBLE], rtol=1e-6,
                               atol=1e-6)
    # the all-sentinel row comes out as zeros, as the unsharded call's
    assert not got[~VISIBLE].any()


@pytest.mark.parametrize("int8", [False, True], ids=["float32", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_equals_unsharded_call(tp, int8):
    q, pool, start = _inputs(4, int8, seed=5)
    whole = paged_pool_attention(
        torch.from_numpy(q), {k: torch.from_numpy(v) for k, v in
                              pool.items()},
        torch.from_numpy(TABLE), torch.from_numpy(start))
    qs, pools, outs = _port_sharded(q, pool, start, tp)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), whole.numpy(),
                               rtol=1e-6, atol=1e-6)
    # the roofline figures of the sharded call are the unsharded call's
    assert bytes_and_flops(qs, pools, torch.from_numpy(TABLE),
                           torch.from_numpy(start)) == bytes_and_flops(
        torch.from_numpy(q), {k: torch.from_numpy(v) for k, v in
                              pool.items()},
        torch.from_numpy(TABLE), torch.from_numpy(start))


def test_cpu_path_launches_nothing_and_counts_the_call():
    q, pool, start = _inputs(1, False)
    before = (paged_pool_attention.launches,
              paged_pool_attention.int8_launches)
    calls = paged_pool_attention.sharded_calls
    _port_sharded(q, pool, start, 2)
    assert (paged_pool_attention.launches,
            paged_pool_attention.int8_launches) == before
    assert paged_pool_attention.sharded_calls == calls + 1


def test_per_shard_tables_and_mismatches():
    q, pool, start = _inputs(1, False)
    lay = ModelLayout(["cpu"] * 2)
    qs, pools, outs = _port_sharded(q, pool, start, 2)
    tables = [torch.from_numpy(TABLE)] * 2
    starts = [torch.from_numpy(start)] * 2
    again = paged_pool_attention(qs, pools, tables, starts,
                                 mesh=lay.devices)
    for a, b in zip(again, outs):
        assert torch.equal(a, b)
    # one table for every shard is not a per-shard sequence
    with pytest.raises(ValueError, match="per-shard"):
        paged_pool_attention(qs, pools, tables[0], starts, mesh=lay.devices)
    with pytest.raises(ValueError, match="mesh of 4"):
        paged_pool_attention(qs, pools, tables, starts, mesh=["cpu"] * 4)
    with pytest.raises(ValueError, match="head counts"):
        paged_pool_attention([qs[0], qs[1][:, :1].contiguous()], pools,
                             tables, starts, mesh=lay.devices)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8],
                         ids=["float32", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_each_shard_pool_is_its_own_contiguous_tensor(tp, dtype):
    m = GPTForCausalLM(vocab_size=64, hidden_size=32, n_layers=2, n_heads=4,
                       max_position=64, device="cpu")
    m.load_state_dict(convert.init_params(m, seed=0))
    tpm = TensorParallelCausalLM(m, ModelLayout(["cpu"] * tp))
    pools = tpm.gpt.init_paged_pool(6, 8, dtype)
    assert len(pools) == tp and all(len(p) == 2 for p in pools)
    planes = [v for shard in tpm.gpt.pool_planes(pools) for v in shard]
    assert len(planes) == tp * 2 * (4 if dtype == torch.int8 else 2)
    assert len({v.untyped_storage().data_ptr() for v in planes}) == \
        len(planes)
    for v in planes:
        assert v.is_contiguous() and v.shape[:3] == (6, 4 // tp, 8)
