"""The LoRA math of the port (``bigdl_tpu_torch/models/lora.py``,
``nn.quantized.lora_delta`` / ``lora_linear`` and the ``lora=`` argument of
``models.gpt``'s cache paths) against the reference (``bigdl_tpu/models/
lora.py``), on the CPU, at the reference tests' tiny model (vocab 61,
hidden 32, 2 layers, 4 heads, rank 4) with the same seeded weights and
adapters (``convert``).

- the single-adapter forward (``SingleAdapter``, the reference's
  ``wrap_params_single``) and the batched one (pool rows gathered a row,
  the reference's ``wrap_params``) give the reference's hidden states
  within 1e-5 (float32, the same products summed in another order), on
  the dense prefill and verify chunk and on the paged chunk;
- a fresh adapter (B = 0) and pool row 0 leave the base model's bits
  exactly, also for the base rows of a mixed batch;
- ``adapter_digest`` and the planes of a reference-made adapter are
  identical in both packages, and the plane round trip keeps the digest;
- int8 slabs are the reference's ``quantize_array`` slabs, and their
  delta dequantises in one multiply;
- under tp a slab's shard parts join back into the whole slab, and a
  row-parallel projection sums the shards' rank-r partials, then applies
  B once, within 1e-6 of the unsharded delta.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bigdl_tpu.models.gpt import GPTForCausalLM as JaxGPT
from bigdl_tpu.models.lora import adapter_digest as jax_digest
from bigdl_tpu.models.lora import adapter_planes as jax_planes
from bigdl_tpu.models.lora import init_adapter as jax_init_adapter
from bigdl_tpu.models.lora import target_shapes as jax_target_shapes
from bigdl_tpu.models.lora import wrap_params, wrap_params_single
from bigdl_tpu.nn.quantized import quantize_array as jax_quantize_array
from bigdl_tpu.serving.adapters import AdapterPool as JaxPool
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models import lora
from bigdl_tpu_torch.models.gpt import GPTForCausalLM, _row_parallel
from bigdl_tpu_torch.nn import Linear
from bigdl_tpu_torch.nn.quantized import lora_delta, lora_linear
from bigdl_tpu_torch.serving import AdapterPool

CFG = dict(vocab_size=61, hidden_size=32, n_layers=2, n_heads=4,
           max_position=64)
RANK = 4
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    jm = JaxGPT(**CFG)
    params, _ = jm.setup(jax.random.PRNGKey(0), None)
    tm = GPTForCausalLM(**CFG, device="cpu")
    tm.load_state_dict(convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    tm.requires_grad_(False)
    jads = [jax_init_adapter(jax.random.PRNGKey(100 + i), params, RANK,
                             b_std=0.5) for i in range(2)]
    return jm, params, tm, jads


def _np(x):
    return np.asarray(jax.device_get(x))


def _ids():
    rng = np.random.default_rng(5)
    return (rng.integers(0, 61, (3, 16)).astype(np.int32),
            rng.integers(0, 61, (3, 4)).astype(np.int32))


def _dense_states(tm, ids, toks, lo):
    with torch.no_grad():
        c = tm.gpt.init_cache(3)
        h0, c = tm.gpt.prefill(c, ids, 12, lora=lo)
        h1, c = tm.gpt.decode_chunk(c, torch.from_numpy(toks),
                                    np.array([5, 9, 2]), lora=lo)
    return h0, h1, c


def _jax_dense_states(jm, gparams, ids, toks):
    c = jm.gpt.init_cache(3)
    h0, c = jm.gpt.prefill(gparams, c, jnp.asarray(ids), 12)
    h1, c = jm.gpt.decode_chunk(gparams, c, jnp.asarray(toks),
                                jnp.asarray([5, 9, 2]))
    return h0, h1, c


def _port_adapter(jad):
    return convert.adapter_from_jax(jax.tree_util.tree_map(np.asarray, jad))


# ------------------------------------------------------------ identity --
def test_digest_and_planes_identical_in_both_packages(pair):
    _, _, _, jads = pair
    for jad in jads:
        ad = _port_adapter(jad)
        assert lora.adapter_digest(ad) == jax_digest(jad)
        for tp, jp in zip(lora.adapter_planes(ad), jax_planes(jad)):
            assert sorted(tp) == sorted(jp)
            for k in tp:
                assert tp[k].dtype == jp[k].dtype
                np.testing.assert_array_equal(tp[k], jp[k])
        back = lora.adapter_from_planes(lora.adapter_planes(ad))
        assert lora.adapter_digest(back) == lora.adapter_digest(ad)
    assert lora.adapter_digest(_port_adapter(jads[0])) \
        != lora.adapter_digest(_port_adapter(jads[1]))
    assert len(lora.adapter_digest(_port_adapter(jads[0]))) == 16


def test_init_adapter_shapes_and_seeding(pair):
    _, params, tm, _ = pair
    assert lora.target_shapes(tm) == [
        {k: tuple(v) for k, v in layer.items()}
        for layer in jax_target_shapes(params)]
    a1 = lora.init_adapter(torch.Generator().manual_seed(1), tm, RANK)
    a2 = lora.init_adapter(torch.Generator().manual_seed(1), tm, RANK)
    assert lora.adapter_digest(a1) == lora.adapter_digest(a2)
    assert a1["rank"] == RANK and a1["alpha"] == float(RANK)
    for layer, shapes in zip(a1["layers"], lora.target_shapes(tm)):
        for tgt, (din, dout) in shapes.items():
            assert layer[tgt]["a"].shape == (din, RANK)
            assert layer[tgt]["a"].dtype == np.float32
            assert not layer[tgt]["b"].any()       # B zero at birth
    noisy = lora.init_adapter(torch.Generator().manual_seed(1), tm, RANK,
                              b_std=0.5)
    assert noisy["layers"][0]["wq"]["b"].any()
    with pytest.raises(ValueError, match="rank"):
        lora.init_adapter(torch.Generator(), tm, 0)


# --------------------------------------------------------------- forward --
def test_single_adapter_forward_matches_reference(pair):
    """``SingleAdapter`` through the dense prefill and verify chunk: the
    reference's ``wrap_params_single`` states and caches within 1e-5."""
    jm, params, tm, jads = pair
    ids, toks = _ids()
    for jad in jads:
        h0, h1, c = _dense_states(tm, ids, toks,
                                  lora.SingleAdapter(_port_adapter(jad)).tree)
        wp = wrap_params_single(params, jad)["gpt"]
        j0, j1, jc = _jax_dense_states(jm, wp, ids, toks)
        np.testing.assert_allclose(h0.numpy(), _np(j0), **TOL)
        np.testing.assert_allclose(h1.numpy(), _np(j1), **TOL)
        for tl, jl in zip(c, jc):
            np.testing.assert_allclose(tl["v"].numpy(), _np(jl["v"]), **TOL)
        base, _, _ = _dense_states(tm, ids, toks, None)
        assert not np.allclose(h0.numpy(), base.numpy(), atol=1e-3)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_batched_pool_rows_match_reference(pair, int8):
    """Rows 0 (base), t0 and t1 of a pool gathered a batch row: the
    reference pool's ``wrap_params`` states within 1e-5; the base row's
    bits are the pool-less forward's exactly. Int8 slabs on both sides
    (the base weights stay float: the slab math alone)."""
    jm, params, tm, jads = pair
    ids, toks = _ids()
    pool = AdapterPool(tm, slots=2, rank=RANK, int8=int8, device="cpu")
    jpool = JaxPool(params, slots=2, rank=RANK, int8=int8)
    rows = []
    for i, jad in enumerate(jads):
        rows.append(pool.acquire(pool.register(f"t{i}", _port_adapter(jad))))
        jpool.acquire(jpool.register(f"t{i}", jad))
    rows = [0] + rows
    tree = pool.gathered(rows)
    h0, h1, c = _dense_states(tm, ids, toks, tree)
    wp = wrap_params(params, jpool.tree(), jnp.asarray(rows, jnp.int32))
    j0, j1, _ = _jax_dense_states(jm, wp["gpt"], ids, toks)
    np.testing.assert_allclose(h0.numpy(), _np(j0), **TOL)
    np.testing.assert_allclose(h1.numpy(), _np(j1), **TOL)
    b0, b1, _ = _dense_states(tm, ids, toks, None)
    np.testing.assert_array_equal(h0[0].numpy(), b0[0].numpy())
    np.testing.assert_array_equal(h1[0].numpy(), b1[0].numpy())


def test_paged_chunk_under_pool_rows_matches_single_adapters(pair):
    """The paged prefill chunk of a mixed batch (base, t0, t1): each row's
    state equals its single-adapter chunk's within 1e-6, the base row's
    bit for bit."""
    _, _, tm, jads = pair
    pool = AdapterPool(tm, slots=2, rank=RANK, device="cpu")
    ads = [_port_adapter(j) for j in jads]
    rows = [0] + [pool.acquire(pool.register(f"t{i}", a))
                  for i, a in enumerate(ads)]
    ids = np.random.default_rng(3).integers(0, 61, (3, 8)).astype(np.int32)

    def chunk(lo):
        pools = tm.gpt.init_paged_pool(8, 8)
        table = np.array([[0, 8], [1, 8], [2, 8]], np.int32)
        with torch.no_grad():
            h, _ = tm.gpt.paged_prefill_chunk(
                pools, table, ids, np.zeros(3, np.int32),
                np.full(3, 8, np.int32), np.zeros(3, np.int32), 8, lora=lo)
        return h.numpy()

    mixed = chunk(pool.gathered(rows))
    np.testing.assert_array_equal(mixed[0], chunk(None)[0])
    for r, ad in zip((1, 2), ads):
        np.testing.assert_allclose(mixed[r],
                                   chunk(lora.SingleAdapter(ad).tree)[r],
                                   rtol=1e-6, atol=1e-6)


def test_fresh_adapter_is_an_exact_noop(pair):
    jm, params, tm, _ = pair
    ids, toks = _ids()
    fresh = lora.init_adapter(torch.Generator().manual_seed(1), tm, RANK)
    got = _dense_states(tm, ids, toks, lora.SingleAdapter(fresh).tree)
    want = _dense_states(tm, ids, toks, None)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_pool_row0_gathers_exact_base(pair):
    """Row 0 alone gathers nothing (the dispatch adds no delta); gathered
    explicitly, its zero slabs at scale 0 give the base bits too."""
    _, _, tm, jads = pair
    ids, toks = _ids()
    pool = AdapterPool(tm, slots=2, rank=RANK, device="cpu")
    pool.acquire(pool.register("t0", _port_adapter(jads[0])))
    assert pool.gathered([0, 0, 0]) is None and pool.gathers == 0
    tree = lora.gather_pool_rows(pool._layers[0], pool._scale[0],
                                 torch.zeros(3, dtype=torch.long))
    got = _dense_states(tm, ids, toks, tree)
    want = _dense_states(tm, ids, toks, None)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


# ------------------------------------------------------------ the delta --
def test_lora_delta_batched_rows_equal_unbatched():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 5, 16), generator=g)
    a = torch.randn((3, 16, RANK), generator=g)
    b = torch.randn((3, RANK, 24), generator=g)
    s = torch.tensor([0.0, 1.0, 0.5])
    d = lora_delta(x, a, b, s)
    assert d.shape == (3, 5, 24)
    assert not d[0].any()                          # scale 0: exactly zero
    for r in (1, 2):
        np.testing.assert_allclose(
            d[r].numpy(), lora_delta(x[r], a[r], b[r], float(s[r])).numpy(),
            **TOL)


def test_int8_slabs_are_the_reference_quantisation(pair):
    _, _, _, jads = pair
    ad = _port_adapter(jads[0])
    host = lora.host_slabs(ad, int8=True)
    for layer, al in zip(host, ad["layers"]):
        for tgt, slabs in layer.items():
            for part in ("a", "b"):
                jq, js = jax_quantize_array(jnp.asarray(al[tgt][part]),
                                            reduce_axes=(0,))
                np.testing.assert_array_equal(slabs[part]["q"].numpy(),
                                              _np(jq))
                np.testing.assert_array_equal(slabs[part]["scale"].numpy(),
                                              _np(js))
    x = torch.randn((2, 3, 32), generator=torch.Generator().manual_seed(2))
    a, b = host[0]["wq"]["a"], host[0]["wq"]["b"]
    want = lora_delta(x, a["q"].float() * a["scale"],
                      b["q"].float() * b["scale"], 1.0)
    np.testing.assert_array_equal(lora_delta(x, a, b, 1.0).numpy(),
                                  want.numpy())


def test_lora_linear_without_batch_is_the_module(pair):
    _, _, tm, _ = pair
    lin = tm.gpt.layers[0].fc1
    x = torch.randn((2, 3, 32))
    np.testing.assert_array_equal(lora_linear(lin, x).numpy(),
                                  lin(x).detach().numpy())


@pytest.mark.parametrize("tgt", ["wq", "wo", "fc1", "fc2"])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_tp_slab_split_joins_the_whole(pair, tgt, int8):
    """Column-parallel targets split B's columns (A whole), row-parallel
    ones A's rows (B whole); the shards' parts join back into the slab.
    A row-parallel projection with its delta (``models.gpt._row_parallel``)
    is the unsharded one within 1e-6, and applies B once: the shards'
    rank-r partials are summed first, as the reference's layout does."""
    _, _, tm, jads = pair
    ad = _port_adapter(jads[0])
    slab = lora.host_slabs(ad, int8)[0][tgt]
    row = tgt in lora.ROW_PARALLEL_TARGETS
    for part, split_dim in (("a", 0 if row else None),
                            ("b", None if row else 1)):
        parts = lora.split_slab(slab[part], tgt, part, 2)
        whole = slab[part]["q"] if int8 else slab[part]
        got = [p["q"] if int8 else p for p in parts]
        if split_dim is None:
            assert all(p is whole for p in got)
        else:
            np.testing.assert_array_equal(
                torch.cat(got, split_dim).numpy(), whole.numpy())
    if row:
        blk = tm.gpt.layers[0]
        lin = getattr(blk.attn if tgt == "wo" else blk, tgt)
        x = torch.randn((2, 3, lin.weight.shape[1]))
        shards = []
        for w in lin.weight.chunk(2, 1):
            shard = Linear(w.shape[1], w.shape[0], with_bias=False,
                           device="cpu")
            shard.weight.data = w.clone()
            shards.append(shard.requires_grad_(False))
        los = [(a, b, 1.0) for a, b in zip(
            lora.split_slab(slab["a"], tgt, "a", 2),
            lora.split_slab(slab["b"], tgt, "b", 2))]
        before = lora_delta.products
        got = _row_parallel(shards, list(x.chunk(2, -1)), los)[0]
        # x_i @ A_i on each shard, then B once after their sum
        assert lora_delta.products - before == 3
        want = F.linear(x, lin.weight) + lora_delta(x, slab["a"],
                                                    slab["b"], 1.0)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)
