"""The port's adapter pool (``bigdl_tpu_torch/serving/adapters.py``)
against the reference's (``bigdl_tpu/serving/adapters.py``), on the CPU,
at the reference tests' tiny model (vocab 61, hidden 32, 2 layers, 4
heads, rank 4), mirroring the reference's ``TestAdapterPool``:

- refcounts, LRU eviction and exhaustion follow the same rows in both
  packages, step for step;
- the resolve forms (name, digest, hex) and a rank mismatch at
  registration;
- the ladder's rungs: an evicted adapter reloads from the host tier; a
  pool sharing a page store loads an adapter it never saw registered,
  including one the reference's pool archived there (and the other way
  round); a corrupt copy degrades to the next rung; an injected
  ``serving.adapter_load`` error fails that one load, typed;
- the loaded rows hold the reference pool's slabs (float exactly, int8
  as the reference quantises them), split over two CPU shards under tp;
- ``gathered`` is memoised on the batch's rows and the load count, and a
  base-only batch gathers nothing.
"""

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu.models.gpt import GPTForCausalLM as JaxGPT
from bigdl_tpu.models.lora import init_adapter as jax_init_adapter
from bigdl_tpu.resilience import faults as jax_faults
from bigdl_tpu.serving.adapters import AdapterPool as JaxPool
from bigdl_tpu.serving.adapters import AdapterPoolExhausted as JaxExhausted
from bigdl_tpu.serving.snapshot import PageStore as JaxPageStore
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models.gpt import GPTForCausalLM
from bigdl_tpu_torch.parallel.layout import ModelLayout
from bigdl_tpu_torch.resilience import faults
from bigdl_tpu_torch.serving import (AdapterColdError, AdapterLoadError,
                                     AdapterPool, AdapterPoolExhausted,
                                     HostPageTier)
from bigdl_tpu_torch.serving.snapshot import PageStore

CFG = dict(vocab_size=61, hidden_size=32, n_layers=2, n_heads=4,
           max_position=64)
RANK = 4


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.configure(None)
    jax_faults.configure(None)
    yield
    faults.configure(None)
    jax_faults.configure(None)


@pytest.fixture(scope="module")
def pair():
    jm = JaxGPT(**CFG)
    params, _ = jm.setup(jax.random.PRNGKey(0), None)
    tm = GPTForCausalLM(**CFG, device="cpu")
    tm.load_state_dict(convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    jads = {f"t{i}": jax_init_adapter(jax.random.PRNGKey(100 + i), params,
                                      RANK, b_std=0.5) for i in range(3)}
    ads = {k: convert.adapter_from_jax(jax.tree_util.tree_map(np.asarray, v))
           for k, v in jads.items()}
    return params, tm, jads, ads


def _pool(tm, **kw):
    return AdapterPool(tm, rank=RANK, device="cpu", **{"slots": 2, **kw})


def test_refcount_lru_evict_exhaust_as_reference(pair):
    """The reference test's sequence of acquires and releases on both
    pools: the same rows, the same exhaustion and cold errors, the same
    counters."""
    params, tm, jads, ads = pair
    pools = [(_pool(tm), ads, AdapterPoolExhausted, AdapterColdError),
             (JaxPool(params, slots=2, rank=RANK), jads, JaxExhausted,
              None)]
    seen = []
    for pool, tree, exhausted, _ in pools:
        d = {k: pool.register(k, v) for k, v in tree.items()}
        ra = pool.acquire(d["t0"])
        rb = pool.acquire(d["t1"])
        assert ra != rb and 0 not in (ra, rb)
        with pytest.raises(exhausted):
            pool.acquire(d["t2"])
        pool.release(ra)
        rc = pool.acquire(d["t2"])
        assert rc == ra and pool.evictions == 1
        assert pool.acquire(d["t2"]) == rc
        pool.release(rc)
        pool.release(rc)
        with pytest.raises(Exception, match="not resident"):
            pool.acquire(d["t0"], allow_load=False)
        assert pool.acquire(d["t1"]) == rb
        st = pool.stats()
        seen.append((ra, rb, rc, st["resident"], st["hits"], st["misses"],
                     st["loads"], st["evictions"]))
    assert seen[0] == seen[1]
    with pytest.raises(AdapterColdError):
        pools[0][0].acquire(pools[0][0].resolve("t0"), allow_load=False)


def test_base_row_and_resolve_forms(pair):
    _, tm, _, ads = pair
    pool = _pool(tm, slots=1)
    dig = pool.register("t0", ads["t0"])
    assert pool.acquire(None) == 0
    pool.release(0)                       # no-op, never counted
    assert pool.stats()["referenced"] == 0
    assert pool.resolve("t0") == dig
    assert pool.resolve(dig) == dig
    assert pool.resolve(dig.hex()) == dig
    assert pool.resolve(None) is None
    with pytest.raises(KeyError):
        pool.resolve("never-registered")


@pytest.mark.parametrize("bad", ["rank", "targets"])
def test_mismatch_fails_at_registration(pair, bad):
    params, tm, _, ads = pair
    pool = _pool(tm, slots=1)
    if bad == "rank":
        wrong = convert.adapter_from_jax(jax.tree_util.tree_map(
            np.asarray, jax_init_adapter(jax.random.PRNGKey(3), params,
                                         RANK + 2)))
    else:
        wrong = dict(ads["t0"], layers=[{k: v for k, v in layer.items()
                                         if k != "fc2"}
                                        for layer in ads["t0"]["layers"]])
    with pytest.raises(AdapterLoadError):
        pool.register("bad", wrong)
    assert pool.stats()["registered"] == 0


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_loaded_rows_hold_the_reference_slabs(pair, int8):
    params, tm, jads, ads = pair
    pool = _pool(tm, int8=int8)
    jpool = JaxPool(params, slots=2, rank=RANK, int8=int8)
    row = pool.acquire(pool.register("t1", ads["t1"]))
    jrow = jpool.acquire(jpool.register("t1", jads["t1"]))
    assert row == jrow == 1
    jtree = jax.tree_util.tree_map(np.asarray, jpool.tree())
    np.testing.assert_array_equal(pool._scale[0].numpy(), jtree["scale"])
    for layer, jlayer in zip(pool._layers[0], jtree["layers"]):
        for tgt, slabs in layer.items():
            for part in ("a", "b"):
                got, want = slabs[part], jlayer[tgt][part]
                if int8:
                    for k in ("q", "scale"):
                        np.testing.assert_array_equal(got[k].numpy(),
                                                      want[k])
                else:
                    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_tp_pool_shards_join_into_the_unsharded_pool(pair, int8):
    """Two CPU shards: column-parallel B and row-parallel A split, the rest
    whole; each shard's gathered tree holds its part."""
    _, tm, _, ads = pair
    whole = _pool(tm, int8=int8)
    tp = AdapterPool(tm, slots=2, rank=RANK, int8=int8,
                     layout=ModelLayout(["cpu", "cpu"]))
    for pool in (whole, tp):
        pool.acquire(pool.register("t0", ads["t0"]))
    rows = [1, 0, 1]
    w, shards = whole.gathered(rows), tp.gathered(rows)
    assert len(shards) == 2
    for s in shards:
        np.testing.assert_array_equal(s["scale"].numpy(), w["scale"].numpy())
    for tgt in ("wq", "wk", "wv", "wo", "fc1", "fc2"):
        row = tgt in ("wo", "fc2")
        for part, dim in (("a", 1 if row else None),
                          ("b", None if row else 2)):
            def q(x):
                return x["q"] if int8 else x
            parts = [q(s["layers"][1][tgt][part]) for s in shards]
            want = q(w["layers"][1][tgt][part])
            got = parts[0] if dim is None else torch.cat(parts, dim)
            np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_tier_rung_serves_evicted_adapter(pair):
    _, tm, _, ads = pair
    pool = _pool(tm, slots=1, host_tier=HostPageTier(1 << 24))
    d = {k: pool.register(k, v) for k, v in ads.items() if k != "t2"}
    pool.release(pool.acquire(d["t0"]))
    pool.release(pool.acquire(d["t1"]))   # evicts t0 into the tier
    hits = pool.tier.stats()["hits"]
    pool.release(pool.acquire(d["t0"]))   # the reload walks the tier
    assert pool.tier.stats()["hits"] == hits + 1
    assert pool.stats()["tier_hits"] == hits + 1


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_store_rung_shares_across_pools_and_packages(pair, tmp_path, writer):
    """A pool sharing the page store loads by digest alone an adapter it
    never saw registered, whichever package's pool archived it; the
    loaded row holds the registered slabs."""
    params, tm, jads, ads = pair
    if writer == "port":
        dig = _pool(tm, slots=1, store=PageStore(str(tmp_path))).register(
            "t0", ads["t0"])
    else:
        dig = JaxPool(params, slots=1, rank=RANK,
                      store=JaxPageStore(str(tmp_path))).register(
            "t0", jads["t0"])
    sibling = _pool(tm, slots=1, store=PageStore(str(tmp_path)))
    assert sibling.acquire(dig) == 1 and sibling.stats()["resident"] == 1
    np.testing.assert_array_equal(
        sibling._layers[0][1]["fc1"]["b"][1].numpy(),
        ads["t0"]["layers"][1]["fc1"]["b"])
    # and the reference's pool reads what the port archived
    if writer == "port":
        jpool = JaxPool(params, slots=1, rank=RANK,
                        store=JaxPageStore(str(tmp_path)))
        assert jpool.acquire(dig) == 1


def test_corrupt_copy_degrades_down_the_ladder(pair):
    _, tm, _, ads = pair
    pool = _pool(tm, slots=1, host_tier=HostPageTier(1 << 24))
    d = {k: pool.register(k, v) for k, v in ads.items() if k != "t2"}
    pool.release(pool.acquire(d["t0"]))
    pool.release(pool.acquire(d["t1"]))   # t0 demoted into the tier
    # seed 1 puts the mangle on a weight plane, as in the reference test
    faults.configure("seed=1;serving.adapter_load:corrupt:times=1")
    row = pool.acquire(d["t0"])           # tier copy mangled: registry
    assert row == 1 and pool.corrupt_dropped == 1
    np.testing.assert_array_equal(pool._layers[0][0]["wq"]["a"][1].numpy(),
                                  ads["t0"]["layers"][0]["wq"]["a"])


def test_error_fault_fails_one_load_typed(pair):
    _, tm, _, ads = pair
    pool = _pool(tm, slots=1)
    dig = pool.register("t0", ads["t0"])
    faults.configure("serving.adapter_load:error:times=1")
    with pytest.raises(AdapterLoadError, match="injected"):
        pool.acquire(dig)
    assert pool.load_errors == 1 and pool.stats()["resident"] == 0
    assert pool.acquire(dig) == 1         # the next load is clean
    assert faults.active_plan().counts() == {
        ("serving.adapter_load", "error"): 1}


def test_unknown_digest_fails_every_rung(pair):
    _, tm, _, _ = pair
    pool = _pool(tm, slots=1)
    with pytest.raises(AdapterLoadError, match="every ladder rung"):
        pool.acquire(bytes(16))
    assert pool.stats()["resident"] == 0 and pool.load_errors == 1


def test_gathered_is_memoised_on_rows_and_loads(pair):
    _, tm, _, ads = pair
    pool = _pool(tm)
    d = {k: pool.register(k, v) for k, v in ads.items()}
    assert pool.gathered([0, 0]) is None and pool.gathers == 0
    r0 = pool.acquire(d["t0"])
    g = pool.gathered([r0, 0])
    assert pool.gathered([r0, 0]) is g and pool.gathers == 1
    assert g["scale"].tolist() == [1.0, 0.0]
    assert g["layers"][0]["wq"]["a"].shape == (2, 32, RANK)
    pool.gathered([0, r0])
    assert pool.gathers == 2
    pool.acquire(d["t1"])                 # a load invalidates every key
    assert pool.gathered([r0, 0]) is not g and pool.gathers == 3
    for i in range(12):                   # the memo stays small
        pool.gathered([r0] * (i + 1))
    assert len(pool._gather_cache) <= 8
