"""The port's tensor-parallel paged serving (``ServingEngine(tp=N)`` /
``ServingEngine(mesh=[...])``, ``bigdl_tpu_torch/parallel/
tensor_parallel.py``) against the JAX reference's, on the CPU.

The JAX engines run the reference's paged-attention kernel
(``BIGDL_TPU_PAGED_KERNEL=1``, interpret mode), so at tp > 1 they run it
under ``shard_map`` (queue B row 6). On the tiny model of
``tests/test_tp_serving.py`` (vocab 64, so the embedding really shards),
with its prompts, 3 slots (mid-flight admission), pages of 8 and prefill
chunks of 4, the port's greedy tokens at tp 1, 2 and 4 must equal the JAX
engine's at the same tp, float and int8 K/V. A per-chip ``kv_bytes``
budget gives the reference's pages; the measured per-shard bytes times tp
are the whole pool's; the flag, the errors and one prefill chunk's hidden
states (within 1e-5 of the unsharded model's) are checked too.
"""

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu.models.gpt import GPTForCausalLM as JaxGPT
from bigdl_tpu.serving import ServingEngine as JaxEngine
from bigdl_tpu.serving.paging import pages_for_budget as jax_pages_for_budget
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models.gpt import GPTForCausalLM
from bigdl_tpu_torch.nn.quantized import Int8Linear
from bigdl_tpu_torch.ops.paged_attention import paged_pool_attention
from bigdl_tpu_torch.parallel.layout import ModelLayout
from bigdl_tpu_torch.parallel.tensor_parallel import TensorParallelCausalLM
from bigdl_tpu_torch.serving import ServingEngine

CFG = dict(vocab_size=64, hidden_size=32, n_layers=2, n_heads=4,
           max_position=64)
PROMPTS = [[5, 9, 2, 17, 3], [1, 1, 4, 60, 8], [7, 3, 3],
           [9, 9, 9, 1, 0, 2, 4], [2, 4], [11, 12, 13, 14, 15, 16]]
ENGINE = dict(max_slots=3, paged=True, kv_bytes=1 << 20, page_size=8,
              prefill_chunk=4)
WAIT = 120.0
N_NEW = 10


def _jax_model(monkeypatch, seed):
    # the reference reads its kernel flag when the attention is built
    monkeypatch.setenv("BIGDL_TPU_PAGED_KERNEL", "1")
    jm = JaxGPT(**CFG)
    params, _ = jm.setup(jax.random.PRNGKey(seed), None)
    return jm, params


def _state_dict(params):
    return convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          params))


def _port_engine(sd, **kw):
    m = GPTForCausalLM(**CFG, device="cpu")
    return ServingEngine(m, sd, device="cpu", **{**ENGINE, **kw})


def _serve(engine, prompts, n_new=N_NEW):
    try:
        handles = [engine.submit(p, n_new) for p in prompts]
        return [engine.result(h, timeout=WAIT) for h in handles]
    finally:
        engine.shutdown()


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_greedy_tokens_match_jax_engine(multi_device_cpu, monkeypatch, tp):
    jm, params = _jax_model(monkeypatch, 1)
    want = _serve(JaxEngine(jm, params, tp=tp, **ENGINE), PROMPTS)
    before = (paged_pool_attention.launches,
              paged_pool_attention.int8_launches)
    calls = paged_pool_attention.sharded_calls
    eng = _port_engine(_state_dict(params), tp=tp)
    got = _serve(eng, PROMPTS)
    met = eng.metrics()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert met["tp_degree"] == tp
    assert met["admitted"] == met["retired"] == len(PROMPTS)
    # one sharded attention call per layer and dispatch at tp > 1; the
    # CPU runs the plain versions and launches nothing
    sharded = met["sharded_attention_calls"] - calls
    dispatches = met["prefill_chunks"] + met["steps"]
    assert sharded == (CFG["n_layers"] * dispatches if tp > 1 else 0)
    assert (paged_pool_attention.launches,
            paged_pool_attention.int8_launches) == before


def test_int8_kv_tp2_matches_jax_engine(multi_device_cpu, monkeypatch):
    jm, params = _jax_model(monkeypatch, 4)
    want = _serve(JaxEngine(jm, params, tp=2, int8_kv=True, **ENGINE),
                  PROMPTS)
    eng = _port_engine(_state_dict(params), tp=2, int8_kv=True)
    got = _serve(eng, PROMPTS)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert eng.metrics()["kv_dtype"] == "int8"


@pytest.mark.parametrize("int8", [False, True], ids=["float32", "int8"])
def test_per_chip_budget_gives_the_reference_pages(int8):
    jm = JaxGPT(**CFG)
    sd = convert.init_params(GPTForCausalLM(**CFG, device="cpu"), seed=0)
    budget = ENGINE["kv_bytes"]
    pages = {}
    for tp in (1, 2, 4):
        eng = _port_engine(sd, tp=tp, int8_kv=int8)
        try:
            st = eng.slots.pool_stats()
        finally:
            eng.shutdown(drain=False)
        assert st["num_pages"] == jax_pages_for_budget(
            jm, 8, budget, int8=int8, tp=tp)
        assert st["tp_degree"] == tp
        assert st["pool_bytes_per_chip"] <= budget
        # measured from the first shard's planes
        assert st["kv_bytes_per_token_per_chip"] * tp == \
            st["kv_bytes_per_token"]
        pages[tp] = st["num_pages"]
    if int8:
        assert (pages[1], pages[2]) == (682, 1365)
    else:
        assert pages[2] == 2 * pages[1] and pages[4] == 4 * pages[1]


def test_measured_shard_bytes_times_tp_is_the_whole_pool():
    sd = convert.init_params(GPTForCausalLM(**CFG, device="cpu"), seed=0)
    for int8 in (False, True):
        eng = _port_engine(sd, tp=2, int8_kv=int8, kv_pages=16)
        try:
            planes = eng.model.gpt.pool_planes(eng.slots._pools)
        finally:
            eng.shutdown(drain=False)
        nbytes = [sum(v.numel() * v.element_size() for v in shard)
                  for shard in planes]
        assert nbytes[0] == nbytes[1]
        st = eng.slots.pool_stats()
        assert nbytes[0] * 2 == st["pool_bytes"]
        assert nbytes[0] == st["pool_bytes_per_chip"]


def test_flag_enables_tp_and_explicit_tp_overrides(monkeypatch):
    sd = convert.init_params(GPTForCausalLM(**CFG, device="cpu"), seed=0)
    monkeypatch.setenv("BIGDL_TPU_SERVING_TP", "2")
    eng = _port_engine(sd)
    try:
        assert eng.metrics()["tp_degree"] == 2
        assert eng.layout is not None and eng.layout.tp == 2
    finally:
        eng.shutdown(drain=False)
    monkeypatch.setenv("BIGDL_TPU_SERVING_TP", "4")
    eng = _port_engine(sd, tp=2)
    try:
        assert eng.metrics()["tp_degree"] == 2
    finally:
        eng.shutdown(drain=False)
    eng = _port_engine(sd, tp=1)
    try:
        assert eng.layout is None and eng.metrics()["tp_degree"] == 1
    finally:
        eng.shutdown(drain=False)


def test_mesh_places_shards_and_serves(monkeypatch):
    sd = convert.init_params(GPTForCausalLM(**CFG, device="cpu"), seed=0)
    m = GPTForCausalLM(**CFG, device="cpu")
    eng = ServingEngine(m, sd, mesh=["cpu", "cpu"], **ENGINE)
    assert eng.layout.describe()["shard_devices"] == ["cpu", "cpu"]
    got = _serve(eng, PROMPTS[:2], 4)
    assert [g.size for g in got] == [len(p) + 4 for p in PROMPTS[:2]]


def test_errors(monkeypatch):
    sd = convert.init_params(GPTForCausalLM(**CFG, device="cpu"), seed=0)
    with pytest.raises(ValueError, match="divisible"):
        _port_engine(sd, tp=3)
    m = GPTForCausalLM(**CFG, device="cpu")
    with pytest.raises(ValueError, match="mesh="):
        ServingEngine(m, sd, mesh=["cpu", "cpu"], device="cpu", **ENGINE)
    # int8 weights under tp (ROADMAP A.6b) now build int8 shards
    with _port_engine(sd, tp=2, int8_weights=True) as eng:
        shard = eng.model.gpt.shards[1].gpt.layers[0]
        assert isinstance(shard.attn.wo, Int8Linear)
        assert shard.fc1.scale.shape == (4 * CFG["hidden_size"] // 2,)
    # tp alone asks for that many cards; a CPU-only torch has none
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="mesh="):
        ServingEngine(GPTForCausalLM(**CFG, device="cpu"), sd, tp=2,
                      **ENGINE)


@pytest.mark.parametrize("tp", [2, 4])
def test_prefill_chunk_hidden_states_match_unsharded(tp):
    m = GPTForCausalLM(**CFG, device="cpu")
    m.load_state_dict(convert.init_params(m, seed=3))
    m.requires_grad_(False)
    tpm = TensorParallelCausalLM(m, ModelLayout(["cpu"] * tp))
    tpm.requires_grad_(False)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, CFG["vocab_size"], (2, 8))
    table = np.array([[0, 1, 6, 6, 6, 6, 6, 6], [2, 6, 6, 6, 6, 6, 6, 6]],
                     np.int32)
    args = (table, ids, np.array([0, 0]), np.array([8, 5]),
            np.array([0, 0]), 8)
    want, _ = m.gpt.paged_prefill_chunk(m.gpt.init_paged_pool(6, 8), *args)
    got, pools = tpm.gpt.paged_prefill_chunk(tpm.gpt.init_paged_pool(6, 8),
                                             *args)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tpm._lm_logits(got).numpy(),
                               m._lm_logits(want).numpy(), rtol=1e-5,
                               atol=1e-5)
    # one decode step on top of the chunk
    tok = np.array([3, 60])
    want_d, _ = m.gpt.paged_decode_step(
        m.gpt.paged_prefill_chunk(m.gpt.init_paged_pool(6, 8), *args)[1],
        table, tok, np.array([8, 5]), 8)
    got_d, _ = tpm.gpt.paged_decode_step(pools, table, tok,
                                         np.array([8, 5]), 8)
    np.testing.assert_allclose(got_d.numpy(), want_d.numpy(), rtol=1e-5,
                               atol=1e-5)
