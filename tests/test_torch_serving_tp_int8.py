"""The port's tensor-parallel serving with int8 weights, and its dense
tensor-parallel path (``ServingEngine(tp=N)``: ``bigdl_tpu_torch/
parallel/tensor_parallel.py``, ``nn/quantized.py``
``qmatmul_row_parallel``, the dense ``serving/slots.py`` manager) against
the JAX reference's, on the CPU.

The JAX engines shard over the 8 virtual CPU devices of
``tests/conftest.py`` (``multi_device_cpu``); the paged ones run the
reference's paged-attention kernel (``BIGDL_TPU_PAGED_KERNEL=1``). On the
tiny model of ``tests/test_tp_serving.py`` (vocab 64: the embedding
really shards) with its six prompts and three slots (mid-flight
admission):

- int8 weights at tp 2 and 4, dense and paged: greedy tokens identical to
  the reference engine's at tp 2;
- every step of the int8 product under tp is exact (a max, int8
  products, an int32 sum), so the port's logits at tp 2 and 4 are bit for
  bit its unsharded int8 logits, dense and paged;
- dense float32 at tp 2: tokens identical to the reference's; each
  shard's dense cache holds 1/tp of the bytes.
"""

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu.models.gpt import GPTForCausalLM as JaxGPT
from bigdl_tpu.serving import ServingEngine as JaxEngine
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models.gpt import GPTForCausalLM
from bigdl_tpu_torch.nn import Linear
from bigdl_tpu_torch.nn.quantized import (Int8Linear, qmatmul,
                                          qmatmul_row_parallel,
                                          quantize_model)
from bigdl_tpu_torch.parallel.layout import ModelLayout
from bigdl_tpu_torch.parallel.tensor_parallel import TensorParallelCausalLM
from bigdl_tpu_torch.serving import (PagedSlotManager, ServingEngine,
                                     SlotManager)

CFG = dict(vocab_size=64, hidden_size=32, n_layers=2, n_heads=4,
           max_position=64)
PROMPTS = [[5, 9, 2, 17, 3], [1, 1, 4, 60, 8], [7, 3, 3],
           [9, 9, 9, 1, 0, 2, 4], [2, 4], [11, 12, 13, 14, 15, 16]]
DENSE = dict(max_slots=3, max_queue=16, prefill_window=2)
PAGED = dict(max_slots=3, paged=True, kv_bytes=1 << 20, page_size=8,
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


def _serve(engine, prompts=PROMPTS, n_new=N_NEW):
    """Every prompt submitted while the scheduler waits on its lock, so its
    first admission pass sees the whole burst and the admission batches
    are the same in every run and in both packages. Int8 weights quantise
    a dispatch's rows against one activation amax, so the tokens depend
    on the batches; with the submits racing the scheduler thread they
    followed the threads' timing."""
    try:
        with engine.scheduler._cond:
            handles = [engine.submit(p, n_new) for p in prompts]
        return [engine.result(h, timeout=WAIT) for h in handles]
    finally:
        engine.shutdown()


def _port_engine(sd, **kw):
    return ServingEngine(GPTForCausalLM(**CFG, device="cpu"), sd,
                         device="cpu", **kw)


@pytest.mark.parametrize("path", ["dense", "paged"])
def test_int8_weights_tp_tokens_match_jax_engine(multi_device_cpu,
                                                 monkeypatch, path):
    jm, params = _jax_model(monkeypatch, 1)
    kw = DENSE if path == "dense" else PAGED
    want = _serve(JaxEngine(jm, params, tp=2, int8_weights=True, **kw))
    sd = _state_dict(params)
    for tp in (2, 4):
        calls = qmatmul.calls
        eng = _port_engine(sd, tp=tp, int8_weights=True, **kw)
        got = _serve(eng)
        met = eng.metrics()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
        assert met["tp_degree"] == tp and met["paged"] == (path == "paged")
        assert met["retired"] == len(PROMPTS)
        # each shard's product counts: 6 a layer and shard a dispatch
        dispatches = met["dispatches"] - met.get("copies", 0)
        assert qmatmul.calls - calls == 6 * tp * CFG["n_layers"] * dispatches


def _manager(model, path, tp, int8_kv=False):
    if tp > 1:
        model = TensorParallelCausalLM(model, ModelLayout(["cpu"] * tp))
    if path == "dense":
        return SlotManager(model, max_slots=3, window=3)
    return PagedSlotManager(model, max_slots=3, num_pages=64, page_size=8,
                            window=3, prefill_chunk=4, int8_kv=int8_kv)


@pytest.mark.parametrize("path", ["dense", "paged"])
def test_int8_tp_logits_bit_equal_to_unsharded(path):
    """Three prompts admitted together, then 6 greedy steps, by hand: the
    logits table after the admission and after every step at tp 2 and 4
    equals the unsharded int8 model's bit for bit, and so do the tokens."""
    m = GPTForCausalLM(**CFG, device="cpu")
    m.load_state_dict(convert.init_params(m, seed=5))
    m.requires_grad_(False)
    quantize_model(m)
    runs = {}
    for tp in (1, 2, 4):
        slots = _manager(m, path, tp)
        if tp > 1:
            shard = slots.model.gpt.shards[1].gpt.layers[0]
            assert isinstance(shard.fc2, Int8Linear)
            assert shard.fc2.weight.shape == (32, 128 // tp)
        slots.admit(PROMPTS[:3])
        logits, toks = [slots._logits.clone()], []
        for _ in range(6):
            slots.reserve_block()
            toks.append(slots.step()[0])
            logits.append(slots._logits.clone())
        runs[tp] = (torch.stack(logits), np.stack(toks))
    for tp in (2, 4):
        assert torch.equal(runs[tp][0], runs[1][0]), \
            f"tp {tp}: logits differ by " \
            f"{float((runs[tp][0] - runs[1][0]).abs().max())}"
        np.testing.assert_array_equal(runs[tp][1], runs[1][1])


def test_row_parallel_product_equals_unsharded():
    """``qmatmul_row_parallel`` over 1, 2 and 4 column blocks of a weight
    equals ``qmatmul`` over the whole, bit for bit, and counts one product
    a shard."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 3, 64, generator=g)
    lin = Linear(64, 24, with_bias=False, device="cpu")
    with torch.no_grad():
        lin.weight.copy_(torch.randn(24, 64, generator=g))
    lin = Int8Linear.from_linear(lin)
    want = qmatmul(x, lin.weight, lin.scale)
    for tp in (1, 2, 4):
        calls = qmatmul.calls
        got = qmatmul_row_parallel(list(x.chunk(tp, -1)),
                                   list(lin.weight.chunk(tp, -1)), lin.scale)
        assert torch.equal(got, want)
        assert qmatmul.calls - calls == tp


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_dense_float_tp_tokens_match_jax_engine(multi_device_cpu, tp):
    """The reference's ``test_dense_tp_matches_sequential_generate`` cell:
    dense float32 at tp 1, 2 and 4, admission mid-flight."""
    jm = JaxGPT(**CFG)
    params, _ = jm.setup(jax.random.PRNGKey(0), None)
    want = _serve(JaxEngine(jm, params, tp=tp, **DENSE))
    eng = _port_engine(_state_dict(params), tp=tp, **DENSE)
    got = _serve(eng)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert eng.metrics()["tp_degree"] == tp


def test_dense_cache_bytes_per_shard_is_one_over_tp():
    """Measured from the shards' cache planes: each holds 1/tp of the
    whole cache's bytes, and the stats say so."""
    sd = convert.init_params(GPTForCausalLM(**CFG, device="cpu"), seed=0)
    whole = None
    for tp in (1, 2, 4):
        eng = _port_engine(sd, max_slots=4, tp=tp)
        try:
            planes = eng.model.gpt.cache_planes(eng.slots._cache)
            st = eng.metrics()
        finally:
            eng.shutdown(drain=False)
        nbytes = [sum(v.numel() * v.element_size() for v in shard)
                  for shard in planes]
        whole = whole or nbytes[0]
        assert nbytes == [whole // tp] * tp
        assert st["cache_bytes"] == whole
        assert st["cache_bytes_per_chip"] == whole // tp
