"""The port's paged serving engine (``bigdl_tpu_torch/serving``) against
the JAX reference, on the CPU.

Greedy tokens of ``ServingEngine(device="cpu", paged=True)`` must equal
the JAX ``ServingEngine(paged=True)``'s on the same weights, for 4 prompts
on 2 slots (so two are admitted mid-flight) with a shared prompt prefix.
A sampled request retires; the engine refuses to start without a device
when CUDA is absent; CPU tensors never launch a kernel; the reference's
unported options raise.
"""

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu.models.gpt import GPTForCausalLM as JaxGPT
from bigdl_tpu.serving import ServingEngine as JaxEngine
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models.gpt import GPTForCausalLM
from bigdl_tpu_torch.ops.paged_attention import paged_pool_attention
from bigdl_tpu_torch.ops.sampling import fused_sample_logits
from bigdl_tpu_torch.serving import (EngineFailedError, PagePoolExhausted,
                                     ServingEngine)

CFG = dict(vocab_size=97, hidden_size=64, n_layers=2, n_heads=4,
           max_position=64)
ENGINE = dict(max_slots=2, paged=True, page_size=8, prefill_chunk=8)
WAIT = 120.0
N_NEW = 8


def _prompts():
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, 97, 19)
    return [np.concatenate([prefix, rng.integers(0, 97, 4)]),
            rng.integers(0, 97, 5),
            np.concatenate([prefix, rng.integers(0, 97, 2)]),
            rng.integers(0, 97, 11)]


@pytest.fixture(scope="module")
def weights():
    jm = JaxGPT(**CFG)
    params, _ = jm.setup(jax.random.PRNGKey(1), None)
    return jm, params, convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params))


def _port_engine(state_dict, **kw):
    m = GPTForCausalLM(**CFG, device="cpu")
    return ServingEngine(m, state_dict, device="cpu", **{**ENGINE, **kw})


def _serve(engine, prompts, **kw):
    handles = [engine.submit(p, N_NEW, **kw) for p in prompts]
    return [engine.result(h, timeout=WAIT) for h in handles]


def test_greedy_tokens_match_jax_engine(weights):
    jm, params, sd = weights
    prompts = _prompts()
    jeng = JaxEngine(jm, params, **ENGINE)
    try:
        want = _serve(jeng, prompts)
    finally:
        jeng.shutdown()
    launches = (paged_pool_attention.launches, fused_sample_logits.launches)
    with _port_engine(sd) as eng:
        got = _serve(eng, prompts)
        m = eng.metrics()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert m["admitted"] == m["retired"] == 4
    assert m["prefix_hits"] >= 1           # the shared 19-token prefix
    assert m["prefill_chunks"] >= 1 and m["steps"] >= N_NEW
    # CPU tensors run the plain versions: no kernel launch
    assert (paged_pool_attention.launches,
            fused_sample_logits.launches) == launches


def test_sampled_request_retires(weights):
    _, _, sd = weights
    prompts = _prompts()
    with _port_engine(sd, top_k=10, top_p=0.9, seed=3) as eng:
        hs = [eng.submit(prompts[0], N_NEW, temperature=0.8),
              eng.submit(prompts[1], N_NEW)]
        out = [eng.result(h, timeout=WAIT) for h in hs]
        streamed = list(eng.stream(hs[0]))
        assert eng.metrics()["retired"] == 2
    assert out[0].size == prompts[0].size + N_NEW
    assert streamed == out[0][prompts[0].size:].tolist()
    assert ((out[0] >= 0) & (out[0] < CFG["vocab_size"])).all()


def test_no_device_raises_without_cuda(weights, monkeypatch):
    _, _, sd = weights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = GPTForCausalLM(**CFG, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(m, sd, **ENGINE)
    with pytest.raises(RuntimeError, match="CUDA"):
        GPTForCausalLM(**CFG)


@pytest.mark.parametrize("kw", [
    {"paged": False}, {"spec_tokens": 4}, {"failover": True},
    {"adapters": ["tenant-a"]}, {"tp": 2, "int8_weights": True},
    {"lora": True},
    {"kv_snapshot": True}, {"kv_host_tier": True},
], ids=lambda kw: next(iter(kw)))
def test_unported_options_raise(weights, kw):
    _, _, sd = weights
    m = GPTForCausalLM(**CFG, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServingEngine(m, sd, device="cpu", **{**ENGINE, **kw})


def test_request_checks_and_failure_reaches_result(weights, monkeypatch):
    _, _, sd = weights
    with _port_engine(sd, kv_pages=8) as eng:
        with pytest.raises(ValueError):
            eng.submit(np.zeros(60, np.int32), 10)   # past max_position
        ok = eng.generate(_prompts()[1], 3, timeout=WAIT)
        assert ok.size == 5 + 3

        # any dispatch error fails the request with that error
        def boom(*a, **k):
            raise RuntimeError("kernel fault")

        monkeypatch.setattr(eng.slots, "_step", boom)
        h = eng.submit(_prompts()[1], 3)
        with pytest.raises(RuntimeError, match="kernel fault"):
            h.result(timeout=WAIT)
        with pytest.raises(EngineFailedError):
            eng.submit(_prompts()[1], 3)
    assert issubclass(PagePoolExhausted, RuntimeError)
