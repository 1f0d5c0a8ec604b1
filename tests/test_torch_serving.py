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


# the reference's flags that turn an unported feature on, each with the
# ROADMAP item the port's refusal must name
UNPORTED_FLAGS = {"BIGDL_TPU_SPEC_DECODE": "A.5", "BIGDL_TPU_KV_SNAPSHOT": "A.7",
                  "BIGDL_TPU_KV_HOST_TIER": "A.7", "BIGDL_TPU_LORA": "A.8"}


@pytest.mark.parametrize("kw", [
    {"paged": False}, {"spec_tokens": 4}, {"failover": True},
    {"adapters": ["tenant-a"]}, {"tp": 2, "int8_weights": True},
    {"lora": True},
    {"kv_snapshot": True}, {"kv_host_tier": True},
    *({flag: "1"} for flag in UNPORTED_FLAGS),
], ids=lambda kw: next(iter(kw)))
def test_unported_options_raise(weights, kw, monkeypatch):
    """By keyword, or by the reference's flag (``BIGDL_TPU_*`` keys are set
    in the environment, not passed), naming the ROADMAP item."""
    _, _, sd = weights
    kw = dict(kw)
    match = "ROADMAP"
    for flag in [k for k in kw if k.startswith("BIGDL_TPU_")]:
        monkeypatch.setenv(flag, kw.pop(flag))
        match = f"ROADMAP queue {UNPORTED_FLAGS[flag]}"
    m = GPTForCausalLM(**CFG, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        ServingEngine(m, sd, device="cpu", **{**ENGINE, **kw})


@pytest.mark.parametrize("flag, kw", [
    ("BIGDL_TPU_SPEC_DECODE", {"spec_tokens": 1}),
    ("BIGDL_TPU_KV_SNAPSHOT", {"kv_snapshot": False}),
    ("BIGDL_TPU_KV_HOST_TIER", {"kv_host_tier": False}),
    ("BIGDL_TPU_LORA", {"lora": False}),
])
def test_unported_flag_yields_to_keyword(weights, flag, kw, monkeypatch):
    """An explicit keyword that turns the feature off wins over its flag,
    as in the reference."""
    _, _, sd = weights
    monkeypatch.setenv(flag, "1")
    with _port_engine(sd, **kw) as eng:
        assert eng.generate(_prompts()[1], 2, timeout=WAIT).size == 5 + 2


@pytest.mark.parametrize("sub, value, parent", [
    ("snapshot_dir", "/nonexistent/snapshots", "kv_snapshot"),
    ("snapshot_interval_s", 0.25, "kv_snapshot"),
    ("snapshot_journal", "journal.log", "kv_snapshot"),
    ("host_tier_bytes", 1 << 20, "kv_host_tier"),
    ("host_tier_prefetch", 4, "kv_host_tier"),
    ("lora_rank", 4, "lora"),
    ("adapter_slots", 2, "lora"),
    ("adapter_host_bytes", 1 << 20, "lora"),
])
def test_sub_options_follow_parent(weights, sub, value, parent):
    """A sub-option of an unported option is ignored while its parent is
    off and refused, naming the ROADMAP item, while it is on; an unknown
    keyword is still a TypeError."""
    _, _, sd = weights
    with _port_engine(sd, **{sub: value}) as eng:
        assert eng.generate(_prompts()[1], 2, timeout=WAIT).size == 5 + 2
    m = GPTForCausalLM(**CFG, device="cpu")
    with pytest.raises(NotImplementedError, match=f"{sub}.*ROADMAP queue A"):
        ServingEngine(m, sd, device="cpu", **ENGINE,
                      **{sub: value, parent: True})
    with pytest.raises(TypeError, match="unexpected keyword"):
        ServingEngine(m, sd, device="cpu", **ENGINE, **{f"{sub}_x": value})


def test_kernel_page_sizes():
    """The paged kernel is built for pages of 8, 16 and 32 at head sizes
    32, 64, 96 and 128; its wrapper's shape check (the one a card call
    runs before launching) takes those pages and refuses page 12."""
    from bigdl_tpu_torch.ops import paged_attention as pa
    assert pa.KERNEL_SHAPES == tuple((ps, d) for d in (32, 64, 96, 128)
                                     for ps in (8, 16, 32))
    q = torch.zeros((2, 4, 1, 64))
    table = torch.zeros((2, 3), dtype=torch.int32)
    start = torch.zeros(2, dtype=torch.int32)
    for ps in (8, 16, 32, 12):
        pool = {"k": torch.zeros((6, 4, ps, 64)),
                "v": torch.zeros((6, 4, ps, 64))}
        if ps == 12:
            with pytest.raises(ValueError, match="not in"):
                pa._check_cuda_args(q, pool, table, start)
        else:
            pa._check_cuda_args(q, pool, table, start)


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
