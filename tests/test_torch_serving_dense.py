"""The port's dense serving engine (``bigdl_tpu_torch/serving/slots.py``
``SlotManager`` behind ``ServingEngine``, the default as in the
reference) against the JAX reference's ``ServingEngine(paged=False)``, on
the CPU, on the same seeded weights (``convert``).

Greedy tokens must be identical: with fewer slots than requests (admission
mid-flight, batched prefill of two prompts) and with ``steps_per_sync``
4, as ``tests/test_serving.py`` holds the reference. EOS retirement, the
refusal of overlong prompts without leaking a slot, the paged-only
options being ignored (``kv_snapshot`` / ``kv_host_tier`` by keyword
refused, as in the reference), and a dispatch error failing every in-flight
request are checked too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.gpt import GPTForCausalLM as JaxGPT
from bigdl_tpu.serving import ServingEngine as JaxEngine
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models.gpt import GPTForCausalLM
from bigdl_tpu_torch.ops.sampling import fused_sample_logits
from bigdl_tpu_torch.serving import (EngineFailedError, ServingEngine,
                                     SlotManager)

CFG = dict(vocab_size=61, hidden_size=32, n_layers=2, n_heads=4,
           max_position=64)
PROMPTS = [[5, 9, 2, 17, 3], [1, 1, 4, 60, 8], [7, 3, 3],
           [9, 9, 9, 1, 0, 2, 4], [2, 4], [11, 12, 13, 14, 15, 16]]
WAIT = 120.0


def _pair(seed):
    jm = JaxGPT(**CFG)
    params, _ = jm.setup(jax.random.PRNGKey(seed), None)
    return jm, params, convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params))


def _port(sd, **kw):
    return ServingEngine(GPTForCausalLM(**CFG, device="cpu"), sd,
                         device="cpu", **kw)


def _serve(engine, prompts, n_new, **kw):
    try:
        handles = [engine.submit(p, n_new, **kw) for p in prompts]
        return [engine.result(h, timeout=WAIT) for h in handles]
    finally:
        engine.shutdown()


def test_default_engine_is_dense_in_both_packages(monkeypatch):
    monkeypatch.delenv("BIGDL_TPU_PAGED_KV", raising=False)
    jm, params, sd = _pair(0)
    jeng = JaxEngine(jm, params, max_slots=2)
    try:
        assert jeng.paged is False
    finally:
        jeng.shutdown()
    with _port(sd, max_slots=2) as eng:
        assert eng.paged is False and not eng.slots.paged
        assert isinstance(eng.slots, SlotManager)
        assert eng.metrics()["paged"] is False
    monkeypatch.setenv("BIGDL_TPU_PAGED_KV", "1")
    with _port(sd, max_slots=2) as eng:
        assert eng.paged is True and eng.slots.paged


@pytest.mark.parametrize("engine_kw", [
    dict(max_slots=3, max_queue=16, prefill_window=2),
    dict(max_slots=4, steps_per_sync=4)], ids=["mid_flight", "block_of_4"])
def test_greedy_tokens_match_jax_dense_engine(engine_kw):
    """Six prompts, 10 greedy tokens each: three slots (requests join the
    running batch as others retire) or four slots decoding blocks of 4
    (10 is not a multiple: each request's tail junk is dropped)."""
    jm, params, sd = _pair(2)
    want = _serve(JaxEngine(jm, params, paged=False, **engine_kw), PROMPTS,
                  10)
    launches = fused_sample_logits.launches
    eng = _port(sd, **engine_kw)
    got = _serve(eng, PROMPTS, 10)
    m = eng.metrics()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert m["admitted"] == m["retired"] == len(PROMPTS)
    assert m["prefills"] >= 2 and m["steps"] >= 10 // eng.slots.steps_per_sync
    assert m["dispatches"] == m["prefills"] + m["steps"]
    assert m["sampled_steps"] == 0
    # CPU tensors run the plain versions: no kernel launch
    assert fused_sample_logits.launches == launches


def test_mid_flight_submission_matches_generate():
    """Requests submitted while earlier ones are mid-generation join the
    running batch; every request's greedy tokens equal the port's batch-1
    ``generate`` (and so the reference's, by test_torch_generate)."""
    _, _, sd = _pair(3)
    m = GPTForCausalLM(**CFG, device="cpu")
    m.load_state_dict(sd)
    want = [m.generate(p, 12)[0].numpy() for p in PROMPTS]
    eng = _port(sd, max_slots=4, max_queue=16)
    try:
        first = [eng.submit(p, 12) for p in PROMPTS[:2]]
        stream = eng.stream(first[0])
        next(stream)
        assert not first[0].done.is_set()
        late = [eng.submit(p, 12) for p in PROMPTS[2:]]
        got = [eng.result(h, timeout=WAIT) for h in first + late]
    finally:
        eng.shutdown()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_eos_retires_early_and_frees_the_slot():
    jm, params, sd = _pair(0)
    want = np.asarray(jm.generate(params, jnp.asarray([PROMPTS[0]],
                                                      jnp.int32), 12))[0]
    gen = want[len(PROMPTS[0]):]
    eos = int(gen[3])
    cut = int(np.argmax(gen == eos)) + 1
    assert cut < 12
    with _port(sd, max_slots=1) as eng:
        got = eng.result(eng.submit(PROMPTS[0], 12, eos_token=eos),
                         timeout=WAIT)
        # the one slot is free again: a second request is served
        again = eng.result(eng.submit(PROMPTS[1], 2), timeout=WAIT)
        assert eng.slots.free_slots() == 1
    np.testing.assert_array_equal(got, want[:len(PROMPTS[0]) + cut])
    assert again.size == len(PROMPTS[1]) + 2


def test_overlong_prompts_refused_without_leaking_a_slot():
    _, _, sd = _pair(0)
    m = GPTForCausalLM(**CFG, device="cpu")
    m.load_state_dict(sd)
    slots = SlotManager(m, max_slots=2)
    with pytest.raises(ValueError, match="slot capacity of 63"):
        slots.admit([np.arange(64) % 61])
    with pytest.raises(ValueError, match="slot capacity"):
        slots.admit([[1, 2], np.arange(70) % 61])
    assert slots.free_slots() == 2 and slots.occupancy() == 0
    assert slots.admit([[1, 2]]) == [0]
    with pytest.raises(ValueError, match="exceeds window"):
        slots.admit([[1]] * 2)
    with _port(sd, max_slots=2) as eng:
        with pytest.raises(ValueError, match="exceeds max_position"):
            eng.submit(np.arange(60) % 61, 8)
        assert eng.generate(PROMPTS[1], 3, timeout=WAIT).size == 8
        assert eng.slots.free_slots() == 2


def test_paged_only_options_ignored_on_dense_path(monkeypatch):
    """``page_size``, ``kv_pages``, ``prefill_chunk``, ``prefix_cache``,
    ``int8_kv``, ``kv_bytes`` and the flags of the paged path's unported
    ``kv_snapshot`` / ``kv_host_tier`` are not read by the dense engine,
    as the reference reads them only under ``paged``: it serves the same
    tokens as without them."""
    _, _, sd = _pair(1)
    plain = _serve(_port(sd, max_slots=2), PROMPTS[:3], 6)
    monkeypatch.setenv("BIGDL_TPU_KV_SNAPSHOT", "1")
    monkeypatch.setenv("BIGDL_TPU_KV_HOST_TIER", "1")
    eng = _port(sd, max_slots=2, page_size=12, kv_pages=3, prefill_chunk=5,
                prefix_cache=False, int8_kv=True, kv_bytes=10,
                snapshot_dir="/nonexistent")
    assert not eng.paged and eng.metrics()["kv_dtype"] == "float32"
    for g, w in zip(_serve(eng, PROMPTS[:3], 6), plain):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("option", ["kv_snapshot", "kv_host_tier"])
def test_paged_only_durability_keyword_refused_on_dense_path(option):
    """Asked for by keyword, the paged path's ``kv_snapshot`` and
    ``kv_host_tier`` make both dense engines raise ``ValueError`` naming
    ``paged=True``, so a durability request is never dropped silently."""
    jm, params, sd = _pair(0)
    with pytest.raises(ValueError, match=f"{option} requires paged=True"):
        JaxEngine(jm, params, max_slots=2, paged=False, **{option: True})
    with pytest.raises(ValueError, match=f"{option} requires paged=True"):
        _port(sd, max_slots=2, snapshot_dir="/nonexistent", **{option: True})


def test_dense_cache_bytes():
    _, _, sd = _pair(0)
    with _port(sd, max_slots=3) as eng:
        st = eng.metrics()
    # 2 layers x K and V x 4 heads x head_dim 8 x 4 bytes a token
    assert st["kv_bytes_per_token"] == 2 * 2 * 4 * 8 * 4
    assert st["cache_bytes"] == st["kv_bytes_per_token"] * 64 * 3
    assert st["cache_bytes_per_chip"] == st["cache_bytes"]


def test_dispatch_error_fails_every_inflight_request(monkeypatch):
    """At a recovery budget of 0 a decode step that raises fails every
    request in flight, and the engine then refuses new work (at the
    default budget the loop recovers in place: ``test_torch_recovery``)."""
    _, _, sd = _pair(0)
    eng = _port(sd, max_slots=2, max_queue=8, max_recoveries=0)
    boom = RuntimeError("injected dispatch fault")
    calls = {"n": 0}
    real = SlotManager._step

    def failing(self):
        calls["n"] += 1
        if calls["n"] == 3:
            raise boom
        return real(self)

    monkeypatch.setattr(SlotManager, "_step", failing)
    try:
        hs = [eng.submit(p, 20) for p in PROMPTS[:4]]
        for h in hs:
            with pytest.raises(RuntimeError, match="injected"):
                eng.result(h, timeout=WAIT)
        with pytest.raises(EngineFailedError):
            eng.submit(PROMPTS[0], 2)
        assert eng.metrics()["failures"] == 1
    finally:
        eng.shutdown(drain=False)


def test_sampled_requests_retire():
    _, _, sd = _pair(0)
    eng = _port(sd, max_slots=2, top_k=10, top_p=0.9, seed=3)
    out = _serve(eng, PROMPTS[:3], 8, temperature=0.8)
    assert [o.size for o in out] == [len(p) + 8 for p in PROMPTS[:3]]
    assert all(((o >= 0) & (o < CFG["vocab_size"])).all() for o in out)
    assert eng.metrics()["sampled_steps"] > 0


def test_no_device_raises_without_cuda(monkeypatch):
    _, _, sd = _pair(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(GPTForCausalLM(**CFG, device="cpu"), sd, max_slots=2)
