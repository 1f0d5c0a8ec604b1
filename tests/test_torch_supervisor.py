"""The port's ``EngineSupervisor`` (``bigdl_tpu_torch/resilience/
supervisor.py``) on the CPU, in the reference's cases
(``tests/test_resilience.py`` ``TestEngineSupervisor``), at the reference
tests' tiny configuration with the reference's weights carried across by
``convert``; greedy tokens equal the reference's sequential ``generate``.

A crash restarts the engine once and the resubmitted requests stay
token-identical; a ``delay`` fault is detected as a wedge; the circuit
breaker fast-rejects and ``reset_circuit`` restores service; the canned
chaos plans (dense, and paged with page exhaustion) leave zero requests
hung. Then a kernel that faults on every call: the factory's every engine
fails again, and the breaker trips after ``max_restarts`` instead of
looping, every handle a ``CircuitOpenError`` carrying the kernel's error.
Only the port's fault plan is armed; an autouse fixture resets it.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bigdl_tpu.models.gpt import GPTForCausalLM as JaxGPT
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models import gpt as gpt_mod
from bigdl_tpu_torch.models.gpt import GPTForCausalLM
from bigdl_tpu_torch.ops.paged_attention import paged_pool_attention
from bigdl_tpu_torch.resilience import faults
from bigdl_tpu_torch.resilience.supervisor import (CircuitOpenError,
                                                   EngineSupervisor)
from bigdl_tpu_torch.serving import EngineClosedError, ServingEngine

CFG = dict(vocab_size=61, hidden_size=32, n_layers=2, n_heads=4,
           max_position=64)
PROMPTS = [[5, 9, 2, 17, 3], [1, 1, 4, 60, 8], [7, 3, 3],
           [9, 9, 9, 1, 0, 2, 4], [2, 4], [11, 12, 13, 14, 15, 16]]
N_NEW = 10
WAIT = 120.0


@pytest.fixture(autouse=True)
def _clean_port_plan():
    """No fault plan leaks across tests, and the process-wide kernel
    counters (``sharded_calls`` and the launch counts, which other files'
    tests read as this process's totals) are left as they were."""
    saved = (paged_pool_attention.sharded_calls,
             paged_pool_attention.launches,
             paged_pool_attention.int8_launches)
    faults.configure(None)
    yield
    faults.configure(None)
    (paged_pool_attention.sharded_calls, paged_pool_attention.launches,
     paged_pool_attention.int8_launches) = saved


@pytest.fixture(scope="module")
def ref():
    jm = JaxGPT(**CFG)
    params, _ = jm.setup(jax.random.PRNGKey(0), None)
    want = [np.asarray(jm.generate(params, jnp.asarray(p, jnp.int32)[None],
                                   N_NEW))[0] for p in PROMPTS]
    return convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          params)), want


def _supervised(sd, engine_kw=None, **kw):
    ekw = dict(max_slots=8, max_recoveries=0)
    ekw.update(engine_kw or {})

    def factory():
        # max_recoveries=0: a step failure escalates to the failover hook
        # at once, so the restart path runs deterministically
        return ServingEngine(GPTForCausalLM(**CFG, device="cpu"), sd,
                             device="cpu", **ekw)

    kw.setdefault("poll_interval_s", 0.02)
    kw.setdefault("backoff_base_s", 0.01)
    kw.setdefault("backoff_max_s", 0.05)
    return EngineSupervisor(factory, **kw)


@pytest.mark.parametrize("paged", [False, True])
def test_crash_restart_resubmits_token_identical(ref, paged):
    sd, want = ref
    faults.configure("serving.step:error:after=2:times=1")
    sup = _supervised(sd, dict(paged=paged, page_size=8, prefill_chunk=4))
    try:
        handles = [sup.submit(p, N_NEW) for p in PROMPTS]
        for h, w in zip(handles, want):
            np.testing.assert_array_equal(h.result(WAIT), w)
        assert sup.restarts == 1
        assert sup.state() == 0                     # serving again
        assert sup.last_recovery_s is not None
        m = sup.metrics()
        assert m["engine_restarts"] == 1 and m["supervisor_state"] == 0
        assert m["supervisor_resubmitted"] >= 1
    finally:
        sup.close(drain=False)


def test_wedge_detected_and_restarted(ref):
    sd, want = ref
    sup = _supervised(sd, wedge_timeout_s=0.5, warmup_grace_s=30.0)
    try:
        sup.generate(PROMPTS[0], 2, timeout=WAIT)   # first tokens out
        wedged = sup.engine
        faults.configure("serving.step:delay=3:times=1")
        handles = [sup.submit(p, 8) for p in PROMPTS[:3]]
        for h, w in zip(handles, want):
            np.testing.assert_array_equal(h.result(WAIT), w[:len(w) - 2])
        assert sup.restarts >= 1 and sup.engine is not wedged
    finally:
        sup.close(drain=False)
    # the abandoned loop wakes from its nap and exits without touching its
    # requests; joined here so no thread outlives the test
    wedged.scheduler._thread.join(WAIT)
    assert not wedged.is_alive()


def test_circuit_breaker_fast_rejects(ref):
    sd, _ = ref
    faults.configure("serving.step:error")          # persistent
    sup = _supervised(sd, max_restarts=2, restart_window_s=60.0,
                      submit_wait_s=0.5)
    try:
        handles = [sup.submit(p, 6) for p in PROMPTS[:3]]
        for h in handles:
            with pytest.raises(CircuitOpenError):
                h.result(WAIT)
        assert sup.state() == 2 and sup.restarts == 2
        with pytest.raises(CircuitOpenError):
            sup.submit([1, 2, 3], 4)
        # the fault is fixed and the circuit closed: service resumes on
        # the next restart
        faults.configure(None)
        sup.reset_circuit()
        deadline = time.monotonic() + WAIT
        while sup.state() != 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert sup.generate([5, 9, 2], 4, timeout=WAIT).shape == (7,)
    finally:
        sup.close(drain=False)


def _zero_hung(handles):
    done, errors = 0, []
    for h in handles:
        try:
            assert h.result(WAIT).dtype == np.int32
            done += 1
        except Exception as e:      # noqa: BLE001 - a clean failure
            errors.append(e)
    assert done + len(errors) == len(handles)        # zero hung
    assert not any(isinstance(e, TimeoutError) for e in errors)
    return done


def test_chaos_canned_plan_zero_hung(ref):
    """A multi-fault canned plan (crash, straggler, prefill fault) over a
    supervised engine: every caller gets an answer or a clean error."""
    sd, _ = ref
    sup = _supervised(sd)
    try:
        sup.generate(PROMPTS[0], 2, timeout=WAIT)
        handles = [sup.submit(p, 8) for p in PROMPTS]
        faults.configure("seed=11;"
                         "serving.step:error:after=1:times=2;"
                         "serving.step:delay=0.05:every=4;"
                         "serving.prefill:error:times=1")
        assert _zero_hung(handles) >= 1
    finally:
        sup.close(drain=False)


def test_chaos_paged_page_alloc_zero_hung(ref):
    sd, _ = ref
    sup = _supervised(sd, dict(max_slots=4, paged=True, kv_pages=8,
                               prefill_chunk=4))
    try:
        sup.generate(PROMPTS[0], 2, timeout=WAIT)
        handles = [sup.submit(p, 8) for p in PROMPTS]
        faults.configure("seed=9;"
                         "serving.page_alloc:error:after=2:times=3;"
                         "serving.step:error:after=1:times=1")
        assert _zero_hung(handles) >= 1
    finally:
        sup.close(drain=False)


def test_kernel_fault_trips_the_breaker(ref, monkeypatch):
    """A paged-attention kernel that fails on every call from the 3rd on
    (the process-wide wrapper, so every rebuilt engine fails too): the
    supervisor restarts up to ``max_restarts`` times, then trips; every
    handle resolves with ``CircuitOpenError`` carrying the kernel's
    error, nothing hangs, nothing retires with tokens."""
    sd, _ = ref
    real = gpt_mod.paged_pool_attention
    calls = {"n": 0}

    def failing(*a, **k):
        calls["n"] += 1
        if calls["n"] > 2:
            raise RuntimeError("kernel fault: an illegal memory access")
        return real(*a, **k)

    monkeypatch.setattr(gpt_mod, "paged_pool_attention", failing)
    sup = _supervised(sd, dict(paged=True, page_size=8, prefill_chunk=4),
                      max_restarts=2, submit_wait_s=0.5)
    try:
        handles = [sup.submit(p, 6) for p in PROMPTS[:4]]
        for h in handles:
            with pytest.raises(CircuitOpenError) as info:
                h.result(WAIT)
            assert "kernel fault" in str(info.value.__cause__)
            assert not h.tokens
        assert sup.state() == 2 and sup.restarts == 2
        with pytest.raises(CircuitOpenError):
            sup.submit(PROMPTS[0], 2)
    finally:
        sup.close(drain=False)


def test_evacuate_returns_the_unfinished(ref):
    sd, want = ref
    sup = _supervised(sd)
    try:
        faults.configure("serving.step:delay=0.2")
        handles = [sup.submit(p, N_NEW) for p in PROMPTS[:3]]
        time.sleep(0.3)
        taken = sup.evacuate()
        assert sup.state() == 2
        assert {r.id for r in taken} == {h.id for h in handles
                                         if not h.done.is_set()}
        faults.configure(None)
        # adopted by another engine, the streams finish where they stopped
        with ServingEngine(GPTForCausalLM(**CFG, device="cpu"), sd,
                           device="cpu", max_slots=8) as other:
            for r in taken:
                other.resubmit(r)
            for h, w in zip(handles, want):
                np.testing.assert_array_equal(h.result(WAIT), w)
    finally:
        sup.close(drain=False)


def test_close_fails_banked_victims(ref):
    sd, _ = ref
    sup = _supervised(sd)
    sup.close()
    with pytest.raises(EngineClosedError):
        sup.submit(PROMPTS[0], 2)
