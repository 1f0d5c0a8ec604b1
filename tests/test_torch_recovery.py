"""In-place recovery of the port's serving engines (``bigdl_tpu_torch/
serving/scheduler.py``: ``_recover``, ``_place``, ``_quarantine``,
``_give_up``) against the reference's, on the CPU.

The reference's cases (``tests/test_resilience.py`` ``TestServingRecovery``
and ``tests/test_paging.py``'s fault-injection cases) on the port's dense
and paged engines, at the reference tests' tiny configuration (vocabulary
61, hidden 32, 2 layers, 4 heads, 64 positions) with the reference's
weights carried across by ``convert``: greedy tokens after a recovery
equal the reference's sequential ``generate``, and the counters meet the
reference test's own assertions.

Then the condition ROADMAP A.4 sets for recovery: a kernel fault still
surfaces. The port's paged attention (``models.gpt.paged_pool_attention``)
and its dense decode attention (``parallel.sequence.cached_attention``)
are made to raise on every call after the N-th: every request ends with
an error and none retires with tokens, recoveries stay within the budget,
the scheduler ends failed, and every handle resolves. A fault that also
breaks the slot table's rebuild (the CPU model of a sticky CUDA error)
ends in one give-up: every handle an ``EngineFailedError`` caused by it.
Only the port's fault plan is ever armed; an autouse fixture resets it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bigdl_tpu.models.gpt import GPTForCausalLM as JaxGPT
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models import gpt as gpt_mod
from bigdl_tpu_torch.models.gpt import GPTForCausalLM
from bigdl_tpu_torch.parallel import sequence
from bigdl_tpu_torch.ops.paged_attention import paged_pool_attention
from bigdl_tpu_torch.resilience import faults
from bigdl_tpu_torch.serving import (EngineFailedError, PagePoolExhausted,
                                     ServingEngine, SlotManager)

CFG = dict(vocab_size=61, hidden_size=32, n_layers=2, n_heads=4,
           max_position=64)
PROMPTS = [[5, 9, 2, 17, 3], [1, 1, 4, 60, 8], [7, 3, 3],
           [9, 9, 9, 1, 0, 2, 4], [2, 4], [11, 12, 13, 14, 15, 16]]
N_NEW = 10
WAIT = 120.0
PATHS = {"dense": dict(max_slots=8),
         "paged": dict(max_slots=8, paged=True, page_size=8,
                       prefill_chunk=4)}


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


def _oracle(seed):
    jm = JaxGPT(**CFG)
    params, _ = jm.setup(jax.random.PRNGKey(seed), None)
    want = [np.asarray(jm.generate(params, jnp.asarray(p, jnp.int32)[None],
                                   N_NEW))[0] for p in PROMPTS]
    return convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          params)), want


@pytest.fixture(scope="module")
def ref0():
    """The reference's seed-0 weights (as a port state_dict) and its
    sequential greedy tokens for PROMPTS, N_NEW each."""
    return _oracle(0)


def _engine(sd, path, **kw):
    return ServingEngine(GPTForCausalLM(**CFG, device="cpu"), sd,
                         device="cpu", **{**PATHS[path], **kw})


def _check(outs, want, n_new=N_NEW):
    for got, w in zip(outs, want):
        np.testing.assert_array_equal(got, w[:len(got)])
        assert len(got) == len(w) - N_NEW + n_new


@pytest.mark.parametrize("path", PATHS)
def test_transient_step_fault_token_identical(ref0, path):
    sd, want = ref0
    faults.configure("serving.step:error:after=2:times=1")
    eng = _engine(sd, path)
    try:
        outs = [h.result(WAIT) for h in [eng.submit(p, N_NEW)
                                         for p in PROMPTS]]
    finally:
        eng.shutdown(drain=False)
    _check(outs, want)
    m = eng.metrics()
    assert m["recoveries"] >= 1 and m["failures"] >= 1
    assert eng.scheduler.failed is None          # the loop survived
    assert faults.active_plan().counts() == {("serving.step", "error"): 1}


@pytest.mark.parametrize("path", PATHS)
def test_poisoned_request_quarantined_alone(ref0, path):
    sd, want = ref0
    eng = _engine(sd, path)
    try:
        handles = [eng.submit(p, N_NEW) for p in PROMPTS]
        victim = handles[2]
        faults.configure(f"serving.step:error:req={victim.id}")
        with pytest.raises(faults.FaultError):
            victim.result(WAIT)
        for i, h in enumerate(handles):
            if h is not victim:
                np.testing.assert_array_equal(h.result(WAIT), want[i])
    finally:
        eng.shutdown(drain=False)
    assert eng.metrics()["quarantined"] == 1
    assert eng.scheduler.failed is None


@pytest.mark.parametrize("path", PATHS)
def test_admit_fault_recovers(ref0, path):
    sd, want = ref0
    faults.configure("serving.admit:error:times=1")
    eng = _engine(sd, path)
    try:
        outs = [h.result(WAIT) for h in [eng.submit(p, 8) for p in PROMPTS]]
    finally:
        eng.shutdown(drain=False)
    _check(outs, want, 8)
    m = eng.metrics()
    # dense: the batch falls back to one at a time; paged: the failed
    # admission is retried once. Nobody fails
    assert m["failures"] >= 1
    assert m["quarantined"] == 0 and m["retired"] == len(PROMPTS)


def test_paged_admit_fault_twice_quarantines_alone(ref0):
    """A paged admission failing its retry too is quarantined alone (the
    reference's outcome at the first failure)."""
    sd, want = ref0
    faults.configure("serving.admit:error:times=2")
    eng = _engine(sd, "paged")
    try:
        hs = [eng.submit(p, 8) for p in PROMPTS]
        with pytest.raises(faults.FaultError):
            hs[0].result(WAIT)
        outs = [h.result(WAIT) for h in hs[1:]]
    finally:
        eng.shutdown(drain=False)
    _check(outs, want[1:], 8)
    assert eng.metrics()["quarantined"] == 1


@pytest.mark.parametrize("path", PATHS)
def test_recovery_budget_exhaustion_fails_cleanly(ref0, path):
    sd, _ = ref0
    faults.configure("serving.step:error:times=1")
    eng = _engine(sd, path, max_recoveries=0)
    try:
        handles = [eng.submit(p, 6) for p in PROMPTS]
        for h in handles:
            with pytest.raises(EngineFailedError) as info:
                h.result(WAIT)
            assert isinstance(info.value.__cause__, faults.FaultError)
        assert eng.scheduler.failed is not None
        with pytest.raises(EngineFailedError):
            eng.submit([1, 2, 3], 4)
    finally:
        eng.shutdown(drain=False)


def test_page_alloc_fault_triggers_recovery_then_parity():
    """``test_paging.py``'s case: injected ``serving.page_alloc``
    exhaustion mid-workload; the preempt/requeue path absorbs it."""
    sd, want = _oracle(16)
    faults.configure("serving.page_alloc:error:after=3:times=2")
    eng = _engine(sd, "paged", max_slots=4, page_size=16, max_queue=32)
    try:
        outs = [h.result(WAIT) for h in [eng.submit(p, N_NEW)
                                         for p in PROMPTS[:4]]]
        met = eng.metrics()
    finally:
        eng.shutdown()
    _check(outs, want[:4])
    assert met["retired"] == 4
    assert faults.active_plan().counts() == {
        ("serving.page_alloc", "error"): 2}


def test_page_alloc_fault_on_lone_request_fails_typed(ref0):
    sd, _ = ref0
    eng = _engine(sd, "paged", max_slots=2, page_size=16)
    try:
        faults.configure("serving.page_alloc:error:times=1")
        h = eng.submit(PROMPTS[0], 4)
        with pytest.raises(PagePoolExhausted):
            h.result(WAIT)
        out = eng.result(eng.submit(PROMPTS[0], 4), timeout=WAIT)
    finally:
        eng.shutdown()
    assert out.size == len(PROMPTS[0]) + 4


def test_paged_transient_step_fault_recovers_token_identical():
    """``test_paging.py``'s case at its seed and engine: 3 prompts on 4
    slots, chunks of 4."""
    sd, want = _oracle(18)
    faults.configure("serving.step:error:after=2:times=1")
    eng = _engine(sd, "paged", max_slots=4, page_size=16, max_queue=32)
    try:
        outs = [h.result(WAIT) for h in [eng.submit(p, N_NEW)
                                         for p in PROMPTS[:3]]]
        met = eng.metrics()
    finally:
        eng.shutdown()
    _check(outs, want[:3])
    assert met["recoveries"] >= 1


@pytest.mark.parametrize("path", PATHS)
def test_spec_decode_step_fault_token_identical(ref0, path):
    """A step fault inside a speculative verify block: the recovery
    rebuilds the draft table with the slot table; greedy tokens stay the
    reference's."""
    sd, want = ref0
    faults.configure("serving.step:error:after=1:times=1")
    eng = _engine(sd, path, spec_tokens=4)
    try:
        outs = [h.result(WAIT) for h in [eng.submit(p, N_NEW)
                                         for p in PROMPTS]]
        met = eng.metrics()
    finally:
        eng.shutdown(drain=False)
    _check(outs, want)
    assert met["recoveries"] >= 1 and met["spec_proposed"] > 0


# ------------------------------------------------ a kernel fault surfaces
def _fault_after(monkeypatch, module, name, n):
    """``module.name`` raises on every call after the ``n``-th."""
    real = getattr(module, name)
    calls = {"n": 0}

    def failing(*a, **k):
        calls["n"] += 1
        if calls["n"] > n:
            raise RuntimeError("kernel fault: illegal memory access")
        return real(*a, **k)

    monkeypatch.setattr(module, name, failing)


KERNELS = {"dense": (sequence, "cached_attention"),
           "paged": (gpt_mod, "paged_pool_attention")}


@pytest.mark.parametrize("path", PATHS)
def test_persistent_kernel_fault_surfaces(ref0, path, monkeypatch):
    """Recovery must not hide a faulting kernel: from the 3rd call on
    every attention call raises. Each wave of requests is re-placed,
    probed, and quarantined with the kernel's error; past the budget the
    loop gives up. No request retires with tokens; every handle resolves."""
    sd, _ = ref0
    budget = 2
    eng = _engine(sd, path, max_recoveries=budget)
    _fault_after(monkeypatch, *KERNELS[path], 2)
    errors = []
    try:
        for wave in range(budget + 1):
            hs = [eng.submit(p, 6) for p in PROMPTS[2 * wave:2 * wave + 2]]
            for h in hs:
                with pytest.raises(RuntimeError) as info:
                    h.result(WAIT)
                errors.append(info.value)
                assert h.done.is_set()
        with pytest.raises(EngineFailedError):
            eng.submit(PROMPTS[0], 2)
    finally:
        eng.shutdown(drain=False)
    m = eng.metrics()
    assert m["retired"] == 0
    assert m["recoveries"] == budget + 1          # the last one gave up
    assert eng.scheduler.failed is not None
    assert all("kernel fault" in str(e) for e in errors)
    assert isinstance(errors[-1], EngineFailedError)


@pytest.mark.parametrize("path", PATHS)
def test_sticky_fault_gives_up_at_once(ref0, path, monkeypatch):
    """The CPU model of a sticky CUDA error: the kernel keeps raising and
    the slot table's rebuild raises too (a poisoned card refuses every
    allocation). No request is to blame, so the first recovery gives up:
    every handle an ``EngineFailedError`` caused by the fault, within one
    recovery, none retired."""
    sd, _ = ref0
    eng = _engine(sd, path)
    _fault_after(monkeypatch, *KERNELS[path], 2)
    real_alloc = type(eng.slots)._alloc

    def sticky_alloc(self):
        raise RuntimeError("kernel fault: CUDA error: device-side assert "
                           "triggered")

    try:
        hs = [eng.submit(p, 6) for p in PROMPTS]
        monkeypatch.setattr(type(eng.slots), "_alloc", sticky_alloc)
        for h in hs:
            with pytest.raises(EngineFailedError) as info:
                h.result(WAIT)
            assert "kernel fault" in str(info.value.__cause__)
    finally:
        monkeypatch.setattr(type(eng.slots), "_alloc", real_alloc)
        eng.shutdown(drain=False)
    m = eng.metrics()
    assert m["recoveries"] == 1 and m["retired"] == 0
    assert m["quarantined"] == 0
    assert eng.scheduler.failed is not None


def test_dense_slot_manager_reset_keeps_its_shape(ref0):
    """``reset`` discards every slot and reallocates the tables at the
    same shapes; ``poisoned`` marks a failed dispatch until then."""
    sd, _ = ref0
    m = GPTForCausalLM(**CFG, device="cpu")
    m.load_state_dict(sd)
    slots = SlotManager(m, max_slots=2)
    slots.admit([PROMPTS[0]])
    cache = slots._cache
    slots.poisoned = True
    slots.reset()
    assert not slots.poisoned and slots.free_slots() == 2
    assert not slots.active.any() and slots._cache is not cache
    assert [v.shape for v in slots._cache[0].values()] == \
        [v.shape for v in cache[0].values()]
