"""The reference's ``submit`` keywords and recovery budget in the port's
``ServingEngine``, against the JAX reference's engine on the CPU, on the
same seeded weights (``convert``):

- ``priority``/``client_id``/``trace`` are carried and the request serves
  the reference's greedy tokens; an unknown priority raises
  ``ValueError`` in both;
- a request naming an adapter fails with ``AdapterLoadError`` (the
  reference's message, the pool being off in both), while the ``submit``
  call itself returns;
- ``BIGDL_TPU_ADMISSION_SLO`` attaches the control policy in both
  packages (the port's ``serving.control.ControlPolicy``, with the flags'
  SLOs), and the port serves the reference's tokens under it;
- ``max_recoveries=0`` serves, and a failing dispatch then fails every
  request with the reference's ``EngineFailedError``, caused by the
  dispatch's error; ``failover`` receives the victims instead, in both;
  at a budget of 1 or more a transient dispatch error is recovered in
  place, with the reference's tokens.
"""

import jax
import numpy as np
import pytest

from bigdl_tpu.models.gpt import GPTForCausalLM as JaxGPT
from bigdl_tpu.serving import ServingEngine as JaxEngine
from bigdl_tpu.serving.adapters import AdapterLoadError as JaxAdapterLoadError
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models.gpt import GPTForCausalLM
from bigdl_tpu_torch.serving import (AdapterLoadError, EngineFailedError,
                                     ServingEngine, SlotManager)

CFG = dict(vocab_size=61, hidden_size=32, n_layers=2, n_heads=4,
           max_position=64)
PROMPTS = [[5, 9, 2, 17, 3], [1, 1, 4, 60, 8], [7, 3, 3]]
WAIT = 120.0


@pytest.fixture(scope="module")
def pair():
    jm = JaxGPT(**CFG)
    params, _ = jm.setup(jax.random.PRNGKey(3), None)
    return jm, params, convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params))


def _engines(pair, **kw):
    jm, params, sd = pair
    return (JaxEngine(jm, params, max_slots=2, **kw),
            ServingEngine(GPTForCausalLM(**CFG, device="cpu"), sd,
                          device="cpu", max_slots=2, **kw))


@pytest.mark.parametrize("priority", ["interactive", "standard",
                                      "best_effort"])
def test_submit_carries_priority_client_and_trace(pair, priority):
    jeng, eng = _engines(pair)
    try:
        outs = []
        for e in (jeng, eng):
            h = e.submit(PROMPTS[0], 6, priority=priority, client_id="c-7",
                         trace="trace-1")
            outs.append(np.asarray(h.result(timeout=WAIT)))
            assert (h.priority, h.client_id, h.trace) == \
                (priority, "c-7", "trace-1")
        np.testing.assert_array_equal(outs[1], outs[0])
        got = eng.generate(PROMPTS[1], 4, timeout=WAIT, priority=priority,
                           client_id=None)
        want = jeng.generate(PROMPTS[1], 4, timeout=WAIT, priority=priority,
                             client_id=None)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    finally:
        jeng.shutdown()
        eng.shutdown()


def test_unknown_priority_raises_in_both(pair):
    jeng, eng = _engines(pair)
    try:
        for e in (jeng, eng):
            with pytest.raises(ValueError, match="unknown priority"):
                e.submit(PROMPTS[0], 2, priority="urgent")
    finally:
        jeng.shutdown()
        eng.shutdown()


def test_adapter_request_fails_with_adapter_load_error(pair):
    jeng, eng = _engines(pair)
    try:
        for e, err in ((jeng, JaxAdapterLoadError), (eng, AdapterLoadError)):
            bad = e.submit(PROMPTS[0], 3, adapter="tenant-a")   # no raise
            ok = e.submit(PROMPTS[1], 3)
            with pytest.raises(err, match=r"names adapter 'tenant-a' but the "
                               r"engine has no adapter pool"):
                bad.result(timeout=WAIT)
            assert np.asarray(ok.result(timeout=WAIT)).size == 5 + 3
            assert e.metrics()["rejected"] == 1
        assert AdapterLoadError.__name__ == JaxAdapterLoadError.__name__
    finally:
        jeng.shutdown()
        eng.shutdown()


def test_admission_slo_flag_attaches_a_policy_and_the_port_refuses(
        pair, monkeypatch):
    """Once a refusal (A.8), now the port's policy: the flag attaches one
    in both packages, with the flags' SLOs, and both serve the same
    tokens under it; with the flag at 0 neither attaches one."""
    from bigdl_tpu_torch.serving.control import ControlPolicy
    jm, params, sd = pair
    monkeypatch.setenv("BIGDL_TPU_ADMISSION_SLO", "1")
    monkeypatch.setenv("BIGDL_TPU_TTFT_SLO_INTERACTIVE_S", "2.5")
    jeng, eng = _engines(pair)
    try:
        assert jeng.policy is not None
        assert isinstance(eng.policy, ControlPolicy)
        assert eng.policy.slo_ttft_s == jeng.policy.slo_ttft_s
        assert eng.policy.slo_ttft_s["interactive"] == 2.5
        outs = [np.asarray(e.generate(PROMPTS[2], 4, timeout=WAIT,
                                      priority="interactive"))
                for e in (jeng, eng)]
        np.testing.assert_array_equal(outs[1], outs[0])
        assert "shed" in eng.metrics()
    finally:
        jeng.shutdown()
        eng.shutdown()
    monkeypatch.setenv("BIGDL_TPU_ADMISSION_SLO", "0")
    with ServingEngine(GPTForCausalLM(**CFG, device="cpu"), sd, device="cpu",
                       max_slots=2) as eng:
        assert eng.policy is None
        assert eng.generate(PROMPTS[2], 2, timeout=WAIT).size == 3 + 2


def _fail_third_step(obj, attr, monkeypatch, real):
    calls = {"n": 0}

    def failing(*a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected dispatch fault")
        return real(*a, **k)

    monkeypatch.setattr(obj, attr, failing)


def test_zero_recovery_budget_serves_then_gives_up_like_the_reference(
        pair, monkeypatch):
    jeng, eng = _engines(pair, max_recoveries=0)
    try:
        for e in (jeng, eng):
            assert np.asarray(e.generate(PROMPTS[0], 3,
                                         timeout=WAIT)).size == 5 + 3
        _fail_third_step(jeng.slots, "step", monkeypatch, jeng.slots.step)
        _fail_third_step(SlotManager, "_step", monkeypatch,
                         SlotManager._step)
        errors = []
        for e in (jeng, eng):
            # The burst is admitted together: outside the lock the scheduler
            # could run the failing step before the second ``submit``.
            with e.scheduler._cond:
                hs = [e.submit(p, 20) for p in PROMPTS[:2]]
            for h in hs:
                with pytest.raises(RuntimeError) as info:
                    h.result(timeout=WAIT)
                errors.append(info.value)
            with pytest.raises(RuntimeError, match="engine failed"):
                e.submit(PROMPTS[0], 2)
        assert len(errors) == 4
        for err in errors:
            assert type(err).__name__ == "EngineFailedError"
            assert "injected dispatch fault" in str(err)
            assert str(err.__cause__) == "injected dispatch fault"
        assert all(isinstance(err, EngineFailedError) for err in errors[2:])
    finally:
        jeng.shutdown(drain=False)
        eng.shutdown(drain=False)


def test_reference_failover_runs_at_budget_zero(pair, monkeypatch):
    """The reference hands the victims to ``failover`` even at a budget of
    0, and so does the port: the request is handed over unfinished."""
    jm, params, sd = pair
    results = []
    for make, obj, attr in (
            (lambda fo: JaxEngine(jm, params, max_slots=2, max_recoveries=0,
                                  failover=fo), None, "step"),
            (lambda fo: ServingEngine(GPTForCausalLM(**CFG, device="cpu"),
                                      sd, device="cpu", max_slots=2,
                                      max_recoveries=0, failover=fo),
             SlotManager, "_step")):
        got = []
        eng = make(lambda victims, error: got.append(
            (len(victims), str(error), victims[0].done.is_set())))
        try:
            target = eng.slots if obj is None else obj
            _fail_third_step(target, attr, monkeypatch,
                             getattr(target, attr))
            eng.submit(PROMPTS[0], 20)
            for _ in range(400):
                if got:
                    break
                eng.scheduler._thread.join(0.05)
            results.append(got)
        finally:
            eng.shutdown(drain=False)
            monkeypatch.undo()
    assert results == [[(1, "injected dispatch fault", False)]] * 2


@pytest.mark.parametrize("budget", [1, 8])
def test_positive_recovery_budget_is_refused(pair, budget, monkeypatch):
    """A budget of 1 or more, once refused, now recovers a transient
    dispatch error in place in both engines: the reference's tokens, one
    recovery each."""
    jeng, eng = _engines(pair, max_recoveries=budget)
    try:
        _fail_third_step(jeng.slots, "step", monkeypatch, jeng.slots.step)
        _fail_third_step(SlotManager, "_step", monkeypatch,
                         SlotManager._step)
        outs = []
        for e in (jeng, eng):
            hs = [e.submit(p, 12) for p in PROMPTS[:2]]
            outs.append([np.asarray(h.result(timeout=WAIT)) for h in hs])
        for g, w in zip(outs[1], outs[0]):
            np.testing.assert_array_equal(g, w)
        assert jeng.scheduler.recoveries == 1
        assert eng.metrics()["recoveries"] == 1
        assert eng.metrics()["failures"] == 1
    finally:
        jeng.shutdown(drain=False)
        eng.shutdown(drain=False)
