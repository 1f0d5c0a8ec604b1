"""The port's serving control plane (``bigdl_tpu_torch/serving/control.py``
and ``ServingEngine(policy=)``) against the reference's, on the CPU.

Units run op for op against the reference's classes with one injected
clock and the reference tests' stubs (``_Req``, ``_StubScheduler``,
``_StubFleet``): ``TokenBucket``, ``FairQueue``, ``ControlPolicy`` and
``AutoScaler`` must give the same decisions, pops, sheds, predictions and
scale steps; ``policy_from_flags`` reads the same flags into the same
policy.

The engines (2 layers, width 64, vocab 61, the same seeded weights through
``convert``) are held as the reference's ``TestPolicyEngine``,
``TestControlChaos`` and ``TestTenantIsolation`` hold the reference:
temperature-0 tokens under a policy equal the FIFO engine's and the
reference policy engine's; typed rate limits, down-tiering and shedding
at admission; under the ``serving.step:delay`` fault best-effort work is
shed before interactive work, and an expired deadline fails at dequeue
before any prefill; with adapters, one tenant's flood spends only its own
budget; under a supervisor a faulty engine with a policy resolves every
handle. Bursts are submitted under the scheduler's condition lock, so
each package admits the same batches.
"""

import time

import jax
import numpy as np
import pytest

from bigdl_tpu.models.gpt import GPTForCausalLM as JaxGPT
from bigdl_tpu.models.lora import init_adapter as jax_init_adapter
from bigdl_tpu.serving import ServingEngine as JaxEngine
from bigdl_tpu.serving import control as jcontrol
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models.gpt import GPTForCausalLM
from bigdl_tpu_torch.obs.metrics import MetricsRegistry
from bigdl_tpu_torch.resilience import faults
from bigdl_tpu_torch.resilience.supervisor import EngineSupervisor
from bigdl_tpu_torch.serving import (DeadlineExceededError, QueueFullError,
                                     ServingEngine, control)
from bigdl_tpu_torch.serving.control import (AdmissionRejectedError,
                                             ControlPolicy, RateLimitedError)

CFG = dict(vocab_size=61, hidden_size=64, n_layers=2, n_heads=4,
           max_position=64)
PROMPTS = [[5, 9, 2, 17, 3], [1, 1, 4, 60, 8], [7, 3, 3],
           [9, 9, 9, 1, 0, 2, 4], [2, 4], [11, 12, 13, 14, 15, 16]]
WAIT = 120.0


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.configure(None)
    yield
    faults.configure(None)


class _Req:
    """Queue-shaped stand-in: the attributes a FairQueue keys on."""
    _n = iter(range(10 ** 9))

    def __init__(self, priority="standard", client_id=None):
        self.priority = priority
        self.client_id = client_id
        self.id = next(_Req._n)
        self.deadline = None


# ------------------------------------------------------- op-for-op units --

def test_constants_and_error_types_match_the_reference():
    assert control.PRIORITIES == jcontrol.PRIORITIES
    assert control.PRIORITY_WEIGHTS == jcontrol.PRIORITY_WEIGHTS
    assert issubclass(RateLimitedError, AdmissionRejectedError)
    assert issubclass(AdmissionRejectedError, QueueFullError)
    for mod in (control, jcontrol):
        with pytest.raises(ValueError):
            mod.TokenBucket(rate=0, burst=1)
        with pytest.raises(ValueError):
            mod.TokenBucket(rate=1, burst=-1)


@pytest.mark.parametrize("seed", [0, 1])
def test_token_bucket_op_for_op(seed):
    rng = np.random.default_rng(seed)
    t = [0.0]
    clock = lambda: t[0]                                   # noqa: E731
    a = control.TokenBucket(rate=2.0, burst=3.0, clock=clock)
    b = jcontrol.TokenBucket(rate=2.0, burst=3.0, clock=clock)
    got = []
    for _ in range(300):
        t[0] += float(rng.exponential(0.3))
        n = float(rng.choice([0.5, 1.0, 2.0]))
        got.append((a.allow(n), b.allow(n)))
    assert all(x == y for x, y in got)
    assert {x for x, _ in got} == {True, False}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fair_queue_op_for_op(seed):
    """A seeded mix of every operation on both queues, over the same
    request objects: identical pops, sheds, lengths and iteration."""
    rng = np.random.default_rng(seed)
    qa, qb = control.FairQueue(), jcontrol.FairQueue()
    held = []
    for _ in range(600):
        op = rng.choice(["append"] * 5 + ["appendleft", "popleft",
                                          "popleft", "remove",
                                          "pop_priority", "shed_lower"])
        if op == "append":
            r = _Req(str(rng.choice(control.PRIORITIES)),
                     f"c{int(rng.integers(4))}")
            qa.append(r)
            qb.append(r)
            held.append(r)
        elif op == "appendleft":
            r = _Req(str(rng.choice(control.PRIORITIES)), "front")
            qa.appendleft(r)
            qb.appendleft(r)
            held.append(r)
        elif op == "popleft":
            if not qb:
                with pytest.raises(IndexError):
                    qa.popleft()
                continue
            assert qa.popleft() is qb.popleft()
        elif op == "remove" and held:
            r = held[int(rng.integers(len(held)))]
            errs = []
            for q in (qa, qb):
                try:
                    q.remove(r)
                    errs.append(None)
                except ValueError:
                    errs.append("ValueError")
            assert errs[0] == errs[1]
        elif op == "pop_priority":
            p = str(rng.choice(control.PRIORITIES))
            assert qa.pop_priority(p) is qb.pop_priority(p)
        elif op == "shed_lower":
            p = str(rng.choice(control.PRIORITIES))
            assert qa.shed_lower(p) is qb.shed_lower(p)
        assert len(qa) == len(qb) and bool(qa) == bool(qb)
        assert [r.id for r in qa] == [r.id for r in qb]
    qa.clear()
    assert len(qa) == 0 and not qa


class _StubSlots:
    def __init__(self, max_slots=4, occ=0):
        self.max_slots = max_slots
        self._occ = occ

    def occupancy(self):
        return self._occ


class _StubScheduler:
    """The surface predict_ttft touches (the reference test's stub) with
    a live TTFT histogram child of its own package."""

    def __init__(self, hist, label="stub", max_slots=4):
        self.obs_label = label
        self._obs = {"ttft": hist}
        self.slots = _StubSlots(max_slots)
        self._waiting = []
        self._avg = None

    def ttft_avg(self):
        return self._avg


def test_control_policy_op_for_op():
    """One injected clock; the same TTFT observations, queue depths and
    occupancies on both sides: equal predictions, budgets and rate
    decisions at every step (the EMA, its decay and the cold start)."""
    from bigdl_tpu.obs.metrics import MetricsRegistry as JaxRegistry
    rng = np.random.default_rng(5)
    t = [0.0]
    clock = lambda: t[0]                                   # noqa: E731
    pols = [mod.ControlPolicy(base_ttft_s=0.05, rate_limit_rps=3.0,
                              rate_limit_burst=2, clock=clock)
            for mod in (control, jcontrol)]
    hists = [reg.histogram("ttft", labels=("engine",),
                           buckets=(0.01, 0.1, 1.0)).labels("e")
             for reg in (MetricsRegistry(), JaxRegistry())]
    schs = [_StubScheduler(h) for h in hists]
    for step in range(400):
        t[0] += float(rng.exponential(0.2))
        if rng.random() < 0.3:
            v = float(rng.exponential(0.3))
            for h in hists:
                h.observe(v)
        depth, occ = int(rng.integers(10)), int(rng.integers(5))
        avg = None if step < 5 else float(rng.exponential(0.1))
        for s in schs:
            s._waiting = [None] * depth
            s.slots._occ = occ
            s._avg = avg
        preds = [p.predict_ttft(s) for p, s in zip(pols, schs)]
        assert preds[0] == preds[1]
        r = _Req(str(rng.choice(control.PRIORITIES)), f"c{step % 3}")
        if rng.random() < 0.5:
            r.deadline = t[0] + float(rng.uniform(-1, 2))
        assert pols[0].budget_s(r, now=t[0]) == pols[1].budget_s(r, now=t[0])
        assert pols[0].check_rate(r.client_id) == pols[1].check_rate(
            r.client_id)
    assert pols[0].slo_ttft_s == pols[1].slo_ttft_s
    assert pols[0].reserved_slots == pols[1].reserved_slots == 1


class _StubFleet:
    def __init__(self):
        self.n = 1
        self.current = {"queue_depth": 0.0, "occupancy": 0.0}

    def replica_count(self):
        return self.n

    def load(self):
        return dict(self.current)

    def scale_to(self, n):
        self.n = n


@pytest.mark.parametrize("seed", [0, 1])
def test_autoscaler_op_for_op(seed, tmp_path, monkeypatch):
    """A seeded load trace (queue depth, occupancy, page occupancy and a
    growing TTFT sum that now and then spikes the anomaly detector) on
    both scalers, one injected clock: the same action every poll."""
    monkeypatch.setenv("BIGDL_TPU_FLIGHT_DIR", str(tmp_path))
    rng = np.random.default_rng(seed)
    t = [0.0]
    fleets = [_StubFleet(), _StubFleet()]
    scalers = [mod.AutoScaler(f, min_replicas=1, max_replicas=4,
                              votes_to_scale=2, idle_polls_to_retire=3,
                              cooldown_s=5.0, obs_label=f"t{seed}-{i}",
                              clock=lambda: t[0])
               for i, (mod, f) in enumerate(zip((control, jcontrol),
                                                fleets))]
    ttft_sum, ttft_n = 0.0, 0
    acts = []
    for _ in range(300):
        t[0] += float(rng.uniform(0.5, 2.0))
        k = int(rng.integers(3))
        load = ({"queue_depth": 12.0, "occupancy": 0.95} if k == 0 else
                {"queue_depth": 0.0, "occupancy": 0.0} if k == 1 else
                {"queue_depth": float(rng.integers(4)),
                 "occupancy": float(rng.uniform(0, 0.8)),
                 "page_occupancy": float(rng.uniform(0, 1))})
        done = int(rng.integers(3))
        ttft_n += done
        ttft_sum += done * (0.05 if rng.random() < 0.95 else 2.0)
        load.update(ttft_sum=ttft_sum, ttft_count=ttft_n)
        for f in fleets:
            f.current = load
        acts.append([s.step() for s in scalers])
    assert all(a == b for a, b in acts)
    assert fleets[0].n == fleets[1].n
    assert (scalers[0].scale_ups, scalers[0].scale_downs) == \
        (scalers[1].scale_ups, scalers[1].scale_downs)
    assert scalers[0].scale_ups > 0 and scalers[0].scale_downs > 0
    assert scalers[0]._obs["replicas"].value == fleets[0].n
    assert scalers[0]._obs["scale_ups"].value == scalers[0].scale_ups
    with pytest.raises(ValueError):
        control.AutoScaler(_StubFleet(), min_replicas=3, max_replicas=2)


def test_autoscaler_thread_lifecycle():
    fleet = _StubFleet()
    sc = control.AutoScaler(fleet, poll_interval_s=0.01, obs_label="thr")
    sc.start()
    fleet.current = {"queue_depth": 12.0, "occupancy": 0.95}
    deadline = time.monotonic() + 5.0
    while fleet.n < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    sc.stop()
    assert fleet.n == 2 and sc._thread is None


def test_policy_from_flags_matches_the_reference(monkeypatch):
    for k in ("BIGDL_TPU_ADMISSION_SLO", "BIGDL_TPU_RATE_LIMIT_RPS",
              "BIGDL_TPU_RATE_LIMIT_BURST"):
        monkeypatch.delenv(k, raising=False)
    assert control.policy_from_flags() is None
    assert jcontrol.policy_from_flags() is None
    monkeypatch.setenv("BIGDL_TPU_ADMISSION_SLO", "yes")
    monkeypatch.setenv("BIGDL_TPU_TTFT_SLO_INTERACTIVE_S", "0.25")
    monkeypatch.setenv("BIGDL_TPU_TTFT_SLO_STANDARD_S", "3")
    monkeypatch.setenv("BIGDL_TPU_RATE_LIMIT_RPS", "8")
    a, b = control.policy_from_flags(), jcontrol.policy_from_flags()
    assert isinstance(a, ControlPolicy)
    for attr in ("slo_ttft_s", "rate_limit_rps", "rate_limit_burst",
                 "base_ttft_s", "reserved_slots"):
        assert getattr(a, attr) == getattr(b, attr), attr
    assert a.slo_ttft_s == {"interactive": 0.25, "standard": 3.0,
                            "best_effort": None}
    assert a.rate_limit_burst == 16.0


# --------------------------------------------------------------- engines --

@pytest.fixture(scope="module")
def pair():
    jm = JaxGPT(**CFG)
    params, _ = jm.setup(jax.random.PRNGKey(2), None)
    sd = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return jm, params, sd


def _port(sd, **kw):
    return ServingEngine(GPTForCausalLM(**CFG, device="cpu"), sd,
                         device="cpu", **kw)


def _burst(eng, specs, n_new):
    """Submit every (prompt, priority, client, adapter) while the loop
    waits on its lock, so the first admission sees the whole burst."""
    with eng.scheduler._cond:
        return [eng.submit(p, n_new, priority=pr, client_id=c, adapter=a)
                for p, pr, c, a in specs]


MIXED = [(p, "interactive" if i % 2 else "best_effort", f"c{i % 3}", None)
         for i, p in enumerate(PROMPTS)]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_temp0_tokens_under_policy_equal_fifo_and_reference(pair, paged):
    jm, params, sd = pair
    kw = dict(max_slots=4, paged=paged, page_size=8, prefill_chunk=8)
    outs = {}
    for name, make in (
            ("fifo", lambda: _port(sd, **kw)),
            ("port", lambda: _port(sd, policy=ControlPolicy(base_ttft_s=0.01),
                                   **kw)),
            ("ref", lambda: JaxEngine(jm, params, policy=jcontrol.ControlPolicy(
                base_ttft_s=0.01), **kw))):
        with make() as eng:
            outs[name] = [np.asarray(h.result(WAIT))
                          for h in _burst(eng, MIXED, 8)]
            if name != "fifo":
                assert eng.policy is not None
                assert eng.metrics()["shed"] == 0
    for a, b, c in zip(outs["fifo"], outs["port"], outs["ref"]):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(b, c)


def test_rate_limit_downtier_and_shed_at_admission(pair):
    """Each case in both packages: the same typed errors and counters."""
    jm, params, sd = pair
    for mk, mod in ((lambda **k: _port(sd, max_slots=2, **k), control),
                    (lambda **k: JaxEngine(jm, params, max_slots=2, **k),
                     jcontrol)):
        with mk(policy=mod.ControlPolicy(rate_limit_rps=1e-6,
                                         rate_limit_burst=2)) as eng:
            eng.submit(PROMPTS[0], 2, client_id="hog")
            eng.submit(PROMPTS[1], 2, client_id="hog")
            with pytest.raises(mod.RateLimitedError):
                eng.submit(PROMPTS[2], 2, client_id="hog")
            eng.submit(PROMPTS[2], 2, client_id="polite").result(WAIT)
            assert eng.scheduler.rate_limited == 1
            assert eng.metrics()["rate_limited"] == 1
        with mk(policy=mod.ControlPolicy(slo_ttft_s={"standard": 1e-9},
                                         base_ttft_s=0.5)) as eng:
            h = eng.submit(PROMPTS[0], 2, priority="standard")
            assert h.priority == "best_effort"
            assert eng.scheduler.downtiered == 1
            h.result(WAIT)
        with mk(policy=mod.ControlPolicy(slo_ttft_s={"best_effort": 1e-9},
                                         base_ttft_s=0.5)) as eng:
            with pytest.raises(mod.AdmissionRejectedError):
                eng.submit(PROMPTS[0], 2, priority="best_effort")
            m = eng.metrics()
            assert eng.scheduler.shed == m["shed"] == 1
            assert m["rejected"] == 1


def test_overload_sheds_best_effort_before_interactive(pair):
    """The overload contract, on the port: with slots and queue full of
    best-effort work under a slowed step, every interactive submit is
    admitted (a queued best-effort victim is shed, typed, before any
    prefill), completes, and nothing hangs."""
    _, _, sd = pair
    with _port(sd, max_slots=2, max_queue=4,
               policy=ControlPolicy(base_ttft_s=0.01)) as eng:
        eng.generate(PROMPTS[0], 2, timeout=WAIT)
        faults.configure("serving.step:delay=0.05")
        be = []
        try:
            for i in range(16):
                be.append(eng.submit(PROMPTS[i % len(PROMPTS)], 8,
                                     priority="best_effort",
                                     client_id=f"b{i}"))
        except QueueFullError:
            pass
        inter = [eng.submit(PROMPTS[k], 4, priority="interactive",
                            client_id="human") for k in range(3)]
        faults.configure(None)
        for h in inter:
            h.result(WAIT)
            assert h.error is None
        shed = [r for r in be if isinstance(r.error, AdmissionRejectedError)]
        assert len(shed) >= 3 and eng.scheduler.shed >= 3
        assert all(r.first_token_at is None for r in shed)
        for r in be:
            if r not in shed:
                r.result(WAIT)
        text = __import__("bigdl_tpu_torch").obs.default_registry() \
            .prometheus_text()
        want = (f'bigdl_serving_shed_total{{engine="{eng.obs_label}",'
                f'priority="best_effort"}} {eng.scheduler.shed}')
        assert want in text


def test_expired_deadline_fails_at_dequeue_before_prefill(pair):
    _, _, sd = pair
    with _port(sd, max_slots=2, max_queue=8,
               policy=ControlPolicy(base_ttft_s=0.01)) as eng:
        eng.generate(PROMPTS[0], 2, timeout=WAIT)
        sch = eng.scheduler
        before = sch.deadline_expired
        faults.configure("serving.step:delay=0.05")
        long = [eng.submit(p, 16, priority="interactive")
                for p in PROMPTS[:2]]
        spin = time.monotonic() + WAIT
        while (any(h.first_token_at is None for h in long)
               and time.monotonic() < spin):
            time.sleep(0.005)
        doomed = eng.submit(PROMPTS[2], 4, deadline_s=0.05,
                            priority="interactive")
        with pytest.raises(DeadlineExceededError):
            doomed.result(WAIT)
        faults.configure(None)
        assert doomed.first_token_at is None and doomed.tokens == []
        assert sch.deadline_expired >= before + 1
        assert eng.metrics()["deadline_exceeded"] >= before + 1
        for h in long:
            h.result(WAIT)


@pytest.fixture(scope="module")
def adapters(pair):
    _, params, _ = pair
    jads = {f"t{i}": jax_init_adapter(jax.random.PRNGKey(100 + i), params,
                                      4, b_std=0.5) for i in range(3)}
    ads = {k: convert.adapter_from_jax(jax.tree_util.tree_map(np.asarray, v))
           for k, v in jads.items()}
    return jads, ads


def _lora(make, ads, policy):
    return make(lora=True, lora_rank=4, adapter_slots=2, adapters=ads,
                policy=policy, max_slots=3, max_queue=16)


def test_rate_bucket_isolates_adapter_flood(pair, adapters):
    """Tenant A spends its rate budget on cold-adapter best-effort
    submits; tenant B's interactive streams (base and adapter) are
    admitted and decode the reference engine's tokens."""
    jm, params, sd = pair
    jads, ads = adapters
    outs = []
    for make, mod, a in ((lambda **k: _port(sd, **k), control, ads),
                         (lambda **k: JaxEngine(jm, params, **k), jcontrol,
                          jads)):
        pol = mod.ControlPolicy(rate_limit_rps=1e-6, rate_limit_burst=2)
        with _lora(make, a, pol) as eng:
            flood = [eng.submit(PROMPTS[i], 4, priority="best_effort",
                                client_id="tenantA", adapter=f"t{i}")
                     for i in range(2)]
            with pytest.raises(mod.RateLimitedError):
                eng.submit(PROMPTS[2], 4, priority="best_effort",
                           client_id="tenantA", adapter="t2")
            assert eng.scheduler.rate_limited == 1
            hb = [eng.submit(PROMPTS[3], 6, priority="interactive",
                             client_id="tenantB"),
                  eng.submit(PROMPTS[4], 6, priority="interactive",
                             client_id="tenantB", adapter="t0")]
            outs.append([np.asarray(h.result(WAIT)) for h in hb])
            for h in flood:
                h.result(WAIT)
            assert eng.adapter_pool.stats()["referenced"] == 0
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_slo_shed_walls_off_adapter_churn(pair, adapters):
    jm, params, sd = pair
    jads, ads = adapters
    outs = []
    for make, mod, a in ((lambda **k: _port(sd, **k), control, ads),
                         (lambda **k: JaxEngine(jm, params, **k), jcontrol,
                          jads)):
        pol = mod.ControlPolicy(slo_ttft_s={"best_effort": 1e-9},
                                base_ttft_s=0.5)
        with _lora(make, a, pol) as eng:
            loads0 = eng.adapter_pool.loads
            for i in range(8):
                with pytest.raises(mod.AdmissionRejectedError):
                    eng.submit(PROMPTS[i % len(PROMPTS)], 4,
                               priority="best_effort", client_id="tenantA",
                               adapter=f"t{i % 3}")
            assert eng.scheduler.shed == 8
            assert eng.adapter_pool.loads == loads0   # no budget spent
            h = eng.submit(PROMPTS[0], 8, priority="interactive",
                           client_id="tenantB", adapter="t1")
            outs.append(np.asarray(h.result(WAIT)))
            assert eng.adapter_pool.stats()["referenced"] == 0
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("seed", [3, 11])
def test_supervised_policy_engine_under_faults_resolves_every_handle(pair,
                                                                     seed):
    """The reference's control-plane chaos leg, seeded and short: a
    mixed-priority overload through the policy while the engine fails
    steps under its supervisor (``max_recoveries=0``: every failure is a
    restart). Every handle resolves, to tokens or a typed error."""
    _, _, sd = pair
    rng = np.random.default_rng(seed)

    def factory():
        return _port(sd, max_slots=4, max_queue=8, max_recoveries=0,
                     policy=ControlPolicy(base_ttft_s=0.01,
                                          rate_limit_rps=200.0))

    sup = EngineSupervisor(factory, poll_interval_s=0.02,
                           backoff_base_s=0.01, backoff_max_s=0.05,
                           max_restarts=50)
    try:
        sup.generate(PROMPTS[0], 2, timeout=WAIT)
        faults.configure(f"seed={seed};serving.step:error:p=0.05;"
                         "serving.step:delay=0.02:p=0.1")
        done = failed = 0
        for _ in range(1):
            handles = []
            for i in range(12):
                pr = "interactive" if i % 4 == 0 else "best_effort"
                try:
                    handles.append(sup.submit(
                        PROMPTS[int(rng.integers(len(PROMPTS)))], 8,
                        priority=pr, client_id=f"c{i % 3}"))
                except QueueFullError:
                    pass
            for h in handles:
                try:
                    h.result(WAIT)
                    done += 1
                except TimeoutError:
                    pytest.fail(f"hung request (seed={seed})")
                except Exception:        # noqa: BLE001 - a clean failure
                    failed += 1
        assert done > 0
        m = sup.metrics()
        assert "shed" in m and m["supervisor_state"] in (0, 1)
    finally:
        faults.configure(None)
        sup.close(drain=False)
