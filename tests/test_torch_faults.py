"""The port's fault-injection harness (``bigdl_tpu_torch/resilience/
faults.py``) against the reference's (``bigdl_tpu/resilience/faults.py``).

The reference's ``TestFaultPlan`` cases run in both packages: the same
specs parse to the same rules or fail alike, and the same call sequences
fire the same faults, with equal ``counts()``; a seeded ``p=`` rule draws
the same pattern; ``corrupt_file`` and ``mangle_planes`` change the same
bytes for the same seed. The reference side runs through plan objects
(``FaultPlan.parse`` / ``check`` / ``mangle``), so only the port's global
plan is ever armed, and an autouse fixture resets it. The ``preempt`` kind
flips the port's preemption guard with the reference's reason.
"""

import numpy as np
import pytest

from bigdl_tpu.resilience import faults as jfaults
from bigdl_tpu_torch.resilience import faults


@pytest.fixture(autouse=True)
def _clean_port_plan():
    faults.configure(None)
    yield
    faults.configure(None)


def _pattern(plan, site, calls, ctxs=None, error=None):
    """Which of ``calls`` calls of ``plan.check(site, ctx)`` raised."""
    fired = []
    for i in range(calls):
        try:
            plan.check(site, {} if ctxs is None else ctxs[i])
        except error:
            fired.append(i)
    return fired


def _rules(plan):
    return [(r.site, r.kind, r.delay, r.mode, r.p, r.after, r.every,
             r.times, r.req, r.signal, r.spec) for r in plan.rules]


@pytest.mark.parametrize("spec", [
    "seed=7; serving.step:error:times=2:after=1;train.drain:delay=0.5;"
    "ckpt.write:corrupt=empty",
    "ckpt.write:partial",
    "serving.step:error:req=42:every=3:p=0.25",
    "train.step:preempt:after=3:times=1:signal=1",
])
def test_parse_matches_reference(spec):
    port, ref = faults.FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)
    assert port.seed == ref.seed
    assert _rules(port) == _rules(ref)


@pytest.mark.parametrize("spec", [
    "serving.step",                       # no kind
    "serving.step:explode",               # unknown kind
    "serving.step:error:frobnicate=1",    # unknown modifier
    "serving.step:delay",                 # delay without duration
    "ckpt.write:corrupt=shred",           # unknown corrupt mode
    "serving.step:error:times=maybe",     # non-integer value
])
def test_parse_rejects_like_the_reference(spec):
    with pytest.raises(jfaults.FaultPlanError):
        jfaults.FaultPlan.parse(spec)
    with pytest.raises(faults.FaultPlanError):
        faults.FaultPlan.parse(spec)
    assert issubclass(faults.FaultPlanError, ValueError)


def test_counter_gates_fire_alike():
    spec = "s:error:after=2:every=3:times=2"
    ref = jfaults.FaultPlan.parse(spec)
    want = _pattern(ref, "s", 20, error=jfaults.FaultError)
    plan = faults.configure(spec)
    fired = []
    for i in range(20):
        try:
            faults.fault_point("s")
        except faults.FaultError:
            fired.append(i)
    assert fired == want == [2, 5]
    assert plan.counts() == ref.counts() == {("s", "error"): 2}


def test_req_scoped_rule_fires_alike():
    spec = "s:error:req=42"
    ctxs = [{"requests": (1, 2, 3)}, {"requests": (41, 42)}, {},
            {"request": 42}, {"request": 7}]
    ref = jfaults.FaultPlan.parse(spec)
    port = faults.FaultPlan.parse(spec)
    want = _pattern(ref, "s", 5, ctxs, jfaults.FaultError)
    assert _pattern(port, "s", 5, ctxs, faults.FaultError) == want == [1, 3]
    faults.configure(spec)
    faults.fault_point("s", requests=(1, 2, 3))        # no 42: no fire
    with pytest.raises(faults.FaultError):
        faults.fault_point("s", requests=(41, 42))
    faults.fault_point("s")                            # no ctx: no fire


@pytest.mark.parametrize("seed", [3, 4, 11])
def test_probability_draws_the_reference_pattern(seed):
    spec = f"seed={seed};s:error:p=0.5;s:delay=0.0:p=0.3;t:error:p=0.7"
    ref = jfaults.FaultPlan.parse(spec)
    port = faults.FaultPlan.parse(spec)
    for site in ("s", "t", "s"):
        want = _pattern(ref, site, 32, error=jfaults.FaultError)
        got = _pattern(port, site, 32, error=faults.FaultError)
        assert got == want and 0 < len(got) < 32
    assert port.counts() == ref.counts()


def test_probability_is_seeded():
    def pattern(seed):
        faults.configure(f"seed={seed};s:error:p=0.5")
        return _pattern(faults.active_plan(), "s", 32,
                        error=faults.FaultError)

    a, b, c = pattern(3), pattern(3), pattern(4)
    assert a == b and a != c and 0 < len(a) < 32


def test_disarmed_is_noop():
    faults.configure(None)
    assert not faults.enabled()
    faults.fault_point("serving.step")   # must not raise
    assert not faults.corrupt_file("ckpt.write", "/nonexistent")
    planes = [{"k": np.ones(4)}]
    assert faults.corrupt_planes("serving.adapter_load", planes) is planes


def test_preempt_kind_parses_and_names_a8():
    """Once a refusal naming ROADMAP A.8(c), the kind now flips the
    port's preemption guard as the reference's flips its own: the reason
    names the site, ``after``/``times`` gate it, and the reference's guard
    is left alone."""
    from bigdl_tpu.resilience import preempt as jpreempt
    from bigdl_tpu_torch.resilience import preempt
    preempt.clear()
    jpreempt.clear()
    try:
        plan = faults.configure("train.step:preempt:after=1:times=1")
        assert plan.rules[0].kind == "preempt"
        faults.fault_point("train.step")     # skipped by after=1
        assert not preempt.requested()
        faults.fault_point("train.step")
        assert preempt.requested()
        assert preempt.reason() == "injected at train.step"
        assert not jpreempt.requested()
        faults.fault_point("train.step")     # times=1: quiet again
        assert plan.counts() == {("train.step", "preempt"): 1}
        jfaults.configure("train.step:preempt:times=1")
        jfaults.fault_point("train.step")
        assert jpreempt.reason() == preempt.reason()
    finally:
        jfaults.configure(None)
        preempt.clear()
        jpreempt.clear()


def test_delay_kind_sleeps(monkeypatch):
    slept = []
    monkeypatch.setattr(faults.time, "sleep", slept.append)
    faults.configure("s:delay=0.25:times=2")
    for _ in range(3):
        faults.fault_point("s")
    assert slept == [0.25, 0.25]


@pytest.mark.parametrize("mode,check", [
    ("truncate", lambda before, after: 0 < after < before),
    ("garbage", lambda before, after: after == before),
    ("empty", lambda before, after: after == 0),
])
def test_corrupt_file_writes_the_reference_bytes(tmp_path, mode, check):
    payload = bytes(range(256)) * 64
    ours, theirs = tmp_path / "port.bin", tmp_path / "ref.bin"
    ours.write_bytes(payload)
    theirs.write_bytes(payload)
    spec = f"seed=5;ckpt.write:corrupt={mode}"
    faults.configure(spec)
    assert faults.corrupt_file("ckpt.write", str(ours))
    assert jfaults.FaultPlan.parse(spec).mangle("ckpt.write", str(theirs))
    after = ours.read_bytes()
    assert check(len(payload), len(after))
    assert after == theirs.read_bytes()
    if mode == "garbage":
        assert after != payload
    assert faults.active_plan().counts() == {("ckpt.write", "corrupt"): 1}


def test_mangle_planes_matches_reference():
    rng = np.random.default_rng(0)
    planes = [{"k": rng.standard_normal((4, 4, 8)).astype(np.float32),
               "v": rng.standard_normal((4, 4, 8)).astype(np.float32),
               "k_scale": rng.standard_normal((4, 4)).astype(np.float32)}
              for _ in range(3)]
    keep = [{k: v.copy() for k, v in pl.items()} for pl in planes]
    spec = "seed=9;serving.host_swap:corrupt:times=2"
    faults.configure(spec)
    got = faults.corrupt_planes("serving.host_swap", planes)
    want = jfaults.FaultPlan.parse(spec).mangle_planes("serving.host_swap",
                                                       planes)
    assert got is not planes
    for g, w, o in zip(got, want, keep):
        for k in o:
            np.testing.assert_array_equal(g[k], w[k])
    changed = sum(not np.array_equal(g[k], o[k])
                  for g, o in zip(got, keep) for k in o)
    assert 1 <= changed <= 2
    for p, o in zip(planes, keep):      # the originals are never touched
        for k in o:
            np.testing.assert_array_equal(p[k], o[k])


def test_env_flag_arms_lazily(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_FAULT_PLAN", "s:error:times=1")
    faults.reset()
    try:
        assert faults.enabled()
        with pytest.raises(faults.FaultError):
            faults.fault_point("s")
        faults.fault_point("s")
    finally:
        monkeypatch.delenv("BIGDL_TPU_FAULT_PLAN")
        faults.reset()
    assert not faults.enabled()


def test_configure_takes_a_plan_object():
    plan = faults.FaultPlan.parse("s:error:times=1")
    assert faults.configure(plan) is plan and faults.active_plan() is plan
    with pytest.raises(faults.FaultError, match="injected fault at s"):
        faults.fault_point("s")
