"""The port's serving telemetry against the reference's after the same
seeded run, on the CPU (2 layers, width 64, vocab 61, the same weights and
adapters through ``convert``).

One run goes through both packages' engines: paged, speculative (gamma
4), with the host tier, the snapshot store, two LoRA adapters and a
control policy; two waves of four greedy requests (two share a prefix; the
second wave repeats the first, so the prefix cache hits), each submitted
while the scheduler waits on its lock. Then, read from each package's
default registry, family by family for this engine's series only:

- the same family names and label names (the reference's
  ``bigdl_decode_traces``, compile counts, has no port counterpart);
- equal deterministic counters (admitted, retired, generated tokens,
  prefix hits, speculative proposals and acceptances);
- a request's trace events in the same order;
- ``engine.metrics()`` with every key of the reference's, obs on and off.

The port's span track, TTFT exemplars, health probe and the supervisor's
and fault harness's instruments are checked on the port alone.
"""

import os

import jax
import numpy as np
import pytest

from bigdl_tpu import obs as jobs
from bigdl_tpu.models.gpt import GPTForCausalLM as JaxGPT
from bigdl_tpu.models.lora import init_adapter as jax_init_adapter
from bigdl_tpu.serving import ServingEngine as JaxEngine
from bigdl_tpu.serving import control as jcontrol
from bigdl_tpu_torch import convert, obs
from bigdl_tpu_torch.models.gpt import GPTForCausalLM
from bigdl_tpu_torch.resilience import faults
from bigdl_tpu_torch.resilience.supervisor import EngineSupervisor
from bigdl_tpu_torch.serving import ServingEngine
from bigdl_tpu_torch.serving.control import ControlPolicy

CFG = dict(vocab_size=61, hidden_size=64, n_layers=2, n_heads=4,
           max_position=64)
WAIT = 120.0
N_NEW = 8
# families of the reference with no counterpart in the port
REFERENCE_ONLY = {"bigdl_decode_traces"}
UNLABELLED = ("bigdl_adapter_", "bigdl_snapshot_")
DETERMINISTIC = ("bigdl_serving_admitted_total", "bigdl_serving_retired_total",
                 "bigdl_serving_generated_tokens_total",
                 "bigdl_serving_prefix_cache_hits_total",
                 "bigdl_serving_prefix_hit_tokens_total",
                 "bigdl_serving_spec_proposed_total",
                 "bigdl_serving_spec_accepted_total")


def _prompts():
    rng = np.random.default_rng(4)
    prefix = rng.integers(0, 61, 17)
    return [np.concatenate([prefix, rng.integers(0, 61, 3)]),
            rng.integers(0, 61, 6),
            np.concatenate([prefix, rng.integers(0, 61, 5)]),
            rng.integers(0, 61, 9)]


ADAPTERS = [None, "t0", None, "t1"]
NO_SLO = {"interactive": None, "standard": None}


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.configure(None)
    yield
    faults.configure(None)


@pytest.fixture(scope="module")
def pair():
    jm = JaxGPT(**CFG)
    params, _ = jm.setup(jax.random.PRNGKey(5), None)
    sd = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    jads = {f"t{i}": jax_init_adapter(jax.random.PRNGKey(200 + i), params,
                                      4, b_std=0.5) for i in range(2)}
    ads = {k: convert.adapter_from_jax(jax.tree_util.tree_map(np.asarray, v))
           for k, v in jads.items()}
    return jm, params, sd, jads, ads


def _options(tmp, name):
    return dict(max_slots=4, max_queue=16, paged=True, page_size=8,
                prefill_chunk=8, spec_tokens=4, kv_host_tier=True,
                kv_snapshot=True, snapshot_dir=str(tmp / name), lora=True,
                lora_rank=4, adapter_slots=2)


def _serve(eng):
    """Two waves of the four requests, each burst under the loop's lock;
    returns the handles."""
    handles = []
    for _ in range(2):
        with eng.scheduler._cond:
            wave = [eng.submit(p, N_NEW, adapter=a)
                    for p, a in zip(_prompts(), ADAPTERS)]
        for h in wave:
            h.result(WAIT)
        handles += wave
    return handles


def _families(snap, label):
    """{family: sorted label names} of this engine's series: engine-labelled
    series of ``label``, the unlabelled adapter/snapshot families, and the
    paged slot manager's collector samples."""
    out = {}
    for name, fam in snap.items():
        for s in fam["series"]:
            lab = s["labels"]
            if (lab.get("engine") == label or name.startswith(UNLABELLED)
                    or str(lab.get("source", "")).startswith(
                        "serving_paged-")):
                out[name] = sorted(lab)
    return out


def _value(snap, name, label):
    (s,) = [s for s in snap[name]["series"]
            if s["labels"].get("engine") == label]
    return s["value"]


@pytest.fixture(scope="module")
def runs(pair, tmp_path_factory):
    """The run through both packages: (snapshots, engine labels, handles,
    metrics with obs on and off, the port's span and step counts)."""
    jm, params, sd, jads, ads = pair
    tmp = tmp_path_factory.mktemp("obs_run")
    obs.default_tracer().clear()
    out = {}
    # no tier has a TTFT SLO: admission must not depend on the clock (the
    # reference's first wave pays its compiles)
    port = ServingEngine(GPTForCausalLM(**CFG, device="cpu"), sd,
                         device="cpu", adapters=ads,
                         policy=ControlPolicy(slo_ttft_s=NO_SLO),
                         **_options(tmp, "port"))
    ref = JaxEngine(jm, params, adapters=jads,
                    policy=jcontrol.ControlPolicy(slo_ttft_s=NO_SLO),
                    **_options(tmp, "ref"))
    try:
        for name, eng, reg in (("port", port, obs.default_registry()),
                               ("ref", ref, jobs.default_registry())):
            handles = _serve(eng)
            health = reg.health()
            # drained and joined: every count of the run is published
            eng.shutdown()
            reg.snapshot()                    # the collectors' first scrape
            on = eng.metrics()
            prev = (obs.set_enabled(False), jobs.set_enabled(False))
            try:
                off = eng.metrics()
            finally:
                obs.set_enabled(prev[0])
                jobs.set_enabled(prev[1])
            out[name] = dict(snap=reg.snapshot(), label=eng.obs_label,
                             handles=handles, on=on, off=off,
                             health=health, health_after=reg.health())
        out["port"]["steps"] = port.stats["steps"]
        out["port"]["spans"] = obs.default_tracer().spans()
    finally:
        port.shutdown()
        ref.shutdown()
    return out


def test_same_family_and_label_names(runs):
    mine = _families(runs["port"]["snap"], runs["port"]["label"])
    ref = _families(runs["ref"]["snap"], runs["ref"]["label"])
    assert REFERENCE_ONLY <= set(ref) and not REFERENCE_ONLY & set(mine)
    for name in REFERENCE_ONLY:
        del ref[name]
    assert mine == ref
    for fam in ("bigdl_serving_shed_total", "bigdl_kv_host_tier_hits_total",
                "bigdl_recovery_streams_total", "bigdl_adapter_loads_total",
                "bigdl_snapshot_pages_written_total",
                "bigdl_serving_spec_accept_rate", "bigdl_device_flops",
                "bigdl_device_flops_per_sec", "bigdl_decode_dispatches"):
        assert fam in mine, fam
    # help strings and types too
    for name in mine:
        a, b = runs["port"]["snap"][name], runs["ref"]["snap"][name]
        assert (a["type"], a["help"]) == (b["type"], b["help"]), name


def test_deterministic_counters_equal(runs):
    p, r = runs["port"], runs["ref"]
    for name in DETERMINISTIC:
        assert _value(p["snap"], name, p["label"]) == \
            _value(r["snap"], name, r["label"]), name
    assert _value(p["snap"], "bigdl_serving_retired_total", p["label"]) == 8
    assert _value(p["snap"], "bigdl_serving_prefix_cache_hits_total",
                  p["label"]) > 0
    assert _value(p["snap"], "bigdl_serving_spec_proposed_total",
                  p["label"]) > 0
    (ttft,) = [s for s in p["snap"]["bigdl_serving_ttft_seconds"]["series"]
               if s["labels"]["engine"] == p["label"]]
    assert ttft["count"] == 8
    traces = {h.trace for h in p["handles"]}
    assert ttft["exemplars"] and all(e["trace"] in traces
                                     for e in ttft["exemplars"].values())


def test_a_request_timeline_has_the_reference_events(runs):
    for i in range(8):
        names = []
        for name, rec in (("port", obs.reqtrace.default_recorder()),
                          ("ref", jobs.reqtrace.default_recorder())):
            tl = rec.timeline(runs[name]["handles"][i].trace)
            names.append([e["event"] for e in tl["events"]])
        assert names[0] == names[1]
        assert names[0][:2] == ["submit", "admit"] and \
            names[0][-1] == "retire"


def test_metrics_have_the_reference_keys_obs_on_and_off(runs):
    p, r = runs["port"], runs["ref"]
    for key in ("on", "off"):
        missing = set(r[key]) - set(p[key])
        assert not missing, (key, missing)
    for k in ("admitted", "retired", "generated_tokens", "rejected",
              "shed", "rate_limited", "downtiered", "spec_proposed",
              "spec_accepted"):
        assert p["on"][k] == p["off"][k] == r["on"][k], k
    assert p["on"]["step_traces"] == p["off"]["step_traces"] == p["steps"]


def test_span_track_and_health_probe(runs):
    p = runs["port"]
    steps = [s for s in p["spans"] if s.name == "serve/step"]
    assert len(steps) == p["steps"]
    assert {s.thread_name for s in steps} == {"bigdl-tpu-torch-serving"}
    assert any(s.name == "serve/prefill_chunk" for s in p["spans"])
    assert any(s.name == "serve/submit" and s.thread_name != steps[0]
               .thread_name for s in p["spans"])
    key = f"engine:{p['label']}"
    assert p["health"][key] is True
    assert key not in p["health_after"]       # shutdown unregistered it


def test_supervisor_restart_instruments(pair, tmp_path, monkeypatch):
    """A restart under the supervisor: its registry series, a flight dump
    in ``BIGDL_TPU_FLIGHT_DIR``, the victims' ``supervisor_resubmit``
    events and the fault harness's counter."""
    _, _, sd, _, _ = pair
    monkeypatch.setenv("BIGDL_TPU_FLIGHT_DIR", str(tmp_path))
    obs.reqtrace.default_flight()._last_dump = 0.0

    def factory():
        return ServingEngine(GPTForCausalLM(**CFG, device="cpu"), sd,
                             device="cpu", max_slots=2, max_recoveries=0)

    fired = obs.counter("bigdl_faults_injected_total",
                        "faults fired by the injection harness",
                        ("site", "kind")).labels("serving.step", "error")
    before = fired.value
    with EngineSupervisor(factory, poll_interval_s=0.02,
                          backoff_base_s=0.01) as sup:
        sup.generate(_prompts()[1], 2, timeout=WAIT)
        faults.configure("serving.step:error:after=1:times=1")
        hs = [sup.submit(p, 6) for p in _prompts()[:2]]
        for h in hs:
            h.result(WAIT)
        faults.configure(None)
        snap = obs.default_registry().snapshot()
        lab = {"supervisor": sup.label}

        def val(name):
            return [s for s in snap[name]["series"]
                    if s["labels"] == lab][0]

        assert val("bigdl_engine_restarts_total")["value"] == sup.restarts == 1
        assert val("bigdl_supervisor_resubmitted_total")["value"] == \
            sup.resubmitted >= 1
        assert val("bigdl_supervisor_state")["value"] == 0
        assert val("bigdl_supervisor_recovery_seconds")["count"] == 1
    assert fired.value == before + 1
    dumps = os.listdir(tmp_path)
    assert any("supervisor" in d for d in dumps)
    events = [[e["event"] for e in obs.reqtrace.default_recorder()
               .timeline(h.trace)["events"]] for h in hs]
    assert any("supervisor_resubmit" in ev and "failover_handoff" in ev
               for ev in events)
    assert all(ev[-1] == "retire" for ev in events)
