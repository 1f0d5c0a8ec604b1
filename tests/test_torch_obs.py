"""The port's telemetry subsystem (``bigdl_tpu_torch/obs``) against the
reference's (``bigdl_tpu/obs``), on fresh instances of both (never the
process-global defaults, which every engine of the test process feeds):

- the registry: one seeded sequence of operations on both
  ``MetricsRegistry`` objects gives byte-equal ``prometheus_text()`` and
  equal ``snapshot()`` (quantiles and exemplars included, the exemplars'
  wall times left out); collectors and probes prune themselves alike;
  the kill switch makes every operation a no-op in both;
- spans: per-thread nesting, the ring's bounds under a soak, and the
  Chrome export's keys and nesting equal the reference's (timestamps,
  thread ids and the producer's name left out);
- request traces: the Perfetto export and the flight recorder's dump file
  have the reference's structure; both packages' SIGUSR2 handlers fire;
- the anomaly detector flags the same steps of one seeded series;
- ``MetricsServer`` on ``127.0.0.1`` at port 0: every route answers,
  ``/healthz`` gives 200, then 503 when a probe reports unhealthy or
  raises, and ``/profile`` validates its argument, answers 409 while a
  capture runs and writes a ``torch.profiler`` trace.
"""

import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from bigdl_tpu import obs as jobs
from bigdl_tpu.obs import reqtrace as jreqtrace
from bigdl_tpu_torch import obs
from bigdl_tpu_torch.obs import reqtrace


def _ops(seed, n=400):
    """A seeded list of registry operations: (kind, name, labels, value,
    exemplar)."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        kind = ("counter", "gauge", "histogram")[int(rng.integers(3))]
        name = f"t_{kind}_{int(rng.integers(3))}"
        lab = (("engine", str(int(rng.integers(3)))),) \
            if rng.random() < 0.7 else ()
        val = float(np.round(rng.exponential(0.3), 6))
        ex = f"tr{int(rng.integers(50))}" if rng.random() < 0.3 else None
        ops.append((kind, name + ("_l" if lab else ""), lab, val, ex))
    return ops


def _apply(mod, reg, ops):
    for kind, name, lab, val, ex in ops:
        labels = tuple(k for k, _ in lab)
        if kind == "histogram":
            fam = reg.histogram(name, f"help of {name}", labels,
                                buckets=(0.01, 0.1, 0.5, 1.0, 2.5))
        else:
            fam = getattr(reg, kind)(name, f"help of {name}\nsecond line",
                                     labels)
        child = fam.labels(*[v for _, v in lab]) if lab else fam
        if kind == "counter":
            child.inc(val)
        elif kind == "gauge":
            (child.set if val > 0.2 else child.dec)(val)
        else:
            child.observe(val, exemplar=ex)
    # escaping and the default histogram buckets too
    reg.gauge("t_escape", "a \\ help", ("path",)).labels(
        'C:\\tmp\n"x"').set(1.5)
    reg.histogram("t_default_seconds").observe(0.3)


def _strip_times(snap):
    for fam in snap.values():
        for s in fam["series"]:
            for ex in s.get("exemplars", {}).values():
                ex.pop("time")
    return snap


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_text_and_snapshot_equal_the_reference(seed):
    ops = _ops(seed)
    mine, ref = obs.MetricsRegistry(), jobs.MetricsRegistry()
    _apply(obs, mine, ops)
    _apply(jobs, ref, ops)
    assert mine.prometheus_text().encode() == ref.prometheus_text().encode()
    got, want = _strip_times(mine.snapshot()), _strip_times(ref.snapshot())
    assert got == want
    # quantiles of every histogram series, at every q
    for name, fam in got.items():
        if fam["type"] != "histogram":
            continue
        for a, b in zip(mine._families[name]._series(),
                        ref._families[name]._series()):
            for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
                assert a[1].quantile(q) == b[1].quantile(q)
    assert json.loads(mine.json())["metrics"].keys() == \
        json.loads(ref.json())["metrics"].keys()


def test_registry_errors_match_the_reference():
    for mod in (obs, jobs):
        reg = mod.MetricsRegistry()
        c = reg.counter("x_total", labels=("k",))
        assert reg.counter("x_total", labels=("k",)) is c
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("x_total", labels=("k",))
        with pytest.raises(ValueError, match="label value"):
            c.labels("v", "extra")
        with pytest.raises(ValueError, match="invalid metric"):
            reg.counter("bad-name")
        with pytest.raises(ValueError, match="only go up"):
            c.labels("v").inc(-1)
        with pytest.raises(ValueError, match="buckets"):
            reg.histogram("h", buckets=(1.0,))
            reg.histogram("h", buckets=(2.0,))


def test_collectors_and_probes_self_unregister_alike():
    for mod in (obs, jobs):
        reg = mod.MetricsRegistry()
        alive = {"on": True}

        def collect():
            return ([("ext_value", {"src": "a"}, 42)] if alive["on"]
                    else None)

        def probe():
            return {"engine:x": True} if alive["on"] else None

        reg.register_collector(collect)
        reg.register_probe(probe)
        assert 'ext_value{src="a"} 42' in reg.prometheus_text()
        assert reg.health() == {"engine:x": True}
        alive["on"] = False
        assert "ext_value" not in reg.prometheus_text()
        assert reg.health() == {}
        assert collect not in reg._collectors and probe not in reg._probes


def test_kill_switch_no_ops_both():
    regs = [obs.MetricsRegistry(), jobs.MetricsRegistry()]
    tracers = [obs.SpanTracer(capacity=16), jobs.SpanTracer(capacity=16)]
    prev = obs.set_enabled(False), jobs.set_enabled(False)
    try:
        for reg, tr in zip(regs, tracers):
            c = reg.counter("dead_total")
            c.inc(10)
            reg.gauge("dead_gauge").set(3)
            reg.histogram("dead_seconds").observe(1.0, exemplar="t")
            with tr.span("dead/span"):
                pass
            tr.record("dead/record", 0.0, 1.0)
            assert c.value == 0 and reg.gauge("dead_gauge").value == 0
            assert reg.histogram("dead_seconds").count == 0
            assert len(tr) == 0
        assert not reqtrace.enabled() and not jreqtrace.enabled()
    finally:
        obs.set_enabled(prev[0])
        jobs.set_enabled(prev[1])
    assert regs[0].prometheus_text() == regs[1].prometheus_text()


# --------------------------------------------------------------------- spans

def _nested(tracer):
    """The reference test's nesting: a client span around a worker thread's
    nested spans, then two more on the client thread."""
    ready, release = threading.Event(), threading.Event()

    def worker():
        with tracer.span("worker/step", live=2):
            with tracer.span("worker/dispatch"):
                ready.set()
                release.wait(5)

    t = threading.Thread(target=worker, name="bigdl-tpu-test-worker")
    with tracer.span("client/submit", request=1):
        t.start()
        assert ready.wait(5)
        release.set()
        t.join(5)
    with tracer.span("outer", step=1):
        with tracer.span("inner"):
            pass
    tracer.record("after", 0.0, 0.25, n=3)


def _shape(doc):
    """The Chrome trace without times, thread ids and producer names."""
    events = []
    for e in doc["traceEvents"]:
        e = {k: v for k, v in e.items() if k not in ("ts", "dur", "pid",
                                                     "tid")}
        if e.get("name") == "process_name":
            e["args"] = sorted(e["args"])
        events.append(e)
    return (sorted(doc), sorted(doc["otherData"]), doc["displayTimeUnit"],
            sorted(json.dumps(e, sort_keys=True) for e in events
                   if e.get("ph") == "X"),
            sorted(e["name"] for e in events if e.get("ph") == "M"))


def test_span_nesting_and_chrome_export_match_the_reference(tmp_path):
    mine, ref = obs.SpanTracer(capacity=64), jobs.SpanTracer(capacity=64)
    _nested(mine)
    _nested(ref)
    key = [(s.name, s.parent, s.depth, s.attrs, s.thread_name)
           for s in mine.spans()]
    assert key == [(s.name, s.parent, s.depth, s.attrs, s.thread_name)
                   for s in ref.spans()]
    by_name = {s.name: s for s in mine.spans()}
    assert by_name["worker/step"].parent is None
    assert by_name["worker/dispatch"].parent == "worker/step"
    assert (by_name["client/submit"].thread_id
            != by_name["worker/step"].thread_id)
    assert by_name["after"].duration == pytest.approx(0.25)
    path = mine.export(str(tmp_path / "trace.json"))
    assert _shape(json.load(open(path))) == _shape(ref.chrome_trace())


def test_span_ring_bounds_under_soak():
    for mod in (obs, jobs):
        tracer = mod.SpanTracer(capacity=64)
        for i in range(10_000):
            tracer.record(f"s{i}", 0.0, 0.001, i=i)
        assert len(tracer) == 64
        assert [s.name for s in tracer.spans()] == \
            [f"s{i}" for i in range(9936, 10_000)]
        tracer.set_capacity(16)
        assert len(tracer) == 16 and tracer.spans()[-1].name == "s9999"


# ------------------------------------------------------------ request traces

def _timelines(mod):
    rec = mod.reqtrace.ReqTraceRecorder(capacity=4, max_traces=3)
    for tr in ("t1", "t2", "t3"):
        rec.event(tr, "submit", request=int(tr[1]))
    for i in range(6):
        rec.event("t1", "tokens", request=1, off=i, n=1)
    rec.event("t4", "submit", request=4)        # evicts t2 (LRU)
    rec.event("t3", "retire", request=3, tokens=0)
    return rec


def test_recorder_and_perfetto_match_the_reference():
    mine, ref = _timelines(obs), _timelines(jobs)
    assert mine.traces() == ref.traces()
    for tr in mine.traces():
        a, b = mine.timeline(tr), ref.timeline(tr)
        for e in a["events"] + b["events"]:
            e.pop("t")
        assert a == b
    strip = ("start", "end")
    assert {k: {f: v for f, v in d.items() if f not in strip}
            for k, d in mine.snapshot().items()} == \
        {k: {f: v for f, v in d.items() if f not in strip}
         for k, d in ref.snapshot().items()}
    for trace in (None, "t3", "nope"):
        pa, pb = mine.perfetto(trace), ref.perfetto(trace)
        assert sorted(pa) == sorted(pb)
        ka = [(e["ph"], e["name"], e.get("tid"),
               sorted(e.get("args", {}))) for e in pa["traceEvents"]
              if e["name"] != "process_name"]
        kb = [(e["ph"], e["name"], e.get("tid"),
               sorted(e.get("args", {}))) for e in pb["traceEvents"]
              if e["name"] != "process_name"]
        assert ka == kb
    assert mine.timeline("t2") is None and ref.timeline("t2") is None


def test_flight_dump_has_the_reference_structure(tmp_path):
    docs = []
    for mod, sub in ((obs, "port"), (jobs, "ref")):
        rec = mod.reqtrace.ReqTraceRecorder(capacity=8)
        fl = mod.reqtrace.FlightRecorder(iterations=4,
                                         directory=str(tmp_path / sub),
                                         min_interval_s=60.0)
        for i in range(6):
            fl.note_iteration("e0", live=i, queued=0, step_s=0.01)
        fl.note_event("e0", "preempt", request=3, delivered=8)
        rec.event("tr", "submit", request=9)
        path = fl.dump("step-time anomaly: 12x median", recorder=rec)
        assert path.startswith(str(tmp_path / sub))
        assert fl.dump("again", recorder=rec) is None      # rate-limited
        assert fl.dump("forced", recorder=rec, force=True) is not None
        assert fl.dumps == 2
        docs.append(json.load(open(path)))
    a, b = docs
    assert sorted(a) == sorted(b) == ["iterations", "reason", "requests",
                                      "time"]
    assert a["reason"] == b["reason"]
    strip = [[{k: v for k, v in r.items() if k != "t"} for r in d[
        "iterations"]["e0"]] for d in docs]
    assert strip[0] == strip[1] and len(strip[0]) == 4
    assert a["requests"]["tr"]["events"][0]["event"] == "submit"
    assert sorted(a["requests"]["tr"]) == sorted(b["requests"]["tr"])
    bad = obs.reqtrace.FlightRecorder(directory="/dev/null/nope",
                                      min_interval_s=0.0)
    assert bad.dump("x", force=True) is None and bad.dumps == 0


def test_sigusr2_dumps_both_packages(tmp_path):
    """Both packages install a SIGUSR2 handler at import, each chaining
    to the one before it: one signal dumps both flight recorders."""
    if not hasattr(signal, "SIGUSR2"):
        pytest.skip("no SIGUSR2 on this platform")
    flights = (reqtrace.default_flight(), jreqtrace.default_flight())
    saved = [f._dir for f in flights]
    try:
        for f, sub in zip(flights, ("port", "ref")):
            f._dir = str(tmp_path / sub)
        os.kill(os.getpid(), signal.SIGUSR2)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not all(
                (tmp_path / sub).exists() and os.listdir(tmp_path / sub)
                for sub in ("port", "ref")):
            time.sleep(0.01)
        for sub in ("port", "ref"):
            (name,) = os.listdir(tmp_path / sub)
            assert name.startswith("flight-") and "SIGUSR2" in name
    finally:
        for f, d in zip(flights, saved):
            f._dir = d


# ------------------------------------------------------------------- anomaly

def test_anomaly_detector_flags_match_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_FLIGHT_DIR", str(tmp_path))
    rng = np.random.default_rng(11)
    series = 0.1 + 0.01 * rng.standard_normal(300)
    series[rng.choice(300, 12, replace=False)] *= rng.uniform(2.0, 6.0, 12)
    flags = []
    for mod in (obs, jobs):
        det = mod.StepTimeAnomalyDetector(loop="t", k=3.0, window=16,
                                          warmup=4,
                                          registry=mod.MetricsRegistry())
        flags.append([det.observe(s) for s in series])
        assert det._anomalies.value == sum(flags[-1])
    assert flags[0] == flags[1] and sum(flags[0]) > 0
    for mod in (obs, jobs):
        with pytest.raises(ValueError, match="k must be > 1"):
            mod.StepTimeAnomalyDetector(k=0.5,
                                        registry=mod.MetricsRegistry())


# ----------------------------------------------------------------- exporters

# straight to the local server, whatever proxy the environment names
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _get(url):
    with _OPENER.open(url, timeout=30) as r:
        return r.status, r.read().decode()


def _status(url):
    try:
        return _get(url)[0]
    except urllib.error.HTTPError as e:
        return e.code


def test_metrics_server_routes(tmp_path):
    reg = obs.MetricsRegistry()
    tracer = obs.SpanTracer(capacity=32)
    rec = obs.ReqTraceRecorder(capacity=8)
    reg.counter("served_total").inc(2)
    with tracer.span("serve/step"):
        pass
    rec.event("tr1", "submit", request=4)
    rec.event("tr1", "retire", request=4)
    state = {"engine:e0": True}
    reg.register_probe(lambda: dict(state))
    with obs.MetricsServer(registry=reg, tracer=tracer, recorder=rec,
                           host="127.0.0.1", port=0) as srv:
        assert srv.host == "127.0.0.1" and srv.port > 0
        assert "served_total 2" in _get(srv.url + "/metrics")[1]
        snap = json.loads(_get(srv.url + "/metrics.json")[1])
        assert snap["metrics"]["served_total"]["series"][0]["value"] == 2
        trace = json.loads(_get(srv.url + "/trace")[1])
        assert any(e.get("name") == "serve/step"
                   for e in trace["traceEvents"])
        idx = json.loads(_get(srv.url + "/requests")[1])
        assert idx["requests"]["tr1"]["last"] == "retire"
        tl = json.loads(_get(srv.url + "/requests?trace=tr1")[1])
        assert [e["event"] for e in tl["events"]] == ["submit", "retire"]
        pf = json.loads(_get(srv.url + "/requests?trace=tr1&fmt=perfetto")[1])
        assert any(e["ph"] == "X" for e in pf["traceEvents"])
        assert _status(srv.url + "/requests?trace=bogus") == 404
        assert _status(srv.url + "/requests?trace=bogus&fmt=perfetto") == 404
        assert "/profile" in _get(srv.url + "/")[1]
        assert _status(srv.url + "/nope") == 404
        status, body = _get(srv.url + "/healthz")
        assert status == 200 and json.loads(body) == {
            "healthy": True, "components": state}
        state["engine:e0"] = False
        assert _status(srv.url + "/healthz") == 503

        def bad():
            raise RuntimeError("mid-rebuild")

        state["engine:e0"] = True
        reg.register_probe(bad)
        assert _status(srv.url + "/healthz") == 503
        reg.unregister_probe(bad)
        assert _status(srv.url + "/healthz") == 200


def test_profile_route_validates_serializes_and_writes(tmp_path):
    with obs.MetricsServer(registry=obs.MetricsRegistry(),
                           recorder=obs.ReqTraceRecorder()) as srv:
        for bad in ("banana", "-1", "0"):
            assert _status(f"{srv.url}/profile?seconds={bad}") == 400
        status, body = _get(srv.url + "/profile?seconds=1")
        doc = json.loads(body)
        assert status == 200 and doc["seconds"] == 1.0
        assert _status(srv.url + "/profile?seconds=1") == 409
        path = os.path.join(doc["logdir"], "trace.json")
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not (
                os.path.exists(path) and not srv._profile_active):
            time.sleep(0.05)
        assert json.load(open(path))["traceEvents"] is not None
        # the capture closed: a new one is accepted
        status, body = _get(srv.url + "/profile?seconds=0.1")
        assert status == 200
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and srv._profile_active:
            time.sleep(0.05)


def test_jsonl_sink_and_summary_bridge_match_the_reference(tmp_path):
    class Writer:
        def __init__(self):
            self.calls = []

        def add_scalar(self, tag, value, step):
            self.calls.append((tag, value, step))

    out = []
    for mod in (obs, jobs):
        reg = mod.MetricsRegistry()
        reg.counter("steps_total", labels=("loop",)).labels("local").inc(4)
        reg.histogram("lat_seconds", buckets=(1.0,)).observe(0.5)
        path = tmp_path / f"{mod.__name__}.jsonl"
        sink = mod.JsonlSink(str(path), registry=reg)
        sink.write(step=1)
        sink.write(step=2)
        lines = [json.loads(ln) for ln in path.read_text().splitlines()]
        w = Writer()
        mod.SummaryBridge(w, ["steps_total", "lat_seconds"],
                          registry=reg).export(step=7)
        out.append(([ln["step"] for ln in lines],
                    [ln["metrics"] for ln in lines], w.calls))
    assert out[0] == out[1]
