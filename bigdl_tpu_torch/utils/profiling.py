"""Dispatch counters, modelled device cost, per-layer timing and device
tracing (the port of ``bigdl_tpu/utils/profiling.py``).

- :class:`DispatchCounters` — the port's ``DecodeCounters``. PyTorch runs
  eagerly, so there are no trace/compile counts to keep: a slot manager
  counts the work it dispatched (prefill chunks, decode steps,
  copy-on-write page copies), the total of those dispatches, and counts
  that are not dispatches (decode steps that sampled). With ``obs_name``
  the dispatch count and the modelled cost publish on the obs registry as
  the reference's collector families.
- :func:`device_peak_flops` — the card's dense bf16 peak, for the
  ``bigdl_mfu`` gauge.
- :func:`trace` — a ``torch.profiler`` capture of the host and, on a card,
  its CUDA activity (``/profile`` of the obs endpoint).
- :func:`per_layer_times` / :func:`format_times` — the reference's
  ``getTimes`` shape: forward and backward wall time per layer,
  synchronised on the device.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
import weakref


class DispatchCounters:
    """Named integer counters plus ``dispatches``, safe to read from any
    thread (``engine.metrics()``) while the scheduler thread ticks them.

    Cost accounting rides the same instance as plain attributes
    (``flops`` / ``hbm_bytes``, fed by :meth:`add_cost` with each
    dispatch's modelled work while request tracing is on, as the
    reference feeds its ``CostStampedJit`` figures). ``obs_name``
    registers a scrape-time collector on the obs default registry holding
    only a weakref (a dead instance prunes itself at the next scrape):
    ``bigdl_decode_dispatches{source}`` always, and while costs flow
    ``bigdl_device_flops`` / ``bigdl_hbm_bytes``, their ``_per_sec`` rates
    between scrapes and, where :func:`device_peak_flops` knows the card,
    ``bigdl_mfu``. The reference's ``bigdl_decode_traces`` (compile
    counts) has no counterpart: PyTorch compiles nothing."""

    _obs_seq = itertools.count()   # shared across instances

    def __init__(self, *names, obs_name=None):
        self._lock = threading.Lock()
        self._counts = {n: 0 for n in names}
        self._counts["dispatches"] = 0
        self.flops = 0.0
        self.hbm_bytes = 0.0
        if obs_name is not None:
            self._register_obs(obs_name)

    def _register_obs(self, obs_name):
        from bigdl_tpu_torch import obs
        source = f"{obs_name}-{next(DispatchCounters._obs_seq)}"
        self.obs_source = source          # the collector's ``source`` label
        ref = weakref.ref(self)
        rate_state = {}

        def collect():
            counters = ref()
            if counters is None:
                return None   # instance gone: unregister this collector
            lbl = {"source": source}
            samples = [("bigdl_decode_dispatches", lbl,
                        counters["dispatches"])]
            flops, hbm = counters.flops, counters.hbm_bytes
            if flops > 0.0:
                samples.append(("bigdl_device_flops", lbl, flops))
                samples.append(("bigdl_hbm_bytes", lbl, hbm))
                now = time.monotonic()
                prev = rate_state.get("prev")
                rate_state["prev"] = (now, flops, hbm)
                if prev is not None and now > prev[0]:
                    dt = now - prev[0]
                    flops_rate = max(0.0, flops - prev[1]) / dt
                    samples.append(("bigdl_device_flops_per_sec", lbl,
                                    flops_rate))
                    samples.append(("bigdl_hbm_bytes_per_sec", lbl,
                                    max(0.0, hbm - prev[2]) / dt))
                    peak = device_peak_flops()
                    if peak:
                        samples.append(("bigdl_mfu", lbl, flops_rate / peak))
            return samples

        obs.default_registry().register_collector(collect)

    def tick(self, name, n=1):
        """Count ``n`` dispatches of kind ``name``."""
        with self._lock:
            self._counts[name] += n
            self._counts["dispatches"] += n

    def add(self, name, n=1):
        """Add ``n`` to the counter ``name`` (created at 0) without
        counting a dispatch."""
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def add_cost(self, flops, hbm_bytes):
        """Accumulate one dispatch's modelled device work (host side)."""
        with self._lock:
            self.flops += flops
            self.hbm_bytes += hbm_bytes

    def __getitem__(self, name):
        with self._lock:
            return self._counts[name]

    def snapshot(self):
        with self._lock:
            return dict(self._counts)

    def reset(self):
        """Zero the counts (the modelled cost keeps accumulating: the
        collector's rates are differences of it)."""
        with self._lock:
            for k in self._counts:
                self._counts[k] = 0


# Peak dense bf16 FLOP/s by card name, for the live MFU gauge (the H100
# SXM's spec-sheet figure, which ``chip_smoke.py`` also uses). Any other
# card and the CPU return None and the gauge is omitted, never fabricated.
_PEAK_FLOPS = {"nvidia h100 80gb hbm3": 989e12}
_peak_cache = []


def device_peak_flops():
    """Peak dense bf16 FLOP/s of CUDA device 0 by its name, or None (no
    card, or a card not in the table); memoised after the first call."""
    if not _peak_cache:
        name = ""
        try:
            import torch
            if torch.cuda.is_available():
                name = torch.cuda.get_device_name(0)
        except Exception:
            name = ""
        _peak_cache.append(_PEAK_FLOPS.get(str(name).strip().lower()))
    return _peak_cache[0]


@contextlib.contextmanager
def trace(logdir):
    """A ``torch.profiler`` capture of the block: host operations and, on
    a card, CUDA kernels and copies (process-wide, whatever thread
    launched them). On exit the trace is written as Chrome trace JSON to
    ``logdir/trace.json`` (Perfetto and ``chrome://tracing`` load it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _name(module):
    get = getattr(module, "get_name", None)
    return get() if callable(get) else type(module).__name__


def per_layer_times(module, x, generator=None, repeats=3, _prefix=None):
    """Forward and backward wall time per layer (the reference's
    ``getTimes`` shape): a list of ``(name, forward_seconds,
    backward_seconds)``.

    A ``Sequential`` is walked into (its children timed one after another
    on the previous child's output); any other module is timed as one
    unit. The forward runs under autograd; the backward is
    ``torch.autograd.grad`` of the output (cotangent ones) with respect to
    the input, when it is floating point, and the module's parameters
    that require grad (0.0 when there is nothing to differentiate). Times
    are medians over ``repeats`` runs after one warm-up, synchronised on
    ``x``'s device. ``generator`` goes to layers whose forward takes one
    (dropout)."""
    import torch
    from bigdl_tpu_torch.nn.containers import Sequential
    from bigdl_tpu_torch.nn.module import call_with_generator

    name = _prefix or _name(module)
    if isinstance(module, Sequential):
        entries, cur = [], x
        for i, child in enumerate(module._modules.values()):
            sub, cur = per_layer_times(child, cur, generator=generator,
                                       repeats=repeats,
                                       _prefix=f"{name}[{i}]:{_name(child)}")
            entries.extend(sub)
        return (entries, cur) if _prefix else entries

    dev = x.device

    def timed(fn):
        fn()                                   # warm-up
        _sync(dev)
        samples = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = fn()
            _sync(dev)
            samples.append(time.perf_counter() - t0)
        return sorted(samples)[len(samples) // 2], out

    xin = x.detach()
    if xin.is_floating_point():
        xin.requires_grad_(True)
    wrt = ([xin] if xin.requires_grad else []) + [
        p for p in module.parameters() if p.requires_grad]

    def forward():
        with torch.enable_grad():
            return call_with_generator(module, xin, generator)

    fwd_s, out = timed(forward)
    if wrt and out.requires_grad:
        cot = torch.ones_like(out)
        bwd_s, _ = timed(lambda: torch.autograd.grad(out, wrt, cot,
                                                     retain_graph=True))
    else:
        bwd_s = 0.0
    entry = [(name, fwd_s, bwd_s)]
    out = out.detach()
    return (entry, out) if _prefix else entry


def format_times(entries):
    """Human-readable table of :func:`per_layer_times` output."""
    total_f = sum(e[1] for e in entries)
    total_b = sum(e[2] for e in entries)
    lines = [f"{'layer':<44} {'fwd_ms':>9} {'bwd_ms':>9}"]
    for name, f, b in entries:
        lines.append(f"{name:<44} {f * 1e3:>9.3f} {b * 1e3:>9.3f}")
    lines.append(f"{'TOTAL':<44} {total_f * 1e3:>9.3f} {total_b * 1e3:>9.3f}")
    return "\n".join(lines)
