"""Deterministic, flag-gated fault injection (the port of
``bigdl_tpu/resilience/faults.py``).

Named *injection sites* threaded through the serving hot path cost one
global load and an ``is None`` test when no plan is armed, and fire
deterministic, seeded faults when ``BIGDL_TPU_FAULT_PLAN`` (or
:func:`configure`) arms one. The plan syntax, the per-rule seeded
``random.Random`` streams and the firing order are the reference's, so one
spec and one sequence of calls fire the same faults in both packages.

Plan syntax: ``;``-separated rules, each ``site:kind[:key=val]...``::

    BIGDL_TPU_FAULT_PLAN="seed=7;serving.step:error:times=1"

Kinds: ``error`` raises :class:`FaultError`; ``delay=S`` sleeps ``S``
seconds; ``corrupt[=mode]`` mangles a just-written file
(:func:`corrupt_file`; ``truncate``, ``garbage`` or ``empty``) or an
in-memory plane list (:func:`corrupt_planes`); ``preempt`` parses, and
raises ``NotImplementedError`` when it fires: the training preemption
guard it flips is ROADMAP queue A.8. ``partial`` is ``corrupt=truncate``.

Modifiers (combined with AND): ``p=F`` (seeded probability), ``after=N``
(skip the first N matching calls), ``every=N``, ``times=K``, ``req=ID``
(only when request ``ID`` is among the call's ``requests``), ``mode=``,
``delay=``, ``signal=``.

Sites in the port: ``serving.admit``, ``serving.prefill``,
``serving.step``, ``serving.page_alloc`` (presents as
``PagePoolExhausted``), ``serving.host_swap`` (``op="demote"`` /
``"promote"``; an error drops that swap), ``serving.snapshot_write`` (an
error skips the page, ``corrupt`` mangles the file after its rename) and
``serving.snapshot_restore`` (an error presents as a store miss). The
training sites (``train.step``, ``train.drain``, ``ckpt.write``,
``allreduce.sync``), ``serving.adapter_load`` and ``fleet.failover`` are
ROADMAP queue A.8. The reference's obs counter of fired faults is
:meth:`FaultPlan.counts` here; every fire also logs at WARNING.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
import zlib

logger = logging.getLogger("bigdl_tpu_torch.resilience")

KINDS = ("error", "delay", "corrupt", "preempt")
CORRUPT_MODES = ("truncate", "garbage", "empty")
MODIFIERS = ("p", "after", "every", "times", "req", "delay", "mode",
             "signal")


class FaultError(RuntimeError):
    """The error raised by an ``error``-kind injected fault."""


class FaultPlanError(ValueError):
    """A ``BIGDL_TPU_FAULT_PLAN`` spec that cannot be parsed."""


class _Rule:
    __slots__ = ("site", "kind", "delay", "mode", "p", "after", "every",
                 "times", "req", "signal", "calls", "fires", "rng", "spec")

    def __init__(self, site, kind, spec, *, delay=0.0, mode="truncate",
                 p=1.0, after=0, every=1, times=None, req=None,
                 signal=False, seed=0, index=0):
        self.site = site
        self.kind = kind
        self.spec = spec
        self.delay = float(delay)
        self.mode = mode
        self.p = float(p)
        self.after = int(after)
        self.every = max(1, int(every))
        self.times = None if times is None else int(times)
        self.req = None if req is None else int(req)
        self.signal = bool(signal)
        self.calls = 0
        self.fires = 0
        # one stream a rule, seeded by crc32 (str hashes are salted per
        # process) of the reference's key, so both packages draw alike
        self.rng = random.Random(
            zlib.crc32(f"{seed}:{index}:{site}:{kind}:{spec}".encode()))

    def should_fire(self, ctx):
        """Counter/probability gate; call with the plan lock held."""
        if self.req is not None:
            ids = ctx.get("requests")
            if ids is None:
                one = ctx.get("request")
                ids = () if one is None else (one,)
            if self.req not in ids:
                return False
        self.calls += 1
        if self.times is not None and self.fires >= self.times:
            return False
        if self.calls <= self.after:
            return False
        if (self.calls - self.after - 1) % self.every:
            return False
        if self.p < 1.0 and self.rng.random() >= self.p:
            return False
        self.fires += 1
        return True


class FaultPlan:
    """A parsed set of injection rules (see module docstring)."""

    def __init__(self, rules, seed=0, spec=""):
        self.rules = list(rules)
        self.seed = seed
        self.spec = spec
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec):
        seed = 0
        pending = []
        for part in str(spec).split(";"):
            part = part.strip()
            if not part:
                continue
            if part.startswith("seed="):
                seed = int(part[5:])
                continue
            fields = part.split(":")
            if len(fields) < 2:
                raise FaultPlanError(
                    f"rule {part!r} must be site:kind[:key=val]...")
            site = fields[0].strip()
            kind, _, kv = fields[1].partition("=")
            kind = kind.strip()
            args = {}
            if kv:
                args["delay" if kind == "delay" else "mode"] = kv
            if kind == "partial":          # alias: half-written file
                kind, args["mode"] = "corrupt", "truncate"
            if kind not in KINDS:
                raise FaultPlanError(
                    f"unknown fault kind {kind!r} in {part!r} "
                    f"(want one of {KINDS})")
            for f in fields[2:]:
                k, _, v = f.partition("=")
                k = k.strip()
                if k not in MODIFIERS:
                    raise FaultPlanError(
                        f"unknown modifier {k!r} in {part!r}")
                args[k] = v
            pending.append((site, kind, part, args))
        rules = []
        for index, (site, kind, part, args) in enumerate(pending):
            if kind == "delay" and "delay" not in args:
                raise FaultPlanError(
                    f"delay rule {part!r} needs a duration: "
                    "site:delay=SECONDS")
            if args.get("mode", "truncate") not in CORRUPT_MODES:
                raise FaultPlanError(
                    f"unknown corrupt mode {args.get('mode')!r} in {part!r} "
                    f"(want one of {CORRUPT_MODES})")
            try:
                rules.append(_Rule(
                    site, kind, part,
                    delay=float(args.get("delay", 0.0)),
                    mode=args.get("mode", "truncate"),
                    p=float(args.get("p", 1.0)),
                    after=int(args.get("after", 0)),
                    every=int(args.get("every", 1)),
                    times=(int(args["times"]) if "times" in args else None),
                    req=(int(args["req"]) if "req" in args else None),
                    signal=args.get("signal", "0").strip().lower()
                    in ("1", "true", "yes", "on"),
                    seed=seed, index=index))
            except ValueError as e:
                raise FaultPlanError(f"bad value in {part!r}: {e}") from e
        return cls(rules, seed=seed, spec=str(spec))

    # ---------------------------------------------------------------- firing
    def _fired(self, site, ctx, corrupt):
        with self._lock:
            return [r for r in self.rules
                    if r.site == site and (r.kind == "corrupt") == corrupt
                    and r.should_fire(ctx)]

    def check(self, site, ctx):
        """Evaluate every rule at ``site``: delays sleep, errors raise, a
        ``preempt`` rule raises ``NotImplementedError`` (ROADMAP A.8).
        Acts outside the lock, so a sleep never serialises other sites."""
        for rule in self._fired(site, ctx, corrupt=False):
            _record(site, rule)
            if rule.kind == "delay":
                time.sleep(rule.delay)
            elif rule.kind == "preempt":
                raise NotImplementedError(
                    f"fault kind 'preempt' fired at {site}: the training "
                    f"preemption guard (resilience/preempt.py) is not "
                    f"ported yet (ROADMAP queue A.8)")
            elif rule.kind == "error":
                raise FaultError(f"injected fault at {site} "
                                 f"({rule.spec}, fire #{rule.fires})")

    def mangle(self, site, path):
        """Apply any firing ``corrupt`` rule at ``site`` to the file
        ``path``. Returns True when the file was mangled."""
        fired = self._fired(site, {}, corrupt=True)
        for rule in fired:
            _record(site, rule)
            _mangle_file(path, rule.mode, rule.rng)
        return bool(fired)

    def mangle_planes(self, site, planes):
        """Apply any firing ``corrupt`` rule at ``site`` to an in-memory
        plane list (per-layer dicts of numpy arrays): returns a mangled
        copy when a rule fired, else ``planes`` unchanged (the originals
        are never touched)."""
        fired = self._fired(site, {}, corrupt=True)
        if not fired:
            return planes
        import numpy as np
        planes = [dict(pl) for pl in planes]
        for rule in fired:
            _record(site, rule)
            li = rule.rng.randrange(len(planes))
            if not planes[li]:
                continue
            key = sorted(planes[li])[rule.rng.randrange(len(planes[li]))]
            a = np.array(planes[li][key])          # owning, contiguous
            raw = a.reshape(-1).view(np.uint8)
            if raw.size:
                raw[:max(1, raw.size // 3)] ^= 0xFF
            planes[li][key] = a
            logger.warning("fault harness mangled plane %d:%s at %s",
                           li, key, site)
        return planes

    def counts(self):
        """{(site, kind): fires}: the fired faults (the reference's
        ``bigdl_faults_injected_total``)."""
        with self._lock:
            out = {}
            for r in self.rules:
                key = (r.site, r.kind)
                out[key] = out.get(key, 0) + r.fires
            return out


def _record(site, rule):
    logger.warning("fault injected at %s: %s (fire #%d)",
                   site, rule.spec, rule.fires)


def _mangle_file(path, mode, rng):
    size = os.path.getsize(path)
    if mode == "empty":
        with open(path, "wb"):
            pass
    elif mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(1, size // 2))
    else:                                   # garbage over the middle third
        n = max(1, size // 3)
        junk = bytes(rng.getrandbits(8) for _ in range(min(n, 65536)))
        with open(path, "r+b") as f:
            f.seek(size // 3)
            f.write(junk)
    logger.warning("fault harness mangled %s (%s, was %d bytes)",
                   path, mode, size)


# ------------------------------------------------------------- global plan
# _UNSET: the flag has not been read yet; None: faults off. After the first
# site call with no plan armed, the fast path is one load and a test.
_UNSET = object()
_PLAN = _UNSET
_ARM_LOCK = threading.Lock()


def active_plan():
    """The armed :class:`FaultPlan`, or None; arms lazily from
    ``BIGDL_TPU_FAULT_PLAN`` on first use."""
    global _PLAN
    if _PLAN is _UNSET:
        with _ARM_LOCK:
            if _PLAN is _UNSET:
                spec = os.environ.get("BIGDL_TPU_FAULT_PLAN")
                _PLAN = FaultPlan.parse(spec) if spec else None
                if _PLAN is not None:
                    logger.warning("fault plan armed: %s", spec)
    return _PLAN


def configure(plan):
    """Arm a plan (a spec string or a :class:`FaultPlan`); ``None``
    disarms. Returns the armed plan."""
    global _PLAN
    if isinstance(plan, str):
        plan = FaultPlan.parse(plan)
    with _ARM_LOCK:
        _PLAN = plan
    return plan


def reset():
    """Forget the armed plan; the next use re-reads the flag."""
    global _PLAN
    with _ARM_LOCK:
        _PLAN = _UNSET


def _plan():
    plan = _PLAN
    if plan is _UNSET:
        plan = active_plan()
    return plan


def fault_point(site, **ctx):
    """An injection site: a no-op unless an armed plan has rules for
    ``site``. May sleep (``delay``) or raise (``error``). Serving sites
    pass ``requests=(ids...)`` so ``req=`` rules can target one
    request."""
    plan = _PLAN
    if plan is None:                       # the disarmed fast path
        return
    plan = _plan()
    if plan is not None:
        plan.check(site, ctx)


def corrupt_file(site, path):
    """Post-write hook of a file site: applies any firing ``corrupt`` rule
    to ``path``. Returns True when the file was mangled."""
    plan = _plan()
    return False if plan is None else plan.mangle(site, path)


def corrupt_planes(site, planes):
    """In-memory analogue of :func:`corrupt_file` for plane lists: a
    mangled copy when a ``corrupt`` rule fires at ``site``, else
    ``planes``."""
    plan = _plan()
    return planes if plan is None else plan.mangle_planes(site, planes)


def enabled():
    """True when a fault plan is armed (flag or :func:`configure`)."""
    return active_plan() is not None
