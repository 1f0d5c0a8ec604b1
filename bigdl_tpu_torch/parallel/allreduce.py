"""ZeRO-1 data parallelism over a list of devices (the port of
``bigdl_tpu/parallel/allreduce.py``, reference
``parameters/AllReduceParameter.scala:78`` and
``optim/DistriOptimizer.scala:374``).

The reference cuts the flattened model vector into N contiguous slices;
replica p owns slice p: its float32 master weights and its optimizer
slots (ZeRO-1). Each step gathers every slice in the wire type
(``getWeights``: an ``all_gather``), runs forward and backward on the
replica's rows of the batch, reduce-scatters the gradients in the wire
type (``putGradients``/``aggregateGradientPartition``: a
``psum_scatter``) and lets each owner update its own slice.

Here one thread drives the N replicas of a ``mesh`` (a list of devices;
a device may repeat, so one card can hold several replicas). Each replica
has its own copy of the module on its device, its float32 master slice
and the ``OptimMethod`` state of that slice alone. The collectives are
copies and sums in a fixed order:

1. gather: each master slice cast to the wire type, copied to every
   replica's device, concatenated and cast back to float32 into that
   replica's parameters, so the forward runs on wire-rounded weights
   even in float32 compute, as the reference's does;
2. forward and backward of replica p on rows ``[p*b/N, (p+1)*b/N)`` of
   the batch (``optim.optimizer.make_loss_and_grads``: the criterion,
   the regularizers, the freeze and ``set_scale_w`` multipliers);
3. reduce-scatter: each replica's flat gradient cast to the wire type;
   owner p sums slice p over the replicas in replica order in float32,
   rounds the sum to the wire type once (as XLA reduces the reference's
   bfloat16 ``psum_scatter``), casts it to float32 and divides by N (by a
   tensor: on the card ``t / n`` multiplies by a rounded reciprocal);
4. clipping: constant clipping on the slice; L2 clipping by the global
   norm, the squares of the slices summed in replica order;
5. update: the owner's ``OptimMethod.update`` on ``{"flat": slice}``, its
   schedule's step, epoch and plateau multiplier in its own state;
6. floating buffers (BN statistics) averaged over the replicas in replica
   order and copied back to each; integer buffers left alone; the loss
   is the mean of the replicas' losses.

The flat vector's element order is the reference's ``ravel_pytree`` order
of the module's parameters in the reference's layout
(``convert.module_params_to_jax``): names sorted by their dotted
components (child indices as numbers, names as strings, so a leaf's
``bias`` comes before its ``weight``), each tensor in the reference's
layout (convolution weights HWIO, Linear weights (in, out)) and row-major.
So replica p's master slice and slots hold the elements the reference's
device p holds.

The gather and the reduce-scatter (with clipping) run inside
``torch.profiler.record_function`` ranges, ``allreduce/gather`` and
``allreduce/reduce_scatter``, so a trace shows them as their own spans.

Every copy between replicas is a new tensor (``torch.cat``, ``clone``):
on a repeated device ``.to(device)`` returns the tensor itself, and one
replica's in-place update must never reach another's state. Each
dispatch's wire bytes go to the obs registry through
:func:`record_allreduce`, which is also the ``allreduce.sync`` fault site.

:func:`allreduce_bandwidth` times the step's two collectives (or a plain
sum over the replicas) on a device list, and :func:`ici_peak_gbps` gives
the link peak it is held against: the H100 SXM's NVLink 4, 450 GB/s a
direction (NVIDIA's datasheet: 900 GB/s both ways). On a list whose
devices repeat, no byte crosses a link for a repeated device (``.to()``
aliases, the copies stay on the card), so it reports the seconds and the
ring's bytes and no bandwidth.
"""

from __future__ import annotations

import copy
import inspect
import math
import time

import torch
from torch.profiler import record_function

from bigdl_tpu_torch import obs
from bigdl_tpu_torch.nn.module import (from_jax_layout, jax_layout,
                                       to_jax_layout)
from bigdl_tpu_torch.optim.optimizer import cast_forward, make_loss_and_grads
from bigdl_tpu_torch.resilience.faults import fault_point
from bigdl_tpu_torch.utils.flags import get_flag


def ring_allreduce_bytes(n_elems, ndev, dtype=torch.bfloat16):
    """Wire bytes per device for one ring allreduce of ``n_elems``
    elements (reduce-scatter and all-gather each move (n-1)/n of the
    vector)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return int(2 * (ndev - 1) / ndev * n_elems * itemsize)


def record_allreduce(n_bytes, seconds=None):
    """Publish one allreduce's wire bytes, and when the caller timed a
    blocking sync its seconds, on the obs registry
    (``bigdl_allreduce_bytes_total``, ``bigdl_allreduce_sync_seconds``).
    The distributed loop calls it once a dispatch with the ring's bytes
    (its collectives run inside the step, so it has no seconds); it is
    also the ``allreduce.sync`` fault site, inside the loop's retry, so an
    injected error takes the reload-and-rebuild path a real fault
    takes."""
    fault_point("allreduce.sync", n_bytes=n_bytes)
    obs.counter("bigdl_allreduce_bytes_total",
                "wire bytes moved by gradient allreduce").inc(n_bytes)
    if seconds is not None:
        obs.histogram("bigdl_allreduce_sync_seconds",
                      "blocking allreduce sync time").observe(seconds)


def _order_key(name):
    return tuple((0, int(c), "") if c.isdigit() else (1, 0, c)
                 for c in name.split("."))


def _jax_layouts(params, module):
    """``{name: how the tensor sits in the reference's layout, or None}``
    (``nn.module.jax_layout`` of its owning layer; the default rule
    without ``module``)."""
    owners = dict(module.named_modules()) if module is not None else {}
    out = {}
    for name, t in params.items():
        prefix, leaf = name.rpartition(".")[::2]
        out[name] = jax_layout(owners.get(prefix), leaf, tuple(t.shape))
    return out


class AllReduceParameter:
    """The flat, slice-owned view of a module's parameters (API of
    ``AllReduceParameter.scala``): ``params`` is ``{name: tensor}`` in the
    port's layout, of ``module`` when given (whose layers name their
    layouts, ``nn.module.jax_layout``). The flat vector is float32, in the
    reference's order and layout (module docstring), zero-padded to a
    multiple of ``n_partitions``."""

    def __init__(self, params, n_partitions, module=None):
        self.params = params
        self.entries = []       # (name, port shape, layout, offset)
        layouts = _jax_layouts(params, module)
        offset = 0
        for name in sorted(params, key=_order_key):
            t = params[name]
            self.entries.append((name, tuple(t.shape), layouts[name],
                                 offset))
            offset += t.numel()
        self.total_size = offset
        self.padding = (-offset) % n_partitions
        self.padded_size = offset + self.padding
        self.slice_size = self.padded_size // n_partitions

    def flatten(self, tensors):
        """``{name: tensor}`` (the parameters, or their gradients) as the
        padded float32 flat vector, on their device."""
        parts = []
        for name, _, layout, _ in self.entries:
            t = to_jax_layout(layout, tensors[name].detach())
            parts.append(t.reshape(-1).float())
        if self.padding:
            parts.append(parts[0].new_zeros(self.padding))
        return torch.cat(parts)

    def flat(self):
        return self.flatten(self.params)

    def to_params(self, flat):
        """``{name: tensor}`` in the port's layout from a flat vector (new
        tensors)."""
        out = {}
        for name, shape, layout, off in self.entries:
            seg = flat[off:off + math.prod(shape)]
            out[name] = from_jax_layout(layout, shape, seg).reshape(
                shape).contiguous()
        return out

    @torch.no_grad()
    def load_into(self, flat, params):
        """Copy a flat vector into ``params`` (``{name: tensor}``) in
        place."""
        for name, shape, layout, off in self.entries:
            seg = flat[off:off + math.prod(shape)]
            params[name].copy_(from_jax_layout(layout, shape, seg).reshape(
                shape))

    def slice_of(self, flat, pid):
        return flat[pid * self.slice_size:(pid + 1) * self.slice_size]


def all_gather(slices, devices, wire_dtype):
    """Step 1's collective: replica q's float32 vector, the ``slices``
    (replica p's on its device) cast to ``wire_dtype``, copied to
    ``devices[q]`` and concatenated in replica order (a new tensor on
    each device)."""
    wire = [t.to(wire_dtype) for t in slices]
    return [torch.cat([w.to(dev) for w in wire]).float() for dev in devices]


def _count(n, device):
    """N as a float32 tensor on ``device``: on the card ``t / n`` with a
    Python number multiplies by a rounded reciprocal, ``t / tensor``
    divides."""
    return torch.full((), float(n), device=device)


def reduce_scatter(flats, devices, wire_dtype):
    """Step 3's collective: owner p's float32 slice p of the mean of the
    replicas' flat vectors ``flats``, each cast to ``wire_dtype`` (the
    bytes on the wire) and summed in replica order in float32 on
    ``devices[p]``, the sum rounded to ``wire_dtype`` once, then cast to
    float32 and divided by N."""
    n = len(devices)
    size = flats[0].shape[0] // n
    out = []
    for p, dev in enumerate(devices):
        acc = None
        for g in flats:
            part = g[p * size:(p + 1) * size].to(wire_dtype).to(dev)
            acc = part.float() if acc is None else acc + part.float()
        out.append(acc.to(wire_dtype).float() / _count(n, dev))
    return out


def _fresh(t, device):
    """A copy of ``t`` on ``device`` that shares no memory with ``t``."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    out.copy_(t)
    return out


class ZeroState:
    """The ZeRO-1 state layout (the reference's ``_opt_specs``, :371):
    replica p holds its module copy ``replicas[p]`` on ``devices[p]``,
    the float32 master slice ``masters[p]`` (``slice_size`` elements of
    the flat vector) and ``opt_states[p]``, ``optim_method.init_state(
    {"flat": masters[p]})``: per-parameter slots of the slice alone,
    scalar counters of its own."""

    def __init__(self, module, optim_method, mesh, wire_dtype):
        self.devices = [torch.device(d) for d in mesh]
        self.n = len(self.devices)
        self.wire_dtype = wire_dtype
        self.arp = AllReduceParameter(dict(module.named_parameters()),
                                      self.n, module)
        flat = self.arp.flat()
        self.masters = [_fresh(self.arp.slice_of(flat, p), dev)
                        for p, dev in enumerate(self.devices)]
        self.replicas = [copy.deepcopy(module).to(dev)
                         for dev in self.devices]
        self.params = [dict(r.named_parameters()) for r in self.replicas]
        self.buffers = [[b for _, b in r.named_buffers()
                         if b.is_floating_point()] for r in self.replicas]
        self.opt_states = [optim_method.init_state({"flat": m})
                           for m in self.masters]

    def gather(self):
        """Step 1: every replica's parameters from the wire-typed master
        slices (module docstring)."""
        for q, full in enumerate(all_gather(self.masters, self.devices,
                                            self.wire_dtype)):
            self.arp.load_into(full, self.params[q])

    def full_master(self, device):
        """The float32 flat master vector on ``device``."""
        return torch.cat([m.to(device) for m in self.masters])

    def split_rows(self, t):
        """Replica p's rows of a batch tensor, on its device."""
        rows = t.shape[0] // self.n
        return [t[p * rows:(p + 1) * rows].to(dev)
                for p, dev in enumerate(self.devices)]

    @torch.no_grad()
    def average_buffers(self):
        """Step 6: floating buffers averaged in replica order."""
        dev0 = self.devices[0]
        for j in range(len(self.buffers[0])):
            acc = self.buffers[0][j].to(dev0, copy=True)
            for q in range(1, self.n):
                acc = acc + self.buffers[q][j].to(dev0)
            acc = acc / _count(self.n, dev0)
            for q in range(self.n):
                self.buffers[q][j].copy_(acc)

    def gathered_opt_state(self):
        """The optimizer state in the reference's gathered layout: every
        per-parameter slot the concatenation of the replicas' slices (the
        padded flat vector, on the first device), the scalar counters
        replica 0's."""
        dev0 = self.devices[0]

        def join(path, first):
            if isinstance(first, dict):
                return {k: join(path + (k,), v) for k, v in first.items()}
            if first.dim() == 0:
                return first.clone()
            parts = []
            for st in self.opt_states:
                for k in path:
                    st = st[k]
                parts.append(st.to(dev0))
            return torch.cat(parts)

        return join((), self.opt_states[0])

    @torch.no_grad()
    def load_opt_state(self, saved):
        """Scatter a state of :meth:`gathered_opt_state`'s layout (any
        device) back onto the replicas' slices."""
        ss = self.arp.slice_size

        def put(dst, src, p):
            for k, v in dst.items():
                if isinstance(v, dict):
                    put(v, src[k], p)
                elif v.dim() == 0:
                    v.copy_(src[k])
                else:
                    v.copy_(src[k][p * ss:(p + 1) * ss])

        for p, st in enumerate(self.opt_states):
            put(st, saved, p)


_GOLDEN = 0x9E3779B97F4A7C15        # spreads the replicas' seeds apart


def replica_generators(generator, devices):
    """One generator a replica for one step: a seed drawn once from
    ``generator`` (a CPU generator, so the draw needs no sync), folded
    with each replica's index, each on its replica's device (the
    reference splits its key once a step and folds in the replica index,
    ``bigdl_tpu/parallel/allreduce.py:197``)."""
    draw = int(torch.randint(0, 1 << 62, (), generator=generator))
    return [torch.Generator(device=dev).manual_seed(
        (draw + (q + 1) * _GOLDEN) % (1 << 63))
        for q, dev in enumerate(devices)]


def make_distributed_train_step(module, criterion, optim_method, mesh,
                                clipping=None, wire_dtype=torch.bfloat16,
                                compute_dtype=None, accumulate_steps=1):
    """The data-parallel step over ``mesh`` (a list of devices). Returns
    ``step``: ``step(x, y, generator=None) -> loss`` runs steps 1-6 of
    the module docstring on a batch whose rows N divides (x, y on any
    device; each replica's rows are copied to its device) and returns the
    mean loss on the first device; with a CPU ``generator``, replica q
    draws from its own stream (:func:`replica_generators`);
    ``step.train_loop(xs, ys, generator=None) -> losses`` runs it on each
    batch of a ``[K, batch, ...]`` superbatch; ``step.state`` is the
    :class:`ZeroState`. ``clipping``: None, ("constant", lo, hi) or
    ("l2norm", max_norm). ``accumulate_steps=K``: K micro-batches of each
    replica's rows a step, their gradients and losses averaged. The
    replicas start from ``module``'s parameters and buffers."""
    state = ZeroState(module, optim_method, mesh, wire_dtype)
    grads_of = [make_loss_and_grads(r, criterion, compute_dtype,
                                    accumulate_steps=accumulate_steps)
                for r in state.replicas]

    def step(x, y, generator=None):
        with record_function("allreduce/gather"):
            state.gather()
        gens = ([None] * state.n if generator is None
                else replica_generators(generator, state.devices))
        losses, flats = [], []
        for q, (xq, yq) in enumerate(zip(state.split_rows(x),
                                         state.split_rows(y))):
            loss, grads = grads_of[q](xq, yq, gens[q])
            losses.append(loss)
            flats.append(state.arp.flatten(grads))
        with torch.no_grad(), record_function("allreduce/reduce_scatter"):
            slices = _clip(reduce_scatter(flats, state.devices, wire_dtype),
                           clipping, state)
        with torch.no_grad():
            for p in range(state.n):
                optim_method.update({"flat": slices[p]}, state.opt_states[p],
                                    {"flat": state.masters[p]})
            state.average_buffers()
            dev0 = state.devices[0]
            total = losses[0].detach().to(dev0, copy=True)
            for loss in losses[1:]:
                total = total + loss.detach().to(dev0)
            return total / _count(state.n, dev0)

    def train_loop(xs, ys, generator=None):
        return torch.stack([step(xs[i], ys[i], generator)
                            for i in range(xs.shape[0])])

    step.train_loop = train_loop
    step.state = state
    return step


def _clip(slices, clipping, state):
    if clipping is None:
        return slices
    kind = clipping[0]
    if kind == "constant":
        return [torch.clamp(g, clipping[1], clipping[2]) for g in slices]
    if kind == "l2norm":
        dev0 = state.devices[0]
        sq = torch.sum(torch.square(slices[0])).to(dev0)
        for g in slices[1:]:
            sq = sq + torch.sum(torch.square(g)).to(dev0)
        scale = torch.clamp_max(clipping[1] / (torch.sqrt(sq) + 1e-12), 1.0)
        return [g * scale.to(g.device) for g in slices]
    raise ValueError(f"unknown clipping {kind}")


def _accepts_valid(method):
    try:
        return "valid" in inspect.signature(method.counters).parameters
    except (TypeError, ValueError):
        return False


def make_distributed_eval_step(state, methods, compute_dtype=None):
    """In-mesh validation over a :class:`ZeroState`: ``fn(x, y, valid) ->
    ((value, count), ...)``, one pair per method, each summed over the
    replicas in replica order (float32, on the first device). Each
    replica runs its rows in eval mode on the gathered wire-typed
    weights; ``valid`` (a bool per row) masks a padded tail out of the
    counters. ``fn.supports_valid`` is False when a method's ``counters``
    takes no ``valid``: the mask is then not passed, and the caller must
    skip padded batches (the reference's ``make_distributed_eval_step``,
    :293)."""
    supports_valid = all(_accepts_valid(m) for m in methods)

    @torch.no_grad()
    def fn(x, y, valid):
        state.gather()
        dev0 = state.devices[0]
        sums = [None] * len(methods)
        for r, xq, yq, vq in zip(state.replicas, state.split_rows(x),
                                 state.split_rows(y),
                                 state.split_rows(valid)):
            was = r.training
            r.eval()
            try:
                out = cast_forward(r, xq, compute_dtype)
            finally:
                r.train(was)
            for i, m in enumerate(methods):
                v, c = (m.counters(out, yq, valid=vq) if supports_valid
                        else m.counters(out, yq))
                pair = (torch.as_tensor(v).float().to(dev0),
                        torch.as_tensor(c).float().to(dev0))
                sums[i] = pair if sums[i] is None else (
                    sums[i][0] + pair[0], sums[i][1] + pair[1])
        return tuple(sums)

    fn.supports_valid = supports_valid
    return fn


def _sync(devices):
    """Wait for every card in ``devices``."""
    for dev in {torch.device(d) for d in devices}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _psum(xs, devices, dtype):
    """The sum over the replicas of ``xs`` (replica p's on its device), in
    replica order in float32, rounded to ``dtype`` once, on every device
    (a new tensor on each)."""
    out = []
    for dev in devices:
        acc = None
        for x in xs:
            part = x.to(dev).float()
            acc = part if acc is None else acc + part
        out.append(acc.to(dtype))
    return out


def allreduce_bandwidth(mesh, size_mb=64, dtype=torch.bfloat16, iters=10,
                        pattern="step"):
    """Time the collectives over ``mesh`` (a list of devices) on a vector
    of ``size_mb`` MiB of ``dtype`` (the reference's
    ``allreduce_bandwidth``, ``bigdl_tpu/parallel/allreduce.py:380``).

    ``pattern="step"`` times the pair the train step runs, in its order:
    :func:`all_gather` of the float32 weight slices in the wire type
    ``dtype``, then :func:`reduce_scatter` of every replica's full float32
    gradient. ``pattern="psum"`` times a sum over the replicas returned
    to every device. One untimed call, then ``iters`` calls, every device
    synchronised before each clock read. Publishes ``bytes x iters`` and
    the seconds through :func:`record_allreduce`.

    Returns ``pattern``, ``seconds_per_allreduce`` and ``ring_bytes`` (the
    ring allreduce's bytes a device, :func:`ring_allreduce_bytes`); on
    distinct devices also ``algo_bandwidth_gbps`` and
    ``bus_bandwidth_gbps``, and with a known peak (:func:`ici_peak_gbps`)
    ``efficiency_vs_peak`` and ``ici_peak_gbps``. A list whose devices
    repeat moves no bytes between the repeated ones, so it gets no
    bandwidth figure, peak override or not."""
    devices = [torch.device(d) for d in mesh]
    ndev = len(devices)
    itemsize = torch.empty((), dtype=dtype).element_size()
    n = int(size_mb * 1024 * 1024 / itemsize)
    n -= n % ndev
    if pattern == "step":
        label = "all_gather+psum_scatter (train step)"
        slices = [torch.ones(n // ndev, device=d) for d in devices]
        grads = [torch.ones(n, device=d) for d in devices]

        def fn():
            full = all_gather(slices, devices, dtype)
            return full, reduce_scatter(grads, devices, dtype)
    elif pattern == "psum":
        label = "psum"
        xs = [torch.ones(n, dtype=dtype, device=d) for d in devices]

        def fn():
            return _psum(xs, devices, dtype)
    else:
        raise ValueError(f"unknown pattern {pattern!r}")
    fn()
    _sync(devices)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(devices)
    dt = (time.perf_counter() - t0) / iters
    bytes_moved = ring_allreduce_bytes(n, ndev, dtype)
    record_allreduce(bytes_moved * iters, seconds=dt)
    out = {"pattern": label, "seconds_per_allreduce": dt,
           "ring_bytes": bytes_moved}
    if len(set(devices)) < ndev:
        return out
    out["algo_bandwidth_gbps"] = n * itemsize / dt / 1e9
    out["bus_bandwidth_gbps"] = bytes_moved / dt / 1e9
    peak = ici_peak_gbps()
    if peak:
        out["efficiency_vs_peak"] = out["bus_bandwidth_gbps"] / peak
        out["ici_peak_gbps"] = peak
    return out


# one-direction link peak by device kind, GB/s, keyed by lower-case
# substrings of ``torch.cuda.get_device_name``: the H100 SXM's NVLink 4,
# 18 links of 25 GB/s a direction (NVIDIA's datasheet: 900 GB/s both ways)
_LINK_PEAK_GBPS = (("h100 80gb hbm3", 450.0), ("h100 sxm", 450.0))


def ici_peak_gbps(device_kind=None):
    """The one-direction link peak of ``device_kind`` (default: the first
    card's name), the denominator of ``efficiency_vs_peak``; the
    ``BIGDL_TPU_PEAK_ICI_GBPS`` flag overrides. None for an unknown kind
    and without a card, so no efficiency is made up."""
    peak = get_flag("BIGDL_TPU_PEAK_ICI_GBPS", None, float)
    if peak:
        return peak
    if device_kind is None:
        if not torch.cuda.is_available():
            return None
        device_kind = torch.cuda.get_device_name(0)
    kind = device_kind.lower()
    for sub, gbps in _LINK_PEAK_GBPS:
        if sub in kind:
            return gbps
    return None


__all__ = ["AllReduceParameter", "ZeroState", "all_gather",
           "allreduce_bandwidth", "ici_peak_gbps",
           "make_distributed_eval_step", "make_distributed_train_step",
           "record_allreduce", "reduce_scatter", "replica_generators",
           "ring_allreduce_bytes"]
