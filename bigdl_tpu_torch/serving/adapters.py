"""Paged, tiered, digest-addressed LoRA adapter pool (the port of
``bigdl_tpu/serving/adapters.py``).

Multi-tenant serving (S-LoRA, Punica) keeps adapter weights the way paged
serving keeps K/V: a preallocated ``[slots + 1, ...]`` device pool of A/B
slabs, refcounted while a live stream decodes under them, LRU-evicted when
full, and addressed by the ``models.lora.adapter_digest`` content digest,
so the digest ladder of K/V pages holds adapters too::

    device pool (this module) -> host tier (HostPageTier) -> PageStore

plus the host registry of every adapter the engine was given (the floor
of the ladder, as the base weights' host copy is).

Row 0 is the base model: zero slabs at scale 0, so a request without an
adapter adds an exactly-zero delta. A load writes one pool row in place
(the slabs copied into the row, the scale set): the pool's tensors are
allocated once, so a load never reallocates what a dispatch reads.
:meth:`AdapterPool.gathered` selects one row per batch row (the slab trees
``models.gpt``'s paths take), memoised on the batch's rows and the load
count: one gather per change of batch composition, never one per step
(the S-LoRA hoist). A batch whose rows are all the base model gathers
nothing, and its dispatch adds no delta.

Under tensor parallelism (``layout``) every shard holds its part of every
slab on its device (``models.lora.split_slab``). With ``int8`` (an engine
serving int8 weights) every slab is stored as ``{"q", "scale"}``, a scale
per column, and dequantised in the delta.

Thread contract: :meth:`acquire`, :meth:`release`, :meth:`load` and
:meth:`gathered` run on the engine's scheduler thread; :meth:`register`
before serving or between requests; :meth:`stats` reads plain counters
from any thread. The counters are plain attributes, and loads, evictions,
swap seconds and the resident count also go to the reference's obs
families (``bigdl_adapter_*``).

Fault site: ``serving.adapter_load`` fires in :meth:`AdapterPool._fetch`
(``error``: this one load fails with :class:`AdapterLoadError`; ``delay``:
a slow load; ``corrupt``: the fetched planes are mangled in memory, which
the digest check drops to the next rung).
"""

from __future__ import annotations

import heapq
import logging
import time
from collections import OrderedDict

import numpy as np
import torch

from bigdl_tpu_torch import obs
from bigdl_tpu_torch.models.lora import (adapter_digest, adapter_from_planes,
                                         adapter_planes, gather_pool_rows,
                                         host_slabs, split_slab,
                                         target_shapes)
from bigdl_tpu_torch.resilience.faults import (FaultError, corrupt_planes,
                                               fault_point)
from bigdl_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("bigdl_tpu_torch.serving")

# memoised gathers kept at most (the steady state needs one: the step's
# current composition, plus a prefill's)
_GATHER_KEYS = 8


class AdapterPoolExhausted(RuntimeError):
    """Every pool row is referenced by a live stream: a cold adapter cannot
    load until one retires. The scheduler requeues the request while
    anything is in flight."""


class AdapterColdError(RuntimeError):
    """The adapter is known but not resident and the caller deferred the
    load (``allow_load=False``): the scheduler requeues the request and
    loads it in a later iteration."""


class AdapterLoadError(RuntimeError):
    """No rung of the ladder produced the adapter's bytes (never
    registered, every copy failed its digest check, or an injected load
    fault), or the adapter does not fit the pool; also a request naming an
    adapter on an engine without a pool."""


class AdapterPool:
    """Refcounted device pool of LoRA A/B slabs over ``model``'s target
    projections (an unsharded ``GPTForCausalLM``, float or int8), content
    addressed and tiered (see module docstring).

    ``slots`` counts adapter rows; the pool holds ``slots + 1`` with row 0
    the base model. ``rank`` is every adapter's (each carries its own
    ``alpha``); ``int8`` stores int8 slabs, else the model's float type;
    ``host_tier`` a ``HostPageTier`` that evicted adapters demote into;
    ``store`` a ``snapshot.PageStore`` registrations archive to and loads
    read from; ``layout`` a ``parallel.layout.ModelLayout`` (one pool
    part per shard) or None, then ``device`` (default the card)."""

    def __init__(self, model, slots, rank, int8=False, host_tier=None,
                 store=None, layout=None, device=None):
        self.capacity = int(slots)
        if self.capacity < 1:
            raise ValueError(f"adapter pool needs >= 1 slot, got {slots}")
        self.rows = self.capacity + 1
        self.rank = int(rank)
        if self.rank < 1:
            raise ValueError(f"LoRA rank must be >= 1, got {rank}")
        self.int8 = bool(int8)
        self.tier = host_tier
        self.store = store
        self.layout = layout
        self.devices = ([resolve_device(device)] if layout is None
                        else list(layout.devices))
        self._shapes = target_shapes(model)
        self._dtype = model.gpt.tok_emb.dtype
        self._names = {}                  # name -> digest
        self._registry = {}               # digest -> host planes
        self._digest_slot = {}            # digest -> resident row
        self._slot_digest = [None] * self.rows
        self._refs = [0] * self.rows
        self._lru = OrderedDict()         # unreferenced resident rows
        self._free = list(range(1, self.rows))
        heapq.heapify(self._free)
        self.hits = 0
        self.misses = 0
        self.loads = 0
        self.evictions = 0
        self.load_errors = 0
        self.corrupt_dropped = 0
        self.gathers = 0
        self.swap_seconds = 0.0           # whole loads, evictions included
        self.evict_seconds = 0.0
        self._obs = {
            "resident": obs.gauge(
                "bigdl_adapter_resident",
                "LoRA adapters resident in the device pool"),
            "loads": obs.counter(
                "bigdl_adapter_loads_total",
                "cold-adapter loads into the device pool"),
            "evictions": obs.counter(
                "bigdl_adapter_evictions_total",
                "LRU adapter evictions from the device pool"),
            "swap": obs.counter(
                "bigdl_adapter_swap_seconds_total",
                "wall seconds spent loading adapters into the pool"),
        }
        self._layers, self._scale = self._build_pool()
        self._gather_cache = {}

    # ------------------------------------------------------------ building
    def _zero_slab(self, shape, tgt, part, i, dev):
        """Shard ``i``'s zero part of a pooled slab of (rows, ...) ``shape``:
        its shape from :func:`models.lora.split_slab` of a meta tensor."""
        tp = len(self.devices)
        if not self.int8:
            meta = torch.empty(shape, device="meta")
            part_shape = split_slab(meta, tgt, part, tp, 1)[i].shape
            return torch.zeros(part_shape, dtype=self._dtype, device=dev)
        scale_shape = (shape[0], 1, shape[2])
        meta = {"q": torch.empty(shape, device="meta"),
                "scale": torch.empty(scale_shape, device="meta")}
        got = split_slab(meta, tgt, part, tp, 1)[i]
        return {"q": torch.zeros(got["q"].shape, dtype=torch.int8,
                                 device=dev),
                "scale": torch.zeros(got["scale"].shape,
                                     dtype=torch.float32, device=dev)}

    def _build_pool(self):
        layers, scales = [], []
        for i, dev in enumerate(self.devices):
            shard = []
            for shapes in self._shapes:
                layer = {}
                for tgt in sorted(shapes):
                    din, dout = shapes[tgt]
                    layer[tgt] = {
                        "a": self._zero_slab((self.rows, din, self.rank),
                                             tgt, "a", i, dev),
                        "b": self._zero_slab((self.rows, self.rank, dout),
                                             tgt, "b", i, dev)}
                shard.append(layer)
            layers.append(shard)
            scales.append(torch.zeros(self.rows, dtype=torch.float32,
                                      device=dev))
        return layers, scales

    def _check(self, adapter):
        """An adapter this pool can hold: its rank, and per layer its
        targets and slab shapes; else :class:`AdapterLoadError`."""
        if int(adapter["rank"]) != self.rank:
            raise AdapterLoadError(
                f"adapter rank {adapter['rank']} != pool rank {self.rank}")
        if len(adapter["layers"]) != len(self._shapes):
            raise AdapterLoadError(
                f"adapter has {len(adapter['layers'])} layers, the model "
                f"{len(self._shapes)}")
        for li, (al, shapes) in enumerate(zip(adapter["layers"],
                                              self._shapes)):
            if sorted(al) != sorted(shapes):
                raise AdapterLoadError(
                    f"adapter targets {sorted(al)} != pool targets "
                    f"{sorted(shapes)} at layer {li}")
            for tgt, (din, dout) in shapes.items():
                a, b = np.shape(al[tgt]["a"]), np.shape(al[tgt]["b"])
                if a != (din, self.rank) or b != (self.rank, dout):
                    raise AdapterLoadError(
                        f"adapter {tgt} slabs {a} / {b} at layer {li}, "
                        f"the pool holds {(din, self.rank)} / "
                        f"{(self.rank, dout)}")

    # ------------------------------------------------------------ identity
    def register(self, name, adapter):
        """Catalog ``adapter`` (a ``models.lora`` tree) under ``name``:
        checked against the pool (:class:`AdapterLoadError` on a rank,
        target or shape mismatch), digested, its host planes kept in the
        registry and, with a store attached, archived there. Returns the
        16-byte digest."""
        self._check(adapter)
        digest = adapter_digest(adapter)
        planes = adapter_planes(adapter)
        self._names[str(name)] = digest
        self._registry[digest] = planes
        if self.store is not None and not self.store.has(digest):
            self.store.put_batch([(digest, planes)])
        return digest

    def resolve(self, ref):
        """An ``adapter=`` reference as a digest: None (the base model)
        passes through; a registered name, a 16-byte digest or its hex
        resolve; anything else raises ``KeyError``."""
        if ref is None:
            return None
        if isinstance(ref, (bytes, bytearray)) and len(ref) == 16:
            return bytes(ref)
        ref = str(ref)
        if ref in self._names:
            return self._names[ref]
        try:
            raw = bytes.fromhex(ref)
        except ValueError:
            raw = None
        if raw is not None and len(raw) == 16:
            return raw
        raise KeyError(f"unknown adapter {ref!r}")

    # ----------------------------------------------------------- residency
    def acquire(self, digest, allow_load=True):
        """The pool row holding ``digest``, its refcount raised (None: row
        0, never counted). A resident hit costs nothing on the card; a
        cold adapter loads (:meth:`load`) unless ``allow_load`` is False,
        which raises :class:`AdapterColdError`."""
        if digest is None:
            return 0
        row = self._digest_slot.get(digest)
        if row is not None:
            if self._refs[row] == 0:
                self._lru.pop(row, None)
            self._refs[row] += 1
            self.hits += 1
            return row
        self.misses += 1
        if not allow_load:
            raise AdapterColdError(
                f"adapter {digest.hex()[:12]} not resident")
        return self.load(digest)

    def release(self, row):
        """Drop one reference; an unreferenced row stays resident, newest
        in the LRU order."""
        if row is None or row == 0:
            return
        self._refs[row] = max(0, self._refs[row] - 1)
        if self._refs[row] == 0 and self._slot_digest[row] is not None:
            self._lru[row] = None
            self._lru.move_to_end(row)

    @torch.no_grad()
    def load(self, digest):
        """Cold load: fetch the planes down the ladder (before any
        eviction: the fetch may fail), take a free row or evict the LRU
        unreferenced one (:class:`AdapterPoolExhausted` when every row is
        referenced), and write the slabs and scale into the row in place.
        Returns the row, refcount 1."""
        if not self._free and not self._lru:
            raise AdapterPoolExhausted(
                f"all {self.capacity} adapter slots referenced by live "
                "streams")
        t0 = time.perf_counter()
        adapter = self._fetch(digest)
        try:
            self._check(adapter)
        except AdapterLoadError:
            self.load_errors += 1
            raise
        if self._free:
            row = heapq.heappop(self._free)
        else:
            row, _ = self._lru.popitem(last=False)
            self._evict(row)
        self._write(row, adapter)
        self._digest_slot[digest] = row
        self._slot_digest[row] = digest
        self._refs[row] = 1
        self.loads += 1
        dt = time.perf_counter() - t0
        self.swap_seconds += dt
        self._obs["loads"].inc()
        self._obs["swap"].inc(dt)
        self._obs["resident"].set(len(self._digest_slot))
        return row

    def _write(self, row, adapter):
        """Copy ``adapter``'s slabs (int8-quantised for an int8 pool) and
        scale into pool row ``row`` of every shard, in place."""
        host = host_slabs(adapter, self.int8)
        s = float(adapter["alpha"]) / float(adapter["rank"])
        tp = len(self.devices)
        for i, shard in enumerate(self._layers):
            for layer, hl in zip(shard, host):
                for tgt, slabs in layer.items():
                    for part in ("a", "b"):
                        src = split_slab(hl[tgt][part], tgt, part, tp)[i]
                        dst = slabs[part]
                        if isinstance(dst, dict):
                            for k in ("q", "scale"):
                                dst[k][row].copy_(src[k])
                        else:
                            dst[row].copy_(src)
            self._scale[i][row] = s

    def _evict(self, row):
        """Drop ``row``'s residency and demote its planes into the host
        tier (the tier skips what it holds and keeps its budget), so a
        reload of a recently hot adapter is a host-memory hit."""
        t0 = time.perf_counter()
        digest = self._slot_digest[row]
        self._slot_digest[row] = None
        self._digest_slot.pop(digest, None)
        self._refs[row] = 0
        self.evictions += 1
        self._obs["evictions"].inc()
        self._obs["resident"].set(len(self._digest_slot))
        planes = self._registry.get(digest)
        if self.tier is not None and planes is not None:
            nbytes = sum(int(np.asarray(v).nbytes)
                         for pl in planes for v in pl.values())
            eid = self.tier.stage((digest,), nbytes)
            if eid is not None:
                self.tier.ingest(eid, planes)
        self.evict_seconds += time.perf_counter() - t0

    def _fetch(self, digest):
        """The ladder: host tier, page store, registry, the content digest
        checked at every rung, so a corrupt copy degrades to the next rung
        and never to wrong weights. Fires ``serving.adapter_load`` (see
        module docstring)."""
        try:
            fault_point("serving.adapter_load", digest=digest.hex())
        except FaultError as e:
            self.load_errors += 1
            raise AdapterLoadError(
                f"injected adapter-load fault for {digest.hex()[:12]}: "
                f"{e!r}") from e
        rungs = []
        if self.tier is not None:
            rungs.append(("tier", self.tier.get))
        if self.store is not None:
            rungs.append(("store", self.store.get))
        rungs.append(("registry", self._registry.get))
        for name, fetch in rungs:
            planes = fetch(digest)
            if planes is None:
                continue
            planes = corrupt_planes("serving.adapter_load", planes)
            try:
                adapter = adapter_from_planes(planes)
                ok = adapter_digest(adapter) == digest
            except Exception:
                ok = False
            if ok:
                return adapter
            self.corrupt_dropped += 1
            logger.warning("adapter %s from the %s failed its digest check; "
                           "trying the next rung", digest.hex()[:12], name)
        self.load_errors += 1
        raise AdapterLoadError(
            f"adapter {digest.hex()[:12]} unavailable on every ladder rung")

    # ------------------------------------------------------------- serving
    def gathered(self, rows):
        """The slab tree of a batch whose row ``j`` runs under pool row
        ``rows[j]`` (``models.lora.gather_pool_rows``): one tree, or under
        a layout one a shard; None when every row is the base model (the
        dispatch adds no delta). Memoised until the rows or the pool's
        contents (``loads``) change."""
        key = (tuple(int(r) for r in rows), self.loads)
        if not any(key[0]):
            return None
        hit = self._gather_cache.get(key)
        if hit is not None:
            return hit
        if len(self._gather_cache) >= _GATHER_KEYS:
            self._gather_cache.clear()
        ids = torch.as_tensor(key[0], dtype=torch.long)
        trees = [gather_pool_rows(layers, scale, ids.to(dev))
                 for layers, scale, dev in zip(self._layers, self._scale,
                                               self.devices)]
        out = trees[0] if self.layout is None else trees
        self.gathers += 1
        self._gather_cache[key] = out
        return out

    # ----------------------------------------------------------- telemetry
    def stats(self):
        out = {
            "capacity": self.capacity,
            "resident": len(self._digest_slot),
            "referenced": sum(1 for r in self._refs[1:] if r > 0),
            "registered": len(self._registry),
            "hits": self.hits,
            "misses": self.misses,
            "loads": self.loads,
            "evictions": self.evictions,
            "load_errors": self.load_errors,
            "corrupt_dropped": self.corrupt_dropped,
            "gathers": self.gathers,
            "swap_seconds": self.swap_seconds,
            "evict_seconds": self.evict_seconds,
        }
        if self.tier is not None:
            for k, v in self.tier.stats().items():
                out["tier_" + k] = v
        return out


__all__ = ["AdapterPool", "AdapterPoolExhausted", "AdapterColdError",
           "AdapterLoadError"]
