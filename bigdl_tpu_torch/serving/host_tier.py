"""Tiered K/V memory: the host-RAM rung of the digest ladder (the port of
``bigdl_tpu/serving/host_tier.py``)::

    pool registry  ->  host RAM (this module)  ->  disk PageStore

Every rung is keyed by the same chained blake2b prefix digests
(``paging._block_digest`` / ``_tail_digest``), so equal digest means
bitwise-equal K/V and a page may come from any rung without changing
greedy tokens.

:class:`HostPageTier`
    The bounded pool: a lock-guarded, LRU-ordered map of digest to full-H
    host planes (the ``export_pages`` layout: one dict a layer of numpy
    arrays, int8 pools with their scale planes). Every entry carries a
    blake2b checksum taken at insert; :meth:`HostPageTier.get` verifies it,
    so a mangled host buffer degrades down the ladder (store, then
    re-prefill), never to wrong K/V. A page mid-demotion is *staged*
    (``inflight_*``, owned by the copier) until the copier commits it
    *resident* under one lock acquisition, so no snapshot of the stats
    counts it twice.

:class:`HostTierCopier`
    The copier thread the engine owns. The owner thread only slices the
    evicted page into a private device buffer (``PagedSlotManager.
    _page_buffer``: a copy made on the main stream, in stream order before
    any later write to the page) and hands it over; the read back to host
    memory and the checksum run here, overlapped with the next dispatch.
    The copier never reads the pool itself: the page's next owner may
    write it at once.

:class:`PinnedStaging`
    The pinned host memory between host and card. Resident pages live in
    ordinary (pageable) numpy arrays, and a small ring of pinned slots,
    one page each, stages every copy: a read back goes card -> slot (on a
    side stream that first waits for the slice's event) -> numpy; a
    promotion goes numpy -> slot -> card as a ``non_blocking`` copy on the
    main stream, with an event recorded behind it that must pass before
    the slot is filled again. The ring is chosen over one pinned slab the
    size of the budget: the default budget is four pools' worth of pages
    (2.42 GB of host RAM at GPT-2 small's 512-page float32 pool), and
    pinning that much takes seconds and holds it locked for the process's
    life, while the ring pins four pages; and the entries stay the plain
    numpy planes that the checksum, the fault harness and the page store
    read as they are.

Default off behind ``BIGDL_TPU_KV_HOST_TIER`` (with ``_BYTES`` and
``_PREFETCH``): see ``ServingEngine``.
"""

from __future__ import annotations

import collections
import itertools
import logging
import queue
import threading
import time

import numpy as np
import torch

from bigdl_tpu_torch.serving.snapshot import _planes_checksum

logger = logging.getLogger("bigdl_tpu_torch.serving")


def _host_copy(planes):
    """Owning numpy copies of a plane list."""
    return [{k: np.array(v) for k, v in pl.items()} for pl in planes]


def _split_planes(raw, spec):
    """Host planes from one page's flat bytes ``raw`` (a uint8 numpy
    array) laid out as ``spec`` (``(layer, name, shape, torch dtype)``
    each, in order)."""
    from bigdl_tpu_torch.serving.paging import _HOST_DTYPES
    planes = [{} for _ in range(max(li for li, *_ in spec) + 1)]
    off = 0
    for li, k, shape, dtype in spec:
        dt = _HOST_DTYPES[dtype]
        n = int(np.prod(shape, dtype=np.int64))
        planes[li][k] = np.frombuffer(raw, dt, count=n,
                                      offset=off).reshape(shape)
        off += n * dt.itemsize
    return planes


class DevicePage:
    """A demoted page on its way to host memory: its private flat device
    buffer, the planes' layout, and (on the card) an event recorded on the
    owner's stream behind the slice."""

    def __init__(self, flat, spec, staging=None):
        self.flat = flat
        self.spec = spec
        self.staging = staging
        self.ready = None
        if flat.is_cuda:
            self.ready = torch.cuda.Event()
            self.ready.record()

    def to_host(self):
        """The page's host planes (owning numpy arrays): blocking, on the
        copier's thread."""
        if self.flat.is_cuda:
            if self.staging is not None:
                raw = self.staging.download(self.flat, self.ready)
            else:
                self.ready.synchronize()
                raw = self.flat.cpu().numpy()
        else:
            raw = self.flat.numpy().copy()
        self.flat = None
        return _split_planes(raw, self.spec)


class PinnedStaging:
    """A ring of ``slots`` pinned host buffers of ``slot_bytes`` each (see
    module docstring). ``alloc_s`` is the seconds the pinned allocation
    took and ``nbytes`` the bytes pinned. Thread-safe: the copier thread
    downloads and the owner thread uploads through the same ring."""

    def __init__(self, slot_bytes, slots=4):
        t0 = time.perf_counter()
        self._bufs = [torch.empty(int(slot_bytes), dtype=torch.uint8,
                                  pin_memory=True) for _ in range(slots)]
        self.alloc_s = time.perf_counter() - t0
        self.slot_bytes = int(slot_bytes)
        self.nbytes = self.slot_bytes * int(slots)
        self._events = [None] * slots
        self._idle = list(range(slots))
        self._cond = threading.Condition()
        self._streams = {}

    def _acquire(self):
        with self._cond:
            while not self._idle:
                self._cond.wait()
            i = self._idle.pop(0)
            ev, self._events[i] = self._events[i], None
        if ev is not None:
            ev.synchronize()       # the slot's last copy has passed
        return i

    def _release(self, i, event=None):
        with self._cond:
            self._events[i] = event
            self._idle.append(i)
            self._cond.notify()

    def upload(self, planes, device):
        """One page's host planes (``_page_buffer`` order: layers, then
        names sorted) as a flat uint8 tensor on ``device``: packed into a
        pinned slot and copied with ``non_blocking`` on the current
        stream; the slot is released behind an event after that copy."""
        from bigdl_tpu_torch.serving.paging import pack_page
        i = self._acquire()
        try:
            buf = self._bufs[i]
            n = pack_page(planes, buf.numpy()).size
            flat = buf[:n].to(device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
        except BaseException:
            self._release(i)
            raise
        self._release(i, ev)
        return flat

    def download(self, flat, ready):
        """``flat`` (a private device buffer) read back through a pinned
        slot on a side stream that first waits for ``ready``. Returns an
        owning uint8 numpy copy."""
        n = flat.numel()
        i = self._acquire()
        try:
            stream = self._streams.get(flat.device)
            if stream is None:
                stream = torch.cuda.Stream(device=flat.device)
                self._streams[flat.device] = stream
            with torch.cuda.stream(stream):
                stream.wait_event(ready)
                self._bufs[i][:n].copy_(flat, non_blocking=True)
                # the buffer came from the owner's stream: keep its memory
                # from being reused before this stream's read
                flat.record_stream(stream)
                done = torch.cuda.Event()
                done.record(stream)
            done.synchronize()
            return self._bufs[i][:n].numpy().copy()
        finally:
            self._release(i)


class HostPageTier:
    """Bounded host K/V page pool keyed by prefix-chain digest.

    Every method takes ``self._lock`` around shared state; :meth:`stage`
    and :meth:`get` run on the engine's scheduler thread, :meth:`commit`,
    :meth:`abort` and :meth:`ingest` on the copier thread, :meth:`stats`
    and :meth:`hex_digests` from any thread. The checksum in :meth:`get`
    and the read back in :meth:`ingest` run outside the lock."""

    def __init__(self, budget_bytes):
        self.budget_bytes = int(budget_bytes)
        if self.budget_bytes < 1:
            raise ValueError(
                f"host-tier budget must be >= 1 byte, got {budget_bytes}")
        self._lock = threading.Lock()
        self._ids = itertools.count()
        # a page is in EXACTLY one map: staged (the copier owns it, not
        # host-resident yet) or resident (oldest first: the LRU order)
        self._staged = {}                            # eid -> (digests, nbytes)
        self._resident = collections.OrderedDict()  # eid -> entry
        self._index = {}                             # digest -> entry
        self.resident_bytes = 0
        self.inflight_bytes = 0
        self.demoted_pages = 0
        self.evicted_pages = 0
        self.skipped_pages = 0
        self.hits = 0
        self.misses = 0
        self.corrupt_dropped = 0
        # the copier's seconds reading pages back and checksumming them,
        # and the bytes it committed: the demotion rate
        self.ingest_s = 0.0
        self.ingested_bytes = 0

    # ------------------------------------------------------------ demotion
    def stage(self, digests, nbytes):
        """Owner thread: claim a demotion for a page carrying ``digests``.
        Returns the token :meth:`commit` redeems, or None when the copy is
        skipped: no digests, a page larger than the budget, or every
        digest already resident (equal digest, equal planes: the entry is
        LRU-touched instead)."""
        digests = frozenset(digests)
        nbytes = int(nbytes)
        if not digests or nbytes > self.budget_bytes:
            with self._lock:
                self.skipped_pages += 1
            return None
        with self._lock:
            live = [self._index.get(d) for d in digests]
            if all(e is not None for e in live):
                for e in live:
                    self._resident.move_to_end(e["eid"])
                self.skipped_pages += 1
                return None
            eid = next(self._ids)
            self._staged[eid] = (digests, nbytes)
            self.inflight_bytes += nbytes
        return eid

    def commit(self, eid, planes, checksum):
        """Copier thread: the staged page's host copy arrived: move it
        staged -> resident in one lock acquisition and evict the oldest
        resident entries past the byte budget."""
        with self._lock:
            staged = self._staged.pop(eid, None)
            if staged is None:            # aborted or cleared meanwhile
                return
            digests, nbytes = staged
            self.inflight_bytes -= nbytes
            entry = {"eid": eid, "digests": digests, "planes": planes,
                     "nbytes": nbytes, "sum": checksum}
            for d in digests:
                self._index[d] = entry
            self._resident[eid] = entry
            self.resident_bytes += nbytes
            self.demoted_pages += 1
            while (self.resident_bytes > self.budget_bytes
                   and len(self._resident) > 1):
                self._evict_oldest_locked()

    def abort(self, eid):
        """Release a staged claim whose copy failed."""
        with self._lock:
            staged = self._staged.pop(eid, None)
            if staged is not None:
                self.inflight_bytes -= staged[1]
                self.skipped_pages += 1

    def ingest(self, eid, item):
        """Materialise a staged page, ``item`` a :class:`DevicePage` or
        host planes: owning host copy, checksum, then :meth:`commit`. The
        copier thread's whole job (and the synchronous path without one).
        No lock is held until the commit; never raises."""
        t0 = time.perf_counter()
        try:
            host = (item.to_host() if isinstance(item, DevicePage)
                    else _host_copy(item))
            checksum = _planes_checksum(host)
        except BaseException:
            logger.exception("host-tier demotion copy failed (page dropped, "
                             "the stream will re-prefill)")
            self.abort(eid)
            return False
        dt = time.perf_counter() - t0
        with self._lock:
            self.ingest_s += dt
            self.ingested_bytes += sum(a.nbytes for pl in host
                                       for a in pl.values())
        self.commit(eid, host, checksum)
        return True

    def _evict_oldest_locked(self):
        eid, entry = self._resident.popitem(last=False)
        for d in entry["digests"]:
            if self._index.get(d) is entry:
                del self._index[d]
        self.resident_bytes -= entry["nbytes"]
        self.evicted_pages += 1

    # ----------------------------------------------------------- promotion
    def get(self, digest):
        """Promotion probe: the page's host planes, or None on a miss. The
        insert-time checksum is verified on every fetch; a mismatch drops
        the entry and counts it (``corrupt_dropped``)."""
        with self._lock:
            entry = self._index.get(digest)
            if entry is None:
                self.misses += 1
                return None
            self._resident.move_to_end(entry["eid"])
            planes, want = entry["planes"], entry["sum"]
        if _planes_checksum(planes) != want:
            with self._lock:
                if self._resident.pop(entry["eid"], None) is not None:
                    for d in entry["digests"]:
                        if self._index.get(d) is entry:
                            del self._index[d]
                    self.resident_bytes -= entry["nbytes"]
                self.corrupt_dropped += 1
            logger.warning("host-tier page failed its checksum; dropped "
                           "(degrading to the page store / re-prefill)")
            return None
        with self._lock:
            self.hits += 1
        return planes

    def has(self, digest):
        with self._lock:
            return digest in self._index

    def hex_digests(self):
        """Hex digests resident now: ``PageStore.gc`` exempts them, since
        a page whose fast copy is volatile host RAM must keep its durable
        disk copy."""
        with self._lock:
            return {d.hex() for d in self._index}

    # ----------------------------------------------------------- telemetry
    def stats(self):
        """Counters under one lock acquisition (any thread); ``resident``
        and ``inflight`` are disjoint by construction."""
        with self._lock:
            return {
                "budget_bytes": self.budget_bytes,
                "resident_pages": len(self._resident),
                "resident_bytes": self.resident_bytes,
                "inflight_pages": len(self._staged),
                "inflight_bytes": self.inflight_bytes,
                "demoted_pages": self.demoted_pages,
                "evicted_pages": self.evicted_pages,
                "skipped_pages": self.skipped_pages,
                "hits": self.hits,
                "misses": self.misses,
                "corrupt_dropped": self.corrupt_dropped,
                "ingest_s": self.ingest_s,
                "ingested_bytes": self.ingested_bytes,
            }

    def clear(self):
        """Drop every resident page (staged copies still commit)."""
        with self._lock:
            self._resident.clear()
            self._index.clear()
            self.resident_bytes = 0


class HostTierCopier:
    """The demotion copier: drains ``(eid, item)`` work into
    :meth:`HostPageTier.ingest` on its own thread, so the owner thread's
    eviction costs the slice and a queue put. Owned and closed by
    ``ServingEngine``."""

    def __init__(self, tier, device=None):
        self.tier = tier
        self.device = device
        self._work = queue.Queue()
        self._thread = threading.Thread(target=self._copy_loop,
                                        name="bigdl-tpu-torch-kv-hosttier",
                                        daemon=True)
        self._thread.start()

    def submit(self, eid, item):
        """Owner thread: hand a staged page over."""
        self._work.put((eid, item))

    def depth(self):
        """Demotions accepted but not yet copied."""
        return self._work.qsize()

    def drain(self):
        """Block until every demotion submitted so far is resident (or
        dropped): what a caller waits on instead of sleeping."""
        self._work.join()

    def close(self, timeout=5.0):
        """Drain the outstanding demotions and stop the thread. Returns
        False when it is still alive after ``timeout``."""
        self._work.put(None)
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def _copy_loop(self):
        try:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.set_device(self.device)
        except BaseException:
            logger.exception("host-tier copier cannot reach its device; "
                             "demotions will be dropped")
        while True:
            item = self._work.get()
            try:
                if item is None:
                    return
                self.tier.ingest(*item)
            finally:
                self._work.task_done()
