"""Crash-consistent serving recovery: the K/V page store and the request
journal (the port of ``bigdl_tpu/serving/snapshot.py``).

The paged K/V page is the unit of persistence: the chained blake2b page
digests (``paging._block_digest`` / ``_tail_digest``) already give
dedupe, integrity and a restore key.

:class:`PageStore`
    Content-addressed page files keyed by prefix digest, each file's
    blake2b payload checksum in an atomically renamed ``MANIFEST.json``. A
    mismatch (a torn write, an injected ``serving.snapshot_write``
    corruption) demotes the entry: deleted and counted, never served.

:class:`RequestJournal`
    A write-ahead log of admitted requests and their delivered-token
    chunks (offset-stamped, so replay is idempotent and never
    double-delivers). Retired streams are tombstoned and compacted out.

:class:`KVSnapshot`
    The coordinator an engine owns: rate-limits snapshot passes, takes
    host copies of pages on the owner thread
    (``PagedSlotManager.export_pages``) and hands them to one writer
    thread, and ties journal retirement to the release of store pins.

The file formats are the reference's: ``MANIFEST.json``
(``{"v": 1, "seq", "pages": {hex: {"sum", "seq"}}}``), page files
``pages/<hex>.page`` (magic ``BDKV1``, a JSON plane header, the raw
plane bytes) and the JSONL journal (``admit`` / ``tok`` / ``ret``
records). The planes are one dict a layer of full-H arrays. A store or
journal written by either package restores in the other.

Restore-first recovery: a re-admission walks its context's digest chain;
blocks missing from the prefix cache come from the store, checksum
verified, loaded into fresh pool pages and registered, so admission
becomes a full prefix hit (one logits-only chunk) instead of a re-prefill.
Any miss, checksum failure or injected ``serving.snapshot_restore`` fault
falls back to re-prefill for that stream.

Default off behind ``BIGDL_TPU_KV_SNAPSHOT`` (with
``BIGDL_TPU_SNAPSHOT_DIR`` and ``BIGDL_TPU_SNAPSHOT_INTERVAL_S``): see
``ServingEngine``. The counters are the plain attributes
``pages_written``, ``pages_restored``, ``corrupt_dropped``,
``restore_misses`` and ``write_errors``; the first three and the store's
page count also go to the reference's obs families
(``bigdl_snapshot_*``).
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time

import numpy as np

from bigdl_tpu_torch import obs
from bigdl_tpu_torch.resilience.faults import (FaultError, corrupt_file,
                                               fault_point)

logger = logging.getLogger("bigdl_tpu_torch.serving")

_MANIFEST = "MANIFEST.json"
_PAGES_DIR = "pages"
_JOURNAL = "journal.jsonl"


class SnapshotError(RuntimeError):
    """A snapshot store operation failed (bad directory, injected
    write fault); snapshotting is best-effort and callers degrade to
    the re-prefill path, never to junk tokens."""


def chain_digests(tokens, page_size, seed=None):
    """The chained full-block digests of a token sequence — the restore
    keys for the K/V pages holding positions ``[b*ps, (b+1)*ps)``.
    Identical (by construction) to the digests ``PagedSlotManager``
    computes at admission, so a snapshot taken from one engine's page
    tables is addressable from any other engine's admission walk.
    ``seed`` overrides the chain seed (a stream under a LoRA adapter
    chains from :func:`paging.chain_seed` of its digest; None: the base
    model's chain)."""
    from bigdl_tpu_torch.serving.paging import _block_digest, chain_seed
    a = np.asarray(tokens, np.int32).reshape(-1)
    ps = int(page_size)
    out, prev = [], (seed or chain_seed())
    for b in range(a.size // ps):
        prev = _block_digest(prev, a[b * ps:(b + 1) * ps])
        out.append(prev)
    return out


def _planes_checksum(planes):
    """blake2b over every plane's bytes in deterministic (layer, key)
    order — computed from the arrays themselves, not the container
    file, so any on-disk mangling (header damage OR payload bit flips)
    fails verification on load."""
    import hashlib
    h = hashlib.blake2b(digest_size=16)
    for li, pl in enumerate(planes):
        for k in sorted(pl):
            a = np.ascontiguousarray(pl[k])
            h.update(f"{li}:{k}:{a.dtype.str}:{a.shape}".encode())
            h.update(a.tobytes())
    return h.hexdigest()


_PAGE_MAGIC = b"BDKV1\n"


def _pack_planes(planes):
    """Flat page-file encoding: magic, 4-byte LE header length, JSON
    header ``[[(key, dtype, shape), ...] per layer]``, then the raw
    plane bytes in header order. One ``read`` + ``np.frombuffer`` per
    restore instead of npz's per-member zip walk (~10x cheaper on the
    small arrays a K/V page holds)."""
    header = [[(k, pl[k].dtype.str, list(pl[k].shape))
               for k in sorted(pl)] for pl in planes]
    hdr = json.dumps(header).encode()
    parts = [_PAGE_MAGIC, len(hdr).to_bytes(4, "little"), hdr]
    for pl in planes:
        for k in sorted(pl):
            parts.append(np.ascontiguousarray(pl[k]).tobytes())
    return b"".join(parts)


def _unpack_planes(buf):
    """Inverse of :func:`_pack_planes`. Raises on any structural damage
    (bad magic, torn header, truncated or trailing payload) — the
    caller demotes, exactly like a checksum mismatch. The returned
    arrays are read-only views over ``buf``."""
    if buf[:len(_PAGE_MAGIC)] != _PAGE_MAGIC:
        raise ValueError("bad page magic")
    off = len(_PAGE_MAGIC)
    hlen = int.from_bytes(buf[off:off + 4], "little")
    off += 4
    header = json.loads(buf[off:off + hlen].decode())
    off += hlen
    planes = []
    for layer in header:
        pl = {}
        for k, dstr, shape in layer:
            dt = np.dtype(dstr)
            n = int(np.prod(shape, dtype=np.int64)) if shape else 1
            pl[k] = np.frombuffer(
                buf, dt, count=n, offset=off).reshape(shape)
            off += dt.itemsize * n
        planes.append(pl)
    if off != len(buf):
        raise ValueError("trailing bytes in page file")
    return planes


class PageStore:
    """Content-addressed, checksummed on-disk K/V page snapshots.

    Layout: ``root/pages/<digest-hex>.page`` (one flat binary file per
    page — JSON plane header + raw bytes, readable with a single
    ``read`` + ``np.frombuffer`` because restore latency IS the product
    here) plus ``root/MANIFEST.json`` mapping
    digest to payload checksum — both written tmp-then-``os.replace``
    so a crash mid-write can only lose the newest pages, never corrupt
    the old ones silently (a torn page file fails its checksum and is
    demoted on first read).

    Thread contract: ``put_batch`` runs on the coordinator's writer
    thread; ``get``/``pin``/``release``/``gc`` on whichever thread is
    restoring (the scheduler loop) — one lock serializes manifest
    mutation. The arrays handed to ``put_batch`` must already OWN their
    memory (``export_pages`` copies): the writer thread must never hold
    a view of a live pool.
    """

    def __init__(self, root):
        self.root = str(root)
        self._pages = os.path.join(self.root, _PAGES_DIR)
        os.makedirs(self._pages, exist_ok=True)
        self._lock = threading.Lock()
        self._seq = 0
        self._disk_sig = None             # (mtime_ns, size) last merged
        self._manifest = {}               # digest-hex -> {"sum", "seq"}
        self._pins = {}                   # rid -> set(digest-hex)
        # optional callable -> hex digests resident in the volatile host
        # tier (serving/host_tier.py); gc exempts them so a swapped-out
        # page never loses its only durable copy to the cap
        self.tier_resident = None
        self.pages_written = 0
        self.pages_restored = 0
        self.corrupt_dropped = 0
        self.restore_misses = 0
        self.write_errors = 0
        self._obs = {
            "written": obs.counter(
                "bigdl_snapshot_pages_written_total",
                "K/V pages persisted to the snapshot store"),
            "restored": obs.counter(
                "bigdl_snapshot_pages_restored_total",
                "K/V pages restored from the snapshot store"),
            "corrupt": obs.counter(
                "bigdl_snapshot_corrupt_dropped_total",
                "snapshot pages demoted on checksum/read failure"),
            "pages": obs.gauge(
                "bigdl_snapshot_store_pages",
                "pages currently held by the snapshot store"),
        }
        self._load_manifest()

    # ---------------------------------------------------------- manifest --
    def _load_manifest(self):
        with self._lock:
            self._merge_disk_locked()
            self._obs["pages"].set(len(self._manifest))

    def _merge_disk_locked(self):
        """Fold the ON-DISK manifest into the in-memory one (lock held).

        Fleet replicas share one store directory — the store is
        multi-writer — so the disk manifest may carry pages a SIBLING
        engine persisted after we last read it; cross-replica failover
        restores exactly those. One ``stat`` makes the unchanged case
        free; in-memory entries win per digest; entries whose page file
        vanished (a sibling's demote/gc) are skipped. Two writers racing
        read-merge-write can still drop each other's newest index
        entries — that loss degrades to a restore miss, never to wrong
        K/V (the page files themselves are content-addressed and
        checksummed)."""
        path = os.path.join(self.root, _MANIFEST)
        try:
            st = os.stat(path)
        except OSError:
            return
        sig = (st.st_mtime_ns, st.st_size)
        if sig == self._disk_sig:
            return
        self._disk_sig = sig
        try:
            with open(path, "r", encoding="utf-8") as f:
                data = json.load(f)
            entries = data.get("pages", {})
            self._seq = max(self._seq, int(data.get("seq", 0)))
        except (json.JSONDecodeError, OSError, ValueError) as e:
            # a torn manifest orphans its page files (safe: they are
            # simply unreachable until re-snapshotted) — never crash
            logger.warning("snapshot manifest unreadable (%r); "
                           "keeping in-memory view", e)
            return
        for hexd, ent in entries.items():
            if hexd in self._manifest:
                continue
            try:
                rec = {"sum": ent["sum"], "seq": int(ent.get("seq", 0))}
            except (KeyError, TypeError, ValueError):
                continue
            if os.path.exists(self._page_path(hexd)):
                self._manifest[hexd] = rec

    def _write_manifest_locked(self):
        # multi-writer courtesy: fold sibling entries in before the
        # replace, so one fleet replica's write doesn't orphan another's
        self._merge_disk_locked()
        path = os.path.join(self.root, _MANIFEST)
        # per-writer tmp name: sibling stores over the same directory
        # each rename their OWN tmp — a shared ".tmp" lets writer B's
        # replace yank writer A's tmp out from underneath it
        tmp = f"{path}.{os.getpid()}.{id(self):x}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"v": 1, "seq": self._seq,
                       "pages": self._manifest}, f)
        os.replace(tmp, path)
        try:
            st = os.stat(path)
            self._disk_sig = (st.st_mtime_ns, st.st_size)
        except OSError:
            self._disk_sig = None
        self._obs["pages"].set(len(self._manifest))

    def _page_path(self, hexd):
        return os.path.join(self._pages, hexd + ".page")

    # ------------------------------------------------------------ writes --
    def has(self, digest):
        with self._lock:
            hexd = digest.hex()
            if hexd not in self._manifest:
                self._merge_disk_locked()
            return hexd in self._manifest

    def __len__(self):
        with self._lock:
            return len(self._manifest)

    def digests(self):
        with self._lock:
            return {bytes.fromhex(h) for h in self._manifest}

    def put_batch(self, items):
        """Persist ``[(digest, planes)]``; one atomic manifest update
        for the whole batch. Per-page failures (injected
        ``serving.snapshot_write`` errors, disk trouble) skip that page
        and continue — snapshotting is best-effort. Returns the number
        of pages written."""
        written = {}
        for digest, planes in items:
            hexd = digest.hex()
            try:
                fault_point("serving.snapshot_write", digest=hexd)
                checksum = _planes_checksum(planes)
                path = self._page_path(hexd)
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(_pack_planes(planes))
                os.replace(tmp, path)
                # post-rename so an injected corruption models a torn
                # write that SURVIVED the rename — exactly what the
                # checksum ladder must catch on restore
                corrupt_file("serving.snapshot_write", path)
            except (FaultError, OSError) as e:
                self.write_errors += 1
                logger.warning("snapshot write of page %s failed: %r",
                               hexd[:12], e)
                continue
            written[hexd] = checksum
        if not written:
            return 0
        with self._lock:
            for hexd, checksum in written.items():
                self._seq += 1
                self._manifest[hexd] = {"sum": checksum, "seq": self._seq}
            self.pages_written += len(written)
            self._write_manifest_locked()
        self._obs["written"].inc(len(written))
        return len(written)

    # ----------------------------------------------------------- restore --
    def get(self, digest):
        """Fetch one page's planes by digest, or None on miss. A page
        that fails its checksum (or cannot be parsed at all) is DEMOTED
        — file deleted, manifest entry dropped, counted — so a corrupt
        snapshot degrades to a prefix-cache miss, never to wrong K/V.
        The ``serving.snapshot_restore`` fault site fires here; an
        injected error also presents as a miss (the per-stream fallback
        is the re-prefill path either way)."""
        hexd = digest.hex()
        try:
            fault_point("serving.snapshot_restore", digest=hexd)
        except FaultError as e:
            logger.warning("injected restore fault for page %s: %r",
                           hexd[:12], e)
            self.restore_misses += 1
            return None
        with self._lock:
            ent = self._manifest.get(hexd)
            if ent is None:
                # a sibling engine sharing this store directory may
                # have persisted the page after our last read — the
                # cross-replica failover restore path lands here
                self._merge_disk_locked()
                ent = self._manifest.get(hexd)
        if ent is None:
            self.restore_misses += 1
            return None
        path = self._page_path(hexd)
        try:
            with open(path, "rb") as f:
                planes = _unpack_planes(f.read())
            ok = _planes_checksum(planes) == ent["sum"]
        except Exception as e:               # torn file, bad header, ...
            logger.warning("snapshot page %s unreadable: %r",
                           hexd[:12], e)
            ok, planes = False, None
        if not ok:
            self._demote(hexd)
            return None
        with self._lock:
            # LRU touch: restored pages are hot, evict them last
            self._seq += 1
            ent["seq"] = self._seq
            self.pages_restored += 1
        self._obs["restored"].inc()
        return planes

    def _demote(self, hexd):
        """Corrupt-snapshot ladder: delete + forget + count (the
        ``_reload_latest`` treatment for checkpoints)."""
        logger.warning("demoting corrupt snapshot page %s", hexd[:12])
        with self._lock:
            self._manifest.pop(hexd, None)
            self.corrupt_dropped += 1
            try:
                os.remove(self._page_path(hexd))
            except OSError:
                pass
            self._write_manifest_locked()
        self._obs["corrupt"].inc()

    # ------------------------------------------------------- pins and gc --
    def pin(self, rid, digests):
        """Mark ``digests`` as needed by live stream ``rid`` — pinned
        pages are exempt from :meth:`gc` until :meth:`release`."""
        with self._lock:
            self._pins[int(rid)] = {d.hex() for d in digests}

    def release(self, rid):
        with self._lock:
            self._pins.pop(int(rid), None)

    def pinned_streams(self):
        with self._lock:
            return len(self._pins)

    def gc(self, max_pages):
        """Evict oldest unpinned entries until at most ``max_pages``
        remain — the store-side half of the bounded-growth contract
        (the journal side is compaction; the cap is
        ``BIGDL_TPU_KV_SNAPSHOT_GC_PAGES``, default 4x the pool).
        Digests the host tier reports resident are exempt alongside the
        pins: host RAM is volatile, so for a swapped-out page this store
        holds the only durable copy. Returns pages evicted."""
        with self._lock:
            excess = len(self._manifest) - int(max_pages)
            if excess <= 0:
                return 0
            pinned = set().union(*self._pins.values()) if self._pins \
                else set()
            if self.tier_resident is not None:
                try:
                    pinned = pinned | set(self.tier_resident())
                except BaseException:
                    logger.exception("host-tier residency probe failed "
                                     "(gc proceeds without exemptions)")
            victims = sorted(
                (h for h in self._manifest if h not in pinned),
                key=lambda h: self._manifest[h]["seq"])[:excess]
            for hexd in victims:
                del self._manifest[hexd]
                try:
                    os.remove(self._page_path(hexd))
                except OSError:
                    pass
            if victims:
                self._write_manifest_locked()
        if victims:
            logger.info("snapshot store gc evicted %d page(s)",
                        len(victims))
        return len(victims)


class RequestJournal:
    """Write-ahead log of admitted requests and delivered tokens.

    JSONL records: ``admit`` (prompt + generation parameters), ``tok``
    (an offset-stamped delivered chunk — replay applies a chunk only at
    exactly its offset, so replaying a journal twice, or a journal
    whose tail duplicates a chunk, can never double-deliver a token),
    and ``ret`` (tombstone). When tombstoned records outnumber
    ``compact_min`` and half the file, the journal is compacted: live
    entries rewritten tmp-then-rename, dead ones dropped — a
    long-running engine's WAL stays proportional to its LIVE streams.

    Thread-safe; appends flush to the OS on every record (the failure
    model is engine/process loss, not kernel loss — matching the
    checkpoint writer's durability level).
    """

    def __init__(self, path, compact_min=64):
        self.path = str(path)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._lock = threading.Lock()
        self._live = {}                   # rid -> entry dict
        self._records = 0                 # records in the on-disk file
        self._dead = 0                    # records belonging to retired rids
        self.compact_min = int(compact_min)
        self.compactions = 0
        if os.path.exists(self.path):
            self._recover_existing()
        self._fh = open(self.path, "a", encoding="utf-8")

    def _recover_existing(self):
        replayed = self.replay(self.path)
        for e in replayed.values():
            e["_recs"] = 1 + (1 if e["tokens"] else 0)
        self._live = replayed
        # start compacted: carry only live state forward
        self._rewrite(replayed)

    # ------------------------------------------------------------ writes --
    def _append_locked(self, rec):
        # tolerate writes after close(): an ABANDONED wedged scheduler
        # thread can wake mid-admission long after the supervisor shut
        # its engine down — its journal traffic must vanish, not raise
        if self._fh.closed:
            return
        self._fh.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._fh.flush()
        self._records += 1

    def admit(self, rid, prompt, max_new_tokens, temperature=0.0,
              eos_token=None, adapter=None, trace=None):
        """Journal an admission (idempotent per rid — recovery
        re-placement re-admits the same request). ``adapter`` is the
        request's adapter reference (digest hex / registered name), so
        a replayed stream resumes under the SAME weights it was
        generating under — never silently under the base model.
        ``trace`` is the request's trace id, carried through so a
        journal-reconstructed stream keeps it. The record is the
        reference's, adapter and trace fields included."""
        rid = int(rid)
        with self._lock:
            if self._fh.closed or rid in self._live:
                return
            entry = {"prompt": [int(t) for t in np.asarray(prompt).ravel()],
                     "max_new_tokens": int(max_new_tokens),
                     "temperature": float(temperature),
                     "eos": None if eos_token is None else int(eos_token),
                     "adapter": None if adapter is None else str(adapter),
                     "trace": None if trace is None else str(trace),
                     "tokens": [], "_recs": 1}
            self._live[rid] = entry
            self._append_locked({"op": "admit", "rid": rid,
                                 "prompt": entry["prompt"],
                                 "max_new_tokens": entry["max_new_tokens"],
                                 "temperature": entry["temperature"],
                                 "eos": entry["eos"],
                                 "adapter": entry["adapter"],
                                 "trace": entry["trace"]})

    def delivered(self, rid, offset, chunk):
        """Journal a delivered chunk at its stream offset."""
        rid = int(rid)
        chunk = [int(t) for t in chunk]
        if not chunk:
            return
        with self._lock:
            entry = self._live.get(rid)
            if entry is None or self._fh.closed:
                return
            if int(offset) == len(entry["tokens"]):
                entry["tokens"].extend(chunk)
            entry["_recs"] += 1
            self._append_locked({"op": "tok", "rid": rid,
                                 "off": int(offset), "toks": chunk})

    def retire(self, rid):
        """Tombstone a finished stream (completed, truncated-force-
        retired, cancelled, expired, quarantined or failed) and compact
        when the dead fraction crosses the threshold."""
        rid = int(rid)
        with self._lock:
            if self._fh.closed or rid not in self._live:
                return
            entry = self._live.pop(rid)
            self._append_locked({"op": "ret", "rid": rid})
            # every record of the retired rid is now dead weight: its
            # admit, its delivered chunks, and the tombstone itself
            self._dead += entry["_recs"] + 1
            if (self._records >= self.compact_min
                    and self._dead * 2 >= self._records):
                self._compact_locked()

    def _compact_locked(self):
        self._fh.close()
        self._rewrite(self._live)
        for e in self._live.values():
            e["_recs"] = 1 + (1 if e["tokens"] else 0)
        self._fh = open(self.path, "a", encoding="utf-8")
        self.compactions += 1

    def _rewrite(self, live):
        tmp = self.path + ".tmp"
        n = 0
        with open(tmp, "w", encoding="utf-8") as f:
            for rid, e in live.items():
                f.write(json.dumps(
                    {"op": "admit", "rid": rid, "prompt": e["prompt"],
                     "max_new_tokens": e["max_new_tokens"],
                     "temperature": e["temperature"], "eos": e["eos"],
                     "adapter": e.get("adapter"),
                     "trace": e.get("trace")},
                    separators=(",", ":")) + "\n")
                n += 1
                if e["tokens"]:
                    f.write(json.dumps(
                        {"op": "tok", "rid": rid, "off": 0,
                         "toks": e["tokens"]},
                        separators=(",", ":")) + "\n")
                    n += 1
        os.replace(tmp, self.path)
        self._records, self._dead = n, 0

    # ----------------------------------------------------------- queries --
    def live(self):
        """{rid: entry} snapshot of journaled, unretired streams."""
        with self._lock:
            out = {}
            for rid, e in self._live.items():
                copy = dict(e, tokens=list(e["tokens"]))
                copy.pop("_recs", None)
                out[rid] = copy
            return out

    def record_count(self):
        with self._lock:
            return self._records

    def close(self):
        with self._lock:
            try:
                self._fh.close()
            except OSError:
                pass

    @staticmethod
    def replay(path):
        """Rebuild {rid: entry} from a journal file — tolerant of a torn
        final line (the crash wrote half a record: everything before it
        is intact). Offset-checked chunk application makes replay
        idempotent: a chunk at an offset already covered is dropped, so
        no token can ever be double-delivered through the journal."""
        live = {}
        try:
            fh = open(path, "r", encoding="utf-8")
        except FileNotFoundError:
            return live
        with fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    logger.warning("journal: dropping torn record")
                    continue
                op, rid = rec.get("op"), rec.get("rid")
                if op == "admit" and rid not in live:
                    live[rid] = {"prompt": rec["prompt"],
                                 "max_new_tokens": rec["max_new_tokens"],
                                 "temperature": rec.get("temperature", 0.0),
                                 "eos": rec.get("eos"),
                                 "adapter": rec.get("adapter"),
                                 "trace": rec.get("trace"),
                                 "tokens": []}
                elif op == "tok" and rid in live:
                    e = live[rid]
                    off, toks = int(rec["off"]), rec["toks"]
                    have = len(e["tokens"])
                    if off <= have < off + len(toks):
                        e["tokens"].extend(toks[have - off:])
                elif op == "ret":
                    live.pop(rid, None)
        return live


def requests_from_journal(entries):
    """Reconstruct fresh ``Request`` handles from journaled live-stream
    entries (``RequestJournal.live()`` / ``replay()`` output) — the
    fleet-failover backstop for streams whose replica died without
    handing over live handles. Each reconstruction carries its
    journaled tokens: ``result()`` returns the full sequence, the
    stream yields the delivered prefix as one catch-up chunk, and
    re-admission resumes from ``context()`` at exactly the journaled
    offset — never re-generating a delivered token. Entries already at
    their token budget are skipped (nothing left to generate)."""
    from bigdl_tpu_torch.serving.scheduler import Request
    out = []
    for rid in sorted(entries):
        e = entries[rid]
        delivered = [int(t) for t in e.get("tokens", ())]
        eos = e.get("eos")
        if (len(delivered) >= int(e["max_new_tokens"])
                or (eos is not None and int(eos) in delivered)):
            continue
        r = Request(e["prompt"], e["max_new_tokens"],
                    temperature=e.get("temperature", 0.0),
                    eos_token=e.get("eos"), adapter=e.get("adapter"))
        # adoption continues the ORIGINAL trace (cross-replica span link
        # is emitted by the router when it resubmits the handle)
        r.trace = e.get("trace")
        if delivered:
            r.tokens.extend(delivered)
            r._stream.put(list(delivered))
        out.append(r)
    return out


class KVSnapshot:
    """The engine-side coordinator tying :class:`PageStore` and
    :class:`RequestJournal` together (see module docstring).

    The scheduler loop calls :meth:`snapshot` after delivery; when
    ``interval_s`` has elapsed it extracts candidate pages ON THE OWNER
    THREAD (``PagedSlotManager.export_pages``: host copies gathered with
    ``index_select``, so the arrays outlive the pool's next writes) and hands
    them to this object's single background writer thread, which
    checksums, writes, and garbage-collects. Journal hooks
    (:meth:`admit` / :meth:`delivered` / :meth:`retire`) are cheap
    appends on the scheduler thread; retire also releases the stream's
    store pins so gc can reclaim its pages.
    """

    def __init__(self, directory, interval_s=0.5, max_pages=None,
                 journal_compact_min=64, journal_name=None):
        self.directory = str(directory)
        self.interval_s = float(interval_s)
        self.max_pages = None if max_pages is None else int(max_pages)
        self.store = PageStore(self.directory)
        # fleet replicas SHARE the page store directory (cross-replica
        # restore keys on content digests) but must each own a journal:
        # RequestJournal's open-time compaction os.replace()s the file,
        # which would orphan a sibling engine's append handle — so give
        # each replica its own journal_name over the common store
        self.journal = RequestJournal(
            os.path.join(self.directory, journal_name or _JOURNAL),
            compact_min=journal_compact_min)
        self._last = 0.0
        self._queued = set()              # digests enqueued, not yet on disk
        self._qlock = threading.Lock()
        self._work = queue.Queue()
        self._closed = False
        self._writer = threading.Thread(target=self._write_loop,
                                        name="bigdl-tpu-kv-snapshot",
                                        daemon=True)
        self._writer.start()

    # ----------------------------------------------------------- journal --
    def admit(self, request):
        # journal the content digest when admission resolved one (it is
        # the stable cross-engine reference), else the raw caller ref
        ref = getattr(request, "adapter_digest", None) \
            or getattr(request, "adapter", None)
        if isinstance(ref, bytes):
            ref = ref.hex()
        self.journal.admit(request.id, request.prompt,
                           request.max_new_tokens, request.temperature,
                           request.eos_token, adapter=ref,
                           trace=getattr(request, "trace", None))

    def delivered(self, request, offset, chunk):
        self.journal.delivered(request.id, offset, chunk)

    def retire(self, rid):
        self.journal.retire(rid)
        self.store.release(rid)

    # ---------------------------------------------------------- snapshot --
    def due(self):
        return time.monotonic() - self._last >= self.interval_s

    def snapshot(self, slots, streams=(), force=False):
        """One snapshot pass (scheduler/owner thread only): select the
        registered prefix-cache pages plus every FULL block page of the
        live ``streams`` (``(rid, context_tokens, slot)`` triples, or
        4-tuples with a trailing per-stream chain ``seed`` for
        adapter-separated digests — full blocks are append-immutable
        while the slot owns them), skip what the store already has,
        extract owning host copies, and enqueue them for the writer
        thread. Returns pages queued."""
        if self._closed:
            # a second shutdown pass (supervisor evacuation, then the
            # monitor's own teardown) must not enqueue work the joined
            # writer will never drain — flush() would block on it
            return 0
        if not force and not self.due():
            return 0
        self._last = time.monotonic()
        with self._qlock:
            queued = set(self._queued)

        def skip(digest):
            return digest in queued or self.store.has(digest)

        ps = int(slots.page_size)
        sentinel = slots.num_pages
        extra = []
        for entry in streams:
            rid, tokens, slot = entry[0], entry[1], entry[2]
            seed = entry[3] if len(entry) > 3 else None
            tokens = np.asarray(tokens, np.int32).reshape(-1)
            covered = min(tokens.size, int(slots.lengths[slot]))
            digs = chain_digests(tokens[:covered], ps, seed=seed)
            self.store.pin(rid, digs)
            row = slots.page_table[slot]
            for b, dig in enumerate(digs):
                if row[b] != sentinel:
                    extra.append((dig, int(row[b])))
        items = slots.export_pages(extra=extra, skip=skip)
        if not items:
            return 0
        with self._qlock:
            self._queued.update(d for d, _ in items)
        self._work.put(items)
        return len(items)

    def _write_loop(self):
        while True:
            batch = self._work.get()
            if batch is None:
                self._work.task_done()
                return
            try:
                self.store.put_batch(batch)
                if self.max_pages is not None:
                    self.store.gc(self.max_pages)
            except BaseException:
                logger.exception("snapshot writer pass failed "
                                 "(serving unaffected)")
            finally:
                with self._qlock:
                    self._queued.difference_update(d for d, _ in batch)
                self._work.task_done()

    def flush(self, timeout=30.0):
        """Block until every queued batch is on disk (tests / clean
        shutdown). Returns False on timeout."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._qlock:
                if not self._queued and self._work.unfinished_tasks == 0:
                    return True
            time.sleep(0.005)
        return False

    def close(self, timeout=5.0):
        if self._closed:
            return
        self._closed = True
        self._work.put(None)
        self._writer.join(timeout)
        self.journal.close()
