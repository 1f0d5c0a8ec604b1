"""Paged K/V cache: block allocator, page-table decode, prefix sharing
(the port of ``bigdl_tpu/serving/paging.py``).

One global pool of fixed-size pages per layer, ``(num_pages, H,
page_size, D)``, and a per-slot page table of int32 pool indices
(PagedAttention, Kwon et al., SOSP '23). A request holds only the pages
its tokens fill; requests with the same prompt prefix point their tables
at the SAME pages (hash-keyed prefix cache, refcounted, copy-on-write on
a shared boundary page).

Device-side contract (``parallel/sequence.py`` + ``models/gpt.py``):

- the page index ``num_pages`` is the host-side SENTINEL for "no page":
  a write through it is filtered out on the host before the scatter, and
  attention skips it;
- reads go through ``ops.paged_attention``: the hand-written kernel on the
  card, its plain version on the CPU;
- ``int8_kv`` pools hold int8 K/V with a float32 scale per (token, head)
  for each of K and V, quantised on write (``parallel/sequence.py``):
  ``(D + 4) / (4 D)`` of a float32 pool's bytes per token, 3.76x the
  tokens in the same bytes at head_dim 64 (``pages_for_budget``);
- under tensor parallelism (a ``parallel.tensor_parallel`` model) every
  shard holds the same page indices for its ``1/tp`` of the heads, so one
  host page table drives all shards; ``pages_for_budget(tp=)`` turns a
  per-chip byte budget into ``tp`` times the pages.

Chunked prefill (Sarathi-Serve, OSDI '24): admission only *allocates*
(host work); :meth:`PagedSlotManager.prefill_tick` advances up to
``window`` pending prompts by one ``prefill_chunk``-token chunk per
dispatch, interleaved by the scheduler with decode blocks.

Admission failure is TYPED: :class:`PagePoolExhausted`, never junk
tokens.

Speculative decoding (``spec_tokens`` > 1, the dense manager's step over
``GPT.paged_verify_chunk``): every verify write, committed or later
rejected, lands inside the ``block_span`` positions :meth:`reserve_block`
made the slot's own (a shared boundary page copied first), or at a
sentinel entry that drops it, so a rejected proposal never touches a
shared prefix page. Each prefill chunk also clears (on a prompt's first
chunk) and primes the slot's draft row, with the token before the chunk.

The digest ladder (the reference's A.7): a prefix-cache miss at
admission walks the HBM registry, then the host tier
(``serving/host_tier.py``: pages the allocator evicted, demoted to host
RAM by a copier thread), then the on-disk page store
(``serving/snapshot.py``). Pages found below the pool are loaded into
fresh pool pages (:meth:`PagedSlotManager._dispatch_load`) and registered,
so admission degrades to the full-prefix-hit path; every miss, checksum
failure or injected fault degrades to re-prefill, never to wrong K/V. The
host planes of a page are the reference's ``export_pages`` layout: one
dict a layer of full-H numpy arrays (``(H, page_size, D)`` planes and an
int8 pool's ``(H, page_size)`` scale planes), the tp shards' heads joined
in ``ModelLayout`` order, so pages move between tp degrees and between the
two packages.

Multi-tenant LoRA: a stream under an adapter chains its prefix digests
from :func:`chain_seed` of the adapter's digest (``admit_one(seed=)``), so
its pages are never shared with another adapter's or the base model's,
on any rung; its pool row (``adapter_slot``) rides every chunk, step and
verify dispatch (the dense manager's ``adapter_slots``).

Fault sites (``resilience/faults.py``): ``serving.page_alloc`` in
:meth:`PageAllocator.alloc` (presents as :class:`PagePoolExhausted`),
``serving.prefill`` before each chunk dispatch, ``serving.host_swap`` on
the tier's demote and promote paths (an error drops that one swap).
"""

from __future__ import annotations

import collections
import hashlib
import heapq
import itertools
import logging
import time

import numpy as np
import torch

from bigdl_tpu_torch.resilience.faults import FaultError, fault_point
from bigdl_tpu_torch.serving.slots import SlotManager

logger = logging.getLogger("bigdl_tpu_torch.serving")

# prefix digests are chained per token-aligned block from this seed, so a
# block's digest commits to the ENTIRE prefix before it: equal digest
# implies equal (position, token) history and so equal K/V. The seed is
# the reference's, so both packages name the same prefix the same way.
_CHAIN_SEED = b"bigdl-tpu-prefix-v1"


def chain_seed(adapter_digest=None):
    """Chain seed for prefix digests, separated by adapter: a K/V page
    holds activations of (tokens, weights), so requests under different
    LoRA adapters must never share one, even for the same prompt. None
    (the base model) is the historical seed; an adapter's 16-byte digest
    folds in as the reference folds it, so both packages name the same
    pages the same way."""
    if not adapter_digest:
        return _CHAIN_SEED
    return hashlib.blake2b(_CHAIN_SEED + b"adapter:" + adapter_digest,
                           digest_size=16).digest()


# numpy dtypes of the host planes; bfloat16 pages travel as their bits
_HOST_DTYPES = {torch.float32: np.dtype(np.float32),
                torch.float16: np.dtype(np.float16),
                torch.bfloat16: np.dtype(np.uint16),
                torch.int8: np.dtype(np.int8)}


def _to_numpy(t):
    """A CPU tensor as a numpy array (bfloat16 as its uint16 bits; a load
    views the bytes back as the pool's dtype)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def pack_page(planes, out=None):
    """One page's host planes as flat bytes, layers in order and each
    layer's planes by name (the order of ``PagedSlotManager._page_buffer``
    and of its loads): into the uint8 numpy array ``out`` when given (a
    pinned staging slot), else a new one. Returns the bytes written."""
    parts = [np.ascontiguousarray(pl[k]).reshape(-1).view(np.uint8)
             for pl in planes for k in sorted(pl)]
    if out is None:
        return np.concatenate(parts)
    off = 0
    for a in parts:
        out[off:off + a.size] = a
        off += a.size
    return out[:off]


def _block_digest(prev, block):
    return hashlib.blake2b(prev + block.tobytes(), digest_size=16).digest()


def _tail_digest(prev, tail):
    # domain-separated: a partial tail of k tokens must never collide with
    # a full block of the same k tokens
    return hashlib.blake2b(prev + b"tail:" + tail.tobytes(),
                           digest_size=16).digest()


def kv_token_bytes(model, int8=False, dtype=torch.float32):
    """K/V bytes ONE cached token costs across every layer (K + V); an
    int8 pool stores 1 byte an element plus one float32 scale per (token,
    head) for each of K and V."""
    layers = model.gpt.layers
    attn = layers[0].attn
    d = attn.head_dim
    per_head = d + 4 if int8 else d * torch.empty(
        (), dtype=dtype).element_size()
    return 2 * len(layers) * attn.n_heads * per_head


def pages_for_budget(model, page_size, byte_budget, int8=False,
                     dtype=torch.float32, tp=1):
    """The page-pool size that fits ``byte_budget`` bytes of K/V: the knob
    for comparing float and int8 pools at equal device memory (an int8
    pool holds ``4 D / (D + 4)`` times a float32 pool's pages, 3.76x at
    head_dim 64; about 1.9x against bfloat16).

    ``byte_budget`` is per chip: with ``tp > 1`` each shard holds ``1/tp``
    of the heads, so the same budget buys ``tp`` times the pages (``tp <=
    1`` is the unsharded math)."""
    tp = max(1, int(tp))
    per_tok = kv_token_bytes(model, int8, dtype) // tp
    return int(byte_budget) // (per_tok * int(page_size))


class PagePoolExhausted(RuntimeError):
    """No free (or reclaimable) K/V pages for the allocation — a typed
    admission/reservation failure the scheduler turns into queueing,
    preemption, or a clean per-request error."""


class PageAllocator:
    """Host-side bookkeeping for the global page pool: free list,
    refcounts, and the hash-keyed prefix cache. It never touches device
    memory.

    A page is *free* (on the lowest-first heap), *live* (``refcount >
    0``; shared prefix pages have refcount > 1) or *reclaimable*
    (``refcount == 0`` but still registered in the prefix cache, in LRU
    order): :meth:`alloc` evicts reclaimable pages only after the free
    list runs dry, dropping their cache entries.

    ``demote_hook(page, digests)``, when given, fires on each eviction
    before the page's registrations drop: the host tier's swap-out path.
    It must never raise into ``alloc``.
    """

    def __init__(self, num_pages, demote_hook=None):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        self.num_pages = int(num_pages)
        self.demote_hook = demote_hook
        self._free = list(range(self.num_pages))
        heapq.heapify(self._free)
        self.refcount = np.zeros(self.num_pages, np.int64)
        self._registry = {}                             # digest -> page
        self._page_keys = collections.defaultdict(set)  # page -> digests
        self._reclaimable = collections.OrderedDict()   # page -> None (LRU)
        self.evictions = 0

    def available(self):
        """Pages :meth:`alloc` could hand out now (free + reclaimable)."""
        return len(self._free) + len(self._reclaimable)

    def in_use(self):
        """Pages referenced by at least one live slot."""
        return self.num_pages - self.available()

    def lookup(self, digest):
        """Prefix-cache probe: the page registered under ``digest``, or
        None. Does NOT claim it — call :meth:`incref` to."""
        return self._registry.get(digest)

    def alloc(self, n, **ctx):
        """Claim ``n`` pages (refcount 1 each); raises
        :class:`PagePoolExhausted` when the pool cannot supply them. The
        ``serving.page_alloc`` fault site fires here and presents as that
        exhaustion, so an injected fault takes a full pool's path."""
        try:
            fault_point("serving.page_alloc", n=n, **ctx)
        except FaultError as e:
            raise PagePoolExhausted(
                f"injected page-pool exhaustion at serving.page_alloc "
                f"({n} page(s) requested)") from e
        if n > self.available():
            raise PagePoolExhausted(
                f"{n} page(s) requested but only {self.available()} of "
                f"{self.num_pages} available ({len(self._free)} free, "
                f"{len(self._reclaimable)} reclaimable)")
        got = []
        for _ in range(n):
            if self._free:
                page = heapq.heappop(self._free)
            else:
                # free list dry: evict the least-recently-retired cached
                # prefix page and drop its registrations; with a host tier
                # its K/V demotes instead of vanishing
                page, _ = self._reclaimable.popitem(last=False)
                if self.demote_hook is not None:
                    digests = set(self._page_keys.get(page, ()))
                    if digests:
                        try:
                            self.demote_hook(int(page), digests)
                        except BaseException:
                            logger.exception("host-tier demote hook failed "
                                             "for page %d (page dropped)",
                                             page)
                self.invalidate_page(page)
                self.evictions += 1
            self.refcount[page] = 1
            got.append(int(page))
        return got

    def incref(self, page):
        """Add a reference (prefix sharing); resurrects a reclaimable
        cached page without touching its contents."""
        if self.refcount[page] == 0:
            self._reclaimable.pop(page, None)
        self.refcount[page] += 1

    def decref(self, page):
        """Drop a reference; at zero the page becomes reclaimable (still
        registered) or free (not registered)."""
        if self.refcount[page] <= 0:
            raise ValueError(f"decref of unreferenced page {page}")
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            if self._page_keys.get(page):
                self._reclaimable[page] = None   # newest LRU position
            else:
                heapq.heappush(self._free, int(page))

    def register(self, digest, page):
        """Publish ``page`` as holding the prefix ``digest`` (first writer
        wins)."""
        if digest in self._registry:
            return
        self._registry[digest] = int(page)
        self._page_keys[page].add(digest)

    def invalidate_page(self, page):
        """Drop every cache entry naming ``page``."""
        for digest in self._page_keys.pop(page, set()):
            self._registry.pop(digest, None)

    def registered(self):
        """``[(digest, page)]`` of the prefix cache: what a snapshot pass
        persists."""
        return list(self._registry.items())


class PagedSlotManager(SlotManager):
    """Slot table over the paged pool (see module docstring), with:

    - :meth:`admit_one` — host-only admission: page allocation + prefix
      match; the prompt joins the *pending* set, no dispatch;
    - :meth:`prefill_tick` — one dispatch advancing up to ``window``
      pending prompts by one ``prefill_chunk``-token chunk each;
    - :meth:`reserve_block` — pre-decode page reservation for the next
      ``block_span`` positions of every active slot (allocates new
      pages, copy-on-writes shared boundary pages);
    - :meth:`step` — ``steps_per_sync`` decode steps (or speculative
      iterations) across every slot;
    - :meth:`pool_stats` — occupancy / fragmentation / prefix-cache
      counters.

    Device state: the per-layer pools and the (slots, vocab) logits table
    stay on the device; the host tables (``page_table``, ``lengths``,
    ``active``, ``temps``) are copied in at every dispatch. The sampler's
    gumbel noise comes from a ``torch.Generator`` on the device, seeded
    with ``seed``. ``int8_kv`` allocates int8 pools with scale planes.

    A tensor-parallel model (``parallel.tensor_parallel``) carries its
    ``layout``: each shard's pools live on its device, the logits table
    and the sampler's generator on the first shard's.

    The lower rungs of the digest ladder (see module docstring):
    ``page_store`` (a ``snapshot.PageStore``) is probed on prefix-cache
    misses; ``host_tier`` (a ``host_tier.HostPageTier``) receives evicted
    pages through the allocator's demote hook, handed to ``host_demote``
    (the copier's ``submit``; without one the copy is synchronous) and is
    probed before the store; ``host_staging`` (a
    ``host_tier.PinnedStaging``) stages pages between host and card;
    ``host_tier_prefetch`` pages a scheduler iteration are promoted ahead
    of the waiting queue's head. ``restored_pages`` counts pages loaded
    from the store and ``host_promoted_pages`` from the tier;
    ``last_admit_shared`` / ``last_admit_total`` are the last admission's
    shared and total prompt tokens.
    """

    paged = True
    _stat_keys = ("prefill_chunks", "steps", "copies", "loads")
    _obs_name = "serving_paged"

    def __init__(self, model, max_slots, num_pages=None, page_size=16,
                 window=4, steps_per_sync=1, prefill_chunk=64,
                 prefix_cache=True, top_k=None, top_p=None, seed=0,
                 int8_kv=False, spec_tokens=1, page_store=None,
                 host_tier=None, host_demote=None, host_tier_prefetch=0,
                 host_staging=None, adapter_pool=None):
        pmax = model.gpt.max_position
        self.page_size = int(page_size)
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if pmax % self.page_size:
            raise ValueError(f"max_position ({pmax}) must be a multiple of "
                             f"page_size ({self.page_size})")
        self.pages_per_slot = pmax // self.page_size
        if num_pages is None:
            # dense-equivalent budget by default
            num_pages = int(max_slots) * self.pages_per_slot
        self.num_pages = int(num_pages)
        if self.num_pages < self.pages_per_slot:
            raise ValueError(
                f"num_pages ({self.num_pages}) cannot hold even one "
                f"max-length stream ({self.pages_per_slot} pages)")
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.prefix_cache = bool(prefix_cache)
        self.int8_kv = bool(int8_kv)
        self.page_store = page_store
        self.restore_active = False
        self.restore_ended = 0.0      # time.monotonic() of the last restore
        self.restored_pages = 0
        self.last_admit_shared = 0
        self.last_admit_total = 0
        self.host_tier = host_tier
        self._host_demote = host_demote
        self.host_tier_prefetch = int(host_tier_prefetch or 0)
        self.host_staging = host_staging
        self.host_promoted_pages = 0
        self.swap_stall_s = 0.0
        super().__init__(model, max_slots, window=window,
                         steps_per_sync=steps_per_sync, top_k=top_k,
                         top_p=top_p, seed=seed, spec_tokens=spec_tokens,
                         adapter_pool=adapter_pool)

    def _alloc(self):
        self._alloc_host()
        gpt = self.model.gpt
        self._pools = gpt.init_paged_pool(
            self.num_pages, self.page_size,
            torch.int8 if self.int8_kv else None)
        # every plane of every shard, the int8 pool's scale planes
        # included; per chip: measured from the first shard's planes
        planes = gpt.pool_planes(self._pools)
        page_bytes = [sum(v[0].numel() * v.element_size() for v in shard)
                      for shard in planes]
        self._kv_token_bytes = sum(page_bytes) // self.page_size
        self._kv_token_bytes_per_chip = page_bytes[0] // self.page_size
        # one page's full-H host planes: per layer {name: (shape, dtype)}
        shards = self._shard_pools()
        self._page_spec = [
            {k: ((v.shape[1] * self.tp,) + tuple(v.shape[2:]),
                 _HOST_DTYPES[v.dtype]) for k, v in pl.items()}
            for pl in shards[0]]
        # sentinel-filled: rows of free/pageless slots write nowhere
        self.page_table = np.full((self.max_slots, self.pages_per_slot),
                                  self.num_pages, np.int32)
        self.allocator = PageAllocator(
            self.num_pages,
            demote_hook=(self._demote_page if self.host_tier is not None
                         else None))
        self._pending = collections.OrderedDict()   # slot -> prefill state
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_hit_tokens = 0
        self.prefix_miss_tokens = 0
        self.cow_copies = 0
        self._pool_snapshot = self._compute_pool_stats()

    def _shard_pools(self):
        """The pools as one per-layer list per shard."""
        return self._pools if self.sharded else [self._pools]

    def warm_kernels(self):
        """The sampler's and this pool's paged-attention kernel (float or
        int8), on the card only."""
        super().warm_kernels()
        if self.device.type != "cuda":
            return
        from bigdl_tpu_torch.ops import _build
        from bigdl_tpu_torch.ops import paged_attention as pa
        if self.int8_kv:
            _build.load("paged_attention_int8", pa._declare_int8)
        else:
            _build.load("paged_attention", pa._declare)

    # ---------------------------------------------------- device dispatches
    @torch.no_grad()
    def _chunk(self, page_table, ids, start, nvalid, write_from,
               slot_final, arows):
        """One chunked-prefill dispatch (``arows`` each row's adapter pool
        row); the rows whose final chunk this is (``slot_final <
        max_slots``) write their next-token logits into their slot's
        logits row."""
        gpt = self.model.gpt
        try:
            h_last, self._pools = gpt.paged_prefill_chunk(
                self._pools, page_table, ids, start, nvalid, write_from,
                self.page_size, lora=self._lora(arows))
            rows = np.nonzero(slot_final < self.max_slots)[0]
            if rows.size:
                dev = self.device
                self._logits[
                    torch.from_numpy(slot_final[rows]).to(dev).long()] \
                    = self.model._lm_logits(
                        h_last[torch.from_numpy(rows).to(dev)]
                    ).to(self._dtype)
        except BaseException:
            self.poisoned = True
            raise
        self.stats.tick("prefill_chunks")

    def _decode(self, tok, pos):
        """One decode step of every slot through the page tables. Inactive
        rows must not write through their tables: a pending (mid-prefill)
        slot already owns pages the junk step would corrupt, so their rows
        become all-sentinel."""
        table = np.where(self.active[:, None], self.page_table,
                         self.num_pages).astype(np.int32)
        h, self._pools = self.model.gpt.paged_decode_step(
            self._pools, table, tok, pos, self.page_size,
            lora=self._lora(self.adapter_slots))
        return h

    def _verify(self, props, pos):
        """One verify chunk of every slot through the page tables, inactive
        rows all-sentinel as in :meth:`_decode`."""
        table = np.where(self.active[:, None], self.page_table,
                         self.num_pages).astype(np.int32)
        h, self._pools = self.model.gpt.paged_verify_chunk(
            self._pools, table, props, pos, self.page_size,
            lora=self._lora(self.adapter_slots))
        return h

    @torch.no_grad()
    def _dispatch_copy(self, src, dst):
        """Copy-on-write: duplicate page ``src`` into ``dst`` in every
        layer's pools, in every shard."""
        try:
            for shard in self.model.gpt.pool_planes(self._pools):
                for v in shard:
                    v[dst].copy_(v[src])
        except BaseException:
            self.poisoned = True
            raise
        self.stats.tick("copies")
        if self._cost is not None:       # a page read and a page written
            self.stats.add_cost(0.0, 2 * self._kv_token_bytes
                                * self.page_size)

    # ------------------------------------------------------------ admission
    def _match_prefix(self, a, seed=None):
        """Longest token-aligned shared prefix of prompt ``a``: walks the
        chained block digests (from ``seed``, the stream's
        :func:`chain_seed`; None: the base model's) through the prefix
        cache and, with a host tier or page store attached, restores the
        missing run from them (:meth:`_restore_pages`), then tries the
        partial tail. Returns ``(digests, tail_dig, shared_pages,
        shared_full, tail_shared)``; ``shared_pages`` are NOT yet
        claimed."""
        ps = self.page_size
        n_full = a.size // ps
        digests, prev = [], seed or chain_seed()
        for b in range(n_full):
            prev = _block_digest(prev, a[b * ps:(b + 1) * ps])
            digests.append(prev)
        tail = a[n_full * ps:]
        tail_dig = _tail_digest(prev, tail) if tail.size else None
        if not self.prefix_cache:
            return digests, tail_dig, [], 0, False
        shared_pages, shared_full = [], 0
        # a restore allocates, and so may evict reclaimable pages this walk
        # already collected: with a lower rung attached each match is
        # pinned for the walk. restore_active is up while restore I/O is
        # possible (the supervisor extends its wedge grace)
        pin = self.page_store is not None or self.host_tier is not None
        tail_shared = False
        try:
            for b in range(n_full):
                page = self.allocator.lookup(digests[b])
                if page is None:
                    break
                if pin:
                    self.allocator.incref(page)
                shared_pages.append(page)
                shared_full = b + 1
            if pin and shared_full < n_full:
                self.restore_active = True
                for page in self._restore_pages(digests[shared_full:n_full]):
                    self.allocator.incref(page)
                    shared_pages.append(page)
                    shared_full += 1
            if tail_dig is not None and shared_full == n_full:
                page = self.allocator.lookup(tail_dig)
                if page is None and pin:
                    self.restore_active = True
                    pages = self._restore_pages([tail_dig])
                    page = pages[0] if pages else None
                if page is not None:
                    if pin:
                        self.allocator.incref(page)
                    shared_pages.append(page)
                    tail_shared = True
        finally:
            if pin:
                for page in shared_pages:
                    self.allocator.decref(page)
            if self.restore_active:
                self._end_restore()
        return digests, tail_dig, shared_pages, shared_full, tail_shared

    def _end_restore(self):
        """The end of a restore, which counts as the loop's progress: the
        supervisor's wedge check reads ``restore_ended`` beside the
        heartbeat (the loop beats again only after the rest of its
        iteration), stamped before ``restore_active`` falls so no poll
        sees the grace gone and the stamp missing."""
        self.restore_ended = time.monotonic()
        self.restore_active = False

    # --------------------------------------------------- the digest ladder
    def _restore_pages(self, digests):
        """Fetch a consecutive run of demoted or snapshotted pages by
        digest into fresh pool pages with one load
        (:meth:`_dispatch_load`), registering each (reclaimable, like a
        retired cached page: the caller's ``incref`` claims it). Each
        digest walks the lower rungs (:meth:`_fetch_restore`); the run
        stops at the first miss, checksum failure, injected fault or plane
        layout mismatch, and at the pool's spare capacity less one page.
        A digest still registered mid-run (LRU eviction does not follow
        chain order) reuses its live page. Returns the pages restored or
        reused: a prefix of ``digests``."""
        plan = []          # (digest, planes | None, from_tier, page | None)
        loads = 0
        spare = max(0, self.allocator.available() - 1)
        for digest in digests:
            page = self.allocator.lookup(digest)
            if page is not None:
                plan.append((digest, None, False, page))
                continue
            if loads >= spare:
                break
            planes, from_tier = self._fetch_restore(digest)
            if planes is None or not self._planes_compatible(planes):
                break
            plan.append((digest, planes, from_tier, None))
            loads += 1
        if not plan:
            return []
        reused = [e[3] for e in plan if e[3] is not None]
        for page in reused:
            self.allocator.incref(page)  # pinned: the alloc must not evict
        try:
            fresh = []
            if loads:
                try:
                    fresh = self.allocator.alloc(loads, restore=True)
                except PagePoolExhausted:
                    # keep the already-live leading run, drop the loads
                    plan = list(itertools.takewhile(
                        lambda e: e[3] is not None, plan))
                    return [e[3] for e in plan]
                try:
                    self._dispatch_load(
                        fresh, [pl for _, pl, _, pg in plan if pg is None])
                except BaseException:
                    for page in fresh:
                        self.allocator.decref(page)
                    raise
            out, it = [], iter(fresh)
            for digest, _, from_tier, page in plan:
                if page is None:
                    page = next(it)
                    self.allocator.register(digest, page)
                    self.allocator.decref(page)  # cached until claimed
                    if from_tier:
                        self.host_promoted_pages += 1
                    else:
                        self.restored_pages += 1
                out.append(page)
            return out
        finally:
            for page in reused:
                self.allocator.decref(page)

    def _fetch_restore(self, digest):
        """The lower rungs for one digest the registry missed: the host
        tier (checksum verified in ``HostPageTier.get``; a corrupt buffer
        is dropped there), then the page store. Returns ``(planes,
        from_tier)``, ``(None, False)`` on a full miss. The
        ``serving.host_swap`` site fires on the tier probe; an injected
        error presents as a tier miss."""
        if self.host_tier is not None:
            t0 = time.perf_counter()
            try:
                fault_point("serving.host_swap", op="promote")
                planes = self.host_tier.get(digest)
            except FaultError as e:
                logger.warning("injected host-swap promote fault "
                               "(presenting as a tier miss): %r", e)
                planes = None
            self.swap_stall_s += time.perf_counter() - t0
            if planes is not None:
                return planes, True
        if self.page_store is not None:
            planes = self.page_store.get(digest)
            if planes is not None:
                return planes, False
        return None, False

    def _page_buffer(self, page):
        """A private copy of one page's full-H planes (every layer, every
        plane, the shards' heads joined) as ONE flat uint8 tensor on the
        first shard's device, made on the current stream, so it is in
        stream order before any later write to the page: the tier's copier
        reads only this buffer, never the pool (a page's next owner may
        write it at once). Returns ``(flat, spec)``, ``spec`` the
        ``(layer, name, shape, dtype)`` of each plane in order. The heads
        are a plane's outermost axis, so its full-H bytes are the shards'
        bytes one after another: one copy (the final ``cat``) a page."""
        shards = self._shard_pools()
        parts, spec = [], []
        for li, pl in enumerate(shards[0]):
            for k in sorted(pl):
                parts.extend(sh[li][k][page].reshape(-1).view(torch.uint8)
                             .to(self.device) for sh in shards)
                spec.append((li, k, self._page_spec[li][k][0],
                             pl[k].dtype))
        return torch.cat(parts), spec

    def _demote_page(self, page, digests):
        """The allocator's demote hook (owner thread, before the evicted
        page's registrations drop): stage the page into the host tier. The
        owner thread only slices the page into a private buffer
        (:meth:`_page_buffer`) and hands it over; the copier thread reads
        it back to host memory and checksums it, overlapped with the next
        dispatch. Never raises into ``alloc``."""
        tier = self.host_tier
        if tier is None:
            return
        t0 = time.perf_counter()
        eid = None
        try:
            fault_point("serving.host_swap", op="demote", page=int(page))
            eid = tier.stage(digests, self._kv_token_bytes * self.page_size)
            if eid is None:
                return
            item = self._device_page(page)
        except FaultError as e:
            logger.warning("injected host-swap demote fault (page "
                           "dropped): %r", e)
            if eid is not None:
                tier.abort(eid)
            return
        except BaseException:
            logger.exception("host-tier demote staging failed (page "
                             "dropped)")
            if eid is not None:
                tier.abort(eid)
            return
        finally:
            self.swap_stall_s += time.perf_counter() - t0
        if self._host_demote is not None:
            self._host_demote(eid, item)
        else:
            tier.ingest(eid, item)       # synchronous (no copier)

    def _device_page(self, page):
        from bigdl_tpu_torch.serving.host_tier import DevicePage
        flat, spec = self._page_buffer(page)
        return DevicePage(flat, spec, self.host_staging)

    def preserve_stream(self, tokens, slot, seed=None):
        """Swap-aware preemption (owner thread, the scheduler's
        ``_preempt``): register the about-to-be-retired stream's written
        full-block (and exact-tail) digests, so retirement leaves its pages
        reclaimable instead of free: pool pressure then demotes them
        through the host tier, and the resume admission hits a full prefix
        instead of re-prefilling its context (``seed``: the stream's
        :func:`chain_seed`). Returns the pages newly registered."""
        if self.host_tier is None or not self.prefix_cache \
                or not self.active[slot]:
            return 0
        a = np.asarray(tokens, np.int32).reshape(-1)
        t = min(a.size, int(self.lengths[slot]))
        row = self.page_table[slot]
        ps, sentinel = self.page_size, self.num_pages
        n_full = t // ps
        count = 0
        prev = seed or chain_seed()
        for b in range(n_full):
            prev = _block_digest(prev, a[b * ps:(b + 1) * ps])
            page = int(row[b])
            if page != sentinel and self.allocator.lookup(prev) is None:
                self.allocator.register(prev, page)
                count += 1
        tail = a[n_full * ps:t]
        if tail.size and n_full < self.pages_per_slot:
            page = int(row[n_full])
            tail_dig = _tail_digest(prev, tail)
            if page != sentinel \
                    and self.allocator.lookup(tail_dig) is None:
                self.allocator.register(tail_dig, page)
                count += 1
        return count

    def prefetch_prefix(self, tokens, limit, seed=None):
        """Swap-in prefetch (owner thread): promote up to ``limit`` of this
        prompt's missing full-block pages from the host tier or the store
        into the pool before its admission (registered reclaimable; LRU
        order keeps them until the admission claims them; ``seed``: the
        prompt's :func:`chain_seed`). Returns the pages promoted."""
        if self.host_tier is None or not self.prefix_cache or limit <= 0:
            return 0
        a = np.asarray(tokens, np.int32).reshape(-1)
        ps = self.page_size
        n_full = a.size // ps
        digests, prev = [], seed or chain_seed()
        for b in range(n_full):
            prev = _block_digest(prev, a[b * ps:(b + 1) * ps])
            digests.append(prev)
        start = 0
        while start < n_full \
                and self.allocator.lookup(digests[start]) is not None:
            start += 1
        run = digests[start:start + int(limit)]
        if not run:
            return 0
        self.restore_active = True
        try:
            pages = self._restore_pages(run)
        finally:
            self._end_restore()
            self._refresh_pool_stats()
        return len(pages)

    def _planes_compatible(self, planes):
        """A page written under another pool layout (page size, dtype,
        int8 scale planes, layer count, heads) presents as a miss and
        never reaches the load."""
        if len(planes) != len(self._page_spec):
            return False
        for got, want in zip(planes, self._page_spec):
            if set(got) != set(want):
                return False
            for k, a in got.items():
                shape, dtype = want[k]
                if tuple(a.shape) != shape or np.dtype(a.dtype) != dtype:
                    return False
        return True

    @torch.no_grad()
    def _dispatch_load(self, pages, planes_list):
        """Write a batch of host pages (full-H planes) into pool pages
        ``pages``, every shard its heads: each page packed flat
        (:func:`pack_page`, the :meth:`_page_buffer` order), the pages
        stacked, then one ``index_copy_`` a plane and shard for the whole
        batch. On the card each page goes through a pinned staging slot
        (``host_staging``) and one ``non_blocking`` copy; the slot is
        reused only after an event recorded behind that copy has passed,
        so the card never reads a staging buffer being refilled. A failure
        poisons the pools."""
        try:
            if self.device.type == "cuda" and self.host_staging is not None:
                flats = [self.host_staging.upload(planes, self.device)
                         for planes in planes_list]
            else:
                flats = [torch.from_numpy(pack_page(planes)).to(self.device)
                         for planes in planes_list]
            stacked = torch.stack(flats)
            shards = self._shard_pools()
            off = 0
            for li, pl in enumerate(shards[0]):
                for k in sorted(pl):
                    shape = self._page_spec[li][k][0]
                    n = int(np.prod(shape)) * pl[k].element_size()
                    full = stacked[:, off:off + n].contiguous().view(
                        pl[k].dtype).view((len(pages),) + shape)
                    h = pl[k].shape[1]
                    for s, sh in enumerate(shards):
                        dst = sh[li][k]
                        dst.index_copy_(
                            0, torch.as_tensor(pages, device=dst.device),
                            full[:, s * h:(s + 1) * h].to(dst.device))
                    off += n
        except BaseException:
            self.poisoned = True
            raise
        self.stats.tick("loads")
        if self._cost is not None:       # the pages written
            self.stats.add_cost(0.0, len(pages) * self._kv_token_bytes
                                * self.page_size)

    @torch.no_grad()
    def export_pages(self, extra=(), skip=None):
        """Owner thread only: host copies of every registered prefix-cache
        page plus the ``extra`` ``(digest, page)`` pairs (a snapshot pass
        passes the full-block pages of live streams); ``skip(digest)``
        filters pages already persisted before any copy. Returns
        ``[(digest, planes)]``, ``planes`` one dict a layer of full-H
        numpy arrays that own their memory (gathered with
        ``index_select``, so no array aliases the pool), safe for the
        snapshot writer's thread."""
        pairs = [(d, int(p)) for d, p in
                 itertools.chain(self.allocator.registered(), extra)
                 if skip is None or not skip(d)]
        if not pairs:
            return []
        pages = sorted({p for _, p in pairs})
        row = {p: i for i, p in enumerate(pages)}
        shards = self._shard_pools()
        host = [[{} for _ in shards[0]] for _ in pages]
        for li, pl in enumerate(shards[0]):
            for k in pl:
                parts = [sh[li][k].index_select(0, torch.as_tensor(
                    pages, device=sh[li][k].device)).cpu() for sh in shards]
                arr = _to_numpy(torch.cat(parts, 1) if len(parts) > 1
                                else parts[0])
                for i in range(len(pages)):
                    host[i][li][k] = arr[i]
        seen, out = set(), []
        for digest, page in pairs:
            if digest not in seen:
                seen.add(digest)
                out.append((digest, host[row[page]]))
        return out

    def admit_one(self, prompt, temperature=0.0, adapter_slot=0, seed=None):
        """Admit ONE prompt: prefix match + page allocation + slot claim
        — host work, no dispatch. The prompt becomes *pending*;
        :meth:`prefill_tick` runs its chunks. ``adapter_slot`` is the
        adapter pool row the stream runs under (0: the base model) and
        ``seed`` its :func:`chain_seed`. Returns the slot id. Raises
        :class:`PagePoolExhausted` (nothing leaked) when the pool cannot
        hold the unshared part of the prompt."""
        a = np.asarray(prompt, np.int32).reshape(-1)
        t = a.size
        if t < 1:
            raise ValueError("empty prompt")
        if t > self.max_position - 1:
            raise ValueError(
                f"prompt of {t} tokens exceeds the slot capacity of "
                f"{self.max_position - 1} (max_position "
                f"{self.max_position} minus one generated token)")
        if not self._free:
            raise ValueError("no free slot")
        ps = self.page_size
        n_full = t // ps
        need_pages = -(-t // ps)
        digests, tail_dig, shared_pages, shared_full, tail_shared = \
            self._match_prefix(a, seed)
        shared_len = t if tail_shared or (shared_full == n_full
                                          and not t % ps) \
            else shared_full * ps
        # claim the matched pages FIRST so alloc's LRU eviction cannot
        # steal them; roll back if alloc fails
        for page in shared_pages:
            self.allocator.incref(page)
        try:
            new_pages = self.allocator.alloc(need_pages - len(shared_pages),
                                             prompt_tokens=t)
        except BaseException:
            for page in shared_pages:
                self.allocator.decref(page)
            raise
        slot = heapq.heappop(self._free)
        self._occupied += 1
        row = self.page_table[slot]
        row[:len(shared_pages)] = shared_pages
        row[len(shared_pages):need_pages] = new_pages
        if shared_len == t:
            # full prefix hit: nothing to write — one logits-only chunk
            # replays the last position through the shared pages
            next_pos, write_from = t - 1, t
        else:
            next_pos = write_from = shared_len
        self._pending[slot] = {
            "tokens": a, "total": t, "next": next_pos,
            "write_from": write_from, "temp": float(temperature or 0.0),
            "digests": digests, "tail_dig": tail_dig,
            "shared_full": shared_full, "tail_shared": tail_shared,
        }
        self.adapter_slots[slot] = int(adapter_slot)
        if shared_len:
            self.prefix_hits += 1
        else:
            self.prefix_misses += 1
        self.prefix_hit_tokens += shared_len
        self.prefix_miss_tokens += t - shared_len
        self.last_admit_shared = int(shared_len)
        self.last_admit_total = int(t)
        self._refresh_pool_stats()
        return int(slot)

    def pending_prefills(self):
        """Prompts admitted but not yet fully prefilled."""
        return len(self._pending)

    def prefill_tick(self):
        """Advance up to ``window`` pending prompts by one chunk each in
        ONE dispatch; prompts whose final chunk lands become active.
        Returns the number of prompts still pending."""
        if not self._pending:
            return 0
        w, c, p = self.window, self.prefill_chunk, self.pages_per_slot
        rows = list(itertools.islice(self._pending.items(), w))
        fault_point("serving.prefill", n=len(rows))
        ids = np.zeros((w, c), np.int32)
        start = np.zeros(w, np.int32)
        nvalid = np.ones(w, np.int32)
        # padding rows: write_from == max_position suppresses every write,
        # and their sentinel table rows attend to nothing
        write_from = np.full(w, self.max_position, np.int32)
        slot_final = np.full(w, self.max_slots, np.int32)
        pt = np.full((w, p), self.num_pages, np.int32)
        # the draft's rows (padding: max_slots, dropped), the token before
        # each chunk (vocab_size: none), and the slots whose first chunk
        # this is (their draft rows are cleared first)
        prime_rows = np.full(w, self.max_slots)
        prime_prev = np.full(w, self.model.vocab_size)
        arows = np.zeros(w, np.int32)        # padding rows: the base model
        clear = []
        finished = []
        for i, (s, st) in enumerate(rows):
            n = min(c, st["total"] - st["next"])
            ids[i, :n] = st["tokens"][st["next"]:st["next"] + n]
            start[i] = st["next"]
            nvalid[i] = n
            write_from[i] = st["write_from"]
            pt[i] = self.page_table[s]
            arows[i] = self.adapter_slots[s]
            prime_rows[i] = s
            if st["next"] > 0:
                prime_prev[i] = st["tokens"][st["next"] - 1]
            if not st.get("primed"):
                clear.append(s)
                st["primed"] = True
            if st["next"] + n >= st["total"]:
                slot_final[i] = s
                finished.append((s, st))
        self._chunk(pt, ids, start, nvalid, write_from, slot_final, arows)
        self._add_cost([(int(start[i]), int(nvalid[i]))
                        for i in range(len(rows))], len(finished))
        self._prime(ids, nvalid, prime_rows, prime_prev, clear)
        for i, (s, st) in enumerate(rows):
            st["next"] = min(st["next"] + int(nvalid[i]), st["total"])
        for s, st in finished:
            self._finalize_prefill(s, st)
        self._refresh_pool_stats()
        return len(self._pending)

    def _finalize_prefill(self, slot, st):
        """The prompt's last chunk landed: register its privately written
        pages in the prefix cache and flip the slot active."""
        del self._pending[slot]
        if self.prefix_cache:
            row = self.page_table[slot]
            n_full = st["total"] // self.page_size
            for b in range(st["shared_full"], n_full):
                self.allocator.register(st["digests"][b], row[b])
            if st["tail_dig"] is not None and not st["tail_shared"]:
                self.allocator.register(st["tail_dig"], row[n_full])
        self.lengths[slot] = st["total"]
        self.active[slot] = True
        self.temps[slot] = st["temp"]
        self._last_tok[slot] = st["tokens"][-1]

    def admit(self, prompts, temperatures=None, adapter_slots=None,
              seeds=None):
        """Batch admission: admit each prompt (under its ``adapter_slots``
        row and ``seeds`` chain seed, when given) and drive its chunks to
        completion before the next, so identical prefixes share pages.
        Returns the assigned slots."""
        if len(prompts) > min(self.window, self.free_slots()):
            raise ValueError(
                f"admit batch of {len(prompts)} exceeds window "
                f"{self.window} / free slots {self.free_slots()}")
        assigned = []
        for i, prompt in enumerate(prompts):
            temp = 0.0 if temperatures is None else float(temperatures[i])
            arow = 0 if adapter_slots is None else int(adapter_slots[i])
            seed = None if seeds is None else seeds[i]
            assigned.append(self.admit_one(prompt, temp, adapter_slot=arow,
                                           seed=seed))
            while self.prefill_tick():
                pass
        return assigned

    # --------------------------------------------------------------- decode
    def reserve_block(self):
        """Guarantee pages for the next ``block_span`` positions of every
        active slot: allocate pages for fresh positions and copy-on-write
        a shared boundary page before the slot writes into it. Raises
        :class:`PagePoolExhausted` when the pool runs out; pages already
        granted stay in the tables, so the call can be retried after the
        scheduler frees pages."""
        ps, sentinel = self.page_size, self.num_pages
        for s in np.nonzero(self.active)[0]:
            lo = int(self.lengths[s])
            hi = min(lo + self.block_span, self.max_position)
            if lo >= hi:
                continue
            row = self.page_table[s]
            first_pi = lo // ps
            page = int(row[first_pi])
            if page != sentinel and self.allocator.refcount[page] > 1:
                # the boundary page is shared: writing position `lo` into
                # it would corrupt the other holders — copy it
                (fresh,) = self.allocator.alloc(1, slot=int(s), cow=True)
                self._dispatch_copy(page, fresh)
                self.allocator.decref(page)
                row[first_pi] = fresh
                self.cow_copies += 1
            for pi in range(first_pi, (hi - 1) // ps + 1):
                if row[pi] == sentinel:
                    (fresh,) = self.allocator.alloc(1, slot=int(s))
                    row[pi] = fresh
        self._refresh_pool_stats()

    def step(self):
        """One block of ``steps_per_sync`` decode steps across every slot
        (call :meth:`reserve_block` first). Returns host tokens of shape
        (steps_per_sync, max_slots), rows of inactive slots junk, or the
        speculative block with ``last_counts`` (the dense manager's
        :meth:`~SlotManager.step`)."""
        toks = super().step()
        self._refresh_pool_stats()
        return toks

    def retire(self, slot):
        """Free a slot — active OR still pending — returning its page
        references to the allocator. Pages it registered stay
        reclaimable for future prefix hits."""
        if self.active[slot]:
            self.active[slot] = False
        elif slot in self._pending:
            del self._pending[slot]
        else:
            raise ValueError(f"slot {slot} is not active")
        row = self.page_table[slot]
        for page in row[row != self.num_pages]:
            self.allocator.decref(int(page))
        row[:] = self.num_pages
        self.lengths[slot] = 0
        self.temps[slot] = 0.0
        self.adapter_slots[slot] = 0
        heapq.heappush(self._free, int(slot))
        self._occupied -= 1
        self._refresh_pool_stats()

    # ------------------------------------------------------------ telemetry
    def pool_stats(self):
        """Page-pool occupancy, fragmentation and prefix-cache counters:
        the snapshot the owner thread rebinds after every mutation, safe
        to read from any thread."""
        return self._pool_snapshot

    def _refresh_pool_stats(self):
        self._pool_snapshot = self._compute_pool_stats()

    def _compute_pool_stats(self):
        a = self.allocator
        in_use = a.in_use()
        frag = 0
        for s in range(self.max_slots):
            n_pages = int((self.page_table[s] != self.num_pages).sum())
            if not n_pages:
                continue
            used = (int(self.lengths[s]) if self.active[s]
                    else int(self._pending[s]["next"])
                    if s in self._pending else 0)
            frag += n_pages * self.page_size - used
        out = {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "kv_dtype": ("int8" if self.int8_kv
                         else str(self._dtype).replace("torch.", "")),
            "kv_bytes_per_token": self._kv_token_bytes,
            "pool_bytes": self._kv_token_bytes * self.page_size
            * self.num_pages,
            # what ONE shard holds (one chip's share when each shard has
            # its own card); the unsharded numbers at tp=1
            "tp_degree": self.tp,
            "kv_bytes_per_token_per_chip": self._kv_token_bytes_per_chip,
            "pool_bytes_per_chip": self._kv_token_bytes_per_chip
            * self.page_size * self.num_pages,
            "pages_in_use": in_use,
            "pages_free": len(a._free),
            "pages_reclaimable": len(a._reclaimable),
            "page_occupancy": in_use / self.num_pages,
            "fragmentation_tokens": frag,
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_miss_tokens": self.prefix_miss_tokens,
            "prefix_evictions": a.evictions,
            "cow_copies": self.cow_copies,
            "restored_pages": self.restored_pages,
        }
        if self.host_tier is not None:
            for k, v in self.host_tier.stats().items():
                out["host_tier_" + k] = v
            out["host_tier_promoted_pages"] = self.host_promoted_pages
            out["host_tier_swap_stall_s"] = self.swap_stall_s
            if self.host_staging is not None:
                out["host_tier_pinned_bytes"] = self.host_staging.nbytes
                out["host_tier_pin_alloc_s"] = self.host_staging.alloc_s
        return out
