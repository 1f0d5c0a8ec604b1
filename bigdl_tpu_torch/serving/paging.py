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

Not ported yet (ROADMAP queue A): speculative decoding, the host tier,
the snapshot page store.
"""

from __future__ import annotations

import collections
import hashlib
import heapq
import itertools

import numpy as np
import torch

from bigdl_tpu_torch.serving.slots import SlotManager

# prefix digests are chained per token-aligned block from this seed, so a
# block's digest commits to the ENTIRE prefix before it: equal digest
# implies equal (position, token) history and so equal K/V. The seed is
# the reference's, so both packages name the same prefix the same way.
_CHAIN_SEED = b"bigdl-tpu-prefix-v1"


def chain_seed():
    """Chain seed for prefix digests (the base model's; the reference
    also separates LoRA adapters here, which are not ported yet)."""
    return _CHAIN_SEED


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
    """

    def __init__(self, num_pages):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        self.num_pages = int(num_pages)
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

    def alloc(self, n):
        """Claim ``n`` pages (refcount 1 each); raises
        :class:`PagePoolExhausted` when the pool cannot supply them."""
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
                # prefix page and drop its registrations
                page, _ = self._reclaimable.popitem(last=False)
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


class PagedSlotManager(SlotManager):
    """Slot table over the paged pool (see module docstring), with:

    - :meth:`admit_one` — host-only admission: page allocation + prefix
      match; the prompt joins the *pending* set, no dispatch;
    - :meth:`prefill_tick` — one dispatch advancing up to ``window``
      pending prompts by one ``prefill_chunk``-token chunk each;
    - :meth:`reserve_block` — pre-decode page reservation for the next
      ``steps_per_sync`` positions of every active slot (allocates new
      pages, copy-on-writes shared boundary pages);
    - :meth:`step` — ``steps_per_sync`` decode steps across every slot,
      one token readback per block;
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
    """

    paged = True
    _stat_keys = ("prefill_chunks", "steps", "copies")

    def __init__(self, model, max_slots, num_pages=None, page_size=16,
                 window=4, steps_per_sync=1, prefill_chunk=64,
                 prefix_cache=True, top_k=None, top_p=None, seed=0,
                 int8_kv=False):
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
        super().__init__(model, max_slots, window=window,
                         steps_per_sync=steps_per_sync, top_k=top_k,
                         top_p=top_p, seed=seed)

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
        # sentinel-filled: rows of free/pageless slots write nowhere
        self.page_table = np.full((self.max_slots, self.pages_per_slot),
                                  self.num_pages, np.int32)
        self.allocator = PageAllocator(self.num_pages)
        self._pending = collections.OrderedDict()   # slot -> prefill state
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_hit_tokens = 0
        self.prefix_miss_tokens = 0
        self.cow_copies = 0
        self._pool_snapshot = self._compute_pool_stats()

    # ---------------------------------------------------- device dispatches
    @torch.no_grad()
    def _chunk(self, page_table, ids, start, nvalid, write_from,
               slot_final):
        """One chunked-prefill dispatch; the rows whose final chunk this
        is (``slot_final < max_slots``) write their next-token logits
        into their slot's logits row."""
        gpt = self.model.gpt
        h_last, self._pools = gpt.paged_prefill_chunk(
            self._pools, page_table, ids, start, nvalid, write_from,
            self.page_size)
        rows = np.nonzero(slot_final < self.max_slots)[0]
        if rows.size:
            dev = self.device
            self._logits[torch.from_numpy(slot_final[rows]).to(dev).long()] \
                = self.model._lm_logits(
                    h_last[torch.from_numpy(rows).to(dev)]
                ).to(self._dtype)
        self.stats.tick("prefill_chunks")

    def _decode(self, tok, pos):
        """One decode step of every slot through the page tables. Inactive
        rows must not write through their tables: a pending (mid-prefill)
        slot already owns pages the junk step would corrupt, so their rows
        become all-sentinel."""
        table = np.where(self.active[:, None], self.page_table,
                         self.num_pages).astype(np.int32)
        h, self._pools = self.model.gpt.paged_decode_step(
            self._pools, table, tok, pos, self.page_size)
        return h

    @torch.no_grad()
    def _dispatch_copy(self, src, dst):
        """Copy-on-write: duplicate page ``src`` into ``dst`` in every
        layer's pools, in every shard."""
        for shard in self.model.gpt.pool_planes(self._pools):
            for v in shard:
                v[dst].copy_(v[src])
        self.stats.tick("copies")

    # ------------------------------------------------------------ admission
    def _match_prefix(self, a):
        """Longest token-aligned shared prefix of prompt ``a``: walks the
        chained block digests through the cache, then tries the partial
        tail. Returns ``(digests, tail_dig, shared_pages, shared_full,
        tail_shared)``; ``shared_pages`` are NOT yet claimed."""
        ps = self.page_size
        n_full = a.size // ps
        digests, prev = [], chain_seed()
        for b in range(n_full):
            prev = _block_digest(prev, a[b * ps:(b + 1) * ps])
            digests.append(prev)
        tail = a[n_full * ps:]
        tail_dig = _tail_digest(prev, tail) if tail.size else None
        if not self.prefix_cache:
            return digests, tail_dig, [], 0, False
        shared_pages, shared_full = [], 0
        for b in range(n_full):
            page = self.allocator.lookup(digests[b])
            if page is None:
                break
            shared_pages.append(page)
            shared_full = b + 1
        tail_shared = False
        if tail_dig is not None and shared_full == n_full:
            page = self.allocator.lookup(tail_dig)
            if page is not None:
                shared_pages.append(page)
                tail_shared = True
        return digests, tail_dig, shared_pages, shared_full, tail_shared

    def admit_one(self, prompt, temperature=0.0):
        """Admit ONE prompt: prefix match + page allocation + slot claim
        — host work, no dispatch. The prompt becomes *pending*;
        :meth:`prefill_tick` runs its chunks. Returns the slot id. Raises
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
            self._match_prefix(a)
        shared_len = t if tail_shared or (shared_full == n_full
                                          and not t % ps) \
            else shared_full * ps
        # claim the matched pages FIRST so alloc's LRU eviction cannot
        # steal them; roll back if alloc fails
        for page in shared_pages:
            self.allocator.incref(page)
        try:
            new_pages = self.allocator.alloc(need_pages - len(shared_pages))
        except PagePoolExhausted:
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
        if shared_len:
            self.prefix_hits += 1
        else:
            self.prefix_misses += 1
        self.prefix_hit_tokens += shared_len
        self.prefix_miss_tokens += t - shared_len
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
        ids = np.zeros((w, c), np.int32)
        start = np.zeros(w, np.int32)
        nvalid = np.ones(w, np.int32)
        # padding rows: write_from == max_position suppresses every write,
        # and their sentinel table rows attend to nothing
        write_from = np.full(w, self.max_position, np.int32)
        slot_final = np.full(w, self.max_slots, np.int32)
        pt = np.full((w, p), self.num_pages, np.int32)
        finished = []
        for i, (s, st) in enumerate(rows):
            n = min(c, st["total"] - st["next"])
            ids[i, :n] = st["tokens"][st["next"]:st["next"] + n]
            start[i] = st["next"]
            nvalid[i] = n
            write_from[i] = st["write_from"]
            pt[i] = self.page_table[s]
            if st["next"] + n >= st["total"]:
                slot_final[i] = s
                finished.append((s, st))
        self._chunk(pt, ids, start, nvalid, write_from, slot_final)
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

    def admit(self, prompts, temperatures=None):
        """Batch admission: admit each prompt and drive its chunks to
        completion before the next, so identical prefixes share pages.
        Returns the assigned slots."""
        if len(prompts) > min(self.window, self.free_slots()):
            raise ValueError(
                f"admit batch of {len(prompts)} exceeds window "
                f"{self.window} / free slots {self.free_slots()}")
        assigned = []
        for i, prompt in enumerate(prompts):
            temp = 0.0 if temperatures is None else float(temperatures[i])
            assigned.append(self.admit_one(prompt, temp))
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
                (fresh,) = self.allocator.alloc(1)
                self._dispatch_copy(page, fresh)
                self.allocator.decref(page)
                row[first_pi] = fresh
                self.cow_copies += 1
            for pi in range(first_pi, (hi - 1) // ps + 1):
                if row[pi] == sentinel:
                    (fresh,) = self.allocator.alloc(1)
                    row[pi] = fresh
        self._refresh_pool_stats()

    def step(self):
        """One block of ``steps_per_sync`` decode steps across every slot
        (call :meth:`reserve_block` first). Returns host tokens of shape
        (steps_per_sync, max_slots); rows of inactive slots are junk."""
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
        return {
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
        }
