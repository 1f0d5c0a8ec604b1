"""Slot table over one preallocated dense K/V cache, and per-slot token
selection (the port of ``bigdl_tpu/serving/slots.py``: ``select_tokens``
and ``SlotManager`` with its speculative step).

Iteration-level serving (Orca, OSDI '22): requests arrive and retire at
different times while the decode batch keeps one shape.

- the cache is ``n_layers`` dicts of (S, H, max_position, D) K/V buffers
  (S = ``max_slots``; dim 0 is the slot table) allocated once: a request
  borrows one slot row for its lifetime;
- :meth:`SlotManager.admit` prefills up to ``window`` prompts in one
  causal forward, padded to ``window`` rows and to the longest prompt's
  ``prompt_bucket``, and writes the real rows' K/V and next-token logits
  into their slots (padding rows write nothing);
- :meth:`SlotManager.step` advances every slot by ``steps_per_sync``
  tokens: per-slot lengths drive per-row cache writes and length-masked
  attention (``parallel.sequence.cached_attention`` with one length a
  row); greedy or sampled selection per slot; inactive rows decode junk
  the host drops;
- :meth:`SlotManager.retire` frees the slot row on the host: the next
  admission overwrites it.

Speculative decoding (``spec_tokens`` = gamma > 1, ``models/spec.py``):
each of a block's ``steps_per_sync`` iterations picks every slot's first
token from its carried logits (greedy or sampled, as above), has the
slot's ``NGramDraft`` row propose gamma - 1 more, verifies all gamma in
one multi-token forward (``GPT.decode_chunk``; the paged manager's
``paged_verify_chunk``) and commits the accepted prefix: 1..gamma tokens
a greedy slot, exactly one a sampled slot, none an inactive one. The
block is then (steps_per_sync * gamma, S) tokens, and ``last_counts``
says how many of column ``s`` are committed. Admission clears the slot's
draft row and primes it from the prompt. Each iteration reads back its
proposals and commit counts once: the next verify's positions, and so its
write plan, are the host's.

Every batch a dispatch runs has the reference's rows (the padding rows of
a short admission, the inactive slots of a step): int8 weights take one
activation amax over a dispatch's rows, so a token depends on them.

Recovery (``scheduler.Scheduler._recover``): :meth:`SlotManager.reset`
discards every slot's state and reallocates the device tables, keeping the
built kernels; ``poisoned`` is set whenever a dispatch raised after it may
have queued work on the card (the cache may hold partly written rows),
and only ``reset`` clears it. ``serving.prefill`` (``resilience/faults``)
fires before an admission claims its slots.

Multi-tenant LoRA (``adapter_pool``, a ``serving.adapters.AdapterPool``):
each slot carries the pool row it decodes under (``adapter_slots``, 0 the
base model, set at admission and cleared at retirement), and every
prefill, step and verify dispatch passes ``adapter_pool.gathered(rows)``
down to the model (padding rows run under row 0). Without a pool the
dispatches are what they were before LoRA was ported.

Telemetry: ``stats`` publishes on the obs registry (``obs_name``
``serving`` / ``serving_paged``, the reference's sources). While request
tracing is on (``BIGDL_TPU_REQ_TRACE``, read at construction, as the
reference wraps its executables then), each prefill, chunk, step and
verify dispatch adds its modelled work (:class:`DispatchCost`) to
``stats.flops`` / ``stats.hbm_bytes``: eager PyTorch has no compile-time
cost analysis, so the work is counted from the dispatch's shapes.

The paged manager (``serving/paging.py``) inherits the host-side table.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from bigdl_tpu_torch.models.gpt import prompt_bucket
from bigdl_tpu_torch.models.spec import NGramDraft, accept_serving, commit
from bigdl_tpu_torch.nn.quantized import Int8Linear
from bigdl_tpu_torch.obs import reqtrace
from bigdl_tpu_torch.ops.sampling import fused_sample_logits, gumbel_noise
from bigdl_tpu_torch.resilience.faults import fault_point
from bigdl_tpu_torch.utils.profiling import DispatchCounters


def select_tokens(logits, temps, generator, top_k, top_p):
    """Per-slot greedy/sampled selection over (S, V) device ``logits``.

    ``temps`` is the host (S,) float32 temperature table. Greedy rows
    take ``torch.argmax`` (first index on ties, like ``jnp.argmax``).
    When any row samples, one gumbel draw from ``generator`` feeds the
    fused sampling kernel for the whole batch and the sampled rows take
    its tokens; an all-greedy batch launches no sampling work at all (the
    reference's ``lax.cond`` is this host-side check). Returns (S,) int32
    tokens on the logits' device."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    sampled_rows = temps > 0.0
    if not sampled_rows.any():
        return greedy
    dev = logits.device
    gumbel = gumbel_noise(logits.shape, generator, dev, logits.dtype)
    t = torch.from_numpy(np.maximum(temps, 1e-6).astype(np.float32)).to(dev)
    sampled = fused_sample_logits(logits, gumbel, t, top_k, top_p)
    return torch.where(torch.from_numpy(sampled_rows).to(dev), sampled,
                       greedy)


class DispatchCost:
    """The modelled device work of one dispatch of ``model`` (a
    ``GPTForCausalLM`` or its tensor-parallel split), for the
    ``bigdl_mfu`` gauge.

    A dispatch feeds rows of new tokens, row ``r`` ``n_r`` tokens at
    positions ``start_r .. start_r + n_r - 1``; only rows that carry
    tokens count (a chunk's padding rows and a step's idle slots do not).
    Then

    - flops = 2 x tokens x the layers' matmul weights (Q/K/V, the output
      projection, the two MLP matrices: ``n_layers (4 H^2 + 2 H I)``)
      + 2 x head rows x the head (``V H``) + the attention products: a
      token at position ``p`` attends to ``p + 1`` positions, ``4 H`` flops
      a position and layer (QK^T and PV);
    - bytes = the matmul weights and the head once + the K/V read (each
      row's context, ``start + n`` positions) and written (``n``), at
      ``kv_token_bytes`` a position (every layer's K and V).

    LayerNorms, embeddings, the sampler and LoRA deltas are left out."""

    def __init__(self, model):
        gpt = model.gpt
        base = gpt.shards[0].gpt if hasattr(gpt, "shards") else gpt
        h, i = base.hidden_size, base.intermediate_size
        self.hidden = h
        self.n_layers = len(base.layers)
        self.layer_weights = self.n_layers * (4 * h * h + 2 * h * i)
        self.head_weights = model.vocab_size * h
        elt = base.tok_emb.element_size()
        int8 = any(isinstance(m, Int8Linear) for m in model.modules())
        self.weight_bytes = (self.layer_weights * (1 if int8 else elt)
                             + self.head_weights * elt)

    def of(self, rows, head_rows, kv_token_bytes):
        """(flops, bytes) of a dispatch of ``rows`` ``(start, n)`` pairs
        whose ``head_rows`` tokens go through the head."""
        tokens = attended = read = 0
        for start, n in rows:
            tokens += n
            attended += n * start + n * (n + 1) // 2
            read += start + n
        flops = (2 * tokens * self.layer_weights
                 + 2 * head_rows * self.head_weights
                 + 4 * self.hidden * self.n_layers * attended)
        return flops, self.weight_bytes + kv_token_bytes * (read + tokens)


class SlotManager:
    """Slot table over one preallocated dense K/V cache (see module
    docstring). ``model`` is a ``GPTForCausalLM`` (or a
    ``parallel.tensor_parallel.TensorParallelCausalLM``: then every shard
    holds its heads of the cache, and the logits table and the sampler's
    generator live on the first shard's device); ``window`` is the
    prefill batch (admissions a dispatch), ``steps_per_sync`` the decode
    steps of one block between host syncs (tokens past a request's end
    inside a block are the caller's to drop); ``top_k`` / ``top_p`` are
    the engine-wide sampling cuts; ``seed`` seeds the sampler's
    ``torch.Generator``; ``spec_tokens`` > 1 makes each decode iteration
    speculative (see module docstring), with ``block_span = steps_per_sync
    * spec_tokens`` the positions a block may write and the counters
    ``spec_proposed``, ``spec_accepted`` and ``spec_rollbacks`` over the
    greedy slots (a sampled slot commits one token by design).

    The host tables (``lengths``, ``active``, ``temps``), a lowest-first
    free heap and an occupancy counter are shared with the paged manager.
    ``stats`` counts dispatches (``prefills``, ``steps``) and, not as
    dispatches, ``sampled_steps``, the decode steps that launched the
    sampler.

    Thread model: NOT thread-safe: exactly one thread (the scheduler
    loop) mutates it; :meth:`occupancy` and :meth:`free_slots` read plain
    integers and are safe from any thread."""

    paged = False
    _stat_keys = ("prefills", "steps")
    _obs_name = "serving"
    # the paged manager's host tier and restore state; none here
    host_tier = None
    restore_active = False
    restore_ended = 0.0

    def __init__(self, model, max_slots, window=4, steps_per_sync=1,
                 top_k=None, top_p=None, seed=0, spec_tokens=1,
                 adapter_pool=None):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        layout = getattr(model, "layout", None)
        self.tp = 1 if layout is None else layout.tp
        # a tensor-parallel model, even over a mesh of one device, keeps
        # its pools and caches as one list per shard
        self.sharded = layout is not None
        self.model = model
        self.device = model.device
        self.max_slots = int(max_slots)
        self.window = max(1, min(int(window), self.max_slots))
        self.steps_per_sync = max(1, int(steps_per_sync))
        self.spec_tokens = max(1, int(spec_tokens))
        # every iteration may write gamma positions, rejected ones too
        self.block_span = self.steps_per_sync * self.spec_tokens
        self._draft = (NGramDraft(model.vocab_size)
                       if self.spec_tokens > 1 else None)
        self.spec_proposed = self.spec_accepted = self.spec_rollbacks = 0
        self.last_counts = None
        self.top_k = top_k
        self.top_p = top_p
        self.adapter_pool = adapter_pool
        self.max_position = model.gpt.max_position
        self._seed = int(seed)
        self._resets = 0
        # a dispatch raised after it may have queued work: nothing but
        # reset() may touch the device tables again
        self.poisoned = False
        self.stats = DispatchCounters(*self._stat_keys,
                                      obs_name=self._obs_name)
        self.stats.add("sampled_steps", 0)
        self._cost = DispatchCost(model) if reqtrace.enabled() else None
        self._alloc()

    def _alloc_host(self):
        self.lengths = np.zeros(self.max_slots, np.int32)
        self.active = np.zeros(self.max_slots, bool)
        self.temps = np.zeros(self.max_slots, np.float32)
        self._free = list(range(self.max_slots))   # heap: lowest slot first
        self._occupied = 0
        self._dtype = self.model.gpt.tok_emb.dtype
        self._logits = torch.zeros((self.max_slots, self.model.vocab_size),
                                   dtype=self._dtype, device=self.device)
        self._gen = torch.Generator(device=self.device)
        # a stream of its own a table incarnation, so a rebuilt table does
        # not replay the sampled tokens of the one it replaces
        self._gen.manual_seed(self._seed + 1_000_003 * self._resets)
        # the draft table (with the logits, on the first shard's device) and
        # each slot's last committed token, the first ``prev`` of the next
        # block's committed pairs
        self._table = (None if self._draft is None
                       else self._draft.init_state(self.max_slots,
                                                   self.device))
        self._last_tok = np.zeros(self.max_slots, np.int32)
        # each slot's adapter pool row (0: the base model)
        self.adapter_slots = np.zeros(self.max_slots, np.int32)

    def _lora(self, rows):
        """The LoRA slab tree of a dispatch whose rows run under pool rows
        ``rows``: None without a pool (or when every row is the base
        model)."""
        if self.adapter_pool is None:
            return None
        return self.adapter_pool.gathered(rows)

    def _alloc(self):
        self._alloc_host()
        gpt = self.model.gpt
        self._cache = gpt.init_cache(self.max_slots)
        planes = gpt.cache_planes(self._cache)
        slot_bytes = [sum(v[0].numel() * v.element_size() for v in shard)
                      for shard in planes]
        # bytes of one cached token, every layer's K and V, all heads / per
        # shard (one chip's share when each shard has its own card)
        self._kv_token_bytes = sum(slot_bytes) // self.max_position
        self._kv_token_bytes_per_chip = slot_bytes[0] // self.max_position

    def reset(self):
        """Discard ALL slot state and reallocate the device tables: the
        recovery entry point after a failed dispatch. The built kernels
        are kept. On the card the devices are synchronised, so a sticky
        CUDA error (the card refusing every call) raises here rather than
        at the next dispatch. The caller re-admits whatever survives."""
        self._resets += 1
        self.last_counts = None
        self._alloc()
        layout = getattr(self.model, "layout", None)
        for dev in {self.device} if layout is None else set(layout.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self.poisoned = False

    def warm_kernels(self):
        """Build (or load) the kernels this table's dispatches launch, on
        the card only: the scheduler calls it before its loop's first
        heartbeat, so a first build never reads as a wedge."""
        if self.device.type != "cuda":
            return
        from bigdl_tpu_torch.ops import _build, sampling
        _build.load("sampling", sampling._declare)

    def free_slots(self):
        return self.max_slots - self._occupied

    def occupancy(self):
        """Active slot count (an owner-maintained integer)."""
        return self._occupied

    def pending_prefills(self):
        """Prompts admitted but not yet prefilled: none here (an admission
        prefills at once)."""
        return 0

    def reserve_block(self):
        """Nothing to reserve: the cache holds every position of every
        slot."""

    # ---------------------------------------------------- device dispatches
    def _add_cost(self, rows, head_rows):
        """Add a dispatch's modelled work (:class:`DispatchCost`) to
        ``stats`` while request tracing is on."""
        if self._cost is not None:
            self.stats.add_cost(*self._cost.of(rows, head_rows,
                                               self._kv_token_bytes))

    @torch.no_grad()
    def _prefill(self, ids, lens, slots, arows):
        """One admission dispatch: ``ids`` (window, bucket) host tokens,
        ``lens`` (window,) prompt lengths (1 on padding rows), ``arows``
        (window,) adapter pool rows; the first ``len(slots)`` rows land in
        ``slots``, whose K/V and logits rows are written."""
        n = len(slots)
        h, self._cache = self.model.gpt.prefill(self._cache, ids, lens,
                                                rows=np.asarray(slots),
                                                lora=self._lora(arows))
        idx = torch.as_tensor(slots, device=self.device)
        self._logits[idx] = self.model._lm_logits(h[:n]).to(self._dtype)
        rows = np.full(ids.shape[0], self.max_slots)
        rows[:n] = slots
        self._prime(ids, lens, rows, clear=slots)
        self.stats.tick("prefills")
        self._add_cost([(0, int(n)) for n in lens[:n]], n)

    def _prime(self, ids, lens, rows, prev=None, clear=()):
        """The draft's part of an admission dispatch (speculation only):
        the draft rows of ``clear`` (slots a new stream takes) are
        emptied, then the host tokens ``ids`` (W, C), ``lens`` valid a row,
        are learned into draft rows ``rows`` (``max_slots``: a padding row,
        dropped); ``prev`` (W,) is the token before a chunk
        (``vocab_size``: none)."""
        if self._draft is None:
            return
        if len(clear):
            self._table[torch.as_tensor(np.asarray(clear),
                                        device=self.device).long()] = 0
        self._draft.prime(self._table, ids, lens, rows=rows, prev=prev)

    def _decode(self, tok, pos):
        """One decode step of every slot: tokens ``tok`` (S,) at host
        positions ``pos`` (S,) through the cache; returns the (S, hidden)
        final-norm states."""
        h, self._cache = self.model.gpt.decode_step(
            self._cache, tok, pos, lora=self._lora(self.adapter_slots))
        return h

    def _verify(self, props, pos):
        """One verify chunk of every slot: proposals ``props`` (S, gamma) at
        host positions ``pos`` (S,) on; returns the (S, gamma, hidden)
        final-norm states."""
        h, self._cache = self.model.gpt.decode_chunk(
            self._cache, props, pos, lora=self._lora(self.adapter_slots))
        return h

    @torch.no_grad()
    def _step(self):
        """``steps_per_sync`` decode steps across every slot
        (:meth:`_decode`); returns the host (steps_per_sync, max_slots)
        token block."""
        model = self.model
        lengths = self.lengths.astype(np.int64)
        pmax = self.max_position
        logits = self._logits
        if (self.temps > 0.0).any():           # select_tokens' own test
            self.stats.add("sampled_steps", self.steps_per_sync)
        toks = []
        for _ in range(self.steps_per_sync):
            tok = select_tokens(logits, self.temps, self._gen, self.top_k,
                                self.top_p)
            # a slot that hit EOS/max mid-block keeps decoding junk the
            # host discards; the clamp keeps its positions in bounds
            pos = np.minimum(lengths, pmax - 1)
            logits = model._lm_logits(self._decode(tok, pos)).to(self._dtype)
            busy = np.nonzero(self.active)[0]
            self._add_cost([(int(pos[s]), 1) for s in busy], busy.size)
            lengths = lengths + self.active
            toks.append(tok)
        self._logits = logits
        self.stats.tick("steps")
        return torch.stack(toks).cpu().numpy()   # ONE readback per block

    @torch.no_grad()
    def _spec_step(self):
        """``steps_per_sync`` speculative iterations across every slot (see
        module docstring; the reference's ``_build_spec_fns`` step).
        Returns the host (block_span, max_slots) token block, each slot's
        committed count (S,) and the block's (proposed, accepted, rejected)
        counts over the greedy slots."""
        model, dev, gamma = self.model, self.device, self.spec_tokens
        s_all = self.max_slots
        sampled_rows = self.temps > 0.0
        spec_rows = self.active & ~sampled_rows
        if sampled_rows.any():                 # select_tokens' own test
            self.stats.add("sampled_steps", self.steps_per_sync)
        live = torch.from_numpy(self.active).to(dev)
        sampled = torch.from_numpy(sampled_rows).to(dev)
        out = np.zeros((self.block_span, s_all), np.int32)
        counts = np.zeros(s_all, np.int64)
        tele = np.zeros(3, np.int64)
        last = torch.from_numpy(self._last_tok).to(dev)
        logits = self._logits
        for _ in range(self.steps_per_sync):
            tok0 = select_tokens(logits, self.temps, self._gen, self.top_k,
                                 self.top_p)
            props = self._draft.propose(self._table, tok0, gamma)
            pos = self.lengths + counts
            vl = model._lm_logits(self._verify(props, pos))
            busy = np.nonzero(self.active)[0]
            self._add_cost([(int(pos[s]), gamma) for s in busy],
                           gamma * busy.size)
            adv, carry = accept_serving(props, vl, sampled=sampled,
                                        live=live)
            last, logits, got = commit(self._draft, self._table, props, adv,
                                       carry, last, logits)
            adv = got[:, -1].astype(np.int64)
            for s in np.nonzero(adv)[0]:
                out[counts[s]:counts[s] + adv[s], s] = got[s, :adv[s]]
            counts += adv
            acc = int(adv[spec_rows].sum())
            tele += (gamma * int(spec_rows.sum()), acc,
                     gamma * int(spec_rows.sum()) - acc)
        self._logits = logits
        self.stats.tick("steps")
        return out, counts, tele

    # ------------------------------------------------------------ admission
    def admit(self, prompts, temperatures=None, adapter_slots=None):
        """Prefill ``prompts`` (at most ``window`` and the free slots) into
        free slots in ONE dispatch; returns the assigned slots in order.
        The batch is padded to ``window`` rows and the prompts to the
        ``prompt_bucket`` of the longest. ``adapter_slots`` gives each
        prompt's adapter pool row (None: the base model). A prompt longer
        than ``max_position - 1`` raises ``ValueError`` before any slot is
        claimed; a failed dispatch returns its slots to the free heap."""
        if not prompts:
            return []
        if len(prompts) > min(self.window, self.free_slots()):
            raise ValueError(
                f"admit batch of {len(prompts)} exceeds window "
                f"{self.window} / free slots {self.free_slots()}")
        arrs = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
        for a in arrs:
            if a.size < 1:
                raise ValueError("empty prompt")
            if a.size > self.max_position - 1:
                raise ValueError(
                    f"prompt of {a.size} tokens exceeds the slot capacity "
                    f"of {self.max_position - 1} (max_position "
                    f"{self.max_position} minus one generated token)")
        w = self.window
        bucket = prompt_bucket(max(a.size for a in arrs), self.max_position)
        ids = np.zeros((w, bucket), np.int32)
        lens = np.ones(w, np.int32)            # padding rows: length 1
        arows = np.zeros(w, np.int32)          # padding rows: base row 0
        for i, a in enumerate(arrs):
            ids[i, :a.size] = a
            lens[i] = a.size
            if adapter_slots is not None:
                arows[i] = int(adapter_slots[i])
        # before any slot is claimed: a fault here must not leak slots
        fault_point("serving.prefill", n=len(arrs))
        slots = [heapq.heappop(self._free) for _ in arrs]
        try:
            self._prefill(ids, lens, slots, arows)
        except BaseException:
            self.poisoned = True
            for s in slots:
                heapq.heappush(self._free, s)
            raise
        self._occupied += len(slots)
        for i, s in enumerate(slots):
            self.lengths[s] = lens[i]
            self.active[s] = True
            self.temps[s] = (0.0 if temperatures is None
                             else float(temperatures[i]))
            self._last_tok[s] = arrs[i][-1]
            self.adapter_slots[s] = arows[i]
        return [int(s) for s in slots]

    # --------------------------------------------------------------- decode
    def step(self):
        """One block of ``steps_per_sync`` decode steps across every slot.
        Returns host tokens of shape (steps_per_sync, max_slots); rows of
        inactive slots are junk. With ``spec_tokens`` > 1 the block is
        (block_span, max_slots) and ``last_counts[s]`` says how many of
        column ``s`` are committed."""
        try:
            if self.spec_tokens > 1:
                return self._finish_spec_block(*self._spec_step())
            toks = self._step()
        except BaseException:
            self.poisoned = True
            raise
        self.lengths[self.active] = np.minimum(
            self.lengths[self.active] + self.steps_per_sync,
            self.max_position)
        return toks

    def _finish_spec_block(self, toks, counts, tele):
        """Host bookkeeping after a speculative block: each slot advances by
        its committed count, its last committed token is kept for the next
        block's draft pairs, and the accept counters grow."""
        self.last_counts = counts
        self.lengths[self.active] = np.minimum(
            self.lengths[self.active] + counts[self.active],
            self.max_position)
        hit = np.nonzero(self.active & (counts > 0))[0]
        self._last_tok[hit] = toks[counts[hit] - 1, hit]
        self.spec_proposed += int(tele[0])
        self.spec_accepted += int(tele[1])
        self.spec_rollbacks += int(tele[2])
        return toks

    def retire(self, slot):
        """Free a slot row (host bookkeeping only: the stale K/V is masked
        by length until the next admission overwrites it)."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        self.active[slot] = False
        self.lengths[slot] = 0
        self.temps[slot] = 0.0
        self.adapter_slots[slot] = 0
        heapq.heappush(self._free, int(slot))
        self._occupied -= 1

    # ------------------------------------------------------------ telemetry
    def pool_stats(self):
        """The dense cache's size: bytes a token (every layer's K and V),
        the whole cache's bytes, and one shard's share of both under tp."""
        return {
            "kv_dtype": str(self._dtype).replace("torch.", ""),
            "kv_bytes_per_token": self._kv_token_bytes,
            "cache_bytes": self._kv_token_bytes * self.max_position
            * self.max_slots,
            "tp_degree": self.tp,
            "kv_bytes_per_token_per_chip": self._kv_token_bytes_per_chip,
            "cache_bytes_per_chip": self._kv_token_bytes_per_chip
            * self.max_position * self.max_slots,
        }
