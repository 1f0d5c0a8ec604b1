"""ServingEngine: the public continuous-batching inference facade (the
port of ``bigdl_tpu/serving/engine.py``).

``ServingEngine(model, params, max_slots=8)`` turns a
``GPTForCausalLM`` into a concurrent serving system: callers
``submit()`` prompts from any thread and stream tokens back, while one
scheduler thread runs prefill and batched decode, sampling through the
fused sampling kernel. By default, as in the reference
(``BIGDL_TPU_PAGED_KV`` off), it serves from the dense slot table
(``serving/slots.py``: one preallocated (slots, max_position) K/V cache,
batched prefill of up to ``prefill_window`` prompts); ``paged=True``
serves from the paged K/V pool (``serving/paging.py``: chunked prefill,
prefix sharing, attention through the paged-attention kernel).

The engine runs on the card (``cuda``) unless the caller passes
``device="cpu"``; without CUDA and without ``device`` it raises.

``spec_tokens=gamma`` (or ``BIGDL_TPU_SPEC_DECODE``) makes every decode
iteration speculative on either table (``models/spec.py``): greedy
requests commit 1..gamma tokens a verify forward, with the tokens they
would get without it; ``metrics()`` then counts the draft's proposals.

``tp=N`` (or ``mesh=[...]``) serves a tensor-parallel model
(``parallel/tensor_parallel.py``), dense or paged, float or int8 weights:
Megatron-sharded weights (int8 ones quantised before they are split, as
the reference does), head-sharded K/V caches or pools, the
paged-attention kernel launched once per shard, and two fixed-order sums
a layer (for int8 weights, of the shards' int32 accumulators). One
scheduler thread drives every shard, as the reference's single controller
does.

Resilience (ROADMAP A.4, the reference's defaults): a failed dispatch is
recovered in place up to ``max_recoveries`` times
(``BIGDL_TPU_SERVING_MAX_RECOVERIES``, 8): the slot table is rebuilt and
the affected requests re-placed from their contexts, a poisoned request
quarantined alone; past the budget every request fails with
``EngineFailedError``, or goes to ``failover`` (``EngineSupervisor``).
A sticky CUDA error leaves the card refusing every call: the table cannot
be rebuilt, and the engine gives up at once. Durability (A.7, paged
only, off by default): ``kv_host_tier`` demotes evicted pages to host RAM
and promotes them back on a prefix hit; ``kv_snapshot`` persists pages
and a request journal to ``snapshot_dir``, from which a new engine
restores.

Multi-tenant LoRA: ``lora=True`` (or
``BIGDL_TPU_LORA``) builds an ``AdapterPool`` (``serving/adapters.py``)
over the model's target projections, after int8 quantisation (int8
slabs with int8 weights) and split like the weights under tp; requests
name an adapter with ``submit(..., adapter=)`` and every dispatch adds
each row's low-rank delta, so mixed-adapter batches decode together on
either table, with speculation, int8 weights and tp.

Control plane and telemetry: ``policy=`` (a ``serving.control.
ControlPolicy``; None takes ``policy_from_flags()``, i.e.
``BIGDL_TPU_ADMISSION_SLO``) makes the scheduler's queue weighted-fair by
priority and client, with per-client rate limits and SLO-aware admission.
Every counter lives on the obs default registry under the reference's
families, labelled ``engine=<obs_label>``; ``metrics()`` reads them there,
or the scheduler's plain attributes while obs is off; a weakref probe
reports the loop's liveness at ``/healthz``; ``submit`` mints the request's
trace ID (``BIGDL_TPU_REQ_TRACE``) and records its ``submit`` event inside
a ``serve/submit`` span.
"""

from __future__ import annotations

import logging
import time
import weakref

from bigdl_tpu_torch import obs
from bigdl_tpu_torch.models.spec import spec_config
from bigdl_tpu_torch.nn.quantized import lora_delta, qmatmul, quantize_model
from bigdl_tpu_torch.ops.paged_attention import paged_pool_attention
from bigdl_tpu_torch.obs import reqtrace
from bigdl_tpu_torch.ops.sampling import fused_sample_logits
from bigdl_tpu_torch.parallel.layout import ModelLayout, serving_mesh
from bigdl_tpu_torch.parallel.tensor_parallel import TensorParallelCausalLM
from bigdl_tpu_torch.serving.paging import (PagedSlotManager,
                                            PagePoolExhausted,
                                            kv_token_bytes, pages_for_budget)
from bigdl_tpu_torch.serving.scheduler import QueueFullError, Request, Scheduler
from bigdl_tpu_torch.serving.slots import SlotManager
from bigdl_tpu_torch.utils.device import resolve_device
from bigdl_tpu_torch.utils.flags import get_flag

logger = logging.getLogger("bigdl_tpu_torch.serving")


class ServingEngine:
    """Continuous-batching engine over one model's dense or paged decode
    path.

    Parameters
    ----------
    model: a ``GPTForCausalLM``.
    params: a ``state_dict`` to load (``convert.params_from_jax`` /
        ``convert.init_params``); None serves the model's current weights.
    max_slots: concurrent in-flight requests.
    max_queue: waiting-queue bound; a full queue rejects ``submit`` with
        ``QueueFullError``.
    prefill_window: max prompts a prefill dispatch takes (dense: one
        batched prefill; paged: one chunk each).
    admit_wait_s: with nothing decoding, hold admission up to this long
        so a burst lands in one admission batch (0 disables).
    steps_per_sync: decode steps per block between host syncs.
    top_k / top_p: engine-wide sampling truncation for requests with
        ``temperature > 0``.
    seed: seeds the engine's ``torch.Generator`` for the sampler's noise.
    default_deadline_s: TTL for requests submitted without one.
    failover: ``callable(victims, error)`` receiving every unfinished
        request when the loop gives up (the ``EngineSupervisor`` hook).
    max_recoveries: in-place recovery budget
        (``BIGDL_TPU_SERVING_MAX_RECOVERIES``, 8; 0 gives up at the first
        error).
    paged: serve from the paged K/V pool (``BIGDL_TPU_PAGED_KV``, off: the
        dense slot table). ``self.paged`` reports the path taken. The
        options below up to ``host_tier_prefetch`` are the paged path's;
        the dense path ignores them, as the reference does, except that
        ``kv_snapshot`` / ``kv_host_tier`` by keyword raise
        ``ValueError`` there (their flags it ignores).
    page_size: tokens per K/V page (``BIGDL_TPU_PAGE_SIZE``, 16).
    kv_pages: page-pool size (default: the dense-equivalent
        ``max_slots * max_position / page_size``).
    prefill_chunk: chunked-prefill width (``BIGDL_TPU_PREFILL_CHUNK``, 64).
    prefix_cache: share pages between identical prompt prefixes
        (``BIGDL_TPU_PREFIX_CACHE``, on).
    int8_weights: serve from symmetric per-output-channel int8 weights
        (``nn.quantize_model``: every ``Linear`` becomes an ``Int8Linear``,
        in place, after ``params`` are loaded; ``BIGDL_TPU_INT8_WEIGHTS``,
        off).
    int8_kv: int8 K/V pages with a float32 scale per (token, head),
        quantised on write and read by the int8 paged-attention kernel
        (``BIGDL_TPU_INT8_KV``, off).
    kv_bytes: size the page pool by a device-memory budget in bytes per
        chip (``paging.pages_for_budget``, counting ``int8_kv``'s scale
        planes; under tp each shard holds ``1/tp`` of the heads, so the
        pool gets ``tp`` times the pages); ignored when ``kv_pages`` is
        given.
    kv_snapshot: persist prefix-cached and live full-block pages and a
        request journal (``serving/snapshot.py``) to ``snapshot_dir``; an
        engine over the same directory restores pages instead of
        re-prefilling (``BIGDL_TPU_KV_SNAPSHOT``, off).
    snapshot_dir: the store's directory (``BIGDL_TPU_SNAPSHOT_DIR``;
        required with ``kv_snapshot``).
    snapshot_interval_s: least seconds between snapshot passes
        (``BIGDL_TPU_SNAPSHOT_INTERVAL_S``, 0.5). The store keeps at most
        ``BIGDL_TPU_KV_SNAPSHOT_GC_PAGES`` pages (default 4 pools).
    snapshot_journal: the journal's file name in ``snapshot_dir``
        (``journal.jsonl``); engines sharing a directory need their own.
    kv_host_tier: demote evicted pool pages to host RAM and promote them
        back on a prefix hit (``serving/host_tier.py``;
        ``BIGDL_TPU_KV_HOST_TIER``, off).
    host_tier_bytes: the tier's budget (``BIGDL_TPU_KV_HOST_TIER_BYTES``;
        default four pools' worth of full-H pages).
    host_tier_prefetch: pages promoted a scheduler iteration ahead of the
        waiting queue's head (``BIGDL_TPU_KV_HOST_TIER_PREFETCH``, 8; 0
        promotes at admission only).
    device: where to serve; None means the card. With ``tp`` it places
        every shard there (``device="cpu"``: ``tp`` shards on the CPU).
    tp: tensor-parallel degree (``BIGDL_TPU_SERVING_TP``, off; an explicit
        ``tp`` overrides the flag). Alone it takes the first ``tp`` cards
        and raises when fewer are visible. Needs ``n_heads % tp == 0``;
        ``tp=1`` is the unsharded path. With ``int8_weights`` the model is
        quantised first and then split. The engine splits ``model``'s
        weights into the shards and
        never moves ``model`` itself: build it on the CPU, so that no card
        holds a whole copy beside its shard.
    mesh: the shards' devices, one per shard (a device may repeat: several
        shards on one card); overrides ``tp``, and is a ``ValueError``
        together with ``device``.
    spec_tokens: the speculative draft length gamma; 1 is off (None:
        ``models.spec.spec_config()``, i.e. ``BIGDL_TPU_SPEC_DECODE`` with
        ``BIGDL_TPU_SPEC_TOKENS``, default 4). Both tables, tp and int8.
    lora: serve LoRA adapters from an ``AdapterPool`` (``BIGDL_TPU_LORA``,
        off); ``self.adapter_pool`` is the pool, or None. The options below
        are ignored while it is off, except ``adapters``, which then raises
        ``ValueError``, as in the reference.
    lora_rank: every adapter's rank (``BIGDL_TPU_LORA_RANK``, 8).
    adapter_slots: adapters resident on the device at once
        (``BIGDL_TPU_ADAPTER_SLOTS``, 8); the pool holds one row more, the
        base model's.
    adapters: ``{name: adapter}`` registered at start
        (``register_adapter``; ``models.lora.init_adapter`` trees).
    adapter_host_bytes: a host tier of this many bytes that evicted
        adapters demote into (``BIGDL_TPU_ADAPTER_HOST_BYTES``, 0: none).
        With ``kv_snapshot`` the pool also archives to and loads from the
        engine's page store.
    policy: a ``serving.control.ControlPolicy`` (priorities, weighted-fair
        dequeue, rate limits, SLO admission); None builds one from the
        flags (``policy_from_flags``: ``BIGDL_TPU_ADMISSION_SLO``, off by
        default: FIFO). ``self.policy`` is the policy, or None.

    A model built with ``sequence_parallel`` is refused with the
    reference's ``ValueError``.
    """

    def __init__(self, model, params=None, max_slots=8, max_queue=64,
                 prefill_window=4, admit_wait_s=0.0, steps_per_sync=1,
                 top_k=None, top_p=None, seed=0, default_deadline_s=None,
                 paged=None, page_size=None, kv_pages=None,
                 prefill_chunk=None, prefix_cache=None, int8_weights=None,
                 int8_kv=None, kv_bytes=None, device=None, tp=None,
                 mesh=None, spec_tokens=None, failover=None,
                 max_recoveries=None, kv_snapshot=None, snapshot_dir=None,
                 snapshot_interval_s=None, snapshot_journal=None,
                 kv_host_tier=None, host_tier_bytes=None,
                 host_tier_prefetch=None, lora=None, lora_rank=None,
                 adapter_slots=None, adapters=None, adapter_host_bytes=None,
                 policy=None):
        if paged is None:
            paged = get_flag("BIGDL_TPU_PAGED_KV", False, bool)
        self.paged = bool(paged)
        if not self.paged:
            for name, value, unit in (("kv_snapshot", kv_snapshot,
                                       "the store's unit of persistence"),
                                      ("kv_host_tier", kv_host_tier,
                                       "the tier's unit of residency")):
                if value:
                    raise ValueError(f"{name} requires paged=True ({unit} "
                                     f"is the K/V page)")
        if getattr(model, "gpt", None) is None:
            raise TypeError("ServingEngine drives GPTForCausalLM models")
        if model.gpt.layers and \
                model.gpt.layers[0].attn.sequence_parallel is not None:
            raise ValueError(
                "serving does not compose with sequence_parallel; build "
                "the model without it for generation")
        layout = self._layout(tp, mesh, device)
        if layout is not None:
            layout.validate_heads(model.gpt.layers[0].attn.n_heads)
        self.layout = layout
        self.tp = 1 if layout is None else layout.tp
        self.device = (resolve_device(device) if layout is None
                       else layout.devices[0])
        if int8_weights is None:
            int8_weights = get_flag("BIGDL_TPU_INT8_WEIGHTS", False, bool)
        self.int8_weights = bool(int8_weights)
        if params is not None:
            model.load_state_dict(params)
        if self.int8_weights:
            quantize_model(model)
        self.adapter_pool = self._adapter_pool(
            model, lora, lora_rank, adapter_slots, adapters,
            adapter_host_bytes)
        if layout is None:
            model.to(self.device)
        else:
            model = TensorParallelCausalLM(model, layout)
        model.requires_grad_(False)
        model.eval()
        self.model = model
        self.default_deadline_s = default_deadline_s
        if spec_tokens is None:
            spec_tokens = spec_config()
        self.spec_tokens = max(1, int(spec_tokens))
        self.snapshot = None
        self.host_tier = None
        self.host_staging = None
        self._host_copier = None
        if self.paged:
            if page_size is None:
                page_size = get_flag("BIGDL_TPU_PAGE_SIZE", 16, int)
            if prefill_chunk is None:
                prefill_chunk = get_flag("BIGDL_TPU_PREFILL_CHUNK", 64, int)
            if prefix_cache is None:
                prefix_cache = get_flag("BIGDL_TPU_PREFIX_CACHE", True,
                                        bool)
            if int8_kv is None:
                int8_kv = get_flag("BIGDL_TPU_INT8_KV", False, bool)
            if kv_bytes is not None and kv_pages is None:
                kv_pages = pages_for_budget(model, page_size, kv_bytes,
                                            int8=bool(int8_kv),
                                            dtype=model.gpt.tok_emb.dtype,
                                            tp=self.tp)
            if kv_pages is None:
                kv_pages = max_slots * (model.gpt.max_position // page_size)
            self._durability(model, int(kv_pages), int(page_size),
                             bool(int8_kv), kv_snapshot, snapshot_dir,
                             snapshot_interval_s, snapshot_journal,
                             kv_host_tier, host_tier_bytes)
            if host_tier_prefetch is None:
                host_tier_prefetch = get_flag(
                    "BIGDL_TPU_KV_HOST_TIER_PREFETCH", 8, int)
            self.slots = PagedSlotManager(
                model, max_slots, num_pages=kv_pages, page_size=page_size,
                window=prefill_window, steps_per_sync=steps_per_sync,
                prefill_chunk=prefill_chunk, prefix_cache=prefix_cache,
                top_k=top_k, top_p=top_p, seed=seed, int8_kv=bool(int8_kv),
                spec_tokens=self.spec_tokens,
                page_store=(None if self.snapshot is None
                            else self.snapshot.store),
                host_tier=self.host_tier,
                host_demote=(None if self._host_copier is None
                             else self._host_copier.submit),
                host_tier_prefetch=(int(host_tier_prefetch or 0)
                                    if self.host_tier is not None else 0),
                host_staging=self.host_staging,
                adapter_pool=self.adapter_pool)
            if self.snapshot is not None:
                if self.snapshot.max_pages is None:
                    # the store holds a few pools' worth of pages
                    gc_pages = get_flag("BIGDL_TPU_KV_SNAPSHOT_GC_PAGES", 0,
                                        int)
                    self.snapshot.max_pages = (
                        int(gc_pages) if gc_pages
                        else 4 * self.slots.num_pages)
                if self.host_tier is not None:
                    # a demoted page's disk copy may be its only durable
                    # one: gc never takes a digest the tier still holds
                    self.snapshot.store.tier_resident = \
                        self.host_tier.hex_digests
        else:
            self.slots = SlotManager(model, max_slots, window=prefill_window,
                                     steps_per_sync=steps_per_sync,
                                     top_k=top_k, top_p=top_p, seed=seed,
                                     spec_tokens=self.spec_tokens,
                                     adapter_pool=self.adapter_pool)
        if self.adapter_pool is not None:
            if self.snapshot is not None:
                # adapters archive into the K/V pages' store: an engine
                # sharing the directory loads them by digest alone
                self.adapter_pool.store = self.snapshot.store
            for name, adapter in (adapters or {}).items():
                self.adapter_pool.register(name, adapter)
        if policy is None:
            from bigdl_tpu_torch.serving.control import policy_from_flags
            policy = policy_from_flags()
        self.policy = policy
        self.scheduler = Scheduler(self.slots, max_queue=max_queue,
                                   admit_wait_s=admit_wait_s,
                                   failover=failover,
                                   max_recoveries=max_recoveries,
                                   snapshot=self.snapshot, policy=policy)
        # the series label distinguishing this engine on the registry
        self.obs_label = self.scheduler.obs_label
        # /healthz liveness through a weakref: a dropped engine prunes its
        # probe at the next health read, and shutdown unregisters it (a
        # cleanly stopped engine is not a failure)
        ref = weakref.ref(self)
        label = self.obs_label

        def _health_probe():
            eng = ref()
            if eng is None:
                return None
            return {f"engine:{label}": eng.scheduler.is_alive()}

        self._health_probe = _health_probe
        obs.default_registry().register_probe(_health_probe)

    def _adapter_pool(self, model, lora, rank, slots, adapters, host_bytes):
        """The ``AdapterPool`` of ``lora`` (each option falling back to its
        flag) over ``model`` (loaded and, with int8 weights, quantised;
        not yet split), on the engine's device or split over its layout,
        with its host tier; None when ``lora`` is off."""
        if lora is None:
            lora = get_flag("BIGDL_TPU_LORA", False, bool)
        if not lora:
            if adapters:
                raise ValueError("adapters= needs the pool: pass lora=True "
                                 "or set BIGDL_TPU_LORA")
            return None
        from bigdl_tpu_torch.serving.adapters import AdapterPool
        from bigdl_tpu_torch.serving.host_tier import HostPageTier
        if rank is None:
            rank = get_flag("BIGDL_TPU_LORA_RANK", 8, int)
        if slots is None:
            slots = get_flag("BIGDL_TPU_ADAPTER_SLOTS", 8, int)
        if host_bytes is None:
            host_bytes = get_flag("BIGDL_TPU_ADAPTER_HOST_BYTES", 0, int)
        tier = HostPageTier(int(host_bytes)) if int(host_bytes or 0) else None
        return AdapterPool(model, int(slots), int(rank),
                           int8=self.int8_weights, host_tier=tier,
                           layout=self.layout, device=self.device)

    def register_adapter(self, name, adapter):
        """Catalog a LoRA adapter (a ``models.lora.init_adapter`` tree, or
        the reference's through ``convert.adapter_from_jax``) under
        ``name``, so ``submit(adapter=name)`` decodes under it. Returns its
        16-byte digest, also accepted (raw or hex) as ``adapter=``. Needs
        ``lora=True``; call it before serving or between requests."""
        if self.adapter_pool is None:
            raise ValueError("register_adapter needs the adapter pool: build "
                             "the engine with lora=True or set "
                             "BIGDL_TPU_LORA")
        return self.adapter_pool.register(name, adapter)

    def _durability(self, model, num_pages, page_size, int8_kv, kv_snapshot,
                    snapshot_dir, snapshot_interval_s, snapshot_journal,
                    kv_host_tier, host_tier_bytes):
        """Build the paged path's page store (``kv_snapshot``) and host
        tier (``kv_host_tier``), each keyword falling back to its flag."""
        if kv_snapshot is None:
            kv_snapshot = get_flag("BIGDL_TPU_KV_SNAPSHOT", False, bool)
        if kv_snapshot:
            from bigdl_tpu_torch.serving.snapshot import KVSnapshot
            if snapshot_dir is None:
                snapshot_dir = get_flag("BIGDL_TPU_SNAPSHOT_DIR", "", str)
            if not snapshot_dir:
                raise ValueError("kv_snapshot needs a directory: pass "
                                 "snapshot_dir= or set "
                                 "BIGDL_TPU_SNAPSHOT_DIR")
            if snapshot_interval_s is None:
                snapshot_interval_s = get_flag(
                    "BIGDL_TPU_SNAPSHOT_INTERVAL_S", 0.5, float)
            self.snapshot = KVSnapshot(snapshot_dir,
                                       interval_s=snapshot_interval_s,
                                       journal_name=snapshot_journal)
        if kv_host_tier is None:
            kv_host_tier = get_flag("BIGDL_TPU_KV_HOST_TIER", False, bool)
        if not kv_host_tier:
            return
        from bigdl_tpu_torch.serving.host_tier import (HostPageTier,
                                                       HostTierCopier,
                                                       PinnedStaging)
        page_bytes = kv_token_bytes(model, int8_kv,
                                    model.gpt.tok_emb.dtype) * page_size
        if host_tier_bytes is None:
            host_tier_bytes = get_flag("BIGDL_TPU_KV_HOST_TIER_BYTES", 0, int)
        if not host_tier_bytes:
            # four pools' worth of demoted (full-H) pages
            host_tier_bytes = 4 * page_bytes * num_pages
        self.host_tier = HostPageTier(host_tier_bytes)
        if self.device.type == "cuda":
            self.host_staging = PinnedStaging(page_bytes)
        self._host_copier = HostTierCopier(self.host_tier, self.device)

    @staticmethod
    def _layout(tp, mesh, device):
        """The tensor-parallel layout of ``tp``/``mesh`` (see the class
        docstring), or None for the unsharded path."""
        if mesh is not None:
            if device is not None:
                raise ValueError("pass mesh= or device=, not both: mesh= "
                                 "names every shard's device")
            return ModelLayout(mesh)
        if tp is None:
            tp = get_flag("BIGDL_TPU_SERVING_TP", 0, int)
        tp = int(tp or 0)
        if tp <= 1:
            return None
        if device is not None:
            return ModelLayout([device] * tp)
        return ModelLayout(serving_mesh(tp))

    # ---------------------------------------------------------------- serve
    @property
    def stats(self):
        """Dispatch counters: ``prefills`` (dense) or ``prefill_chunks``
        and ``copies`` (paged), ``steps``, ``dispatches``, and
        ``sampled_steps`` (decode steps that launched the sampler; not
        dispatches of their own)."""
        return self.slots.stats

    def submit(self, prompt, max_new_tokens, temperature=0.0,
               eos_token=None, deadline_s=None, priority="standard",
               client_id=None, adapter=None, trace=None):
        """Enqueue one generation request; returns its ``Request`` handle
        at once. Raises ``QueueFullError`` (backpressure),
        ``EngineClosedError`` (after shutdown), ``ValueError`` for a
        request the position table cannot hold or an unknown
        ``priority`` and, paged, ``PagePoolExhausted`` for one the whole
        pool could never hold; under a policy also ``RateLimitedError`` or
        ``AdmissionRejectedError`` (both ``QueueFullError``s).
        ``priority`` and ``client_id`` feed the policy (without one they
        are carried). ``trace`` is an already-minted request-trace ID;
        None mints one (``obs.reqtrace``, while ``BIGDL_TPU_REQ_TRACE`` is
        on) and the handle's ``.trace`` carries it. ``adapter`` names the
        LoRA adapter to decode under (a registered name, or its digest raw
        or hex; None: the base model), resolved at admission: an unknown
        one, or any adapter on an engine without a pool, fails the request
        with ``AdapterLoadError``, never this call."""
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        req = Request(prompt, max_new_tokens, temperature=temperature,
                      eos_token=eos_token, deadline_s=deadline_s,
                      priority=priority, client_id=client_id,
                      adapter=adapter)
        if trace is None and reqtrace.enabled():
            trace = reqtrace.mint()
        req.trace = trace
        t = req.prompt.size
        pmax = self.model.gpt.max_position
        if t + req.max_new_tokens > pmax:
            raise ValueError(
                f"prompt ({t}) + max_new_tokens ({req.max_new_tokens}) "
                f"exceeds max_position ({pmax})")
        if self.paged:
            ps = self.slots.page_size
            worst = (t + req.max_new_tokens - 1) // ps + 1
            if worst > self.slots.num_pages:
                raise PagePoolExhausted(
                    f"request needs up to {worst} page(s) ({t} prompt + "
                    f"{req.max_new_tokens} new tokens, page_size {ps}) but "
                    f"the pool holds only {self.slots.num_pages}")
        reqtrace.event(trace, "submit", request=req.id,
                       engine=self.obs_label, prompt_tokens=int(t),
                       max_new_tokens=int(req.max_new_tokens))
        with obs.span("serve/submit", request=req.id,
                      engine=self.obs_label):
            return self.scheduler.submit(req)

    def submit_many(self, requests):
        """Enqueue a group of requests that one admission pass sees whole,
        whatever the host's timing between them: ``requests`` holds
        :meth:`submit`'s keyword arguments, a dict a request. Returns the
        handles in order; a refused request raises, those before it
        enqueued."""
        with self.scheduler.held_admission():
            return [self.submit(**kw) for kw in requests]

    def resubmit(self, request):
        """Re-enqueue an unfinished handle on THIS engine (the supervisor's
        route): the same ``Request`` object, so the caller's stream stays
        attached; admission re-prefills from ``request.context()``
        (prompt + delivered tokens), so generation resumes where it
        stopped and no token is delivered twice. Bypasses the queue
        bound."""
        if request.done.is_set():
            return request
        reqtrace.event(request.trace, "resubmit", request=request.id,
                       engine=self.obs_label, delivered=len(request.tokens))
        return self.scheduler.submit(request, force=True)

    def cancel(self, handle):
        """Cancel a submitted request (any thread)."""
        return handle.cancel()

    def stream(self, handle):
        """Iterate a request's tokens as they are generated (blocking)."""
        return iter(handle)

    def result(self, handle, timeout=None):
        """Block for completion; returns prompt + generated tokens."""
        return handle.result(timeout)

    def generate(self, prompt, max_new_tokens, timeout=None, **kw):
        """Submit + block. A full queue is retried with exponential
        backoff (``BIGDL_TPU_QUEUE_RETRIES``, 3) before ``QueueFullError``
        propagates; a ``timeout`` that expires cancels the request."""
        retries = get_flag("BIGDL_TPU_QUEUE_RETRIES", 3, int)
        backoff = get_flag("BIGDL_TPU_QUEUE_RETRY_BACKOFF_S", 0.05, float)
        for attempt in range(retries + 1):
            try:
                handle = self.submit(prompt, max_new_tokens, **kw)
                break
            except QueueFullError:
                if attempt >= retries:
                    raise
                time.sleep(backoff * (2 ** attempt))
        try:
            return self.result(handle, timeout=timeout)
        except TimeoutError:
            handle.cancel()
            raise

    # -------------------------------------------------------------- control
    def metrics(self):
        """Live engine metrics: queue and slot occupancy, admission and
        retirement counters, TTFT, decode throughput, dispatch counters,
        the dense cache's or the page pool's statistics (with
        ``tp_degree`` and the per-chip bytes),
        the kernels' launch counts, the count of sharded paged-attention
        calls and the count of int8 products (process-wide: every engine
        adds to one count), and, speculating, the draft's ``spec_proposed``
        / ``spec_accepted`` / ``spec_rollbacks`` tokens over greedy
        requests and ``spec_accept_rate``; the recovery counters
        (``failures``, ``recoveries``, ``quarantined``, and after a
        recovery with a snapshot attached ``recovery_restore_streams``,
        ``recovery_reprefill_streams`` and ``recovery_replayed_tokens``);
        on the paged path ``restored_pages`` and, with their options,
        ``host_tier_*`` and ``snapshot_pages_written`` /
        ``snapshot_pages_restored``; with an adapter pool its ``stats()``
        as ``adapter_*``, and ``lora_products`` (process-wide, the delta's
        products); under a policy ``shed``, ``rate_limited`` and
        ``downtiered``. The reference's keys are all here:
        ``prefill_traces``, ``step_traces`` and (paged) ``copy_traces``
        count prefill, decode-step and copy-on-write dispatches (PyTorch
        compiles nothing, so they grow with every dispatch), and
        ``mesh_devices`` is the serving mesh's device count.

        The reference's counters (queue depth to ``deadline_exceeded``)
        are read from this engine's series on the obs registry; with the
        ``BIGDL_TPU_OBS`` kill switch off they come from the scheduler's
        plain attributes, which are kept either way."""
        sch = self.scheduler
        sl = self.slots
        st = sl.stats.snapshot()
        spec = {} if self.spec_tokens <= 1 else {
            "spec_proposed": sl.spec_proposed,
            "spec_accepted": sl.spec_accepted,
            "spec_rollbacks": sl.spec_rollbacks,
            "spec_accept_rate": (sl.spec_accepted / sl.spec_proposed
                                 if sl.spec_proposed else 0.0)}
        gates = {
            "prefill_traces": st["prefill_chunks" if self.paged
                                 else "prefills"],
            "step_traces": st["steps"],
            "mesh_devices": self.tp,
        }
        if self.paged:
            gates["copy_traces"] = st["copies"]
        if self.policy is not None:
            gates.update(shed=sch.shed, rate_limited=sch.rate_limited,
                         downtiered=sch.downtiered)
        return {
            "device": str(self.device),
            "paged": self.paged,
            **self._counter_metrics(),
            **gates,
            "recovery_restore_streams": sch.restored_streams,
            "recovery_reprefill_streams": sch.reprefilled_streams,
            "recovery_replayed_tokens": sch.replayed_tokens,
            "preempted": sch.preempted,
            "sharded_attention_calls": paged_pool_attention.sharded_calls,
            "paged_attention_launches": paged_pool_attention.launches,
            "paged_attention_int8_launches":
                paged_pool_attention.int8_launches,
            "int8_matmuls": qmatmul.calls,
            "fused_sampling_launches": fused_sample_logits.launches,
            "lora_products": lora_delta.products,
            **self.slots.stats.snapshot(),
            **self.slots.pool_stats(),
            **spec,
            **self._snapshot_metrics(),
            **({} if self.adapter_pool is None else
               {"adapter_" + k: v
                for k, v in self.adapter_pool.stats().items()}),
        }

    def _counter_metrics(self):
        """The reference's counter keys of ``metrics()``: from the obs
        registry, or from the scheduler's attributes while obs is off."""
        sch = self.scheduler
        if not obs.enabled():
            return {
                "queue_depth": sch.queue_depth(),
                "slot_occupancy": self.slots.occupancy(),
                "max_slots": self.slots.max_slots,
                "admitted": sch.admitted,
                "rejected": sch.rejected,
                "retired": sch.retired,
                "generated_tokens": sch.generated_tokens,
                "time_to_first_token_s": sch.ttft_avg(),
                "decode_tokens_per_sec": (
                    sch.generated_tokens / sch.step_seconds
                    if sch.step_seconds else 0.0),
                "failures": sch.failures,
                "recoveries": sch.recoveries,
                "quarantined": sch.quarantined,
                "cancelled": sch.cancelled,
                "deadline_exceeded": sch.deadline_expired,
            }
        o = sch._obs
        _, ttft_sum, ttft_count = o["ttft"].snapshot()
        step_s = o["step_seconds"].value
        toks = int(o["generated_tokens"].value)
        return {
            "queue_depth": int(o["queue_depth"].value),
            "slot_occupancy": int(o["slot_occupancy"].value),
            "max_slots": self.slots.max_slots,
            "admitted": int(o["admitted"].value),
            "rejected": int(o["rejected"].value),
            "retired": int(o["retired"].value),
            "generated_tokens": toks,
            "time_to_first_token_s": (ttft_sum / ttft_count
                                      if ttft_count else None),
            "decode_tokens_per_sec": toks / step_s if step_s else 0.0,
            "failures": int(o["failures"].value),
            "recoveries": int(o["recoveries"].value),
            "quarantined": int(o["quarantined"].value),
            "cancelled": int(o["cancelled"].value),
            "deadline_exceeded": int(o["deadline_exceeded"].value),
        }

    def _snapshot_metrics(self):
        if self.snapshot is None:
            return {}
        store = self.snapshot.store
        return {"snapshot_pages_written": store.pages_written,
                "snapshot_pages_restored": store.pages_restored,
                "snapshot_corrupt_dropped": store.corrupt_dropped}

    def is_alive(self):
        """True while the scheduler thread runs."""
        return self.scheduler.is_alive()

    def shutdown(self, drain=True, timeout=None):
        """Stop accepting requests. ``drain=True`` serves everything
        queued and in flight first; ``drain=False`` fails it with
        ``EngineClosedError``. Returns True when the scheduler thread
        exited (False: wedged in a dispatch). With a snapshot, a clean
        exit takes one last forced pass (the next engine over the
        directory restores the whole prefix cache) and flushes the writer;
        the host tier's copier drains its demotions and stops. The
        engine's ``/healthz`` probe is unregistered first."""
        obs.default_registry().unregister_probe(self._health_probe)
        exited = self.scheduler.shutdown(drain=drain, timeout=timeout)
        snap = self.snapshot
        if snap is not None:
            if exited and self.scheduler.failed is None:
                try:
                    snap.snapshot(self.slots, force=True)
                except BaseException:
                    logger.exception("final kv snapshot failed")
                snap.flush()
            snap.close()
        if self._host_copier is not None:
            self._host_copier.close()
        return exited

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
