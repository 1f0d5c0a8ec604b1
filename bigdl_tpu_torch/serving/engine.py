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
"""

from __future__ import annotations

import time

from bigdl_tpu_torch.models.spec import spec_config
from bigdl_tpu_torch.nn.quantized import qmatmul, quantize_model
from bigdl_tpu_torch.ops.paged_attention import paged_pool_attention
from bigdl_tpu_torch.ops.sampling import fused_sample_logits
from bigdl_tpu_torch.parallel.layout import ModelLayout, serving_mesh
from bigdl_tpu_torch.parallel.tensor_parallel import TensorParallelCausalLM
from bigdl_tpu_torch.serving.paging import (PagedSlotManager,
                                            PagePoolExhausted,
                                            pages_for_budget)
from bigdl_tpu_torch.serving.scheduler import QueueFullError, Request, Scheduler
from bigdl_tpu_torch.serving.slots import SlotManager
from bigdl_tpu_torch.utils.device import resolve_device
from bigdl_tpu_torch.utils.flags import get_flag

# options of the reference engine that are not ported yet, with the
# ROADMAP queue A item that ports each
_UNPORTED = {
    "kv_snapshot": "A.7 serving durability",
    "kv_host_tier": "A.7 serving durability",
    "lora": "A.8 control plane, fleet and multi-tenant serving",
    "adapters": "A.8 control plane, fleet and multi-tenant serving",
    "policy": "A.8 control plane, fleet and multi-tenant serving",
    "failover": "A.4 in-place recovery",
    "max_recoveries": "A.4 in-place recovery",
}
# the reference's flags that turn an unported option on when its keyword
# is not given
_UNPORTED_FLAGS = {"kv_snapshot": "BIGDL_TPU_KV_SNAPSHOT",
                   "kv_host_tier": "BIGDL_TPU_KV_HOST_TIER",
                   "lora": "BIGDL_TPU_LORA",
                   "policy": "BIGDL_TPU_ADMISSION_SLO"}
# unported options of the reference's paged path alone, with the reason the
# reference gives for refusing each by keyword on the dense path (it reads
# their flags only under ``paged``, so the dense engine ignores those)
_PAGED_ONLY = {
    "kv_snapshot": "the store's unit of persistence is the K/V page",
    "kv_host_tier": "the tier's unit of residency is the K/V page",
}
# sub-options of unported options: accepted and ignored while their parent
# is off, as the reference ignores them
_SUB_OPTIONS = {
    "snapshot_dir": "kv_snapshot",
    "snapshot_interval_s": "kv_snapshot",
    "snapshot_journal": "kv_snapshot",
    "host_tier_bytes": "kv_host_tier",
    "host_tier_prefetch": "kv_host_tier",
    "lora_rank": "lora",
    "adapter_slots": "lora",
    "adapter_host_bytes": "lora",
}


def _unported_on(name, value):
    """Does the unported option ``name`` (keyword ``value``, None if not
    given) ask for its feature? An explicit keyword wins over its flag."""
    if name == "max_recoveries":
        # a budget of 0 gives up at the first error, as the port does
        return value is not None and value is not False and int(value) > 0
    if value is None:
        flag = _UNPORTED_FLAGS.get(name)
        return flag is not None and get_flag(flag, False, bool)
    return value is not False


def _refuse_unported(options, paged):
    """Raise ``TypeError`` on an unknown keyword, and
    ``NotImplementedError`` naming the ROADMAP item when an unported
    option (by keyword or by the reference's flag) asks for its feature
    on the path it applies to. On the dense path a ``_PAGED_ONLY`` option
    asked for by keyword raises ``ValueError`` as in the reference, and
    its flag is ignored."""
    for name in options:
        if name not in _UNPORTED and name not in _SUB_OPTIONS:
            raise TypeError(f"unexpected keyword argument {name!r}")
    for name, item in _UNPORTED.items():
        if name in _PAGED_ONLY and not paged:
            if options.get(name):
                raise ValueError(f"{name} requires paged=True ("
                                 f"{_PAGED_ONLY[name]})")
            continue
        if not _unported_on(name, options.get(name)):
            continue
        subs = [s for s, parent in _SUB_OPTIONS.items()
                if parent == name and options.get(s) is not None]
        given = f" with {', '.join(subs)}" if subs else ""
        raise NotImplementedError(
            f"ServingEngine({name}=...){given} is not ported yet (ROADMAP "
            f"queue {item})")


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
    paged: serve from the paged K/V pool (``BIGDL_TPU_PAGED_KV``, off: the
        dense slot table). ``self.paged`` reports the path taken. The
        options below up to ``kv_bytes`` are the paged path's; the dense
        path ignores them, as the reference does. ``kv_snapshot`` /
        ``kv_host_tier`` are the paged path's too: by keyword the dense
        path refuses them with ``ValueError``, their flags it ignores.
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

    The reference's other options (LoRA, K/V snapshots, the host tier,
    the control plane, recovery) raise ``NotImplementedError`` naming the
    ROADMAP item that ports them, when given by keyword or turned on by
    the reference's flag (``BIGDL_TPU_KV_SNAPSHOT``,
    ``BIGDL_TPU_KV_HOST_TIER``, ``BIGDL_TPU_LORA``,
    ``BIGDL_TPU_ADMISSION_SLO`` for ``policy``; a keyword wins over its
    flag). ``max_recoveries=0`` is served: at that budget the reference
    gives up at the first error, failing every request with
    ``EngineFailedError``, as the port does at any budget. Their sub-options (``snapshot_dir``,
    ``snapshot_interval_s``, ``snapshot_journal``, ``host_tier_bytes``,
    ``host_tier_prefetch``, ``lora_rank``, ``adapter_slots``,
    ``adapter_host_bytes``) are ignored while the parent is off.
    """

    def __init__(self, model, params=None, max_slots=8, max_queue=64,
                 prefill_window=4, admit_wait_s=0.0, steps_per_sync=1,
                 top_k=None, top_p=None, seed=0, default_deadline_s=None,
                 paged=None, page_size=None, kv_pages=None,
                 prefill_chunk=None, prefix_cache=None, int8_weights=None,
                 int8_kv=None, kv_bytes=None, device=None, tp=None,
                 mesh=None, spec_tokens=None, **unported):
        if paged is None:
            paged = get_flag("BIGDL_TPU_PAGED_KV", False, bool)
        self.paged = bool(paged)
        _refuse_unported(unported, self.paged)
        if getattr(model, "gpt", None) is None:
            raise TypeError("ServingEngine drives GPTForCausalLM models")
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
            self.slots = PagedSlotManager(
                model, max_slots, num_pages=kv_pages, page_size=page_size,
                window=prefill_window, steps_per_sync=steps_per_sync,
                prefill_chunk=prefill_chunk, prefix_cache=prefix_cache,
                top_k=top_k, top_p=top_p, seed=seed, int8_kv=bool(int8_kv),
                spec_tokens=self.spec_tokens)
        else:
            self.slots = SlotManager(model, max_slots, window=prefill_window,
                                     steps_per_sync=steps_per_sync,
                                     top_k=top_k, top_p=top_p, seed=seed,
                                     spec_tokens=self.spec_tokens)
        self.scheduler = Scheduler(self.slots, max_queue=max_queue,
                                   admit_wait_s=admit_wait_s)

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
        pool could never hold. ``priority`` and ``client_id`` are carried
        on the request and ``trace`` on the handle (``.trace``); a request
        naming an ``adapter`` fails at admission with ``AdapterLoadError``
        (see ``scheduler.Request``)."""
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        req = Request(prompt, max_new_tokens, temperature=temperature,
                      eos_token=eos_token, deadline_s=deadline_s,
                      priority=priority, client_id=client_id,
                      adapter=adapter)
        req.trace = trace
        t = req.prompt.size
        pmax = self.model.gpt.max_position
        if t + req.max_new_tokens > pmax:
            raise ValueError(
                f"prompt ({t}) + max_new_tokens ({req.max_new_tokens}) "
                f"exceeds max_position ({pmax})")
        if not self.paged:
            return self.scheduler.submit(req)
        ps = self.slots.page_size
        worst = (t + req.max_new_tokens - 1) // ps + 1
        if worst > self.slots.num_pages:
            raise PagePoolExhausted(
                f"request needs up to {worst} page(s) ({t} prompt + "
                f"{req.max_new_tokens} new tokens, page_size {ps}) but the "
                f"pool holds only {self.slots.num_pages}")
        return self.scheduler.submit(req)

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
        requests and ``spec_accept_rate``."""
        sch = self.scheduler
        sl = self.slots
        spec = {} if self.spec_tokens <= 1 else {
            "spec_proposed": sl.spec_proposed,
            "spec_accepted": sl.spec_accepted,
            "spec_rollbacks": sl.spec_rollbacks,
            "spec_accept_rate": (sl.spec_accepted / sl.spec_proposed
                                 if sl.spec_proposed else 0.0)}
        return {
            "device": str(self.device),
            "paged": self.paged,
            "queue_depth": sch.queue_depth(),
            "slot_occupancy": self.slots.occupancy(),
            "max_slots": self.slots.max_slots,
            "admitted": sch.admitted,
            "rejected": sch.rejected,
            "retired": sch.retired,
            "generated_tokens": sch.generated_tokens,
            "time_to_first_token_s": sch.ttft_avg(),
            "decode_tokens_per_sec": (sch.generated_tokens / sch.step_seconds
                                      if sch.step_seconds else 0.0),
            "failures": sch.failures,
            "cancelled": sch.cancelled,
            "deadline_exceeded": sch.deadline_expired,
            "preempted": sch.preempted,
            "sharded_attention_calls": paged_pool_attention.sharded_calls,
            "paged_attention_launches": paged_pool_attention.launches,
            "paged_attention_int8_launches":
                paged_pool_attention.int8_launches,
            "int8_matmuls": qmatmul.calls,
            "fused_sampling_launches": fused_sample_logits.launches,
            **self.slots.stats.snapshot(),
            **self.slots.pool_stats(),
            **spec,
        }

    def is_alive(self):
        """True while the scheduler thread runs."""
        return self.scheduler.is_alive()

    def shutdown(self, drain=True, timeout=None):
        """Stop accepting requests. ``drain=True`` serves everything
        queued and in flight first; ``drain=False`` fails it with
        ``EngineClosedError``. Returns True when the scheduler thread
        exited."""
        return self.scheduler.shutdown(drain=drain, timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
