#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``bigdl_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --baseline DIR   # also time DIR's sampler

Phases, each printing one JSON line (any failure exits non-zero):

1. device  — require CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them.
2. build   — compile every kernel source under ``bigdl_tpu_torch/ops/
   csrc`` (one ``nvcc`` per source, all at once) and report the seconds.
3. kernels — call each kernel's wrapper on card tensors at the shapes its
   path gives it, hold it against its plain PyTorch version on the same
   inputs, and time both with CUDA events beside the kernel's roofline
   bound. Every kernel and its library yardstick are timed queued behind
   a spin kernel (the launches' device time back to back, without the
   host's gaps), the L2 flushed before each run, as the median of three
   readings with their spread;
   * paged attention: 8 slots, 12 heads, head_dim 64, page_size 16, 64
     table entries, shared pages and sentinel tails; decode (C=1, all 8
     slots) and a prefill chunk (C=64, the 4-row prefill window); float32
     (max abs error <= 2e-5) and bfloat16 (atol = rtol = 2e-2); the same
     cases at pages of 8 and 32 tokens (1024 positions a row), and at
     pages of 16 with heads of 32, 96 and 128, are held to the same
     tolerances (not timed), at pages of 16 with heads of 32, 33, 34, 36,
     72, 80, 96, 128 and 256 (timed; 33-36 run on the built width 64, 72
     and 80 on 96, over pools of their true width; each pool's rows are
     then staged by copies of 16, 8, 4 and 1 bytes, and each must run)
     and with heads of 80 and 256 at pages of 8 and 32 (held), and at heads
     of 320 and 512 (timed; the width-256 kernel in two chunks a row); at
     pages of 16 a second call must equal the first bit for bit; and the
     speculative verify chunk (B 8, C = SPEC_TOKENS = 4 queries a slot at
     the decode slots' committed lengths, row 7 inactive) at pages of 16,
     head 64, held and timed in both query types (a 16-query tile runs
     the 4 queries);
   * int8 paged attention: the same shapes, page sizes and query types over
     an int8 pool with float32 scale planes, written by the port's
     ``paged_write_quant`` from random float K/V; the same tolerances;
   * tensor-parallel paged attention (queue B row 6): the same decode and
     chunk cases (and the verify chunk) over float32 and int8 pools,
     float32 queries, split on
     the head axis into 2 and 4 shards (each shard its own contiguous
     pool, all on cuda:0) and launched once per shard through the
     wrapper's ``mesh=`` branch; the joined outputs must equal the
     unsharded kernel's bit for bit and the plain version within 2e-5
     (also at heads of 128, 256 and 512, tp 2, held only);
     timed as one sharded call beside the unsharded kernel, both queued
     ahead of the card behind a spin kernel (device time, without the
     host's gaps), the median of three readings with their spread;
   * fused sampling: 8 x 50257 logits (per-row temperatures) and 8 x
     128256 (Llama-3's vocabulary; temperature 0.8), both in the cluster's
     shared memory, float32 and bfloat16, at (top_k, top_p) = (50, 0.9),
     (50, None), (None, 0.9) and (None, None); tied bfloat16 rows (uniform
     in [0, 1)) at (50, 0.9) and (2000, 0.9); 2 x 600000 (past MAX_VOCAB:
     re-read from global memory) at (50, 0.9) and (None, 0.9); one
     injected gumbel draw a case. Tokens must be identical except on a row
     whose kept-set boundary lies within 1e-5 of its level (printed); a
     second call bit-equal; each row alone (S = 1) equal to its token in
     the batch; the paths the kernel reports equal to the plain version's
     (the draw alone, the small kept set and the cluster's top-p rounds
     must all run); each call on its variant's counter. Timed beside the
     plain version, the PyTorch chain of the same draw
     (``models.gpt.sample_logits``), and with ``--baseline DIR`` the
     sampler of the checkout at DIR (the parent commit's), on the same
     inputs; the bound counts the kept set's noise (``kept_ref``);
   * flash attention (forward, dQ, dK/dV): the training path's (B*H = 96,
     S = 1024, D = 64) causal, one non-causal case with an lse cotangent,
     one ragged causal case (S = 1000) and the path's shape at D = 128,
     32 and 80 (those two zero-padded to the 64 and 128 kernels), each in
     float32 (the CUDA-core kernels) and bfloat16 (the tensor-core
     kernels), and at D = 160 and 256, causal and full with an lse
     cotangent, in both types on the CUDA-core kernels (160 zero-padded to
     256), and at D = 320 and 512 (B 4, H 2), causal at S = 1024 and full
     with an lse cotangent at S = 1000, on the width-256 CUDA-core kernels
     in two chunks a row (320 zero-padded to 512), and at BERT-base's
     shapes (FLASH_BERT_CASES, D = 64, both types, timed: full attention
     at 128 x 128 and 16 x 512, a dp 2 x sp 4 ring chunk pair B 4 x 128
     and a 32-position chunk B 128 with an lse cotangent, and a causal
     ring diagonal 1 x 256 with one; SDPA, the yardstick, takes no lse
     cotangent); each call on the path
     ``flash_attention.path`` names, and a
     bfloat16 kernel's second call (at D other than 64 and 128 every
     kernel's) equal to its first bit for bit. float32
     max abs error <= 2e-5 for O and lse and <= 1e-4 for the gradients
     (the same float32 math summed in another order, over up to 1024
     keys); bfloat16 atol = rtol = 2e-2 (outputs rounded to bfloat16, p
     rounded at a running maximum in the kernel). The path, D = 128, 32
     and 80 cases in both types are timed beside the library yardstick:
     ``F.scaled_dot_product_attention(is_causal=True)`` forward, and its
     backward (one call yields dQ, dK and dV, so both backward rows carry
     that time; timed at D 64, 128, 32, 80, 160, 256, 320 and 512); the
     backend that ran is printed;
   * 3x3 convolution, tap-sum (k9) and im2col (i2c): ResNet-50's four
     stride-1 3x3 shapes at batch 256 (56x56x64, 28x28x128, 14x14x256,
     7x7x512, NHWC), bfloat16 (the tensor-core path) and float32 (the
     CUDA-core path; the path each call took is checked against
     ``tc_eligible``), forward and ``flip`` (the input gradient), each
     timed. Max abs error <= 1e-4 x max|plain| in float32 (the same
     float32 sums in another order over 9*Cin <= 4608 terms) and <= 2e-2 x
     max|plain| in bfloat16 (``scripts/perf_pallas_conv.py``'s own bar; the
     outputs are rounded to bfloat16). The library yardstick is cuDNN on
     the same channels-last tensors (TF32 off for float32): ``F.conv2d``
     forward, and for flip ``F.conv2d`` of dy with the rotated weights
     made once outside the timing; the cuDNN kernels that ran are printed.
     Eight ragged bfloat16 shapes (CONV_RAGGED: partial tiles, Cin not a
     multiple of 64, Cout not a multiple of the channel tile) are held on
     both kernels' tensor-core paths too, not timed. VGG-16's and
     Inception-v1's shapes at batch 32 (CONV_MODEL_SHAPES: 224² x 3 -> 64,
     which runs on the CUDA cores even in bfloat16, 224² x 64, 112² x 64
     -> 128 and 128, 28² x 96 -> 128, 14² x 144 -> 288, 7² x 192 -> 384),
     each direction on the kernel its route takes, in both types: held at
     the same bars on the path ``tc_eligible`` names and timed beside
     cuDNN, the bound and the plain version (``model_shapes`` of the
     entries).
4. slice   — GPT-2 small at full width (12 layers, hidden 768, 12 heads,
   vocab 50257, context 1024), float32, seeded random weights: the paged
   ``ServingEngine`` serves 12 requests (prompts of 24-700 tokens, two
   sharing a 256-token prefix, 8 greedy and 4 at temperature 0.8, 64 new
   tokens each). Checks: every request retires with its tokens; the
   paged-attention kernel launched once per layer for every prefill chunk
   and decode step, the sampler at least once; the prefix cache hit; the
   first 16 greedy tokens of two requests equal the port's run on the CPU
   (plain versions), or diverge only at a step whose top-2 logit gap on
   the CPU is below 1e-3 (printed); the sampler launched once per decode
   step with a sampled row. Then the same traffic, with fresh
   prompts, runs once more under ``torch.profiler`` (a ``profile`` line):
   the device's busy time against the wall time, the kernels that take
   the most device time, and the paged-attention and sampling kernels'
   shares (likewise in every serving phase).
4a. slice_spec — ``slice`` with ``spec_tokens=4``: the same engine,
   weights and traffic. Checks: every request retires with its tokens;
   the paged kernel exactly 12 times a prefill chunk and verify
   iteration, the int8 one never; the sampler once per iteration with a
   sampled row; proposed = accepted + rejected; greedy tokens of requests
   0 and 11 against ``slice``'s engine and the CPU run (the near-tie
   rule). Reports tokens/s, TTFT and the accept rate beside ``slice``'s,
   and a ``profile`` line. Then the repetitive stream: 4 greedy prompts,
   each a random 16-token cycle repeated to 128 tokens, 128 new tokens,
   through the paged engine without and with speculation (the
   reference's ``test_spec_accept_rate_on_repetitive_stream`` at GPT-2
   small): both runs' tokens against the greedy loop driven by hand on
   the card (the near-tie rule), the accept rate and both tokens/s.
4b. slice_dense — the same model, weights and traffic through
   ``ServingEngine(model, params, max_slots=8)`` with no ``paged`` and
   no flag: the dense slot table, the reference's default. Checks: every
   request retires with its tokens; no paged-attention and no flash
   launch (every prompt bucket is at most 1024); one sampler launch per
   decode step with a sampled row; greedy tokens of requests 0 and 11
   against ``slice``'s CPU run (the near-tie rule). Reports tokens/s,
   TTFT, peak memory and the dense table's bytes beside ``slice``'s, and
   a ``profile`` line. Then ``slice_dense_tp``: the dense path at tp 2 on
   the one card, 4 greedy requests through the engine, their first 16
   tokens against the unsharded dense model's hand-driven on the card
   (the same rule), the shards' measured cache bytes. Then
   ``slice_dense_spec``: the dense engine with ``spec_tokens=4`` on the
   same traffic (no paged or flash launch; tokens against
   ``slice_dense``'s engine and the CPU run, the near-tie rule).
4c. generate — ``GPTForCausalLM.generate`` at GPT-2 small: 4 prompts of
   100 tokens, 64 new, greedy (rows equal to a 4-slot dense engine's on
   the same prompts) and sampled at (50, 0.9), T 0.8 (one sampler launch
   a token); a 1000-token prompt through ``_generate_sliding`` (12 flash
   forward launches a token; its first 16 tokens against the CPU's
   sliding loop); and GPT-2's widths with a 4096-position table (not a
   published model) on a 1500-token prompt, whose 2048-bucket prefill
   passes the reference's flash gate: 12 flash launches, 16 greedy
   tokens against the CPU run. ``generate_spec``: the greedy prompts
   again with ``spec_tokens=4``: rows equal to the plain call's or
   diverging first where the plain loop's top-2 gap is below 1e-3,
   tokens/s beside the plain call's.
5. slice_int8 — the same model, weights and traffic through
   ``ServingEngine(int8_weights=True, int8_kv=True, kv_bytes=...)``, the
   byte budget of the float32 slice's 512-page pool. Checks: every request
   retires with its tokens; the int8 paged kernel launched exactly once
   per layer for every prefill chunk and decode step and the float one
   never; 6 int8 products a layer per dispatch; the prefix cache hit. Card
   against CPU: prompts 0 and 11 through a hand-driven 2-slot
   ``PagedSlotManager`` on each (int8 weights couple the rows of a batch,
   so the engine's batching is kept out of it), 16 greedy tokens,
   identical or diverging only where the CPU top-2 logit gap is below
   ``INT8_GAP`` (0.1; the line also reports how far the CPU logits move
   when the embeddings move by 2^-23). Reports tokens/s, TTFT, the pool's
   pages and bytes per token against the float32 slice, the weight bytes,
   and a ``profile`` line for the int8 burst. Then ``slice_spec_int8``:
   the same engine with ``spec_tokens=4``: every request retires, exactly
   12 int8 kernel launches a prefill chunk and verify iteration and no
   float one, 72 int8 products a dispatch; its per-token agreement with
   ``slice_int8``'s engine is reported, not held (int8 weights couple a
   dispatch's rows, and a verify dispatch has 4 times a step's).
6. slice_tp, slice_tp_int8 — ``slice``'s model, weights and traffic served
   tensor-parallel: ``ServingEngine(mesh=["cuda:0", "cuda:0"])`` (tp 2,
   both shards on the one card; the source model built on the CPU, so the
   card holds only the shards), float32 pools, then ``int8_kv=True``,
   each with ``kv_bytes`` = the float32 slice's pool bytes as a per-chip
   budget (so ``pages_for_budget(..., tp=2)`` pages: twice the float
   slice's 512, 3855 int8). Checks: every request retires; the pool's
   paged kernel launched exactly tp x 12 times per prefill chunk and
   decode step (once per shard and layer), the other never; one sharded
   call per layer and dispatch; the sampler once per sampled decode step,
   not tp times; each shard holds 1/tp of the pool's bytes (measured).
   Greedy tokens of requests 0 and 11 against ``slice``'s CPU run (float)
   or a CPU ``int8_kv`` run of the unsharded port (int8), diverging only
   where the CPU top-2 gap is below 1e-3 or 0.1. Reports tokens/s, TTFT
   and peak memory beside the unsharded phase's, and a ``profile`` line.
   After ``slice_tp``, ``slice_spec_tp``: ``slice_spec`` at tp 2 on the one
   card (float32 pools at ``slice_tp``'s budget): exactly tp x 12 row-6
   launches a prefill chunk and verify iteration, one sharded call a
   layer and dispatch; greedy tokens against ``slice_spec``'s engine and
   the CPU run (the near-tie rule).
6b. slice_tp_int8w — ``slice_int8``'s model and traffic at tp 2 on the
   one card with int8 weights (``mesh=["cuda:0", "cuda:0"], paged=True,
   int8_weights=True, int8_kv=True``): the weights quantised, then split.
   Checks: every request retires; exactly tp x 12 int8 kernel launches
   per prefill chunk and decode step; tp x 6 int8 products a layer per
   dispatch (tp times the unsharded count); a hand-driven 2-slot run of
   requests 0 and 11 on the shards with logits bit-equal, step by step,
   to ``slice_int8``'s unsharded card run; the engine's tokens of those
   requests equal to ``slice_int8``'s engine's, or diverging only where
   that run's top-2 gap is below 0.1. Reports tokens/s, TTFT, the
   shards' weight bytes, and a ``profile`` line.
6c. resilience (after ``slice_tp_int8w``; ``slice``'s model, weights and
   traffic, float32):
   * slice_recovery — the paged and the dense engine under the fault plan
     RECOVERY_PLAN (two consecutive step faults: the second lands in the
     recovery's own probe block, so the group is bisected; a third step
     fault later, a second recovery; one admission fault; paged, two
     forced page exhaustions). Checks: 12 of 12 retired; at least 2
     recoveries; greedy tokens equal the no-fault phase's (``slice`` /
     ``slice_dense``) or first differ where the CPU run's top-2 logit gap
     is below 1e-3, and requests 0 and 11 against the CPU run (the
     near-tie rule); paged, exactly 12 kernel launches per prefill chunk
     and step, re-placement included; one sampler launch per sampled
     step. Then a poisoned request (``serving.step:error:req=<id>``) on
     the dense engine: it alone fails (quarantined), the other 11 retire,
     greedy ones as without the fault. Prints the seconds from each fired
     fault to the next delivered token.
   * slice_fault_sticky — a child process (``--sticky-child``) serves 4
     of the requests on the paged engine; inside its third decode step an
     out-of-range index into a card tensor raises a device-side assert, a
     sticky CUDA error. Checks, from the child's JSON line: every handle
     resolved with ``EngineFailedError`` (or ``CircuitOpenError``) caused
     by a CUDA error, no token delivered after the fault, the child done
     within 90 s. The parent's CUDA context is never touched.
   * slice_supervisor — ``EngineSupervisor`` over a paged-engine factory
     at ``max_recoveries=0``, one step fault: exactly one restart, the 8
     greedy requests resubmitted and as without the fault (the near-tie
     rule); prints the restart's seconds and each engine build's.
   * slice_host_tier — 2 slots, a 96-page pool of pages of 16, four
     distinct 512-token prompts one after another, then the first two
     again, 64 greedy tokens each (a stream holds 36 pages, so the first
     two are evicted, demoted, and promoted), on float32 and int8 pools
     and at tp 2 on the one card, each beside the same traffic with the
     tier off. Checks: tokens identical to the tier-off run; at least 32
     promoted pages a repeated prompt; ``prefix_miss_tokens`` lower than
     the tier-off run's by 16 a promoted page; every resident host buffer
     mangled (``corrupt_planes``), the third prompt again re-prefills with
     identical tokens; exactly 12 (tp 2: 24) kernel launches per chunk
     and step. Prints the pinned bytes and their allocation's seconds,
     and demote / promote MB/s of 32 pages through the pinned ring.
   * slice_snapshot — an engine with ``kv_snapshot=True`` over a
     temporary directory serves the 8 greedy requests and shuts down
     (flushed); a new engine over the directory serves them again: at
     least the 16 pages of the shared 256-token prefix restored, tokens
     as before (the near-tie rule); a tp 2 engine restores the same
     store; under ``serving.snapshot_write:corrupt`` the next engine
     demotes every page it tries and re-prefills, same tokens. Prints the
     restore and re-prefill seconds and the bytes written.
6d. slice_lora — multi-tenant LoRA (``ServingEngine(lora=True)``) on
   ``slice``'s model, weights and traffic: four tenants' adapters (rank 8,
   alpha 8, the six default targets, drawn from seeds with B ~ 0.5 N(0,
   1)); requests 0, 4 and 8 decode the base model, the other nine cycle
   the tenants; every greedy adapter request's oracle tokens differ from
   its base-model oracle's and another tenant's. ``lora_paged``: paged, pages of 16, chunk 64, 2 adapter
   rows, a host tier for 4 adapters: 12 of 12 retired; at least 4 loads,
   2 evictions and 1 host-tier hit; exactly 12 paged launches a chunk and
   step; one sampler launch a sampled step; 2 x 6 x 12 LoRA products a
   dispatch with an adapter row; no more gathers than changes of the
   batch's (rows, loads) key; then a ``profile`` line of the same traffic.
   ``lora_dense``: the dense engine, 4 rows, the same holds but no paged
   launch. Then a ``profile`` line of 16 decode steps of an 8-slot mixed
   batch (4 tenants and the base model) driven by hand on this thread,
   every delta in a ``lora_delta`` range: its share of device time (the
   profiler sees the ranges of its own thread only). Greedy adapter streams against their
   single-adapter oracles (a hand-driven 2-slot paged or dense manager
   under ``models.lora.SingleAdapter``) and the base rows against
   ``slice`` / ``slice_dense``'s tokens, by the near-tie rule; requests 0
   and 11 against the CPU under the same adapters. ``lora_variants``: 4
   greedy requests (2 base, 2 under t0 / t1), 16 tokens, on the paged
   engine with int8 weights and K/V (int8 slabs; 12 int8-kernel launches
   and 72 int8 products a dispatch; the same burst through the same engine
   on the CPU, batch for batch, holds the tokens to 0.1; the agreement
   with an int8 oracle reported), at tp 2 on the
   one card (2 x 12 launches a dispatch; 22 x 12 LoRA products: the
   row-parallel targets' B once after the shards' rank-r sum) and
   with ``spec_tokens=4`` (12 a verify iteration), tokens against the
   oracles. ``lora_faults``: a corrupt host-tier copy is dropped and the
   registry serves (tokens against the oracle); an injected load error
   fails that request alone with ``AdapterLoadError``. Reports tokens/s and
   TTFT beside ``slice`` and ``slice_dense``, the busy share, the LoRA
   range's share of device time, peak memory, load, eviction and swap
   seconds.
6e. slice_control — the control plane and its telemetry on ``slice``'s
   model, weights and prompts: the paged engine under a
   ``ControlPolicy(base_ttft_s=0.01)`` (the tiers' TTFT SLOs at
   CONTROL_SLO_S, so none of the measured traffic is shed) serves the 12
   requests with priorities alternating best-effort / interactive and
   three clients: every greedy request's tokens as ``slice``'s engine
   gave them (the near-tie rule; whether identical is reported), requests
   0 and 11 against the CPU as ``slice``'s were; exactly 12 paged
   launches a chunk and step, one sampler launch a sampled step. An obs
   ``MetricsServer`` on ``127.0.0.1:0`` is scraped: ``/metrics`` shows
   ``bigdl_serving_ttft_seconds_count`` equal to the requests retired, the
   page gauges, and ``bigdl_mfu`` (the modelled flops' rate between two
   scrapes over 989 TFLOP/s) in (0, 1]; ``/trace`` holds one
   ``serve/step`` span on the scheduler thread a decode step; ``/healthz``
   gives 200; ``/profile?seconds=1`` taken while the traffic is served
   (a second call 409) writes a ``torch.profiler`` trace whose CUDA
   kernels include ``paged_attention_kernel`` and ``fused_sample_kernel``.
   The same traffic (fresh prompts) runs with obs on and with
   ``obs.set_enabled(False)`` in turns (on, off, off, on), each profiled:
   tokens/s and the busy share of every run are reported, with no bar. Overload: a second engine (8 slots, a queue
   of 4) under ``serving.step:delay=0.05`` takes 16 best-effort
   submissions, then 3 interactive ones: all three complete, at least 3
   best-effort requests are shed with ``AdmissionRejectedError`` before
   any token (``bigdl_serving_shed_total`` by priority agrees), nothing
   hangs; then a client past its bucket of 4 gets ``RateLimitedError``.
6f. slice_fleet — the engine fleet (``serving.router.EngineFleet``) on
   ``slice``'s model, weights and traffic: two supervised replicas of
   ``slice``'s paged engine on the one card (``make_tp_factory(...,
   devices=["cuda:0", "cuda:0"])``, the source model on the CPU, each
   replica snapshotting into one shared directory under its own journal),
   rendezvous routing on blocks of 16, failover on. The 12 requests: all
   retire; the greedy ones as ``slice``'s engine gave them (the near-tie
   rule); requests 3 and 9 routed to one replica, whose prefix cache hits
   at least 256 tokens; exactly 12 paged launches a prefill chunk and
   decode step summed over the replicas, one sampler launch a sampled
   step. An evacuation: greedy requests 0, 2, 3 and 11 (64 new tokens,
   all routed to replica 0); once each has its first tokens,
   ``evacuate_replica(0)`` migrates them to replica 1: every migrated
   stream finishes with the fleet's own tokens of the first part (the
   near-tie rule), its stream delivers each token once,
   ``bigdl_fleet_migrations_total`` counts them, at least one resumes by
   restoring pages from the shared store, the launch counts hold through
   the restore; the seconds from the evacuation to each migrated stream's
   next token. Replica 0 then comes back: the watcher re-arms its circuit
   after 1 s, its supervisor rebuilds the engine (adopting none of the
   migrated streams), and canary picks readmit it. The ``AutoScaler``
   over the fleet: 32 short requests held by ``serving.step:delay=0.05``
   (the schedulers' locks held while they are submitted) and one ``step``
   scales it to 3 replicas; with replica 1's circuit opened,
   ``scale_to(2, prefer_unhealthy=True)`` retires replica 1, not the
   newest. After ``close()`` the card's allocated memory is within 64 MiB
   of what it was before the phase. Reports tokens/s beside ``slice``'s
   (two replicas on one card: the fleet's cost, not a gain), and the same
   traffic's tokens/s through two replicas without the snapshot store or
   failover (``no_store_tokens_per_s``), with the pages each replica's
   store wrote.
6g. train_preempt — preemption of a training run through the facade:
   ResNet-50 (ImageNet, NHWC, float32), 96 seeded records in batches of 32
   (3 an epoch), pinned shuffles, ``SGD(0.01)``, 4 iterations: once
   uninterrupted, once under ``train.step:preempt:after=2:times=1``, which
   raises ``TrainingPreempted`` after the third step with the final
   checkpoint ``model.4`` / ``optimMethod.4`` (3 steps taken; ``model.4``
   in the native format, the ResNet as the reference's graph of its named
   layers, which ``load_module`` builds back into a ResNet), and once
   resumed from that checkpoint for the last iteration, all three with
   cuDNN's deterministic algorithms (without them two uninterrupted runs
   differ from the second step on). Checks: the preempted and resumed
   losses within 1e-4 relative of the uninterrupted run's; each run's CUDA-core conv launches equal ``conv_routes`` times
   its steps, no tensor-core launch, no 3x3 stride-1 ``F.conv2d``;
   ``bigdl_train_steps_total`` and the ``train/dispatch`` spans one a
   step. LeNet-5 through the facade, preempted by a real SIGTERM that its
   summary sends this process at iteration 2: ``TrainingPreempted`` with
   the reason ``SIGTERM`` and the checkpoint on disk, the previous handler
   back afterwards. LeNet-5 through ``DistriOptimizer`` on two replicas of
   the card: ``allreduce.sync:error:after=3`` retried once from the
   checkpoint, ``train.step:preempt`` raised through the retry loop with
   its ``driverState``.
6h. train_sharded — sharded checkpoints (``BIGDL_TPU_SHARDED_CHECKPOINT``)
   and the collectives' timing, on two replicas of the card: ResNet-50
   (NHWC, float32, 1000 outputs, labels of 10 classes) through
   ``DistriOptimizer``, 96 seeded records in batches of 32 in one seeded
   order every epoch, ``Adam(1e-3)``, a sharded checkpoint every 2
   iterations, 6 iterations, cuDNN's deterministic algorithms; once
   uninterrupted and once with the fifth batch failing. Checks:
   ``shard.2.p0`` and ``shard.4.p0`` written, shard 4 holding two master
   blocks at starts 0 and ``slice_size``; ``model.4`` the marker file (the
   native format, its root carrying ``_sharded_weights_marker``); one
   retry, resumed from the sharded set at 4; every step's loss equal to
   the uninterrupted run's bit for bit, the recomputed fourth included;
   CUDA-core conv launches = ``conv_routes`` x 2 replicas x the steps each
   run took, no tensor-core launch, no 3x3 stride-1 ``F.conv2d``. Then
   ``allreduce_bandwidth(["cuda:0", "cuda:0"], size_mb=64)`` in both
   patterns: seconds and ring bytes, no bandwidth figure, two
   ``bigdl_allreduce_sync_seconds`` observations, ``ici_peak_gbps()``.
6i. infer_int8 — post-training int8 quantisation of ResNet-50 (NHWC,
   float32, seeded weights, evaluation mode) at batch 32 x 224²:
   ``Quantizer.quantize(model, calib_input=batch)`` and
   ``Quantizer.quantize(model)`` on the card. Checks: top-1 of both agrees
   with the float model's on at least ``INT8_TOP1_AGREE`` of the rows; no
   ``F.conv2d`` in their forwards; every static scale of a calibration on
   the first 8 images within 1e-5 relative of the port's calibration on
   the CPU; both int8 models' log-probabilities on those rows within
   ``INT8_MODEL_TOL`` of the same int8 models on the CPU
   (``tests/test_torch_quantizer.py``'s bars); the int32 accumulators of
   the stem, a 1x1, a 3x3 and a strided 3x3 on the card's int8 inputs
   equal to a float64 CPU convolution of the same values. Reports
   images/s of the float32, int8 static and int8 dynamic forwards, and
   the int8 products' share of device time in one profiled forward.
6j. train_rnn — ``PTBModel()`` (vocabulary 10000, hidden 256, 2 LSTM
   layers) on a seeded Zipf stream cut by ``ptb_batches(20, 20)``: the
   first step's loss and gradients on the card against the port on the
   CPU (1e-6 relative; 1e-4 of each gradient's largest magnitude), then 5
   steps through ``Optimizer`` with ``TimeDistributedCriterion(
   ClassNLLCriterion(), size_average=True)`` and ``Adam(0.01)``, the loss
   falling; ms a step, tokens/s and the busy share of ``make_train_step``.
   ``Recurrent(ConvLSTMPeephole(16, 16, 3, 3))`` on (8, 6, 16, 32, 32),
   forward and backward against the CPU (outputs 1e-5, gradients 1e-4 of
   their max), with exactly 2T + T + (T - 1) CUDA-core 3x3 launches (the
   forward's two a step, the input gradient of each but the zero state's)
   and no 3x3 stride-1 ``F.conv2d``; the ``stride=2`` and 3-D cells
   forward. ``LookupTable`` + ``BinaryTreeLSTM`` + ``TreeGather`` +
   ``Linear`` at the constituency Tree-LSTM's sentiment widths of Tai,
   Socher and Manning (ACL 2015: 300-d word vectors, memory 150) with the
   Stanford Sentiment Treebank's 21701-word vocabulary, on 64 seeded
   trees of 2 to 56 tokens (right-branching, as
   ``tests/test_text_treelstm.py`` builds them), forward and backward
   against the CPU, ``TreeNNAccuracy`` counts equal; ms a batch forward
   and backward on the card.
6k. load_native — the native model format (``bigdl_tpu.module.v2``,
   ``utils/serializer.py``) and the filesystem registry, after
   ``train_rnn``. (a) ``slice``'s GPT-2 small (float32, tied head, its
   seeded weights) served by ``slice``'s paged engine on ``slice``'s
   traffic, unprofiled, each group of requests submitted under the
   scheduler's lock (one admission pass sees it whole, so the batches do
   not follow the host's timing); then written by ``save_module`` once to
   a local file with a ``weight_path=`` sidecar and once to ``mem://`` (an
   in-memory filesystem the phase registers through
   ``utils.fileio.register_filesystem``), each copy read onto the card by
   ``load_module`` (bit-equal weights) and served the same way: every
   request's tokens, and the ``paged_attention`` and ``fused_sampling``
   launches (set to 0 just before each run, read just after; exactly 12 a
   prefill chunk and decode step), equal the unsaved model's run. Against
   ``slice``'s own run, whose first 8 submissions are not one burst (its
   batches, and so its counts and sampled tokens, follow the host's
   timing): greedy tokens by the near-tie rule, identity and counts
   reported. File bytes, save and load seconds a route. (b)
   ``train_sharded``'s ResNet-50 run (two replicas, float32,
   ``Adam(1e-3)``, cuDNN's deterministic algorithms) with native
   checkpoints every 2 iterations and ``train.step:error:after=4:times=1``
   armed: ``model.4``'s magic, no shard file, one retry reloading
   ``model.4`` through ``load_module`` (``_reload_gathered``), the six
   losses equal ``train_sharded``'s uninterrupted run's bit for bit, and
   CUDA-core conv launches = ``conv_routes`` x 2 replicas x the 7 steps
   dispatched, no tensor-core launch, no 3x3 stride-1 ``F.conv2d``. (c)
   the card's file read with ``device="cpu"``: the CPU's logits of 2 x 64
   tokens within 1e-4 x max|CPU| of the card's; that CPU model written and
   read back onto the card: its logits equal the card's first forward bit
   for bit.
6l. detect — the losses and the detection heads (A.11(d)(4)(a)), after
   ``train_rnn``: float32, TF32 off, seeded weights (the layers'
   initialisers from DETECT_SEED). (a) SSD300 on VGG-16 as Liu et al.'s
   ``ssd_pascal.py`` builds it (``SSD300``: Caffe's ceil-mode pools, pool5
   3x3/s1/p1, fc6 3x3 dilated 6, fc7 1x1, conv6-conv9, ``NormalizeScale(20)``
   on conv4_3, six ``PriorBox`` layers, 8,732 priors, 3x3 pad-1 loc and
   conf heads, ``DetectionOutputSSD(21, nms 0.45, top 400, keep 200, conf
   0.01)``) at batch 8 x 300²: a warm-up and DETECT_TIMED timed passes,
   the 3x3 CUDA-core launches equal to ``conv_routes(..., training=False)``
   of every stage and head and the library calls to its count (fc6, the
   1x1, stride-2 and VALID convolutions), no 3x3 stride-1 ``F.conv2d``;
   loc, conf and priors at batch 1 within 1e-4 of the CPU's largest
   magnitude; the head on the CPU's batch-1 inputs and on the card's batch
   of 8, each against the CPU head on the same inputs by the near-tie rule
   (an image's rows equal, or equal up to a first differing row whose own
   decision, its score to ``conf_thresh`` or to its class's top-k cut,
   its overlap with an earlier row to the NMS threshold, or its order
   against the other device's row, the CPU head took by a margin under
   DETECT_TIE_EPS; counted and printed). (b) Faster R-CNN VGG-16 (``FRCNN_VGG16``:
   py-faster-rcnn's ``test.prototxt`` at its TEST settings) on one 600 x
   800 image, im_info (600, 800, 1.6, 1.6), its seeded ``cls_score``
   weights widened so their logits spread with a standard deviation of 2
   (at the initialiser's width every probability sits near 1/21, under
   ``conf_thresh``, and no RoI would be detected): timed passes with the
   route table's launches; conv5_3 and the RPN's maps within 1e-4 of the CPU's;
   ``Proposal`` and ``DetectionOutputFrcnn`` fed the CPU's own inputs
   against the CPU layers by the near-tie rule (min_size within
   DETECT_TIE_PX pixels), ``RoiPooling`` on them exactly; the card's own
   RoIs against the CPU's reported; ``RoiPooling``'s allocation beyond its
   inputs at most 1.1x its RoIs' (R, C, H, W) map; the NMS calls timed
   alone in one more pass (their share of it). (c) conv5 and the RPN
   (``rpn_train_model``) from the card's conv4_3, 3 steps of
   ``make_train_step`` with ``SGD(0.001, momentum 0.9)`` and
   ``ParallelCriterion(SoftmaxWithCriterion(ignore_label=-1),
   SmoothL1CriterionWithWeights(sigma=3))`` on seeded anchor targets (64
   foreground, 192 background, the rest -1): the first step's loss within
   1e-5 relative of the CPU's; each input-gradient flip of the step
   (conv5_2, conv5_3, rpn_conv) on the card, fed the CPU run's own output
   gradient, within 1e-5 of ``torch.nn.grad.conv2d_input``'s largest
   magnitude; every gradient within 1e-4 of the largest magnitude of a
   CPU run that takes the card's ReLU decisions (the ReLU outputs whose
   sign the two devices' rounding decides differently are counted; each
   gradient against the plain CPU run by train_cnn's rule, and cuDNN's in
   the kernels' place, reported), the losses falling, the launches of ``conv_routes`` x 3
   (forward and input-gradient flips). (d) every case of ``CRITERION_CASES`` (all 39
   criterions) forward and backward on the card within 1e-5 of the CPU.
   Reports images/s, ms an image, the NMS sweep's steps, launches and
   time, ms a step and the card.
7. train   — GPT-2 small at full width and depth, float32, the same seeded
   weights, ``Adam(learningrate=3e-4)`` and ``CrossEntropyCriterion``
   through ``make_train_step`` on one fixed batch of 8 x 1024 tokens: one
   warm-up step, then 5 timed steps (step time, tokens/s, peak memory,
   model FLOP utilisation against the 67 TFLOP/s float32 peak). Checks:
   every loss finite and the last below the first; each flash kernel
   launched 12 times a timed step; on a 1 x 512 batch the card's loss and gradients equal the port's
   CPU run (plain versions): loss within 1e-4 relative, each parameter's
   gradient within 1e-3 of its largest magnitude. Then 2 steps under
   ``torch.profiler`` (a ``profile`` line).
8. train_bf16 — ``train``'s model, weights, batch and optimizer through
   ``make_train_step(..., compute_dtype=torch.bfloat16)``: one warm-up
   step, then 5 timed steps (step time, tokens/s, peak memory,
   utilisation against 989 TFLOP/s bfloat16). Checks: losses finite and
   falling; the first within 2 % of ``train``'s float32 first loss (same
   batch and weights; a sanity bound only: at the initial weights the loss
   sits near ln(50257) whatever attention does); per timed step 12 launches
   of each flash wrapper on the path ``flash_attention.path`` names at
   GPT-2's head_dim 64 (the tensor cores for all three) and none on the
   other; ``flash_attention``'s bfloat16
   autograd, which is what holds the kernels, at 1 x 12 x 512 x 64,
   causal (output, dQ, dK, dV) within 2e-2 x max|CPU| of float32 autograd
   of the plain attention on the CPU over the same values. Then 2 steps
   under ``torch.profiler`` (a ``profile`` line grouped into flash
   tensor-core kernels, the tensor-core dQ alone, flash CUDA-core
   kernels, GEMMs, elementwise and reductions).
9. train_resnet — ``bench.py``'s training configuration: ResNet-50
   (ImageNet, NHWC, 1000 classes, full width and depth), seeded weights
   from ``convert.init_resnet_params(seed=0)``, one fixed batch of 256 x
   224 x 224 x 3 with labels from ``default_rng(1)``, ``ClassNLLCriterion``,
   ``SGD(learningrate=0.01, momentum=0.9)``, ``make_train_step(...,
   compute_dtype=torch.bfloat16)``: one warm-up step, then 5 timed steps
   (step time, images/s, peak memory, utilisation against 989 TFLOP/s
   bfloat16 with ``resnet_flops``). Checks: losses finite and the last
   below the first; per timed step, the k9 and i2c tensor-core kernels
   launched exactly the counts derived from the model's layers
   (``models.conv_routes``: forward and input gradient of each 3x3
   stride-1 convolution, 20 k9 and 6 i2c), their CUDA-core kernels never,
   and ``F.conv2d`` exactly once per other convolution, never for a 3x3
   stride-1 one. Card against the port's CPU run at float32 on a 4 x 224
   x 224 batch (cuDNN and matmul TF32 off, set and printed; the conv
   kernels on their CUDA-core path, ``conv_routes`` launches, no
   tensor-core one): loss within 1e-4 relative, BN running statistics
   after the step within 1e-4, each gradient within 1e-3 of its largest
   magnitude or within 10 times its float32 noise floor on the CPU,
   whichever is larger (see RESNET_NOISE_FACTOR). Then 2 steps under
   ``torch.profiler`` (a ``profile`` line).
10. train_optimizer — the reference's training API, ``Optimizer(model=,
   dataset=, criterion=)`` with its setters, ``optimize()`` and
   ``Evaluator``. LeNet-5 in the configuration of the reference's accuracy
   test (``tests/test_lenet_mnist.py``: ``mnist_dataset`` of 1024
   synthetic digits in batches of 128, validation on 512, ``Adam(2e-3)``,
   6 epochs, validation every epoch with ``Top1Accuracy`` and ``Loss``),
   with an ``L2Regularizer(1e-4)`` on conv1_5x5 and a checkpoint every
   epoch into a temporary directory, the epoch shuffles pinned to seeded
   orders. Checks: losses finite, the last below the first; ``Evaluator``
   top-1 above 0.9; ``model.<n>`` reloads into a fresh LeNet-5 bit for
   bit and ``optimMethod.<n>`` gives the method and its step; the first
   epoch's per-iteration losses within 1e-4 relative of the port's CPU
   run from the same weights and shuffle; the example's setters
   (``examples/lenet_mnist.py``, ``SGD(0.05)``) for one epoch with finite,
   falling losses; ``steps_per_loop=2`` within 1e-4 of
   ``steps_per_loop=1`` with half the dispatches; ``DeviceFeed``'s copy
   counter moved. Reports ``metrics_summary()``, step time, records/s
   (also of each of four two-epoch runs at ``steps_per_loop`` 1, 2, 2, 1)
   and a ``profile`` line of one epoch. Then ResNet-50 (ImageNet, NHWC, 1000
   classes) at 224 x 224, float32, batch 32, through the facade: 128
   seeded records via ``DataSet.array`` -> ``SampleToMiniBatch(32)``,
   ``SGD(0.01, momentum 0.9)`` under ``MultiStep([2, 3], 0.1)``,
   ``Trigger.max_iteration(4)``, validation on one batch with
   ``Top1Accuracy``. Checks: the first loss within 1e-6 relative of
   ``make_train_step``'s on the same weights and batch; losses finite;
   the conv kernels' CUDA-core launches equal ``conv_routes`` a step plus
   one forward for the validation batch, no tensor-core launch, no 3x3
   stride-1 ``F.conv2d``; ``conv3x3`` in float32 at batch 32 and ResNet-50's
   four 3x3 stride-1 shapes (output, input gradient through the flip
   launch, weight gradient) within 1e-4 x max|CPU| of float32 autograd of
   ``F.conv2d`` on the CPU, one CUDA-core forward and flip a shape.
   Reports images/s and the device's busy share
   over 2 more iterations (a ``profile`` line).

11. train_distri — ``DistriOptimizer`` (ZeRO-1 data parallelism) through
   ``Optimizer(model, DataSet.array(records, distributed=True), criterion,
   mesh=["cuda:0", "cuda:0"])``: two replicas on the one card. First one
   hand-checked step of ResNet-50 (batch 32 at 224²): at float32 wire
   the new float32 masters within 1e-6 x max|w| of the mean of the two
   half-batch gradients of ``make_loss_and_grads`` applied by the same
   ``SGD``, BN statistics within 1e-6 of the halves' mean; at bfloat16
   wire within 1e-3 x max|w| of the same step on wire-rounded weights and
   gradients. Then ResNet-50 (ImageNet, NHWC, 1000 outputs, labels of 10
   classes), float32, 128 seeded records, global batch 32 (16 a replica),
   ``SGD(0.01, momentum 0.9)``, 4 iterations, validation on one batch in
   the mesh, a checkpoint. Checks: losses finite, the last below the
   first; CUDA-core conv launches = 2 x (4 x ``conv_routes`` + the
   validation forward), no tensor-core launch, no 3x3 stride-1
   ``F.conv2d``; each replica's slots ``padded_size / 2`` elements; the
   checkpoint reloads bit for bit; no retry logged. Reports step time,
   images/s, peak memory, ``metrics_summary()`` and a ``profile`` line
   (2 more iterations) with the gather and reduce-scatter ranges as their
   own groups. Then 2 iterations with ``compute_dtype=torch.bfloat16``:
   tensor-core launches = 2 x 2 x ``conv_routes``, no CUDA-core one. Then
   LeNet-5 at two replicas, the reference test's 6 epochs on a
   distributed MNIST pipeline: losses falling, top-1 > 0.9.

12. train_cnn — VGG-16, Inception-v1 and AlexNet (``BASELINE.json``
   configs 2 and 3) at full width and depth, 1000 classes, seeded weights
   (``Module.reset``), seeded NCHW images in channels-last memory order.
   VGG-16 at batch 32 x 224² through ``make_train_step`` in bfloat16,
   SGD(0.05, momentum 0.9), labels of 10 classes (CNN_CLASSES says why),
   dropout drawing from a seeded generator: a warm-up and 5 timed steps
   on one batch; losses finite and the last below the first; the conv
   launches by path equal the route table
   (``models.conv_routes(model, hw, dtype)``: 3 i2c on the tensor cores,
   1 on the CUDA cores (the first layer, 3 input channels), 21 k9 a step)
   and no 3x3 stride-1 ``F.conv2d``; then 2 steps under the profiler.
   Card against the port's CPU run (VGG-16 and Inception-v1, float32,
   batch 4 x 224², training mode, dropout off): ``train_resnet``'s bars
   (loss 1e-4 relative; each gradient within 1e-3 of its largest magnitude
   or 10 times its CPU noise floor) and the float32 route table on the
   CUDA cores. Inception-v1 with both auxiliary heads through
   ``Optimizer``: float32, 4 iterations of 32 seeded records, the
   reference example's SGD(0.0898, momentum 0.9, weight decay 1e-4,
   Poly(0.5, 62000)), dropout from the facade's seeded stream; launches =
   4 x the float32 route table; then ``make_train_step`` in bfloat16 on
   those weights as for VGG-16 (1 i2c and 19 k9 a step, all on the tensor
   cores, 49 library). VGG-16 through ``DistriOptimizer`` (two replicas
   on the card, global batch 32, bfloat16 compute and wire, 2 iterations,
   a checkpoint): launches = 2 x 2 x the bfloat16 route table, the
   checkpoint reloads bit for bit, no retry. AlexNet (Caffe, grouped
   conv4 and conv5 once a group, 227²) and AlexNet-OWT (224²): a warm-up
   and one timed float32 step each (10 and 6 k9 CUDA-core launches).
   Reports step time, images/s, utilisation of the counted operations
   (``models.model_flops``) against 67 or 989 TFLOP/s, peak memory, the
   device's busy share and the 3x3 kernels' share of device time.

13. load_interop — ``BASELINE.json`` config 3's load paths. Inception-v1
   from Caffe: the run writes BVLC GoogLeNet's layout as a prototxt
   (``conv1/7x7_s2`` ... ``inception_5b/output``, ``pool5/7x7_s1``,
   ``loss3/classifier``, ending in a ``SoftmaxWithLoss`` that the loader
   maps to ``LogSoftMax``) and a caffemodel of
   ``Inception_v1_NoAuxClassifier(1000, seed=CNN_SEED)``'s weights, encoded
   with the port's ``protowire``, into a temporary directory, and loads
   them with ``interop.load_caffe(..., sample_input=(CNN_BATCH, 3, 224,
   224))`` on the card: in evaluation mode the loaded graph's float32
   outputs on one seeded batch equal the source model's within 1e-5 of
   their largest magnitude; its ``conv_routes`` equal the source's; it
   trains CNN_STEPS bfloat16 steps through ``make_train_step`` (dropout
   from a seeded generator) with the 3x3 launches equal to the route
   table and no 3x3 stride-1 ``F.conv2d``; ``CaffeLoader.
   load_weights_into`` a fresh ``Inception_v1_NoAuxClassifier`` gives the
   source's weights bit for bit. AlexNet-OWT from Torch7: ``save_torch``
   of ``AlexNet_OWT(1000, seed=CNN_SEED)``, ``load_torch`` on the card,
   outputs within 1e-5 of the source's, one float32 step with the route
   table's CUDA-core launches; ``save_torch`` of the Caffe AlexNet
   (grouped conv2, conv4 and conv5) raises as the reference's does.
   Reports each file's bytes and load seconds, step time and images/s.

14. load_tf — ``BASELINE.json`` config 5's load path (TF GraphDef
   import, A.11(d)(2)(a)). The control-flow graphs of the CPU tests (a
   counter loop, a TensorArray loop, a data-dependent loop, a
   Switch/Merge cond) on the card against the CPU, the dynamic loop's
   host reads of its condition counted (6). BERT-base as Google BERT's
   classifier fine-tuning graph (``bert_tf_graph``: ``modeling.py`` with
   ``run_classifier.py``'s head, 12 layers, hidden 768, 12 heads, FFN
   3072 with erf GELU, vocabulary 30522, 128 tokens, 2 classes, one
   ``input_ids`` input, seeded truncated normals of 0.02) written as a
   GraphDef and an ``.npy`` directory (``export_tf_checkpoint.py``'s
   layout, Google's variable names) and imported by ``load_tf``: float32
   logits at batch 2, evaluation mode, TF32 off, within 1e-4 of the
   CPU import's largest magnitude; a ``TFTrainingSession`` built without
   ``sample_input`` takes one Adam step at learning rate 0 and still
   predicts the CPU's logits; then 5 Adam(5e-5) steps at 32 x 128
   (finite losses); no flash launch (the reference imports attention as
   ``MM`` + ``SoftMax``). TF-slim's ``vgg_16`` (``vgg16_tf_graph``,
   NHWC, 224², 1000 classes) the same way: logits at batch 2 within 1e-4,
   3 float32 SGD(0.01) steps at batch 32 through ``TFTrainingSession``
   with the 3x3 CUDA-core launches equal to ``conv_routes`` x 3, no 3x3
   stride-1 ``F.conv2d``. Reports the ``.npy`` bytes, load seconds, step
   time, sequences or images/s and the busy share.

15. load_tf_train — the TF graph's gradient and data ops (A.11(d)(2)(b)).
   An op sweep (``tf_grad_sweep_graph``: the ten elementwise gradient
   pairs, both ``FusedBatchNormGrad``s, ``AvgPoolGrad``, ``LRNGrad``,
   ``ResizeBilinearGrad``, ``Dilation2DBackprop*``, the depthwise and 3-D
   ``Backprop{Input,Filter}``, a 3x3 ``Conv2DBackpropInput`` at 2 x 112² x
   128, a folded ``BroadcastGradientArgs``, ``RandomShuffle`` with a
   generator, ``Substr``) on the card against the CPU import within 1e-5
   of each output's largest magnitude, its flips counted by
   ``conv_routes`` (1 k9, the depthwise one's 8 groups on i2c), the
   shuffle a row permutation, ``CategoricalColHashBucket`` of the
   substrings equal. TF-slim's ``vgg_16`` training graph
   (``vgg16_tf_train_graph``: ``tf.gradients`` of the mean softmax cross
   entropy, the 32 variable gradients as outputs, 224², 1000 classes)
   written as GraphDefs at batch 2 and 32 and an ``.npy`` directory; 32
   tf.Examples (uint8 ``image/raw``, int64 ``image/class/label`` of 10
   classes) written with ``TFRecordWriter`` and read back with
   ``tf_record_iterator`` feed its ``serialized`` placeholder
   (``ParseExample`` -> ``DecodeRaw`` -> ``Reshape`` -> ``Cast`` ->
   ``Mul``); a copy with one payload byte flipped raises ``IOError``.
   Batch 2 (``load_tf`` with ``sample_input``): logits within 1e-4 of the
   CPU import's largest magnitude, loss within 1e-5 relative, the decoded
   images bit-equal; each of the graph's 47 convolution nodes (forward,
   input and filter gradients) on the card, fed the CPU run's own inputs
   for it, within 1e-5 of the CPU output's largest magnitude; and each
   gradient off the CPU's by no more than the port's autograd of the
   forward import is off its CPU run, plus 1e-4 of its largest magnitude
   (train_cnn's noise-floor rule is reported, and so is the same autograd
   on the card with the 3x3 route swapped for cuDNN's ``F.conv2d``: a
   witness of the card's rounding that launches no kernel).
   Batch 32 under ``torch.no_grad()``: a warm-up and 3 timed evaluations,
   21 k9 and 4 i2c CUDA-core launches each (``conv_routes``; 6 library
   calls, no 3x3 stride-1 ``F.conv2d``), the decoded batch bit-equal, the
   loss within 1e-5 and every gradient within train_cnn's rule (the
   card's own noise floor) of autograd of the forward import on the same
   weights and images. Reports ms an evaluation, images/s, peak memory,
   the busy share, the 3x3 kernels' share of device time and the load
   seconds. TF32 is off.

16. train_bert — BERT-base (``BASELINE.json`` config 5: 12 layers,
   hidden 768, 12 heads, vocabulary 30522, max_position 512) at full width
   and depth, seeded weights (``convert.init_bert_tree``) and seeded
   tokens, 15 % masked (label -1 elsewhere). ``BertForMLM`` through
   ``make_train_step``, bfloat16 compute, ``Adam(1e-4)``, ``bench.py``'s
   two phases (128 x 128: a warm-up and 5 timed steps; 16 x 512: a
   warm-up and 3): losses finite and the last below the first, exactly 12
   tensor-core launches of each flash kernel a step and no CUDA-core
   one; 2 steps of each under the profiler. float32 loss and gradients of
   a 2 x 128 batch on the card against the port's CPU run: ``train``'s
   bars (1e-4 relative; 1e-3 of each gradient's largest magnitude), 12
   CUDA-core launches each. ``make_sp_train_step`` at dp 2 x sp 4
   (``examples/bert_sequence_parallel.py``), every replica on ``cuda:0``,
   float32, 8 x 512: each shard's forward against the plain model's
   (rtol 2e-4, atol 2e-5, the reference's sp bar); one ``SGD(0.1)`` step
   on unpadded labels against one plain ``make_train_step``'s (each
   tensor within 1e-5 of its largest magnitude); then a warm-up and 2
   ``Adam`` steps on masked labels, each timed alone, the replicas bit-
   identical after each, finite losses, exactly dp x 12 x sp^2 = 384
   CUDA-core launches of each flash kernel a step; one step profiled.
   The ring and Ulysses forms over 4 shards of ``cuda:0`` through
   ``make_train_step`` in bfloat16 on phase 2's batch and weights: the
   first loss within 2 % of phase 2's, 12 x 16 and 12 x 4 tensor-core
   launches a step. GPT-2 small at ``("ring_inner", "seq", 4)``, float32,
   1 x 1024: the sp step's loss and gradients against the plain model's
   on the card at ``train``'s bars, 12 x 10 CUDA-core launches each (a
   causal ring of 4 runs 4 causal and 6 full pairs). Reports step time,
   tokens/s, utilisation of ``bert_mlm_flops_per_token`` x 3 against 989
   TFLOP/s, peak memory, the busy share and the flash kernels' share of
   device time.

Then a ``run`` line (the whole run's seconds and each phase's), a
``{"kernels": [...]}`` line (name, route, source, replaced TPU kernel,
launches on its path's run, max error, kernel / plain / bound / library
times in ms), the nvidia-smi line again, and last ``{"ok": true,
"device": {...}}``.

The bound of a kernel is the larger of its bytes over 3.35 TB/s (HBM3) and
its float operations over the card's peak for the inputs' type: 67 TFLOP/s
for float32 (outside the tensor cores, TF32 off), 989 TFLOP/s for bfloat16
(dense tensor cores), the H100 SXM's published peaks.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound(nbytes, flops, dtype):
    """(ms, "bytes" or "operations"): the least time for ``nbytes`` of HBM
    traffic and ``flops`` operations on inputs of ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS_PER_S[str(dtype).replace("torch.", "")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# cycles of the spin kernel that keeps the card busy while the host
# queues a timed run (about 1 ms on an H100)
AHEAD_CYCLES = 2_000_000


def time_ms(torch, fn, iters, flush=None, warm=3, ahead=False):
    """Mean device time of ``fn`` over ``iters`` runs after ``warm``
    untimed runs, from CUDA events; with ``flush`` (a buffer larger than
    L2) the cache is overwritten before each run and only the run is
    timed. ``ahead`` (with ``flush``) queues a spin kernel before each
    run's start event, so that the host has queued the whole run before
    the card reaches it: the time is then the launches' device time back
    to back, without the host's gaps between them."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    if flush is None:
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / iters
    pairs = []
    for _ in range(iters):
        flush.zero_()
        if ahead:
            torch.cuda._sleep(AHEAD_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


# ------------------------------------------------------------------ phases
def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": line,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return line


def phase_build():
    from bigdl_tpu_torch.ops import _build
    names = _build.kernel_names()
    t0 = time.perf_counter()
    compiled = _build.build(*names)
    secs = time.perf_counter() - t0
    ptxas = [ln.strip() for name in names
             for ln in _build.build_log(name).splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": secs, "compiled": compiled,
          "ptxas": ptxas})


def _paged_case(torch, dtype, b, c, starts, tables, seed, int8, ps=16,
                d=64):
    """Random paged-attention inputs on the card, pages of ``ps`` tokens,
    heads of ``d``; an int8 pool is written through the port's
    ``paged_write_quant`` from random float K/V, every page and offset, as
    the serving path writes it."""
    from bigdl_tpu_torch.parallel.sequence import (paged_write_index,
                                                   paged_write_quant)
    g = torch.Generator(device="cuda").manual_seed(seed)
    n, h = 512, 12
    kw = dict(generator=g, device="cuda", dtype=torch.float32)
    if int8:
        pages = torch.arange(n).repeat_interleave(ps)[None]
        offs = torch.arange(ps).repeat(n)[None]
        index = paged_write_index(pages, offs, n, "cuda")
        pool = {}
        for name in ("k", "v"):
            new = torch.randn((1, h, n * ps, d), **kw)
            card, cpu = [paged_write_quant(
                torch.zeros((n, h, ps, d), dtype=torch.int8, device=dev),
                torch.zeros((n, h, ps), device=dev), new.to(dev),
                index.to(dev)) for dev in ("cuda", "cpu")]
            # quantise-on-write gives the same bits on the card and the CPU
            for on_card, on_cpu in zip(card, cpu):
                check(torch.equal(on_card.cpu(), on_cpu),
                      f"paged_write_quant of {name}: card and CPU differ")
            pool[name], pool[f"{name}_scale"] = card
    else:
        pool = {"k": torch.randn((n, h, ps, d), **kw).to(dtype),
                "v": torch.randn((n, h, ps, d), **kw).to(dtype)}
    q = torch.randn((b, h, c, d), **kw).to(dtype)
    table = torch.tensor(tables, dtype=torch.int32, device="cuda")
    start = torch.tensor(starts, dtype=torch.int32, device="cuda")
    return q, pool, table, start


def _tables(lengths, p=64, ps=16, n=512, share=None):
    """Page tables as the allocator leaves them: page runs in position
    order, sentinel tails, an empty row all sentinel; ``share`` = (row_a,
    row_b, pages) points row_b's first ``pages`` entries at row_a's."""
    rows, nxt = [], 0
    for length in lengths:
        row = [n] * p
        for j in range(-(-length // ps)):
            row[j] = nxt
            nxt += 1
        rows.append(row)
    if share is not None:
        a, b_, k = share
        rows[b_][:k] = rows[a][:k]
    return rows


PAGED_TOL = 2e-5       # float32 bar of the paged kernels (rows 4-6)
PAGED_TP = (2, 4)      # tp degrees of row 6's kernel check
PAGE_SIZES = (8, 32)   # the kernel's other page sizes, held, not timed
PAGED_HEAD_DIMS = (32, 96, 128)    # its other built widths, at page 16
# head dims between or at the top of the built widths (80 on 96, 256), held
# at every page size
PAGED_WIDE_HEAD_DIMS = (80, 256)
PAGED_ODD_HEAD_DIMS = (72, 36, 34, 33)  # held and timed at page 16
# above 256: width 256 in 2 chunks, held and timed at page 16
PAGED_CHUNKED_HEAD_DIMS = (320, 512)
READINGS = 3           # timed kernels: readings, the median reported


def _steady_ms(torch, fn, flush, iters=50):
    """A kernel's timing: READINGS readings of :func:`time_ms` (``iters``
    runs, 10 warm, queued ahead of the card behind the spin kernel, L2
    flushed before each run); returns (median, [min, max])."""
    ms = sorted(time_ms(torch, fn, iters, flush, warm=10, ahead=True)
                for _ in range(READINGS))
    return ms[len(ms) // 2], [ms[0], ms[-1]]


SPEC_TOKENS = 4        # the speculative phases' draft length gamma


def _paged_cases(ps=16, verify=False):
    """The paged-attention cases at pages of ``ps`` tokens (1024 positions
    a row): decode over 8 slots (row 7 inactive, all sentinel; rows 2 and
    3 share a 256-token prefix) and one prefill chunk of the 4-row window
    (rows 1 and 2 share 192 tokens); with ``verify``, a speculative verify
    chunk of SPEC_TOKENS queries a slot at the decode slots' committed
    lengths (row 7 inactive, the tables covering the chunk)."""
    dec_len = [24, 100, 300, 310, 700, 1000, 513, 0]
    dec = dict(b=8, c=1, starts=[max(x - 1, 0) for x in dec_len],
               tables=_tables(dec_len, p=1024 // ps, ps=ps,
                              share=(2, 3, 256 // ps)))
    chk_start = [0, 192, 256, 640]
    chk = dict(b=4, c=64, starts=chk_start,
               tables=_tables([s + 64 for s in chk_start], p=1024 // ps,
                              ps=ps, share=(1, 2, 192 // ps)))
    cases = (("decode", dec), ("chunk", chk))
    if verify:
        ver = dict(b=8, c=SPEC_TOKENS, starts=dec_len,
                   tables=_tables([x and x + SPEC_TOKENS for x in dec_len],
                                  p=1024 // ps, ps=ps,
                                  share=(2, 3, 256 // ps)))
        cases += (("verify", ver),)
    return cases


def _paged_kernel(torch, flush, int8):
    """The paged-attention kernel (float pool, or int8 pool) against its
    plain version on :func:`_paged_cases`, float32 and bfloat16 queries,
    at pages of 16, of PAGE_SIZES, at page 16 with heads of
    PAGED_HEAD_DIMS and PAGED_ODD_HEAD_DIMS, and with heads of
    PAGED_WIDE_HEAD_DIMS at every page size; every case at pages of 16 is
    timed. Each pool's cases take every staging copy (16, 8, 4, 1 bytes). Returns its ``kernels``
    entry, timed on decode float32 at pages of 16 and head 64, with the
    other heads' timings under ``head_dims``."""
    from bigdl_tpu_torch.ops import paged_attention as pa
    name = "paged_attention_int8" if int8 else "paged_attention"
    shapes = []
    shape_list = ([(16, 64)] + [(ps, 64) for ps in PAGE_SIZES]
                  + [(16, d) for d in PAGED_HEAD_DIMS]
                  + [(ps, d) for d in PAGED_WIDE_HEAD_DIMS
                     for ps in (16,) + PAGE_SIZES]
                  # rows that no 16-byte copy divides, so that each pool
                  # takes every staging copy (pa.copy_bytes): int8 rows of
                  # 72 (8-byte copies), 36 (4) and 33 or 34 bytes (1);
                  # bfloat16 rows of 72 (8), 68 (4) and 66 bytes (1);
                  # float32 rows of 136 (8) and 132 bytes (4)
                  + [(16, d) for d in PAGED_ODD_HEAD_DIMS]
                  + [(16, d) for d in PAGED_CHUNKED_HEAD_DIMS])
    for ps, d, label, case in [(ps, d, label, case)
                               for ps, d in shape_list
                               for label, case in _paged_cases(
                                   ps, verify=(ps, d) == (16, 64))]:
        for dtype, tol in ((torch.float32, PAGED_TOL),
                           (torch.bfloat16, 2e-2)):
            q, pool, table, start = _paged_case(
                torch, dtype, case["b"], case["c"], case["starts"],
                case["tables"], seed=len(shapes) + 10 * int8, int8=int8,
                ps=ps, d=d)
            got = pa.paged_pool_attention(q, pool, table, start)
            torch.cuda.synchronize()
            tag = f"{name} page {ps} head {d} {label} {dtype}"
            if ps == 16:
                again = pa.paged_pool_attention(q, pool, table, start)
                torch.cuda.synchronize()
                check(torch.equal(got, again),
                      f"{tag}: a second call differs from the first")
            want = pa.paged_pool_attention_ref(q, pool, table, start)
            vis = (table[:, 0] < 512)
            err = (got.float() - want.float())[vis].abs()
            max_err = float(err.max())
            if dtype == torch.float32:
                ok = max_err <= tol
            else:
                ok = bool(torch.allclose(got.float()[vis],
                                         want.float()[vis], atol=tol,
                                         rtol=tol))
            check(torch.isfinite(got.float()).all().item(),
                  f"{tag}: non-finite output")
            check(ok, f"{tag}: max abs err {max_err} over tolerance {tol}")
            row = {"page_size": ps, "head_dim": d,
                   "built_width": pa.kernel_width(d),
                   "copy_bytes": pa.copy_bytes(d, pool["k"].element_size()),
                   "shape": label,
                   "B": case["b"], "C": case["c"],
                   "dtype": str(dtype).replace("torch.", ""),
                   "max_abs_err": max_err, "tolerance": tol}
            shapes.append(row)
            if ps != 16:
                continue
            nbytes, flops = pa.bytes_and_flops(q, pool, table, start)
            b_ms, b_by = bound(nbytes, flops, dtype)
            ms, spread = _steady_ms(torch, lambda: pa.paged_pool_attention(
                q, pool, table, start), flush)
            row.update(ms=ms, ms_spread=spread,
                       plain_ms=time_ms(torch, lambda: pa.
                                        paged_pool_attention_ref(
                                            q, pool, table, start), 10,
                                        flush),
                       bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                       flops=flops)
    copies = {s["copy_bytes"] for s in shapes}
    check(copies == {16, 8, 4, 1},
          f"{name}: staging copies held {sorted(copies)}, not 16, 8, 4, 1")
    f32 = [s for s in shapes if s["dtype"] == "float32"]
    d32 = f32[0]
    head_dims = {f"d{s['head_dim']} {s['shape']} {s['dtype']}": {
        key: s[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "max_abs_err", "built_width")}
        for s in shapes if "ms" in s and s["head_dim"] != 64}
    # the speculative verify shape (B 8, C 4, head 64), both query types
    verify = {s["dtype"]: {key: s[key] for key in (
        "ms", "ms_spread", "plain_ms", "bound_ms", "bound_by",
        "max_abs_err")} for s in shapes if s["shape"] == "verify"}
    emit({"phase": "kernels", "kernel": name, "shapes": shapes})
    return {
        "name": name, "route": "cuda",
        "source": ("bigdl_tpu_torch/ops/csrc/paged_attention_int8.cu" if int8
                   else "bigdl_tpu_torch/ops/csrc/paged_attention.cu"),
        "replaces": ("bigdl_tpu/ops/paged_attention.py:107" if int8
                     else "bigdl_tpu/ops/paged_attention.py:69"),
        "max_abs_err": max(s["max_abs_err"] for s in f32),
        "ms": d32["ms"], "ms_spread": d32["ms_spread"],
        "plain_ms": d32["plain_ms"],
        "bound_ms": d32["bound_ms"], "bound_by": d32["bound_by"],
        # no single PyTorch call attends through a page table
        "library_ms": None, "timed_shape": "decode float32, page 16",
        "head_dims": head_dims, "verify": verify, "launches": 0,
        "shapes": shapes}


def _paged_tp_kernel(torch, flush):
    """Queue B row 6: the paged-attention kernel launched once per shard on
    head-sharded pools (every shard on cuda:0), at PAGED_TP, over float32
    and int8 pools, on :func:`_paged_cases` with float32 queries. The
    shards' outputs joined on the head axis must equal the unsharded
    kernel's bit for bit and the plain version within PAGED_TOL. Time: one
    sharded call (its launches back to back on the card, :func:`_steady_ms`),
    L2 flushed before it, beside the unsharded kernel's timed the same way;
    the bound is the unsharded call's (the same work). Returns its
    ``kernels`` entry, timed on decode float32 at tp 2."""
    from bigdl_tpu_torch.ops import paged_attention as pa
    from bigdl_tpu_torch.parallel.layout import ModelLayout
    shapes = []
    for int8 in (False, True):
        for label, case in _paged_cases(verify=True):
            q, pool, table, start = _paged_case(
                torch, torch.float32, case["b"], case["c"], case["starts"],
                case["tables"], seed=100 + len(shapes), int8=int8)
            whole = pa.paged_pool_attention(q, pool, table, start)
            torch.cuda.synchronize()
            want = pa.paged_pool_attention_ref(q, pool, table, start)
            vis = (table[:, 0] < 512)
            nbytes, flops = pa.bytes_and_flops(q, pool, table, start)
            b_ms, b_by = bound(nbytes, flops, torch.float32)
            whole_ms, whole_spread = _steady_ms(
                torch, lambda: pa.paged_pool_attention(q, pool, table,
                                                       start), flush)
            for tp in PAGED_TP:
                lay = ModelLayout(["cuda:0"] * tp)
                qs = lay.split(q, 1)                  # the head axis
                pools = lay.split_pool(pool)
                tables, starts = [table] * tp, [start] * tp
                tag = (f"paged_attention_tp tp={tp} {label} "
                       f"{'int8' if int8 else 'float32'}")

                def sharded():
                    return pa.paged_pool_attention(qs, pools, tables,
                                                   starts, mesh=lay.devices)

                got = torch.cat(sharded(), 1)
                torch.cuda.synchronize()
                check(torch.isfinite(got).all().item(),
                      f"{tag}: non-finite output")
                check(torch.equal(got, whole),
                      f"{tag}: shards differ from the unsharded kernel by "
                      f"{float((got - whole).abs().max())}")
                max_err = float((got - want)[vis].abs().max())
                check(max_err <= PAGED_TOL, f"{tag}: max abs err {max_err} "
                                            f"over tolerance {PAGED_TOL}")
                check(pa.bytes_and_flops(qs, pools, table, start)
                      == (nbytes, flops), f"{tag}: bytes/flops differ")
                ms, spread = _steady_ms(torch, sharded, flush)
                shapes.append({
                    "tp": tp, "shape": label, "B": case["b"],
                    "C": case["c"], "pool": "int8" if int8 else "float32",
                    "heads_per_shard": qs[0].shape[1],
                    "bit_equal_to_unsharded": True,
                    "max_abs_err": max_err, "tolerance": PAGED_TOL,
                    "ms": ms, "ms_spread": spread,
                    "unsharded_ms": whole_ms,
                    "unsharded_ms_spread": whole_spread,
                    "plain_ms": time_ms(torch, lambda: [
                        pa.paged_pool_attention_ref(x, p, table, start)
                        for x, p in zip(qs, pools)], 10, flush),
                    "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                    "flops": flops})
    shapes += _paged_tp_head_dim(torch, pa, ModelLayout)
    emit({"phase": "kernels", "kernel": "paged_attention_tp",
          "shards_on": "cuda:0", "shapes": shapes})
    t = shapes[0]                       # tp 2, decode, float32 pool
    ver = next(r for r in shapes if r["shape"] == "verify" and r["tp"] == 2
               and r["pool"] == "float32")
    return {
        "name": "paged_attention_tp", "route": "cuda",
        "source": "bigdl_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "bigdl_tpu/ops/paged_attention.py:232",
        "max_abs_err": max(r["max_abs_err"] for r in shapes),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "unsharded_ms": t["unsharded_ms"],
        # as rows 4/5: no single PyTorch call attends through a page table
        "library_ms": None, "timed_shape": "tp 2 decode float32",
        "verify": {key: ver[key] for key in (
            "ms", "ms_spread", "unsharded_ms", "plain_ms", "bound_ms",
            "bound_by", "max_abs_err")},
        "launches": 0, "shapes": shapes}


PAGED_TP_HEAD_DIMS = (128, 256, 512)  # row 6 also held at these, tp 2


def _paged_tp_head_dim(torch, pa, ModelLayout):
    """Row 6 at heads of PAGED_TP_HEAD_DIMS, tp 2: float32 and int8 pools,
    decode and chunk; the joined shards equal the unsharded kernel bit for
    bit and the plain version within PAGED_TOL. Held, not timed."""
    rows = []
    lay = ModelLayout(["cuda:0"] * 2)
    for d, int8, (label, case) in [(d, int8, c) for d in PAGED_TP_HEAD_DIMS
                                   for int8 in (False, True)
                                   for c in _paged_cases()]:
        q, pool, table, start = _paged_case(
            torch, torch.float32, case["b"], case["c"], case["starts"],
            case["tables"], seed=200 + len(rows), int8=int8, d=d)
        whole = pa.paged_pool_attention(q, pool, table, start)
        qs, pools = lay.split(q, 1), lay.split_pool(pool)
        got = torch.cat(pa.paged_pool_attention(
            qs, pools, [table] * 2, [start] * 2, mesh=lay.devices), 1)
        torch.cuda.synchronize()
        tag = (f"paged_attention_tp tp=2 head {d} {label}"
               f" {'int8' if int8 else 'float32'}")
        check(torch.equal(got, whole),
              f"{tag}: shards differ from the unsharded kernel by "
              f"{float((got - whole).abs().max())}")
        want = pa.paged_pool_attention_ref(q, pool, table, start)
        vis = (table[:, 0] < 512)
        max_err = float((got - want)[vis].abs().max())
        check(max_err <= PAGED_TOL, f"{tag}: max abs err {max_err} over "
                                    f"tolerance {PAGED_TOL}")
        rows.append({"tp": 2, "head_dim": d,
                     "shape": label, "B": case["b"], "C": case["c"],
                     "pool": "int8" if int8 else "float32",
                     "bit_equal_to_unsharded": True,
                     "max_abs_err": max_err, "tolerance": PAGED_TOL})
        del q, pool, whole, got, want, qs, pools
    return rows


def phase_kernels(torch, baseline=None):
    flush = torch.empty(80 * 2 ** 20 // 4, dtype=torch.float32,
                        device="cuda")
    results = {}
    for int8 in (False, True):
        entry = _paged_kernel(torch, flush, int8)
        results[entry["name"]] = entry
    results["paged_attention_tp"] = _paged_tp_kernel(torch, flush)

    results["fused_sampling"] = _sampling_kernel(torch, flush, baseline)
    results.update(_flash_kernels(torch, flush))
    results.update(_conv_kernels(torch, flush))
    del flush
    return results


# (S, V, per-row temperatures): GPT-2's vocabulary and Llama-3's, both in
# the cluster's shared memory
SAMPLE_CASES = [(8, 50257, [0.5, 0.8, 1.0, 1.3, 0.7, 0.9, 1.1, 0.6]),
                (8, 128256, [0.8] * 8)]
# (top_k, top_p): the serving config (the small kept set), top-k alone,
# top-p alone (the cluster's rounds), and no cut (the draw alone)
SAMPLE_SETTINGS = [(50, 0.9), (50, None), (None, 0.9), (None, None)]
# bfloat16 logits uniform in [0, 1) (128 values in [0.5, 1), each about
# 200 times: ties at the k-th value): k 50 (about 200 kept, the small
# set) and k 2000 (past SMALL_SET: the cluster's rounds after top-k)
SAMPLE_TIES = [(50, 0.9), (2000, 0.9)]
# a row past MAX_VOCAB: the global variant, 2 rows
SAMPLE_LONG = (2, 600000)
SAMPLE_EPS = 1e-5     # a kept-set boundary this near its level is excused


def _load_module(name, path):
    """The Python file at ``path``, imported as module ``name``."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _baseline_sampler(root):
    """The fused-sampling wrapper of another checkout at ``root`` (the
    parent commit's, to time its kernel beside this one in one run), built
    from that checkout's own sources."""
    ops = f"{root}/bigdl_tpu_torch/ops"
    build = _load_module("baseline_build", f"{ops}/_build.py")
    mod = _load_module("baseline_sampling", f"{ops}/sampling.py")
    mod._build = build               # its kernel from its own csrc/
    return mod.fused_sample_logits


def _sample_inputs(torch, g, rows, vocab, dtype, ties=False):
    """Seeded logits (3 x a normal, or uniform in [0, 1) for ties once
    rounded to bfloat16) and gumbel noise on the card."""
    from bigdl_tpu_torch.ops import sampling as sm
    if ties:
        x = torch.rand((rows, vocab), generator=g, device="cuda")
    else:
        x = 3.0 * torch.randn((rows, vocab), generator=g, device="cuda")
    return x.to(dtype), sm.gumbel_noise((rows, vocab), g, "cuda", dtype)


def _sampling_case(torch, flush, baseline, logits, gumbel, temps, top_k,
                   top_p, label):
    """One sampler case: the kernel against the plain version (tokens
    identical except near a kept-set boundary), a second call bit-equal,
    each row alone (S = 1) equal to its token in the batch, the paths the
    plain version names, the variant's counter moved once a call; timed
    beside the plain version, the PyTorch chain of the same draw
    (``models.gpt.sample_logits``: topk, sort, softmax, cumsum, masks,
    argmax) and, with ``baseline``, the parent's kernel. Returns its
    row."""
    from bigdl_tpu_torch.models.gpt import sample_logits
    from bigdl_tpu_torch.ops import sampling as sm
    fn = sm.fused_sample_logits
    s_rows, vocab = logits.shape
    long_row = vocab > sm.MAX_VOCAB
    paths = torch.full((s_rows,), -1, dtype=torch.int32, device="cuda")
    before = (fn.launches, fn.long_row_launches)
    got = fn(logits, gumbel, temps, top_k, top_p, paths=paths)
    torch.cuda.synchronize()
    moved = (fn.launches - before[0], fn.long_row_launches - before[1])
    check(moved == ((0, 1) if long_row else (1, 0)),
          f"fused sampling {label}: launches moved {moved}")
    again = fn(logits, gumbel, temps, top_k, top_p)
    alone = torch.cat([fn(logits[r:r + 1], gumbel[r:r + 1], temps[r:r + 1],
                          top_k, top_p) for r in range(s_rows)])
    torch.cuda.synchronize()
    check(torch.equal(got, again),
          f"fused sampling {label}: a second call differs from the first")
    check(torch.equal(got, alone),
          f"fused sampling {label}: rows alone give {alone.tolist()}, in the "
          f"batch {got.tolist()}")
    want_paths = torch.zeros_like(paths)
    want = sm.fused_sample_logits_ref(logits, gumbel, temps, top_k, top_p,
                                      want_paths)
    check(torch.equal(paths, want_paths),
          f"fused sampling {label}: paths {paths.tolist()}, the plain "
          f"version names {want_paths.tolist()}")
    near = _near_boundary(torch, logits, temps, top_k, top_p, SAMPLE_EPS)
    diff = (got != want).nonzero().flatten().tolist()
    for r in diff:
        print(f"sampling {label}: row {r} differs (kernel {int(got[r])}, "
              f"plain {int(want[r])}), near boundary {bool(near[r])}",
              flush=True)
    bad = [r for r in diff if not near[r]]
    check(not bad, f"fused sampling {label}: rows {bad} differ away from a "
                   f"kept-set boundary")
    kept = int(sm.kept_ref(logits, temps, top_k, top_p).sum())
    nbytes, flops = sm.bytes_and_flops(logits, top_k, top_p, kept)
    b_ms, b_by = bound(nbytes, flops, logits.dtype)
    ms, spread = _steady_ms(torch, lambda: fn(logits, gumbel, temps, top_k,
                                              top_p), flush)
    row = {"case": label, "dtype": str(logits.dtype).replace("torch.", ""),
           "rows": s_rows, "vocab": vocab, "top_k": top_k, "top_p": top_p,
           "variant": sm.sample_plan(s_rows, vocab)["variant"],
           "paths": paths.tolist(), "differing_rows": diff,
           "near_boundary_rows": [r for r in range(s_rows) if near[r]],
           "kept": kept, "repeats_bitwise": True, "alone_equals_batch": True,
           "max_abs_err": 0.0 if not diff else float(len(diff)),
           "ms": ms, "ms_spread": spread,
           "plain_ms": time_ms(torch, lambda: sm.fused_sample_logits_ref(
               logits, gumbel, temps, top_k, top_p), 5),
           "chain_ms": _steady_ms(torch, lambda: sample_logits(
               logits, gumbel, temps[:, None].to(logits.dtype), top_k,
               top_p), flush, 20)[0],
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
           "flops": flops}
    if baseline is not None:
        base = baseline(logits, gumbel, temps, top_k, top_p)
        torch.cuda.synchronize()
        row["baseline_ms"] = _steady_ms(torch, lambda: baseline(
            logits, gumbel, temps, top_k, top_p), flush)[0]
        row["baseline_differing_rows"] = (base != got).nonzero().flatten(
        ).tolist()
    return row


def _sampling_kernel(torch, flush, baseline=None):
    """The fused sampler against its plain version: SAMPLE_SETTINGS at
    SAMPLE_CASES in float32 and bfloat16, SAMPLE_TIES on tied bfloat16
    rows, and SAMPLE_LONG past MAX_VOCAB, one injected gumbel draw a case
    (:func:`_sampling_case`); every path (the draw alone, the small kept
    set, the cluster's rounds) and both variants run. ``baseline``: the
    parent's wrapper, timed on the same inputs. Returns the ``kernels``
    entry, timed at the serving config (8 x 50257 float32, top_k 50, top_p
    0.9)."""
    g = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    for s_rows, vocab, row_temps in SAMPLE_CASES:
        temps = torch.tensor(row_temps, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            logits, gumbel = _sample_inputs(torch, g, s_rows, vocab, dtype)
            for top_k, top_p in SAMPLE_SETTINGS:
                rows.append(_sampling_case(
                    torch, flush, baseline, logits, gumbel, temps, top_k,
                    top_p, f"{s_rows}x{vocab} {dtype} k={top_k} p={top_p}"))
            del logits, gumbel
    temps = torch.tensor(SAMPLE_CASES[0][2], device="cuda")
    logits, gumbel = _sample_inputs(torch, g, 8, 50257, torch.bfloat16,
                                    ties=True)
    for top_k, top_p in SAMPLE_TIES:
        rows.append(_sampling_case(
            torch, flush, baseline, logits, gumbel, temps, top_k, top_p,
            f"ties 8x50257 bfloat16 k={top_k} p={top_p}"))
    s_rows, vocab = SAMPLE_LONG
    temps = torch.full((s_rows,), 0.8, device="cuda")
    logits, gumbel = _sample_inputs(torch, g, s_rows, vocab, torch.float32)
    for top_k, top_p in SAMPLE_SETTINGS[:3:2]:
        rows.append(_sampling_case(
            torch, flush, baseline, logits, gumbel, temps, top_k, top_p,
            f"long {s_rows}x{vocab} float32 k={top_k} p={top_p}"))
    del logits, gumbel
    paths = {p for r in rows for p in r["paths"]}
    check(paths == {0, 1, 2}, f"fused sampling: paths {sorted(paths)} ran, "
                              f"not all of the draw, small set and rounds")
    emit({"phase": "kernels", "kernel": "fused_sampling", "shapes": rows})
    t = rows[0]
    return {
        "name": "fused_sampling", "route": "cuda",
        "source": "bigdl_tpu_torch/ops/csrc/sampling.cu",
        "replaces": "bigdl_tpu/ops/sampling.py:75",
        # tokens: the count of rows that differ from the plain version
        # (each near a kept-set boundary), over every case
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": t["ms"], "ms_spread": t["ms_spread"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "chain_ms": t["chain_ms"],
        "baseline_ms": t.get("baseline_ms"),
        # no single PyTorch call does top-k + top-p + the gumbel draw;
        # chain_ms is the chain of calls that does
        "library_ms": None,
        "timed_shape": "8x50257 float32 top_k 50 top_p 0.9",
        "launches": 0, "shapes": rows}


FLASH_SOURCE = "bigdl_tpu_torch/ops/csrc/flash_attention.cu"
FLASH_NAMES = {"fwd": "flash_fwd", "dq": "flash_bwd_dq",
               "dkv": "flash_bwd_dkv"}       # the wrappers' names
FLASH_REPLACES = {"fwd": "bigdl_tpu/ops/flash_attention.py:45",
                  "dq": "bigdl_tpu/ops/flash_attention.py:120",
                  "dkv": "bigdl_tpu/ops/flash_attention.py:159"}
# (label, B, H, S, D, causal, with an lse cotangent, kernels held), each in
# FLASH_DTYPES
FLASH_CASES = [("path", 8, 12, 1024, 64, True, False, ("fwd", "dq", "dkv")),
               ("full", 8, 12, 1024, 64, False, True, ("fwd", "dq", "dkv")),
               ("ragged", 8, 12, 1000, 64, True, False,
                ("fwd", "dq", "dkv")),
               ("d128", 8, 12, 1024, 128, True, False,
                ("fwd", "dq", "dkv")),
               # head dims below a built width: zero-padded to 64 and 128
               ("d32", 8, 12, 1024, 32, True, False, ("fwd", "dq", "dkv")),
               ("d80", 8, 12, 1024, 80, True, False, ("fwd", "dq", "dkv")),
               # above 128: the CUDA-core kernels in both types, 160
               # zero-padded to 256
               ("d160", 8, 12, 1024, 160, True, False, ("fwd", "dq", "dkv")),
               ("d256", 8, 12, 1024, 256, True, False, ("fwd", "dq", "dkv")),
               ("d160_full", 8, 12, 1024, 160, False, True,
                ("fwd", "dq", "dkv")),
               ("d256_full", 8, 12, 1024, 256, False, True,
                ("fwd", "dq", "dkv")),
               # above 256: the CUDA-core kernels of width 256 in chunks
               # (320 zero-padded to 512), at 2 heads, as GPTConfig(
               # n_embd=640 or 1024, n_head=2) gives them; full and ragged
               ("d320", 4, 2, 1024, 320, True, False, ("fwd", "dq", "dkv")),
               ("d512", 4, 2, 1024, 512, True, False, ("fwd", "dq", "dkv")),
               ("d320_full", 4, 2, 1000, 320, False, True,
                ("fwd", "dq", "dkv")),
               ("d512_full", 4, 2, 1000, 512, False, True,
                ("fwd", "dq", "dkv")),
               # BERT-base (train_bert): its two phases in full attention,
               # a dp 2 x sp 4 ring chunk pair with the merge's lse
               # cotangent, the 32-position chunk of an s128 batch under
               # sp 4 (a partial tile both ways), and a causal ring's
               # diagonal pair (GPT-2 small at sp 4)
               ("bert_s128", 128, 12, 128, 64, False, False,
                ("fwd", "dq", "dkv")),
               ("bert_s512", 16, 12, 512, 64, False, False,
                ("fwd", "dq", "dkv")),
               ("ring_chunk", 4, 12, 128, 64, False, True,
                ("fwd", "dq", "dkv")),
               ("ring_chunk32", 128, 12, 32, 64, False, True,
                ("fwd", "dq", "dkv")),
               ("ring_diag", 1, 12, 256, 64, True, True,
                ("fwd", "dq", "dkv"))]
FLASH_DTYPES = ("float32", "bfloat16")
FLASH_TOL = {"float32": {"fwd": 2e-5, "grad": 1e-4}, "bfloat16": 2e-2}
# the cases timed beside SDPA
FLASH_BERT_CASES = ("bert_s128", "bert_s512", "ring_chunk", "ring_chunk32",
                    "ring_diag")
FLASH_TIMED = ("path", "d128", "d32", "d80", "d160", "d256", "d320", "d512",
               "d320_full", "d512_full") + FLASH_BERT_CASES
FLASH_HEAD_DIM_CASES = ("d128", "d32", "d80", "d160", "d256", "d320",
                        "d512", "d320_full", "d512_full")
# products of depth D each kernel runs per visible (query, key) pair: the
# function's two, plus the recomputed S (dQ, dK/dV) and dP (dK/dV). Their
# time at the peak rate is a floor the kernel cannot go below; the bound
# (bytes_and_flops) counts the function's two only.
FLASH_PRODUCTS = {"fwd": 2, "dq": 3, "dkv": 4}


def _device_kernels(torch, fn):
    """Names of the CUDA kernels one call of ``fn`` runs (torch.profiler;
    empty if the profiler sees no device events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name[:60] for e in prof.events()
                   if e.device_type == DeviceType.CUDA})


def _flash_kernels(torch, flush):
    """The three flash kernels against their plain versions (and SDPA as
    the library yardstick) on FLASH_CASES in both types. Each call must
    take the path ``fa.path`` names and move that path's counter; a
    bfloat16 kernel's second call must equal its first bit for bit. The
    path and d128 cases are timed. Returns their ``kernels`` entries:
    bfloat16 at the path shape (the main path's type), the float32 timing
    beside it."""
    from bigdl_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(21)
    rows = {"fwd": [], "dq": [], "dkv": []}
    counters = {"fwd": fa.flash_fwd, "dq": fa.flash_bwd_dq,
                "dkv": fa.flash_bwd_dkv}
    for label, b, h, s, d, causal, with_dlse, kerns in FLASH_CASES:
        for dname in FLASH_DTYPES:
            dtype = getattr(torch, dname)
            q, k, v, do = [torch.randn((b, h, s, d), generator=g,
                                       device="cuda").to(dtype)
                           for _ in range(4)]
            dlse = (torch.randn((b, h, s), generator=g, device="cuda")
                    if with_dlse else None)
            before = {kern: _launch_counts(counters[kern]) for kern in kerns}
            o, lse = fa.flash_fwd(q, k, v, causal)
            delta = (do.float() * o.float()).sum(-1)
            bwd = (q, k, v, do, lse, delta, dlse, causal)
            calls = {"fwd": lambda: fa.flash_fwd(q, k, v, causal),
                     "dq": lambda: (fa.flash_bwd_dq(*bwd),),
                     "dkv": lambda: fa.flash_bwd_dkv(*bwd)}
            got = {"fwd": (o, lse)}
            got.update({kern: calls[kern]() for kern in kerns
                        if kern != "fwd"})
            torch.cuda.synchronize()
            plain = {"fwd": lambda: fa.flash_fwd_ref(q, k, v, causal),
                     "dq": lambda: (fa.flash_bwd_dq_ref(*bwd),),
                     "dkv": lambda: fa.flash_bwd_dkv_ref(*bwd)}
            case = {"case": label, "B": b, "H": h, "S": s, "D": d,
                    "causal": causal, "dtype": dname, "dlse": with_dlse}
            for kern in kerns:
                path = fa.path(FLASH_NAMES[kern], dtype, d)
                moved = {p: n - before[kern][p] for p, n in
                         _launch_counts(counters[kern]).items()}
                check(moved == {p: int(p == path) for p in moved},
                      f"flash {kern} {label} {dname}: launches moved "
                      f"{moved}, expected one on {path}")
                want = plain[kern]()
                outs = list(zip(got[kern], want))
                err = max(float((a.float() - w.float()).abs().max())
                          for a, w in outs)
                for a, _ in outs:
                    check(torch.isfinite(a.float()).all().item(),
                          f"flash {kern} {label} {dname}: non-finite "
                          f"output")
                if dname == "float32":
                    tol = FLASH_TOL[dname]["fwd" if kern == "fwd"
                                           else "grad"]
                    ok = err <= tol
                else:
                    tol = FLASH_TOL[dname]
                    ok = all(torch.allclose(a.float(), w.float(), atol=tol,
                                            rtol=tol) for a, w in outs)
                check(ok, f"flash {kern} {label} {dname}: max abs err "
                          f"{err} over tolerance {tol}")
                row = {**case, "path": path,
                       "launched_head_dim": fa.kernel_head_dim(d),
                       "max_abs_err": err, "tolerance": tol}
                if dname == "bfloat16" or d not in (64, 128):
                    again = calls[kern]()
                    torch.cuda.synchronize()
                    same = all(torch.equal(a, b_) for a, b_ in
                               zip(got[kern], again))
                    check(same, f"flash {kern} {label} {dname}: a second "
                                f"call differs from the first")
                    row["repeats_bitwise"] = same
                    del again
                rows[kern].append(row)
                del want, outs
            if label in FLASH_TIMED:
                _time_flash(torch, fa, flush, rows, kerns, dtype, causal,
                            with_dlse, q, k, v, do, bwd)
            del q, k, v, do, dlse, o, lse, delta, bwd, got
            torch.cuda.empty_cache()
    results = {}
    for kern, shapes in rows.items():
        name = FLASH_NAMES[kern]
        emit({"phase": "kernels", "kernel": name, "shapes": shapes})
        timed = {r["dtype"]: r for r in shapes
                 if r["case"] == "path" and "ms" in r}
        t, t32 = timed["bfloat16"], timed["float32"]
        head_dims = {c: {r["dtype"]: {key: r[key] for key in
                                      ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms",
                                       "max_abs_err", "path",
                                       "launched_head_dim")}
                         for r in shapes if r["case"] == c and "ms" in r}
                     for c in FLASH_HEAD_DIM_CASES}
        bert_shapes = {c: {r["dtype"]: {key: r[key] for key in
                                        ("B", "H", "S", "D", "causal",
                                         "dlse", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms", "max_abs_err",
                                         "path")}
                           for r in shapes if r["case"] == c and "ms" in r}
                       for c in FLASH_BERT_CASES}
        results[name] = {
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": FLASH_REPLACES[kern],
            "max_abs_err": max(r["max_abs_err"] for r in shapes
                               if r["dtype"] == "bfloat16"),
            "ms": t["ms"], "ms_spread": t["ms_spread"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "products_floor_ms": t["products_floor_ms"],
            # forward: one SDPA call; backward rows: one SDPA backward
            # call, which yields dQ, dK and dV together
            "library_ms": t["library_ms"],
            "timed_shape": f"B 8 H 12 S 1024 D 64 causal bfloat16, "
                           f"{t['path'].replace('_', ' ')}",
            "float32": {"max_abs_err": max(r["max_abs_err"] for r in shapes
                                           if r["dtype"] == "float32"),
                        **{key: t32[key] for key in
                           ("ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms", "path")}},
            "head_dims": head_dims, "bert_shapes": bert_shapes,
            # SDPA returns no lse: on the dlse cases its backward takes
            # dO alone, a lighter function than the kernels'
            "library_note": "SDPA returns no lse; beside the dlse cases "
                            "its backward computes without dlse",
            "launches": 0, "shapes": shapes}
    return results


def _launch_counts(fn):
    """A flash wrapper's launch counters by path."""
    return {"cuda_cores": fn.launches,
            "tensor_cores": getattr(fn, "tc_launches", 0)}


def _time_flash(torch, fa, flush, rows, kerns, dtype, causal, with_dlse,
                q, k, v, do, bwd):
    """Time each kernel of ``kerns`` on these inputs and SDPA's forward
    and backward on the same tensors (:func:`_steady_ms`, 20 runs a
    reading: device time behind the spin kernel, the L2 flushed before
    each run), and the plain version (3 runs); the numbers go into each
    kernel's last row."""
    import torch.nn.functional as F
    fns = {"fwd": (lambda: fa.flash_fwd(q, k, v, causal),
                   lambda: fa.flash_fwd_ref(q, k, v, causal)),
           "dq": (lambda: fa.flash_bwd_dq(*bwd),
                  lambda: fa.flash_bwd_dq_ref(*bwd)),
           "dkv": (lambda: fa.flash_bwd_dkv(*bwd),
                   lambda: fa.flash_bwd_dkv_ref(*bwd))}
    qq, kk, vv = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

    def sdpa():
        return F.scaled_dot_product_attention(qq, kk, vv, is_causal=causal)

    out = sdpa()

    def sdpa_bwd():
        return torch.autograd.grad(out, (qq, kk, vv), do, retain_graph=True)

    lib = {"fwd": _steady_ms(torch, sdpa, flush, 20),
           "bwd": _steady_ms(torch, sdpa_bwd, flush, 20)}
    backend = _device_kernels(torch, lambda: (sdpa(), sdpa_bwd()))
    print(f"sdpa {dtype} D {q.shape[-1]}: kernels {backend}", flush=True)
    for kern in kerns:
        kernel_fn, plain_fn = fns[kern]
        nbytes, flops = fa.bytes_and_flops(kern, q, causal, with_dlse)
        b_ms, b_by = bound(nbytes, flops, dtype)
        products = flops // 2 * FLASH_PRODUCTS[kern]
        ms, spread = _steady_ms(torch, kernel_fn, flush, 20)
        lib_ms, lib_spread = lib["fwd" if kern == "fwd" else "bwd"]
        rows[kern][-1].update(
            ms=ms, ms_spread=spread,
            plain_ms=time_ms(torch, plain_fn, 3, flush),
            library_ms=lib_ms, library_ms_spread=lib_spread,
            sdpa_kernels=backend, bound_ms=b_ms, bound_by=b_by,
            bytes=nbytes, flops=flops,
            products_floor_ms=bound(0, products, dtype)[0])
    del qq, kk, vv, out


CONV_SOURCE = "bigdl_tpu_torch/ops/csrc/conv3x3.cu"
CONV_REPLACES = {"k9": "scripts/perf_pallas_conv.py:64",
                 "i2c": "scripts/perf_pallas_conv.py:98"}
# ResNet-50's stride-1 3x3 shapes at batch 256: (N, H, W, Cin, Cout)
CONV_SHAPES = [(256, 56, 56, 64, 64), (256, 28, 28, 128, 128),
               (256, 14, 14, 256, 256), (256, 7, 7, 512, 512)]
CONV_TOL = {"float32": 1e-4, "bfloat16": 2e-2}     # x max|plain|
# ragged bfloat16 shapes for the tensor-core path's edges, held on both
# kernels, forward and flip, not timed: partial pixel tiles, Cin not a
# multiple of 64, Cout not a multiple of the channel tile, tiny images
CONV_RAGGED = [(1, 7, 9, 64, 64), (2, 7, 7, 72, 80), (1, 5, 13, 8, 8),
               (2, 9, 11, 16, 136), (1, 3, 3, 24, 40), (1, 30, 30, 128, 64),
               (3, 14, 14, 256, 256), (2, 5, 5, 192, 64)]


def _conv_kernels(torch, flush):
    """Both 3x3 kernels against their plain versions at CONV_SHAPES,
    forward and flip, in bfloat16 (the tensor-core path) and float32 (the
    CUDA-core path), each direction timed queued behind the spin kernel
    (:func:`_steady_ms`, 10 runs a reading) beside cuDNN on the same
    tensors timed the same way: ``F.conv2d`` forward, and for flip
    ``F.conv2d`` of dy with the rotated, transposed weights made once
    outside the timing. Returns their ``kernels`` entries, timed forward
    at the first shape each takes on the ResNet-50 path in bfloat16 (i2c:
    56x56x64; k9: 28x28x128)."""
    import torch.nn.functional as F
    from bigdl_tpu_torch.ops import conv3x3 as cv
    print(f"cudnn {torch.backends.cudnn.version()}: allow_tf32 set to "
          f"False for the yardstick, matmul allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False     # cuDNN's float32 in float32
    plain = {"k9": cv.conv3x3_k9_ref, "i2c": cv.conv3x3_i2c_ref}
    g = torch.Generator(device="cuda").manual_seed(31)
    rows = {"k9": [], "i2c": []}
    for n, h, w, cin, cout in CONV_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).replace("torch.", "")
            x = torch.randn((n, h, w, cin), generator=g, device="cuda").to(
                dtype)
            wt = (torch.randn((cout, 3, 3, cin), generator=g, device="cuda")
                  * (2.0 / (9 * cin)) ** 0.5).to(dtype)
            dy = torch.randn((n, h, w, cout), generator=g,
                             device="cuda").to(dtype)
            xc, wc = x.permute(0, 3, 1, 2), wt.permute(0, 3, 1, 2)
            dyc = dy.permute(0, 3, 1, 2)
            # flip's weights as an OIHW (Cin, Cout, 3, 3) channels-last copy
            wf = wt.flip(1, 2).permute(3, 0, 1, 2).contiguous(
                memory_format=torch.channels_last)
            cudnn = {False: lambda: F.conv2d(xc, wc, padding=1),
                     True: lambda: F.conv2d(dyc, wf, padding=1)}
            lib = {f: _steady_ms(torch, cudnn[f], flush, 10)
                   for f in (False, True)}
            backend = _device_kernels(torch, cudnn[False])
            print(f"cudnn {dname} {h}x{w}x{cin}: kernels {backend}",
                  flush=True)
            for kind, fn in cv.KERNELS.items():
                row = {"N": n, "H": h, "W": w, "Cin": cin, "Cout": cout,
                       "dtype": dname, "path": cv.kernel_for(cin) == kind,
                       "tensor_cores": cv.tc_eligible(kind, x, wt),
                       "cudnn_kernels": backend}
                for flip, inp in ((False, x), (True, dy)):
                    pre = "flip_" if flip else ""
                    before = (fn.launches, fn.tc_launches)
                    got = fn(inp, wt, flip)
                    torch.cuda.synchronize()
                    tc = fn.tc_launches - before[1]
                    check(tc + fn.launches - before[0] == 1
                          and tc == row["tensor_cores"],
                          f"conv3x3_{kind} {h}x{w}x{cin} {dname} flip={flip}"
                          f": ran {tc} tensor-core launches, expected "
                          f"{int(row['tensor_cores'])}")
                    want = plain[kind](inp, wt, flip)
                    check(torch.isfinite(got.float()).all().item(),
                          f"conv3x3_{kind} {h}x{w}x{cin} {dname} flip={flip}: "
                          f"non-finite output")
                    err = float((got.float() - want.float()).abs().max())
                    scale = float(want.float().abs().max())
                    tol = CONV_TOL[dname] * scale
                    check(err <= tol, f"conv3x3_{kind} {h}x{w}x{cin} {dname} "
                                      f"flip={flip}: max abs err {err} over "
                                      f"{tol}")
                    del got, want
                    nbytes, flops = cv.bytes_and_flops(inp, wt, flip)
                    b_ms, b_by = bound(nbytes, flops, dtype)
                    ms, spread = _steady_ms(torch, lambda: fn(inp, wt, flip),
                                            flush, 10)
                    row.update({f"{pre}max_abs_err": err,
                                f"{pre}tolerance": tol, f"{pre}ms": ms,
                                f"{pre}ms_spread": spread,
                                f"{pre}library_ms": lib[flip][0],
                                f"{pre}library_ms_spread": lib[flip][1],
                                f"{pre}bound_ms": b_ms,
                                f"{pre}bound_by": b_by,
                                f"{pre}bytes": nbytes, f"{pre}flops": flops})
                row["plain_ms"] = time_ms(torch, lambda: plain[kind](x, wt),
                                          3)
                rows[kind].append(row)
            del x, wt, dy, xc, wc, dyc, wf
            torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = tf32
    ragged = _conv_ragged(torch, g)
    model_rows = _conv_model_shapes(torch, flush, g)
    results = {}
    for kind, shapes in rows.items():
        name = f"conv3x3_{kind}"
        mine = [r for r in model_rows if r["kind"] == kind]
        emit({"phase": "kernels", "kernel": name, "shapes": shapes,
              "ragged": ragged[kind], "model_shapes": mine})
        t = next(r for r in shapes if r["path"] and r["dtype"] == "bfloat16")
        results[name] = {
            "name": name, "route": "cuda", "source": CONV_SOURCE,
            "replaces": CONV_REPLACES[kind],
            # the main path's (bfloat16, tensor cores) and the CUDA-core
            # path's (float32), over both directions; the worst against
            # its tolerance over every case
            "max_abs_err": max(max(r["max_abs_err"], r["flip_max_abs_err"])
                               for r in shapes if r["dtype"] == "bfloat16"),
            "max_abs_err_float32": max(
                max(r["max_abs_err"], r["flip_max_abs_err"])
                for r in shapes if r["dtype"] == "float32"),
            "worst_err_vs_tolerance": max(
                [max(r["max_abs_err"] / r["tolerance"],
                     r["flip_max_abs_err"] / r["flip_tolerance"])
                 for r in shapes]
                + [r["max_abs_err"] / r["tolerance"] for r in mine]),
            "ms": t["ms"], "ms_spread": t["ms_spread"],
            "flip_ms": t["flip_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            # one F.conv2d call (cuDNN) on the same channels-last tensors
            "library_ms": t["library_ms"],
            "timed_shape": f"{t['N']}x{t['H']}x{t['W']}x{t['Cin']} -> "
                           f"{t['Cout']} bfloat16, tensor cores",
            "launches": 0, "shapes": shapes,
            # VGG-16's and Inception-v1's shapes (CONV_MODEL_SHAPES)
            "model_shapes": mine}
    return results


# the 3x3 stride-1 shapes VGG-16 and Inception-v1 give rows 8-9 at batch
# 32, (N, H, W, Cin, Cout, model): VGG's first layer (3 input channels:
# the CUDA-core kernel even in bfloat16), its 224² and 112² layers (k9 at
# 112 wide plans a 354-row halo), and three of Inception's towers (Cin and
# Cout not multiples of 64: partial depth stages and channel tiles)
CONV_MODEL_SHAPES = [(32, 224, 224, 3, 64, "vgg16"),
                     (32, 224, 224, 64, 64, "vgg16"),
                     (32, 112, 112, 64, 128, "vgg16"),
                     (32, 112, 112, 128, 128, "vgg16"),
                     (32, 28, 28, 96, 128, "inception_v1"),
                     (32, 14, 14, 144, 288, "inception_v1"),
                     (32, 7, 7, 192, 384, "inception_v1")]


def _conv_model_shapes(torch, flush, g):
    """Rows 8-9 at CONV_MODEL_SHAPES: each direction (forward by the
    operation's input channels, flip by its output channels) on the
    kernel ``kernel_for`` gives it, in bfloat16 and float32, held against
    the plain version at CONV_TOL on the path ``tc_eligible`` names, and
    timed behind the spin kernel (``_steady_ms``, 10 runs a reading)
    beside ``F.conv2d`` on the same channels-last tensors (cuDNN, TF32
    off), with the bound of ``bytes_and_flops``. Returns the rows."""
    import torch.nn.functional as F
    from bigdl_tpu_torch.ops import conv3x3 as cv
    plain = {"k9": cv.conv3x3_k9_ref, "i2c": cv.conv3x3_i2c_ref}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for n, h, w, cin, cout, model in CONV_MODEL_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).replace("torch.", "")
            wt = (torch.randn((cout, 3, 3, cin), generator=g, device="cuda")
                  * (2.0 / (9 * cin)) ** 0.5).to(dtype)
            for flip in (False, True):
                c_in = cout if flip else cin
                kind = cv.kernel_for(c_in)
                fn = cv.KERNELS[kind]
                inp = torch.randn((n, h, w, c_in), generator=g,
                                  device="cuda").to(dtype)
                # cuDNN's operation on the same values, channels-last
                # OIHW weights: the flip as F.conv2d with the rotated,
                # transposed weights
                wc = (wt.flip(1, 2).permute(3, 0, 1, 2).contiguous(
                    memory_format=torch.channels_last) if flip
                    else wt.permute(0, 3, 1, 2))
                ic = inp.permute(0, 3, 1, 2)
                tc = cv.tc_eligible(kind, inp, wt, flip)
                before = (fn.launches, fn.tc_launches)
                got = fn(inp, wt, flip)
                torch.cuda.synchronize()
                ran_tc = fn.tc_launches - before[1]
                label = (f"conv3x3_{kind} {h}x{w}x{cin}->{cout} {dname} "
                         f"flip={flip}")
                check(ran_tc + fn.launches - before[0] == 1
                      and ran_tc == tc,
                      f"{label}: ran {ran_tc} tensor-core launches, "
                      f"expected {int(tc)}")
                want = plain[kind](inp, wt, flip)
                check(torch.isfinite(got.float()).all().item(),
                      f"{label}: non-finite output")
                err = float((got.float() - want.float()).abs().max())
                tol = CONV_TOL[dname] * float(want.float().abs().max())
                check(err <= tol, f"{label}: max abs err {err} over {tol}")
                del got, want
                nbytes, flops = cv.bytes_and_flops(inp, wt, flip)
                b_ms, b_by = bound(nbytes, flops, dtype)
                ms, spread = _steady_ms(torch, lambda: fn(inp, wt, flip),
                                        flush, 10)
                lib, lib_spread = _steady_ms(
                    torch, lambda: F.conv2d(ic, wc, padding=1), flush, 10)
                plain_ms = time_ms(torch, lambda: plain[kind](inp, wt, flip),
                                   2, warm=1)
                rows.append({
                    "kind": kind, "model": model, "N": n, "H": h, "W": w,
                    "Cin": cin, "Cout": cout, "flip": flip, "dtype": dname,
                    "path": "tensor cores" if tc else "CUDA cores",
                    # the first layer reads the images: no input gradient
                    "on_model_path": not (flip and cin == 3),
                    "max_abs_err": err, "tolerance": tol, "ms": ms,
                    "ms_spread": spread, "library_ms": lib,
                    "library_ms_spread": lib_spread, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                    "flops": flops})
                print(f"{label} ({model}): {'tc' if tc else 'simt'} "
                      f"{ms:.4f} ms, cuDNN {lib:.4f}, bound {b_ms:.4f}",
                      flush=True)
                del inp, ic, wc
            del wt
            torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = tf32
    first = next(r for r in rows if r["Cin"] == 3 and not r["flip"]
                 and r["dtype"] == "bfloat16")
    check(first["path"] == "CUDA cores",
          f"VGG's first layer in bfloat16 ran on the {first['path']}")
    return rows


def _conv_ragged(torch, g):
    """Both conv kernels on CONV_RAGGED in bfloat16, forward and flip, on
    the tensor-core path, against their plain versions; returns each
    kernel's worst error as a fraction of max|plain| per shape."""
    from bigdl_tpu_torch.ops import conv3x3 as cv
    plain = {"k9": cv.conv3x3_k9_ref, "i2c": cv.conv3x3_i2c_ref}
    out = {"k9": [], "i2c": []}
    for n, h, w, cin, cout in CONV_RAGGED:
        for kind, fn in cv.KERNELS.items():
            worst = 0.0
            for flip in (False, True):
                x = torch.randn((n, h, w, cout if flip else cin),
                                generator=g, device="cuda").bfloat16()
                wt = (torch.randn((cout, 3, 3, cin), generator=g,
                                  device="cuda")
                      * (2.0 / (9 * cin)) ** 0.5).bfloat16()
                tc = fn.tc_launches
                got = fn(x, wt, flip).float()
                torch.cuda.synchronize()
                check(fn.tc_launches == tc + 1,
                      f"conv3x3_{kind} {(n, h, w, cin, cout)} flip={flip}: "
                      f"not on the tensor-core path")
                want = plain[kind](x, wt, flip).float()
                err = float((got - want).abs().max() / want.abs().max())
                check(err <= CONV_TOL["bfloat16"],
                      f"conv3x3_{kind} {(n, h, w, cin, cout)} flip={flip}: "
                      f"error {err} x max|plain| over "
                      f"{CONV_TOL['bfloat16']}")
                worst = max(worst, err)
            out[kind].append({"shape": [n, h, w, cin, cout],
                              "max_err_vs_max_plain": worst})
    return out


def _near_boundary(torch, logits, temps, top_k, top_p, eps=1e-5):
    """Per row: does the kept set's boundary lie within ``eps`` of its
    level? Top-k (when on): the k-th and (k+1)-th scaled logits nearly tie
    without being equal; top-p (when on): a cumulative softmax mass (after
    top-k) lies within ``eps`` of p."""
    l = logits.float() / temps.to(logits.dtype).float()[:, None].clamp_min(
        1e-6)
    srt = torch.sort(l, dim=-1, descending=True).values
    near = torch.zeros(l.shape[0], dtype=torch.bool, device=l.device)
    kept = srt
    if top_k is not None and 0 < top_k < l.shape[1]:
        gap = srt[:, top_k - 1] - srt[:, top_k]
        near |= (gap > 0) & (gap < eps)
        kept = srt[:, :top_k]
    if top_p is not None and top_p < 1.0:
        cum = torch.cumsum(torch.softmax(kept, dim=-1), dim=-1)
        near |= ((cum - top_p).abs() < eps).any(dim=-1)
    return near.cpu().tolist()


LENGTHS = [24, 700, 96, 310, 150, 480, 64, 200, 380, 290, 520, 40]
TEMPS = [0.8 if i in (1, 4, 7, 10) else 0.0 for i in range(12)]
N_NEW = 64


def _traffic(rng):
    """12 prompts of LENGTHS random token ids; 3 and 9 share their first
    256 tokens."""
    import numpy as np
    prompts = [rng.integers(0, 50257, n) for n in LENGTHS]
    prefix = rng.integers(0, 50257, 256)
    for i in (3, 9):
        prompts[i] = np.concatenate([prefix, prompts[i][256:]])
    return prompts


def _drive(engine, prompts, adapters=None, burst=False):
    """Submit the traffic: 8 requests at once, then, once request 3's
    prefill registered the shared pages, the other 4 (which wait for free
    slots); request ``i`` under ``adapters[i]`` when given. With
    ``burst`` each group goes in through ``submit_many``, so one
    admission pass sees it whole and the run's batches do not depend on
    the host's timing. Returns the handles."""
    t0 = time.perf_counter()
    adapters = adapters or [None] * 12

    def submit(idx):
        kws = [dict(prompt=prompts[i], max_new_tokens=N_NEW,
                    temperature=TEMPS[i], adapter=adapters[i]) for i in idx]
        if burst:
            return engine.submit_many(kws)
        return [engine.submit(**kw) for kw in kws]

    handles = submit(range(8))
    while handles[3].first_token_at is None:
        check(not handles[3].done.is_set() or handles[3].error is None,
              f"request 3 failed: {handles[3].error!r}")
        check(time.perf_counter() - t0 < 300, "request 3 stalled")
        time.sleep(0.005)
    return handles + submit(range(8, 12))


def _profile(torch, run, groups=None, ranges=()):
    """Run ``run()`` under torch.profiler and report the device's busy
    time (the union of CUDA kernel and copy intervals) against the wall
    time, with the largest kernels by device time, and, for ``groups``
    ({label: a substring of the kernel name, or a tuple of them}), each
    group's calls and device time, and for ``ranges`` (names of
    ``record_function`` ranges) each range's calls, host time and the
    device time of the kernels launched inside it. Without device events
    the device numbers are "not measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernels and copies; a ``record_function`` range also appears on the
    # device timeline, as one span over its kernels and the gaps between
    # them, and is left out of the busy time
    dev = _device_events(prof, DeviceType.CUDA, ranges)
    if not dev:
        return {"wall_s": wall, "device_busy_s": "not measured"}
    spans = sorted((start, end) for _, start, end in dev)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name = {}
    for name, start, end in dev:
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + (end - start))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    total = sum(t for _, t in by_name.values())
    grouped = {}
    for label, parts in (groups or {}).items():
        parts = (parts,) if isinstance(parts, str) else parts
        hits = [v for k, v in by_name.items()
                if any(part in k for part in parts)]
        t = sum(v[1] for v in hits)
        grouped[label] = {"calls": sum(v[0] for v in hits), "s": t / 1e6,
                          "share_of_device_time": t / total}
    events = prof.events() if ranges else ()
    for name in ranges:
        hits = [e for e in events if e.name == name
                and e.device_type == DeviceType.CPU]
        t = sum(e.device_time_total if hasattr(e, "device_time_total")
                else e.cuda_time_total for e in hits)
        grouped[name] = {"calls": len(hits),
                         "host_s": sum(e.cpu_time_total for e in hits) / 1e6,
                         "s": t / 1e6, "share_of_device_time": t / total}
    return {"wall_s": wall, "device_busy_s": busy / 1e6,
            "groups": grouped,
            "device_busy_share": busy / 1e6 / wall,
            "device_events": len(dev), "device_time_s": total / 1e6,
            "top": [{"name": k[:80], "calls": n, "s": t / 1e6,
                     "share_of_device_time": t / total}
                    for k, (n, t) in top]}


def _device_events(prof, device_type, skip=()):
    """``(name, start_us, end_us)`` of the profile's events on
    ``device_type`` (user annotations and the ranges ``skip`` left out),
    read from the raw Kineto results: ``prof.events()`` builds the whole
    event tree in Python at ~65 us an event, minutes for a serving run's
    million events, and is used only where ranges need it."""
    raw = prof.profiler.kineto_results.events()
    return [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3) for e in raw
            if e.device_type() == device_type and e.name() not in skip
            and not getattr(e, "is_user_annotation", lambda: False)()]


# the serving profile's kernel families, by substrings of their names
SERVING_KERNEL_GROUPS = {"paged attention": "paged_attention_kernel",
                         "sampling": "fused_sample_kernel"}


class _lora_ranges:
    """While active (``on``), every LoRA delta runs inside a
    ``record_function("lora_delta")`` range, so a profile attributes its
    products' device time (a measurement-only wrapper around
    ``nn.quantized.lora_delta``, which keeps counting its products)."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        if not self.on:
            return self
        import torch
        from bigdl_tpu_torch.nn import quantized
        real = self.real = quantized.lora_delta

        def ranged(*args):
            with torch.profiler.record_function("lora_delta"):
                return real(*args)

        # the delta counts its products on whatever its module's name
        # holds: carry the count across
        ranged.products = real.products
        quantized.lora_delta = ranged
        return self

    def __exit__(self, *exc):
        if self.on:
            from bigdl_tpu_torch.nn import quantized
            self.real.products = quantized.lora_delta.products
            quantized.lora_delta = self.real
        return False


def _serving_counts():
    """The serving path's launch counts (the flash forward's on both of
    its paths), int8 products and LoRA delta products."""
    from bigdl_tpu_torch.nn.quantized import lora_delta, qmatmul
    from bigdl_tpu_torch.ops.flash_attention import flash_fwd
    from bigdl_tpu_torch.ops.paged_attention import paged_pool_attention
    from bigdl_tpu_torch.ops.sampling import fused_sample_logits
    return {"paged_attention": paged_pool_attention.launches,
            "paged_attention_int8": paged_pool_attention.int8_launches,
            "fused_sampling": fused_sample_logits.launches,
            "flash_fwd": flash_fwd.launches + flash_fwd.tc_launches,
            "int8_matmuls": qmatmul.calls,
            "lora_products": lora_delta.products}


def _reset_serving_counts():
    from bigdl_tpu_torch.nn.quantized import lora_delta, qmatmul
    from bigdl_tpu_torch.ops.paged_attention import paged_pool_attention
    from bigdl_tpu_torch.ops.sampling import fused_sample_logits
    lora_delta.products = 0
    paged_pool_attention.launches = 0
    paged_pool_attention.int8_launches = 0
    paged_pool_attention.sharded_calls = 0
    fused_sample_logits.launches = 0
    fused_sample_logits.long_row_launches = 0
    qmatmul.calls = 0
    _reset_flash_counts()


SPEC_KEYS = ("spec_proposed", "spec_accepted", "spec_rollbacks",
             "spec_accept_rate")


def _serve_traffic(torch, engine, rng, adapters=None, profiled=True,
                   before_run=None, after_run=None, burst=False):
    """A warm-up request, then the 12-request traffic (request ``i`` under
    ``adapters[i]`` when given) with every count set to 0 just before it
    and read just after, then (``profiled``) the same traffic with fresh
    prompts once more under torch.profiler, LoRA delta products as their
    own range when there are ``adapters``. ``before_run()`` and
    ``after_run()`` are called just before the counted run and when its
    counts are read; ``burst``: ``_drive``'s. Returns the run's record."""
    try:
        # warm-up (cuBLAS handles, allocator): not part of the run
        engine.generate(rng.integers(0, 50257, 80), 4, temperature=0.8,
                        timeout=300)
        if before_run is not None:
            before_run()
        _reset_serving_counts()
        engine.stats.reset()
        torch.cuda.reset_peak_memory_stats()
        prompts = _traffic(rng)
        t_run = time.perf_counter()
        handles = _drive(engine, prompts, adapters, burst)
        outs = [h.result(timeout=600) for h in handles]
        wall = time.perf_counter() - t_run
        stats = engine.stats.snapshot()
        counts = _serving_counts()
        metrics = engine.metrics()
        peak = torch.cuda.max_memory_allocated()
        if after_run is not None:
            after_run()
        # where the time goes: the same traffic (fresh prompts) once more
        # under torch.profiler, after the counts were read
        profile = None
        if profiled:
            fresh = _traffic(rng)
            with _lora_ranges(adapters is not None):
                profile = _profile(
                    torch, lambda: [h.result(timeout=600) for h in
                                    _drive(engine, fresh, adapters)],
                    groups=SERVING_KERNEL_GROUPS,
                    ranges=("lora_delta",) if adapters else ())
    finally:
        engine.shutdown()
    for i, (o, h) in enumerate(zip(outs, handles)):
        check(o.size == LENGTHS[i] + N_NEW and not h.truncated,
              f"request {i}: {o.size - LENGTHS[i]} of {N_NEW} tokens")
        check(((o >= 0) & (o < 50257)).all(), f"request {i}: bad token id")
    check(not engine.paged or (metrics["prefix_hits"] >= 1 and
                               metrics["prefix_hit_tokens"] >= 256),
          f"no prefix-cache hit: {metrics.get('prefix_hits')}")
    check(counts["fused_sampling"] >= 1, "the fused sampler never launched")
    check(counts["fused_sampling"] == stats["sampled_steps"],
          f"the fused sampler launched {counts['fused_sampling']} times for "
          f"{stats['sampled_steps']} decode steps with a sampled row")
    ttft = [h.first_token_at - h.submitted_at for h in handles]
    generated = sum(o.size - n for o, n in zip(outs, LENGTHS))
    import numpy as np
    line = {"requests": len(handles), "new_tokens_each": N_NEW,
            "generated_tokens": int(generated), "wall_s": wall,
            "tokens_per_s": generated / wall,
            "ttft_mean_s": float(np.mean(ttft)),
            "ttft_p50_s": float(np.median(ttft)),
            "ttft_max_s": float(np.max(ttft)),
            "peak_memory_bytes": peak, "paged": engine.paged,
            "decode_steps": stats["steps"],
            "sampled_steps": stats["sampled_steps"],
            "launches": counts,
            "kv_dtype": metrics["kv_dtype"],
            "kv_bytes_per_token": metrics["kv_bytes_per_token"],
            "tp_degree": metrics["tp_degree"],
            "kv_bytes_per_token_per_chip":
                metrics["kv_bytes_per_token_per_chip"],
            "sharded_attention_calls": metrics["sharded_attention_calls"]}
    if engine.spec_tokens > 1:
        line.update({"spec_tokens": engine.spec_tokens,
                     **{k: metrics[k] for k in SPEC_KEYS}})
        check(line["spec_proposed"] == line["spec_accepted"]
              + line["spec_rollbacks"] > 0,
              f"spec counters do not add up: {[line[k] for k in SPEC_KEYS]}")
    if engine.paged:
        line.update({"prefill_chunks": stats["prefill_chunks"],
                     "cow_copies": stats["copies"],
                     **{k: metrics[k] for k in (
                         "prefix_hits", "prefix_hit_tokens", "num_pages",
                         "pool_bytes", "pool_bytes_per_chip")}})
    else:
        line.update({"prefills": stats["prefills"],
                     "cache_bytes": metrics["cache_bytes"],
                     "cache_bytes_per_chip": metrics["cache_bytes_per_chip"]})
    return prompts, outs, line, profile


def _greedy_slots(torch, model, prompts, n_steps, int8_kv, paged=True,
                  adapter_pool=None, adapter_slots=None):
    """Prompts through a 2-slot ``PagedSlotManager`` (or, ``paged=False``,
    a dense ``SlotManager`` of one slot a prompt) on ``model``'s device,
    admitted together (under ``adapter_pool``'s rows ``adapter_slots``,
    or every row under a ``models.lora.SingleAdapter``), then ``n_steps``
    greedy decode steps. Returns the tokens (B, n_steps) and each step's
    float32 logits (B, n_steps, V) on the CPU."""
    import numpy as np
    from bigdl_tpu_torch.serving import PagedSlotManager, SlotManager
    if paged:
        slots = PagedSlotManager(model, max_slots=2, page_size=16,
                                 prefill_chunk=64, int8_kv=int8_kv,
                                 adapter_pool=adapter_pool)
    else:
        slots = SlotManager(model, max_slots=len(prompts),
                            window=len(prompts), adapter_pool=adapter_pool)
    slots.admit(prompts, adapter_slots=adapter_slots)
    toks, logits = [], []
    for _ in range(n_steps):
        logits.append(slots._logits.float().cpu())
        slots.reserve_block()
        toks.append(slots.step()[0])
    return np.stack(toks, axis=1), torch.stack(logits, dim=1)


def _first_divergence(torch, name, got, want, cpu_logits, threshold):
    """Per row: the first step where the card's tokens ``got`` leave the
    CPU's ``want``; each must lie where the CPU top-2 logit gap is below
    ``threshold``. Returns the divergences (printed as well)."""
    import numpy as np
    top2 = torch.topk(cpu_logits, 2, dim=-1).values
    gaps = (top2[..., 0] - top2[..., 1]).numpy()
    found = []
    for row in range(got.shape[0]):
        miss = np.nonzero(got[row] != want[row])[0]
        if miss.size:
            step = int(miss[0])
            gap = float(gaps[row, step])
            print(f"{name} row {row}: card and CPU greedy tokens diverge at "
                  f"step {step}, CPU top-2 logit gap {gap}", flush=True)
            check(gap < threshold, f"{name} row {row} diverges at step "
                                   f"{step} with a top-2 gap of {gap}")
            found.append({"row": row, "step": step, "gap": gap})
    return found


# the card-vs-CPU token checks of the serving phases: requests CMP_IDX, the
# first N_CMP greedy tokens; a divergence may only lie where the CPU top-2
# logit gap is below FLOAT_GAP (float weights) or INT8_GAP (below)
CMP_IDX, N_CMP, FLOAT_GAP = [0, 11], 16, 1e-3


def _cpu_greedy(torch, params, prompts, int8_kv):
    """The port's CPU run (plain versions) of the prompts CMP_IDX on
    ``params``: tokens (2, N_CMP) and each step's logits."""
    from bigdl_tpu_torch.models.gpt import gpt2_small
    cpu_model = gpt2_small(device="cpu")
    cpu_model.load_state_dict(params)
    cpu_model.requires_grad_(False)
    return _greedy_slots(torch, cpu_model, [prompts[i] for i in CMP_IDX],
                         N_CMP, int8_kv)


def _engine_greedy(outs):
    """The first N_CMP generated tokens of the engine's requests CMP_IDX."""
    import numpy as np
    return np.stack([outs[i][LENGTHS[i]:LENGTHS[i] + N_CMP]
                     for i in CMP_IDX])


def phase_slice(torch, kernels):
    import numpy as np
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.models.gpt import gpt2_small
    from bigdl_tpu_torch.serving import ServingEngine

    t0 = time.perf_counter()
    model = gpt2_small()
    params = convert.init_params(model, seed=0)
    engine = ServingEngine(model, params, max_slots=8, paged=True,
                           page_size=16, prefill_chunk=64, top_k=50,
                           top_p=0.9, seed=0)
    n_layers = len(model.gpt.layers)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts, outs, line, profile = _serve_traffic(torch, engine, rng)
    counts = line["launches"]
    dispatches = line["prefill_chunks"] + line["decode_steps"]
    check(counts["paged_attention"] >= n_layers * dispatches,
          f"paged attention launched {counts['paged_attention']} times for "
          f"{dispatches} chunk+step dispatches of {n_layers} layers")
    kernels["paged_attention"]["launches"] = counts["paged_attention"]
    kernels["fused_sampling"]["launches"] = counts["fused_sampling"]
    _NO_FAULT["paged"] = outs

    # greedy tokens against the port's plain versions on the CPU: the float
    # path is row-local, so the engine's own tokens are compared
    cpu_toks, cpu_logits = _cpu_greedy(torch, params, prompts, False)
    divergences = _first_divergence(torch, "slice", _engine_greedy(outs),
                                    cpu_toks, cpu_logits, FLOAT_GAP)
    _NO_FAULT["paged_cpu_div"] = divergences
    emit({"phase": "slice", "model": "gpt2_small", "layers": n_layers,
          **line, "greedy_checked": CMP_IDX,
          "greedy_tokens_compared": N_CMP, "divergences": divergences,
          "setup_s": setup_s})
    emit({"phase": "profile", "path": "serving", **profile})
    return line, (cpu_toks, cpu_logits), _engine_greedy(outs)


# card-vs-CPU token check of the int8 slice: a divergence may only lie
# where the CPU top-2 logit gap is below this. The card's float operations
# (attention kernel, LayerNorm, the head's GEMM) differ from the CPU's in
# the last bits; where one lands an activation on the other side of an
# int8 rounding boundary the int8 product moves by a whole quantisation
# step, and the logits move by a few hundredths. The phase measures that
# on the CPU (``cpu_ulp_logit_change``: token embeddings moved by 2^-23
# relative); 0.1 is about twice the largest value of it seen.
INT8_GAP = 0.1


def _weight_bytes(model):
    return sum(t.numel() * t.element_size()
               for t in model.state_dict().values())


def phase_slice_int8(torch, kernels, f32_line):
    import numpy as np
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.models.gpt import gpt2_small
    from bigdl_tpu_torch.nn import quantize_model
    from bigdl_tpu_torch.serving import ServingEngine
    from bigdl_tpu_torch.serving.paging import kv_token_bytes

    t0 = time.perf_counter()
    model = gpt2_small()
    params = convert.init_params(model, seed=0)
    float_weight_bytes = _weight_bytes(model)
    # the float32 slice's pool in bytes, now holding int8 pages
    kv_bytes = f32_line["num_pages"] * 16 * kv_token_bytes(model)
    engine = ServingEngine(model, params, max_slots=8, paged=True,
                           page_size=16, prefill_chunk=64, top_k=50,
                           top_p=0.9, seed=0, int8_weights=True,
                           int8_kv=True, kv_bytes=kv_bytes)
    n_layers = len(model.gpt.layers)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts, outs, line, profile = _serve_traffic(torch, engine, rng)
    counts = line["launches"]
    dispatches = line["prefill_chunks"] + line["decode_steps"]
    check(counts["paged_attention_int8"] == n_layers * dispatches,
          f"int8 paged attention launched {counts['paged_attention_int8']} "
          f"times for {dispatches} chunk+step dispatches of {n_layers} "
          f"layers")
    check(counts["paged_attention"] == 0,
          f"the float paged kernel launched {counts['paged_attention']} "
          f"times over int8 pools")
    check(counts["int8_matmuls"] == 6 * n_layers * dispatches,
          f"{counts['int8_matmuls']} int8 products for {dispatches} "
          f"dispatches of {n_layers} layers (6 a layer)")
    check(line["kv_dtype"] == "int8", f"pool dtype {line['kv_dtype']}")
    kernels["paged_attention_int8"]["launches"] = \
        counts["paged_attention_int8"]

    # card against CPU, both hand-driven in the same order: int8 weights
    # couple a dispatch's rows (one activation amax per batch), so the
    # engine's tokens depend on its batching and are not compared
    cmp_prompts = [prompts[i] for i in CMP_IDX]
    card_toks, card_logits = _greedy_slots(torch, model, cmp_prompts, N_CMP,
                                           True)

    def cpu_int8(sd):
        m = gpt2_small(device="cpu")
        m.load_state_dict(sd)
        m.requires_grad_(False)
        return quantize_model(m)

    cpu_model = cpu_int8(params)
    card_sd = model.state_dict()
    for name, t in cpu_model.state_dict().items():
        check(torch.equal(t, card_sd[name].cpu()),
              f"weights differ between card and CPU: {name}")
    cpu_toks, cpu_logits = _greedy_slots(torch, cpu_model, cmp_prompts,
                                         N_CMP, True)
    divergences = _first_divergence(torch, "slice_int8", card_toks,
                                    cpu_toks, cpu_logits, INT8_GAP)
    # what a last-bit difference does to the logits through the int8
    # roundings, on the CPU alone
    g = torch.Generator().manual_seed(1)
    moved = dict(params)
    emb = params["gpt.tok_emb"]
    moved["gpt.tok_emb"] = emb + emb * (
        torch.rand(emb.shape, generator=g) - 0.5) * 2.0 ** -22
    _, moved_logits = _greedy_slots(torch, cpu_int8(moved), cmp_prompts,
                                    N_CMP, True)
    ulp_change = float((moved_logits - cpu_logits).abs().max())
    print(f"slice_int8: CPU logits move by up to {ulp_change} when the "
          f"token embeddings move by 2^-23 relative; divergence threshold "
          f"{INT8_GAP}", flush=True)
    emit({"phase": "slice_int8", "model": "gpt2_small", "layers": n_layers,
          "int8_weights": True, "int8_kv": True, "kv_bytes": kv_bytes,
          **line, "float32_num_pages": f32_line["num_pages"],
          "float32_kv_bytes_per_token": f32_line["kv_bytes_per_token"],
          "tokens_per_byte_vs_float32": (f32_line["kv_bytes_per_token"]
                                         / line["kv_bytes_per_token"]),
          "weight_bytes": _weight_bytes(model),
          "float32_weight_bytes": float_weight_bytes,
          "greedy_checked": CMP_IDX, "greedy_tokens_compared": N_CMP,
          "gap_threshold": INT8_GAP, "cpu_ulp_logit_change": ulp_change,
          "divergences": divergences, "setup_s": setup_s})
    emit({"phase": "profile", "path": "serving_int8", **profile})
    return line, (card_toks, card_logits, _engine_greedy(outs))


TP_MESH = ["cuda:0", "cuda:0"]     # both shards of slice_tp on one card


def phase_slice_tp(torch, kernels, f32_line, base, cpu_ref, int8_kv):
    """``slice`` (or, with ``int8_kv``, its int8 K/V pool) served tensor-
    parallel: GPT-2 small at full width and depth through
    ``ServingEngine(mesh=TP_MESH)``, the same seeded weights and the same
    12-request traffic (``default_rng(0)``), ``kv_bytes`` = the float
    slice's pool bytes (``f32_line``) as a per-chip budget, as
    ``slice_int8`` takes it, so the pool holds ``pages_for_budget(...,
    tp=2)`` pages; ``base`` is the unsharded phase's line, reported
    beside. Checks: exact per-shard launch
    counts (tp x layers x dispatches of the pool's kernel, none of the
    other), one sharded call per layer and dispatch, the sampler once per
    sampled decode step, the measured per-shard bytes; greedy tokens of
    CMP_IDX against the CPU: ``cpu_ref`` (slice's unsharded CPU run) for
    float pools, a CPU ``int8_kv`` run of the unsharded port for int8."""
    import numpy as np
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.models.gpt import gpt2_small
    from bigdl_tpu_torch.serving import ServingEngine
    from bigdl_tpu_torch.serving.paging import pages_for_budget

    name = "slice_tp_int8" if int8_kv else "slice_tp"
    t0 = time.perf_counter()
    # the source model stays on the CPU: the engine copies its shards out
    model = gpt2_small(device="cpu")
    params = convert.init_params(model, seed=0)
    kv_bytes = f32_line["pool_bytes"]
    engine = ServingEngine(model, params, max_slots=8, paged=True,
                           page_size=16, prefill_chunk=64, top_k=50,
                           top_p=0.9, seed=0, int8_kv=int8_kv,
                           kv_bytes=kv_bytes, mesh=TP_MESH)
    tp = engine.layout.tp
    n_layers = len(model.gpt.layers)
    pages = pages_for_budget(model, 16, kv_bytes, int8=int8_kv, tp=tp)
    shard_planes = engine.model.gpt.pool_planes(engine.slots._pools)
    shard_bytes = [sum(v.numel() * v.element_size() for v in shard)
                   for shard in shard_planes]
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts, outs, line, profile = _serve_traffic(torch, engine, rng)
    counts = line["launches"]
    dispatches = line["prefill_chunks"] + line["decode_steps"]
    run, idle = (("paged_attention_int8", "paged_attention") if int8_kv
                 else ("paged_attention", "paged_attention_int8"))
    check(counts[run] == tp * n_layers * dispatches,
          f"{name}: {run} launched {counts[run]} times for {dispatches} "
          f"chunk+step dispatches of {n_layers} layers at tp {tp}")
    check(counts[idle] == 0, f"{name}: {idle} launched {counts[idle]} times")
    check(line["sharded_attention_calls"] == n_layers * dispatches,
          f"{name}: {line['sharded_attention_calls']} sharded calls for "
          f"{dispatches} dispatches of {n_layers} layers")
    check(line["num_pages"] == pages,
          f"{name}: {line['num_pages']} pages, the budget gives {pages}")
    check(line["tp_degree"] == tp and len(set(shard_bytes)) == 1
          and shard_bytes[0] == line["pool_bytes_per_chip"]
          and shard_bytes[0] * tp == line["pool_bytes"],
          f"{name}: shard bytes {shard_bytes}, pool {line['pool_bytes']}")
    kernels["paged_attention_tp"]["launches"] += counts[run]
    kernels["paged_attention_tp"].setdefault("launches_by_phase", {})[
        name] = counts[run]

    if int8_kv:
        (cpu_toks, cpu_logits), gap = (_cpu_greedy(torch, params, prompts,
                                                   True), INT8_GAP)
    else:
        (cpu_toks, cpu_logits), gap = cpu_ref, FLOAT_GAP
    divergences = _first_divergence(torch, name, _engine_greedy(outs),
                                    cpu_toks, cpu_logits, gap)
    emit({"phase": name, "model": "gpt2_small", "layers": n_layers,
          "int8_kv": int8_kv, "kv_bytes": kv_bytes,
          **engine.layout.describe(), "one_card_holds_all_shards":
              len(set(engine.layout.devices)) == 1,
          **line, "shard_pool_bytes": shard_bytes,
          "pages_for_budget": pages, "unsharded_num_pages": base["num_pages"],
          "unsharded_tokens_per_s": base["tokens_per_s"],
          "unsharded_ttft_mean_s": base["ttft_mean_s"],
          "unsharded_peak_memory_bytes": base["peak_memory_bytes"],
          "greedy_checked": CMP_IDX, "greedy_tokens_compared": N_CMP,
          "gap_threshold": gap, "divergences": divergences,
          "setup_s": setup_s})
    emit({"phase": "profile", "path": "serving_tp_int8" if int8_kv
          else "serving_tp", **profile})


# slice_dense's tensor-parallel check: these greedy requests of the traffic
DENSE_TP_IDX = [0, 2, 3, 11]


def phase_slice_dense(torch, kernels, f32_line, cpu_ref):
    """``slice``'s model, weights and traffic through ``ServingEngine(model,
    params, max_slots=8)`` with no ``paged`` argument and no flag: the
    dense slot table (the reference's default). Checks: every request
    retires with its tokens; no paged-attention launch; one sampler launch
    per decode step with a sampled row; no flash launch (every prompt
    bucket is at most 1024, under the reference's flash gate of 2048);
    greedy tokens of CMP_IDX against ``slice``'s CPU run (``cpu_ref``),
    diverging only where its top-2 gap is below FLOAT_GAP. Then the dense
    path tensor-parallel on one card (``mesh=TP_MESH``): DENSE_TP_IDX's
    greedy requests through the engine, their first N_CMP tokens against
    the unsharded dense model's, hand-driven on the card (a divergence
    only where that run's top-2 gap is below FLOAT_GAP)."""
    import os

    import numpy as np
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.models.gpt import gpt2_small
    from bigdl_tpu_torch.serving import ServingEngine

    check("BIGDL_TPU_PAGED_KV" not in os.environ,
          "slice_dense serves the engine's default: unset BIGDL_TPU_PAGED_KV")
    t0 = time.perf_counter()
    model = gpt2_small()
    params = convert.init_params(model, seed=0)
    engine = ServingEngine(model, params, max_slots=8, top_k=50, top_p=0.9,
                           seed=0)
    check(not engine.paged, "the default engine is not the dense one")
    n_layers = len(model.gpt.layers)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts, outs, line, profile = _serve_traffic(torch, engine, rng)
    counts = line["launches"]
    check(counts["paged_attention"] == counts["paged_attention_int8"] == 0,
          f"slice_dense launched the paged kernel: {counts}")
    check(counts["flash_fwd"] == 0,
          f"slice_dense launched flash {counts['flash_fwd']} times")
    kernels["fused_sampling"].setdefault("launches_by_phase", {})[
        "slice_dense"] = counts["fused_sampling"]
    _NO_FAULT["dense"] = outs
    cpu_toks, cpu_logits = cpu_ref
    divergences = _first_divergence(torch, "slice_dense",
                                     _engine_greedy(outs), cpu_toks,
                                     cpu_logits, FLOAT_GAP)
    emit({"phase": "slice_dense", "model": "gpt2_small", "layers": n_layers,
          **line, "paged_tokens_per_s": f32_line["tokens_per_s"],
          "paged_ttft_mean_s": f32_line["ttft_mean_s"],
          "paged_peak_memory_bytes": f32_line["peak_memory_bytes"],
          "paged_pool_bytes": f32_line["pool_bytes"],
          "greedy_checked": CMP_IDX, "greedy_tokens_compared": N_CMP,
          "divergences": divergences, "setup_s": setup_s})
    emit({"phase": "profile", "path": "serving_dense", **profile})

    # the dense path at tp 2, both shards on the card
    tp_prompts = [prompts[i] for i in DENSE_TP_IDX]
    want, want_logits = _greedy_slots(torch, engine.model, tp_prompts,
                                      N_CMP, False, paged=False)
    del engine, model
    torch.cuda.empty_cache()
    cpu_model = gpt2_small(device="cpu")
    tp_engine = ServingEngine(cpu_model, params, max_slots=8, top_k=50,
                              top_p=0.9, seed=0, mesh=TP_MESH)
    try:
        _reset_serving_counts()
        t_run = time.perf_counter()
        handles = [tp_engine.submit(p, N_NEW) for p in tp_prompts]
        tp_outs = [h.result(timeout=600) for h in handles]
        wall = time.perf_counter() - t_run
        tp_counts = _serving_counts()
        met = tp_engine.metrics()
        planes = tp_engine.model.gpt.cache_planes(tp_engine.slots._cache)
    finally:
        tp_engine.shutdown()
    check(tp_counts["paged_attention"] == tp_counts["flash_fwd"] == 0,
          f"slice_dense tp: {tp_counts}")
    for i, o in zip(DENSE_TP_IDX, tp_outs):
        check(o.size == LENGTHS[i] + N_NEW,
              f"slice_dense tp request {i}: {o.size - LENGTHS[i]} tokens")
    got = np.stack([o[LENGTHS[i]:LENGTHS[i] + N_CMP]
                    for i, o in zip(DENSE_TP_IDX, tp_outs)])
    tp_div = _first_divergence(torch, "slice_dense_tp", got, want,
                               want_logits, FLOAT_GAP)
    shard_bytes = [sum(v.numel() * v.element_size() for v in shard)
                   for shard in planes]
    check(shard_bytes == [met["cache_bytes_per_chip"]] * 2
          and met["cache_bytes"] == 2 * shard_bytes[0],
          f"slice_dense tp: shard bytes {shard_bytes}, cache "
          f"{met['cache_bytes']}")
    emit({"phase": "slice_dense_tp", "model": "gpt2_small",
          "layers": n_layers, **tp_engine.layout.describe(),
          "requests": DENSE_TP_IDX, "new_tokens_each": N_NEW,
          "tokens_per_s": len(tp_prompts) * N_NEW / wall,
          "launches": tp_counts, "shard_cache_bytes": shard_bytes,
          "cache_bytes": met["cache_bytes"],
          "greedy_tokens_compared": N_CMP,
          "exact_vs_engine": [bool(np.array_equal(
              o[LENGTHS[i]:], outs[i][LENGTHS[i]:]))
              for i, o in zip(DENSE_TP_IDX, tp_outs)],
          "divergences": tp_div})
    return line, _engine_greedy(outs)


def _cpu_sliding_greedy(torch, model, ids, n_new):
    """``GPTForCausalLM._generate_sliding``'s greedy loop on a CPU model,
    keeping each step's float32 logits: tokens (B, n_new) and logits
    (B, n_new, V)."""
    window = model.gpt.max_position
    cur = torch.as_tensor(ids).long()
    toks, logits = [], []
    with torch.no_grad():
        for _ in range(n_new):
            lg = model._lm_logits(model.gpt(cur[:, -window:])[:, -1])
            logits.append(lg.float())
            tok = torch.argmax(lg, dim=-1)
            toks.append(tok)
            cur = torch.cat([cur, tok[:, None]], 1)
    return torch.stack(toks, 1).numpy(), torch.stack(logits, 1)


def _dense_greedy(torch, model, ids, n_new):
    """``GPTForCausalLM.generate``'s greedy prefill and decode loop on the
    model's device, keeping each step's float32 logits: tokens (B, n_new)
    and logits (B, n_new, V), on the CPU."""
    from bigdl_tpu_torch.models.gpt import prompt_bucket
    gpt = model.gpt
    ids = torch.as_tensor(ids).long()
    b, t = ids.shape
    padded = torch.zeros((b, prompt_bucket(t, gpt.max_position)),
                         dtype=torch.long)
    padded[:, :t] = ids
    toks, logits = [], []
    with torch.no_grad():
        h, cache = gpt.prefill(gpt.init_cache(b), padded, t)
        lg = model._lm_logits(h)
        for step in range(n_new):
            logits.append(lg.float().cpu())
            tok = torch.argmax(lg, dim=-1)
            toks.append(tok.cpu())
            if step + 1 < n_new:
                h, cache = gpt.decode_step(cache, tok, t + step)
                lg = model._lm_logits(h)
    return torch.stack(toks, 1).numpy(), torch.stack(logits, 1)


GEN_PROMPTS, GEN_PROMPT_LEN = 4, 100     # generate: 4 prompts of 100 tokens
SLIDING_PROMPT = 1000                    # + N_NEW passes GPT-2's 1024
# a GPT-2-small-width model with a 4096-position table (not a published
# model): its 1500-token prompt pads to the bucket 2048, where the
# reference's flash gate (causal, t % 128 == 0, t >= 2048) opens
LONG_POSITIONS, LONG_PROMPT = 4096, 1500


def phase_generate(torch, kernels):
    """``GPTForCausalLM.generate`` at GPT-2 small (``slice``'s weights):
    GEN_PROMPTS prompts of GEN_PROMPT_LEN tokens, N_NEW new, greedy (rows
    equal to the dense engine's tokens for the same prompts, served with
    one slot a prompt so that every product has generate's shapes) and
    sampled at (50, 0.9), T 0.8 (the sampler launched once a token); a
    SLIDING_PROMPT-token prompt takes ``_generate_sliding``: 12 flash
    forward launches a token, the first N_CMP greedy tokens against the
    CPU's sliding loop; then a GPT-2-small-width model with LONG_POSITIONS
    positions on a LONG_PROMPT-token prompt: the bucketed prefill past the
    reference's flash gate launches the flash forward once a layer (12),
    and its first N_CMP greedy tokens hold against the CPU run. A
    divergence from the CPU only where its top-2 gap is below
    FLOAT_GAP."""
    import numpy as np
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.models.gpt import GPTForCausalLM, gpt2_small
    from bigdl_tpu_torch.ops.flash_attention import flash_fwd
    from bigdl_tpu_torch.ops.sampling import fused_sample_logits
    from bigdl_tpu_torch.serving import ServingEngine

    rng = np.random.default_rng(7)
    model = gpt2_small()
    params = convert.init_params(model, seed=0)
    model.load_state_dict(params)
    model.requires_grad_(False)
    n_layers = len(model.gpt.layers)
    ids = rng.integers(0, 50257, (GEN_PROMPTS, GEN_PROMPT_LEN))
    model.generate(ids[:1, :16], 2)                     # warm-up
    _reset_serving_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    greedy = model.generate(ids, N_NEW).numpy()
    greedy_s = time.perf_counter() - t0
    check(_serving_counts()["flash_fwd"] == 0, "generate launched flash "
          "below the gate")
    gen = torch.Generator(device="cuda").manual_seed(0)
    _reset_serving_counts()
    t0 = time.perf_counter()
    sampled = model.generate(ids, N_NEW, temperature=0.8, generator=gen,
                             top_k=50, top_p=0.9).numpy()
    sampled_s = time.perf_counter() - t0
    sampler = fused_sample_logits.launches
    check(sampler == N_NEW, f"generate sampled with {sampler} sampler "
                            f"launches for {N_NEW} tokens")
    check(((sampled >= 0) & (sampled < 50257)).all(), "bad sampled token")
    # the dense engine on the same prompts: the same shapes, the same bits
    # the prompts admitted together, in order: row r of generate's batch
    engine = ServingEngine(model, None, max_slots=GEN_PROMPTS,
                           admit_wait_s=5.0)
    try:
        handles = [engine.submit(p, N_NEW) for p in ids]
        served = np.stack([h.result(timeout=600) for h in handles])
    finally:
        engine.shutdown()
    check(np.array_equal(served, greedy),
          f"generate's greedy rows differ from the dense engine's at "
          f"{np.argwhere(served != greedy)[:4].tolist()}")
    spec_line = _generate_spec(torch, model, ids, greedy, greedy_s)

    # past max_position: the sliding loop, one full forward a token
    cpu_model = gpt2_small(device="cpu")
    cpu_model.load_state_dict(params)
    cpu_model.requires_grad_(False)
    long_ids = rng.integers(0, 50257, (1, SLIDING_PROMPT))
    _reset_serving_counts()
    t0 = time.perf_counter()
    slide = model.generate(long_ids, N_NEW).numpy()[:, SLIDING_PROMPT:]
    sliding_s = time.perf_counter() - t0
    slide_flash = flash_fwd.launches
    check(slide_flash == n_layers * N_NEW,
          f"sliding: {slide_flash} flash launches for {N_NEW} tokens of "
          f"{n_layers} layers")
    cpu_slide, cpu_slide_logits = _cpu_sliding_greedy(torch, cpu_model,
                                                       long_ids, N_CMP)
    slide_div = _first_divergence(torch, "generate sliding",
                                  slide[:, :N_CMP], cpu_slide,
                                  cpu_slide_logits, FLOAT_GAP)
    del model, cpu_model
    torch.cuda.empty_cache()

    # the reference's dense flash gate: a 4096-position table
    long_model = GPTForCausalLM(max_position=LONG_POSITIONS)
    long_params = convert.init_params(long_model, seed=0)
    long_model.load_state_dict(long_params)
    long_model.requires_grad_(False)
    prompt = rng.integers(0, 50257, (1, LONG_PROMPT))
    _reset_serving_counts()
    t0 = time.perf_counter()
    out = long_model.generate(prompt, N_CMP).numpy()[:, LONG_PROMPT:]
    long_s = time.perf_counter() - t0
    long_flash = flash_fwd.launches
    check(long_flash == n_layers, f"the 2048-bucket prefill launched flash "
                                  f"{long_flash} times, not {n_layers}")
    cpu_long = GPTForCausalLM(max_position=LONG_POSITIONS, device="cpu")
    cpu_long.load_state_dict(long_params)
    cpu_long.requires_grad_(False)
    cpu_toks, cpu_logits = _dense_greedy(torch, cpu_long, prompt, N_CMP)
    long_div = _first_divergence(torch, "generate long prefill", out,
                                 cpu_toks, cpu_logits, FLOAT_GAP)
    kernels["flash_fwd"].setdefault("launches_by_phase", {})[
        "generate"] = slide_flash + long_flash
    kernels["fused_sampling"].setdefault("launches_by_phase", {})[
        "generate"] = sampler
    emit({"phase": "generate", "model": "gpt2_small", "layers": n_layers,
          "prompts": GEN_PROMPTS, "prompt_tokens": GEN_PROMPT_LEN,
          "new_tokens": N_NEW,
          "greedy_tokens_per_s": GEN_PROMPTS * N_NEW / greedy_s,
          "sampled_tokens_per_s": GEN_PROMPTS * N_NEW / sampled_s,
          "sampler_launches": sampler, "greedy_equals_dense_engine": True,
          "sliding_prompt_tokens": SLIDING_PROMPT,
          "sliding_tokens_per_s": N_NEW / sliding_s,
          "sliding_flash_launches": slide_flash,
          "sliding_divergences": slide_div,
          "long_model": f"GPT-2 small widths with a {LONG_POSITIONS}-"
                        f"position table: not a published model",
          "long_prompt_tokens": LONG_PROMPT, "long_new_tokens": N_CMP,
          "long_s": long_s, "long_prefill_flash_launches": long_flash,
          "long_divergences": long_div,
          "greedy_tokens_compared": N_CMP})
    emit(spec_line)
    del long_model, cpu_long
    torch.cuda.empty_cache()


def _generate_spec(torch, model, ids, greedy, greedy_s):
    """``generate(spec_tokens=SPEC_TOKENS)`` on ``phase_generate``'s greedy
    prompts, beside its plain call (``greedy``, ``greedy_s``): rows equal
    to the plain ones, or diverging first where the plain loop's top-2
    logit gap (its loop driven by hand on the card, whose tokens must be
    the plain call's) is below FLOAT_GAP; no paged or flash launch.
    Returns its line."""
    import numpy as np
    t = ids.shape[1]
    _reset_serving_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spec = model.generate(ids, N_NEW, spec_tokens=SPEC_TOKENS).numpy()
    spec_s = time.perf_counter() - t0
    counts = _serving_counts()
    check(counts["flash_fwd"] == counts["paged_attention"] == 0,
          f"speculative generate launched {counts}")
    want, want_logits = _dense_greedy(torch, model, ids, N_NEW)
    check(np.array_equal(want, greedy[:, t:]),
          "the hand-driven greedy loop differs from generate's plain call")
    divergences = _first_divergence(torch, "generate spec", spec[:, t:],
                                    want, want_logits, FLOAT_GAP)
    return {"phase": "generate_spec", "model": "gpt2_small",
            "prompts": ids.shape[0], "prompt_tokens": t,
            "new_tokens": N_NEW, "spec_tokens": SPEC_TOKENS,
            "tokens_per_s": ids.shape[0] * N_NEW / spec_s,
            "plain_tokens_per_s": ids.shape[0] * N_NEW / greedy_s,
            "equal_to_plain": bool(np.array_equal(spec, greedy)),
            "divergences": divergences, "gap_threshold": FLOAT_GAP}


def phase_slice_tp_int8w(torch, kernels, f32_line, int8_line, int8_ref):
    """``slice_int8``'s model, weights and traffic served tensor-parallel
    with int8 weights: ``ServingEngine(mesh=TP_MESH, paged=True,
    int8_weights=True, int8_kv=True, kv_bytes=...)`` (the weights
    quantised, then split; ``kv_bytes`` the float slice's pool bytes as a
    per-chip budget, as ``slice_tp_int8`` takes it). Checks: every request
    retires; the int8 paged kernel launched exactly tp x 12 times per
    prefill chunk and decode step, the float one never; int8 products
    exactly tp x 6 a layer per dispatch (tp times the unsharded count);
    the hand-driven 2-slot int8 run of
    CMP_IDX on the shards equal to ``slice_int8``'s unsharded one on the
    card (``int8_ref``): every step's logits bit for bit, and so the
    tokens; the threaded engine's tokens of CMP_IDX equal to
    ``slice_int8``'s engine's, or diverging first where the unsharded
    hand-driven run's top-2 logit gap is below INT8_GAP (its batches
    follow the scheduler's timing, and int8 weights couple a batch's
    rows)."""
    import numpy as np
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.models.gpt import gpt2_small
    from bigdl_tpu_torch.serving import ServingEngine

    t0 = time.perf_counter()
    model = gpt2_small(device="cpu")
    params = convert.init_params(model, seed=0)
    kv_bytes = f32_line["pool_bytes"]
    engine = ServingEngine(model, params, max_slots=8, paged=True,
                           page_size=16, prefill_chunk=64, top_k=50,
                           top_p=0.9, seed=0, int8_weights=True,
                           int8_kv=True, kv_bytes=kv_bytes, mesh=TP_MESH)
    tp = engine.layout.tp
    n_layers = len(model.gpt.layers)
    shard_weights = [_weight_bytes(s) for s in engine.model.gpt.shards]
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts, outs, line, profile = _serve_traffic(torch, engine, rng)
    counts = line["launches"]
    dispatches = line["prefill_chunks"] + line["decode_steps"]
    check(counts["paged_attention_int8"] == tp * n_layers * dispatches,
          f"slice_tp_int8w: {counts['paged_attention_int8']} int8 launches "
          f"for {dispatches} dispatches of {n_layers} layers at tp {tp}")
    check(counts["paged_attention"] == 0,
          f"slice_tp_int8w: the float kernel launched "
          f"{counts['paged_attention']} times")
    check(counts["int8_matmuls"] == tp * 6 * n_layers * dispatches,
          f"slice_tp_int8w: {counts['int8_matmuls']} int8 products for "
          f"{dispatches} dispatches (tp x 6 a layer)")
    kernels["paged_attention_tp"]["launches"] += counts[
        "paged_attention_int8"]
    kernels["paged_attention_tp"].setdefault("launches_by_phase", {})[
        "slice_tp_int8w"] = counts["paged_attention_int8"]
    want_toks, want_logits, want_engine = int8_ref
    got_toks, got_logits = _greedy_slots(
        torch, engine.model, [prompts[i] for i in CMP_IDX], N_CMP, True)
    check(torch.equal(got_logits, want_logits),
          f"slice_tp_int8w: tp logits differ from the unsharded int8 run by "
          f"{float((got_logits - want_logits).abs().max())}")
    check(np.array_equal(got_toks, want_toks),
          "slice_tp_int8w: tp tokens differ from the unsharded int8 run")
    # the threaded engine's tokens against slice_int8's engine: its batches
    # follow the scheduler's timing and int8 weights couple a batch's rows,
    # so a divergence may only lie where the unsharded run's top-2 logit
    # gap is below INT8_GAP (the int8 near-tie rule)
    engine_toks = _engine_greedy(outs)
    engine_divergences = _first_divergence(
        torch, "slice_tp_int8w engine", engine_toks, want_engine,
        want_logits, INT8_GAP)
    emit({"phase": "slice_tp_int8w", "model": "gpt2_small",
          "layers": n_layers, "int8_weights": True, "int8_kv": True,
          "kv_bytes": kv_bytes, **engine.layout.describe(), **line,
          "shard_weight_bytes": shard_weights,
          "unsharded_tokens_per_s": int8_line["tokens_per_s"],
          "unsharded_ttft_mean_s": int8_line["ttft_mean_s"],
          "greedy_checked": CMP_IDX, "greedy_tokens_compared": N_CMP,
          "logits_bit_equal_to_unsharded": True,
          "engine_greedy_equal_to_slice_int8": bool(np.array_equal(
              engine_toks, want_engine)),
          "gap_threshold": INT8_GAP,
          "engine_divergences": engine_divergences,
          "setup_s": setup_s})
    emit({"phase": "profile", "path": "serving_tp_int8w", **profile})


# slice_spec's repetitive stream: REP_PROMPTS greedy prompts, each a
# REP_CYCLE-token cycle repeated to REP_LEN tokens, REP_NEW new tokens
REP_PROMPTS, REP_CYCLE, REP_LEN, REP_NEW = 4, 16, 128, 128


def _spec_engine(**kw):
    """``slice``'s engine configuration with speculation (SPEC_TOKENS) on
    a fresh GPT-2 small with ``slice``'s seeded weights (the model on the
    CPU when ``kw`` has a ``mesh``). Returns the model and the engine."""
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.models.gpt import gpt2_small
    from bigdl_tpu_torch.serving import ServingEngine
    model = gpt2_small(device="cpu" if "mesh" in kw else None)
    return model, ServingEngine(model, convert.init_params(model, seed=0),
                                max_slots=8, top_k=50, top_p=0.9, seed=0,
                                spec_tokens=SPEC_TOKENS, **kw)


def _spec_checks(torch, name, engine, line, outs, cpu_ref, want, kernels,
                 run, idle):
    """The speculative serving phases' common holds: ``run`` (the paged
    kernel the pool takes, or None on the dense table) launched exactly
    tp x layers times a prefill chunk and verify iteration,
    ``idle`` (the other) never, no flash launch; greedy tokens of CMP_IDX
    against the port's CPU run (``cpu_ref``) and against ``want`` (the
    matching non-speculative phase's engine tokens), each diverging only
    where the CPU top-2 logit gap is below FLOAT_GAP. Adds the phase's
    launches to ``kernels``. Returns the divergences."""
    import numpy as np
    counts = line["launches"]
    tp, n_layers = line["tp_degree"], len(engine.model.gpt.layers)
    if run is not None:
        dispatches = line["prefill_chunks"] + line["decode_steps"]
        check(counts[run] == tp * n_layers * dispatches,
              f"{name}: {run} launched {counts[run]} times for "
              f"{dispatches} chunk and verify dispatches")
        key = "paged_attention_tp" if tp > 1 else run
        kernels[key]["launches"] += counts[run]
        kernels[key].setdefault("launches_by_phase", {})[name] = counts[run]
    for other in idle:
        check(counts[other] == 0, f"{name}: {other} launched {counts[other]}")
    check(counts["flash_fwd"] == 0, f"{name}: flash launched")
    kernels["fused_sampling"].setdefault("launches_by_phase", {})[name] = \
        counts["fused_sampling"]
    got = _engine_greedy(outs)
    cpu_toks, cpu_logits = cpu_ref
    return {"vs_cpu": _first_divergence(torch, name, got, cpu_toks,
                                        cpu_logits, FLOAT_GAP),
            "vs_non_speculative": _first_divergence(
                torch, f"{name} vs its non-speculative phase", got, want,
                cpu_logits, FLOAT_GAP),
            "equal_to_non_speculative": bool(np.array_equal(got, want))}


def phase_slice_spec(torch, kernels, f32_line, cpu_ref, slice_toks):
    """``slice`` with speculation: the same engine (paged, 8 slots, pages of
    16, chunk 64, top_k 50, top_p 0.9, seed 0) with ``spec_tokens=
    SPEC_TOKENS``, the same weights and 12-request traffic. Holds: every
    request retires with its tokens; the paged kernel exactly 12 times a
    prefill chunk and verify iteration, the int8 one never; the sampler
    once per iteration with a sampled row; the draft's counters add up;
    greedy tokens of CMP_IDX against ``slice``'s engine and the CPU run
    (the near-tie rule). Then the repetitive stream (:func:`_repetitive`).
    Reports tokens/s, TTFT and the accept rate beside ``slice``'s, and a
    ``profile`` line. Returns the line and the engine's greedy tokens."""
    import numpy as np
    t0 = time.perf_counter()
    model, engine = _spec_engine(paged=True, page_size=16, prefill_chunk=64)
    setup_s = time.perf_counter() - t0
    prompts, outs, line, profile = _serve_traffic(
        torch, engine, np.random.default_rng(0))
    checked = _spec_checks(torch, "slice_spec", engine, line, outs, cpu_ref,
                           slice_toks, kernels, "paged_attention",
                           ("paged_attention_int8",))
    rep = _repetitive(torch, model)
    emit({"phase": "slice_spec", "model": "gpt2_small",
          "layers": len(model.gpt.layers),
          **line, "non_speculative_tokens_per_s": f32_line["tokens_per_s"],
          "non_speculative_ttft_mean_s": f32_line["ttft_mean_s"],
          "non_speculative_decode_steps": f32_line["decode_steps"],
          "greedy_checked": CMP_IDX, "greedy_tokens_compared": N_CMP,
          **checked, "repetitive": rep, "setup_s": setup_s})
    emit({"phase": "profile", "path": "serving_spec", **profile})
    return line, _engine_greedy(outs)


def _repetitive(torch, model):
    """The reference's ``test_spec_accept_rate_on_repetitive_stream`` at
    GPT-2 small: REP_PROMPTS greedy prompts, each a random REP_CYCLE-token
    cycle repeated to REP_LEN tokens, REP_NEW new tokens, through
    ``slice``'s paged engine without and with speculation, one after the
    other. Holds: every request's tokens; the paged kernel 12 times a
    dispatch; each run's tokens against the greedy loop driven by hand on
    the card (the dense table), diverging first only where its top-2 logit
    gap is below FLOAT_GAP. Returns the accept rate and both runs'
    tokens/s."""
    import numpy as np
    from bigdl_tpu_torch.serving import ServingEngine
    rng = np.random.default_rng(3)
    prompts = [np.tile(rng.integers(0, 50257, REP_CYCLE),
                       REP_LEN // REP_CYCLE) for _ in range(REP_PROMPTS)]
    want, want_logits = _greedy_slots(torch, model, prompts, REP_NEW, False,
                                      paged=False)
    res = {}
    for gamma in (1, SPEC_TOKENS):
        engine = ServingEngine(model, None, max_slots=8, paged=True,
                               page_size=16, prefill_chunk=64, seed=0,
                               spec_tokens=gamma)
        try:
            engine.generate(rng.integers(0, 50257, 40), 4, timeout=300)
            _reset_serving_counts()
            engine.stats.reset()
            t0 = time.perf_counter()
            handles = [engine.submit(p, REP_NEW) for p in prompts]
            outs = [h.result(timeout=600) for h in handles]
            wall = time.perf_counter() - t0
            stats = engine.stats.snapshot()
            met = engine.metrics()
            counts = _serving_counts()
        finally:
            engine.shutdown()
        name = f"repetitive spec_tokens={gamma}"
        check(all(o.size == REP_LEN + REP_NEW for o in outs),
              f"{name}: a request is short")
        dispatches = stats["prefill_chunks"] + stats["steps"]
        check(counts["paged_attention"] == len(model.gpt.layers)
              * dispatches,
              f"{name}: {counts['paged_attention']} paged launches for "
              f"{dispatches} dispatches")
        got = np.stack([o[REP_LEN:] for o in outs])
        res[f"spec_tokens_{gamma}"] = {
            "tokens_per_s": REP_PROMPTS * REP_NEW / wall, "wall_s": wall,
            "decode_steps": stats["steps"],
            "prefill_chunks": stats["prefill_chunks"],
            "paged_attention_launches": counts["paged_attention"],
            **{k: met[k] for k in SPEC_KEYS if k in met},
            "divergences": _first_divergence(torch, name, got, want,
                                             want_logits, FLOAT_GAP)}
    spec = res[f"spec_tokens_{SPEC_TOKENS}"]
    check(spec["spec_proposed"] == spec["spec_accepted"]
          + spec["spec_rollbacks"] > 0, "repetitive: counters")
    return {"prompts": REP_PROMPTS, "cycle": REP_CYCLE,
            "prompt_tokens": REP_LEN, "new_tokens": REP_NEW,
            "accept_rate": spec["spec_accept_rate"],
            "spec_over_plain_tokens_per_s":
                spec["tokens_per_s"] / res["spec_tokens_1"]["tokens_per_s"],
            **res}


def phase_slice_dense_spec(torch, kernels, dense_line, cpu_ref, dense_toks):
    """``slice_dense`` with speculation: the dense table (no ``paged``),
    ``spec_tokens=SPEC_TOKENS``, the same weights and traffic. Holds: every
    request retires; no paged and no flash launch; the sampler once per
    iteration with a sampled row; counters add up; greedy tokens of
    CMP_IDX against ``slice_dense``'s engine and the CPU run (the near-tie
    rule). Reports tokens/s and TTFT beside ``slice_dense``'s, and a
    ``profile`` line."""
    import numpy as np
    _, engine = _spec_engine()
    check(not engine.paged, "slice_dense_spec is not on the dense table")
    prompts, outs, line, profile = _serve_traffic(
        torch, engine, np.random.default_rng(0))
    checked = _spec_checks(torch, "slice_dense_spec", engine, line, outs,
                           cpu_ref, dense_toks, kernels, None,
                           ("paged_attention", "paged_attention_int8"))
    emit({"phase": "slice_dense_spec", "model": "gpt2_small",
          "layers": len(engine.model.gpt.layers),
          **line, "non_speculative_tokens_per_s": dense_line["tokens_per_s"],
          "non_speculative_ttft_mean_s": dense_line["ttft_mean_s"],
          "non_speculative_decode_steps": dense_line["decode_steps"],
          "greedy_checked": CMP_IDX, "greedy_tokens_compared": N_CMP,
          **checked})
    emit({"phase": "profile", "path": "serving_dense_spec", **profile})


def phase_slice_spec_tp(torch, kernels, f32_line, spec_line, cpu_ref,
                        spec_toks):
    """``slice_spec`` tensor-parallel: ``mesh=TP_MESH`` (tp 2 on the one
    card), float32 pools at ``slice_tp``'s per-chip budget. Holds: every
    request retires; row 6 exactly tp x 12 launches a prefill chunk and
    verify iteration, one sharded call a layer and dispatch; greedy tokens
    of CMP_IDX against ``slice_spec``'s engine and the CPU run (the
    near-tie rule). Reports tokens/s and TTFT beside ``slice_spec``'s."""
    import numpy as np
    _, engine = _spec_engine(paged=True, page_size=16, prefill_chunk=64,
                             mesh=TP_MESH, kv_bytes=f32_line["pool_bytes"])
    n_layers = len(engine.model.gpt.layers)
    prompts, outs, line, profile = _serve_traffic(
        torch, engine, np.random.default_rng(0))
    dispatches = line["prefill_chunks"] + line["decode_steps"]
    check(line["sharded_attention_calls"] == n_layers * dispatches,
          f"slice_spec_tp: {line['sharded_attention_calls']} sharded calls "
          f"for {dispatches} dispatches")
    checked = _spec_checks(torch, "slice_spec_tp", engine, line, outs,
                           cpu_ref, spec_toks, kernels, "paged_attention",
                           ("paged_attention_int8",))
    emit({"phase": "slice_spec_tp", "model": "gpt2_small",
          "layers": n_layers,
          **engine.layout.describe(), **line,
          "unsharded_tokens_per_s": spec_line["tokens_per_s"],
          "unsharded_ttft_mean_s": spec_line["ttft_mean_s"],
          "greedy_checked": CMP_IDX, "greedy_tokens_compared": N_CMP,
          **checked})
    emit({"phase": "profile", "path": "serving_spec_tp", **profile})


def phase_slice_spec_int8(torch, kernels, f32_line, int8_line, int8_ref):
    """``slice_int8`` with speculation: ``int8_weights=True, int8_kv=True``
    at the float slice's pool bytes, ``spec_tokens=SPEC_TOKENS``, the same
    traffic. Holds: every request retires; the int8 paged kernel exactly
    12 times a prefill chunk and verify iteration, the float one never;
    72 int8 products a dispatch. Int8 weights couple a dispatch's rows (a
    verify dispatch has 4 times a decode step's), so the tokens are not
    held: their per-token agreement with ``slice_int8``'s engine over
    CMP_IDX's first N_CMP tokens is reported."""
    import numpy as np
    kv_bytes = f32_line["pool_bytes"]      # slice_int8's budget
    _, engine = _spec_engine(paged=True, page_size=16, prefill_chunk=64,
                             int8_weights=True, int8_kv=True,
                             kv_bytes=kv_bytes)
    n_layers = len(engine.model.gpt.layers)
    prompts, outs, line, profile = _serve_traffic(
        torch, engine, np.random.default_rng(0))
    counts = line["launches"]
    dispatches = line["prefill_chunks"] + line["decode_steps"]
    check(counts["paged_attention_int8"] == n_layers * dispatches,
          f"slice_spec_int8: {counts['paged_attention_int8']} int8 launches "
          f"for {dispatches} dispatches")
    check(counts["paged_attention"] == counts["flash_fwd"] == 0,
          f"slice_spec_int8: {counts}")
    check(counts["int8_matmuls"] == 6 * n_layers * dispatches,
          f"slice_spec_int8: {counts['int8_matmuls']} int8 products for "
          f"{dispatches} dispatches")
    check(line["kv_dtype"] == "int8", f"pool dtype {line['kv_dtype']}")
    kernels["paged_attention_int8"]["launches"] += \
        counts["paged_attention_int8"]
    kernels["paged_attention_int8"].setdefault("launches_by_phase", {})[
        "slice_spec_int8"] = counts["paged_attention_int8"]
    got = _engine_greedy(outs)
    emit({"phase": "slice_spec_int8", "model": "gpt2_small",
          "layers": n_layers,
          "int8_weights": True, "int8_kv": True, "kv_bytes": kv_bytes,
          **line, "non_speculative_tokens_per_s": int8_line["tokens_per_s"],
          "non_speculative_ttft_mean_s": int8_line["ttft_mean_s"],
          "greedy_checked": CMP_IDX, "greedy_tokens_compared": N_CMP,
          "agreement_with_slice_int8": float(np.mean(got == int8_ref[2])),
          "held": False})
    emit({"phase": "profile", "path": "serving_spec_int8", **profile})


TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 5


def _flash_wrappers():
    from bigdl_tpu_torch.ops import flash_attention as fa
    return {"flash_fwd": fa.flash_fwd, "flash_bwd_dq": fa.flash_bwd_dq,
            "flash_bwd_dkv": fa.flash_bwd_dkv}


def _reset_flash_counts():
    for fn in _flash_wrappers().values():
        fn.launches = 0
        if hasattr(fn, "tc_launches"):
            fn.tc_launches = 0


def _flash_counts():
    """Each flash wrapper's launches by path."""
    return {name: _launch_counts(fn)
            for name, fn in _flash_wrappers().items()}


def _grads_vs_cpu(torch, model, params, crit, rng):
    """Loss and gradients of one 1 x 512 batch on the card against the
    port's CPU run (plain versions) on the same weights: (loss relative
    difference, worst per-parameter max|diff| / max|cpu grad|, its name)."""
    from bigdl_tpu_torch.models.gpt import gpt2_small
    from bigdl_tpu_torch.optim import make_loss_and_grads
    ids = torch.from_numpy(rng.integers(0, 50257, (1, 513)))
    x, y = ids[:, :-1].contiguous(), ids[:, 1:].reshape(-1)
    model.load_state_dict(params)
    loss_g, grads_g = make_loss_and_grads(model, crit)(x.cuda(), y.cuda())
    cpu = gpt2_small(device="cpu")
    cpu.load_state_dict(params)
    loss_c, grads_c = make_loss_and_grads(cpu, crit)(x, y)
    rel_loss = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    worst, worst_name = 0.0, None
    for name, gc in grads_c.items():
        diff = float((grads_g[name].cpu() - gc).abs().max())
        ratio = diff / max(float(gc.abs().max()), 1e-30)
        if ratio > worst:
            worst, worst_name = ratio, name
    return rel_loss, worst, worst_name


def phase_train(torch, kernels, smi):
    import numpy as np
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.models.gpt import gpt2_small, gpt_flops_per_token
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import Adam, make_train_step

    t0 = time.perf_counter()
    model = gpt2_small()
    params = convert.init_params(model, seed=0)
    model.load_state_dict(params)
    n_layers = len(model.gpt.layers)
    crit = CrossEntropyCriterion()
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, 50257, (TRAIN_BATCH,
                                                   TRAIN_SEQ + 1))).cuda()
    x, y = ids[:, :-1].contiguous(), ids[:, 1:].reshape(-1)
    opt = Adam(learningrate=3e-4)
    opt_state = opt.init_state(dict(model.named_parameters()))
    step = make_train_step(model, crit, opt)
    setup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step(opt_state, x, y)]                 # warm-up
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    # the counts start at 0 just before the timed steps
    _reset_flash_counts()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        losses.append(step(opt_state, x, y))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _flash_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    check(all(np.isfinite(losses)), f"non-finite training loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for name, n in launches.items():
        check(n == {"cuda_cores": n_layers * TRAIN_STEPS, "tensor_cores": 0},
              f"{name} launched {n} times in {TRAIN_STEPS} float32 steps "
              f"of {n_layers} layers")
        kernels[name]["float32"]["launches"] = n["cuda_cores"]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = wall / TRAIN_STEPS
    flops = 3 * gpt_flops_per_token(s=TRAIN_SEQ) * tokens

    rel_loss, worst, worst_name = _grads_vs_cpu(torch, model, params, crit,
                                                rng)
    check(rel_loss <= 1e-4, f"card vs CPU loss differs by {rel_loss}")
    check(worst <= 1e-3, f"card vs CPU gradient of {worst_name} differs by "
                         f"{worst} of its largest magnitude")
    emit({"phase": "train", "model": "gpt2_small", "layers": n_layers,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "dtype": "float32",
          "optimizer": "Adam(3e-4)", "losses": losses,
          "timed_steps": TRAIN_STEPS, "step_s": step_s,
          "tokens_per_s": tokens / step_s, "warmup_s": warmup_s,
          "setup_s": setup_s, "peak_memory_bytes": peak,
          "model_flops_per_step": flops,
          "mfu_vs_fp32_peak": flops / step_s / PEAK_FLOPS_PER_S["float32"],
          "flash_launches": launches, "cpu_loss_rel_diff": rel_loss,
          "cpu_grad_worst_rel": worst, "cpu_grad_worst_param": worst_name,
          "card": smi})

    # where the time goes: 2 more float32 steps under torch.profiler
    model.load_state_dict(params)
    opt_state = opt.init_state(dict(model.named_parameters()))
    profile = _profile(torch, lambda: [step(opt_state, x, y)
                                       for _ in range(2)])
    emit({"phase": "profile", "path": "train", "steps": 2, **profile})
    return losses[0]


# families of device kernels in the train_bf16 profile, by substrings of
# their names
GPT_BF16_KERNEL_GROUPS = {
    "flash tensor-core kernels": ("flash_fwd_tc_kernel",
                                  "flash_bwd_dq_tc_kernel",
                                  "flash_bwd_dkv_tc_kernel"),
    "flash tensor-core dQ": ("flash_bwd_dq_tc_kernel",),
    "flash CUDA-core kernels": ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                                "flash_bwd_dkv_kernel"),
    "GEMMs": ("gemm", "nvjet", "xmma", "cutlass"),
    "elementwise": ("elementwise_kernel",),
    "reductions": ("reduce_kernel",)}
FLASH_AUTOGRAD_SHAPE = (1, 12, 512, 64)     # GPT-2 small, batch 1 x 512
FLASH_BF16_REL = 2e-2                       # x max|CPU float32|


def _flash_autograd_bf16(torch, rng):
    """``ops.flash_attention.flash_attention``, the autograd function the
    model calls, in bfloat16 on the card at FLASH_AUTOGRAD_SHAPE, causal:
    the output and dQ, dK, dV against float32 autograd of the plain
    attention (softmax of the masked scaled scores, times v) on the CPU
    over the same bfloat16 values. Returns the worst max|diff| / max|CPU|
    of each."""
    from bigdl_tpu_torch.ops.flash_attention import flash_attention
    q, k, v, do = [torch.from_numpy(rng.standard_normal(
        FLASH_AUTOGRAD_SHAPE, dtype="float32")).to(torch.bfloat16)
        for _ in range(4)]
    s = FLASH_AUTOGRAD_SHAPE[2]
    qc, kc, vc = [t.float().requires_grad_() for t in (q, k, v)]
    sc = (qc @ kc.transpose(-1, -2)) * FLASH_AUTOGRAD_SHAPE[3] ** -0.5
    sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(),
                        float("-inf"))
    oc = torch.softmax(sc, dim=-1) @ vc
    oc.backward(do.float())
    qg, kg, vg = [t.cuda().requires_grad_() for t in (q, k, v)]
    og = flash_attention(qg, kg, vg, causal=True)
    og.backward(do.cuda())
    rel = {}
    for key, got, want in (("o", og, oc), ("dq", qg.grad, qc.grad),
                           ("dk", kg.grad, kc.grad),
                           ("dv", vg.grad, vc.grad)):
        want = want.detach()
        rel[key] = float((got.detach().float().cpu() - want).abs().max()
                         / want.abs().max())
    return rel


def phase_train_bf16(torch, kernels, smi, loss32):
    """GPT-2 small trained with bfloat16 compute: ``train``'s model,
    weights, batch and optimizer through ``make_train_step(...,
    compute_dtype=torch.bfloat16)``; ``loss32`` is ``train``'s float32
    first loss on the same batch and weights."""
    import numpy as np
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.models.gpt import gpt2_small, gpt_flops_per_token
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.optim import Adam, make_train_step

    t0 = time.perf_counter()
    model = gpt2_small()
    params = convert.init_params(model, seed=0)
    model.load_state_dict(params)
    n_layers = len(model.gpt.layers)
    crit = CrossEntropyCriterion()
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, 50257, (TRAIN_BATCH,
                                                   TRAIN_SEQ + 1))).cuda()
    x, y = ids[:, :-1].contiguous(), ids[:, 1:].reshape(-1)
    opt = Adam(learningrate=3e-4)
    opt_state = opt.init_state(dict(model.named_parameters()))
    step = make_train_step(model, crit, opt, compute_dtype=torch.bfloat16)
    setup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step(opt_state, x, y)]                 # warm-up
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    # the counts start at 0 just before the timed steps
    _reset_flash_counts()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        losses.append(step(opt_state, x, y))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _flash_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    check(all(np.isfinite(losses)), f"non-finite training loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    rel32 = abs(losses[0] - loss32) / loss32
    check(rel32 <= 0.02, f"bfloat16 first loss {losses[0]} vs float32 "
                         f"{loss32}")
    head_dim = model.gpt.layers[0].attn.head_dim
    for name, n in launches.items():
        path = fa.path(name, torch.bfloat16, head_dim)
        want = {p: n_layers * TRAIN_STEPS * (p == path) for p in n}
        check(n == want, f"{name} launched {n} times in {TRAIN_STEPS} "
                         f"bfloat16 steps of {n_layers} layers; expected "
                         f"{want}")
        kernels[name]["launches"] = n[path]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = wall / TRAIN_STEPS
    flops = 3 * gpt_flops_per_token(s=TRAIN_SEQ) * tokens

    ad = _flash_autograd_bf16(torch, rng)
    print(f"train_bf16 flash bfloat16 autograd vs CPU: {json.dumps(ad)}",
          flush=True)
    check(max(ad.values()) <= FLASH_BF16_REL,
          f"flash bfloat16 autograd vs CPU: {ad}")
    emit({"phase": "train_bf16", "model": "gpt2_small", "layers": n_layers,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "compute_dtype": "bfloat16", "optimizer": "Adam(3e-4)",
          "losses": losses, "float32_first_loss": loss32,
          "first_loss_rel_diff": rel32, "timed_steps": TRAIN_STEPS,
          "step_s": step_s, "tokens_per_s": tokens / step_s,
          "warmup_s": warmup_s, "setup_s": setup_s,
          "peak_memory_bytes": peak, "model_flops_per_step": flops,
          "mfu_vs_bf16_peak": flops / step_s / PEAK_FLOPS_PER_S["bfloat16"],
          "flash_launches": launches, "flash_bf16_autograd_rel": ad,
          "card": smi})

    # where the time goes: 2 more bfloat16 steps under torch.profiler
    model.load_state_dict(params)
    opt_state = opt.init_state(dict(model.named_parameters()))
    profile = _profile(torch, lambda: [step(opt_state, x, y)
                                       for _ in range(2)],
                       groups=GPT_BF16_KERNEL_GROUPS)
    emit({"phase": "profile", "path": "train_bf16", "steps": 2, **profile})


RESNET_BATCH, RESNET_HW, RESNET_STEPS = 256, 224, 5
# families of device kernels in the train_resnet profile, by name
RESNET_KERNEL_GROUPS = {"conv3x3 tensor-core kernels": "conv3x3_tc_kernel",
                        "cuDNN xmma kernels": "xmma",
                        "reductions": "reduce_kernel",
                        "elementwise": "elementwise_kernel"}
RESNET_CHECK_BATCH = 4
# bfloat16-compute loss at the check batch against the float32 CPU loss,
# relative
RESNET_BF16_LOSS_REL = 2e-2
# ResNet-50's 3x3 stride-1 convolutions as (H = W, Cin = Cout), and the bar
# of conv3x3's bfloat16 autograd check at the check batch: output, input
# and weight gradients within this share of the float32 CPU's largest
# magnitude (the kernels phase's bfloat16 bar)
RESNET_CONV3X3 = ((56, 64), (28, 128), (14, 256), (7, 512))
CONV_BF16_REL = 2e-2


def _conv_counts():
    """Launches of each conv kernel's tensor-core path (``k9``, ``i2c``)
    and CUDA-core path (``k9_cuda_core``, ``i2c_cuda_core``), and the
    library convolutions by kind."""
    from bigdl_tpu_torch.nn import SpatialConvolution
    from bigdl_tpu_torch.ops import conv3x3 as cv
    counts = {}
    for kind, fn in cv.KERNELS.items():
        counts[kind] = fn.tc_launches
        counts[f"{kind}_cuda_core"] = fn.launches
    counts["library"] = dict(SpatialConvolution.library_calls)
    return counts


def _reset_conv_counts():
    from bigdl_tpu_torch.nn import SpatialConvolution
    from bigdl_tpu_torch.ops import conv3x3 as cv
    for fn in cv.KERNELS.values():
        fn.launches = fn.tc_launches = 0
    SpatialConvolution.library_calls.clear()


# card-vs-CPU gradient bar of train_resnet: a gradient may differ from the
# CPU's by 1e-3 of its largest magnitude or by RESNET_NOISE_FACTOR times
# its float32 noise floor, whichever is larger. The noise floor is how far
# the CPU's own gradient moves when the images move by 2^-23 relative (the
# larger of two such draws). At this model's initial weights and a batch
# of 4 the training-mode BN layers make most gradients ill-conditioned:
# such a change moves the median parameter's gradient by 2.2 % of its
# largest magnitude and res5_0_proj.weight's by 32 % (PERF.md, PR 4), so a
# fixed 1e-3 bar cannot hold whatever the kernels do.
RESNET_NOISE_FACTOR = 10


def _perturbed(torch, x, seed):
    g = torch.Generator().manual_seed(seed)
    return x * (1 + (torch.rand(x.shape, generator=g) - 0.5) * 2.0 ** -22)


def _resnet_vs_cpu(torch, model, params, rng):
    """One float32 training forward and backward of a RESNET_CHECK_BATCH
    batch on the card against the port's CPU run (plain versions) on the
    same weights; returns the comparison's record (see
    RESNET_NOISE_FACTOR for the gradient bar)."""
    from bigdl_tpu_torch.models import ResNet
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import make_loss_and_grads
    crit = ClassNLLCriterion()
    x = torch.from_numpy(rng.standard_normal(
        (RESNET_CHECK_BATCH, RESNET_HW, RESNET_HW, 3), dtype="float32"))
    y = torch.from_numpy(rng.integers(0, 1000, RESNET_CHECK_BATCH))
    model.load_state_dict(params)
    _reset_conv_counts()
    loss_g, grads_g = make_loss_and_grads(model, crit)(x.cuda(), y.cuda())
    launches = _conv_counts()
    card_bufs = {k: b.cpu() for k, b in model.named_buffers()}
    # the same batch in bfloat16 compute, on the tensor-core path
    model.load_state_dict(params)
    _reset_conv_counts()
    loss16, grads16 = make_loss_and_grads(
        model, crit, compute_dtype=torch.bfloat16)(x.cuda(), y.cuda())
    launches16 = _conv_counts()
    cpu = ResNet(class_num=1000, depth=50, format="NHWC", device="cpu")

    def cpu_run(images):
        cpu.load_state_dict(params)
        loss, grads = make_loss_and_grads(cpu, crit)(images, y)
        return float(loss), {k: g.clone() for k, g in grads.items()}

    loss_c, grads_c = cpu_run(x)
    cpu_bufs = {k: b.clone() for k, b in cpu.named_buffers()}
    noise = {k: 0.0 for k in grads_c}
    for seed in (0, 1):
        _, moved = cpu_run(_perturbed(torch, x, seed))
        for k, g in moved.items():
            noise[k] = max(noise[k], float((g - grads_c[k]).abs().max()))
    rec = {"cpu_loss_rel_diff": abs(float(loss_g) - loss_c) / abs(loss_c),
           "cpu_grad_worst_rel": 0.0, "cpu_grad_worst_param": None,
           "cpu_grad_worst_vs_bar": 0.0, "cpu_grad_bar_param": None,
           "cpu_grad_params_on_noise_floor": 0,
           "cpu_grad_noise_median_rel": None, "cpu_bn_worst_abs": 0.0,
           "cpu_bn_worst_buffer": None, "cpu_check_launches": launches,
           "bf16_loss_rel_diff": abs(float(loss16) - loss_c) / abs(loss_c),
           "bf16_check_launches": launches16}
    # read, not checked: a 2^-23 change of the images already moves most
    # float32 gradients by percents here, so bfloat16's rounding leaves no
    # bar a whole-model gradient could be held to (conv3x3's own autograd
    # check holds the bfloat16 gradients)
    conv_rel = sorted(
        float((grads16[k].float().cpu() - g).abs().max())
        / max(float(g.abs().max()), 1e-30)
        for k, g in grads_c.items() if g.dim() == 4 and g.shape[2:] == (3, 3))
    rec["bf16_conv3x3_grad_rel_median"] = conv_rel[len(conv_rel) // 2]
    rec["bf16_conv3x3_grad_rel_worst"] = conv_rel[-1]
    noise_rel = []
    for name, gc in grads_c.items():
        top = max(float(gc.abs().max()), 1e-30)
        diff = float((grads_g[name].float().cpu() - gc).abs().max())
        noise_rel.append(noise[name] / top)
        bar = max(1e-3 * top, RESNET_NOISE_FACTOR * noise[name])
        rec["cpu_grad_params_on_noise_floor"] += bar > 1e-3 * top
        if diff / top > rec["cpu_grad_worst_rel"]:
            rec["cpu_grad_worst_rel"] = diff / top
            rec["cpu_grad_worst_param"] = name
        if diff / bar > rec["cpu_grad_worst_vs_bar"]:
            rec["cpu_grad_worst_vs_bar"] = diff / bar
            rec["cpu_grad_bar_param"] = name
    rec["cpu_grad_noise_median_rel"] = sorted(noise_rel)[len(noise_rel) // 2]
    for name, b in cpu_bufs.items():
        diff = float((card_bufs[name] - b).abs().max())
        if diff > rec["cpu_bn_worst_abs"]:
            rec["cpu_bn_worst_abs"], rec["cpu_bn_worst_buffer"] = diff, name
    return rec


def _conv3x3_autograd(torch, rng, dtype, batch):
    """``ops.conv3x3.conv3x3``, the autograd function the model calls,
    in ``dtype`` on the card at ``batch`` and ResNet-50's four 3x3
    shapes: output, input gradient (the flip launch) and weight gradient
    against float32 autograd of ``F.conv2d`` on the CPU over the same
    ``dtype`` values. Returns the worst max|diff| / max|CPU| of each, and
    the conv counts of these calls."""
    import torch.nn.functional as F
    from bigdl_tpu_torch.ops.conv3x3 import conv3x3

    def draw(shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype="float32")
                                * scale).to(dtype)

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False     # the weight gradient's
    _reset_conv_counts()
    worst = {"y": 0.0, "dx": 0.0, "dw": 0.0}
    for hw, c in RESNET_CONV3X3:
        x = draw((batch, hw, hw, c))
        w = draw((c, c, 3, 3), (2.0 / (9 * c)) ** 0.5).contiguous(
            memory_format=torch.channels_last)
        dy = draw((batch, hw, hw, c))
        xc = x.float().permute(0, 3, 1, 2).requires_grad_()
        wc = w.float().requires_grad_()
        yc = F.conv2d(xc, wc, padding=1)
        yc.backward(dy.float().permute(0, 3, 1, 2))
        # leaves of their own: in float32, x.float() and w.float() are x
        # and w, and w now requires grad
        xg = x.detach().cuda().requires_grad_()
        wg = w.detach().cuda().requires_grad_()
        yg = conv3x3(xg, wg)
        yg.backward(dy.cuda())
        for key, got, want in (("y", yg, yc.permute(0, 2, 3, 1)),
                               ("dx", xg.grad, xc.grad.permute(0, 2, 3, 1)),
                               ("dw", wg.grad, wc.grad)):
            want, got = want.detach(), got.detach().float().cpu()
            rel = float((got - want).abs().max() / want.abs().max())
            if not torch.isfinite(got).all():
                rel = float("inf")      # max() would pass over a NaN
            worst[key] = max(worst[key], rel)
    torch.backends.cudnn.allow_tf32 = tf32
    return worst, _conv_counts()


def _check_conv3x3_autograd(torch, rng, dtype, batch, tol):
    """:func:`_conv3x3_autograd`, held to ``tol`` x max|CPU|, with one
    forward and one flip launch a shape on the path ``dtype`` takes (the
    tensor cores for bfloat16, the CUDA cores for float32); returns the
    worst errors."""
    from bigdl_tpu_torch.ops.conv3x3 import kernel_for
    name = str(dtype).replace("torch.", "")
    worst, counts = _conv3x3_autograd(torch, rng, dtype, batch)
    print(f"conv3x3 {name} autograd vs CPU at batch {batch}: "
          f"{json.dumps(worst)}", flush=True)
    check(max(worst.values()) <= tol,
          f"conv3x3 {name} autograd vs CPU at batch {batch}: {worst} over "
          f"{tol}")
    want = {"k9": 0, "i2c": 0}
    for _, c in RESNET_CONV3X3:
        want[kernel_for(c)] += 2        # forward and flip
    tc = dtype == torch.bfloat16
    on, off = ("", "_cuda_core") if tc else ("_cuda_core", "")
    got = {k: counts[k + on] for k in want}
    check(got == want and not any(counts[k + off] for k in want),
          f"conv3x3 {name} autograd ran {counts}; the "
          f"{'tensor' if tc else 'CUDA'} cores should have run {want}")
    return worst


def phase_train_resnet(torch, kernels, smi):
    import numpy as np
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.models import ResNet, conv_routes, resnet_flops
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"train_resnet: cudnn.allow_tf32 "
          f"{torch.backends.cudnn.allow_tf32}, cuda.matmul.allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)
    t0 = time.perf_counter()
    model = ResNet(class_num=1000, depth=50, format="NHWC")
    params = convert.init_resnet_params(model, seed=0)
    model.load_state_dict(params)
    routes = conv_routes(model, (RESNET_HW, RESNET_HW))
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(
        (RESNET_BATCH, RESNET_HW, RESNET_HW, 3), dtype="float32")).cuda()
    y = torch.from_numpy(rng.integers(0, 1000, RESNET_BATCH)).cuda()
    crit = ClassNLLCriterion()
    opt = SGD(learningrate=0.01, momentum=0.9)
    opt_state = opt.init_state(dict(model.named_parameters()))
    step = make_train_step(model, crit, opt, compute_dtype=torch.bfloat16)
    setup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step(opt_state, x, y)]                 # warm-up
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    # the counts start at 0 just before the timed steps
    _reset_conv_counts()
    t0 = time.perf_counter()
    for _ in range(RESNET_STEPS):
        losses.append(step(opt_state, x, y))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _conv_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    check(all(np.isfinite(losses)), f"non-finite training loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for kind in ("k9", "i2c"):
        want = routes[kind] * RESNET_STEPS
        check(counts[kind] == want,
              f"conv3x3_{kind} ran {counts[kind]} tensor-core launches in "
              f"{RESNET_STEPS} bfloat16 steps; the layers give {want}")
        check(counts[f"{kind}_cuda_core"] == 0,
              f"conv3x3_{kind} ran {counts[f'{kind}_cuda_core']} CUDA-core "
              f"launches in the bfloat16 steps")
        kernels[f"conv3x3_{kind}"]["launches"] = counts[kind]
    check("3x3/s1" not in counts["library"],
          f"a 3x3 stride-1 convolution reached F.conv2d: {counts['library']}")
    lib = sum(counts["library"].values())
    check(lib == routes["library"] * RESNET_STEPS,
          f"F.conv2d ran {lib} times in {RESNET_STEPS} steps; the layers "
          f"give {routes['library'] * RESNET_STEPS}")
    step_s = wall / RESNET_STEPS
    flops = 3 * resnet_flops(model, (RESNET_HW, RESNET_HW)) * RESNET_BATCH

    cmp = _resnet_vs_cpu(torch, model, params, rng)
    print(f"train_resnet card vs CPU: {json.dumps(cmp)}", flush=True)
    check(cmp["cpu_loss_rel_diff"] <= 1e-4,
          f"card vs CPU loss differs by {cmp['cpu_loss_rel_diff']}")
    check(cmp["cpu_grad_worst_vs_bar"] <= 1.0,
          f"card vs CPU gradient of {cmp['cpu_grad_bar_param']} is "
          f"{cmp['cpu_grad_worst_vs_bar']} times its bar")
    check(cmp["cpu_bn_worst_abs"] <= 1e-4,
          f"card vs CPU BN statistic {cmp['cpu_bn_worst_buffer']} differs "
          f"by {cmp['cpu_bn_worst_abs']}")
    f32 = cmp["cpu_check_launches"]
    b16 = cmp["bf16_check_launches"]
    for kind in ("k9", "i2c"):
        # float32 stays on the CUDA-core path, one forward and (but for
        # the stem's input) one input gradient per convolution; bfloat16
        # takes the tensor cores
        check(f32[kind] == 0 and f32[f"{kind}_cuda_core"] == routes[kind],
              f"float32 check: conv3x3_{kind} ran {f32[kind]} tensor-core "
              f"and {f32[f'{kind}_cuda_core']} CUDA-core launches; the "
              f"layers give 0 and {routes[kind]}")
        check(b16[kind] == routes[kind] and b16[f"{kind}_cuda_core"] == 0,
              f"bfloat16 check: conv3x3_{kind} ran {b16[kind]} tensor-core "
              f"and {b16[f'{kind}_cuda_core']} CUDA-core launches; the "
              f"layers give {routes[kind]} and 0")
    check(cmp["bf16_loss_rel_diff"] <= RESNET_BF16_LOSS_REL,
          f"bfloat16 check loss differs from the float32 CPU loss by "
          f"{cmp['bf16_loss_rel_diff']}")
    conv_ad = _check_conv3x3_autograd(torch, rng, torch.bfloat16,
                                      RESNET_CHECK_BATCH, CONV_BF16_REL)
    emit({"phase": "train_resnet", "model": "resnet50", "format": "NHWC",
          "batch": RESNET_BATCH, "image": RESNET_HW,
          "compute_dtype": "bfloat16",
          "optimizer": "SGD(0.01, momentum 0.9)", "losses": losses,
          "timed_steps": RESNET_STEPS, "step_s": step_s,
          "images_per_s": RESNET_BATCH / step_s, "warmup_s": warmup_s,
          "setup_s": setup_s, "peak_memory_bytes": peak,
          "model_flops_per_step": flops,
          "mfu_vs_bf16_peak": flops / step_s / PEAK_FLOPS_PER_S["bfloat16"],
          "conv_routes_per_step": routes, "launches": counts,
          "cpu_check_batch": RESNET_CHECK_BATCH,
          "cpu_grad_noise_factor": RESNET_NOISE_FACTOR, **cmp,
          "conv3x3_bf16_autograd_rel": conv_ad,
          "card": smi})

    # where the time goes: 2 more bfloat16 steps under torch.profiler
    model.load_state_dict(params)
    opt_state = opt.init_state(dict(model.named_parameters()))
    profile = _profile(torch, lambda: [step(opt_state, x, y)
                                       for _ in range(2)],
                       groups=RESNET_KERNEL_GROUPS)
    emit({"phase": "profile", "path": "train_resnet", "steps": 2, **profile})


# ------------------------------------------------- train_optimizer (facade)
# LeNet-5 in the configuration of the reference's accuracy test
# (tests/test_lenet_mnist.py:170-186): 1024 synthetic training digits in
# batches of 128 (8 steps an epoch), 512 validation digits, Adam 2e-3, 6
# epochs; the test's bar on the validation top-1
LENET_TRAIN, LENET_VAL, LENET_BATCH, LENET_EPOCHS = 1024, 512, 128, 6
LENET_TOP1_BAR = 0.9
# card vs the port's CPU run, per iteration of the first epoch, relative:
# float32 cuDNN against CPU convolutions, carried through 8 Adam steps
LENET_CPU_LOSS_REL = 1e-4
# ResNet-50 through the facade: float32 (the reference's facade trains in
# float32), 128 seeded records, batches of 32, 4 iterations
FACADE_RESNET_RECORDS, FACADE_RESNET_BATCH, FACADE_RESNET_STEPS = 128, 32, 4
# the facade's first loss against make_train_step's on the same weights
# and batch, relative: the same kernels on the same inputs
FACADE_FIRST_LOSS_REL = 1e-6
# the epoch shuffle's seeds: the reference's shuffle is unseeded, and the
# card-vs-CPU and K=1-vs-K=2 comparisons need one order
SHUFFLE_SEEDS = tuple(range(100, 120))


class _Scalars:
    """An ``add_scalar`` summary: every (tag, value) in order."""

    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value)))

    @property
    def losses(self):
        return [v for tag, v in self.scalars if tag == "Loss"]


def _pin_shuffle(ds):
    """``ds`` (a LocalDataSet) with its epoch shuffles seeded from
    SHUFFLE_SEEDS in turn."""
    from bigdl_tpu_torch.dataset.dataset import LocalDataSet
    seeds = iter(SHUFFLE_SEEDS)

    class Pinned(LocalDataSet):
        def shuffle(self, seed=None):
            return LocalDataSet.shuffle(self, next(seeds))

    ds.__class__ = Pinned
    return ds


def _lenet_run(torch, device, w0, epochs, method, steps_per_loop=1,
               val=None, ckpt=None, regularize=True):
    """LeNet-5 from weights ``w0`` through ``Optimizer(...).optimize()``
    on ``device``; returns (model, optimizer, per-iteration losses,
    wall seconds)."""
    from bigdl_tpu_torch.dataset.mnist import mnist_dataset
    from bigdl_tpu_torch.models import LeNet5
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import (L2Regularizer, Loss, Optimizer,
                                       Top1Accuracy, Trigger)
    model = LeNet5(10, device=device)
    model.load_state_dict(w0)
    if regularize:
        model[1].w_regularizer = L2Regularizer(1e-4)     # conv1_5x5
    train = _pin_shuffle(mnist_dataset(training=True, batch_size=LENET_BATCH,
                                       synthetic_size=LENET_TRAIN))
    opt = Optimizer(model=model, dataset=train,
                    criterion=ClassNLLCriterion(),
                    steps_per_loop=steps_per_loop)
    opt.set_optim_method(method)
    opt.set_end_when(Trigger.max_epoch(epochs))
    if val is not None:
        opt.set_validation(Trigger.every_epoch(), val,
                           [Top1Accuracy(), Loss()])
    if ckpt is not None:
        opt.set_checkpoint(ckpt, Trigger.every_epoch())
    log = _Scalars()
    opt.set_train_summary(log)
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.optimize()
    if device != "cpu":
        torch.cuda.synchronize()
    return model, opt, log.losses, time.perf_counter() - t0


def _facade_lenet(torch, smi):
    import os
    import tempfile

    import numpy as np
    from bigdl_tpu_torch.dataset.mnist import mnist_dataset
    from bigdl_tpu_torch.dataset.transformer import DeviceFeed
    from bigdl_tpu_torch.models import LeNet5
    from bigdl_tpu_torch.optim import SGD, Adam, Evaluator, OptimMethod
    from bigdl_tpu_torch.optim import Top1Accuracy
    from bigdl_tpu_torch.utils.serializer import load_module

    w0 = LeNet5(10, device="cpu", seed=1).state_dict()
    val = mnist_dataset(training=False, batch_size=LENET_BATCH,
                        synthetic_size=LENET_VAL)
    per_epoch = LENET_TRAIN // LENET_BATCH
    rec = {"model": "lenet5", "train_records": LENET_TRAIN,
           "val_records": LENET_VAL, "batch": LENET_BATCH,
           "epochs": LENET_EPOCHS, "optimizer": "Adam(2e-3)",
           "regularizer": "L2Regularizer(1e-4) on conv1_5x5"}
    with tempfile.TemporaryDirectory() as ckpt:
        copies0 = DeviceFeed.copies
        model, opt, losses, wall = _lenet_run(
            torch, "cuda", w0, LENET_EPOCHS, Adam(learningrate=2e-3),
            val=val, ckpt=ckpt)
        copies = DeviceFeed.copies - copies0
        check(len(losses) == LENET_EPOCHS * per_epoch,
              f"{len(losses)} losses for {LENET_EPOCHS} epochs")
        check(all(np.isfinite(losses)), f"non-finite LeNet loss: {losses}")
        check(losses[-1] < losses[0], f"LeNet loss did not fall: {losses}")
        top1, n = Evaluator(model).evaluate(
            val, [Top1Accuracy()])["Top1Accuracy"].result()
        check(n == LENET_VAL and top1 > LENET_TOP1_BAR,
              f"LeNet validation top-1 {top1} over {n} digits")
        check(copies == 2 * len(losses),
              f"DeviceFeed issued {copies} copies for {len(losses)} steps")
        last = LENET_EPOCHS * per_epoch + 1
        names = sorted(os.listdir(ckpt))
        check(f"model.{last}" in names and f"optimMethod.{last}" in names,
              f"checkpoint files {names}")
        fresh = LeNet5(10, device="cuda", seed=7)
        fresh.load_state_dict(load_module(
            os.path.join(ckpt, f"model.{last}")).state_dict())
        same = all(torch.equal(a, b) for a, b in
                   zip(model.state_dict().values(),
                       fresh.state_dict().values()))
        check(same, "model checkpoint does not reload bit for bit")
        method, state = OptimMethod.load(os.path.join(ckpt,
                                                      f"optimMethod.{last}"))
        check(type(method) is Adam and int(state["step"]) == len(losses)
              and int(state["epoch"]) == LENET_EPOCHS,
              f"optimMethod checkpoint: {type(method).__name__}, step "
              f"{int(state['step'])}, epoch {int(state['epoch'])}")
        rec.update(checkpoints=len(names), checkpoint_reload_bitwise=same)
    summary = opt.metrics_summary()
    rec.update(losses=losses, top1=top1, metrics_summary=summary,
               step_s=summary["step_time_avg_s"] + summary["data_time_avg_s"],
               records_per_s=summary["throughput_rec_s"], wall_s=wall,
               device_feed_copies=copies)

    # the first epoch on the CPU, from the same weights and shuffle
    _, _, cpu_losses, _ = _lenet_run(torch, "cpu", w0, 1,
                                     Adam(learningrate=2e-3))
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
    print(f"train_optimizer LeNet card vs CPU, first epoch: card "
          f"{losses[:per_epoch]}, CPU {cpu_losses}", flush=True)
    check(len(cpu_losses) == per_epoch and rel <= LENET_CPU_LOSS_REL,
          f"LeNet first-epoch losses differ from the CPU's by {rel}")
    rec["cpu_loss_rel_diff"] = rel

    # the reference example's setters (examples/lenet_mnist.py:39-53)
    _, ex, ex_losses, _ = _lenet_run(torch, "cuda", w0, 1,
                                     SGD(learningrate=0.05), val=val,
                                     regularize=False)
    check(all(np.isfinite(ex_losses)) and ex_losses[-1] < ex_losses[0],
          f"example setters' losses: {ex_losses}")
    rec["example_sgd_losses"] = ex_losses

    # steps_per_loop 2 against 1 on the card, run 1, 2, 2, 1: losses,
    # dispatches and records/s of each run
    k_runs = {1: [], 2: []}
    for k in (1, 2, 2, 1):
        copies0 = DeviceFeed.copies
        _, o, ls, w = _lenet_run(torch, "cuda", w0, 2,
                                 Adam(learningrate=2e-3), steps_per_loop=k)
        k_runs[k].append((ls, dict(o.metrics), DeviceFeed.copies - copies0,
                          o.metrics_summary()["throughput_rec_s"]))
    (l1, m1, c1, _), (l2, m2, c2, _) = k_runs[1][0], k_runs[2][0]
    rel_k = max(abs(a - b) / abs(b) for a, b in zip(l2, l1))
    check(len(l1) == len(l2) == 2 * per_epoch and rel_k <= LENET_CPU_LOSS_REL,
          f"steps_per_loop=2 losses differ from steps_per_loop=1 by {rel_k}")
    check(m2["dispatches"] * 2 == m2["steps"] == m1["dispatches"],
          f"steps_per_loop=2 dispatches {m2['dispatches']} for "
          f"{m2['steps']} steps")
    check(c1 > 0 and c2 > 0, f"DeviceFeed copies {c1}, {c2}")
    rec.update(steps_per_loop_rel_diff=rel_k,
               steps_per_loop_dispatches={"1": m1["dispatches"],
                                          "2": m2["dispatches"]},
               steps_per_loop_records_per_s={
                   str(k): [r[3] for r in runs]
                   for k, runs in k_runs.items()})
    emit({"phase": "train_optimizer", "part": "lenet", **rec, "card": smi})
    profile = _profile(torch, lambda: _lenet_run(
        torch, "cuda", w0, 1, Adam(learningrate=2e-3), val=val))
    emit({"phase": "profile", "path": "train_optimizer_lenet", "epochs": 1,
          **profile})


def _conv_forward_counts(model, hw):
    """Launches of each conv kernel in one forward pass (no gradient)."""
    from bigdl_tpu_torch.nn import SpatialConvolution
    from bigdl_tpu_torch.ops.conv3x3 import kernel_for
    out = {"k9": 0, "i2c": 0}
    for _, m, (h, w) in model.layer_walk(hw):
        if isinstance(m, SpatialConvolution) and m.uses_kernel(h, w):
            out[kernel_for(m.n_input_plane)] += 1
    return out


def _facade_resnet(torch, kernels, smi):
    import numpy as np
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
    from bigdl_tpu_torch.models import ResNet, conv_routes, resnet_flops
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import (SGD, MultiStep, Optimizer,
                                       Top1Accuracy, Trigger,
                                       make_train_step)

    n, b, hw = FACADE_RESNET_RECORDS, FACADE_RESNET_BATCH, RESNET_HW
    rng = np.random.default_rng(2)
    images = rng.standard_normal((n, hw, hw, 3), dtype=np.float32)
    labels = rng.integers(0, 1000, n).astype(np.int32)
    val_images = rng.standard_normal((b, hw, hw, 3), dtype=np.float32)
    val_labels = rng.integers(0, 1000, b).astype(np.int32)

    def method():
        return SGD(learningrate=0.01, momentum=0.9,
                   learningrate_schedule=MultiStep([2, 3], 0.1))

    model = ResNet(class_num=1000, depth=50, format="NHWC")
    params = convert.init_resnet_params(model, seed=0)
    routes = conv_routes(model, (hw, hw))
    fwd = _conv_forward_counts(model, (hw, hw))
    # make_train_step's first loss on the first batch the pinned shuffle
    # gives, from the same weights
    order = np.arange(n)
    np.random.default_rng(SHUFFLE_SEEDS[0]).shuffle(order)
    first = order[:b]
    model.load_state_dict(params)
    opt_m = method()
    step = make_train_step(model, ClassNLLCriterion(), opt_m)
    want = float(step(opt_m.init_state(dict(model.named_parameters())),
                      torch.from_numpy(images[first]).cuda(),
                      torch.from_numpy(labels[first]).cuda()))

    model.load_state_dict(params)
    train = _pin_shuffle(DataSet.array(
        [Sample(images[i], labels[i]) for i in range(n)])
        >> SampleToMiniBatch(b))
    val = DataSet.array([Sample(val_images[i], val_labels[i])
                         for i in range(b)]) >> SampleToMiniBatch(b)
    opt = Optimizer(model=model, dataset=train,
                    criterion=ClassNLLCriterion())
    opt.set_optim_method(method())
    opt.set_end_when(Trigger.max_iteration(FACADE_RESNET_STEPS))
    opt.set_validation(Trigger.every_epoch(), val, [Top1Accuracy()])
    vlog, log = _Scalars(), _Scalars()
    opt.set_validation_summary(vlog)
    opt.set_train_summary(log)
    torch.cuda.synchronize()
    _reset_conv_counts()
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _conv_counts()
    losses = log.losses
    check(len(losses) == FACADE_RESNET_STEPS and all(np.isfinite(losses)),
          f"ResNet-50 facade losses: {losses}")
    rel = abs(losses[0] - want) / abs(want)
    check(rel <= FACADE_FIRST_LOSS_REL,
          f"facade first loss {losses[0]} vs make_train_step's {want}")
    check([tag for tag, _ in vlog.scalars] == ["Top1Accuracy"],
          f"ResNet-50 validation summary: {vlog.scalars}")
    for kind in ("k9", "i2c"):
        want_n = routes[kind] * FACADE_RESNET_STEPS + fwd[kind]
        check(counts[f"{kind}_cuda_core"] == want_n and counts[kind] == 0,
              f"facade float32: conv3x3_{kind} ran {counts[kind]} "
              f"tensor-core and {counts[f'{kind}_cuda_core']} CUDA-core "
              f"launches; the layers give 0 and {want_n} ({routes[kind]} "
              f"a step, {fwd[kind]} in the validation forward)")
        kernels[f"conv3x3_{kind}"].setdefault("launches_by_phase", {})[
            "train_optimizer"] = counts[f"{kind}_cuda_core"]
    check("3x3/s1" not in counts["library"],
          f"a 3x3 stride-1 convolution reached F.conv2d: {counts['library']}")
    # the float32 CUDA-core kernels at this path's batch and shapes,
    # forward and flip, against F.conv2d on the CPU
    conv_f32 = _check_conv3x3_autograd(torch, rng, torch.float32, b,
                                       CONV_TOL["float32"])
    summary = opt.metrics_summary()
    step_s = summary["step_time_avg_s"] + summary["data_time_avg_s"]
    flops = 3 * resnet_flops(model, (hw, hw)) * b
    # where the time goes: 2 more iterations through the facade
    model.load_state_dict(params)
    opt2 = Optimizer(model=model, dataset=_pin_shuffle(train.copy()),
                     criterion=ClassNLLCriterion())
    opt2.set_optim_method(method()).set_end_when(Trigger.max_iteration(2))
    profile = _profile(torch, opt2.optimize,
                       groups={"conv3x3 CUDA-core kernels":
                               "conv3x3_simt_kernel",
                               "cuDNN": ("xmma", "cudnn", "implicit"),
                               "reductions": "reduce_kernel",
                               "elementwise": "elementwise_kernel"})
    emit({"phase": "train_optimizer", "part": "resnet50", "format": "NHWC",
          "dtype": "float32", "batch": b, "image": hw, "records": n,
          "iterations": FACADE_RESNET_STEPS,
          "optimizer": "SGD(0.01, momentum 0.9, MultiStep([2, 3], 0.1))",
          "losses": losses, "make_train_step_first_loss": want,
          "first_loss_rel_diff": rel, "metrics_summary": summary,
          "step_s": step_s, "images_per_s": b / step_s, "wall_s": wall,
          "model_flops_per_step": flops,
          "mfu_vs_f32_peak": flops / step_s / PEAK_FLOPS_PER_S["float32"],
          "conv_routes_per_step": routes,
          "validation_forward_launches": fwd, "launches": counts,
          "conv3x3_f32_autograd_rel": conv_f32,
          "conv3x3_f32_autograd_tol": CONV_TOL["float32"],
          "device_busy_share": profile.get("device_busy_share",
                                           "not measured"),
          "card": smi})
    emit({"phase": "profile", "path": "train_optimizer_resnet50",
          "iterations": 2, **profile})


# ------------------------------------------------- train_distri (A.10)
# ZeRO-1 data parallelism through the facade, two replicas on the one card
# (a device may repeat in a mesh): the data-parallel path's cost, not a
# gain
DISTRI_MESH = ["cuda:0", "cuda:0"]
# ResNet-50 (ImageNet, NHWC, 1000 outputs) at 224 x 224, global batch 32
# (16 a replica): 128 seeded records, 4 float32 iterations (the reference's
# default compute), then 2 in bfloat16 compute; labels from 10 classes, so
# that 4 SGD steps lower the loss whatever the batches hold
DISTRI_RECORDS, DISTRI_BATCH = 128, 32
DISTRI_STEPS, DISTRI_BF16_STEPS, DISTRI_CLASSES = 4, 2, 10
# one hand-driven step against make_distributed_train_step's: float32 wire
# (the same kernels on the same halves; only the mean's division could
# differ), x max|w|; bfloat16 wire against the hand step on wire-rounded
# weights and wire-rounded half gradients (one rounding of their sum
# apart), x max|w|; BN statistics, absolute
DISTRI_F32_REL, DISTRI_BF16_REL, DISTRI_BN_ATOL = 1e-6, 1e-3, 1e-6


def _distri_step_check(torch, params, x, y, wire):
    """One ``make_distributed_train_step`` step of ResNet-50 at ``wire``
    against the hand-driven step: the mean of the two half-batch
    gradients of ``make_loss_and_grads`` (each half on its own copy of the
    model, on the wire-rounded weights and with its gradient rounded to
    the wire type at bfloat16 wire) applied by the same ``SGD`` to the
    float32 masters; BN statistics the mean of the halves'. Returns
    (masters' max error / max|w|, BN statistics' max error)."""
    from bigdl_tpu_torch.models import ResNet
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, make_loss_and_grads
    from bigdl_tpu_torch.parallel.allreduce import \
        make_distributed_train_step

    def fresh():
        m = ResNet(class_num=1000, depth=50, format="NHWC")
        m.load_state_dict(params)
        return m

    step = make_distributed_train_step(
        fresh(), ClassNLLCriterion(), SGD(learningrate=0.01, momentum=0.9),
        DISTRI_MESH, wire_dtype=wire)
    step(x, y)
    arp = step.state.arp
    got = step.state.full_master(x.device)
    halves = [fresh(), fresh()]
    rows = x.shape[0] // 2
    grads = []
    for i, h in enumerate(halves):
        hp = dict(h.named_parameters())
        arp.load_into(arp.flatten(hp).to(wire).float(), hp)
        _, g = make_loss_and_grads(h, ClassNLLCriterion())(
            x[i * rows:(i + 1) * rows], y[i * rows:(i + 1) * rows])
        grads.append(arp.flatten(g).to(wire).float())
    mean = (grads[0] + grads[1]) / torch.tensor(2.0, device=x.device)
    w = arp.flatten(dict(fresh().named_parameters()))
    method = SGD(learningrate=0.01, momentum=0.9)
    method.update({"flat": mean}, method.init_state({"flat": w}),
                  {"flat": w})
    torch.cuda.synchronize()
    rel = float((got - w).abs().max() / w.abs().max())
    bn = 0.0
    for (name, b), (_, b0), (_, b1) in zip(
            step.state.replicas[0].named_buffers(),
            halves[0].named_buffers(), halves[1].named_buffers()):
        if b.is_floating_point():
            bn = max(bn, float((b - (b0 + b1) / 2).abs().max()))
    del step, halves, grads, mean, w, got
    torch.cuda.empty_cache()
    return rel, bn


def _distri_resnet_opt(torch, params, train, steps, compute_dtype=None,
                       val=None, ckpt=None):
    """ResNet-50 from ``params`` and its ``Optimizer(..., mesh=
    DISTRI_MESH)``, set up: returns (model, optimizer, train summary,
    validation summary)."""
    from bigdl_tpu_torch.models import ResNet
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Top1Accuracy, Trigger
    model = ResNet(class_num=1000, depth=50, format="NHWC")
    model.load_state_dict(params)
    opt = Optimizer(model=model, dataset=train,
                    criterion=ClassNLLCriterion(), mesh=DISTRI_MESH,
                    compute_dtype=compute_dtype)
    opt.set_optim_method(SGD(learningrate=0.01, momentum=0.9))
    opt.set_end_when(Trigger.max_iteration(steps))
    if val is not None:
        opt.set_validation(Trigger.every_epoch(), val, [Top1Accuracy()])
    if ckpt is not None:
        opt.set_checkpoint(ckpt, Trigger.every_epoch())
    log, vlog = _Scalars(), _Scalars()
    opt.set_train_summary(log)
    opt.set_validation_summary(vlog)
    return model, opt, log, vlog


def _distri_resnet_run(torch, *args, **kw):
    """:func:`_distri_resnet_opt`, then ``optimize()``: returns (model,
    optimizer, losses, validation scalars, wall seconds)."""
    model, opt, log, vlog = _distri_resnet_opt(torch, *args, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    return model, opt, log.losses, vlog.scalars, time.perf_counter() - t0


def _distri_resnet(torch, kernels, smi):
    import os
    import tempfile

    import numpy as np
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
    from bigdl_tpu_torch.models import (ResNet, conv_routes,
                                        resnet_flops)
    from bigdl_tpu_torch.parallel import DistriOptimizer
    from bigdl_tpu_torch.utils.serializer import load_module

    n, b, hw = DISTRI_RECORDS, DISTRI_BATCH, RESNET_HW
    rng = np.random.default_rng(12)
    images = rng.standard_normal((n, hw, hw, 3), dtype=np.float32)
    labels = rng.integers(0, DISTRI_CLASSES, n).astype(np.int32)
    model = ResNet(class_num=1000, depth=50, format="NHWC")
    params = convert.init_resnet_params(model, seed=3)
    routes = conv_routes(model, (hw, hw))
    fwd = _conv_forward_counts(model, (hw, hw))
    del model
    x = torch.from_numpy(images[:b]).cuda()
    y = torch.from_numpy(labels[:b]).long().cuda()
    f32_rel, f32_bn = _distri_step_check(torch, params, x, y, torch.float32)
    check(f32_rel <= DISTRI_F32_REL and f32_bn <= DISTRI_BN_ATOL,
          f"float32-wire step vs the hand-driven mean of halves: masters "
          f"{f32_rel} x max|w|, BN statistics {f32_bn}")
    bf_rel, bf_bn = _distri_step_check(torch, params, x, y, torch.bfloat16)
    check(bf_rel <= DISTRI_BF16_REL and bf_bn <= DISTRI_BN_ATOL,
          f"bfloat16-wire step vs the hand-driven step on wire-rounded "
          f"weights and gradients: masters {bf_rel} x max|w|, BN "
          f"statistics {bf_bn}")
    del x, y

    def records(k):
        return DataSet.array([Sample(images[i], labels[i])
                              for i in range(k)], distributed=True) \
            >> SampleToMiniBatch(b)

    val = DataSet.array([Sample(images[i], labels[i]) for i in range(b)]) \
        >> SampleToMiniBatch(b)
    with tempfile.TemporaryDirectory() as ckpt:
        _reset_conv_counts()
        torch.cuda.reset_peak_memory_stats()
        model, opt, losses, vscalars, wall = _distri_resnet_run(
            torch, params, records(n), DISTRI_STEPS, val=val, ckpt=ckpt)
        peak = torch.cuda.max_memory_allocated()
        counts = _conv_counts()
        check(isinstance(opt, DistriOptimizer),
              f"Optimizer(mesh=...) gave {type(opt).__name__}")
        check(len(losses) == DISTRI_STEPS and all(np.isfinite(losses))
              and losses[-1] < losses[0],
              f"train_distri ResNet-50 float32 losses: {losses}")
        epochs = -(-DISTRI_STEPS // (n // b))     # one validation each
        check([tag for tag, _ in vscalars] == ["Top1Accuracy"] * epochs,
              f"train_distri validation summary: {vscalars}")
        for kind in ("k9", "i2c"):
            want_n = 2 * (routes[kind] * DISTRI_STEPS + fwd[kind])
            check(counts[f"{kind}_cuda_core"] == want_n and counts[kind] == 0,
                  f"train_distri float32: conv3x3_{kind} ran {counts[kind]} "
                  f"tensor-core and {counts[f'{kind}_cuda_core']} CUDA-core "
                  f"launches; 2 replicas give 0 and {want_n} "
                  f"({routes[kind]} a step, {fwd[kind]} a validation "
                  f"forward, each)")
            kernels[f"conv3x3_{kind}"].setdefault("launches_by_phase", {})[
                "train_distri"] = counts[f"{kind}_cuda_core"]
        check("3x3/s1" not in counts["library"],
              f"a 3x3 stride-1 convolution reached F.conv2d: "
              f"{counts['library']}")
        state = opt._step.state
        slots = [st["velocity"]["flat"].numel() for st in state.opt_states]
        check(slots == [state.arp.padded_size // 2] * 2,
              f"replica slots {slots} for padded size "
              f"{state.arp.padded_size}")
        last = DISTRI_STEPS + 1
        fresh = load_module(os.path.join(ckpt, f"model.{last}"))
        check(isinstance(fresh, ResNet),
              f"train_distri: model.{last} loads as {type(fresh).__name__}")
        same = all(torch.equal(a, b_) for a, b_ in
                   zip(model.state_dict().values(),
                       fresh.state_dict().values()))
        check(same, "train_distri checkpoint does not reload bit for bit")
        # ``retries`` counts the retries the optimizer logged
        check(opt.retries == 0, f"train_distri retried {opt.retries} times")
        summary = opt.metrics_summary()
        del fresh, model, opt
        torch.cuda.empty_cache()
    step_s = summary["step_time_avg_s"] + summary["data_time_avg_s"]
    flops = 3 * resnet_flops(ResNet(class_num=1000, depth=50,
                                    format="NHWC", device="cpu"),
                             (hw, hw)) * b
    # where the time goes: 2 more iterations, the model and optimizer set
    # up outside the profile, as in the facade's
    _, popt, _, _ = _distri_resnet_opt(torch, params, records(2 * b), 2)
    profile = _profile(
        torch, popt.optimize,
        groups={"conv3x3 CUDA-core kernels": "conv3x3_simt_kernel",
                "cuDNN": ("xmma", "cudnn", "implicit"),
                "copies": ("copy", "CatArray"),
                "reductions": "reduce_kernel",
                "elementwise": "elementwise_kernel"},
        ranges=("allreduce/gather", "allreduce/reduce_scatter"))
    del popt
    emit({"phase": "train_distri", "part": "resnet50", "format": "NHWC",
          "dtype": "float32", "wire_dtype": "bfloat16", "mesh": DISTRI_MESH,
          "batch": b, "per_replica": b // 2, "image": hw, "records": n,
          "classes": DISTRI_CLASSES, "iterations": DISTRI_STEPS,
          "optimizer": "SGD(0.01, momentum 0.9)", "losses": losses,
          "step_check_f32_wire_rel": f32_rel, "step_check_f32_bn": f32_bn,
          "step_check_bf16_wire_rel": bf_rel, "step_check_bf16_bn": bf_bn,
          "metrics_summary": summary, "step_s": step_s,
          "images_per_s": b / step_s, "wall_s": wall,
          "peak_memory_bytes": peak, "model_flops_per_step": flops,
          "conv_routes_per_step": routes, "validation_forward": fwd,
          "launches": counts, "slot_elements": slots,
          "checkpoint_reload_bitwise": same, "retries": 0,
          "device_busy_share": profile.get("device_busy_share",
                                           "not measured"),
          "card": smi})
    emit({"phase": "profile", "path": "train_distri_resnet50",
          "iterations": 2, **profile})

    # bfloat16 compute: every 3x3 stride-1 convolution on the tensor cores
    _reset_conv_counts()
    _, opt, losses, _, wall = _distri_resnet_run(
        torch, params, records(n), DISTRI_BF16_STEPS,
        compute_dtype=torch.bfloat16)
    counts = _conv_counts()
    check(len(losses) == DISTRI_BF16_STEPS and all(np.isfinite(losses)),
          f"train_distri ResNet-50 bfloat16 losses: {losses}")
    for kind in ("k9", "i2c"):
        want_n = 2 * routes[kind] * DISTRI_BF16_STEPS
        check(counts[kind] == want_n and counts[f"{kind}_cuda_core"] == 0,
              f"train_distri bfloat16: conv3x3_{kind} ran {counts[kind]} "
              f"tensor-core and {counts[f'{kind}_cuda_core']} CUDA-core "
              f"launches; 2 replicas give {want_n} and 0")
        kernels[f"conv3x3_{kind}"]["launches_by_phase"][
            "train_distri_bf16"] = counts[kind]
    check("3x3/s1" not in counts["library"],
          f"a 3x3 stride-1 convolution reached F.conv2d: {counts['library']}")
    summary = opt.metrics_summary()
    step_s = summary["step_time_avg_s"] + summary["data_time_avg_s"]
    emit({"phase": "train_distri", "part": "resnet50_bf16",
          "compute_dtype": "bfloat16", "wire_dtype": "bfloat16",
          "iterations": DISTRI_BF16_STEPS, "losses": losses,
          "metrics_summary": summary, "step_s": step_s,
          "images_per_s": b / step_s, "wall_s": wall, "launches": counts,
          "card": smi})
    del opt
    torch.cuda.empty_cache()


def _distri_lenet(torch, smi):
    import numpy as np
    from bigdl_tpu_torch.dataset.mnist import mnist_dataset
    from bigdl_tpu_torch.models import LeNet5
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import (Adam, Evaluator, Optimizer,
                                       Top1Accuracy, Trigger)
    model = LeNet5(10, device="cuda", seed=1)
    train = mnist_dataset(training=True, batch_size=LENET_BATCH,
                          distributed=True, synthetic_size=LENET_TRAIN)
    val = mnist_dataset(training=False, batch_size=LENET_BATCH,
                        synthetic_size=LENET_VAL)
    opt = Optimizer(model=model, dataset=train,
                    criterion=ClassNLLCriterion(), mesh=DISTRI_MESH)
    opt.set_optim_method(Adam(learningrate=2e-3))
    opt.set_end_when(Trigger.max_epoch(LENET_EPOCHS))
    log = _Scalars()
    opt.set_train_summary(log)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = log.losses
    check(len(losses) == LENET_EPOCHS * LENET_TRAIN // LENET_BATCH
          and all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"train_distri LeNet losses: {losses}")
    top1, count = Evaluator(model).evaluate(
        val, [Top1Accuracy()])["Top1Accuracy"].result()
    check(count == LENET_VAL and top1 > LENET_TOP1_BAR,
          f"train_distri LeNet validation top-1 {top1} over {count} digits")
    summary = opt.metrics_summary()
    emit({"phase": "train_distri", "part": "lenet", "mesh": DISTRI_MESH,
          "train_records": LENET_TRAIN, "batch": LENET_BATCH,
          "epochs": LENET_EPOCHS, "optimizer": "Adam(2e-3)",
          "losses": losses, "top1": top1, "metrics_summary": summary,
          "step_s": summary["step_time_avg_s"] + summary["data_time_avg_s"],
          "records_per_s": summary["throughput_rec_s"], "wall_s": wall,
          "retries": opt.retries, "card": smi})
    check(opt.retries == 0, "train_distri LeNet retried")


def phase_train_distri(torch, kernels, smi):
    """``DistriOptimizer`` (ZeRO-1 over two replicas on the card) on
    ResNet-50 and LeNet-5 through the reference's API (see module
    docstring)."""
    _distri_resnet(torch, kernels, smi)
    torch.cuda.empty_cache()
    _distri_lenet(torch, smi)


def phase_train_optimizer(torch, kernels, smi):
    """The reference's training API (``Optimizer(...).optimize()``,
    ``Evaluator``) on LeNet-5 and ResNet-50 (see module docstring)."""
    _facade_lenet(torch, smi)
    torch.cuda.empty_cache()
    _facade_resnet(torch, kernels, smi)


# ------------------------------------------------- train_cnn (A.11(a))
# VGG-16, Inception-v1 and AlexNet (BASELINE.json configs 2 and 3) at full
# width and depth, 1000 classes, seeded random weights (Module.reset) and
# seeded synthetic NCHW images in channels-last memory order
CNN_BATCH, CNN_STEPS = 32, 5
CNN_SEED = 16
# labels from 10 of the 1000 classes, as train_distri's, and SGD at 0.05
# (momentum 0.9): VGG-16's signal vanishes through 15 ReLU layers at its
# initial weights, its logits stay near 0, and its loss must fall in 5
# steps by more than bfloat16's rounding of the log-probabilities (2^-5
# near ln 1000) and the dropout's noise; the classifier's bias alone moves
# the label classes' logits by about 13 x lr x 0.1 = 0.066 in 5 steps (at
# 0.01 the bfloat16 losses did not fall on the card)
CNN_CLASSES = 10
CNN_LR = 0.05
# card against the port's CPU run, float32, training mode, dropout off:
# train_resnet's bars (loss relative; each gradient within CNN_GRAD_REL of
# its largest magnitude or RESNET_NOISE_FACTOR times its CPU noise floor,
# whichever is larger: a 2^-23 change of the images moves these models'
# gradients by up to percents at their initial weights, see
# tests/test_torch_inception.py)
CNN_CHECK_BATCH, CNN_LOSS_REL, CNN_GRAD_REL = 4, 1e-4, 1e-3
# Inception-v1 through the facade: the reference example's optimizer
# (examples/inception_imagenet.py:73-76), 4 float32 iterations of 32
INCEPTION_FACADE_STEPS = 4
INCEPTION_LR = 0.0898
# VGG-16 through DistriOptimizer (BASELINE.json config 2): two replicas on
# the card, global batch 32, bfloat16 compute and wire
CNN_DISTRI_STEPS = 2
CNN_KERNEL_GROUPS = {"conv3x3 tensor-core kernels": "conv3x3_tc_kernel",
                     "conv3x3 CUDA-core kernels": "conv3x3_simt_kernel",
                     "cuDNN": ("cudnn", "implicit", "fprop", "dgrad",
                               "wgrad"),
                     "GEMMs": "gemm",
                     "reductions": "reduce_kernel",
                     "elementwise": "elementwise_kernel"}


def _cnn_batch(torch, rng, n, hw, device="cuda"):
    """``n`` seeded images (NCHW, channels-last memory) and labels."""
    x = torch.from_numpy(rng.standard_normal((n, 3, hw, hw),
                                             dtype="float32"))
    y = torch.from_numpy(rng.integers(0, CNN_CLASSES, n))
    return (x.to(device).contiguous(memory_format=torch.channels_last),
            y.to(device))


def _route_launches(split, n):
    """The conv counters (``_conv_counts``) ``n`` steps of a route table
    (``models.conv_routes`` with a dtype) give."""
    return {"k9": split["k9"]["tc"] * n, "k9_cuda_core":
            split["k9"]["simt"] * n, "i2c": split["i2c"]["tc"] * n,
            "i2c_cuda_core": split["i2c"]["simt"] * n}


def _check_routes(name, counts, split, n):
    """Launches by path and library calls of ``n`` steps against the route
    table; no 3x3 stride-1 convolution on the library."""
    got = {k: counts[k] for k in ("k9", "k9_cuda_core", "i2c",
                                  "i2c_cuda_core")}
    want = _route_launches(split, n)
    check(got == want, f"{name}: the conv kernels ran {got}; the route "
                       f"table gives {want} ({n} steps)")
    check("3x3/s1" not in counts["library"],
          f"{name}: a 3x3 stride-1 convolution reached F.conv2d: "
          f"{counts['library']}")
    lib = sum(counts["library"].values())
    check(lib == split["library"] * n,
          f"{name}: F.conv2d ran {lib} times; the route table gives "
          f"{split['library'] * n}")


def _conv3x3_share(profile):
    groups = profile.get("groups", {})
    shares = [groups[k]["share_of_device_time"] for k in
              ("conv3x3 tensor-core kernels", "conv3x3 CUDA-core kernels")
              if k in groups]
    return sum(shares) if shares else "not measured"


def _cnn_steps(torch, name, model, hw, dtype, smi, kernels, steps,
               generator=None, phase="train_cnn"):
    """``make_train_step`` (SGD CNN_LR, momentum 0.9) on one seeded batch
    of CNN_BATCH: a warm-up step, then ``steps`` timed ones, launches held
    against the route table; then 2 steps under the profiler. Emits and
    returns the line (``phase`` names it and the launches' entry)."""
    import numpy as np
    from bigdl_tpu_torch.models import conv_routes, model_flops
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, make_train_step
    cast = dtype if dtype is not None else torch.float32
    split = conv_routes(model, (hw, hw), cast)
    x, y = _cnn_batch(torch, np.random.default_rng(CNN_SEED), CNN_BATCH, hw)
    opt = SGD(learningrate=CNN_LR, momentum=0.9)
    opt_state = opt.init_state(dict(model.named_parameters()))
    step = make_train_step(model, ClassNLLCriterion(), opt,
                           compute_dtype=dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step(opt_state, x, y, generator)]           # warm-up
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    _reset_conv_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(step(opt_state, x, y, generator))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _conv_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    check(all(np.isfinite(losses)), f"{name}: non-finite losses {losses}")
    if steps:
        _check_routes(name, counts, split, steps)
    step_s = wall / steps if steps else warmup_s
    flops = 3 * model_flops(model, (hw, hw)) * CNN_BATCH
    dname = str(cast).replace("torch.", "")
    profile = _profile(torch, lambda: [step(opt_state, x, y, generator)
                                       for _ in range(2)],
                       groups=CNN_KERNEL_GROUPS)
    line = {"phase": phase, "part": name, "format": "NCHW",
            "memory_format": "channels_last", "batch": CNN_BATCH,
            "image": hw, "compute_dtype": dname,
            "optimizer": f"SGD({CNN_LR}, momentum 0.9)",
            "dropout": generator is not None, "losses": losses,
            "timed_steps": steps, "step_s": step_s,
            "images_per_s": CNN_BATCH / step_s, "warmup_s": warmup_s,
            "peak_memory_bytes": peak, "model_flops_per_step": flops,
            f"mfu_vs_{dname}_peak": flops / step_s
            / PEAK_FLOPS_PER_S[dname],
            "conv_routes_per_step": split, "launches": counts,
            "device_busy_share": profile.get("device_busy_share",
                                             "not measured"),
            "conv3x3_share_of_device_time": _conv3x3_share(profile),
            "card": smi}
    emit(line)
    emit({"phase": "profile", "path": f"{phase}_{name}", "steps": 2,
          **profile})
    for kind in ("k9", "i2c"):
        kernels[f"conv3x3_{kind}"].setdefault("launches_by_phase", {})[
            f"{phase}_{name}"] = {"tensor_cores": counts[kind],
                                  "cuda_cores": counts[f"{kind}_cuda_core"]}
    return line


def _cnn_vs_cpu(torch, name, model, make, hw):
    """One float32 training forward and backward of a CNN_CHECK_BATCH
    batch, dropout off, on the card (the conv kernels' CUDA-core path)
    against the port's CPU run (plain versions) on the same weights; the
    gradient bar is train_resnet's. Returns the record."""
    import numpy as np
    from bigdl_tpu_torch.models import conv_routes
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import make_loss_and_grads
    crit = ClassNLLCriterion()
    x, y = _cnn_batch(torch, np.random.default_rng(CNN_SEED + 1),
                      CNN_CHECK_BATCH, hw, device="cpu")
    _reset_conv_counts()
    loss_g, grads_g = make_loss_and_grads(model, crit)(x.cuda(), y.cuda())
    torch.cuda.synchronize()
    launches = _conv_counts()
    grads_g = {k: g.float().cpu() for k, g in grads_g.items()}
    cpu = make(1000, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})

    def cpu_run(images):
        loss, grads = make_loss_and_grads(cpu, crit)(images, y)
        return float(loss), {k: g.clone() for k, g in grads.items()}

    t0 = time.perf_counter()
    loss_c, grads_c = cpu_run(x)
    noise = {k: 0.0 for k in grads_c}
    for seed in (0, 1):
        _, moved = cpu_run(_perturbed(torch, x, seed))
        for k, g in moved.items():
            noise[k] = max(noise[k], float((g - grads_c[k]).abs().max()))
    cpu_s = time.perf_counter() - t0
    rec = {"cpu_loss_rel_diff": abs(float(loss_g) - loss_c) / abs(loss_c),
           "cpu_grad_worst_rel": 0.0, "cpu_grad_worst_param": None,
           "cpu_grad_worst_vs_bar": 0.0, "cpu_grad_bar_param": None,
           "cpu_grad_params_on_noise_floor": 0,
           "cpu_check_launches": launches, "cpu_check_s": cpu_s}
    for k, gc in grads_c.items():
        top = max(float(gc.abs().max()), 1e-30)
        diff = float((grads_g[k] - gc).abs().max())
        bar = max(CNN_GRAD_REL * top, RESNET_NOISE_FACTOR * noise[k])
        rec["cpu_grad_params_on_noise_floor"] += bar > CNN_GRAD_REL * top
        if diff / top > rec["cpu_grad_worst_rel"]:
            rec["cpu_grad_worst_rel"], rec["cpu_grad_worst_param"] = \
                diff / top, k
        if diff / bar > rec["cpu_grad_worst_vs_bar"]:
            rec["cpu_grad_worst_vs_bar"], rec["cpu_grad_bar_param"] = \
                diff / bar, k
    print(f"train_cnn {name} card vs CPU: {json.dumps(rec)}", flush=True)
    check(rec["cpu_loss_rel_diff"] <= CNN_LOSS_REL,
          f"{name} card vs CPU loss differs by {rec['cpu_loss_rel_diff']}")
    check(rec["cpu_grad_worst_vs_bar"] <= 1.0,
          f"{name} card vs CPU gradient of {rec['cpu_grad_bar_param']} is "
          f"{rec['cpu_grad_worst_vs_bar']} times its bar")
    _check_routes(f"{name} float32 check", launches,
                  conv_routes(model, (hw, hw), torch.float32), 1)
    del cpu
    return rec


def _cnn_inception_facade(torch, kernels, smi):
    """Inception-v1 with both auxiliary heads through ``Optimizer``:
    float32, INCEPTION_FACADE_STEPS iterations of CNN_BATCH seeded
    records, the reference example's SGD; dropout draws from the
    facade's seeded stream. Launches against the float32 route table."""
    import numpy as np
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
    from bigdl_tpu_torch.models import (Inception_v1, conv_routes,
                                        model_flops)
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Poly, Trigger
    n, b, hw = INCEPTION_FACADE_STEPS * CNN_BATCH, CNN_BATCH, 224
    rng = np.random.default_rng(CNN_SEED + 2)
    images = rng.standard_normal((n, 3, hw, hw), dtype=np.float32)
    labels = rng.integers(0, CNN_CLASSES, n).astype(np.int32)
    model = Inception_v1(1000, seed=CNN_SEED)
    split = conv_routes(model, (hw, hw), torch.float32)
    ds = _pin_shuffle(DataSet.array([Sample(images[i], labels[i])
                                     for i in range(n)])
                      >> SampleToMiniBatch(b))
    opt = Optimizer(model=model, dataset=ds, criterion=ClassNLLCriterion(),
                    seed=CNN_SEED)
    opt.set_optim_method(SGD(learningrate=INCEPTION_LR, momentum=0.9,
                             dampening=0.0, weightdecay=1e-4,
                             learningrate_schedule=Poly(0.5, 62000)))
    opt.set_end_when(Trigger.max_iteration(INCEPTION_FACADE_STEPS))
    log = _Scalars()
    opt.set_train_summary(log)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_conv_counts()
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _conv_counts()
    losses = log.losses
    check(len(losses) == INCEPTION_FACADE_STEPS and all(np.isfinite(losses)),
          f"inception_v1 facade losses: {losses}")
    _check_routes("inception_v1 facade float32", counts, split,
                  INCEPTION_FACADE_STEPS)
    summary = opt.metrics_summary()
    step_s = summary["step_time_avg_s"] + summary["data_time_avg_s"]
    flops = 3 * model_flops(model, (hw, hw)) * b
    emit({"phase": "train_cnn", "part": "inception_v1_facade",
          "dtype": "float32", "batch": b, "image": hw, "records": n,
          "iterations": INCEPTION_FACADE_STEPS,
          "optimizer": f"SGD({INCEPTION_LR}, momentum 0.9, weightdecay "
                       f"1e-4, Poly(0.5, 62000))",
          "dropout": True, "losses": losses, "metrics_summary": summary,
          "step_s": step_s, "images_per_s": b / step_s, "wall_s": wall,
          "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          "model_flops_per_step": flops,
          "mfu_vs_float32_peak": flops / step_s
          / PEAK_FLOPS_PER_S["float32"],
          "conv_routes_per_step": split, "launches": counts, "card": smi})
    for kind in ("k9", "i2c"):
        kernels[f"conv3x3_{kind}"].setdefault("launches_by_phase", {})[
            "train_cnn_inception_v1_facade"] = counts[f"{kind}_cuda_core"]
    return model


def _cnn_vgg_distri(torch, kernels, smi):
    """VGG-16 through ``DistriOptimizer`` on two replicas of the card:
    bfloat16 compute and wire, CNN_DISTRI_STEPS iterations of a global
    CNN_BATCH, a checkpoint that must reload bit for bit; launches 2 x
    steps x the bfloat16 route table."""
    import os
    import tempfile

    import numpy as np
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
    from bigdl_tpu_torch.models import Vgg_16, conv_routes
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    from bigdl_tpu_torch.utils.serializer import load_module
    n, b, hw = CNN_DISTRI_STEPS * CNN_BATCH, CNN_BATCH, 224
    rng = np.random.default_rng(CNN_SEED + 3)
    images = rng.standard_normal((n, 3, hw, hw), dtype=np.float32)
    labels = rng.integers(0, CNN_CLASSES, n).astype(np.int32)
    model = Vgg_16(1000, seed=CNN_SEED)
    split = conv_routes(model, (hw, hw), torch.bfloat16)
    ds = DataSet.array([Sample(images[i], labels[i]) for i in range(n)],
                       distributed=True) >> SampleToMiniBatch(b)
    with tempfile.TemporaryDirectory() as ckpt:
        opt = Optimizer(model=model, dataset=ds,
                        criterion=ClassNLLCriterion(), mesh=DISTRI_MESH,
                        compute_dtype=torch.bfloat16, seed=CNN_SEED)
        opt.set_optim_method(SGD(learningrate=0.01, momentum=0.9))
        opt.set_end_when(Trigger.max_iteration(CNN_DISTRI_STEPS))
        opt.set_checkpoint(ckpt, Trigger.every_epoch())
        log = _Scalars()
        opt.set_train_summary(log)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_conv_counts()
        t0 = time.perf_counter()
        opt.optimize()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _conv_counts()
        peak = torch.cuda.max_memory_allocated()
        losses = log.losses
        check(len(losses) == CNN_DISTRI_STEPS and all(np.isfinite(losses)),
              f"vgg16 distri losses: {losses}")
        _check_routes("vgg16 distri bfloat16", counts, split,
                      2 * CNN_DISTRI_STEPS)
        fresh = Vgg_16(1000, seed=0)
        fresh.load_state_dict(load_module(os.path.join(
            ckpt, f"model.{CNN_DISTRI_STEPS + 1}")).state_dict())
        same = all(torch.equal(a, b_) for a, b_ in
                   zip(model.state_dict().values(),
                       fresh.state_dict().values()))
        check(same, "vgg16 distri checkpoint does not reload bit for bit")
        check(opt.retries == 0, f"vgg16 distri retried {opt.retries} times")
        summary = opt.metrics_summary()
        del fresh, opt
    step_s = summary["step_time_avg_s"] + summary["data_time_avg_s"]
    emit({"phase": "train_cnn", "part": "vgg16_distri", "mesh": DISTRI_MESH,
          "compute_dtype": "bfloat16", "wire_dtype": "bfloat16",
          "batch": b, "per_replica": b // 2, "image": hw,
          "iterations": CNN_DISTRI_STEPS, "losses": losses,
          "metrics_summary": summary, "step_s": step_s,
          "images_per_s": b / step_s, "wall_s": wall,
          "peak_memory_bytes": peak, "conv_routes_per_step": split,
          "launches": counts, "checkpoint_reload_bitwise": same,
          "retries": 0, "card": smi})
    for kind in ("k9", "i2c"):
        kernels[f"conv3x3_{kind}"].setdefault("launches_by_phase", {})[
            "train_cnn_vgg16_distri"] = counts[kind]
    del model
    torch.cuda.empty_cache()


def phase_train_cnn(torch, kernels, smi):
    """VGG-16, Inception-v1 and AlexNet on the training paths (see module
    docstring)."""
    from bigdl_tpu_torch.models import (AlexNet, AlexNet_OWT, Inception_v1,
                                        Vgg_16)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # VGG-16, bfloat16, dropout from a seeded generator
    vgg = Vgg_16(1000, seed=CNN_SEED)
    gen = torch.Generator(device="cuda").manual_seed(CNN_SEED)
    line = _cnn_steps(torch, "vgg16", vgg, 224, torch.bfloat16, smi,
                      kernels, CNN_STEPS, generator=gen)
    check(line["losses"][-1] < line["losses"][0],
          f"vgg16 loss did not fall: {line['losses']}")
    cmp_vgg = _cnn_vs_cpu(torch, "vgg16", vgg, Vgg_16, 224)
    del vgg
    torch.cuda.empty_cache()
    # Inception-v1 with its auxiliary heads: the facade in float32, then
    # make_train_step in bfloat16 on the facade's weights
    inc = _cnn_inception_facade(torch, kernels, smi)
    # its losses are reported, not held to fall: the three heads' dropout
    # (0.4 and 0.7) moves them more than 5 steps at this rate do
    _cnn_steps(torch, "inception_v1", inc, 224, torch.bfloat16, smi,
               kernels, CNN_STEPS,
               generator=torch.Generator(device="cuda").manual_seed(CNN_SEED))
    inc_fresh = Inception_v1(1000, seed=CNN_SEED)
    cmp_inc = _cnn_vs_cpu(torch, "inception_v1", inc_fresh, Inception_v1,
                          224)
    del inc, inc_fresh
    torch.cuda.empty_cache()
    emit({"phase": "train_cnn", "part": "card_vs_cpu", "dtype": "float32",
          "batch": CNN_CHECK_BATCH, "image": 224, "dropout": False,
          "loss_rel_bar": CNN_LOSS_REL, "grad_rel_bar": CNN_GRAD_REL,
          "grad_noise_factor": RESNET_NOISE_FACTOR, "vgg16": cmp_vgg,
          "inception_v1": cmp_inc, "card": smi})
    _cnn_vgg_distri(torch, kernels, smi)
    # AlexNet (Caffe, grouped, 227²) and AlexNet-OWT (224²): one float32
    # step each
    for name, make, hw in (("alexnet", AlexNet, 227),
                              ("alexnet_owt", AlexNet_OWT, 224)):
        _cnn_steps(torch, name, make(1000, seed=CNN_SEED), hw, None, smi,
                   kernels, 1)
        torch.cuda.empty_cache()


# ------------------------------------------- load_interop (A.11(d)(1))
# BVLC GoogLeNet's inception modules (its deploy.prototxt, the port's
# Inception_v1_NoAuxClassifier): (name, (1x1, 3x3 reduce, 3x3, 5x5 reduce,
# 5x5, pool proj)), with its max pools between 3b and 4a and 4e and 5a
GOOGLENET_MODULES = [("3a", (64, 96, 128, 16, 32, 32)),
                     ("3b", (128, 128, 192, 32, 96, 64)), "pool3/3x3_s2",
                     ("4a", (192, 96, 208, 16, 48, 64)),
                     ("4b", (160, 112, 224, 24, 64, 64)),
                     ("4c", (128, 128, 256, 24, 64, 64)),
                     ("4d", (112, 144, 288, 32, 64, 64)),
                     ("4e", (256, 160, 320, 32, 128, 128)), "pool4/3x3_s2",
                     ("5a", (256, 160, 320, 32, 128, 128)),
                     ("5b", (384, 192, 384, 48, 128, 128))]
INTEROP_OUT_REL = 1e-5      # loaded model against its source, x max|out|


def _caffe_layer_text(name, kind, bottoms, top, param=None):
    lines = [f'layer {{ name: "{name}" type: "{kind}"']
    lines += [f'  bottom: "{b}"' for b in bottoms]
    lines.append(f'  top: "{top}"')
    if param:
        key, fields = param
        lines.append(f"  {key} {{ " + " ".join(f"{k}: {v}" for k, v in
                                              fields) + " }")
    return "\n".join(lines) + " }"


def googlenet_prototxt(batch, image=224, modules=GOOGLENET_MODULES,
                       pool5=7, classes=1000):
    """BVLC GoogLeNet's layout (``models/bvlc_googlenet``'s deploy
    prototxt: the stem, the inception modules of ``modules`` with their
    in-place ReLUs and the max pools between them, ``pool5`` as a
    ``pool5`` x ``pool5`` average, dropout 0.4 and ``loss3/classifier``),
    ending in ``loss3/loss3``, a ``SoftmaxWithLoss``."""
    out = ['name: "GoogleNet"', 'input: "data"',
           f"input_shape {{ dim: {batch} dim: 3 dim: {image} "
           f"dim: {image} }}"]

    def conv(name, bottom, n, k, stride=1, pad=0):
        fields = [("num_output", n)] + ([("pad", pad)] if pad else []) \
            + [("kernel_size", k)] + ([("stride", stride)]
                                      if stride != 1 else [])
        relu = name.replace("/", "/relu_", 1)
        out.append(_caffe_layer_text(name, "Convolution", [bottom], name,
                                     ("convolution_param", fields)))
        out.append(_caffe_layer_text(relu, "ReLU", [name], name))
        return name

    def pool(name, bottom, kind, k, stride, pad=0):
        fields = [("pool", kind), ("kernel_size", k), ("stride", stride)] \
            + ([("pad", pad)] if pad else [])
        out.append(_caffe_layer_text(name, "Pooling", [bottom], name,
                                     ("pooling_param", fields)))
        return name

    def lrn(name, bottom):
        out.append(_caffe_layer_text(
            name, "LRN", [bottom], name,
            ("lrn_param", [("local_size", 5), ("alpha", 0.0001),
                           ("beta", 0.75)])))
        return name

    top = conv("conv1/7x7_s2", "data", 64, 7, 2, 3)
    top = lrn("pool1/norm1", pool("pool1/3x3_s2", top, "MAX", 3, 2))
    top = conv("conv2/3x3_reduce", top, 64, 1)
    top = conv("conv2/3x3", top, 192, 3, pad=1)
    top = pool("pool2/3x3_s2", lrn("conv2/norm2", top), "MAX", 3, 2)
    for mod in modules:
        if isinstance(mod, str):
            top = pool(mod, top, "MAX", 3, 2)
            continue
        name, (c1, r3, c3, r5, c5, pp) = mod
        pre = f"inception_{name}/"
        towers = [conv(pre + "1x1", top, c1, 1),
                  conv(pre + "3x3", conv(pre + "3x3_reduce", top, r3, 1),
                       c3, 3, pad=1),
                  conv(pre + "5x5", conv(pre + "5x5_reduce", top, r5, 1),
                       c5, 5, pad=2),
                  conv(pre + "pool_proj",
                       pool(pre + "pool", top, "MAX", 3, 1, 1), pp, 1)]
        top = pre + "output"
        out.append(_caffe_layer_text(top, "Concat", towers, top))
    top = pool("pool5/7x7_s1", top, "AVE", pool5, 1)
    out.append(_caffe_layer_text("pool5/drop_7x7_s1", "Dropout", [top], top,
                                 ("dropout_param",
                                  [("dropout_ratio", 0.4)])))
    out.append(_caffe_layer_text("loss3/classifier", "InnerProduct", [top],
                                 "loss3/classifier",
                                 ("inner_product_param",
                                  [("num_output", classes)])))
    out.append(_caffe_layer_text("loss3/loss3", "SoftmaxWithLoss",
                                 ["loss3/classifier", "label"],
                                 "loss3/loss3"))
    return "\n".join(out) + "\n"


def caffemodel_bytes(model, name="GoogleNet"):
    """A caffemodel of ``model``'s named convolutions and ``Linear``s
    (layer name: the module's name; blobs: weight, then bias, in the
    port's layouts, which are Caffe's), encoded by the port's
    ``protowire``."""
    import numpy as np
    from bigdl_tpu_torch.interop.caffe import NET
    from bigdl_tpu_torch.nn import Linear, SpatialConvolution
    from bigdl_tpu_torch.utils.protowire import encode

    def blob(t):
        a = t.detach().float().cpu().numpy()
        return {"shape": {"dim": list(a.shape)},
                "data": np.ascontiguousarray(a).ravel()}

    layers = []
    for m in model.modules():
        if isinstance(m, (SpatialConvolution, Linear)) \
                and "/" in m.get_name():
            kind = ("Convolution" if isinstance(m, SpatialConvolution)
                    else "InnerProduct")
            layers.append({"name": m.get_name(), "type": kind,
                           "blobs": [blob(m.weight)]
                           + ([blob(m.bias)] if m.bias is not None
                              else [])})
    return encode({"name": name, "layer": layers}, NET)


def _eval_outputs(torch, model, x):
    """``model``'s float32 outputs on ``x`` in evaluation mode (the model
    is left in training mode)."""
    model.evaluate()
    with torch.no_grad():
        y = model(x).float()
    model.train()
    torch.cuda.synchronize()
    return y


def _out_rel(got, want):
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def _interop_caffe(torch, kernels, smi, root):
    """Inception-v1 written as a BVLC prototxt and caffemodel, loaded on
    the card (see the module docstring's load_interop)."""
    import numpy as np
    from bigdl_tpu_torch.interop import CaffeLoader, load_caffe
    from bigdl_tpu_torch.models import (Inception_v1_NoAuxClassifier,
                                        conv_routes)
    src = Inception_v1_NoAuxClassifier(1000, seed=CNN_SEED)
    proto = f"{root}/googlenet.prototxt"
    weights = f"{root}/googlenet.caffemodel"
    t0 = time.perf_counter()
    with open(proto, "w") as f:
        f.write(googlenet_prototxt(CNN_BATCH))
    with open(weights, "wb") as f:
        f.write(caffemodel_bytes(src))
    write_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph = load_caffe(proto, weights, sample_input=(CNN_BATCH, 3, 224, 224))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    x, _ = _cnn_batch(torch, np.random.default_rng(CNN_SEED + 4), CNN_BATCH,
                      224)
    rel = _out_rel(_eval_outputs(torch, graph, x),
                   _eval_outputs(torch, src, x))
    check(rel <= INTEROP_OUT_REL, f"caffe-loaded inception_v1: outputs "
                                  f"differ from the source's by {rel}")
    routes = conv_routes(graph, (224, 224), torch.bfloat16)
    want = conv_routes(src, (224, 224), torch.bfloat16)
    check(routes == want, f"caffe-loaded inception_v1 routes {routes}, "
                          f"the source's {want}")
    fresh = Inception_v1_NoAuxClassifier(1000, seed=CNN_SEED + 1)
    _, copied = CaffeLoader(proto, weights).load_weights_into(fresh)
    same = all(torch.equal(a, b) for a, b in
               zip(fresh.state_dict().values(), src.state_dict().values()))
    check(same, "load_weights_into did not reproduce the source's weights")
    del fresh, src
    torch.cuda.empty_cache()
    line = _cnn_steps(torch, "inception_v1_caffe", graph, 224,
                      torch.bfloat16, smi, kernels, CNN_STEPS,
                      generator=torch.Generator(device="cuda")
                      .manual_seed(CNN_SEED), phase="load_interop")
    import os
    emit({"phase": "load_interop", "part": "inception_v1_caffe",
          "prototxt_bytes": os.path.getsize(proto),
          "caffemodel_bytes": os.path.getsize(weights),
          "graph_nodes": len(graph.exec_order), "write_s": write_s,
          "load_s": load_s, "out_rel_vs_source": rel,
          "out_rel_bar": INTEROP_OUT_REL, "conv_routes_per_step": routes,
          "load_weights_into_layers": len(copied),
          "load_weights_into_bitwise": same, "step_s": line["step_s"],
          "images_per_s": line["images_per_s"], "card": smi})
    del graph
    torch.cuda.empty_cache()


def _interop_torch(torch, kernels, smi, root):
    """AlexNet-OWT through a .t7 file (see the module docstring's
    load_interop)."""
    import os

    import numpy as np
    from bigdl_tpu_torch.interop import load_torch, save_torch
    from bigdl_tpu_torch.models import AlexNet, AlexNet_OWT, conv_routes
    src = AlexNet_OWT(1000, seed=CNN_SEED)
    path = f"{root}/alexnet_owt.t7"
    t0 = time.perf_counter()
    save_torch(src, path)
    save_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded = load_torch(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    x, _ = _cnn_batch(torch, np.random.default_rng(CNN_SEED + 5), CNN_BATCH,
                      224)
    rel = _out_rel(_eval_outputs(torch, loaded, x),
                   _eval_outputs(torch, src, x))
    check(rel <= INTEROP_OUT_REL, f"t7-loaded alexnet_owt: outputs differ "
                                  f"from the source's by {rel}")
    routes = conv_routes(loaded, (224, 224), torch.float32)
    check(routes == conv_routes(src, (224, 224), torch.float32),
          "t7-loaded alexnet_owt: routes differ from the source's")
    del src
    grouped = AlexNet(1000, seed=CNN_SEED)
    try:
        save_torch(grouped, f"{root}/alexnet.t7")
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused is not None and "no legacy-nn mapping" in refused,
          f"save_torch of a grouped convolution: {refused}")
    del grouped
    torch.cuda.empty_cache()
    line = _cnn_steps(torch, "alexnet_owt_t7", loaded, 224, None, smi,
                      kernels, 1, phase="load_interop")
    emit({"phase": "load_interop", "part": "alexnet_owt_t7",
          "t7_bytes": os.path.getsize(path), "save_s": save_s,
          "load_s": load_s, "out_rel_vs_source": rel,
          "out_rel_bar": INTEROP_OUT_REL, "conv_routes_per_step": routes,
          "grouped_refused": refused, "step_s": line["step_s"],
          "images_per_s": line["images_per_s"], "card": smi})
    del loaded
    torch.cuda.empty_cache()


def phase_load_interop(torch, kernels, smi):
    """Inception-v1 from a Caffe prototxt and caffemodel, AlexNet-OWT from
    a Torch7 file, both written in the run (see module docstring)."""
    import tempfile
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as root:
        _interop_caffe(torch, kernels, smi, root)
        _interop_torch(torch, kernels, smi, root)


# ----------------------------------------------- load_tf (A.11(d)(2)(a))
# TF GraphDefs written in the run: node dicts as the GraphDef schema of
# ``interop/tf_loader.py`` takes them, encoded with the port's protowire;
# variables as the .npy directory scripts/export_tf_checkpoint.py writes
# (one ``<name>.npy`` a variable, ``/`` as ``__``), each read through a
# ``VariableV2`` node and an ``Identity`` named ``<name>/read``. The CPU
# tests (tests/test_torch_tf_*.py) build their graphs with these too.
TF_DTYPES = {"float32": 1, "int32": 3, "uint8": 4, "string": 7, "int64": 9,
             "bool": 10}


def tf_node(name, op, inputs=(), **attrs):
    """A NodeDef dict; attrs: bool -> b, int -> i, float -> f, bytes -> s,
    an array -> a tensor (one of bytes a DT_STRING tensor), a dict -> the
    AttrValue itself."""
    import numpy as np
    a = []
    for k, v in attrs.items():
        if isinstance(v, bool):
            a.append({"key": k, "value": {"b": v}})
        elif isinstance(v, int):
            a.append({"key": k, "value": {"i": v}})
        elif isinstance(v, float):
            a.append({"key": k, "value": {"f": v}})
        elif isinstance(v, bytes):
            a.append({"key": k, "value": {"s": v}})
        elif isinstance(v, np.ndarray) and v.dtype.kind in "SO":
            a.append({"key": k, "value": {"tensor": {
                "dtype": TF_DTYPES["string"],
                "tensor_shape": {"dim": [{"size": int(s)}
                                         for s in v.shape]},
                "string_val": [bytes(b) for b in v.ravel()]}}})
        elif isinstance(v, np.ndarray):
            a.append({"key": k, "value": {"tensor": {
                "dtype": TF_DTYPES[v.dtype.name],
                "tensor_shape": {"dim": [{"size": int(s)}
                                         for s in v.shape]},
                "tensor_content": v.tobytes()}}})
        elif isinstance(v, dict):
            a.append({"key": k, "value": v})
        else:
            raise TypeError(f"attr {k}: {type(v)}")
    return {"name": name, "op": op, "input": list(inputs), "attr": a}


def tf_const(name, arr):
    import numpy as np
    return tf_node(name, "Const", value=np.asarray(arr))


def tf_variable(name):
    """A variable's ``VariableV2`` node and its ``<name>/read``."""
    return [tf_node(name, "VariableV2"),
            tf_node(f"{name}/read", "Identity", [name])]


def tf_graphdef(nodes):
    from bigdl_tpu_torch.interop.tf_loader import GRAPH_DEF
    from bigdl_tpu_torch.utils.protowire import encode
    return encode({"node": nodes}, GRAPH_DEF)


def write_npy_dir(root, variables):
    """``variables`` as export_tf_checkpoint.py writes them; returns the
    bytes written."""
    import os

    import numpy as np
    total = 0
    for name, a in variables.items():
        path = os.path.join(root, name.replace("/", "__") + ".npy")
        np.save(path, a)
        total += os.path.getsize(path)
    return total


def _truncated_normal(rng, shape, std=0.02):
    """Normal draws of ``std`` redrawn until within 2 std (TF's
    ``truncated_normal_initializer``, as BERT initialises its weights)."""
    import numpy as np
    x = rng.standard_normal(shape, dtype=np.float32)
    bad = np.abs(x) > 2.0
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()), dtype=np.float32)
        bad = np.abs(x) > 2.0
    return x * np.float32(std)


def _tf_layer_norm(p, x):
    """BERT's layer norm over the last axis (``modeling.py``
    ``layer_norm``, epsilon 1e-12), the reference's mini-BERT chain, on
    ``p``'s ``LayerNorm/gamma`` and ``LayerNorm/beta``."""
    import numpy as np
    g = f"{p}/LayerNorm"
    return [
        tf_const(f"{g}/axes", np.asarray([-1], np.int32)),
        tf_node(f"{g}/mean", "Mean", [x, f"{g}/axes"], keep_dims=True),
        tf_node(f"{g}/sub", "Sub", [x, f"{g}/mean"]),
        tf_node(f"{g}/SquaredDifference", "SquaredDifference",
                [x, f"{g}/mean"]),
        tf_node(f"{g}/variance", "Mean", [f"{g}/SquaredDifference",
                                          f"{g}/axes"], keep_dims=True),
        tf_const(f"{g}/epsilon", np.float32(1e-12)),
        tf_node(f"{g}/add", "AddV2", [f"{g}/variance", f"{g}/epsilon"]),
        tf_node(f"{g}/Rsqrt", "Rsqrt", [f"{g}/add"]),
        tf_node(f"{g}/normalized", "Mul", [f"{g}/sub", f"{g}/Rsqrt"]),
        tf_node(f"{g}/mul", "Mul", [f"{g}/normalized", f"{g}/gamma/read"]),
        tf_node(f"{g}/output", "AddV2", [f"{g}/mul", f"{g}/beta/read"]),
    ]


def _tf_dense(p, x, act=None):
    """``p``'s dense layer on ``x``: ``MatMul`` on ``p/kernel``,
    ``BiasAdd`` of ``p/bias``; returns (nodes, output name)."""
    nodes = [tf_node(f"{p}/MatMul", "MatMul", [x, f"{p}/kernel/read"]),
             tf_node(f"{p}/BiasAdd", "BiasAdd",
                     [f"{p}/MatMul", f"{p}/bias/read"])]
    if act is None:
        return nodes, f"{p}/BiasAdd"
    nodes.append(tf_node(f"{p}/{act}", act, [f"{p}/BiasAdd"]))
    return nodes, f"{p}/{act}"


def bert_tf_graph(n_layers=12, hidden=768, heads=12, ffn=3072, vocab=30522,
                  seq=128, classes=2, seed=0):
    """Google BERT's classifier fine-tuning graph (``modeling.py`` with
    ``run_classifier.py``'s head), laid out op for op as the reference's
    mini-BERT (tests/test_tf_importer.py), on one ``input_ids``
    placeholder: word and position embeddings, ``n_layers`` encoder layers
    (exact erf GELU), the pooler (dense + Tanh on the [CLS] row, taken as
    ``sequence_output[:, 0:1, :]`` and squeezed), a ``classes``-way
    classifier (``output_weights`` (classes, hidden), ``transpose_b``).
    Every Reshape takes the batch as -1. Returns (nodes, variables: name
    -> float32 array, seeded truncated normals of 0.02, LayerNorm gamma 1,
    beta 0, biases 0); ``position_embeddings`` holds the ``seq`` rows the
    graph adds. Output node: ``output/logits``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    hd = hidden // heads
    var = {}

    def kernel(name, shape):
        var[name] = _truncated_normal(rng, shape)

    def zeros(name, n):
        var[name] = np.zeros(n, np.float32)

    def ln(p):
        var[f"{p}/LayerNorm/gamma"] = np.ones(hidden, np.float32)
        zeros(f"{p}/LayerNorm/beta", hidden)

    def dense(p, n_in, n_out):
        kernel(f"{p}/kernel", (n_in, n_out))
        zeros(f"{p}/bias", n_out)

    e = "bert/embeddings"
    kernel(f"{e}/word_embeddings", (vocab, hidden))
    kernel(f"{e}/position_embeddings", (seq, hidden))
    ln(e)
    nodes = [
        tf_node("input_ids", "Placeholder", dtype={"type": 3}),
        tf_node(f"{e}/GatherV2", "GatherV2",
                [f"{e}/word_embeddings/read", "input_ids", f"{e}/axis"]),
        tf_const(f"{e}/axis", np.int32(0)),
        tf_node(f"{e}/add", "AddV2", [f"{e}/GatherV2",
                                      f"{e}/position_embeddings/read"]),
        *_tf_layer_norm(e, f"{e}/add"),
        tf_const("bert/encoder/flat", np.asarray([-1, hidden], np.int32)),
        tf_node("bert/encoder/Reshape", "Reshape",
                [f"{e}/LayerNorm/output", "bert/encoder/flat"]),
        tf_const("bert/encoder/heads_shape",
                 np.asarray([-1, seq, heads, hd], np.int32)),
        tf_const("bert/encoder/perm", np.asarray([0, 2, 1, 3], np.int32)),
    ]
    x = "bert/encoder/Reshape"
    for i in range(n_layers):
        p = f"bert/encoder/layer_{i}"
        a = f"{p}/attention/self"
        proj = {}
        for part in ("query", "key", "value"):
            dense(f"{a}/{part}", hidden, hidden)
            d, out = _tf_dense(f"{a}/{part}", x)
            nodes += d + [
                tf_node(f"{a}/{part}/Reshape", "Reshape",
                        [out, "bert/encoder/heads_shape"]),
                tf_node(f"{a}/{part}/transpose", "Transpose",
                        [f"{a}/{part}/Reshape", "bert/encoder/perm"])]
            proj[part] = f"{a}/{part}/transpose"
        nodes += [
            tf_node(f"{a}/MatMul", "BatchMatMulV2",
                    [proj["query"], proj["key"]], adj_y=True),
            tf_const(f"{a}/Mul/y", np.float32(1.0 / np.sqrt(hd))),
            tf_node(f"{a}/Mul", "Mul", [f"{a}/MatMul", f"{a}/Mul/y"]),
            tf_node(f"{a}/Softmax", "Softmax", [f"{a}/Mul"]),
            tf_node(f"{a}/MatMul_1", "BatchMatMulV2",
                    [f"{a}/Softmax", proj["value"]]),
            tf_node(f"{a}/transpose_3", "Transpose",
                    [f"{a}/MatMul_1", "bert/encoder/perm"]),
            tf_node(f"{a}/Reshape_3", "Reshape",
                    [f"{a}/transpose_3", "bert/encoder/flat"])]
        o = f"{p}/attention/output"
        dense(f"{o}/dense", hidden, hidden)
        ln(o)
        d, out = _tf_dense(f"{o}/dense", f"{a}/Reshape_3")
        nodes += d + [tf_node(f"{o}/add", "AddV2", [out, x])]
        nodes += _tf_layer_norm(o, f"{o}/add")
        attn = f"{o}/LayerNorm/output"
        m = f"{p}/intermediate"
        dense(f"{m}/dense", hidden, ffn)
        d, h = _tf_dense(f"{m}/dense", attn)
        nodes += d + [
            tf_const(f"{m}/dense/Sqrt", np.float32(1.0 / np.sqrt(2.0))),
            tf_node(f"{m}/dense/truediv", "Mul", [h, f"{m}/dense/Sqrt"]),
            tf_node(f"{m}/dense/Erf", "Erf", [f"{m}/dense/truediv"]),
            tf_const(f"{m}/dense/add/x", np.float32(1.0)),
            tf_node(f"{m}/dense/add", "AddV2",
                    [f"{m}/dense/Erf", f"{m}/dense/add/x"]),
            tf_node(f"{m}/dense/mul_1", "Mul", [h, f"{m}/dense/add"]),
            tf_const(f"{m}/dense/mul/x", np.float32(0.5)),
            tf_node(f"{m}/dense/mul_2", "Mul",
                    [f"{m}/dense/mul_1", f"{m}/dense/mul/x"])]
        o = f"{p}/output"
        dense(f"{o}/dense", ffn, hidden)
        ln(o)
        d, out = _tf_dense(f"{o}/dense", f"{m}/dense/mul_2")
        nodes += d + [tf_node(f"{o}/add", "AddV2", [out, attn])]
        nodes += _tf_layer_norm(o, f"{o}/add")
        x = f"{o}/LayerNorm/output"
    dense("bert/pooler/dense", hidden, hidden)
    kernel("output_weights", (classes, hidden))
    zeros("output_bias", classes)
    nodes += [
        tf_const("bert/encoder/seq_shape",
                 np.asarray([-1, seq, hidden], np.int32)),
        tf_node("bert/encoder/Reshape_1", "Reshape",
                [x, "bert/encoder/seq_shape"]),
        tf_const("bert/pooler/begin", np.asarray([0, 0, 0], np.int32)),
        tf_const("bert/pooler/end", np.asarray([0, 1, 0], np.int32)),
        tf_const("bert/pooler/strides", np.asarray([1, 1, 1], np.int32)),
        tf_node("bert/pooler/strided_slice", "StridedSlice",
                ["bert/encoder/Reshape_1", "bert/pooler/begin",
                 "bert/pooler/end", "bert/pooler/strides"],
                begin_mask=5, end_mask=5),
        tf_node("bert/pooler/Squeeze", "Squeeze",
                ["bert/pooler/strided_slice"],
                squeeze_dims={"list": {"i": [1]}})]
    d, pooled = _tf_dense("bert/pooler/dense", "bert/pooler/Squeeze", "Tanh")
    nodes += d + [
        tf_node("output/MatMul", "MatMul", [pooled, "output_weights/read"],
                transpose_b=True),
        tf_node("output/logits", "BiasAdd",
                ["output/MatMul", "output_bias/read"])]
    for name in var:
        nodes += tf_variable(name)
    return nodes, var


VGG16_BLOCKS = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


def _vgg16_plan(blocks, image, fc, classes, images):
    """TF-slim ``vgg_16``'s layers in forward order: ``("conv", prefix, k,
    cin, cout, padding, input name, input (h, w))`` and ``("pool", name,
    input name, input (h, w))``; the last convolution (``fc8``) has no
    ``Relu``."""
    plan, x, cin, hw = [], images, 3, image
    for b, (n, cout) in enumerate(blocks, 1):
        for j in range(1, n + 1):
            p = f"vgg_16/conv{b}/conv{b}_{j}"
            plan.append(("conv", p, 3, cin, cout, b"SAME", x, hw))
            x, cin = f"{p}/Relu", cout
        plan.append(("pool", f"vgg_16/pool{b}/MaxPool", x, hw))
        x, hw = f"vgg_16/pool{b}/MaxPool", hw // 2
    for name, k, cout in (("fc6", hw, fc), ("fc7", 1, fc),
                          ("fc8", 1, classes)):
        plan.append(("conv", f"vgg_16/{name}", k, cin, cout, b"VALID", x,
                     hw))
        x, cin, hw = f"vgg_16/{name}/Relu", cout, hw - k + 1
    return plan


def vgg16_tf_graph(blocks=VGG16_BLOCKS, image=224, fc=4096, classes=1000,
                   seed=0, images=None):
    """TF-slim's ``vgg_16`` inference graph (tensorflow/models
    ``research/slim/nets/vgg.py``), NHWC on an ``input`` placeholder (or,
    with ``images``, on that node, which the caller writes):
    ``Conv2D`` 3x3 SAME + ``BiasAdd`` + ``Relu`` per layer of ``blocks``
    ((convolutions, channels) a block), ``MaxPool`` 2x2 VALID after each
    block, ``fc6`` a VALID ``Conv2D`` over the whole remaining map, ``fc7``
    and ``fc8`` 1x1, then ``Squeeze`` [1, 2], no dropout nodes. Names
    ``vgg_16/conv1/conv1_1/weights`` ... ``vgg_16/fc8/biases``; weights
    Glorot-uniform from ``seed`` (slim's default), biases 0. Returns
    (nodes, variables). Output node: ``vgg_16/fc8/squeezed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    var = {}
    nodes = ([] if images else
             [tf_node("input", "Placeholder", dtype={"type": 1})])
    plan = _vgg16_plan(blocks, image, fc, classes, images or "input")
    for step in plan:
        if step[0] == "pool":
            _, name, x, _ = step
            nodes.append(tf_node(name, "MaxPool", [x],
                                 ksize={"list": {"i": [1, 2, 2, 1]}},
                                 strides={"list": {"i": [1, 2, 2, 1]}},
                                 padding=b"VALID", data_format=b"NHWC"))
            continue
        _, p, k, cin, cout, pad, x, _ = step
        bound = np.sqrt(6.0 / (k * k * cin + k * k * cout))
        var[f"{p}/weights"] = rng.uniform(-bound, bound, (k, k, cin, cout)) \
            .astype(np.float32)
        var[f"{p}/biases"] = np.zeros(cout, np.float32)
        nodes += [tf_node(f"{p}/Conv2D", "Conv2D", [x, f"{p}/weights/read"],
                          strides={"list": {"i": [1, 1, 1, 1]}},
                          padding=pad, data_format=b"NHWC"),
                  tf_node(f"{p}/BiasAdd", "BiasAdd",
                          [f"{p}/Conv2D", f"{p}/biases/read"])]
        if step is not plan[-1]:
            nodes.append(tf_node(f"{p}/Relu", "Relu", [f"{p}/BiasAdd"]))
    nodes.append(tf_node("vgg_16/fc8/squeezed", "Squeeze",
                         ["vgg_16/fc8/BiasAdd"],
                         squeeze_dims={"list": {"i": [1, 2]}}))
    for name in var:
        nodes += tf_variable(name)
    return nodes, var


def _i32(v):
    import numpy as np
    return np.asarray(v, np.int32)


def _tf_example_front(batch, image, classes):
    """The data front of a training graph fed by tf.Examples: a
    ``serialized`` string placeholder of ``batch`` records, ``ParseExample``
    of ``image/class/label`` (int64, port 0; keys in TF's sorted order)
    and ``image/raw`` (string, port 1), both required; ``DecodeRaw`` as
    uint8, ``Reshape`` to (batch, image, image, 3) (the decoded images,
    ``Reshape``), ``Cast`` to float32 and ``Mul`` by 1/255 (``images``);
    the labels' ``OneHot`` over ``classes``."""
    import numpy as np
    pe = "ParseExample/ParseExample"
    return [
        tf_node("serialized", "Placeholder", dtype={"type": 7},
                shape={"shape": {"dim": [{"size": batch}]}}),
        tf_const(f"{pe}/names", np.zeros(0, "S1")),
        tf_const(f"{pe}/dense_keys_0", np.asarray(b"image/class/label")),
        tf_const(f"{pe}/dense_keys_1", np.asarray(b"image/raw")),
        tf_const("ParseExample/Const", np.zeros(0, np.int64)),
        tf_const("ParseExample/Const_1", np.zeros(0, "S1")),
        tf_node(pe, "ParseExample",
                ["serialized", f"{pe}/names", f"{pe}/dense_keys_0",
                 f"{pe}/dense_keys_1", "ParseExample/Const",
                 "ParseExample/Const_1"],
                Nsparse=0, Ndense=2, Tdense={"list": {"type": [9, 7]}},
                dense_shapes={"list": {"shape": [{}, {}]}}),
        tf_node("DecodeRaw", "DecodeRaw", [f"{pe}:1"],
                out_type={"type": 4}, little_endian=True),
        tf_const("Reshape/shape", _i32([batch, image, image, 3])),
        tf_node("Reshape", "Reshape", ["DecodeRaw", "Reshape/shape"]),
        tf_node("Cast", "Cast", ["Reshape"], SrcT={"type": 4},
                DstT={"type": 1}),
        tf_const("mul/y", np.float32(1.0 / 255.0)),
        tf_node("images", "Mul", ["Cast", "mul/y"]),
        tf_const("OneHot/depth", _i32(classes)),
        tf_const("OneHot/on_value", np.float32(1.0)),
        tf_const("OneHot/off_value", np.float32(0.0)),
        tf_node("OneHot", "OneHot", [f"{pe}:0", "OneHot/depth",
                                     "OneHot/on_value", "OneHot/off_value"],
                axis=-1)]


def _tf_placeholder_front(batch, image, classes):
    """The same graph's front as two placeholders: ``images`` (float32)
    and ``labels`` (int32), one-hot as above."""
    import numpy as np
    return [
        tf_node("images", "Placeholder", dtype={"type": 1},
                shape={"shape": {"dim": [{"size": d} for d in
                                         (batch, image, image, 3)]}}),
        tf_node("labels", "Placeholder", dtype={"type": 3}),
        tf_const("OneHot/depth", _i32(classes)),
        tf_const("OneHot/on_value", np.float32(1.0)),
        tf_const("OneHot/off_value", np.float32(0.0)),
        tf_node("OneHot", "OneHot", ["labels", "OneHot/depth",
                                     "OneHot/on_value", "OneHot/off_value"],
                axis=-1)]


def vgg16_tf_train_graph(blocks=VGG16_BLOCKS, image=224, fc=4096,
                         classes=1000, batch=32, seed=0, front="examples"):
    """TF-slim ``vgg_16``'s training graph as TF 1.x's ``tf.gradients``
    writes it for ``reduce_mean(softmax_cross_entropy_with_logits(logits,
    one_hot(label)))``, after constant folding with static shapes. The
    front (``front="examples"``: :func:`_tf_example_front`; "placeholders":
    :func:`_tf_placeholder_front`) feeds :func:`vgg16_tf_graph`'s forward
    at ``images``. The loss: ``_flatten_outer_dims``' ``xent/Reshape`` of
    the logits and ``xent/Reshape_1`` of the labels to (batch, classes),
    ``xent/xentropy`` (``SoftmaxCrossEntropyWithLogits``), ``xent/
    Reshape_2`` to (batch,) and ``Mean``. The backward, by ``nn_grad.py``
    and ``math_grad.py``: the mean's gradient (``Fill`` of the seed,
    ``Reshape``, ``Tile`` and ``RealDiv`` by the batch, ``ExpandDims``)
    folded into the constant ``gradients/xent/xentropy_grad/ExpandDims``
    (batch, 1) of 1 / batch, times the cross entropy's backprop output;
    the ``Reshape`` gradients back to (batch, 1, 1, classes); per layer
    ``ReluGrad(g, relu_out)`` (not ``fc8``), ``BiasAddGrad``,
    ``Conv2DBackpropInput(input_sizes, weights/read, g)`` (not
    ``conv1_1``: the images need none) and ``Conv2DBackpropFilter(x,
    filter_sizes, g)``, their sizes constants as folding leaves them;
    ``MaxPoolGrad(x, pool_out, g)`` per pool. Returns (nodes, variables,
    gradient output names in the variables' order); outputs ``Mean`` (the
    loss), ``xent/Reshape`` (the logits) and, with the example front,
    ``Reshape`` (the decoded uint8 images)."""
    import numpy as np
    fwd, var = vgg16_tf_graph(blocks, image, fc, classes, seed,
                              images="images")
    make_front = (_tf_example_front if front == "examples"
                  else _tf_placeholder_front)
    n, g = batch, "gradients"
    nodes = make_front(batch, image, classes) + fwd + [
        tf_const("xent/Reshape/shape", _i32([n, classes])),
        tf_node("xent/Reshape", "Reshape",
                ["vgg_16/fc8/squeezed", "xent/Reshape/shape"]),
        tf_node("xent/Reshape_1", "Reshape", ["OneHot",
                                              "xent/Reshape/shape"]),
        tf_node("xent/xentropy", "SoftmaxCrossEntropyWithLogits",
                ["xent/Reshape", "xent/Reshape_1"]),
        tf_const("xent/Reshape_2/shape", _i32([n])),
        tf_node("xent/Reshape_2", "Reshape", ["xent/xentropy:0",
                                              "xent/Reshape_2/shape"]),
        tf_const("Const", _i32([0])),
        tf_node("Mean", "Mean", ["xent/Reshape_2", "Const"],
                keep_dims=False),
        tf_const(f"{g}/xent/xentropy_grad/ExpandDims",
                 np.full((n, 1), 1.0 / n, np.float32)),
        tf_node(f"{g}/xent/xentropy_grad/mul", "Mul",
                [f"{g}/xent/xentropy_grad/ExpandDims", "xent/xentropy:1"]),
        tf_const(f"{g}/xent/Reshape_grad/Shape", _i32([n, classes])),
        tf_node(f"{g}/xent/Reshape_grad/Reshape", "Reshape",
                [f"{g}/xent/xentropy_grad/mul",
                 f"{g}/xent/Reshape_grad/Shape"]),
        tf_const(f"{g}/vgg_16/fc8/squeezed_grad/Shape",
                 _i32([n, 1, 1, classes])),
        tf_node(f"{g}/vgg_16/fc8/squeezed_grad/Reshape", "Reshape",
                [f"{g}/xent/Reshape_grad/Reshape",
                 f"{g}/vgg_16/fc8/squeezed_grad/Shape"])]
    grad = f"{g}/vgg_16/fc8/squeezed_grad/Reshape"
    outs = {}
    plan = _vgg16_plan(blocks, image, fc, classes, "images")
    window = dict(ksize={"list": {"i": [1, 2, 2, 1]}},
                  strides={"list": {"i": [1, 2, 2, 1]}}, padding=b"VALID",
                  data_format=b"NHWC")
    for step in reversed(plan):
        if step[0] == "pool":
            _, name, x, _ = step
            q = f"{g}/{name}_grad/MaxPoolGrad"
            nodes.append(tf_node(q, "MaxPoolGrad", [x, name, grad],
                                 **window))
            grad = q
            continue
        _, p, k, cin, cout, pad, x, hw = step
        if step is not plan[-1]:
            q = f"{g}/{p}/Relu_grad/ReluGrad"
            nodes.append(tf_node(q, "ReluGrad", [grad, f"{p}/Relu"]))
            grad = q
        c = f"{g}/{p}/Conv2D_grad"
        conv = dict(strides={"list": {"i": [1, 1, 1, 1]}}, padding=pad,
                    data_format=b"NHWC")
        nodes += [
            tf_node(f"{g}/{p}/BiasAdd_grad/BiasAddGrad", "BiasAddGrad",
                    [grad], data_format=b"NHWC"),
            tf_const(f"{c}/ShapeN_1", _i32([k, k, cin, cout])),
            tf_node(f"{c}/Conv2DBackpropFilter", "Conv2DBackpropFilter",
                    [x, f"{c}/ShapeN_1", grad], **conv)]
        outs[f"{p}/weights"] = f"{c}/Conv2DBackpropFilter"
        outs[f"{p}/biases"] = f"{g}/{p}/BiasAdd_grad/BiasAddGrad"
        if x != "images":
            nodes += [
                tf_const(f"{c}/ShapeN", _i32([n, hw, hw, cin])),
                tf_node(f"{c}/Conv2DBackpropInput", "Conv2DBackpropInput",
                        [f"{c}/ShapeN", f"{p}/weights/read", grad], **conv)]
            grad = f"{c}/Conv2DBackpropInput"
    return nodes, var, [outs[name] for name in var]


GRAD_PAIRS = (("ReluGrad", "g", "x"), ("Relu6Grad", "g", "x"),
              ("EluGrad", "g", "x"), ("SoftplusGrad", "g", "x"),
              ("SoftsignGrad", "g", "x"), ("SigmoidGrad", "xp", "g"),
              ("TanhGrad", "xp", "g"), ("SqrtGrad", "xp", "g"),
              ("RsqrtGrad", "xp", "g"), ("ReciprocalGrad", "xp", "g"))


def tf_grad_sweep_graph(seed=0, host=True, wide=(2, 112, 128)):
    """One GraphDef naming the gradient and data ops of A.11(d)(2)(b) over
    placeholders: the ten elementwise gradient pairs (TF's argument
    order), ``FusedBatchNormGrad``/``V2``, ``AvgPoolGrad`` (3x3 stride-2
    SAME), ``LRNGrad``, ``ResizeBilinearGrad``, ``Dilation2DBackprop
    Input``/``Filter``, the depthwise and 3-D ``Backprop{Input,Filter}``
    (``Conv3D*`` and ``Conv3D*V2``), a 3x3 stride-1 SAME
    ``Conv2DBackpropInput`` at ``wide`` = (batch, size, channels), a
    ``BroadcastGradientArgs`` folded into a ``Sum``, ``RandomShuffle``
    and, with ``host``, ``Substr``. Returns (nodes, inputs, outputs, feed:
    seeded numpy arrays in the inputs' order)."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    s1 = {"list": {"i": [1, 1, 1, 1]}}
    sh = (2, 5, 5, 8)
    n, hw, c = wide
    feed = {"g": f(*sh), "x": f(*sh), "xp": np.abs(f(*sh)) + 0.25,
            "scale": f(8), "mean": f(8) * 0.1, "var": np.abs(f(8)) + 0.5,
            "gp": f(2, 3, 3, 8), "gr": f(2, 8, 7, 8), "gd": f(2, 5, 5, 16),
            "x3": f(1, 3, 4, 4, 2), "g3": f(1, 3, 4, 4, 3),
            "gw": f(n, hw, hw, c), "rows": f(6, 4)}
    nodes = [tf_node(k, "Placeholder", dtype={"type": 1},
                     shape={"shape": {"dim": [{"size": d}
                                              for d in v.shape]}})
             for k, v in feed.items()]
    outs = []
    for op, a, b in GRAD_PAIRS:
        nodes.append(tf_node(op, op, [a, b]))
        outs.append(op)
    bn = ["g", "x", "scale", "mean", "var"]
    for op in ("FusedBatchNormGrad", "FusedBatchNormGradV2"):
        nodes.append(tf_node(op, op, bn, epsilon=1e-3))
        outs += [f"{op}:0", f"{op}:1", f"{op}:2"]
    nodes += [
        tf_const("avg/sizes", _i32(sh)),
        tf_node("AvgPoolGrad", "AvgPoolGrad", ["avg/sizes", "gp"],
                ksize={"list": {"i": [1, 3, 3, 1]}},
                strides={"list": {"i": [1, 2, 2, 1]}}, padding=b"SAME"),
        tf_node("LRNGrad", "LRNGrad", ["g", "x", "x"], depth_radius=2,
                bias=1.5, alpha=0.3, beta=0.75),
        tf_node("ResizeBilinearGrad", "ResizeBilinearGrad", ["gr", "x"]),
        tf_const("dil/w", f(3, 3, 8))]
    outs += ["AvgPoolGrad", "LRNGrad", "ResizeBilinearGrad"]
    for op in ("Dilation2DBackpropInput", "Dilation2DBackpropFilter"):
        nodes.append(tf_node(op, op, ["x", "dil/w", "g"], strides=s1,
                             rates=s1, padding=b"SAME"))
        outs.append(op)
    convs = [("DepthwiseConv2dNative", sh, (3, 3, 8, 2), "x", "gd", s1),
             ("Conv3D", (1, 3, 4, 4, 2), (3, 3, 3, 2, 3), "x3", "g3",
              {"list": {"i": [1, 1, 1, 1, 1]}})]
    for base, sizes, wshape, x, g, st in convs:
        nodes += [tf_const(f"{base}/sizes", _i32(sizes)),
                  tf_const(f"{base}/w", f(*wshape) * 0.3),
                  tf_const(f"{base}/fsizes", _i32(wshape))]
        kinds = ([""] if base.startswith("Depthwise") else ["", "V2"])
        for v in kinds:
            nodes += [
                tf_node(f"{base}BackpropInput{v}", f"{base}BackpropInput{v}",
                        [f"{base}/sizes", f"{base}/w", g], strides=st,
                        padding=b"SAME"),
                tf_node(f"{base}BackpropFilter{v}",
                        f"{base}BackpropFilter{v}",
                        [x, f"{base}/fsizes", g], strides=st,
                        padding=b"SAME")]
            outs += [f"{base}BackpropInput{v}", f"{base}BackpropFilter{v}"]
    nodes += [
        tf_const("wide/sizes", _i32([n, hw, hw, c])),
        tf_const("wide/w", f(3, 3, c, c) * np.float32(1 / 24)),
        tf_node("Conv2DBackpropInput", "Conv2DBackpropInput",
                ["wide/sizes", "wide/w", "gw"], strides=s1,
                padding=b"SAME"),
        tf_node("bga/sx", "Shape", ["g"]),
        tf_const("bga/sy", _i32([8])),
        tf_node("bga", "BroadcastGradientArgs", ["bga/sx", "bga/sy"]),
        tf_node("bga/sum", "Sum", ["g", "bga:1"], keep_dims=False),
        tf_node("RandomShuffle", "RandomShuffle", ["rows"])]
    outs += ["Conv2DBackpropInput", "bga:0", "bga:1", "bga/sum",
             "RandomShuffle"]
    if host:
        feed["strings"] = np.asarray([b"tfrecord", b"example", b"decode"],
                                     dtype=object)
        nodes += [tf_node("strings", "Placeholder", dtype={"type": 7}),
                  tf_const("substr/pos", _i32(1)),
                  tf_const("substr/len", _i32(4)),
                  tf_node("Substr", "Substr", ["strings", "substr/pos",
                                               "substr/len"])]
        outs.append("Substr")
    return nodes, list(feed), outs, list(feed.values())


def counter_loop_graph(w, n_iters):
    """The CPU tests' counter loop (tests/test_tf_importer.py
    ``_counter_frame``): ``i < n_iters``: x = tanh(x @ W); output ``out``
    on input ``x``."""
    import numpy as np
    f = b"loop"
    return [
        tf_node("x", "Placeholder"), tf_const("W", w),
        tf_const("c_zero", np.int32(0)), tf_const("c_n", np.int32(n_iters)),
        tf_const("c_one", np.int32(1)),
        tf_node("enter_i", "Enter", ["c_zero"], frame_name=f),
        tf_node("enter_x", "Enter", ["x"], frame_name=f),
        tf_node("enter_n", "Enter", ["c_n"], frame_name=f, is_constant=True),
        tf_node("enter_one", "Enter", ["c_one"], frame_name=f,
                is_constant=True),
        tf_node("enter_W", "Enter", ["W"], frame_name=f, is_constant=True),
        tf_node("merge_i", "Merge", ["enter_i", "nextit_i"]),
        tf_node("merge_x", "Merge", ["enter_x", "nextit_x"]),
        tf_node("less", "Less", ["merge_i", "enter_n"]),
        tf_node("lc", "LoopCond", ["less"]),
        tf_node("sw_i", "Switch", ["merge_i", "lc"]),
        tf_node("sw_x", "Switch", ["merge_x", "lc"]),
        tf_node("add_i", "Add", ["sw_i:1", "enter_one"]),
        tf_node("mm", "MatMul", ["sw_x:1", "enter_W"]),
        tf_node("act", "Tanh", ["mm"]),
        tf_node("nextit_i", "NextIteration", ["add_i"]),
        tf_node("nextit_x", "NextIteration", ["act"]),
        tf_node("exit_x", "Exit", ["sw_x"]),
        tf_node("out", "Identity", ["exit_x"])]


def tensorarray_loop_graph(w, steps):
    """The CPU tests' TensorArray loop: x scattered into a TensorArray, a
    loop reads row i, applies MatMul(W) + Tanh and writes row i of a
    second array, gathered after the Exit; output ``gather`` on ``x``
    (steps, D)."""
    import numpy as np
    d = w.shape[0]
    f = b"taloop"
    return [
        tf_node("x", "Placeholder"),
        tf_const("c_size", np.int32(steps)),
        tf_const("c_range", np.arange(steps, dtype=np.int32)),
        tf_const("W", w),
        tf_node("ta_x", "TensorArrayV3", ["c_size"], dtype={"type": 1}),
        tf_node("scat", "TensorArrayScatterV3",
                ["ta_x", "c_range", "x", "ta_x:1"]),
        tf_node("ta_y", "TensorArrayV3", ["c_size"], dtype={"type": 1},
                element_shape={"shape": {"dim": [{"size": d}]}}),
        tf_const("c_zero", np.int32(0)), tf_const("c_n", np.int32(steps)),
        tf_const("c_one", np.int32(1)),
        tf_node("enter_i", "Enter", ["c_zero"], frame_name=f),
        tf_node("enter_fy", "Enter", ["ta_y:1"], frame_name=f),
        tf_node("enter_n", "Enter", ["c_n"], frame_name=f, is_constant=True),
        tf_node("enter_one", "Enter", ["c_one"], frame_name=f,
                is_constant=True),
        tf_node("enter_hx", "Enter", ["ta_x"], frame_name=f,
                is_constant=True),
        tf_node("enter_hy", "Enter", ["ta_y"], frame_name=f,
                is_constant=True),
        tf_node("enter_fx", "Enter", ["scat"], frame_name=f,
                is_constant=True),
        tf_node("enter_W", "Enter", ["W"], frame_name=f, is_constant=True),
        tf_node("merge_i", "Merge", ["enter_i", "nextit_i"]),
        tf_node("merge_fy", "Merge", ["enter_fy", "nextit_fy"]),
        tf_node("less", "Less", ["merge_i", "enter_n"]),
        tf_node("lc", "LoopCond", ["less"]),
        tf_node("sw_i", "Switch", ["merge_i", "lc"]),
        tf_node("sw_fy", "Switch", ["merge_fy", "lc"]),
        tf_node("add_i", "Add", ["sw_i:1", "enter_one"]),
        tf_node("read", "TensorArrayReadV3",
                ["enter_hx", "sw_i:1", "enter_fx"]),
        tf_node("rrow", "Reshape", ["read", "c_rshape"]),
        tf_const("c_rshape", np.asarray([1, d], np.int32)),
        tf_node("mm", "MatMul", ["rrow", "enter_W"]),
        tf_node("act", "Tanh", ["mm"]),
        tf_node("vrow", "Reshape", ["act", "c_vshape"]),
        tf_const("c_vshape", np.asarray([d], np.int32)),
        tf_node("write", "TensorArrayWriteV3",
                ["enter_hy", "sw_i:1", "vrow", "sw_fy:1"]),
        tf_node("nextit_i", "NextIteration", ["add_i"]),
        tf_node("nextit_fy", "NextIteration", ["write"]),
        tf_node("exit_fy", "Exit", ["sw_fy"]),
        tf_node("gather", "TensorArrayGatherV3",
                ["ta_y", "c_range", "exit_fy"])]


def dynamic_loop_graph(limit=100.0):
    """The CPU tests' data-dependent loop: x doubles while sum(x) <
    ``limit``; output ``exit_x`` on ``x``."""
    import numpy as np
    f = b"wloop"
    return [
        tf_node("x", "Placeholder"),
        tf_const("c_lim", np.float32(limit)),
        tf_node("enter_x", "Enter", ["x"], frame_name=f),
        tf_node("enter_lim", "Enter", ["c_lim"], frame_name=f,
                is_constant=True),
        tf_node("merge_x", "Merge", ["enter_x", "nextit_x"]),
        tf_node("sum", "Sum", ["merge_x", "c_axes"]),
        tf_const("c_axes", np.asarray([0], np.int32)),
        tf_node("less", "Less", ["sum", "enter_lim"]),
        tf_node("lc", "LoopCond", ["less"]),
        tf_node("sw_x", "Switch", ["merge_x", "lc"]),
        tf_node("dbl", "Mul", ["sw_x:1", "c_two"]),
        tf_const("c_two", np.float32(2.0)),
        tf_node("nextit_x", "NextIteration", ["dbl"]),
        tf_node("exit_x", "Exit", ["sw_x"])]


def switch_merge_graph():
    """The CPU tests' tf.cond graph: ``merge`` is 10 x on ``pred``, -x
    otherwise; inputs ``x`` and ``pred``."""
    import numpy as np
    return [
        tf_node("x", "Placeholder"), tf_node("pred", "Placeholder"),
        tf_node("sw", "Switch", ["x", "pred"]),
        tf_node("neg", "Neg", ["sw"]),
        tf_node("big", "Mul", ["sw:1", "c10"]),
        tf_const("c10", np.float32(10.0)),
        tf_node("merge", "Merge", ["neg", "big"])]


# BERT-base (bert_config.json of uncased_L-12_H-768_A-12) at
# run_classifier.py's max_seq_length, 2 classes
TF_BERT = dict(n_layers=12, hidden=768, heads=12, ffn=3072, vocab=30522,
               seq=128, classes=2)
TF_VGG_IMAGE = 224
TF_BERT_STEPS = 5             # Adam(5e-5) steps at run_classifier's batch
TF_BERT_BATCH = 32
TF_BERT_LR = 5e-5
TF_VGG_STEPS = 3              # SGD steps at train_image_classifier's batch
TF_VGG_BATCH = 32
TF_VGG_LR = 0.01
TF_OUT_REL = 1e-4             # card logits against the CPU's, x max|CPU|
TF_SEED = 22


def _tf_dataset(x, y, batch):
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
    recs = [Sample.from_ndarray(f, l) for f, l in zip(x, y)]
    return DataSet.array(recs) >> SampleToMiniBatch(batch)


def _tf_predict(torch, graph, x):
    """``graph``'s float32 outputs on the numpy batch ``x`` in evaluation
    mode, as a CPU tensor (the graph is left in training mode)."""
    from bigdl_tpu_torch.ops.tf_ops import as_tensor
    dev = next(graph.parameters()).device
    graph.evaluate()
    with torch.no_grad():
        y = graph(as_tensor(x, dev)).float().cpu()
    graph.train()
    return y


def _tf_loss(torch, graph, crit, x, y):
    out = _tf_predict(torch, graph, x)
    return float(crit(out, torch.from_numpy(y)))


def _load_tf_bert(torch, kernels, smi, root):
    """BERT-base's fine-tuning graph from a GraphDef and an .npy
    directory (see the module docstring's load_tf)."""
    import numpy as np
    from bigdl_tpu_torch.interop import load_tf
    from bigdl_tpu_torch.interop.tf_session import TFTrainingSession
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import Adam, Trigger
    t0 = time.perf_counter()
    nodes, var = bert_tf_graph(seed=TF_SEED, **TF_BERT)
    pb = f"{root}/bert_classifier.pb"
    with open(pb, "wb") as f:
        f.write(tf_graphdef(nodes))
    npy_bytes = write_npy_dir(root, var)
    n_params = sum(a.size for a in var.values())
    del var
    write_s = time.perf_counter() - t0
    rng = np.random.default_rng(TF_SEED)
    vocab, seq = TF_BERT["vocab"], TF_BERT["seq"]
    ids2 = rng.integers(0, vocab, (2, seq)).astype(np.int32)
    out = ["output/logits"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph = load_tf(pb, ["input_ids"], out, bin_dir=root,
                    sample_input=ids2[:1])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cpu = load_tf(pb, ["input_ids"], out, bin_dir=root,
                  sample_input=ids2[:1], device="cpu")
    want = _tf_predict(torch, cpu, ids2)
    _reset_flash_counts()
    got = _tf_predict(torch, graph, ids2)
    rel = _out_rel(got, want)
    check(rel <= TF_OUT_REL, f"load_tf bert: card logits differ from the "
                             f"CPU's by {rel}")
    del graph
    torch.cuda.empty_cache()
    # the session without sample_input: the weights are applied when
    # training starts; one Adam step at learning rate 0 keeps them
    crit = CrossEntropyCriterion()
    sess = TFTrainingSession(pb, ["input_ids"], out, bin_dir=root)
    y2 = np.asarray([0, 1], np.int32)
    sess.train(_tf_dataset(ids2, y2, 2), crit, Adam(learningrate=0.0),
               Trigger.max_iteration(1))
    lr0 = _out_rel(torch.from_numpy(sess.predict(ids2, batch_size=2)), want)
    check(lr0 <= TF_OUT_REL, f"load_tf bert: after a learning-rate-0 step "
                             f"the predictions differ from the CPU's by "
                             f"{lr0}")
    n = TF_BERT_BATCH * TF_BERT_STEPS
    x = rng.integers(0, vocab, (n, seq)).astype(np.int32)
    y = rng.integers(0, 2, n).astype(np.int32)
    before = _tf_loss(torch, sess.graph, crit, x[:TF_BERT_BATCH],
                      y[:TF_BERT_BATCH])
    ds = _tf_dataset(x, y, TF_BERT_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sess.train(ds, crit, Adam(learningrate=TF_BERT_LR),
               Trigger.max_iteration(TF_BERT_STEPS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    after = _tf_loss(torch, sess.graph, crit, x[:TF_BERT_BATCH],
                     y[:TF_BERT_BATCH])
    check(np.isfinite([before, after]).all(),
          f"load_tf bert: losses {before}, {after}")
    profile = _profile(torch, lambda: sess.train(
        _tf_dataset(x[:2 * TF_BERT_BATCH], y[:2 * TF_BERT_BATCH],
                    TF_BERT_BATCH), crit, Adam(learningrate=TF_BERT_LR),
        Trigger.max_iteration(2)))
    flash = _flash_counts()
    check(all(v == 0 for c in flash.values() for v in c.values()),
          f"load_tf bert: the imported BERT launched flash kernels {flash}")
    step_s = wall / TF_BERT_STEPS
    line = {"phase": "load_tf", "part": "bert_base_tf", **TF_BERT,
            "params": int(n_params),
            "graph_nodes": len(nodes), "npy_bytes": npy_bytes,
            "write_s": write_s, "load_s": load_s,
            "out_rel_vs_cpu": rel, "lr0_step_out_rel_vs_cpu": lr0,
            "out_rel_bar": TF_OUT_REL, "batch": TF_BERT_BATCH,
            "optimizer": f"Adam({TF_BERT_LR})", "steps": TF_BERT_STEPS,
            "loss_before": before, "loss_after": after,
            "step_s": step_s,
            "sequences_per_s": TF_BERT_BATCH / step_s,
            "peak_memory_bytes": peak, "flash_launches": flash,
            "device_busy_share": profile.get("device_busy_share",
                                             "not measured"),
            "card": smi}
    emit(line)
    emit({"phase": "profile", "path": "load_tf_bert", "steps": 2,
          **profile})
    for name, n in flash.items():
        kernels[name].setdefault("launches_by_phase", {})[
            "load_tf_bert"] = n
    del sess, cpu
    torch.cuda.empty_cache()


def _load_tf_vgg(torch, kernels, smi, root):
    """TF-slim's vgg_16 from a GraphDef and an .npy directory, trained
    through TFTrainingSession (see the module docstring's load_tf)."""
    import os

    import numpy as np
    from bigdl_tpu_torch.interop import load_tf
    from bigdl_tpu_torch.interop.tf_session import TFTrainingSession
    from bigdl_tpu_torch.models import conv_routes, model_flops
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import SGD, Trigger
    sub = f"{root}/vgg"
    os.makedirs(sub)
    t0 = time.perf_counter()
    hw = TF_VGG_IMAGE
    nodes, var = vgg16_tf_graph(image=hw, seed=TF_SEED)
    pb = f"{sub}/vgg_16.pb"
    with open(pb, "wb") as f:
        f.write(tf_graphdef(nodes))
    npy_bytes = write_npy_dir(sub, var)
    del var
    write_s = time.perf_counter() - t0
    out = ["vgg_16/fc8/squeezed"]
    rng = np.random.default_rng(TF_SEED + 1)
    x2 = rng.standard_normal((2, hw, hw, 3), dtype=np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess = TFTrainingSession(pb, ["input"], out, bin_dir=sub,
                             sample_input=(1, hw, hw, 3))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    graph = sess.graph
    cpu = load_tf(pb, ["input"], out, bin_dir=sub, device="cpu")
    from bigdl_tpu_torch.interop.tf_loader import apply_tf_weights
    apply_tf_weights(cpu)
    want = _tf_predict(torch, cpu, x2)
    del cpu
    rel = _out_rel(_tf_predict(torch, graph, x2), want)
    check(rel <= TF_OUT_REL, f"load_tf vgg_16: card logits differ from the "
                             f"CPU's by {rel}")
    split = conv_routes(graph, (hw, hw), torch.float32)
    n = TF_VGG_BATCH * TF_VGG_STEPS
    x = rng.standard_normal((n, hw, hw, 3), dtype=np.float32)
    y = rng.integers(0, 1000, n).astype(np.int32)
    crit = CrossEntropyCriterion()
    before = _tf_loss(torch, graph, crit, x[:8], y[:8])
    ds = _tf_dataset(x, y, TF_VGG_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_conv_counts()
    t0 = time.perf_counter()
    sess.train(ds, crit, SGD(learningrate=TF_VGG_LR),
               Trigger.max_iteration(TF_VGG_STEPS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _conv_counts()
    peak = torch.cuda.max_memory_allocated()
    _check_routes("load_tf vgg_16", counts, split, TF_VGG_STEPS)
    after = _tf_loss(torch, graph, crit, x[:8], y[:8])
    check(np.isfinite([before, after]).all(),
          f"load_tf vgg_16: losses {before}, {after}")
    step_s = wall / TF_VGG_STEPS
    flops = 3 * model_flops(graph, (hw, hw)) * TF_VGG_BATCH
    profile = _profile(torch, lambda: sess.train(
        _tf_dataset(x[:2 * TF_VGG_BATCH], y[:2 * TF_VGG_BATCH],
                    TF_VGG_BATCH), crit, SGD(learningrate=TF_VGG_LR),
        Trigger.max_iteration(2)), groups=CNN_KERNEL_GROUPS)
    emit({"phase": "load_tf", "part": "vgg_16_tf", "format": "NHWC",
          "graph_nodes": len(nodes), "pb_bytes": os.path.getsize(pb),
          "npy_bytes": npy_bytes, "write_s": write_s, "load_s": load_s,
          "out_rel_vs_cpu": rel, "out_rel_bar": TF_OUT_REL,
          "batch": TF_VGG_BATCH, "compute_dtype": "float32",
          "optimizer": f"SGD({TF_VGG_LR})", "steps": TF_VGG_STEPS,
          "loss_before": before, "loss_after": after,
          "conv_routes_per_step": split, "launches": counts,
          "step_s": step_s, "images_per_s": TF_VGG_BATCH / step_s,
          "model_flops_per_step": flops,
          "mfu_vs_float32_peak": flops / step_s
          / PEAK_FLOPS_PER_S["float32"], "peak_memory_bytes": peak,
          "device_busy_share": profile.get("device_busy_share",
                                           "not measured"),
          "conv3x3_share_of_device_time": _conv3x3_share(profile),
          "card": smi})
    emit({"phase": "profile", "path": "load_tf_vgg_16", "steps": 2,
          **profile})
    for kind in ("k9", "i2c"):
        kernels[f"conv3x3_{kind}"].setdefault("launches_by_phase", {})[
            "load_tf_vgg_16"] = {"tensor_cores": counts[kind],
                                 "cuda_cores": counts[f"{kind}_cuda_core"]}
    del sess, graph
    torch.cuda.empty_cache()


def _load_tf_control(torch, smi):
    """The CPU tests' counter, TensorArray, dynamic and Switch/Merge
    graphs on the card against the CPU."""
    import numpy as np
    from bigdl_tpu_torch.interop import load_tf
    from bigdl_tpu_torch.interop.tf_loader import _TFWhileModule
    from bigdl_tpu_torch.utils.table import T
    rng = np.random.default_rng(TF_SEED + 2)
    w = (rng.standard_normal((3, 3)) * 0.5).astype(np.float32)
    cases = {"counter_loop": (counter_loop_graph(w, 3), ["x"], ["out"],
                              rng.standard_normal((2, 3), dtype=np.float32)),
             "tensorarray_loop": (tensorarray_loop_graph(w, 4), ["x"],
                                  ["gather"], rng.standard_normal(
                                      (4, 3), dtype=np.float32)),
             "dynamic_loop": (dynamic_loop_graph(), ["x"], ["exit_x"],
                              np.ones(4, np.float32))}
    line = {"phase": "load_tf", "part": "control_flow", "card": smi}
    for name, (nodes, ins, outs, x) in cases.items():
        gd = tf_graphdef(nodes)
        res, syncs = {}, {}
        for key, dev in (("cpu", "cpu"), ("card", "cuda")):
            g = load_tf(gd, ins, outs, sample_input=x, device=dev)
            with torch.no_grad():
                res[key] = g(torch.from_numpy(x).to(dev)).cpu()
            loops = [n.module for n in g.exec_order
                     if isinstance(n.module, _TFWhileModule)]
            syncs[key] = loops[0].host_syncs
        rel = _out_rel(res["card"], res["cpu"])
        check(rel <= TF_OUT_REL, f"load_tf {name}: card differs from the "
                                 f"CPU by {rel}")
        line[name] = {"out_rel_vs_cpu": rel, "host_syncs": syncs["card"]}
    check(line["dynamic_loop"]["host_syncs"] == 6,
          f"load_tf dynamic_loop: {line['dynamic_loop']['host_syncs']} "
          "host reads of the loop condition (1 forward of 4 ones to 128: "
          "6 reads)")
    g = load_tf(tf_graphdef(switch_merge_graph()), ["x", "pred"], ["merge"])
    x = torch.ones(2, 2, device="cuda")
    got = [g(T(x, torch.tensor(p, device="cuda"))).cpu() for p in (True,
                                                                   False)]
    check(torch.equal(got[0], torch.full((2, 2), 10.0))
          and torch.equal(got[1], torch.full((2, 2), -1.0)),
          f"load_tf switch_merge: {got}")
    line["switch_merge"] = "10 x on true, -x on false"
    emit(line)


def phase_load_tf(torch, kernels, smi):
    """BERT-base and TF-slim VGG-16 from GraphDefs and .npy directories
    written in the run, and the control-flow graphs (see module
    docstring)."""
    import tempfile
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _load_tf_control(torch, smi)
    with tempfile.TemporaryDirectory() as root:
        _load_tf_bert(torch, kernels, smi, root)
        _load_tf_vgg(torch, kernels, smi, root)


# ----------------------------------- load_tf_train (A.11(d)(2)(b))
TF_TRAIN_BATCH = 32           # train_image_classifier's batch
TF_TRAIN_CHECK_BATCH = 2      # card vs the CPU import
TF_TRAIN_EVALS = 3            # timed evaluations, after one warm-up
TF_TRAIN_LOSS_REL = 1e-5      # the loss against the CPU or autograd
# batch 2: how far (x max|CPU gradient|) the card may move a gradient
# output off the CPU's beyond how far it moves autograd's of the forward
# import (the graph's ops and autograd agree to ~4e-6 on either device)
TF_TRAIN_DEVICE_GAP = 1e-4
TF_SWEEP_REL = 1e-5           # the op sweep, card vs CPU, x max|CPU|
TF_SWEEP_WIDE = (2, 112, 128)  # its 3x3 Conv2DBackpropInput: VGG's conv2_2
# the training graph's nodes that convolve (the kernels' and the library's)
TF_TRAIN_CONV_OPS = ("SpatialConvolution", "ConvBackpropInput",
                     "ConvBackpropFilter")
# VGG-16's: 16 forward (13 3x3 and fc6-8), 15 input and 16 filter gradients
TF_TRAIN_CONV_NODES = 47
# VGG-16's route table an evaluation of its training graph: every
# Conv2DBackpropInput but conv1_1's on the flip kernels, fc6-8 forward and
# their input gradients on the library
TF_TRAIN_ROUTES = {"i2c": {"tc": 0, "simt": 4}, "k9": {"tc": 0, "simt": 21},
                   "library": 6}


def _grad_bar(got, want, noise):
    """train_cnn's rule for each pair of gradients: the larger of
    CNN_GRAD_REL of the largest magnitude and RESNET_NOISE_FACTOR times
    the noise floor; returns the record (worst relative difference, worst
    ratio to the bar, their gradients, how many sit on the noise floor)."""
    rec = {"grad_worst_rel": 0.0, "grad_worst": None,
           "grad_worst_vs_bar": 0.0, "grad_bar_worst": None,
           "grads_on_noise_floor": 0, "rel_and_noise_rel": {}}
    for name in want:
        top = max(float(want[name].abs().max()), 1e-30)
        diff = float((got[name] - want[name]).abs().max())
        rec["rel_and_noise_rel"][name] = [diff / top, noise[name] / top]
        bar = max(CNN_GRAD_REL * top, RESNET_NOISE_FACTOR * noise[name])
        rec["grads_on_noise_floor"] += bar > CNN_GRAD_REL * top
        if diff / top > rec["grad_worst_rel"]:
            rec["grad_worst_rel"], rec["grad_worst"] = diff / top, name
        if diff / bar > rec["grad_worst_vs_bar"]:
            rec["grad_worst_vs_bar"], rec["grad_bar_worst"] = diff / bar, name
    return rec


def _noise(base, runs):
    """Each gradient's largest move over ``runs`` (dicts like ``base``)."""
    return {k: max(float((r[k] - v).abs().max()) for r in runs)
            for k, v in base.items()}


def _conv_taps(graph):
    """Forward hooks on ``graph``'s convolution nodes that keep, by node
    name, the arguments each is called with and its output: ``(taps,
    handles)``."""
    taps, handles = {}, []
    for nd in graph.exec_order:
        if type(nd.module).__name__ in TF_TRAIN_CONV_OPS:
            def keep(mod, args, out, name=nd.module.get_name()):
                taps[name] = (args, out)
            handles.append(nd.module.register_forward_hook(keep))
    return taps, handles


def _conv_nodes_vs_cpu(torch, graph, taps):
    """Each convolution node of the card's ``graph`` called on the CPU
    run's arguments for it (``taps``), against the CPU's output: by node,
    the largest difference over the CPU output's largest magnitude. Every
    input is the same on both devices, so the card's rounding cannot move
    a pool or ReLU decision upstream, and a kernel fault shows at its
    size."""
    mods = {nd.module.get_name(): nd.module for nd in graph.exec_order}

    def card(v):
        if isinstance(v, (list, tuple)):
            return [card(e) for e in v]
        return v.cuda() if isinstance(v, torch.Tensor) else v

    rel = {}
    with torch.no_grad():
        for name, (args, out) in taps.items():
            y = mods[name](*card(args)).cpu()
            rel[name] = float((y - out).abs().max()) / max(
                float(out.abs().max()), 1e-30)
    return rel


def _library_3x3():
    """A context in which ``nn.conv``'s 3x3 route runs ``F.conv2d`` (cuDNN)
    instead of the kernels: the library witness of the card's rounding."""
    import contextlib

    import torch.nn.functional as F
    from bigdl_tpu_torch.nn import conv as nconv

    def library(x, weight, groups):
        return F.conv2d(x.permute(0, 3, 1, 2), weight, None, 1, 1, 1,
                        groups).permute(0, 2, 3, 1)

    @contextlib.contextmanager
    def swapped():
        kernels, nconv._kernel_route = nconv._kernel_route, library
        try:
            yield
        finally:
            nconv._kernel_route = kernels

    return swapped()


def _tf_scaled(torch, images):
    """The graph's ``Cast`` and ``Mul`` by 1/255 of uint8 images."""
    import numpy as np
    return torch.from_numpy(images).float() * float(np.float32(1 / 255))


def _tf_autograd(torch, fwd, names, images_f, labels):
    """The loss and, by name in TF's layout, the gradients of the mean
    softmax cross entropy of the forward import ``fwd`` on float images,
    by autograd, on ``fwd``'s device."""
    dev = next(fwd.parameters()).device
    mods = {nd.module.get_name(): nd.module for nd in fwd.exec_order}
    leaves = [mods[f"{k.rsplit('/', 1)[0]}/Conv2D"].weight
              if k.endswith("weights")
              else mods[f"{k.rsplit('/', 1)[0]}/BiasAdd"].bias
              for k in names]
    n = len(labels)
    logits = fwd(images_f.to(dev)).reshape(n, -1)
    onehot = torch.nn.functional.one_hot(
        torch.from_numpy(labels).long().to(dev), logits.shape[1]).float()
    lv = -(onehot * torch.log_softmax(logits, -1)).sum(-1).mean()
    gs = torch.autograd.grad(lv, leaves)
    return float(lv.detach()), {
        k: (g.permute(2, 3, 1, 0) if g.dim() == 4 else g).float().cpu()
        for k, g in zip(names, gs)}


def _load_tf_train_vgg(torch, kernels, smi, root):
    """TF-slim vgg_16's training graph fed from a TFRecord (see the module
    docstring's load_tf_train)."""
    import os

    import numpy as np
    from bigdl_tpu_torch.interop import (TFRecordWriter, load_tf,
                                         tf_record_iterator)
    from bigdl_tpu_torch.interop.tf_loader import apply_tf_weights
    from bigdl_tpu_torch.models import conv_routes, model_flops
    from bigdl_tpu_torch.utils.shape import _cpu_copy
    hw, n = TF_VGG_IMAGE, TF_TRAIN_BATCH
    t0 = time.perf_counter()
    pbs = {}
    for key, batch in (("check", TF_TRAIN_CHECK_BATCH), ("train", n)):
        nodes, var, grads = vgg16_tf_train_graph(image=hw, batch=batch,
                                                 seed=TF_SEED)
        pbs[key] = f"{root}/vgg_16_train_{key}.pb"
        with open(pbs[key], "wb") as f:
            f.write(tf_graphdef(nodes))
    pbs["forward"] = f"{root}/vgg_16.pb"
    with open(pbs["forward"], "wb") as f:
        f.write(tf_graphdef(vgg16_tf_graph(image=hw, seed=TF_SEED)[0]))
    npy_bytes = write_npy_dir(root, var)
    names = list(var)
    del var
    write_s = time.perf_counter() - t0
    rng = np.random.default_rng(TF_SEED + 3)
    images = rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)
    labels = rng.integers(0, CNN_CLASSES, n)
    path = f"{root}/train.tfrecord"
    t0 = time.perf_counter()
    with TFRecordWriter(path) as w:
        for im, lab in zip(images, labels):
            w.write_example({"image/class/label": np.asarray([lab]),
                             "image/raw": im.tobytes()})
    record_write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    serialized = np.asarray(list(tf_record_iterator(path)), dtype=object)
    record_read_s = time.perf_counter() - t0
    check(len(serialized) == n, f"load_tf_train: {len(serialized)} records")
    data = bytearray(open(path, "rb").read())
    data[12 + len(serialized[0]) // 2] ^= 0x01     # a byte of record 0
    with open(f"{path}.flipped", "wb") as f:
        f.write(bytes(data))
    try:
        list(tf_record_iterator(f"{path}.flipped"))
        corrupt = "read without error"
    except IOError as e:
        corrupt = f"IOError: {e}"
    check(corrupt.startswith("IOError"),
          f"load_tf_train: a flipped payload byte was {corrupt}")
    outs = ["Mean", "xent/Reshape", "Reshape"] + grads

    def as_dict(ys):
        return {k: v.float().cpu() for k, v in zip(names, ys[3:])}

    # batch 2: the card against the port's CPU import of the same bytes
    m = TF_TRAIN_CHECK_BATCH
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph = load_tf(pbs["check"], ["serialized"], outs, bin_dir=root,
                    sample_input=serialized[:m])
    torch.cuda.synchronize()
    check_load_s = time.perf_counter() - t0
    cpu = load_tf(pbs["check"], ["serialized"], outs, bin_dir=root,
                  device="cpu")
    apply_tf_weights(cpu)
    taps, handles = _conv_taps(cpu)
    with torch.no_grad():
        got = [v.cpu() for v in graph(serialized[:m])]
        want = cpu(serialized[:m])
    for h in handles:
        h.remove()
    logits_rel = _out_rel(got[1], want[1])
    check(logits_rel <= TF_OUT_REL, f"load_tf_train: card logits differ "
                                    f"from the CPU's by {logits_rel}")
    loss_rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
    check(loss_rel <= TF_TRAIN_LOSS_REL,
          f"load_tf_train: batch-2 loss differs from the CPU's by {loss_rel}")
    check(torch.equal(got[2], torch.from_numpy(images[:m])),
          "load_tf_train: the card's decoded images are not the written "
          "bytes")
    # every convolution of the graph, forward and gradient, on the CPU
    # run's own inputs for it
    node_rel = _conv_nodes_vs_cpu(torch, graph, taps)
    node_worst = max(node_rel, key=node_rel.get)
    # the forward ones again with cuDNN in the kernels' place: each
    # route's rounding on the same inputs
    with _library_3x3():
        node_lib = _conv_nodes_vs_cpu(
            torch, graph, {k: v for k, v in taps.items()
                           if k.endswith("/Conv2D")})
    check(len(node_rel) == TF_TRAIN_CONV_NODES
          and node_rel[node_worst] <= TF_SWEEP_REL,
          f"load_tf_train: {len(node_rel)} convolution nodes; the card's "
          f"{node_worst} on the CPU's inputs is off the CPU's output by "
          f"{node_rel[node_worst]} of its largest magnitude")
    del graph, cpu, taps
    torch.cuda.empty_cache()
    # the port's autograd of the forward import (PR 22's path) on both
    # devices: the card moves it off the CPU as it moves the graph
    fwd = load_tf(pbs["forward"], ["input"], ["vgg_16/fc8/squeezed"],
                  bin_dir=root)
    apply_tf_weights(fwd)
    fwd_cpu = _cpu_copy(fwd)
    x2 = _tf_scaled(torch, images[:m])
    auto_card = _tf_autograd(torch, fwd, names, x2, labels[:m])[1]
    # the same on the card with the 3x3 kernels swapped for cuDNN
    _reset_conv_counts()
    with _library_3x3():
        auto_lib = _tf_autograd(torch, fwd, names, x2, labels[:m])[1]
    lib_counts = _conv_counts()
    check(not any(lib_counts[k] for k in ("k9", "i2c", "k9_cuda_core",
                                          "i2c_cuda_core")),
          f"load_tf_train: the library witness launched kernels "
          f"{lib_counts}")
    t0 = time.perf_counter()
    auto_cpu = _tf_autograd(torch, fwd_cpu, names, x2, labels[:m])[1]
    # the CPU's noise floor under a 2^-23 change of the images (autograd
    # and the graph's gradient ops agree to ~1e-6 on the CPU)
    moved = [_tf_autograd(torch, fwd_cpu, names, _perturbed(torch, x2, s),
                          labels[:m])[1] for s in (0, 1)]
    cpu_noise_s = time.perf_counter() - t0
    del fwd_cpu
    base = as_dict(want)
    got = as_dict(got)
    noise = _noise(auto_cpu, moved)
    rec2 = _grad_bar(got, base, noise)
    rec2["conv_nodes_vs_cpu_worst"] = node_rel[node_worst]
    rec2["conv_nodes_vs_cpu_worst_node"] = node_worst
    rec2["conv_nodes_vs_cpu"] = node_rel
    rec2["forward_nodes_vs_cpu_library"] = node_lib
    lib = _grad_bar(auto_lib, auto_cpu, noise)
    rec2["library_card_vs_cpu_worst_rel"] = lib["grad_worst_rel"]
    rec2["library_card_vs_cpu_worst_vs_bar"] = lib["grad_worst_vs_bar"]
    rec2["library_card_vs_cpu_rel"] = {
        k: v[0] for k, v in lib["rel_and_noise_rel"].items()}
    # held: the card's gradient outputs are off the CPU's exactly as far as
    # the card's autograd is off the CPU's autograd (train_cnn's rule, in
    # rec2, misses the device's pool and ReLU decision flips in block 5 at
    # this batch, for both paths alike)
    same = {}
    for k, c in base.items():
        top = max(float(c.abs().max()), 1e-30)
        same[k] = float(((got[k] - c) - (auto_card[k] - auto_cpu[k]))
                        .abs().max()) / top
    rec2["device_gap_vs_autograds"] = max(same.values())
    rec2["device_gap_vs_autograds_worst"] = max(same, key=same.get)
    rec2["autograd_card_vs_cpu_rel"] = {
        k: float((auto_card[k] - v).abs().max())
        / max(float(v.abs().max()), 1e-30) for k, v in auto_cpu.items()}
    print(f"load_tf_train batch 2 card vs CPU: {json.dumps(rec2)}",
          flush=True)
    check(rec2["device_gap_vs_autograds"] <= TF_TRAIN_DEVICE_GAP,
          f"load_tf_train: the card moves the gradient of "
          f"{rec2['device_gap_vs_autograds_worst']} off the CPU's by "
          f"{rec2['device_gap_vs_autograds']} of its largest magnitude more "
          "than it moves autograd's")
    del got, want, base, moved, auto_card, auto_cpu, auto_lib
    # batch 32 on the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph = load_tf(pbs["train"], ["serialized"], outs, bin_dir=root)
    apply_tf_weights(graph)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    split = conv_routes(graph, (hw, hw), torch.float32)
    check(split == TF_TRAIN_ROUTES,
          f"load_tf_train: route table {split}, not {TF_TRAIN_ROUTES}")
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        t0 = time.perf_counter()
        ys = graph(serialized)
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        _reset_conv_counts()
        t0 = time.perf_counter()
        for _ in range(TF_TRAIN_EVALS):
            ys = graph(serialized)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = _conv_counts()
    peak = torch.cuda.max_memory_allocated()
    _check_routes("load_tf_train vgg_16", counts, split, TF_TRAIN_EVALS)
    check(torch.equal(ys[2].cpu(), torch.from_numpy(images)),
          "load_tf_train: the decoded batch is not the written images")
    loss = float(ys[0])
    graph_grads = as_dict(ys)
    del ys
    profile = _profile(torch, lambda: _no_grad_runs(torch, graph,
                                                    serialized, 2),
                       groups=CNN_KERNEL_GROUPS)
    # against autograd of the forward import, same weights and batch; the
    # noise floor is the card's own under a 2^-23 change of the images
    flops = 3 * model_flops(fwd, (hw, hw)) * n
    x = _tf_scaled(torch, images)
    loss_a, auto = _tf_autograd(torch, fwd, names, x, labels)
    moved = [_tf_autograd(torch, fwd, names, _perturbed(torch, x, s),
                          labels)[1] for s in (0, 1)]
    loss_rel_a = abs(loss - loss_a) / abs(loss_a)
    check(loss_rel_a <= TF_TRAIN_LOSS_REL,
          f"load_tf_train: the graph's loss {loss} is not autograd's "
          f"{loss_a}")
    rec32 = _grad_bar(graph_grads, auto, _noise(auto, moved))
    print(f"load_tf_train batch 32 vs autograd: {json.dumps(rec32)}",
          flush=True)
    check(rec32["grad_worst_vs_bar"] <= 1.0,
          f"load_tf_train: the graph's gradient of {rec32['grad_bar_worst']}"
          f" is {rec32['grad_worst_vs_bar']} times its bar against "
          "autograd")
    eval_s = wall / TF_TRAIN_EVALS
    emit({"phase": "load_tf_train", "part": "vgg_16_tf_train",
          "format": "NHWC", "graph_outputs": len(outs),
          "npy_bytes": npy_bytes, "write_s": write_s,
          "record_bytes": os.path.getsize(path),
          "record_write_s": record_write_s, "record_read_s": record_read_s,
          "flipped_byte": corrupt, "check_batch": m,
          "check_load_s": check_load_s, "load_s": load_s,
          "logits_rel_vs_cpu": logits_rel, "loss_rel_vs_cpu": loss_rel,
          "grads_vs_cpu": rec2, "cpu_noise_s": cpu_noise_s, "batch": n,
          "compute_dtype": "float32", "loss": loss,
          "loss_rel_vs_autograd": loss_rel_a, "grads_vs_autograd": rec32,
          "conv_routes_per_eval": split, "launches": counts,
          "evals": TF_TRAIN_EVALS, "warmup_s": warmup_s,
          "ms_per_eval": 1e3 * eval_s, "images_per_s": n / eval_s,
          "model_flops_per_eval": flops,
          "mfu_vs_float32_peak": flops / eval_s
          / PEAK_FLOPS_PER_S["float32"], "peak_memory_bytes": peak,
          "device_busy_share": profile.get("device_busy_share",
                                           "not measured"),
          "conv3x3_share_of_device_time": _conv3x3_share(profile),
          "card": smi})
    emit({"phase": "profile", "path": "load_tf_train_vgg_16", "evals": 2,
          **profile})
    for kind in ("k9", "i2c"):
        kernels[f"conv3x3_{kind}"].setdefault("launches_by_phase", {})[
            "load_tf_train_vgg_16"] = {
                "tensor_cores": counts[kind],
                "cuda_cores": counts[f"{kind}_cuda_core"]}
    del graph, fwd
    torch.cuda.empty_cache()


def _no_grad_runs(torch, graph, x, k):
    with torch.no_grad():
        for _ in range(k):
            graph(x)


def _load_tf_sweep(torch, smi):
    """tf_grad_sweep_graph on the card against the CPU import."""
    import numpy as np
    from bigdl_tpu_torch.interop import load_tf
    from bigdl_tpu_torch.models import conv_routes
    nodes, ins, outs, feed = tf_grad_sweep_graph(TF_SEED,
                                                 wide=TF_SWEEP_WIDE)
    gd = tf_graphdef(nodes)
    res = {}
    for key, dev in (("cpu", "cpu"), ("card", "cuda")):
        g = load_tf(gd, ins, outs, bin_dir=None, device=dev)
        xs = [torch.from_numpy(a).to(dev) if a.dtype != object else a
              for a in feed]
        if key == "card":
            split = conv_routes(g, (5, 5), torch.float32)
            _reset_conv_counts()
        with torch.no_grad():
            ys = g(xs, generator=torch.Generator(device=dev).manual_seed(7))
        res[key] = [y.cpu() if isinstance(y, torch.Tensor) else y
                    for y in ys]
    counts = _conv_counts()
    _check_routes("load_tf_train sweep", counts, split, 1)
    check(split["k9"]["simt"] == 1 and split["i2c"]["simt"] == 8,
          f"load_tf_train sweep: routes {split} (the wide flip on k9, the "
          "depthwise one's 8 groups on i2c)")
    worst, rows = {}, feed[ins.index("rows")]
    for name, c, t in zip(outs, res["cpu"], res["card"]):
        if name == "RandomShuffle":
            want = torch.from_numpy(rows[np.argsort(rows[:, 0])])
            check(torch.equal(t[torch.argsort(t[:, 0])], want),
                  "load_tf_train sweep: RandomShuffle is not a row "
                  "permutation of its input")
            continue
        if isinstance(c, np.ndarray):
            check(c.tolist() == t.tolist(),
                  f"load_tf_train sweep: {name} differs on the card")
            continue
        if not c.is_floating_point():
            check(torch.equal(c, t), f"load_tf_train sweep: {name} {t} "
                                     f"is not the CPU's {c}")
            continue
        worst[name] = _out_rel(t, c) if c.numel() else 0.0
        check(worst[name] <= TF_SWEEP_REL,
              f"load_tf_train sweep: {name} differs from the CPU's by "
              f"{worst[name]}")
    ids = {}
    for key in ("cpu", "card"):
        from bigdl_tpu_torch.ops.tf_ops import CategoricalColHashBucket
        ids[key] = CategoricalColHashBucket(1000)(res[key][outs.index(
            "Substr")])
    check(np.array_equal(ids["cpu"], ids["card"]),
          "load_tf_train sweep: the hash buckets differ")
    emit({"phase": "load_tf_train", "part": "op_sweep", "ops": len(outs),
          "out_rel_vs_cpu": worst, "out_rel_bar": TF_SWEEP_REL,
          "conv_routes": split, "launches": counts,
          "hash_buckets": ids["card"].tolist(), "card": smi})


def phase_load_tf_train(torch, kernels, smi):
    """TF-slim VGG-16's training graph fed from a TFRecord written in the
    run, and the op sweep (see module docstring)."""
    import tempfile
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _load_tf_sweep(torch, smi)
    with tempfile.TemporaryDirectory() as root:
        _load_tf_train_vgg(torch, kernels, smi, root)


# ------------------------------------------------------------- resilience
# the no-fault phases' outputs (all 12 requests), by path: what the fault
# phases' greedy tokens are held to
# ------------------------------------------------------------- train_bert
BERT_VOCAB, BERT_SEED, BERT_MASK_P = 30522, 17, 0.15
# (part, batch, seq, timed steps): bench.py's BERT-Base MLM phases
BERT_PHASES = [("phase1", 128, 128, 5), ("phase2", 16, 512, 3)]
BERT_CPU_BATCH = (2, 128)
# examples/bert_sequence_parallel.py's dp 2 x sp 4, every shard on the card
BERT_SP_MESH = [["cuda:0"] * 4 for _ in range(2)]
BERT_SP_BATCH = (8, 512)
BERT_SP_FWD_TOL = dict(rtol=2e-4, atol=2e-5)    # the reference's sp bar
BERT_SP_STEP_REL = 1e-5                         # x max|w| a tensor
BERT_SP_ADAM_STEPS = 2
BERT_SEQ_MESH = ["cuda:0"] * 4                  # ring / Ulysses forms
BERT_SEQ_STEPS = 2
BERT_SEQ_LOSS_REL = 0.02
GPT_SP_BATCH = (1, 1024)                        # GPT-2 small, ring_inner


def _bert_batch(torch, rng, b, s, masked=True):
    """Seeded MLM inputs ``(x (b, s), y (b, s))`` on the card, the
    example's rule (``examples/bert_mlm_pretrain.py``): 15 % of tokens
    masked (the last vocabulary entry as [MASK]), label -1 elsewhere;
    ``masked=False``: every label the token itself."""
    import numpy as np
    tokens = rng.integers(0, BERT_VOCAB - 1, (b, s))
    if not masked:
        t = torch.from_numpy(tokens).cuda()
        return t, t.clone()
    pick = rng.random((b, s)) < BERT_MASK_P
    labels = np.where(pick, tokens, -1)
    tokens[pick] = BERT_VOCAB - 1
    return (torch.from_numpy(tokens).cuda(),
            torch.from_numpy(labels).cuda())


def _expect_flash(name, counts, path, n):
    """Each flash wrapper launched exactly ``n`` times on ``path``
    ("tensor_cores" or "cuda_cores") and never on the other."""
    for fn, c in counts.items():
        want = {p: n * (p == path) for p in c}
        check(c == want, f"{name}: {fn} launched {c}, expected {want}")


def _bert_model(torch, params, **kw):
    from bigdl_tpu_torch.models import BertForMLM
    model = BertForMLM(max_position=512, **kw)
    model.load_state_dict(params)
    return model


def _bert_timed(torch, step, opt_state, x, y, steps):
    """A warm-up step, then ``steps`` timed ones with the flash counts
    from 0: (losses, seconds a step, counts, warm-up seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step(opt_state, x, y)]
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    _reset_flash_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(step(opt_state, x, y))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return [float(v) for v in losses], wall / steps, _flash_counts(), \
        warmup_s


def _bert_mlm_phases(torch, params, smi, kernels, n_layers):
    """BertForMLM through ``make_train_step``, bfloat16 compute,
    ``Adam(1e-4)``, on each of BERT_PHASES from the seeded weights:
    finite, falling losses and exactly 12 tensor-core launches of each
    flash kernel a step. Returns {part: line}."""
    import numpy as np
    from bigdl_tpu_torch.models import bert_mlm_flops_per_token
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import Adam, make_train_step
    lines = {}
    for part, b, s, steps in BERT_PHASES:
        model = _bert_model(torch, params)
        x, y = _bert_batch(torch, np.random.default_rng(BERT_SEED), b, s)
        opt = Adam(learningrate=1e-4)
        opt_state = opt.init_state(dict(model.named_parameters()))
        step = make_train_step(model, CrossEntropyCriterion(), opt,
                               compute_dtype=torch.bfloat16)
        torch.cuda.reset_peak_memory_stats()
        losses, step_s, counts, warmup_s = _bert_timed(
            torch, step, opt_state, x, y.reshape(-1), steps)
        peak = torch.cuda.max_memory_allocated()
        check(all(np.isfinite(losses)), f"train_bert {part}: losses "
                                        f"{losses}")
        check(losses[-1] < losses[0], f"train_bert {part}: loss did not "
                                      f"fall: {losses}")
        _expect_flash(f"train_bert {part}", counts, "tensor_cores",
                      n_layers * steps)
        flops = 3 * bert_mlm_flops_per_token(s=s) * b * s
        profile = _profile(torch, lambda: [step(opt_state, x, y.reshape(-1))
                                           for _ in range(2)],
                           groups=GPT_BF16_KERNEL_GROUPS)
        flash = profile.get("groups", {}).get("flash tensor-core kernels",
                                              {})
        lines[part] = {
            "batch": b, "seq": s, "masked_labels": int((y >= 0).sum()),
            "losses": losses, "timed_steps": steps, "step_s": step_s,
            "tokens_per_s": b * s / step_s, "warmup_s": warmup_s,
            "model_flops_per_step": flops,
            "mfu_vs_bf16_peak": flops / step_s
            / PEAK_FLOPS_PER_S["bfloat16"],
            "peak_memory_bytes": peak, "flash_launches": counts,
            "device_busy_share": profile.get("device_busy_share",
                                             "not measured"),
            "flash_share_of_device_time": flash.get(
                "share_of_device_time", "not measured")}
        emit({"phase": "profile", "path": f"train_bert_{part}", "steps": 2,
              **profile})
        for name, c in counts.items():
            kernels[name].setdefault("launches_by_phase", {})[
                f"train_bert_{part}"] = c
        del model, step, opt_state
        torch.cuda.empty_cache()
    return lines


def _bert_vs_cpu(torch, params, n_layers):
    """float32 loss and gradients of one masked BERT_CPU_BATCH on the card
    against the port's CPU run (plain versions) on the same weights, with
    12 CUDA-core launches of each flash kernel."""
    import numpy as np
    from bigdl_tpu_torch.models import BertForMLM
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import make_loss_and_grads
    crit = CrossEntropyCriterion()
    x, y = _bert_batch(torch, np.random.default_rng(BERT_SEED + 1),
                       *BERT_CPU_BATCH)
    model = _bert_model(torch, params)
    _reset_flash_counts()
    loss_g, grads_g = make_loss_and_grads(model, crit)(x, y.reshape(-1))
    torch.cuda.synchronize()
    counts = _flash_counts()
    _expect_flash("train_bert cpu check", counts, "cuda_cores", n_layers)
    cpu = BertForMLM(max_position=512, device="cpu")
    cpu.load_state_dict(params)
    loss_c, grads_c = make_loss_and_grads(cpu, crit)(x.cpu(),
                                                     y.reshape(-1).cpu())
    rel = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    worst, worst_name = 0.0, None
    for name, gc in grads_c.items():
        ratio = (float((grads_g[name].cpu() - gc).abs().max())
                 / max(float(gc.abs().max()), 1e-30))
        if ratio > worst:
            worst, worst_name = ratio, name
    check(rel <= 1e-4, f"train_bert: card vs CPU loss differs by {rel}")
    check(worst <= 1e-3, f"train_bert: card vs CPU gradient of {worst_name} "
                         f"differs by {worst} of its largest magnitude")
    del model, grads_g
    torch.cuda.empty_cache()
    return {"batch": list(BERT_CPU_BATCH), "loss_rel_diff": rel,
            "grad_worst_rel": worst, "grad_worst_param": worst_name,
            "flash_launches": counts}


def _replicas_identical(torch, step):
    master = dict(step.model.named_parameters())
    return all(torch.equal(p, master[n]) for row in step.replicas
               for r in row for n, p in r.named_parameters())


def _bert_dp_sp(torch, params, n_layers, kernels):
    """``make_sp_train_step`` at dp 2 x sp 4 on the card, float32,
    BERT_SP_BATCH (see the module docstring's train_bert)."""
    import numpy as np
    from bigdl_tpu_torch.models import (bert_mlm_flops_per_token,
                                        make_sp_train_step)
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import SGD, Adam, make_train_step
    dp, sp = len(BERT_SP_MESH), len(BERT_SP_MESH[0])
    b, s = BERT_SP_BATCH
    bl, tl = b // dp, s // sp
    ring_inner = ("ring_inner", "seq", sp)
    crit = CrossEntropyCriterion()
    per_step = dp * n_layers * sp * sp
    rng = np.random.default_rng(BERT_SEED + 2)
    x, y = _bert_batch(torch, rng, b, s, masked=False)

    # the forward against the plain model's, shard by shard
    plain = _bert_model(torch, params)
    model = _bert_model(torch, params, sequence_parallel=ring_inner)
    step = make_sp_train_step(model, crit, SGD(learningrate=0.1),
                              BERT_SP_MESH)
    with torch.no_grad():
        want = plain(x).reshape(b, s, -1)
        outs = step.forward(x)
        fwd_err = 0.0
        for d, row in enumerate(outs):
            for k, o in enumerate(row):
                ref = want[d * bl:(d + 1) * bl, k * tl:(k + 1) * tl]
                got = o.reshape(bl, tl, -1)
                fwd_err = max(fwd_err, float((got - ref).abs().max()))
                check(torch.allclose(got, ref, **BERT_SP_FWD_TOL),
                      f"train_bert dp x sp: shard ({d}, {k}) forward "
                      f"differs from the plain model's by {fwd_err}")
        del want, outs

    # one SGD(0.1) step on unpadded labels against make_train_step's
    method = SGD(learningrate=0.1)
    plain_step = make_train_step(plain, crit, method)
    loss_plain = float(plain_step(method.init_state(
        dict(plain.named_parameters())), x, y.reshape(-1)))
    opt_state = step.optim_method.init_state(dict(model.named_parameters()))
    loss_sp = float(step(opt_state, x, y))
    torch.cuda.synchronize()
    check(_replicas_identical(torch, step),
          "train_bert dp x sp: replicas differ after the SGD step")
    new_plain = dict(plain.named_parameters())
    sgd_worst, sgd_name = 0.0, None
    for name, p in model.named_parameters():
        w = new_plain[name]
        ratio = (float((p.detach() - w.detach()).abs().max())
                 / float(w.abs().max()))
        if ratio > sgd_worst:
            sgd_worst, sgd_name = ratio, name
    check(sgd_worst <= BERT_SP_STEP_REL,
          f"train_bert dp x sp: SGD step's {sgd_name} differs from the "
          f"plain step's by {sgd_worst} of its largest magnitude")
    loss_rel = abs(loss_sp - loss_plain) / abs(loss_plain)
    del step, plain, plain_step, model, opt_state
    torch.cuda.empty_cache()

    # Adam on masked labels: a warm-up and BERT_SP_ADAM_STEPS timed steps
    x, y = _bert_batch(torch, rng, b, s)
    model = _bert_model(torch, params, sequence_parallel=ring_inner)
    step = make_sp_train_step(model, crit, Adam(learningrate=1e-4),
                              BERT_SP_MESH)
    opt_state = step.optim_method.init_state(dict(model.named_parameters()))
    torch.cuda.reset_peak_memory_stats()
    # each step timed alone, the replicas compared after it
    losses, times, identical = [], [], []
    for i in range(1 + BERT_SP_ADAM_STEPS):
        if i == 1:
            _reset_flash_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(opt_state, x, y)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        identical.append(_replicas_identical(torch, step))
    counts = _flash_counts()
    warmup_s, step_s = times[0], sum(times[1:]) / BERT_SP_ADAM_STEPS
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"train_bert dp x sp: losses {losses}")
    check(all(identical), f"train_bert dp x sp: replicas differ after a "
                          f"step: {identical}")
    _expect_flash("train_bert dp x sp", counts, "cuda_cores",
                  per_step * BERT_SP_ADAM_STEPS)
    profile = _profile(torch, lambda: step(opt_state, x, y),
                       groups=GPT_BF16_KERNEL_GROUPS)
    emit({"phase": "profile", "path": "train_bert_dp_sp", "steps": 1,
          **profile})
    flash = profile.get("groups", {}).get("flash CUDA-core kernels", {})
    for name, c in counts.items():
        kernels[name].setdefault("launches_by_phase", {})[
            "train_bert_dp_sp"] = c
    del step, model, opt_state
    torch.cuda.empty_cache()
    return {"dp": dp, "sp": sp, "batch": b, "seq": s, "dtype": "float32",
            "forward_max_abs_err": fwd_err, "sgd_loss": loss_sp,
            "sgd_plain_loss": loss_plain, "sgd_loss_rel_diff": loss_rel,
            "sgd_weights_worst_rel": sgd_worst, "sgd_weights_worst": sgd_name,
            "adam_losses": losses, "timed_steps": BERT_SP_ADAM_STEPS,
            "step_s": step_s, "tokens_per_s": b * s / step_s,
            # every shard's queries attend over the whole sequence
            "mfu_vs_fp32_peak": 3 * bert_mlm_flops_per_token(s=s) * b * s
            / step_s / PEAK_FLOPS_PER_S["float32"],
            "warmup_s": warmup_s, "peak_memory_bytes": peak,
            "flash_launches": counts, "flash_launches_per_step": per_step,
            "replicas_identical": identical,
            "device_busy_share": profile.get("device_busy_share",
                                             "not measured"),
            "flash_share_of_device_time": flash.get(
                "share_of_device_time", "not measured")}


def _bert_seq_forms(torch, params, n_layers, loss_unsharded):
    """BertForMLM with ``("ulysses", BERT_SEQ_MESH)`` and ``("ring",
    BERT_SEQ_MESH)`` attention through ``make_train_step`` in bfloat16 on
    the phase-2 batch and weights: a warm-up and BERT_SEQ_STEPS timed
    steps each; the first loss within BERT_SEQ_LOSS_REL of the unsharded
    model's; 12 x 4 (Ulysses) and 12 x 16 (ring) tensor-core launches of
    each flash kernel a step."""
    import numpy as np
    from bigdl_tpu_torch.models import bert_mlm_flops_per_token
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import Adam, make_train_step
    _, b, s, _ = BERT_PHASES[1]
    n = len(BERT_SEQ_MESH)
    out = {}
    for kind, per_layer in (("ulysses", n), ("ring", n * n)):
        model = _bert_model(torch, params,
                            sequence_parallel=(kind, BERT_SEQ_MESH, "seq"))
        x, y = _bert_batch(torch, np.random.default_rng(BERT_SEED), b, s)
        opt = Adam(learningrate=1e-4)
        opt_state = opt.init_state(dict(model.named_parameters()))
        step = make_train_step(model, CrossEntropyCriterion(), opt,
                               compute_dtype=torch.bfloat16)
        torch.cuda.reset_peak_memory_stats()
        losses, step_s, counts, _ = _bert_timed(
            torch, step, opt_state, x, y.reshape(-1), BERT_SEQ_STEPS)
        peak = torch.cuda.max_memory_allocated()
        rel = abs(losses[0] - loss_unsharded) / loss_unsharded
        check(all(np.isfinite(losses)), f"train_bert {kind}: losses "
                                        f"{losses}")
        check(rel <= BERT_SEQ_LOSS_REL, f"train_bert {kind}: first loss "
              f"{losses[0]} vs the unsharded model's {loss_unsharded}")
        _expect_flash(f"train_bert {kind}", counts, "tensor_cores",
                      n_layers * per_layer * BERT_SEQ_STEPS)
        out[kind] = {"shards": n, "losses": losses,
                     "first_loss_rel_diff": rel, "step_s": step_s,
                     "tokens_per_s": b * s / step_s,
                     "mfu_vs_bf16_peak": 3 * bert_mlm_flops_per_token(s=s)
                     * b * s / step_s / PEAK_FLOPS_PER_S["bfloat16"],
                     "peak_memory_bytes": peak,
                     "flash_launches": counts,
                     "flash_launches_per_step": n_layers * per_layer}
        del model, step, opt_state
        torch.cuda.empty_cache()
    return out


def _gpt_ring_inner(torch, n_layers):
    """GPT-2 small at ``("ring_inner", "seq", 4)``, dp 1 x sp 4, float32,
    one GPT_SP_BATCH: the sp step's loss and gradients
    (``SequenceParallelStep.loss_and_grads``) against the plain model's
    on the card at ``train``'s bars; a causal ring of 4 runs 10 pairs a
    layer (4 causal, 6 full)."""
    import numpy as np
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.models import gpt2_small, make_sp_train_step
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import SGD, make_loss_and_grads
    sp = len(BERT_SEQ_MESH)
    crit = CrossEntropyCriterion()
    params = convert.init_params(gpt2_small(device="cpu"), seed=0)
    b, s = GPT_SP_BATCH
    ids = torch.from_numpy(np.random.default_rng(BERT_SEED + 3).integers(
        0, 50257, (b, s + 1))).cuda()
    x, y = ids[:, :-1].contiguous(), ids[:, 1:].contiguous()
    plain = gpt2_small()
    plain.load_state_dict(params)
    loss_p, grads_p = make_loss_and_grads(plain, crit)(x, y.reshape(-1))
    del plain
    model = gpt2_small(sequence_parallel=("ring_inner", "seq", sp))
    model.load_state_dict(params)
    step = make_sp_train_step(model, crit, SGD(learningrate=0.0),
                              [BERT_SEQ_MESH])
    _reset_flash_counts()
    loss_s, grads_s = step.loss_and_grads(x, y)
    torch.cuda.synchronize()
    counts = _flash_counts()
    pairs = sp * (sp + 1) // 2
    _expect_flash("train_bert gpt ring_inner", counts, "cuda_cores",
                  n_layers * pairs)
    rel = abs(float(loss_s) - float(loss_p)) / abs(float(loss_p))
    worst, worst_name = 0.0, None
    for name, gp in grads_p.items():
        ratio = (float((grads_s[name] - gp).abs().max())
                 / max(float(gp.abs().max()), 1e-30))
        if ratio > worst:
            worst, worst_name = ratio, name
    check(rel <= 1e-4, f"train_bert gpt ring_inner: loss differs by {rel}")
    check(worst <= 1e-3, f"train_bert gpt ring_inner: gradient of "
                         f"{worst_name} differs by {worst}")
    del step, model, grads_p, grads_s
    torch.cuda.empty_cache()
    return {"model": "gpt2_small", "dp": 1, "sp": sp, "batch": b, "seq": s,
            "dtype": "float32", "loss_rel_diff": rel,
            "grad_worst_rel": worst, "grad_worst_param": worst_name,
            "pairs_per_layer": pairs, "flash_launches": counts}


def phase_train_bert(torch, kernels, smi):
    """BERT-base (``BASELINE.json`` config 5; 12 layers, hidden 768, 12
    heads, vocabulary 30522) trained on the card: see the module
    docstring."""
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.models import BertForMLM
    t0 = time.perf_counter()
    params = convert.bert_params_from_jax(convert.init_bert_tree(
        BertForMLM(max_position=512, device="cpu"), seed=BERT_SEED))
    n_layers = 12
    setup_s = time.perf_counter() - t0
    mlm = _bert_mlm_phases(torch, params, smi, kernels, n_layers)
    cpu = _bert_vs_cpu(torch, params, n_layers)
    dp_sp = _bert_dp_sp(torch, params, n_layers, kernels)
    forms = _bert_seq_forms(torch, params, n_layers,
                            mlm["phase2"]["losses"][0])
    gpt = _gpt_ring_inner(torch, n_layers)
    emit({"phase": "train_bert", "model": "bert_base (BertForMLM)",
          "layers": n_layers, "hidden": 768, "heads": 12,
          "vocab": BERT_VOCAB, "optimizer": "Adam(1e-4)",
          "compute_dtype": "bfloat16", "setup_s": setup_s, **mlm,
          "cpu_check": cpu, "dp_sp": dp_sp, "seq_forms": forms,
          "gpt_ring_inner": gpt, "card": smi})


_NO_FAULT = {}
_CPU_MODEL = {}


def _cpu_top2_gap(torch, params, ids):
    """The top-2 gap of the port's CPU run's next-token logits after
    ``ids`` (the near-tie rule's yardstick at one divergence)."""
    from bigdl_tpu_torch.models.gpt import gpt2_small
    model = _CPU_MODEL.get("m")
    if model is None:
        model = gpt2_small(device="cpu")
        model.load_state_dict(params)
        model.requires_grad_(False)
        _CPU_MODEL["m"] = model
    with torch.no_grad():
        logits = model(torch.as_tensor(ids, dtype=torch.long)[None])[-1]
    top2 = torch.topk(logits.float(), 2).values
    return float(top2[0] - top2[1])


def _near_tie_check(torch, name, params, got, want, idx):
    """Requests ``idx``: ``got`` tokens equal ``want``'s, or first differ at
    a step where the CPU run's top-2 logit gap (on the prompt and
    ``want``'s tokens before it) is below FLOAT_GAP. Returns the
    divergences."""
    import numpy as np
    found = []
    for i in idx:
        g, w = np.asarray(got[i]), np.asarray(want[i])
        check(g.size == w.size, f"{name} request {i}: {g.size} tokens, "
                                f"{w.size} without the fault")
        miss = np.nonzero(g != w)[0]
        if not miss.size:
            continue
        step = int(miss[0])
        gap = _cpu_top2_gap(torch, params, w[:step])
        print(f"{name} request {i}: tokens diverge at position {step}, "
              f"CPU top-2 logit gap {gap}", flush=True)
        check(gap < FLOAT_GAP, f"{name} request {i} diverges at position "
                               f"{step} with a top-2 gap of {gap}")
        found.append({"request": i, "position": step, "gap": gap})
    return found


GREEDY_IDX = [i for i in range(12) if TEMPS[i] == 0.0]
# the recovery phase's plan: two consecutive step faults (the second lands
# in the recovery's own probe block, so the group is bisected), a third a
# while later (a second recovery), one admission fault; paged, two forced
# page exhaustions
RECOVERY_PLAN = ("serving.step:error:after=20:times=2;"
                 "serving.step:error:after=40:times=1;"
                 "serving.admit:error:times=1")
RECOVERY_PAGED = ";serving.page_alloc:error:after=30:times=2"
POISON_IDX = 5          # a greedy request, quarantined by a req= rule


class _FaultClock:
    """Times of fired faults (wrapping the harness's log hook) and of
    token deliveries (wrapping ``Request._deliver``), to read the seconds
    from each fault to the next delivered token."""

    def __init__(self):
        from bigdl_tpu_torch.resilience import faults
        from bigdl_tpu_torch.serving.scheduler import Request
        self.fired, self.delivered = [], []
        self._faults, self._request = faults, Request
        self._record, self._deliver = faults._record, Request._deliver
        clock = self

        def record(site, rule):
            clock.fired.append((time.perf_counter(), site))
            return clock._record(site, rule)

        def deliver(req, chunk):
            clock.delivered.append(time.perf_counter())
            return clock._deliver(req, chunk)

        faults._record = record
        Request._deliver = deliver

    def close(self):
        self._faults._record = self._record
        self._request._deliver = self._deliver

    def gaps(self):
        import bisect
        out = []
        for t, site in self.fired:
            j = bisect.bisect_right(self.delivered, t)
            out.append({"site": site, "s_to_next_token":
                        (self.delivered[j] - t)
                        if j < len(self.delivered) else None})
        return out


def _fault_run(torch, engine, prompts, plan, poison=None):
    """The 12-request traffic under the fault ``plan`` (armed after the
    warm-up; with ``poison``, the rule targets that request's id once it
    is submitted), counts set to 0 just before and read just after.
    Returns the outputs (None where a request failed), the errors, the
    run's record and the fault-to-token gaps."""
    from bigdl_tpu_torch.resilience import faults
    engine.generate(prompts[0][:80], 4, timeout=300)        # warm-up
    _reset_serving_counts()
    engine.stats.reset()
    retired0 = engine.metrics()["retired"]
    clock = _FaultClock()
    try:
        if poison is None:
            faults.configure(plan)
        t0 = time.perf_counter()
        handles = [engine.submit(prompts[i], N_NEW, temperature=TEMPS[i])
                   for i in range(12)]
        if poison is not None:
            faults.configure(plan.format(id=handles[poison].id))
        outs, errors = [], {}
        for i, h in enumerate(handles):
            try:
                outs.append(h.result(timeout=600))
            except Exception as e:    # noqa: BLE001 - held by the caller
                outs.append(None)
                errors[i] = repr(e)
        wall = time.perf_counter() - t0
        fired = faults.active_plan().counts()
    finally:
        faults.configure(None)
        clock.close()
    stats = engine.stats.snapshot()
    counts = _serving_counts()
    metrics = engine.metrics()
    line = {"wall_s": wall, "retired": metrics["retired"] - retired0,
            "failures": metrics["failures"],
            "recoveries": metrics["recoveries"],
            "quarantined": metrics["quarantined"],
            "preempted": metrics["preempted"],
            "faults_fired": {f"{s}:{k}": n for (s, k), n in fired.items()},
            "launches": counts, "decode_steps": stats["steps"],
            "sampled_steps": stats["sampled_steps"]}
    if engine.paged:
        line["prefill_chunks"] = stats["prefill_chunks"]
    return outs, errors, line, clock.gaps()


def phase_slice_recovery(torch, kernels, cpu_ref):
    """``slice``'s model, weights and traffic on the paged and the dense
    engine under RECOVERY_PLAN (see module docstring), then a poisoned
    request on the dense engine."""
    import numpy as np
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.models.gpt import gpt2_small
    from bigdl_tpu_torch.serving import ServingEngine

    model = gpt2_small()
    params = convert.init_params(model, seed=0)
    n_layers = len(model.gpt.layers)
    rng = np.random.default_rng(0)
    rng.integers(0, 50257, 80)          # _serve_traffic's warm-up draw
    prompts = _traffic(rng)
    cpu_toks, cpu_logits = cpu_ref
    lines = {}
    for path in ("paged", "dense"):
        paged = path == "paged"
        engine = ServingEngine(model, None if path == "dense" else params,
                               max_slots=8, paged=paged, page_size=16,
                               prefill_chunk=64, top_k=50, top_p=0.9,
                               seed=0)
        plan = RECOVERY_PLAN + (RECOVERY_PAGED if paged else "")
        try:
            outs, errors, line, gaps = _fault_run(torch, engine, prompts,
                                                  plan)
        finally:
            engine.shutdown()
        check(not errors, f"slice_recovery {path}: failed requests "
                          f"{errors}")
        check(line["retired"] == 12, f"slice_recovery {path}: "
                                     f"{line['retired']} of 12 retired")
        check(line["recoveries"] >= 2,
              f"slice_recovery {path}: {line['recoveries']} recoveries")
        for i, o in enumerate(outs):
            check(o.size == LENGTHS[i] + N_NEW,
                  f"slice_recovery {path} request {i}: "
                  f"{o.size - LENGTHS[i]} tokens")
        gen = [o[LENGTHS[i]:] for i, o in enumerate(outs)]
        base = [o[LENGTHS[i]:] for i, o in enumerate(_NO_FAULT[path])]
        div = _near_tie_check(torch, f"slice_recovery {path}", params,
                              outs, _NO_FAULT[path], GREEDY_IDX)
        cpu_div = _first_divergence(torch, f"slice_recovery {path}",
                                    _engine_greedy(outs), cpu_toks,
                                    cpu_logits, FLOAT_GAP)
        c = line["launches"]
        if paged:
            dispatches = line["prefill_chunks"] + line["decode_steps"]
            check(c["paged_attention"] == n_layers * dispatches,
                  f"slice_recovery paged: {c['paged_attention']} paged "
                  f"launches for {dispatches} chunks and steps")
            kernels["paged_attention"].setdefault("launches_by_phase", {})[
                "slice_recovery"] = c["paged_attention"]
        else:
            check(c["paged_attention"] == 0 and c["flash_fwd"] == 0,
                  f"slice_recovery dense launched {c}")
        check(c["fused_sampling"] == line["sampled_steps"],
              f"slice_recovery {path}: {c['fused_sampling']} sampler "
              f"launches for {line['sampled_steps']} sampled steps")
        kernels["fused_sampling"].setdefault("launches_by_phase", {})[
            f"slice_recovery_{path}"] = c["fused_sampling"]
        lines[path] = line
        emit({"phase": "slice_recovery", "path": path, "plan": plan,
              **line, "divergences_vs_no_fault": div,
              "divergences_vs_cpu": cpu_div,
              "exact_vs_no_fault": [bool(np.array_equal(gen[i], base[i]))
                                    for i in GREEDY_IDX],
              "fault_to_next_token": gaps})
        del engine
        torch.cuda.empty_cache()

    # a poisoned request on the dense engine: quarantined alone
    engine = ServingEngine(model, None, max_slots=8, top_k=50, top_p=0.9,
                           seed=0)
    plan = "serving.step:error:req={id}"
    try:
        outs, errors, line, gaps = _fault_run(torch, engine, prompts, plan,
                                              poison=POISON_IDX)
    finally:
        engine.shutdown()
    check(list(errors) == [POISON_IDX] and "FaultError" in
          errors[POISON_IDX], f"slice_recovery poison: errors {errors}")
    check(line["quarantined"] == 1 and line["retired"] == 11,
          f"slice_recovery poison: {line['quarantined']} quarantined, "
          f"{line['retired']} retired")
    others = [i for i in GREEDY_IDX if i != POISON_IDX]
    div = _near_tie_check(torch, "slice_recovery poison", params, outs,
                          _NO_FAULT["dense"], others)
    emit({"phase": "slice_recovery", "path": "dense_poisoned",
          "poisoned_request": POISON_IDX, **line,
          "divergences_vs_no_fault": div, "fault_to_next_token": gaps})
    del engine, model
    torch.cuda.empty_cache()
    return lines


STICKY_IDX = [0, 2, 6, 11]       # greedy requests of the traffic
STICKY_STEP = 3                  # the decode step that faults
STICKY_TIMEOUT_S = 90


def _sticky_child():
    """The child of ``slice_fault_sticky`` (``--sticky-child``): 4 of
    ``slice``'s requests on the paged engine; inside the third decode step
    an out-of-range index into a card tensor raises a device-side assert,
    a sticky CUDA error. Prints one JSON line with every handle's outcome
    and exits at once (``os._exit``: the process's CUDA context is
    unusable)."""
    import os

    import numpy as np
    import torch
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.models.gpt import gpt2_small
    from bigdl_tpu_torch.serving import ServingEngine

    model = gpt2_small()
    params = convert.init_params(model, seed=0)
    engine = ServingEngine(model, params, max_slots=8, paged=True,
                           page_size=16, prefill_chunk=64, seed=0)
    rng = np.random.default_rng(0)
    rng.integers(0, 50257, 80)
    prompts = _traffic(rng)
    state = {"steps": 0, "at_fault": None, "t_fault": None}
    handles = []
    real = engine.slots._decode

    def faulting_decode(tok, pos):
        state["steps"] += 1
        if state["steps"] == STICKY_STEP:
            state["at_fault"] = [len(h.tokens) for h in handles]
            state["t_fault"] = time.perf_counter()
            probe = torch.zeros(4, device=tok.device)
            probe[torch.full((1,), 1 << 30, device=tok.device,
                             dtype=torch.long)] = 1.0    # out of range
        return real(tok, pos)

    engine.slots._decode = faulting_decode
    t0 = time.perf_counter()
    submitted = [engine.submit(prompts[i], N_NEW) for i in STICKY_IDX]
    handles.extend(submitted)
    out = []
    for h in handles:
        ok = h.done.wait(STICKY_TIMEOUT_S - 10)
        err = h.error
        out.append({"resolved": ok, "error": type(err).__name__,
                    "cause": repr(getattr(err, "__cause__", None))[:300],
                    "tokens": len(h.tokens)})
    print(json.dumps({"sticky_child": out, "at_fault": state["at_fault"],
                      "steps": state["steps"],
                      "recoveries": engine.scheduler.recoveries,
                      "failed": repr(engine.scheduler.failed)[:300],
                      "resolve_s": time.perf_counter() - (state["t_fault"]
                                                          or t0),
                      "wall_s": time.perf_counter() - t0}), flush=True)
    sys.stdout.flush()
    os._exit(0)


def phase_slice_fault_sticky(torch):
    """A real sticky CUDA fault, in a child process (see module
    docstring); the parent's CUDA context is never touched."""
    import os
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--sticky-child"],
            capture_output=True, text=True, timeout=STICKY_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"slice_fault_sticky: the child ran past "
                           f"{STICKY_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith('{"sticky_child"')]
    check(proc.returncode == 0 and len(lines) == 1,
          f"slice_fault_sticky child: rc {proc.returncode}, stdout "
          f"{proc.stdout[-2000:]!r}, stderr {proc.stderr[-3000:]!r}")
    got = json.loads(lines[0])
    check(got["at_fault"] is not None
          and len(got["at_fault"]) == len(STICKY_IDX),
          f"the sticky fault ran at {got['at_fault']}")
    for i, (h, n0) in enumerate(zip(got["sticky_child"], got["at_fault"])):
        check(h["resolved"], f"slice_fault_sticky handle {i} hung")
        check(h["error"] in ("EngineFailedError", "CircuitOpenError")
              and "CUDA" in h["cause"],
              f"slice_fault_sticky handle {i}: {h}")
        check(h["tokens"] == n0, f"slice_fault_sticky handle {i}: "
                                 f"{h['tokens'] - n0} tokens after the fault")
    check(wall < STICKY_TIMEOUT_S, f"the child took {wall} s")
    assert_msgs = [ln for ln in proc.stderr.splitlines()
                   if "Assertion" in ln][:2]
    emit({"phase": "slice_fault_sticky", "child_s": wall, **got,
          "device_assert": assert_msgs})


def phase_slice_supervisor(torch, smi):
    """``EngineSupervisor`` over a paged-engine factory at
    ``max_recoveries=0`` with one step fault: one restart, the requests
    resubmitted, greedy tokens as without the fault (the near-tie rule);
    the restart's seconds (the engine's rebuild and its pool on the
    card)."""
    import numpy as np
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.models.gpt import gpt2_small
    from bigdl_tpu_torch.resilience import faults
    from bigdl_tpu_torch.resilience.supervisor import EngineSupervisor
    from bigdl_tpu_torch.serving import ServingEngine

    model = gpt2_small()
    params = convert.init_params(model, seed=0)
    model.load_state_dict(params)
    rng = np.random.default_rng(0)
    rng.integers(0, 50257, 80)
    prompts = _traffic(rng)
    builds = []

    def factory():
        t0 = time.perf_counter()
        eng = ServingEngine(model, None, max_slots=8, paged=True,
                            page_size=16, prefill_chunk=64, top_k=50,
                            top_p=0.9, seed=0, max_recoveries=0)
        torch.cuda.synchronize()
        builds.append(time.perf_counter() - t0)
        return eng

    sup = EngineSupervisor(factory, poll_interval_s=0.01,
                           backoff_base_s=0.01, backoff_max_s=0.05)
    try:
        sup.generate(prompts[0][:80], 4, timeout=300)       # warm-up
        faults.configure("serving.step:error:after=10:times=1")
        t0 = time.perf_counter()
        handles = [sup.submit(prompts[i], N_NEW) for i in GREEDY_IDX]
        outs = [h.result(timeout=600) for h in handles]
        wall = time.perf_counter() - t0
        fired = faults.active_plan().counts()
    finally:
        faults.configure(None)
        sup.close()
    check(sup.restarts == 1, f"slice_supervisor: {sup.restarts} restarts")
    check(fired == {("serving.step", "error"): 1}, f"faults {fired}")
    div = _near_tie_check(torch, "slice_supervisor", params,
                          dict(zip(GREEDY_IDX, outs)), _NO_FAULT["paged"],
                          GREEDY_IDX)
    emit({"phase": "slice_supervisor", "requests": GREEDY_IDX,
          "restarts": sup.restarts, "restart_s": sup.last_recovery_s,
          "engine_build_s": builds, "resubmitted": sup.resubmitted,
          "wall_s": wall, "divergences_vs_no_fault": div, "card": smi})


TIER_PROMPT = 512        # four distinct prompts of 32 full pages each
TIER_POOL = 96           # pages of 16: 2.67 streams of 36 pages
TIER_ORDER = [0, 1, 2, 3, 0, 1]


def _tier_engine(model, params, tier, **kw):
    from bigdl_tpu_torch.serving import ServingEngine
    return ServingEngine(model, params, max_slots=2, paged=True,
                         page_size=16, kv_pages=TIER_POOL, prefill_chunk=64,
                         seed=0, kv_host_tier=tier, **kw)


def _tier_run(torch, engine, prompts):
    """TIER_ORDER's prompts one after another, 64 greedy tokens each."""
    outs = []
    for i in TIER_ORDER:
        outs.append(engine.generate(prompts[i], N_NEW, timeout=600))
        if engine._host_copier is not None:
            engine._host_copier.drain()    # its demotions are resident
    return outs


def _tier_rates(torch, engine):
    """Demote and promote MB/s of 32 pages (37.7 MB at GPT-2 small's
    float32 page) through the engine's pinned staging ring, timed around
    a synchronised card, after the engine's loop stopped: the page slice
    and read back (``_page_buffer`` + ``PinnedStaging.download``), then
    the upload and scatter (``_dispatch_load``)."""
    slots, tier = engine.slots, engine.host_tier
    pages = list(range(32))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    items = [slots._device_page(p) for p in pages]
    host = [it.to_host() for it in items]
    torch.cuda.synchronize()
    t_down = time.perf_counter() - t0
    nbytes = sum(a.nbytes for pl in host[0] for a in pl.values())
    t0 = time.perf_counter()
    slots._dispatch_load(pages, host)
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t0
    st = tier.stats()
    return {"page_bytes": nbytes,
            "demote_MB_per_s": 32 * nbytes / t_down / 1e6,
            "promote_MB_per_s": 32 * nbytes / t_up / 1e6,
            "copier_MB_per_s": (st["ingested_bytes"] / st["ingest_s"] / 1e6
                                if st["ingest_s"] else None)}


def phase_slice_host_tier(torch, kernels, smi):
    """The host tier at GPT-2 small (see module docstring): float32 and
    int8 pools, and tp 2 on the one card."""
    import numpy as np
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.models.gpt import gpt2_small
    from bigdl_tpu_torch.resilience import faults

    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 50257, TIER_PROMPT) for _ in range(4)]
    params = None
    for name, kw in (("float32", {}), ("int8", {"int8_kv": True}),
                     ("tp2", {"mesh": TP_MESH})):
        model = gpt2_small(device="cpu" if "mesh" in kw else "cuda")
        if params is None:
            params = convert.init_params(model, seed=0)
        model.load_state_dict(params)
        off = _tier_engine(model, None, False, **kw)
        try:
            base = _tier_run(torch, off, prompts)
            off_miss = off.metrics()["prefix_miss_tokens"]
        finally:
            off.shutdown()
        del off
        _reset_serving_counts()
        eng = _tier_engine(model, None, True, **kw)
        try:
            stats0 = eng.stats.snapshot()
            t0 = time.perf_counter()
            outs = _tier_run(torch, eng, prompts)
            wall = time.perf_counter() - t0
            counts = _serving_counts()
            stats = eng.stats.snapshot()
            met = eng.metrics()
            # corrupt every resident host buffer, then the third prompt
            # again: its pages fail their checksums and it re-prefills
            faults.configure("serving.host_swap:corrupt")
            with eng.host_tier._lock:
                for entry in eng.host_tier._resident.values():
                    entry["planes"] = faults.corrupt_planes(
                        "serving.host_swap", entry["planes"])
            faults.configure(None)
            again = eng.generate(prompts[2], N_NEW, timeout=600)
            met2 = eng.metrics()
        finally:
            faults.configure(None)
            eng.shutdown()
        rates = _tier_rates(torch, eng) if name != "tp2" else None
        for k, (g, w) in enumerate(zip(outs, base)):
            check(np.array_equal(g, w), f"slice_host_tier {name}: request "
                                        f"{k} differs from the tier-off run")
        check(np.array_equal(again, base[2]),
              f"slice_host_tier {name}: the corrupted run differs")
        promoted = met["host_tier_promoted_pages"]
        check(promoted >= 2 * 32, f"slice_host_tier {name}: {promoted} "
                                  f"pages promoted, want 32 a repeat")
        check(off_miss - met["prefix_miss_tokens"] == 16 * promoted,
              f"slice_host_tier {name}: miss tokens {off_miss} off, "
              f"{met['prefix_miss_tokens']} on, {promoted} promoted")
        check(met2["host_tier_corrupt_dropped"] >= 1,
              f"slice_host_tier {name}: no corrupt page dropped")
        n_layers = 12
        dispatches = ((stats["prefill_chunks"] - stats0["prefill_chunks"])
                      + (stats["steps"] - stats0["steps"]))
        key = "paged_attention_int8" if "int8_kv" in kw else "paged_attention"
        want = n_layers * dispatches * (2 if "mesh" in kw else 1)
        check(counts[key] == want, f"slice_host_tier {name}: {counts[key]} "
                                   f"{key} launches, want {want}")
        entry = kernels.get("paged_attention_int8" if "int8_kv" in kw
                            else ("paged_attention_tp" if "mesh" in kw
                                  else "paged_attention"), {})
        entry.setdefault("launches_by_phase", {})[
            f"slice_host_tier_{name}"] = counts[key]
        emit({"phase": "slice_host_tier", "pool": name,
              "pool_pages": TIER_POOL, "prompt_tokens": TIER_PROMPT,
              "order": TIER_ORDER, "wall_s": wall,
              "promoted_pages": promoted,
              "demoted_pages": met["host_tier_demoted_pages"],
              "prefix_miss_tokens": met["prefix_miss_tokens"],
              "prefix_miss_tokens_tier_off": off_miss,
              "corrupt_dropped": met2["host_tier_corrupt_dropped"],
              "pinned_bytes": met.get("host_tier_pinned_bytes"),
              "pin_alloc_s": met.get("host_tier_pin_alloc_s"),
              "swap_stall_s": met["host_tier_swap_stall_s"],
              "budget_bytes": met["host_tier_budget_bytes"],
              "rates": rates, "launches": counts, "card": smi})
        del eng, model
        torch.cuda.empty_cache()


def phase_slice_snapshot(torch, kernels, smi):
    """The snapshot store at GPT-2 small (see module docstring)."""
    import tempfile
    from pathlib import Path

    import numpy as np
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.models.gpt import gpt2_small
    from bigdl_tpu_torch.resilience import faults
    from bigdl_tpu_torch.serving import ServingEngine

    rng = np.random.default_rng(0)
    rng.integers(0, 50257, 80)
    prompts = _traffic(rng)
    cpu_model = gpt2_small(device="cpu")
    params = convert.init_params(cpu_model, seed=0)
    cpu_model.load_state_dict(params)
    model = gpt2_small()
    model.load_state_dict(params)

    def serve(d, journal=None, **kw):
        m = cpu_model if "mesh" in kw else model
        engine = ServingEngine(m, None, max_slots=8, paged=True,
                               page_size=16, prefill_chunk=64, seed=0,
                               kv_snapshot=True, snapshot_dir=d,
                               snapshot_interval_s=0.5,
                               snapshot_journal=journal, **kw)
        try:
            t0 = time.perf_counter()
            hs = [engine.submit(prompts[i], N_NEW) for i in GREEDY_IDX]
            outs = {i: h.result(timeout=600) for i, h in zip(GREEDY_IDX, hs)}
            wall = time.perf_counter() - t0
        finally:
            engine.shutdown()          # the last pass, flushed
        return outs, wall, engine.metrics()

    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as bad:
        first, t_first, m1 = serve(d)
        written = sum(f.stat().st_size for f in
                      Path(d, "pages").glob("*.page"))
        second, t_second, m2 = serve(d, journal="j2.jsonl")
        third, t_third, m3 = serve(d, journal="j3.jsonl", mesh=TP_MESH)
        faults.configure("serving.snapshot_write:corrupt")
        try:
            serve(bad)
        finally:
            faults.configure(None)
        fourth, t_fourth, m4 = serve(bad, journal="j4.jsonl")
    shared = [i for i in (3, 9) if i in GREEDY_IDX]
    check(m2["restored_pages"] >= 16,
          f"slice_snapshot: {m2['restored_pages']} pages restored, want "
          f"the 16 of the shared prefix at least")
    check(m3["restored_pages"] >= 16,
          f"slice_snapshot tp 2: {m3['restored_pages']} pages restored")
    check(m4["restored_pages"] == 0 and m4["snapshot_corrupt_dropped"] > 0,
          f"slice_snapshot corrupt: {m4['restored_pages']} restored, "
          f"{m4['snapshot_corrupt_dropped']} dropped")
    divs = {}
    for name, outs in (("restart", second), ("tp2", third),
                       ("corrupt", fourth)):
        divs[name] = _near_tie_check(torch, f"slice_snapshot {name}",
                                     params, outs, first, GREEDY_IDX)
    emit({"phase": "slice_snapshot", "requests": GREEDY_IDX,
          "shared_prefix_requests": shared,
          "pages_written": m1["snapshot_pages_written"],
          "bytes_written": written,
          "restored_pages": m2["restored_pages"],
          "restored_pages_tp2": m3["restored_pages"],
          "corrupt_dropped": m4["snapshot_corrupt_dropped"],
          "prefix_miss_tokens": {"first": m1["prefix_miss_tokens"],
                                 "restart": m2["prefix_miss_tokens"],
                                 "corrupt": m4["prefix_miss_tokens"]},
          "seconds": {"first": t_first, "restore": t_second,
                      "restore_tp2": t_third, "reprefill": t_fourth},
          "divergences": divs, "card": smi})
    del model
    torch.cuda.empty_cache()


LORA_RANK = 8          # the reference engine's default rank
LORA_B_STD = 0.5       # B's draw, so the tenants' tokens differ from base
                       # (0.05 left request 6's first 16 as the base's)
LORA_TENANTS = ["t0", "t1", "t2", "t3"]
LORA_GREEDY = [i for i in GREEDY_IDX if i not in (0, 4, 8)]
# lora_variants: 4 greedy requests, 2 base and 2 under t0 / t1
LORA_VARIANT_IDX = [0, 2, 3, 11]
LORA_VARIANT_ADAPTERS = [None, "t0", None, "t1"]
LORA_VARIANT_NEW = 16
# the seeded corrupt rule mangles a weight plane of GPT-2 small's 13
# adapter planes (a mangled meta plane re-parses to the same digest)
LORA_CORRUPT_SEED = 1


def _lora_plan():
    """Request ``i``'s adapter in the slice_lora traffic: requests 0, 4 and
    8 decode the base model, the other nine cycle the four tenants (3 and
    9, which share a prefix, both run under t2)."""
    out, k = [], 0
    for i in range(12):
        if i in (0, 4, 8):
            out.append(None)
        else:
            out.append(LORA_TENANTS[k % 4])
            k += 1
    return out


def _lora_oracles(torch, model, ads, prompts, idx, adapters, n, paged=True,
                  int8=False):
    """Each request ``idx[j]`` (under ``adapters[j]``) alone under its one
    adapter: a hand-driven manager (``_greedy_slots``) a request, every
    row under ``models.lora.SingleAdapter`` (unbatched slabs; the base
    model for None; ``int8``: int8 slabs over int8 K/V pages). Returns
    {request: (tokens (n,), logits (n, V))}."""
    from bigdl_tpu_torch.models import lora
    out = {}
    for i, a in zip(idx, adapters):
        pool = None if a is None else lora.SingleAdapter(
            ads[a], device=model.device, int8=int8)
        toks, logits = _greedy_slots(torch, model, [prompts[i]], n, int8,
                                     paged=paged, adapter_pool=pool)
        out[i] = (toks[0], logits[0])
    return out


def _oracle_check(torch, name, outs, oracles, gap, new=N_CMP):
    """The engine's first ``new`` tokens of each oracle's request against
    the oracle: identical, or first diverging where the oracle's top-2
    logit gap is below ``gap``. Returns the divergences."""
    import numpy as np
    idx = sorted(oracles)
    got = np.stack([outs[i][LENGTHS[i]:LENGTHS[i] + new] for i in idx])
    want = np.stack([oracles[i][0][:new] for i in idx])
    logits = torch.stack([oracles[i][1][:new] for i in idx])
    found = _first_divergence(torch, name, got, want, logits, gap)
    return [dict(f, request=idx[f["row"]]) for f in found]


class _GatherLog:
    """Records an adapter pool's ``gathered`` calls (measurement only): the
    dispatches that passed a slab tree down, and the changes of the
    ``(rows, loads)`` key from one call to the next."""

    def __init__(self, pool):
        self.pool, self.real = pool, pool.gathered
        self.calls = self.with_tree = self.changes = 0
        self.last = None
        pool.gathered = self

    def __call__(self, rows):
        key = (tuple(int(r) for r in rows), self.pool.loads)
        self.calls += 1
        self.changes += key != self.last
        self.last = key
        tree = self.real(rows)
        self.with_tree += tree is not None
        return tree

    def reset(self):
        self.calls = self.with_tree = self.changes = 0
        self.last = None
        self.gathers0 = self.pool.gathers
        self.loads0 = self.pool.loads

    def freeze(self):
        """The run's numbers, read when its counts are read."""
        self.run = {"lora_dispatches": self.with_tree,
                    "gathers": self.pool.gathers - self.gathers0,
                    "gather_key_changes": self.changes,
                    "pool_loads_in_run": self.pool.loads - self.loads0}


def _lora_products(tp, n_layers):
    """The LoRA products of one dispatch with an adapter row: per layer,
    2 for each of the 4 column-parallel targets on every shard, and for
    each of the 2 row-parallel ones ``x_i @ A_i`` on every shard and B
    once after their sum (2 x 6 x 12 at tp 1)."""
    return (4 * 2 * tp + 2 * (tp + 1)) * n_layers


def _lora_serving_checks(name, line, log, tp=1, n_layers=12):
    """A LoRA run's holds: :func:`_lora_products` a dispatch that passed a
    slab tree, and no more gathers than key changes (one per change of
    batch composition or pool contents, never one per step). Returns the
    record's LoRA part."""
    c, run = line["launches"], log.run
    n = run["lora_dispatches"]
    check(n > 0, f"{name}: no dispatch ran with an adapter row")
    want = _lora_products(tp, n_layers) * n
    check(c["lora_products"] == want,
          f"{name}: {c['lora_products']} LoRA products for {n} dispatches "
          f"with an adapter row (want {want})")
    check(run["gathers"] <= run["gather_key_changes"],
          f"{name}: {run['gathers']} gathers for "
          f"{run['gather_key_changes']} key changes")
    return dict(run)


def _lora_burst(engine, prompts, idx, adapters, n_new):
    """Requests ``idx`` under ``adapters``, submitted as one group
    (``submit_many``: one admission pass sees them all). Returns their
    outputs {request: tokens}, the seconds, and {request id: request}."""
    t0 = time.perf_counter()
    hs = engine.submit_many([dict(prompt=prompts[i], max_new_tokens=n_new,
                                  adapter=a) for i, a in zip(idx, adapters)])
    outs = {i: h.result(timeout=600) for i, h in zip(idx, hs)}
    return outs, time.perf_counter() - t0, {h.id: i for i, h in zip(idx, hs)}


class _StepLog:
    """Records each decode dispatch of an engine (measurement only): the
    requests its active slots hold and, with ``logits``, their rows of
    the logits the step picks its tokens from. Without speculation and
    with one step a block, a request's k-th token comes from its k-th
    recorded row."""

    def __init__(self, engine, logits):
        sched = engine.scheduler
        slots, real = sched.slots, sched.slots.step
        self.ids, self.logits = [], {}

        def step():
            live = {s: r for s, r in sched._inflight.items()
                    if slots.active[s]}
            self.ids.append(sorted(r.id for r in live.values()))
            if logits:
                for s, r in live.items():
                    self.logits.setdefault(r.id, []).append(
                        slots._logits[s].float().cpu())
            return real()

        slots.step = step

    def reset(self):
        self.ids, self.logits = [], {}

    def batches(self, by_id):
        """Each step's requests, as request numbers (``by_id``: id ->
        number), the burst's only."""
        return [sorted(by_id[r] for r in ids if r in by_id)
                for ids in self.ids]


def _distinct_check(name, oracles, alts, n=N_CMP):
    """The oracles tell the tenants apart: each request's first ``n``
    oracle tokens differ from those of the same request's alternative
    oracles (``alts``: {label: {request: (tokens, logits)}}: the base
    model, another tenant). Otherwise a pool that gathered the wrong row
    would pass the token checks. Returns, per request and label, the
    first step where they differ."""
    import numpy as np
    out = {}
    for i, (toks, _) in sorted(oracles.items()):
        for label, alt in alts.items():
            diff = np.nonzero(toks[:n] != alt[i][0][:n])[0]
            out.setdefault(str(i), {})[label] = (int(diff[0]) if diff.size
                                                 else None)
    same = [(i, label) for i, d in out.items() for label, step in d.items()
            if step is None]
    check(not same, f"{name}: oracle tokens equal over {n} tokens for "
                    f"(request, alternative) {same}; first differing steps "
                    f"{out}")
    return out


def phase_slice_lora(torch, kernels, smi, f32_line, dense_line, cpu_ref):
    """Multi-tenant LoRA at GPT-2 small (see module docstring): the paged
    and dense engines under ``slice``'s traffic with four tenants, the
    variants (int8 weights, tp 2, speculation) and the adapter-load
    faults."""
    import numpy as np
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.models import lora
    from bigdl_tpu_torch.models.gpt import gpt2_small
    from bigdl_tpu_torch.nn import quantize_model
    from bigdl_tpu_torch.resilience import faults
    from bigdl_tpu_torch.serving import AdapterLoadError, ServingEngine

    t0 = time.perf_counter()
    cpu_model = gpt2_small(device="cpu")
    params = convert.init_params(cpu_model, seed=0)
    cpu_model.load_state_dict(params)
    cpu_model.requires_grad_(False)
    ads = {t: lora.init_adapter(torch.Generator().manual_seed(100 + k),
                                cpu_model, LORA_RANK, b_std=LORA_B_STD)
           for k, t in enumerate(LORA_TENANTS)}
    adapter_bytes = sum(a.nbytes for pl in lora.adapter_planes(ads["t0"])
                        for a in pl.values())
    plan = _lora_plan()
    rng = np.random.default_rng(0)
    rng.integers(0, 50257, 80)          # _serve_traffic's warm-up draw
    prompts = _traffic(rng)
    card = gpt2_small()
    card.load_state_dict(params)
    card.requires_grad_(False)
    oracles = {path: _lora_oracles(
        torch, card, ads, prompts, LORA_GREEDY,
        [plan[i] for i in LORA_GREEDY], N_CMP, paged=path == "paged")
        for path in ("paged", "dense")}
    var_oracle = _lora_oracles(torch, card, ads, prompts, LORA_VARIANT_IDX,
                               LORA_VARIANT_ADAPTERS, LORA_VARIANT_NEW)
    # each greedy adapter request also under the base model and under the
    # next tenant: its oracle must differ from both
    greedy_ads = [plan[i] for i in LORA_GREEDY]
    distinct, alts = {}, {}
    for path in ("paged", "dense"):
        alts[path] = {label: _lora_oracles(
            torch, card, ads, prompts, LORA_GREEDY, alt, N_CMP,
            paged=path == "paged") for label, alt in (
                ("base", [None] * len(LORA_GREEDY)),
                ("next_tenant", [LORA_TENANTS[(LORA_TENANTS.index(a) + 1)
                                              % 4] for a in greedy_ads]))}
        distinct[path] = _distinct_check(f"lora_{path} oracles",
                                         oracles[path], alts[path])
    # the variants' adapter requests (2 under t0, 11 under t1) run under
    # the other of the two in the plan (t1, t0)
    var_ads = {i: var_oracle[i] for i, a in zip(LORA_VARIANT_IDX,
                                                LORA_VARIANT_ADAPTERS) if a}
    distinct["variants"] = _distinct_check(
        "lora_variants oracles", var_ads,
        {"base": alts["paged"]["base"], "other_tenant": oracles["paged"]},
        LORA_VARIANT_NEW)
    # requests 0 and 11 (base, t0) on the CPU under the same adapters
    cpu11 = _greedy_slots(torch, cpu_model, [prompts[11]], N_CMP, False,
                          adapter_pool=lora.SingleAdapter(ads["t0"]))
    setup_s = time.perf_counter() - t0
    del card
    torch.cuda.empty_cache()
    n_layers = len(cpu_model.gpt.layers)
    lines = {}

    def engine(model, p=None, **kw):
        return ServingEngine(model, p, max_slots=8, top_k=50, top_p=0.9,
                             seed=0, lora=True, lora_rank=LORA_RANK,
                             adapters=ads, **kw)

    # --- lora_paged: the mixed traffic through the paged engine
    for path in ("paged", "dense"):
        paged = path == "paged"
        model = gpt2_small()
        kw = (dict(paged=True, page_size=16, prefill_chunk=64,
                   adapter_slots=2, adapter_host_bytes=4 * adapter_bytes)
              if paged else dict(adapter_slots=4))
        eng = engine(model, params, **kw)
        log = _GatherLog(eng.adapter_pool)
        _, outs, line, prof = _serve_traffic(
            torch, eng, np.random.default_rng(0), adapters=plan,
            profiled=paged, before_run=log.reset, after_run=log.freeze)
        st = eng.adapter_pool.stats()
        c = line["launches"]
        name = f"lora_{path}"
        lo = _lora_serving_checks(name, line, log, n_layers=n_layers)
        if paged:
            dispatches = line["prefill_chunks"] + line["decode_steps"]
            check(c["paged_attention"] == n_layers * dispatches,
                  f"{name}: {c['paged_attention']} paged launches for "
                  f"{dispatches} chunks and steps")
            check(st["loads"] >= 4 and st["evictions"] >= 2
                  and st["tier_hits"] >= 1,
                  f"{name}: loads {st['loads']}, evictions "
                  f"{st['evictions']}, tier hits {st['tier_hits']}")
            kernels["paged_attention"].setdefault("launches_by_phase", {})[
                "slice_lora"] = c["paged_attention"]
        else:
            check(c["paged_attention"] == c["paged_attention_int8"]
                  == c["flash_fwd"] == 0, f"{name} launched {c}")
        kernels["fused_sampling"].setdefault("launches_by_phase", {})[
            f"slice_{name}"] = c["fused_sampling"]
        divs = {"vs_oracle": _oracle_check(torch, name, outs,
                                           oracles[path], FLOAT_GAP),
                "base_vs_no_adapter_engine": _near_tie_check(
                    torch, name, params, outs, _NO_FAULT[path], [0, 8])}
        if paged:
            cpu_toks, cpu_logits = cpu_ref
            got = np.stack([outs[i][LENGTHS[i]:LENGTHS[i] + N_CMP]
                            for i in CMP_IDX])
            want = np.stack([cpu_toks[0], cpu11[0][0]])
            logits = torch.stack([cpu_logits[0], cpu11[1][0]])
            divs["vs_cpu"] = _first_divergence(torch, f"{name} vs CPU", got,
                                               want, logits, FLOAT_GAP)
        base = f32_line if paged else dense_line
        lines[name] = {**line, **lo, "adapter_stats": st,
                       "no_adapter_tokens_per_s": base["tokens_per_s"],
                       "no_adapter_ttft_mean_s": base["ttft_mean_s"],
                       "tokens_per_s_vs_no_adapter":
                           line["tokens_per_s"] / base["tokens_per_s"],
                       "paged_tokens_per_s": f32_line["tokens_per_s"],
                       "dense_tokens_per_s": dense_line["tokens_per_s"],
                       "divergences": divs}
        emit({"phase": "slice_lora", "run": name, "model": "gpt2_small",
              "rank": LORA_RANK, "tenants": len(ads),
              "adapter_bytes": adapter_bytes, "plan": plan, **lines[name],
              "card": smi})
        if prof is not None:
            emit({"phase": "profile", "path": "serving_lora", **prof})
        del eng, model
        torch.cuda.empty_cache()

    lines["lora_decode_profile"] = _lora_step_profile(
        torch, params, ads, prompts, plan, n_layers)

    # --- lora_variants: int8 weights, tp 2 on the one card, speculation
    var_prompts = LORA_VARIANT_IDX
    for var, kw in (("int8", dict(int8_weights=True, int8_kv=True)),
                    ("tp2", dict(mesh=TP_MESH)),
                    ("spec", dict(spec_tokens=SPEC_TOKENS))):
        model = gpt2_small(device="cpu" if var == "tp2" else None)
        model.load_state_dict(params)
        eng = engine(model, None, paged=True, page_size=16, prefill_chunk=64,
                     adapter_slots=2, **kw)
        log = _GatherLog(eng.adapter_pool)
        steps = _StepLog(eng, logits=False)
        try:
            eng.generate(prompts[0][:80], 4, timeout=300)     # warm-up
            log.reset()
            steps.reset()
            _reset_serving_counts()
            eng.stats.reset()
            outs, wall, by_id = _lora_burst(eng, prompts, var_prompts,
                                            LORA_VARIANT_ADAPTERS,
                                            LORA_VARIANT_NEW)
            stats = eng.stats.snapshot()
            log.freeze()
            line = {"launches": _serving_counts(), "wall_s": wall,
                    "prefill_chunks": stats["prefill_chunks"],
                    "decode_steps": stats["steps"]}
            pool_int8 = eng.adapter_pool.int8
        finally:
            eng.shutdown()
        name = f"lora_{var}"
        tp = 2 if var == "tp2" else 1
        lo = _lora_serving_checks(name, line, log, tp=tp,
                                  n_layers=n_layers)
        c = line["launches"]
        dispatches = line["prefill_chunks"] + line["decode_steps"]
        run, idle = (("paged_attention_int8", "paged_attention")
                     if var == "int8" else
                     ("paged_attention", "paged_attention_int8"))
        check(c[run] == tp * n_layers * dispatches and c[idle] == 0,
              f"{name}: {c[run]} {run} launches for {dispatches} "
              f"dispatches at tp {tp} ({c[idle]} {idle})")
        key = "paged_attention_tp" if tp > 1 else run
        kernels[key].setdefault("launches_by_phase", {})[
            f"slice_{name}"] = c[run]
        for i in var_prompts:
            check(outs[i].size == LENGTHS[i] + LORA_VARIANT_NEW,
                  f"{name} request {i}: {outs[i].size - LENGTHS[i]} tokens")
        rec = {**line, **lo}
        if var == "int8":
            check(pool_int8 and c["int8_matmuls"] == 6 * n_layers
                  * dispatches, f"{name}: int8 slabs {pool_int8}, "
                                f"{c['int8_matmuls']} int8 products")
            rec.update(_lora_int8_checks(
                torch, params, ads, prompts, outs, steps.batches(by_id),
                lambda m: engine(m, None, paged=True, page_size=16,
                                 prefill_chunk=64, adapter_slots=2,
                                 device="cpu", **kw),
                quantize_model, gpt2_small))
        else:
            rec["divergences"] = _oracle_check(
                torch, name, outs, var_oracle, FLOAT_GAP, LORA_VARIANT_NEW)
        lines[name] = rec
        emit({"phase": "slice_lora", "run": name, "requests": var_prompts,
              "adapters": LORA_VARIANT_ADAPTERS,
              "new_tokens_each": LORA_VARIANT_NEW, **rec})
        del eng, model
        torch.cuda.empty_cache()

    # --- lora_faults: a corrupt tier copy, then an injected load error
    model = gpt2_small()
    eng = engine(model, params, paged=True, page_size=16, prefill_chunk=64,
                 adapter_slots=1, adapter_host_bytes=2 * adapter_bytes)
    n = LORA_VARIANT_NEW
    try:
        first = eng.generate(prompts[2], n, adapter="t0", timeout=300)
        eng.generate(prompts[11], n, adapter="t1", timeout=300)  # evicts t0
        faults.configure(f"seed={LORA_CORRUPT_SEED};"
                         f"serving.adapter_load:corrupt:times=1")
        again = eng.generate(prompts[2], n, adapter="t0", timeout=300)
        corrupt = eng.metrics()["adapter_corrupt_dropped"]
        faults.configure("serving.adapter_load:error:times=1")
        bad = eng.submit(prompts[11], n, adapter="t1")
        ok = eng.submit(prompts[3], n)
        try:
            bad.result(timeout=300)
            bad_err = None
        except AdapterLoadError as e:
            bad_err = repr(e)
        ok_out = ok.result(timeout=300)
        met = eng.metrics()
    finally:
        faults.configure(None)
        eng.shutdown()
    check(corrupt >= 1, f"lora_faults: {corrupt} corrupt copies dropped")
    check(bad_err is not None and "injected" in bad_err,
          f"lora_faults: the failed load gave {bad_err!r}")
    check(ok_out.size == LENGTHS[3] + n, "lora_faults: request 3 failed")
    div = _oracle_check(torch, "lora_faults", {2: again},
                        {2: var_oracle[2]}, FLOAT_GAP, n)
    lines["lora_faults"] = {
        "corrupt_dropped": corrupt, "load_errors":
            met["adapter_load_errors"], "failed_request_error": bad_err,
        "rejected": met["rejected"],
        "corrupt_run_equals_clean_run": bool(np.array_equal(first, again)),
        "divergences": div}
    emit({"phase": "slice_lora", "run": "lora_faults",
          **lines["lora_faults"]})
    del eng, model
    torch.cuda.empty_cache()
    emit({"phase": "slice_lora", "run": "summary", "setup_s": setup_s,
          "tokens_per_s": {k: v.get("tokens_per_s") for k, v in lines.items()
                           if "tokens_per_s" in v},
          "slice_tokens_per_s": f32_line["tokens_per_s"],
          "slice_dense_tokens_per_s": dense_line["tokens_per_s"],
          "oracles_differ_at_step": distinct, "card": smi})
    return lines


def _lora_step_profile(torch, params, ads, prompts, plan, n_layers,
                       steps=16):
    """Where a mixed-adapter decode step's device time goes: requests 0-7
    under their adapters (4 tenants and the base model) in a hand-driven
    8-slot ``PagedSlotManager`` over a 4-row pool, greedy, then ``steps``
    decode steps under torch.profiler with every LoRA delta in its own
    range. Driven on this thread (the profiler records the ranges of the
    thread that runs it, not the engine's scheduler thread). Returns the
    ``profile`` line's numbers."""
    from bigdl_tpu_torch.models.gpt import gpt2_small
    from bigdl_tpu_torch.serving import AdapterPool, PagedSlotManager
    model = gpt2_small()
    model.load_state_dict(params)
    model.requires_grad_(False)
    pool = AdapterPool(model, 4, LORA_RANK)
    for name, ad in ads.items():
        pool.register(name, ad)
    rows = [pool.acquire(pool.resolve(plan[i])) for i in range(8)]
    slots = PagedSlotManager(model, max_slots=8, page_size=16,
                             prefill_chunk=64, adapter_pool=pool)
    slots.admit([prompts[i] for i in range(4)], adapter_slots=rows[:4])
    slots.admit([prompts[i] for i in range(4, 8)], adapter_slots=rows[4:])

    def run():
        for _ in range(steps):
            slots.reserve_block()
            slots.step()

    run()                                   # warm-up
    from bigdl_tpu_torch.nn.quantized import lora_delta
    products = lora_delta.products
    with _lora_ranges(True):
        prof = _profile(torch, run, groups=SERVING_KERNEL_GROUPS,
                        ranges=("lora_delta",))
    check(lora_delta.products - products == 2 * 6 * n_layers * steps,
          f"lora decode profile: {lora_delta.products - products} products "
          f"for {steps} steps")
    emit({"phase": "profile", "path": "serving_lora_decode_steps",
          "steps": steps, "rows": rows, **prof})
    del slots, pool, model
    torch.cuda.empty_cache()
    return prof


def _lora_int8_checks(torch, params, ads, prompts, outs, batches,
                      make_engine, quantize_model, gpt2_small):
    """``lora_int8``'s token checks. Int8 weights couple a dispatch's rows
    (one activation amax a batch), so a single-request oracle cannot hold
    the engine's tokens; a run of the same burst through the same engine
    on the CPU can. Held: the card engine ran the same batches step for
    step (``batches``) as the CPU engine, and its first LORA_VARIANT_NEW
    tokens of every request equal the CPU engine's, or first diverge
    where the CPU's top-2 logit gap is below INT8_GAP. The agreement with
    each request's int8 single-adapter oracle on the card is reported."""
    import numpy as np
    cpu_model = gpt2_small(device="cpu")
    cpu_model.load_state_dict(params)
    cpu_model.requires_grad_(False)
    eng = make_engine(cpu_model)
    steps = _StepLog(eng, logits=True)
    try:
        eng.generate(prompts[0][:80], 4, timeout=300)         # as the card's
        steps.reset()
        cpu_outs, cpu_wall, by_id = _lora_burst(
            eng, prompts, LORA_VARIANT_IDX, LORA_VARIANT_ADAPTERS,
            LORA_VARIANT_NEW)
    finally:
        eng.shutdown()
    check(steps.batches(by_id) == batches,
          "lora_int8: the card and CPU engines ran different batches")
    n = LORA_VARIANT_NEW
    got = np.stack([outs[i][LENGTHS[i]:LENGTHS[i] + n]
                    for i in LORA_VARIANT_IDX])
    want = np.stack([cpu_outs[i][LENGTHS[i]:LENGTHS[i] + n]
                     for i in LORA_VARIANT_IDX])
    rows = {i: r for r, i in by_id.items()}
    logits = torch.stack([torch.stack(steps.logits[rows[i]][:n])
                          for i in LORA_VARIANT_IDX])
    held = [dict(f, request=LORA_VARIANT_IDX[f["row"]]) for f in
            _first_divergence(torch, "lora_int8 card vs CPU engine", got,
                              want, logits, INT8_GAP)]
    del eng, cpu_model
    card = gpt2_small()
    card.load_state_dict(params)
    card.requires_grad_(False)
    quantize_model(card)
    oracle = _lora_oracles(torch, card, ads, prompts, LORA_VARIANT_IDX,
                           LORA_VARIANT_ADAPTERS, n, int8=True)
    del card
    agree = {i: float(np.mean(outs[i][LENGTHS[i]:] == oracle[i][0]))
             for i in LORA_VARIANT_IDX}
    return {"card_vs_cpu_engine_divergences": held,
            "cpu_engine_wall_s": cpu_wall, "steps_compared": len(batches),
            "gap_threshold": INT8_GAP,
            "agreement_with_int8_oracle": agree}


# ------------------------------------------------------------ slice_control
CONTROL_SLOTS = 8                  # the overload engine: slots, queue bound
CONTROL_QUEUE = 4
CONTROL_FLOOD = 16                 # best-effort submits into the overload
CONTROL_FLOOD_NEW = 16
CONTROL_DELAY = 0.05               # serving.step:delay of the overload
CONTROL_BURST = 4                  # the rate-limited client's bucket
CONTROL_SLO_S = 60.0               # the served traffic's tiers' TTFT SLO
OBS_TURNS = (True, False, False, True)   # obs on / off, in turns
PEAK_BF16 = PEAK_FLOPS_PER_S["bfloat16"]
# straight to the local obs endpoint, whatever proxy the environment names
_LOCAL = None


def _scrape(url):
    """GET ``url`` on the local obs endpoint: (status, body text)."""
    import urllib.error
    import urllib.request
    global _LOCAL
    if _LOCAL is None:
        _LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        with _LOCAL.open(url, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _series(text, name, **labels):
    """The value of the Prometheus line ``name{labels}`` (labels in any
    order, all given ones matched), or None."""
    for line in text.splitlines():
        head, _, value = line.rpartition(" ")
        if head.split("{")[0] == name and all(
                f'{k}="{v}"' in head for k, v in labels.items()):
            return float(value)
    return None


def _drive_policy(engine, prompts):
    """``_drive`` with priorities alternating best-effort / interactive and
    three clients."""
    t0 = time.perf_counter()

    def submit(i):
        return engine.submit(prompts[i], N_NEW, temperature=TEMPS[i],
                             priority=("interactive" if i % 2
                                       else "best_effort"),
                             client_id=f"c{i % 3}")

    handles = [submit(i) for i in range(8)]
    while handles[3].first_token_at is None:
        check(not handles[3].done.is_set() or handles[3].error is None,
              f"request 3 failed: {handles[3].error!r}")
        check(time.perf_counter() - t0 < 300, "request 3 stalled")
        time.sleep(0.005)
    return handles + [submit(i) for i in range(8, 12)]


def _control_run(torch, engine, prompts):
    """One policy-driven traffic run: tokens, wall seconds, launches,
    dispatch counts and the modelled flops, counts set to 0 just before."""
    _reset_serving_counts()
    engine.stats.reset()
    flops0 = engine.stats.flops
    t0 = time.perf_counter()
    handles = _drive_policy(engine, prompts)
    outs = [h.result(timeout=600) for h in handles]
    wall = time.perf_counter() - t0
    return {"outs": outs, "handles": handles, "wall_s": wall,
            "stats": engine.stats.snapshot(), "counts": _serving_counts(),
            "flops": engine.stats.flops - flops0,
            "generated": sum(o.size - n for o, n in zip(outs, LENGTHS))}


def phase_slice_control(torch, kernels, smi, cpu_ref):
    """The control plane and its telemetry on ``slice``'s model, weights
    and traffic (see module docstring, 6e)."""
    import numpy as np
    from bigdl_tpu_torch import convert, obs
    from bigdl_tpu_torch.models.gpt import gpt2_small
    from bigdl_tpu_torch.resilience import faults
    from bigdl_tpu_torch.serving import QueueFullError, ServingEngine
    from bigdl_tpu_torch.serving.control import (AdmissionRejectedError,
                                                 ControlPolicy,
                                                 RateLimitedError)

    t_setup = time.perf_counter()
    model = gpt2_small()
    params = convert.init_params(model, seed=0)
    n_layers = len(model.gpt.layers)
    rng = np.random.default_rng(0)
    rng.integers(0, 50257, 80)          # _serve_traffic's warm-up draw
    prompts = _traffic(rng)
    fresh = np.random.default_rng(18)
    server = obs.MetricsServer(host="127.0.0.1", port=0)
    # the measured traffic is held to its tokens, so none of it may be
    # shed: its tiers' TTFT SLOs are CONTROL_SLO_S (shedding is held in
    # the overload part below, at the default SLOs)
    engine = ServingEngine(model, params, max_slots=8, paged=True,
                           page_size=16, prefill_chunk=64, top_k=50,
                           top_p=0.9, seed=0,
                           policy=ControlPolicy(
                               base_ttft_s=0.01,
                               slo_ttft_s={"interactive": CONTROL_SLO_S,
                                           "standard": CONTROL_SLO_S}))
    setup_s = time.perf_counter() - t_setup
    label = engine.obs_label
    source = engine.stats.obs_source
    line = {"phase": "slice_control", "model": "gpt2_small",
            "layers": n_layers, "engine": label, "setup_s": setup_s,
            "card": smi}
    try:
        engine.generate(fresh.integers(0, 50257, 80), 4, temperature=0.8,
                        timeout=300)                          # warm-up
        obs.default_tracer().clear()
        _, first = _scrape(server.url + "/metrics")           # MFU's start
        t_scrape = time.perf_counter()

        # policy serving: slice's prompts, alternating priorities
        run = _control_run(torch, engine, prompts)
        _, text = _scrape(server.url + "/metrics")
        scrape_s = time.perf_counter() - t_scrape
        outs, stats, counts = run["outs"], run["stats"], run["counts"]
        for i, (o, h) in enumerate(zip(outs, run["handles"])):
            check(h.error is None and o.size == LENGTHS[i] + N_NEW,
                  f"slice_control request {i}: {o.size - LENGTHS[i]} of "
                  f"{N_NEW} tokens, {h.error!r}")
        check(engine.scheduler.shed == 0,
              f"slice_control: {engine.scheduler.shed} requests shed")
        exact = [bool(np.array_equal(outs[i], _NO_FAULT["paged"][i]))
                 for i in GREEDY_IDX]
        div = _near_tie_check(torch, "slice_control", params, outs,
                              _NO_FAULT["paged"], GREEDY_IDX)
        cpu_toks, cpu_logits = cpu_ref
        cpu_div = _first_divergence(torch, "slice_control",
                                    _engine_greedy(outs), cpu_toks,
                                    cpu_logits, FLOAT_GAP)
        # requests 0 and 11 as slice's own engine gave them against the
        # CPU: identical where slice's were (no divergence there)
        check(cpu_div == _NO_FAULT["paged_cpu_div"],
              f"slice_control: divergences from the CPU {cpu_div}, slice's "
              f"{_NO_FAULT['paged_cpu_div']}")
        dispatches = stats["prefill_chunks"] + stats["steps"]
        check(counts["paged_attention"] == n_layers * dispatches,
              f"slice_control: {counts['paged_attention']} paged launches "
              f"for {dispatches} chunks and steps")
        check(counts["fused_sampling"] == stats["sampled_steps"] >= 1,
              f"slice_control: {counts['fused_sampling']} sampler launches "
              f"for {stats['sampled_steps']} sampled steps")
        for k, c in (("paged_attention", counts["paged_attention"]),
                     ("fused_sampling", counts["fused_sampling"])):
            kernels[k].setdefault("launches_by_phase", {})[
                "slice_control"] = c

        # the scraped page: TTFT count = retired, page gauges, MFU
        m = engine.metrics()
        ttft_n = _series(text, "bigdl_serving_ttft_seconds_count",
                         engine=label)
        check(ttft_n == m["retired"] == 13,
              f"slice_control: TTFT count {ttft_n}, retired {m['retired']}")
        pages = {k: _series(text, f"bigdl_serving_{k}", engine=label)
                 for k in ("pages_in_use", "pages_total", "page_occupancy")}
        check(pages["pages_total"] == 512 and None not in pages.values(),
              f"slice_control: page gauges {pages}")
        mfu = _series(text, "bigdl_mfu", source=source)
        check(mfu is not None and 0.0 < mfu <= 1.0,
              f"slice_control: bigdl_mfu {mfu}")
        check((_series(first, "bigdl_device_flops", source=source) or 0)
              > 0, "slice_control: no modelled flops before the run")

        # the span track: one serve/step on the scheduler thread a step
        _, trace_text = _scrape(server.url + "/trace")
        doc = json.loads(trace_text)
        names = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
                 if e.get("ph") == "M" and e["name"] == "thread_name"}
        steps_on_loop = sum(1 for e in doc["traceEvents"]
                            if e.get("ph") == "X" and e["name"] ==
                            "serve/step" and names.get(e["tid"]) ==
                            "bigdl-tpu-torch-serving")
        check(steps_on_loop == stats["steps"],
              f"slice_control: {steps_on_loop} serve/step spans for "
              f"{stats['steps']} decode steps")
        status, body = _scrape(server.url + "/healthz")
        check(status == 200 and json.loads(body)["components"].get(
            f"engine:{label}") is True, f"slice_control /healthz {status} "
                                        f"{body}")

        # the cost of obs: the same traffic (fresh prompts) with obs on and
        # off, each under torch.profiler for the busy share, in turns (on,
        # off, off, on) so neither setting always runs first
        cost = {"obs_on": [], "obs_off": []}
        for on in OBS_TURNS:
            prev = obs.set_enabled(on)
            try:
                fresh_prompts = _traffic(fresh)
                box = {}
                prof = _profile(torch, lambda: box.update(
                    _control_run(torch, engine, fresh_prompts)),
                    groups=SERVING_KERNEL_GROUPS)
            finally:
                obs.set_enabled(prev)
            cost["obs_on" if on else "obs_off"].append({
                "tokens_per_s": box["generated"] / box["wall_s"],
                "wall_s": box["wall_s"],
                "device_busy_share": prof.get("device_busy_share",
                                              "not measured")})

        # /profile while serving: a torch.profiler capture on the server's
        # thread must see rows 4 and 7 launched by the scheduler's
        status, body = _scrape(server.url + "/profile?seconds=1")
        check(status == 200, f"slice_control /profile: {status} {body}")
        logdir = json.loads(body)["logdir"]
        status409, _ = _scrape(server.url + "/profile?seconds=1")
        check(status409 == 409, f"slice_control: second /profile gave "
                                f"{status409}")
        _control_run(torch, engine, _traffic(fresh))
        path = f"{logdir}/trace.json"
        deadline = time.perf_counter() + 120
        while server._profile_active and time.perf_counter() < deadline:
            time.sleep(0.1)
        check(not server._profile_active, "slice_control: /profile capture "
                                          "did not finish")
        with open(path) as f:
            kernel_names = {e.get("name", "") for e in json.load(f)[
                "traceEvents"] if e.get("cat") == "kernel"}
        seen = {k: any(v in n for n in kernel_names)
                for k, v in SERVING_KERNEL_GROUPS.items()}
        check(all(seen.values()), f"slice_control /profile trace: {seen}")
    finally:
        engine.shutdown()
    del engine
    torch.cuda.empty_cache()

    # overload: best-effort fills slots and queue under a slowed step, then
    # interactive work arrives; a client past its bucket is rate-limited
    over = ServingEngine(model, None, max_slots=CONTROL_SLOTS,
                         max_queue=CONTROL_QUEUE, paged=True, page_size=16,
                         prefill_chunk=64, top_k=50, top_p=0.9, seed=0,
                         policy=ControlPolicy(base_ttft_s=0.01,
                                              rate_limit_rps=1e-6,
                                              rate_limit_burst=CONTROL_BURST))
    try:
        over.generate(fresh.integers(0, 50257, 48), 4, timeout=300)
        faults.configure(f"serving.step:delay={CONTROL_DELAY}")
        t0 = time.perf_counter()
        flood, full = [], 0
        for i in range(CONTROL_FLOOD):
            try:
                flood.append(over.submit(fresh.integers(0, 50257, 48),
                                         CONTROL_FLOOD_NEW,
                                         priority="best_effort",
                                         client_id=f"b{i}"))
            except QueueFullError:
                full += 1
        inter = [over.submit(fresh.integers(0, 50257, 48), 8,
                             priority="interactive", client_id="human")
                 for _ in range(3)]
        for h in inter:
            h.result(timeout=300)
        faults.configure(None)
        shed = [h for h in flood if h.done.wait(300)
                and isinstance(h.error, AdmissionRejectedError)]
        for h in flood:
            if h not in shed:
                h.result(timeout=300)
        over_wall = time.perf_counter() - t0
        # a client past its bucket, on the drained engine
        limited, hog = 0, []
        for _ in range(CONTROL_BURST + 1):
            try:
                hog.append(over.submit(fresh.integers(0, 50257, 16), 2,
                                       priority="interactive",
                                       client_id="hog"))
            except RateLimitedError:
                limited += 1
        for h in hog:
            h.result(timeout=300)
        _, text = _scrape(server.url + "/metrics")
        shed_by = {p: _series(text, "bigdl_serving_shed_total",
                              engine=over.obs_label, priority=p)
                   for p in ("interactive", "standard", "best_effort")}
        om = over.metrics()
    finally:
        faults.configure(None)
        over.shutdown()
        server.close()
    check(all(h.error is None for h in inter),
          "slice_control: an interactive request failed under overload")
    check(len(shed) >= 3 and all(h.first_token_at is None for h in shed),
          f"slice_control: {len(shed)} best-effort requests shed typed")
    check(shed_by["best_effort"] == len(shed) == om["shed"]
          and shed_by["interactive"] == 0,
          f"slice_control: shed by priority {shed_by}, metrics "
          f"{om['shed']}")
    check(limited == 1 and om["rate_limited"] == 1,
          f"slice_control: {limited} RateLimitedError, metrics "
          f"{om['rate_limited']}")
    mfu_own = run["flops"] / run["wall_s"] / PEAK_BF16
    line.update({
        "requests": 12, "wall_s": run["wall_s"],
        "tokens_per_s": run["generated"] / run["wall_s"],
        "decode_steps": stats["steps"], "prefill_chunks":
        stats["prefill_chunks"], "sampled_steps": stats["sampled_steps"],
        "launches": counts, "greedy_exact_vs_slice": exact,
        "divergences_vs_slice": div, "divergences_vs_cpu": cpu_div,
        "serve_step_spans": steps_on_loop,
        "ttft_count": ttft_n, "page_gauges": pages,
        "bigdl_mfu": mfu, "mfu_scrape_interval_s": scrape_s,
        "modelled_flops": run["flops"], "mfu_phase_own": mfu_own,
        "obs_cost": cost, "profile_kernels": seen,
        "overload": {"flood": CONTROL_FLOOD, "queue_full": full,
                     "shed": len(shed), "shed_by_priority": shed_by,
                     "rate_limited": limited, "wall_s": over_wall,
                     "interactive_ttft_s": [h.first_token_at -
                                            h.submitted_at for h in inter]}})
    emit(line)


# ------------------------------------------------- slice_fleet (A.8(c))
# the engine fleet: two supervised replicas of slice's engine on the one
# card (a device may repeat in make_tp_factory's list), failover on
FLEET_DEVICES = ["cuda:0", "cuda:0"]
FLEET_ROUTE_BLOCK = 16          # the engines' page size: the cache's chain
FLEET_EVAC_IDX = [0, 2, 3, 11]  # greedy requests of the evacuation
FLEET_PROBATION_S = 1.0
FLEET_BACKLOG = 32              # short requests held by serving.step:delay
FLEET_BACKLOG_DELAY = 0.05
FLEET_MEMORY_SLACK = 64 << 20   # memory_allocated after close vs before


class _DeliveryLog:
    """Times of token deliveries by request (wrapping
    ``Request._deliver``), to read the seconds from an evacuation to each
    migrated stream's next token."""

    def __init__(self):
        from bigdl_tpu_torch.serving.scheduler import Request
        self.times, self._request = {}, Request
        self._deliver = Request._deliver
        log = self

        def deliver(req, chunk):
            log.times.setdefault(req.id, []).append(time.perf_counter())
            return log._deliver(req, chunk)

        Request._deliver = deliver

    def close(self):
        self._request._deliver = self._deliver

    def next_after(self, rid, t):
        later = [x for x in self.times.get(rid, ()) if x > t]
        return (min(later) - t) if later else None


def _fleet_factory(model, params, root):
    """Replica ``r``: slice's paged engine on its sub-slice of
    FLEET_DEVICES, snapshotting into ``root`` under its own journal."""
    from bigdl_tpu_torch.serving.router import make_tp_factory

    def factory(replica_id=0):
        return make_tp_factory(
            model, params, tp=1, devices=FLEET_DEVICES, max_slots=8,
            paged=True, page_size=16, prefill_chunk=64, top_k=50,
            top_p=0.9, seed=0, prefix_cache=True, kv_snapshot=True,
            snapshot_dir=root,
            snapshot_journal=f"journal-{replica_id}.jsonl")(replica_id)
    return factory


def _fleet_plain_rate(model, params):
    """tokens/s of ``slice``'s traffic through two replicas without the
    snapshot store and with failover off: what the fleet itself costs,
    beside what the store's page writes add."""
    import numpy as np
    from bigdl_tpu_torch.serving.router import EngineFleet, make_tp_factory
    fleet = EngineFleet(make_tp_factory(
        model, params, tp=1, devices=FLEET_DEVICES, max_slots=8,
        paged=True, page_size=16, prefill_chunk=64, top_k=50, top_p=0.9,
        seed=0), replicas=2, route_block=FLEET_ROUTE_BLOCK)
    try:
        rng = np.random.default_rng(0)
        warm = rng.integers(0, 50257, 80)
        for rep in fleet._replicas:
            rep.sup.generate(warm, 4, temperature=0.8, timeout=300)
        prompts = _traffic(rng)
        t0 = time.perf_counter()
        outs = [h.result(timeout=600) for h in _drive(fleet, prompts)]
        wall = time.perf_counter() - t0
    finally:
        fleet.close(drain=False)
    generated = sum(o.size - n for o, n in zip(outs, LENGTHS))
    check(generated == 12 * N_NEW, f"slice_fleet without the store: "
                                   f"{generated} of {12 * N_NEW} tokens")
    return generated / wall


def _fleet_dispatches(engines):
    """Summed (prefill chunks + decode steps, sampled steps) of the
    distinct ``engines`` (a replica not yet rebuilt still holds the
    engine it was evacuated from)."""
    distinct = {id(e): e for e in engines}.values()
    snaps = [e.stats.snapshot() for e in distinct]
    return (sum(s["prefill_chunks"] + s["steps"] for s in snaps),
            sum(s["sampled_steps"] for s in snaps))


def _fleet_run(torch, kernels, smi, params, model, root, line):
    """The fleet's parts (see module docstring, 6f); returns nothing that
    holds a replica, so the caller can read the card's memory after."""
    import numpy as np
    from bigdl_tpu_torch.resilience import faults
    from bigdl_tpu_torch.serving import AutoScaler
    from bigdl_tpu_torch.serving.router import (HEALTH_EJECTED, HEALTH_OK,
                                                HEALTH_PROBATION,
                                                EngineFleet)
    n_layers = len(model.gpt.layers)
    t0 = time.perf_counter()
    fleet = EngineFleet(_fleet_factory(model, params, root), replicas=2,
                        route_block=FLEET_ROUTE_BLOCK, failover=True,
                        probation_s=FLEET_PROBATION_S,
                        rebuild_budget_s=60.0,
                        supervisor_kw=dict(submit_wait_s=60.0))
    line["build_s"] = time.perf_counter() - t0
    picks = []
    pick = fleet._pick

    def recording_pick(prompt, exclude=(), adapter=None):
        rep = pick(prompt, exclude, adapter=adapter)
        picks.append(rep.rid)
        return rep

    fleet._pick = recording_pick
    log = _DeliveryLog()
    scaler = None
    try:
        rng = np.random.default_rng(0)
        warm = rng.integers(0, 50257, 80)        # slice's warm-up draw
        for rep in fleet._replicas:
            rep.sup.generate(warm, 4, temperature=0.8, timeout=300)
        prompts = _traffic(rng)
        engines = [rep.sup.engine for rep in fleet._replicas]
        _reset_serving_counts()
        for e in engines:
            e.stats.reset()
        picks.clear()
        t_run = time.perf_counter()
        handles = _drive(fleet, prompts)
        outs = [h.result(timeout=600) for h in handles]
        wall = time.perf_counter() - t_run
        counts = _serving_counts()
        dispatches, sampled = _fleet_dispatches(engines)
        met = [e.metrics() for e in engines]
        hits = [m["prefix_hit_tokens"] for m in met]
        route = list(picks)
        generated = sum(o.size - n for o, n in zip(outs, LENGTHS))
        for i, o in enumerate(outs):
            check(o.size == LENGTHS[i] + N_NEW,
                  f"slice_fleet request {i}: {o.size - LENGTHS[i]} of "
                  f"{N_NEW} tokens")
        check(counts["paged_attention"] == n_layers * dispatches,
              f"slice_fleet: paged attention launched "
              f"{counts['paged_attention']} times for {dispatches} chunk "
              f"and step dispatches of {n_layers} layers over the replicas")
        check(counts["paged_attention_int8"] == 0,
              "slice_fleet: the int8 paged kernel launched")
        check(counts["fused_sampling"] == sampled,
              f"slice_fleet: the sampler launched "
              f"{counts['fused_sampling']} times for {sampled} sampled "
              f"steps over the replicas")
        check(route[3] == route[9] and max(hits) >= 256,
              f"slice_fleet: requests 3 and 9 went to replicas {route[3]} "
              f"and {route[9]}, prefix hit tokens {hits}")
        div = _near_tie_check(torch, "slice_fleet", params,
                              dict(enumerate(outs)), _NO_FAULT["paged"],
                              GREEDY_IDX)
        exact = all(np.array_equal(outs[i], _NO_FAULT["paged"][i])
                    for i in GREEDY_IDX)
        kernels["paged_attention"].setdefault("launches_by_phase", {})[
            "slice_fleet"] = counts["paged_attention"]
        kernels["fused_sampling"].setdefault("launches_by_phase", {})[
            "slice_fleet"] = counts["fused_sampling"]
        line.update({"requests": 12, "generated_tokens": int(generated),
                     "wall_s": wall, "tokens_per_s": generated / wall,
                     "replica_of_request": route,
                     "prefix_hit_tokens_by_replica": hits,
                     "snapshot_pages_written_by_replica":
                         [m["snapshot_pages_written"] for m in met],
                     "dispatches": dispatches, "sampled_steps": sampled,
                     "launches": counts, "greedy_exact_vs_slice": exact,
                     "divergences_vs_slice": div})

        # evacuation: replica 0 mid-decode, its streams onto replica 1
        evac = [prompts[i] for i in FLEET_EVAC_IDX]
        old = fleet._replicas[0].sup.engine
        engines = [old, fleet._replicas[1].sup.engine]
        _reset_serving_counts()
        for e in engines:
            e.stats.reset()
        picks.clear()
        hs = [fleet.submit(p, N_NEW) for p in evac]
        route_e = list(picks)
        deadline = time.perf_counter() + 300
        while not all(h.tokens for h in hs):
            check(time.perf_counter() < deadline,
                  "slice_fleet: evacuation streams never started")
            time.sleep(0.001)
        t_evac = time.perf_counter()
        delivered = [len(h.tokens) for h in hs]
        moved = fleet.evacuate_replica(0)
        evac_s = time.perf_counter() - t_evac
        outs_e = [h.result(timeout=600) for h in hs]
        counts_e = _serving_counts()
        dispatches_e, sampled_e = _fleet_dispatches(
            engines + [fleet._replicas[0].sup.engine])
        streams = [[int(t) for t in h] for h in hs]
        migrated = [i for i, (h, r) in enumerate(zip(hs, route_e))
                    if r == 0 and delivered[i] < N_NEW]
        to_next = {FLEET_EVAC_IDX[i]: log.next_after(hs[i].id, t_evac)
                   for i in migrated}
        check(moved is not None and moved == len(migrated) >= 1,
              f"slice_fleet: {moved} streams migrated, {len(migrated)} "
              f"were live on replica 0 (routes {route_e})")
        check(fleet._obs["migrations"].value == fleet.migrated_streams
              == moved, f"slice_fleet: bigdl_fleet_migrations_total "
              f"{fleet._obs['migrations'].value}, {moved} moved")
        check(fleet.failover_restored >= 1 and fleet.failover_restored
              + fleet.failover_reprefilled == moved,
              f"slice_fleet: {fleet.failover_restored} restored, "
              f"{fleet.failover_reprefilled} re-prefilled of {moved}")
        for i, (o, s) in enumerate(zip(outs_e, streams)):
            n = len(evac[i])
            check(o.size == n + N_NEW and s == [int(t) for t in o[n:]],
                  f"slice_fleet: evacuated stream {FLEET_EVAC_IDX[i]} "
                  f"delivered {len(s)} tokens for {o.size - n}")
        check(counts_e["paged_attention"] == n_layers * dispatches_e
              and counts_e["fused_sampling"] == sampled_e,
              f"slice_fleet evacuation: {counts_e} for {dispatches_e} "
              f"dispatches, {sampled_e} sampled steps")
        want = {i: outs[i] for i in FLEET_EVAC_IDX}
        got = dict(zip(FLEET_EVAC_IDX, outs_e))
        div_e = _near_tie_check(torch, "slice_fleet evacuation", params,
                                got, want, FLEET_EVAC_IDX)
        exact_e = all(np.array_equal(got[i], want[i])
                      for i in FLEET_EVAC_IDX)
        # probation: the watcher re-arms the circuit after probation_s, the
        # supervisor rebuilds, canary picks readmit
        deadline = time.perf_counter() + 120
        while fleet.health()[0] != HEALTH_PROBATION:
            check(time.perf_counter() < deadline,
                  f"slice_fleet: replica 0 never entered probation "
                  f"({fleet.health()})")
            time.sleep(0.01)
        t_probe = time.perf_counter()
        canaries = []
        while fleet.health()[0] != HEALTH_OK:
            check(len(canaries) < 400, "slice_fleet: replica 0 was never "
                                       "readmitted")
            canaries.append(fleet.submit(rng.integers(0, 50257, 32), 4))
        for h in canaries:
            h.result(timeout=300)
        readmit_s = time.perf_counter() - t_probe
        check(fleet.readmissions == 1 and fleet.ejections == 1,
              f"slice_fleet: {fleet.ejections} ejections, "
              f"{fleet.readmissions} readmissions")
        check(fleet._replicas[0].sup.resubmitted == 0,
              "slice_fleet: the rebuilt replica adopted a migrated stream")
        line["evacuation"] = {
            "requests": FLEET_EVAC_IDX, "replica_of_request": route_e,
            "delivered_at_evacuation": delivered, "migrated": moved,
            "restored": fleet.failover_restored,
            "reprefilled": fleet.failover_reprefilled,
            "evacuate_s": evac_s, "s_to_next_token": to_next,
            "dispatches": dispatches_e, "launches": counts_e,
            "greedy_exact_vs_fleet": exact_e,
            "divergences_vs_fleet": div_e,
            "rebuild_s": fleet._replicas[0].sup.last_recovery_s,
            "canaries": len(canaries), "readmit_s": readmit_s}
        check(HEALTH_EJECTED not in fleet.health().values(),
              f"slice_fleet: health {fleet.health()}")

        # the AutoScaler over the fleet: a held backlog scales it to 3
        scaler = AutoScaler(fleet, max_replicas=3, votes_to_scale=1,
                            cooldown_s=0.0, obs_label="slice_fleet")
        faults.configure(f"serving.step:delay={FLEET_BACKLOG_DELAY}")
        held = contextlib.ExitStack()
        for rep in fleet._replicas:
            held.enter_context(rep.sup.engine.scheduler.held_admission())
        try:
            backlog = [fleet.submit(rng.integers(0, 50257, 16), 4)
                       for _ in range(FLEET_BACKLOG)]
            load = fleet.load()
            t_scale = time.perf_counter()
            action = scaler.step()
            scale_s = time.perf_counter() - t_scale
        finally:
            held.close()
        faults.configure(None)
        for h in backlog:
            h.result(timeout=300)
        check(action == 1 and fleet.replica_count() == 3,
              f"slice_fleet: the AutoScaler took action {action} on "
              f"{load}, {fleet.replica_count()} replicas")
        sick = fleet._replicas[1]
        sick.sup.evacuate()                      # circuit open, no streams
        retired = [r.rid for r in fleet._replicas]
        fleet.scale_to(2, prefer_unhealthy=True)
        left = [r.rid for r in fleet._replicas]
        check(left == [0, 2],
              f"slice_fleet: scale-down from {retired} left {left}; the "
              f"circuit-open replica {sick.rid} must go first")
        line["autoscaler"] = {"backlog": FLEET_BACKLOG, "load": load,
                              "action": action, "scale_up_s": scale_s,
                              "replicas_after_down": left}
    finally:
        faults.configure(None)
        log.close()
        if scaler is not None:
            scaler.stop()
        fleet.close(drain=False)


def phase_slice_fleet(torch, kernels, smi, f32_line):
    """The engine fleet on ``slice``'s model, weights and traffic (see
    module docstring, 6f)."""
    import gc
    import shutil
    import tempfile
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.models.gpt import gpt2_small

    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    model = gpt2_small(device="cpu")       # the card holds the replicas only
    params = convert.init_params(model, seed=0)
    root = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    line = {"phase": "slice_fleet", "model": "gpt2_small",
            "layers": len(model.gpt.layers), "replicas": 2,
            "devices": FLEET_DEVICES, "route_block": FLEET_ROUTE_BLOCK,
            "card": smi}
    try:
        _fleet_run(torch, kernels, smi, params, model, root, line)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    line["no_store_tokens_per_s"] = _fleet_plain_rate(model, params)
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    check(after - before <= FLEET_MEMORY_SLACK,
          f"slice_fleet: {after - before} bytes still allocated on the "
          f"card after close")
    line.update({"memory_before_bytes": before,
                 "memory_after_close_bytes": after,
                 "slice_tokens_per_s": f32_line["tokens_per_s"]})
    emit(line)


# ------------------------------------------------ train_preempt (A.8(c))
# ResNet-50 float32 through the facade, preempted by the fault harness and
# resumed from its final checkpoint: 3 batches of 32 an epoch, so the
# preemption after the third step falls at an epoch's end and the resumed
# run's next shuffle is the uninterrupted run's second
PREEMPT_RECORDS, PREEMPT_BATCH, PREEMPT_STEPS = 96, 32, 4
PREEMPT_PLAN = "train.step:preempt:after=2:times=1"
PREEMPT_LOSS_REL = 1e-4
PREEMPT_DISTRI_PLANS = ("allreduce.sync:error:after=3:times=1",
                        "train.step:preempt:after=2:times=1")


def _preempt_counts(torch, run):
    """``run()``'s conv launches, ``bigdl_train_steps_total{loop="local"}``
    increment and ``train/dispatch`` spans; the counts set to 0 just
    before."""
    from bigdl_tpu_torch import obs
    steps = obs.counter("bigdl_train_steps_total",
                        "optimizer steps completed",
                        ("loop",)).labels("local")
    obs.default_tracer().clear()
    torch.cuda.synchronize()
    _reset_conv_counts()
    before = steps.value
    err = None
    try:
        run()
    except Exception as e:           # the caller checks what was raised
        err = e
    torch.cuda.synchronize()
    spans = [s.name for s in obs.default_tracer().spans()]
    return err, _conv_counts(), steps.value - before, \
        spans.count("train/dispatch")


def _preempt_resnet(torch, kernels, smi, root):
    """ResNet-50's three runs with cuDNN's deterministic algorithms (the
    library convolutions and every weight gradient): without them two
    uninterrupted runs on the card differ by 1e-6 relative at the second
    step and by percents at the fourth, which would hide the resume."""
    with _deterministic_cudnn(torch):
        return _preempt_resnet_runs(torch, kernels, smi, root)


def _preempt_resnet_runs(torch, kernels, smi, root):
    import numpy as np
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
    from bigdl_tpu_torch.models import ResNet, conv_routes
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    from bigdl_tpu_torch.optim.methods import OptimMethod
    from bigdl_tpu_torch.resilience import TrainingPreempted, faults, preempt
    from bigdl_tpu_torch.utils.serializer import load_module

    n, b, hw = PREEMPT_RECORDS, PREEMPT_BATCH, RESNET_HW
    rng = np.random.default_rng(19)
    images = rng.standard_normal((n, hw, hw, 3), dtype=np.float32)
    labels = rng.integers(0, 1000, n).astype(np.int32)
    model = ResNet(class_num=1000, depth=50, format="NHWC")
    params = convert.init_resnet_params(model, seed=0)
    routes = conv_routes(model, (hw, hw))

    def dataset():
        return _pin_shuffle(DataSet.array(
            [Sample(images[i], labels[i]) for i in range(n)])
            >> SampleToMiniBatch(b))

    def facade(weights, ds, steps, log, ckpt=None):
        model.load_state_dict(weights)
        opt = Optimizer(model=model, dataset=ds,
                        criterion=ClassNLLCriterion())
        opt.set_optim_method(SGD(learningrate=0.01))
        opt.set_end_when(Trigger.max_iteration(steps))
        if ckpt is not None:       # only the preemption writes one
            opt.set_checkpoint(ckpt, Trigger.several_iteration(1000))
        opt.set_train_summary(log)
        return opt

    runs = {}
    full = _Scalars()
    runs["uninterrupted"] = _preempt_counts(
        torch, facade(params, dataset(), PREEMPT_STEPS, full).optimize)
    ds = dataset()
    cut = _Scalars()
    faults.configure(PREEMPT_PLAN)
    try:
        t0 = time.perf_counter()
        runs["preempted"] = _preempt_counts(
            torch, facade(params, ds, PREEMPT_STEPS, cut, ckpt=root)
            .optimize)
        preempt_s = time.perf_counter() - t0
        fired = faults.active_plan().counts()
    finally:
        faults.configure(None)
    err = runs["preempted"][0]
    check(isinstance(err, TrainingPreempted),
          f"train_preempt: the preempted run raised {err!r}")
    neval = err.neval
    reason = preempt.reason()
    preempt.clear()
    _, state = OptimMethod.load(f"{root}/optimMethod.{neval}")
    check(neval == 4 and int(state["step"]) == 3 and fired ==
          {("train.step", "preempt"): 1},
          f"train_preempt: neval {neval}, step {int(state['step'])}, "
          f"faults {fired}")
    # model.N holds the ResNet as the reference's graph, built back into
    # a ResNet
    weights = load_module(f"{root}/model.{neval}").state_dict()
    rest = _Scalars()
    runs["resumed"] = _preempt_counts(
        torch, facade(weights, ds, PREEMPT_STEPS - (neval - 1), rest)
        .optimize)
    check(runs["resumed"][0] is None and runs["uninterrupted"][0] is None,
          f"train_preempt: {runs['uninterrupted'][0]!r}, "
          f"{runs['resumed'][0]!r}")
    losses = cut.losses + rest.losses
    rel = [abs(g - w) / abs(w) for g, w in zip(losses, full.losses)]
    check(len(losses) == len(full.losses) == PREEMPT_STEPS
          and all(np.isfinite(losses)) and max(rel) <= PREEMPT_LOSS_REL,
          f"train_preempt: preempted + resumed losses {losses} vs the "
          f"uninterrupted run's {full.losses}")
    launches = {}
    for name, (_, counts, steps, dispatch_spans) in runs.items():
        n_steps = {"uninterrupted": PREEMPT_STEPS, "preempted": neval - 1,
                   "resumed": PREEMPT_STEPS - (neval - 1)}[name]
        for kind in ("k9", "i2c"):
            check(counts[kind] == 0 and counts[f"{kind}_cuda_core"]
                  == routes[kind] * n_steps,
                  f"train_preempt {name}: conv3x3_{kind} ran "
                  f"{counts[kind]} tensor-core and "
                  f"{counts[f'{kind}_cuda_core']} CUDA-core launches for "
                  f"{n_steps} steps of {routes[kind]}")
        check("3x3/s1" not in counts["library"],
              f"train_preempt {name}: a 3x3 stride-1 convolution reached "
              f"F.conv2d: {counts['library']}")
        check(steps == dispatch_spans == n_steps,
              f"train_preempt {name}: bigdl_train_steps_total +{steps}, "
              f"{dispatch_spans} train/dispatch spans for {n_steps} steps")
        launches[name] = {"k9": counts["k9_cuda_core"],
                          "i2c": counts["i2c_cuda_core"]}
    for kind in ("k9", "i2c"):
        kernels[f"conv3x3_{kind}"].setdefault("launches_by_phase", {})[
            "train_preempt"] = sum(v[kind] for v in launches.values())
    return {"records": n, "batch": b, "image": hw, "plan": PREEMPT_PLAN,
            "optimizer": "SGD(0.01)", "cudnn_deterministic": True,
            "reason": reason,
            "preempted_neval": neval, "checkpoint_step": int(state["step"]),
            "losses_uninterrupted": full.losses,
            "losses_preempted_resumed": losses, "loss_rel_diff": rel,
            "preempted_run_s": preempt_s, "conv_routes_per_step": routes,
            "cuda_core_launches": launches}


def _preempt_sigterm(torch, root, prev):
    """LeNet-5 through the facade, preempted by a real SIGTERM sent to
    this process from its summary (the main thread) at iteration 2;
    ``prev`` is the handler the guard must put back."""
    import os
    import signal
    from bigdl_tpu_torch.dataset.mnist import mnist_dataset
    from bigdl_tpu_torch.models import LeNet5
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    from bigdl_tpu_torch.resilience import TrainingPreempted, preempt

    preempt.uninstall()          # the earlier runs armed it: start from prev
    check(signal.getsignal(signal.SIGTERM) is prev,
          "train_preempt: the guard did not put the handler back")

    class Kill(_Scalars):
        def add_scalar(self, tag, value, step):
            super().add_scalar(tag, value, step)
            if tag == "Loss" and step == 2:
                # only with the guard armed: unguarded, SIGTERM ends us
                check(signal.getsignal(signal.SIGTERM) is not prev,
                      "train_preempt: the guard is not installed")
                os.kill(os.getpid(), signal.SIGTERM)

    opt = Optimizer(model=LeNet5(10, device="cuda", seed=1),
                    dataset=mnist_dataset(training=True,
                                          batch_size=LENET_BATCH,
                                          synthetic_size=LENET_TRAIN),
                    criterion=ClassNLLCriterion())
    opt.set_optim_method(SGD(learningrate=0.05))
    opt.set_end_when(Trigger.max_epoch(1))
    opt.set_checkpoint(root, Trigger.several_iteration(1000))
    opt.set_train_summary(Kill())
    err = None
    try:
        opt.optimize()
    except TrainingPreempted as e:
        err = e
    reason = preempt.reason()
    preempt.clear()
    preempt.uninstall()
    restored = signal.getsignal(signal.SIGTERM) is prev
    check(err is not None and reason == "SIGTERM" and restored
          and os.path.exists(f"{root}/model.{err.neval}"),
          f"train_preempt SIGTERM: {err!r}, reason {reason}, previous "
          f"handler restored: {restored}")
    return {"neval": err.neval, "reason": reason,
            "handler_restored": restored}


def _preempt_distri(torch, root):
    """LeNet-5 through ``DistriOptimizer`` on two replicas of the card:
    an ``allreduce.sync`` error retried once from the checkpoint, then a
    preemption through the retry loop."""
    import os
    import numpy as np
    from bigdl_tpu_torch.dataset.mnist import mnist_dataset
    from bigdl_tpu_torch.models import LeNet5
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    from bigdl_tpu_torch.resilience import TrainingPreempted, faults, preempt

    out = {}
    for plan in PREEMPT_DISTRI_PLANS:
        ckpt = os.path.join(root, plan.split(":")[0])
        opt = Optimizer(model=LeNet5(10, device="cuda", seed=1),
                        dataset=mnist_dataset(training=True,
                                              batch_size=LENET_BATCH,
                                              distributed=True,
                                              synthetic_size=LENET_TRAIN),
                        criterion=ClassNLLCriterion(), mesh=DISTRI_MESH)
        opt.set_optim_method(SGD(learningrate=0.05))
        opt.set_end_when(Trigger.max_epoch(1))
        opt.set_checkpoint(ckpt, Trigger.several_iteration(2))
        log = _Scalars()
        opt.set_train_summary(log)
        faults.configure(plan)
        err = None
        try:
            opt.optimize()
        except TrainingPreempted as e:
            err = e
        finally:
            fired = faults.active_plan().counts()
            faults.configure(None)
            preempt.clear()
        out[plan] = {"retries": opt.retries, "faults": {
            f"{s}:{k}": v for (s, k), v in fired.items()},
            "preempted_neval": None if err is None else err.neval,
            "losses": log.losses}
        if plan.startswith("allreduce"):
            check(err is None and opt.retries == 1
                  and all(np.isfinite(log.losses)),
                  f"train_preempt distri: {plan} gave {err!r}, "
                  f"{opt.retries} retries")
        else:
            check(err is not None and opt.retries == 0 and os.path.exists(
                f"{ckpt}/driverState.{err.neval}"),
                f"train_preempt distri: {plan} gave {err!r}, "
                f"{opt.retries} retries")
    return out


def phase_train_preempt(torch, kernels, smi):
    """Training preemption through the facade and ``DistriOptimizer``
    (see module docstring, 6g)."""
    import shutil
    import signal
    import tempfile
    from bigdl_tpu_torch.resilience import preempt
    prev = signal.getsignal(signal.SIGTERM)
    root = tempfile.mkdtemp(prefix="chip_smoke_preempt_")
    try:
        resnet = _preempt_resnet(torch, kernels, smi, f"{root}/resnet")
        torch.cuda.empty_cache()
        sigterm = _preempt_sigterm(torch, f"{root}/sigterm", prev)
        distri = _preempt_distri(torch, f"{root}/distri")
    finally:
        preempt.uninstall()
        shutil.rmtree(root, ignore_errors=True)
    check(signal.getsignal(signal.SIGTERM) is prev,
          "train_preempt: the SIGTERM handler was not put back")
    emit({"phase": "train_preempt", "resnet50": resnet,
          "sigterm_lenet": sigterm, "distri_lenet": distri, "card": smi})


# ----------------------------------------------------------- A.10(b)
SHARDED_MESH = ["cuda:0", "cuda:0"]
# ResNet-50 float32 through DistriOptimizer on two replicas of the card:
# 96 seeded records in batches of 32 (3 an epoch, so the retry's epoch
# restart and the uninterrupted run see the same batches), Adam (slots per
# element), a sharded checkpoint every 2 iterations, 6 iterations, the
# fifth batch failing once
SHARDED_RECORDS, SHARDED_BATCH, SHARDED_STEPS = 96, 32, 6
SHARDED_FAIL_AT, SHARDED_CLASSES = 5, 10
BANDWIDTH_MB = 64


class _StepScalars:
    """An ``add_scalar`` summary keeping the last value a step logged."""

    def __init__(self):
        self.by_step = {}

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.by_step[int(step)] = float(value)


class _deterministic_cudnn:
    """cuDNN's deterministic algorithms while active (without them two
    runs on the card drift apart, ``train_preempt``)."""

    def __init__(self, torch):
        self.cudnn = torch.backends.cudnn

    def __enter__(self):
        self.saved = (self.cudnn.deterministic, self.cudnn.benchmark)
        self.cudnn.deterministic, self.cudnn.benchmark = True, False

    def __exit__(self, *exc):
        self.cudnn.deterministic, self.cudnn.benchmark = self.saved


def _sharded_resnet(torch, kernels, root):
    """The sharded run, failed and retried, against an uninterrupted one
    (see module docstring, 6h), with cuDNN's deterministic algorithms."""
    with _deterministic_cudnn(torch):
        return _sharded_resnet_runs(torch, kernels, root)


def _retry_resnet_setup():
    """``train_sharded``'s data, model and weights (module docstring, 6h;
    ``load_native`` retries the same run from native checkpoints)."""
    import numpy as np
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.models import ResNet, conv_routes

    n, hw = SHARDED_RECORDS, RESNET_HW
    rng = np.random.default_rng(20)
    images = rng.standard_normal((n, hw, hw, 3), dtype=np.float32)
    labels = rng.integers(0, SHARDED_CLASSES, n).astype(np.int32)
    order = rng.permutation(n)             # the one seeded order
    model = ResNet(class_num=1000, depth=50, format="NHWC")
    return {"images": images, "labels": labels, "order": order,
            "model": model, "params": convert.init_resnet_params(model,
                                                                 seed=0),
            "routes": conv_routes(model, (hw, hw))}


def _retry_resnet_run(torch, setup, ckpt, fail_at=None, plan=None,
                      reload="_reload_sharded"):
    """One ``DistriOptimizer`` run of ``setup`` on ``SHARDED_MESH``:
    ``Adam(1e-3)``, ``SHARDED_STEPS`` iterations, a checkpoint every 2
    under ``ckpt`` (None: none), the ``fail_at``-th batch failing once or
    the fault ``plan`` armed; the optimizer's ``reload`` method traced.
    Returns ``(opt, {step: loss}, steps dispatched, [reloaded neval],
    conv counts, seconds)``, the counts set to 0 just before."""
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import Adam, Optimizer, Trigger
    from bigdl_tpu_torch.resilience import faults

    images, labels, model = setup["images"], setup["labels"], setup["model"]
    ds = DataSet.array([Sample(images[i], labels[i]) for i in setup["order"]],
                       distributed=True)
    ds.shuffle = lambda seed=None: ds      # every epoch in that order
    model.load_state_dict(setup["params"])
    opt = Optimizer(model=model, dataset=ds >> SampleToMiniBatch(
        SHARDED_BATCH), criterion=ClassNLLCriterion(), mesh=SHARDED_MESH)
    opt.set_optim_method(Adam(learningrate=1e-3))
    opt.set_end_when(Trigger.max_iteration(SHARDED_STEPS))
    if ckpt is not None:
        opt.set_checkpoint(ckpt, Trigger.several_iteration(2))
    log = _StepScalars()
    opt.set_train_summary(log)
    calls, reloads = {"n": 0, "steps": 0}, []
    shard, reloaded = opt._shard_batch, getattr(opt, reload)

    def counted(batch, tensors=None):
        calls["n"] += 1
        if calls["n"] == fail_at:
            raise RuntimeError("injected executor failure")
        calls["steps"] += 1
        return shard(batch, tensors)

    def traced(neval):
        reloads.append(neval)
        return reloaded(neval)

    opt._shard_batch = counted
    setattr(opt, reload, traced)
    torch.cuda.synchronize()
    _reset_conv_counts()
    t0 = time.perf_counter()
    faults.configure(plan)
    try:
        opt.optimize()
        fired = faults.active_plan().counts() if plan else {}
    finally:
        faults.configure(None)
    torch.cuda.synchronize()
    # a fault at train.step fires after the batch was placed, before the
    # step: that placement dispatched nothing
    steps = calls["steps"] - sum(fired.values())
    return (opt, log.by_step, steps, reloads, _conv_counts(),
            time.perf_counter() - t0)


def _sharded_resnet_runs(torch, kernels, root):
    import os
    import pickle

    import numpy as np
    from bigdl_tpu_torch.utils.serializer import load_module

    setup = _retry_resnet_setup()
    n, b, hw = SHARDED_RECORDS, SHARDED_BATCH, RESNET_HW
    routes = setup["routes"]

    def run(ckpt, fail_at=None):
        return _retry_resnet_run(torch, setup, ckpt, fail_at)

    os.environ["BIGDL_TPU_SHARDED_CHECKPOINT"] = "1"
    try:
        full = run(None)
        cut = run(root, SHARDED_FAIL_AT)
    finally:
        del os.environ["BIGDL_TPU_SHARDED_CHECKPOINT"]
    opt, losses, steps, reloads, counts, cut_s = cut
    _, want, full_steps, _, full_counts, full_s = full
    ss = opt._step.state.arp.slice_size
    with open(os.path.join(root, "shard.4.p0"), "rb") as f:
        shard4 = pickle.load(f)
    files = sorted(os.listdir(root))
    marker = getattr(load_module(os.path.join(root, "model.4")),
                     "_sharded_weights_marker", None)
    check(all(f"shard.{k}.p0" in files for k in (2, 4))
          and [s for s, _ in shard4["flat"]] == [0, ss]
          and marker == {"neval": 4, "nprocs": 1},
          f"train_sharded: files {files}, shard.4 starts "
          f"{[s for s, _ in shard4['flat']]} (slice {ss}), model.4 marker "
          f"{marker}")
    check(opt.retries == 1 and reloads == [4],
          f"train_sharded: {opt.retries} retries, sharded reloads {reloads}")
    check(sorted(losses) == sorted(want) == list(range(1, SHARDED_STEPS + 1))
          and all(losses[k] == want[k] for k in want),
          f"train_sharded: resumed losses {losses} vs uninterrupted {want}")
    check(all(np.isfinite(list(want.values()))),
          f"train_sharded: losses {want}")
    launches = {}
    for name, c, k in (("uninterrupted", full_counts, full_steps),
                       ("failed_and_resumed", counts, steps)):
        for kind in ("k9", "i2c"):
            check(c[kind] == 0 and c[f"{kind}_cuda_core"]
                  == routes[kind] * len(SHARDED_MESH) * k,
                  f"train_sharded {name}: conv3x3_{kind} ran {c[kind]} "
                  f"tensor-core and {c[f'{kind}_cuda_core']} CUDA-core "
                  f"launches for {k} steps x {len(SHARDED_MESH)} replicas "
                  f"of {routes[kind]}")
        check("3x3/s1" not in c["library"],
              f"train_sharded {name}: a 3x3 stride-1 convolution reached "
              f"F.conv2d: {c['library']}")
        launches[name] = {"k9": c["k9_cuda_core"], "i2c": c["i2c_cuda_core"]}
    for kind in ("k9", "i2c"):
        kernels[f"conv3x3_{kind}"].setdefault("launches_by_phase", {})[
            "train_sharded"] = sum(v[kind] for v in launches.values())
    return {"records": n, "batch": b, "image": hw, "optimizer": "Adam(1e-3)",
            "replicas": len(SHARDED_MESH), "fail_at_batch": SHARDED_FAIL_AT,
            "steps_run": {"uninterrupted": full_steps,
                          "failed_and_resumed": steps},
            "resumed_from": reloads, "slice_size": ss,
            "shard_bytes": os.path.getsize(os.path.join(root,
                                                        "shard.4.p0")),
            "losses": [want[k] for k in sorted(want)],
            "losses_bit_equal": True, "cudnn_deterministic": True,
            "uninterrupted_s": full_s, "failed_and_resumed_s": cut_s,
            "conv_routes_per_step": routes, "cuda_core_launches": launches}


def _bandwidth(torch):
    """``allreduce_bandwidth`` on the two replicas of the card, both
    patterns: seconds and ring bytes, no bandwidth figure (no byte
    crosses a link), the sync-seconds histogram observed."""
    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.parallel import allreduce_bandwidth
    from bigdl_tpu_torch.parallel.allreduce import ici_peak_gbps
    hist = obs.histogram("bigdl_allreduce_sync_seconds",
                         "blocking allreduce sync time")
    before = hist.count
    out = {}
    for pattern in ("step", "psum"):
        r = allreduce_bandwidth(SHARDED_MESH, size_mb=BANDWIDTH_MB,
                                pattern=pattern)
        check(not any("bandwidth" in k or "efficiency" in k for k in r),
              f"train_sharded: a bandwidth figure on one card: {r}")
        out[pattern] = r
    check(hist.count - before == 2,
          f"train_sharded: bigdl_allreduce_sync_seconds observed "
          f"{hist.count - before} times for 2 calls")
    out["ici_peak_gbps"] = ici_peak_gbps()
    out["size_mb"] = BANDWIDTH_MB
    return out


def phase_train_sharded(torch, kernels, smi):
    """Sharded checkpoints and the collectives' timing on one card (see
    module docstring, 6h)."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    try:
        resnet = _sharded_resnet(torch, kernels, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    bandwidth = _bandwidth(torch)
    emit({"phase": "train_sharded", "resnet50": resnet,
          "allreduce_bandwidth": bandwidth, "card": smi})
    return resnet["losses"]


# ---------------------------------------------------------- A.11(d)(3)
NATIVE_PLAN = "train.step:error:after=4:times=1"   # the fifth batch fails
NATIVE_CHECK_IDS = (2, 64)      # (c)'s batch of token ids
NATIVE_OUT_REL = 1e-4           # card vs CPU logits, x max|CPU| (TF32 off)


class _MemFS:
    """An in-memory filesystem for ``mem://`` paths
    (``utils.fileio.register_filesystem``), as ``tests/test_serializer.py``
    registers one: a written file lands in ``blobs`` when it is closed."""

    def __init__(self):
        self.blobs = {}

    def open(self, path, mode="rb"):
        import io
        if "w" not in mode:
            return io.BytesIO(self.blobs[path])
        buf, blobs = io.BytesIO(), self.blobs
        real_close = buf.close

        def close():
            blobs[path] = buf.getvalue()
            real_close()
        buf.close = close
        return buf

    def exists(self, path):
        return path in self.blobs

    def makedirs(self, path):
        pass

    def listdir(self, path):
        return [p.rsplit("/", 1)[-1] for p in self.blobs
                if p.startswith(path.rstrip("/") + "/")]


def _native_route(torch, model, path, weight_path, nbytes):
    """Save ``model`` to ``path`` (and ``weight_path``) with
    ``save_module``, load it onto the card with ``load_module``: the
    seconds of each, the bytes, the loaded model."""
    from bigdl_tpu_torch.utils.serializer import load_module, save_module
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_module(model, path, weight_path=weight_path)
    t1 = time.perf_counter()
    loaded = load_module(path, weight_path=weight_path)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    same = all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), loaded.state_dict().values()))
    check(same and list(model.state_dict()) == list(loaded.state_dict()),
          f"load_native: {path} does not reload bit for bit")
    return loaded, {"save_s": t1 - t0, "load_s": t2 - t1,
                    "bytes": nbytes()}


def _native_serve(torch, model):
    """``slice``'s engine and traffic on ``model``, each group of requests
    submitted in one burst (``_drive``), unprofiled: the outputs and the
    run's record, exactly 12 paged launches a prefill chunk and decode
    step held."""
    import numpy as np
    from bigdl_tpu_torch.serving import ServingEngine
    engine = ServingEngine(model, model.state_dict(), max_slots=8,
                           paged=True, page_size=16, prefill_chunk=64,
                           top_k=50, top_p=0.9, seed=0)
    _, outs, line, _ = _serve_traffic(torch, engine,
                                      np.random.default_rng(0),
                                      profiled=False, burst=True)
    n = len(model.gpt.layers) * (line["prefill_chunks"]
                                 + line["decode_steps"])
    check(line["launches"]["paged_attention"] == n,
          f"load_native: paged attention launched "
          f"{line['launches']['paged_attention']} times, {n} for "
          f"{line['prefill_chunks']} chunks and {line['decode_steps']} "
          f"steps")
    return outs, line


def _native_gpt(torch, kernels, f32_line, root):
    """(a) and (c) of ``load_native`` (module docstring, 6k)."""
    import os

    import numpy as np
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.models.gpt import gpt2_small
    from bigdl_tpu_torch.utils import fileio
    from bigdl_tpu_torch.utils.serializer import load_module, save_module

    model = gpt2_small()
    params = convert.init_params(model, seed=0)
    model.load_state_dict(params)
    n_params = sum(t.numel() for t in model.state_dict().values())
    mem = _MemFS()
    fileio.register_filesystem("mem", mem)
    # the model as built, then each saved and loaded copy, on one schedule
    want, base = _native_serve(torch, model)
    routes = {}
    keys = ("paged_attention", "fused_sampling")
    local = os.path.join(root, "gpt2.bigdl")
    sidecar = os.path.join(root, "gpt2.weights")
    for name, path, wpath, nbytes in (
            ("local", local, sidecar,
             lambda: os.path.getsize(local) + os.path.getsize(sidecar)),
            ("mem", "mem://bucket/gpt2.bigdl", None,
             lambda: len(mem.blobs["mem://bucket/gpt2.bigdl"]))):
        loaded, routes[name] = _native_route(torch, model, path, wpath,
                                             nbytes)
        outs, line = _native_serve(torch, loaded)
        routes[name].update(tokens_per_s=line["tokens_per_s"],
                            launches={k: line["launches"][k] for k in keys})
        for k in keys:
            check(line["launches"][k] == base["launches"][k],
                  f"load_native {name}: {k} launched {line['launches'][k]} "
                  f"times, the unsaved model {base['launches'][k]}")
        same = [bool(np.array_equal(a, b)) for a, b in zip(outs, want)]
        check(all(same), f"load_native {name}: requests "
              f"{[i for i, v in enumerate(same) if not v]} differ from "
              f"the unsaved model's tokens")
        del loaded
        torch.cuda.empty_cache()
    for k in keys:
        kernels[k].setdefault("launches_by_phase", {})["load_native"] = (
            base["launches"][k] + sum(r["launches"][k]
                                      for r in routes.values()))
    # against slice's own run, whose first burst's batches follow the
    # host's timing: greedy tokens by the near-tie rule
    exact = [bool(np.array_equal(want[i], _NO_FAULT["paged"][i]))
             for i in range(12)]
    div = _near_tie_check(torch, "load_native", params, want,
                          _NO_FAULT["paged"], GREEDY_IDX)
    vs_slice = {"tokens_identical": exact, "greedy_divergences": div,
                "slice_launches": {k: f32_line["launches"][k] for k in keys},
                "launches": {k: base["launches"][k] for k in keys},
                "tokens_per_s": base["tokens_per_s"],
                "slice_tokens_per_s": f32_line["tokens_per_s"]}

    # (c) a file the card wrote, read on the CPU, and the reverse
    ids = torch.from_numpy(np.random.default_rng(24).integers(
        0, 50257, NATIVE_CHECK_IDS))
    with torch.no_grad():
        want_card = model.eval()(ids.cuda()).float().cpu()
        on_cpu = load_module(local, device="cpu").eval()
        got_cpu = on_cpu(ids)
    scale = float(got_cpu.abs().max())
    card_vs_cpu = float((want_card - got_cpu).abs().max()) / scale
    cpu_file = os.path.join(root, "gpt2_cpu.bigdl")
    t0 = time.perf_counter()
    save_module(on_cpu, cpu_file)
    cpu_save_s = time.perf_counter() - t0
    with torch.no_grad():
        back = load_module(cpu_file).eval()
        got_card = back(ids.cuda()).float().cpu()
    cpu_file_vs_cpu = float((got_card - got_cpu).abs().max()) / scale
    check(card_vs_cpu <= NATIVE_OUT_REL and cpu_file_vs_cpu <= NATIVE_OUT_REL
          and torch.equal(got_card, want_card),
          f"load_native: card file on the CPU {card_vs_cpu:.3g}, CPU file "
          f"on the card {cpu_file_vs_cpu:.3g} x max|CPU| (bar "
          f"{NATIVE_OUT_REL}); the two card runs bit-equal: "
          f"{torch.equal(got_card, want_card)}")
    del model, on_cpu, back
    return {"model": "gpt2_small", "dtype": "float32", "params": n_params,
            "routes": routes, "tokens_equal_unsaved": True,
            "unsaved_vs_slice": vs_slice,
            "across_devices": {"ids": list(NATIVE_CHECK_IDS),
                               "card_file_on_cpu_rel": card_vs_cpu,
                               "cpu_file_on_card_rel": cpu_file_vs_cpu,
                               "cpu_save_s": cpu_save_s,
                               "bar": NATIVE_OUT_REL}}


def _native_resnet(torch, kernels, root, want):
    """(b) of ``load_native`` (module docstring, 6k): ``train_sharded``'s
    run with native checkpoints, retried from ``model.4`` after the fault
    plan fails the fifth batch, against ``train_sharded``'s uninterrupted
    losses ``want`` (one per step)."""
    import os

    import numpy as np
    from bigdl_tpu_torch.utils import protowire
    from bigdl_tpu_torch.utils.serializer import MAGIC, MODEL_FILE

    setup = _retry_resnet_setup()
    with _deterministic_cudnn(torch):
        opt, losses, steps, reloads, counts, secs = _retry_resnet_run(
            torch, setup, root, plan=NATIVE_PLAN, reload="_reload_gathered")
    with open(os.path.join(root, "model.4"), "rb") as f:
        # the magic alone: the decoder skips the fields a schema leaves out
        magic = protowire.decode(f.read(), {1: MODEL_FILE[1]}).get("magic")
    files = sorted(os.listdir(root))
    check(magic == MAGIC and "model.4" in files and not any(
        f.startswith("shard.") for f in files),
        f"load_native: model.4 magic {magic!r}, files {files}")
    check(opt.retries == 1 and reloads == [4],
          f"load_native: {opt.retries} retries, native reloads {reloads}")
    got = [losses.get(k) for k in range(1, SHARDED_STEPS + 1)]
    check(got == list(want) and all(np.isfinite(want)),
          f"load_native: resumed losses {got} vs uninterrupted {want}")
    routes = setup["routes"]
    for kind in ("k9", "i2c"):
        check(counts[kind] == 0 and counts[f"{kind}_cuda_core"]
              == routes[kind] * len(SHARDED_MESH) * steps,
              f"load_native: conv3x3_{kind} ran {counts[kind]} tensor-core "
              f"and {counts[f'{kind}_cuda_core']} CUDA-core launches for "
              f"{steps} steps x {len(SHARDED_MESH)} replicas of "
              f"{routes[kind]}")
        kernels[f"conv3x3_{kind}"].setdefault("launches_by_phase", {})[
            "load_native"] = counts[f"{kind}_cuda_core"]
    check("3x3/s1" not in counts["library"],
          f"load_native: a 3x3 stride-1 convolution reached F.conv2d: "
          f"{counts['library']}")
    return {"model": "resnet50", "image": RESNET_HW, "batch": SHARDED_BATCH,
            "replicas": len(SHARDED_MESH), "plan": NATIVE_PLAN,
            "model_file_bytes": os.path.getsize(os.path.join(root,
                                                             "model.4")),
            "resumed_from": reloads, "steps_run": steps, "losses": got,
            "losses_bit_equal": True, "run_s": secs,
            "cuda_core_launches": {k: counts[f"{k}_cuda_core"]
                                   for k in ("k9", "i2c")},
            "conv_routes_per_step": routes}


def phase_load_native(torch, kernels, smi, f32_line, sharded_losses):
    """The native model format on the card (see module docstring, 6k)."""
    import os
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="chip_smoke_native_")
    try:
        t0 = time.perf_counter()
        gpt = _native_gpt(torch, kernels, f32_line, root)
        gpt_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        resnet = _native_resnet(torch, kernels,
                                os.path.join(root, "resnet"), sharded_losses)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "load_native", "gpt2": gpt, "gpt2_s": gpt_s,
          "resnet50": resnet, "card": smi})


# ------------------------------------------------------------- A.9(c)
INT8_BATCH, INT8_CHECK_ROWS, INT8_ACC_ROWS = 32, 8, 4
INT8_AMAX_REL = 1e-5
# tests/test_torch_quantizer.py's bars: quantised log-probabilities within
# MODEL_TOL of the other's, top-1 agreeing with the float model's on at
# least TOP1_AGREE of the rows
INT8_MODEL_TOL, INT8_TOP1_AGREE = 1e-2, 0.9
INT8_TIMED = 25        # about a second of forwards a variant
# the int8 convolutions whose int32 accumulators are held exactly: the
# stem (7x7/s2), a 1x1, a 3x3 and a strided 3x3
INT8_ACC_LAYERS = ("conv1", "res2_0_conv1", "res2_0_conv2", "res3_0_conv2")


class _int8_product_ranges:
    """While active, every int8 product runs inside a
    ``record_function("int8_product")`` range, so a profile attributes its
    device time (a measurement-only wrapper of ``nn.quantized._int_mm``)."""

    def __init__(self, torch):
        from bigdl_tpu_torch.nn import quantized
        self.q, self.real, self.torch = quantized, quantized._int_mm, torch

    def _ranged(self, a, b):
        with self.torch.profiler.record_function("int8_product"):
            return self.real(a, b)

    def __enter__(self):
        self.q._int_mm = self._ranged

    def __exit__(self, *exc):
        self.q._int_mm = self.real


def _timed_forward(torch, model, x):
    """(seconds a forward, after one untimed) over INT8_TIMED forwards."""
    model(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(INT8_TIMED):
        model(x)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / INT8_TIMED


def _int8_inputs(torch, qmodel, names, x):
    """The float inputs of the layers ``names`` in one forward of
    ``qmodel``."""
    seen, handles = {}, []
    for name in names:
        def keep(module, args, name=name):
            seen.setdefault(name, args[0])

        handles.append(getattr(qmodel, name).register_forward_pre_hook(keep))
    try:
        qmodel(x)
    finally:
        for h in handles:
            h.remove()
    return seen


def _plain_acc(torch, layer, xq):
    """The plain CPU int32 accumulator of an int8 NHWC input: a float64
    convolution (exact: every sum is below 2^53) of the same values."""
    import torch.nn.functional as F
    x = xq.cpu().double().permute(0, 3, 1, 2)
    (t, b), (l, r) = layer.padding(*xq.shape[1:3])
    y = F.conv2d(F.pad(x, (l, r, t, b)), layer.weight.cpu().double(),
                 stride=(layer.stride_h, layer.stride_w),
                 dilation=(layer.dilation_h, layer.dilation_w),
                 groups=layer.n_group)
    return y.permute(0, 2, 3, 1).to(torch.int32)


def phase_infer_int8(torch, kernels, smi):
    """Post-training int8 quantisation of ResNet-50 (see module
    docstring, 6i)."""
    import copy

    import numpy as np
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.models import ResNet
    from bigdl_tpu_torch.nn import (QuantizedSpatialConvolution, Quantizer,
                                    SpatialConvolution)
    from bigdl_tpu_torch.nn.quantized import _quant_input

    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.standard_normal(
        (INT8_BATCH, RESNET_HW, RESNET_HW, 3), dtype=np.float32))
    xc, xg = x[:INT8_CHECK_ROWS], x.to("cuda")
    params = convert.init_resnet_params(
        ResNet(class_num=1000, depth=50, format="NHWC", device="cpu"),
        seed=0)
    model = ResNet(class_num=1000, depth=50, format="NHWC")
    model.load_state_dict(params)
    model.eval()
    cpu = ResNet(class_num=1000, depth=50, format="NHWC", device="cpu")
    cpu.load_state_dict(params)
    cpu.eval()
    out = {"batch": INT8_BATCH, "image": RESNET_HW}
    with torch.no_grad():
        t0 = time.perf_counter()
        q_static = Quantizer.quantize(model, calib_input=xg)
        torch.cuda.synchronize()
        out["quantize_calibrated_s"] = time.perf_counter() - t0
        q_dyn = Quantizer.quantize(model)
        f = model(xg)
        lib = dict(SpatialConvolution.library_calls)
        ys, yd = q_static(xg), q_dyn(xg)
        check(dict(SpatialConvolution.library_calls) == lib,
              "infer_int8: a quantised model reached F.conv2d: "
              f"{dict(SpatialConvolution.library_calls)} after {lib}")
        agree = {k: float((y.argmax(-1) == f.argmax(-1)).float().mean())
                 for k, y in (("static", ys), ("dynamic", yd))}
        check(min(agree.values()) >= INT8_TOP1_AGREE,
              f"infer_int8: top-1 agreement with the float model {agree}")
        out["top1_agreement_with_float"] = agree
        # static amaxes: calibration on the card against the CPU port's,
        # on the same rows
        q_card8 = Quantizer.quantize(model, calib_input=xc.to("cuda"))
        q_cpu8 = Quantizer.quantize(cpu, calib_input=xc)
        pairs = [(float(a.in_scale), float(c.in_scale))
                 for a, c in zip(_quantized(q_card8), _quantized(q_cpu8))]
        amax_rel = max(abs(a - c) / c for a, c in pairs)
        check(len(pairs) == 54 and amax_rel <= INT8_AMAX_REL,
              f"infer_int8: {len(pairs)} static scales, worst relative "
              f"difference card vs CPU {amax_rel}")
        out["amax_max_rel"] = amax_rel
        # logits: the card's int8 models against the same int8 models on
        # the CPU (static scales make rows independent)
        s_cpu = copy.deepcopy(q_static).to("cpu")
        d_cpu = copy.deepcopy(q_dyn).to("cpu")
        diffs = {"static": float((ys[:INT8_CHECK_ROWS].cpu()
                                  - s_cpu(xc)).abs().max()),
                 "dynamic": float((q_dyn(xc.to("cuda")).cpu()
                                   - d_cpu(xc)).abs().max())}
        check(max(diffs.values()) <= INT8_MODEL_TOL,
              f"infer_int8: int8 log-probabilities card vs CPU {diffs}")
        out["logprob_max_abs_diff_vs_cpu"] = diffs
        # int32 accumulators, exactly, on the card's int8 inputs
        inputs = _int8_inputs(torch, q_static, INT8_ACC_LAYERS,
                              xg[:INT8_ACC_ROWS])
        acc = {}
        for name in INT8_ACC_LAYERS:
            layer = getattr(q_static, name)
            check(isinstance(layer, QuantizedSpatialConvolution),
                  f"infer_int8: {name} is {type(layer).__name__}")
            xq, _ = _quant_input(inputs[name], layer.in_scale)
            got = layer.accumulate(xq).cpu()
            want = _plain_acc(torch, layer, xq)
            acc[name] = {"equal": bool(torch.equal(got, want)),
                         "max_abs": int(want.abs().max()),
                         "shape": list(got.shape)}
        check(all(v["equal"] for v in acc.values()),
              f"infer_int8: int32 accumulators card vs plain CPU {acc}")
        out["int32_accumulators"] = acc
        # images/s, float32 and int8, in one call
        secs = {"float32": _timed_forward(torch, model, xg),
                "int8_static": _timed_forward(torch, q_static, xg),
                "int8_dynamic": _timed_forward(torch, q_dyn, xg)}
        out["seconds_per_batch"] = secs
        out["images_per_s"] = {k: INT8_BATCH / v for k, v in secs.items()}
        with _int8_product_ranges(torch):
            out["profile_int8_static"] = _profile(
                torch, lambda: q_static(xg), ranges=("int8_product",))
    emit({"phase": "infer_int8", **out, "card": smi})


def _quantized(model):
    from bigdl_tpu_torch.nn import QuantizedLinear, QuantizedSpatialConvolution
    return [m for m in model.modules()
            if isinstance(m, (QuantizedLinear, QuantizedSpatialConvolution))]


# ------------------------------------------------------------ A.11(c)
# PTBModel() at its defaults (vocabulary 10000, hidden 256, 2 LSTM layers)
# on a seeded Zipf stream cut by ptb_batches(20, 20), 5 steps of Adam(0.01)
PTB_BATCH, PTB_NUM_STEPS, PTB_TRAIN_STEPS, PTB_ZIPF = 20, 20, 5, 1.0
PTB_TIMED = 25         # steady steps timed, about a second
# tests/test_torch_recurrent.py's and test_torch_text_treelstm.py's bars:
# outputs 1e-5 absolute, gradients 1e-4 of their largest magnitude, losses
# 1e-6 relative
RNN_OUT_TOL, RNN_GRAD_REL, RNN_LOSS_REL = 1e-5, 1e-4, 1e-6
CONVLSTM_SHAPE = (8, 6, 16, 32, 32)     # (batch, time, channels, H, W)
CONVLSTM_3D_SHAPE = (2, 3, 4, 8, 8, 8)
# the constituency Tree-LSTM for sentiment of Tai, Socher and Manning (ACL
# 2015, section 5.1 and table 1): 300-d word vectors, memory dimension 150,
# the Stanford Sentiment Treebank's 21701 words; trees of 2 to 56 tokens
TREES, TREE_VOCAB, TREE_EMB, TREE_HIDDEN = 64, 21701, 300, 150
TREE_LEN = (2, 56)
TREE_TIMED = 5


def _worst_grad(grads_g, grads_c):
    """max over tensors of max|card - CPU| / max|CPU|, and its name."""
    worst, name = 0.0, None
    for k, gc in grads_c.items():
        r = float((grads_g[k].cpu() - gc).abs().max()) / max(
            float(gc.abs().max()), 1e-30)
        if r > worst:
            worst, name = r, k
    return worst, name


def _ptb(torch, smi):
    import numpy as np
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
    from bigdl_tpu_torch.dataset.text import ptb_batches
    from bigdl_tpu_torch.models import PTBModel
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.optim import (Adam, Optimizer, Trigger,
                                       make_loss_and_grads, make_train_step)

    vocab = 10000
    rng = np.random.default_rng(22)
    p = 1.0 / np.arange(1, vocab + 1) ** PTB_ZIPF
    n = PTB_BATCH * PTB_NUM_STEPS * PTB_TRAIN_STEPS + 1
    stream = rng.choice(vocab, n, p=p / p.sum())
    batches = list(ptb_batches(stream, PTB_BATCH, PTB_NUM_STEPS))
    crit = TimeDistributedCriterion(ClassNLLCriterion(), size_average=True)
    model = PTBModel()
    model.reset(22)
    w0 = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    # the first step's loss and gradients against the port on the CPU
    x0, y0 = (torch.from_numpy(a.astype(np.int64)) for a in batches[0])
    loss_g, grads_g = make_loss_and_grads(model, crit)(x0.to("cuda"),
                                                       y0.to("cuda"))
    cpu = PTBModel(device="cpu")
    cpu.load_state_dict(w0)
    loss_c, grads_c = make_loss_and_grads(cpu, crit)(x0, y0)
    loss_rel = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    worst, worst_name = _worst_grad(grads_g, grads_c)
    check(loss_rel <= RNN_LOSS_REL and worst <= RNN_GRAD_REL,
          f"train_rnn PTB: first loss {float(loss_g)} vs CPU "
          f"{float(loss_c)} (rel {loss_rel}); worst gradient {worst_name} "
          f"at {worst} of its max")
    # 5 steps through the facade, the batches in ptb_batches' order
    ds = DataSet.array([Sample(x[r], y[r]) for x, y in batches
                        for r in range(PTB_BATCH)])
    ds.shuffle = lambda seed=None: ds
    model.load_state_dict(w0)
    opt = Optimizer(model=model, dataset=ds >> SampleToMiniBatch(PTB_BATCH),
                    criterion=crit)
    opt.set_optim_method(Adam(learningrate=0.01))
    opt.set_end_when(Trigger.max_iteration(PTB_TRAIN_STEPS))
    log = _Scalars()
    opt.set_train_summary(log)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = log.losses
    check(len(losses) == PTB_TRAIN_STEPS and all(np.isfinite(losses))
          and losses[-1] < losses[0],
          f"train_rnn PTB: facade losses {losses}")
    # steady step time and the busy share: make_train_step on batch 0
    method = Adam(learningrate=0.01)
    step = make_train_step(model, crit, method)
    state = method.init_state(dict(model.named_parameters()))
    xg, yg = x0.to("cuda"), y0.to("cuda")
    step(state, xg, yg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(PTB_TIMED):
        step(state, xg, yg)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t1) / PTB_TIMED
    prof = _profile(torch, lambda: [step(state, xg, yg) for _ in range(2)])
    tokens = PTB_BATCH * PTB_NUM_STEPS
    return {"vocab": vocab, "hidden": 256, "layers": 2, "batch": PTB_BATCH,
            "num_steps": PTB_NUM_STEPS, "optimizer": "Adam(0.01)",
            "first_loss_card": float(loss_g), "first_loss_cpu":
            float(loss_c), "first_loss_rel": loss_rel,
            "worst_grad_rel": worst, "worst_grad": worst_name,
            "facade_losses": losses, "facade_s": wall,
            "facade_ms_per_step": wall / PTB_TRAIN_STEPS * 1e3,
            "ms_per_step": step_s * 1e3, "tokens_per_s": tokens / step_s,
            "profile": prof}


def _conv_lstm(torch, kernels):
    import numpy as np
    from bigdl_tpu_torch.nn import (ConvLSTMPeephole, ConvLSTMPeephole3D,
                                    Recurrent)

    def pair(make, shape, seed, grad):
        card = Recurrent(make(None))
        card.reset(seed)
        cpu = Recurrent(make("cpu"))
        cpu.load_state_dict({k: v.cpu() for k, v in
                             card.state_dict().items()})
        rng = np.random.default_rng(seed)
        x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        xg = x.to("cuda").detach().requires_grad_(grad)
        xc = x.detach().clone().requires_grad_(grad)
        torch.cuda.synchronize()
        _reset_conv_counts()
        yg = card(xg)
        ct = torch.from_numpy(rng.standard_normal(tuple(yg.shape),
                                                  dtype=np.float32))
        if grad:
            (yg * ct.to("cuda")).sum().backward()
        torch.cuda.synchronize()
        counts = _conv_counts()
        yc = cpu(xc)
        diff = (yg.detach().cpu() - yc.detach()).abs().max()
        out = {"out_max_abs": float(diff), "launches": counts}
        if grad:
            (yc * ct).sum().backward()
            grads_g = {k: p.grad for k, p in card.named_parameters()}
            grads_g["input"] = xg.grad
            grads_c = {k: p.grad for k, p in cpu.named_parameters()}
            grads_c["input"] = xc.grad
            out["worst_grad_rel"], out["worst_grad"] = _worst_grad(
                grads_g, grads_c)
        return out

    t = CONVLSTM_SHAPE[1]
    main = pair(lambda d: ConvLSTMPeephole(16, 16, 3, 3, device=d),
                CONVLSTM_SHAPE, 23, True)
    c = main["launches"]
    # 2 x T forward; the input gradient of each input convolution and of
    # each hidden convolution but the first (the zero state needs none)
    want = 2 * t + t + (t - 1)
    check(c["k9"] == c["i2c"] == 0
          and c["k9_cuda_core"] + c["i2c_cuda_core"] == want
          and "3x3/s1" not in c["library"],
          f"train_rnn ConvLSTM: launches {c}, expected {want} CUDA-core "
          "3x3 launches and no 3x3/s1 F.conv2d")
    check(main["out_max_abs"] <= RNN_OUT_TOL
          and main["worst_grad_rel"] <= RNN_GRAD_REL,
          f"train_rnn ConvLSTM card vs CPU: {main}")
    for kind in ("k9", "i2c"):
        kernels[f"conv3x3_{kind}"].setdefault("launches_by_phase", {})[
            "train_rnn"] = c[f"{kind}_cuda_core"]
    stride2 = pair(lambda d: ConvLSTMPeephole(16, 16, 3, 3, stride=2,
                                              device=d),
                   CONVLSTM_SHAPE, 24, False)
    vol = pair(lambda d: ConvLSTMPeephole3D(4, 4, 3, 3, device=d),
               CONVLSTM_3D_SHAPE, 25, False)
    for name, r in (("stride 2", stride2), ("3-D", vol)):
        check(r["out_max_abs"] <= RNN_OUT_TOL,
              f"train_rnn ConvLSTM {name} card vs CPU: {r}")
    return {"shape": list(CONVLSTM_SHAPE), "expected_launches": want,
            "stride1": main, "stride2_forward": stride2,
            "conv3d_forward": vol}


def _tree_batch(seqs):
    """Right-branching trees over token sequences, as
    ``tests/test_text_treelstm.py`` builds them: (word ids (B, N), children
    (B, N, 2), 1-based roots (B,))."""
    import numpy as np
    b, n = len(seqs), 2 * max(len(t) for t in seqs) - 1
    tree = np.zeros((b, n, 2), np.int32)
    word = np.zeros((b, n), np.int32)
    roots = np.zeros((b,), np.int32)
    for i, toks in enumerate(seqs):
        word[i, :len(toks)] = toks
        cur, slot = 1, len(toks) + 1
        for j in range(1, len(toks)):
            tree[i, slot - 1] = (cur, j + 1)
            cur, slot = slot, slot + 1
        roots[i] = cur
    return word, tree, roots


def _tree_lstm(torch):
    import numpy as np
    from bigdl_tpu_torch.nn import (BinaryTreeLSTM, CrossEntropyCriterion,
                                    Linear, LookupTable, Sequential,
                                    TreeGather)
    from bigdl_tpu_torch.optim import TreeNNAccuracy

    rng = np.random.default_rng(0)
    seqs, labels = [], []
    for _ in range(TREES):
        n = int(rng.integers(TREE_LEN[0], TREE_LEN[1] + 1))
        toks = rng.integers(1, TREE_VOCAB, n)
        seqs.append(toks.tolist())
        labels.append(int((np.where(toks <= TREE_VOCAB // 2, 1, -1)).sum()
                          > 0))
    word, tree, roots = (torch.from_numpy(a) for a in _tree_batch(seqs))
    labels = torch.tensor(labels)

    def build(device):
        return Sequential().add(LookupTable(TREE_VOCAB, TREE_EMB,
                                            device=device)).add(
            BinaryTreeLSTM(TREE_EMB, TREE_HIDDEN, device=device)).add(
            Linear(TREE_HIDDEN, 2, device=device))

    def run(m, dev):
        emb, tl, head = m[0], m[1], m[2]
        hs = tl([emb(word.to(dev)), tree.to(dev)])
        logits = head(TreeGather()([hs, roots.to(dev)]))
        loss = CrossEntropyCriterion()(logits, labels.to(dev))
        loss.backward()
        grads = {k: p.grad for k, p in m.named_parameters()}
        acc = TreeNNAccuracy().counters(logits.detach()[:, None, :],
                                        labels.to(dev))
        return float(loss.detach()), logits.detach().cpu(), grads, \
            (int(acc[0]), int(acc[1]))

    card = build(None)
    card.reset(26)
    cpu = build("cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    loss_g, logits_g, grads_g, acc_g = run(card, "cuda")
    loss_c, logits_c, grads_c, acc_c = run(cpu, "cpu")
    worst, worst_name = _worst_grad(grads_g, grads_c)
    out = {"trees": TREES, "vocab": TREE_VOCAB, "embed": TREE_EMB,
           "hidden": TREE_HIDDEN, "nodes": int(tree.shape[1]),
           "loss_card": loss_g, "loss_cpu": loss_c,
           "logits_max_abs": float((logits_g - logits_c).abs().max()),
           "worst_grad_rel": worst, "worst_grad": worst_name,
           "tree_nn_accuracy": {"card": acc_g, "cpu": acc_c}}
    check(abs(loss_g - loss_c) / abs(loss_c) <= RNN_LOSS_REL
          and out["logits_max_abs"] <= RNN_OUT_TOL
          and worst <= RNN_GRAD_REL and acc_g == acc_c,
          f"train_rnn tree-LSTM card vs CPU: {out}")
    # a forward and backward on the card, after the checked one
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TREE_TIMED):
        card.zero_grad(set_to_none=True)
        run(card, "cuda")
    torch.cuda.synchronize()
    out["card_ms_per_batch"] = (time.perf_counter() - t0) / TREE_TIMED * 1e3
    return out


def phase_train_rnn(torch, kernels, smi):
    """The recurrent and tree models (see module docstring, 6j)."""
    ptb = _ptb(torch, smi)
    torch.cuda.empty_cache()
    conv = _conv_lstm(torch, kernels)
    tree = _tree_lstm(torch)
    emit({"phase": "train_rnn", "ptb": ptb, "conv_lstm": conv,
          "tree_lstm": tree, "card": smi})


# ------------------------------------------------------------------ detect
# A detector's convolutional stages as (kind, ...) layers: ("conv", cin,
# cout[, k, stride, pad, dilation]) a convolution (3x3, stride 1, pad 1
# where not given) and its ReLU; ("pool", k, stride, pad) a max pooling in
# Caffe's ceil mode (300 -> 150 -> 75 -> 38 -> 19)
VGG16_CONV1_4 = [("conv", 3, 64), ("conv", 64, 64), ("pool", 2, 2, 0),
                 ("conv", 64, 128), ("conv", 128, 128), ("pool", 2, 2, 0),
                 ("conv", 128, 256), ("conv", 256, 256), ("conv", 256, 256),
                 ("pool", 2, 2, 0), ("conv", 256, 512), ("conv", 512, 512),
                 ("conv", 512, 512)]
VGG16_CONV5 = [("pool", 2, 2, 0), ("conv", 512, 512), ("conv", 512, 512),
               ("conv", 512, 512)]
# Liu et al.'s ssd_pascal.py (VGG_VOC0712_SSD_300x300): the stages whose
# outputs are the source maps (conv4_3, under NormalizeScale(20); fc7, after
# pool5 3x3/s1/p1 and fc6 dilated 6; conv6_2 to conv9_2), each source's
# PriorBox (min size, max size, aspect ratios, step; flip on, clip off,
# variances 0.1/0.1/0.2/0.2, offset 0.5) and the DetectionOutput settings
SSD300 = {
    "image": 300, "classes": 21, "norm_scale": 20.0,
    "stages": [VGG16_CONV1_4,
               VGG16_CONV5 + [("pool", 3, 1, 1),
                              ("conv", 512, 1024, 3, 1, 6, 6),
                              ("conv", 1024, 1024, 1, 1, 0)],
               [("conv", 1024, 256, 1, 1, 0), ("conv", 256, 512, 3, 2, 1)],
               [("conv", 512, 128, 1, 1, 0), ("conv", 128, 256, 3, 2, 1)],
               [("conv", 256, 128, 1, 1, 0), ("conv", 128, 256, 3, 1, 0)],
               [("conv", 256, 128, 1, 1, 0), ("conv", 128, 256, 3, 1, 0)]],
    "priors": [(30.0, 60.0, [2.0], 8.0), (60.0, 111.0, [2.0, 3.0], 16.0),
               (111.0, 162.0, [2.0, 3.0], 32.0),
               (162.0, 213.0, [2.0, 3.0], 64.0),
               (213.0, 264.0, [2.0], 100.0), (264.0, 315.0, [2.0], 300.0)],
    "detection": dict(n_classes=21, nms_thresh=0.45, nms_topk=400,
                      keep_top_k=200, conf_thresh=0.01),
}
SSD300_PRIORS = 8732
# py-faster-rcnn's VGG16/faster_rcnn_end2end/test.prototxt with its TEST
# settings (RPN_PRE_NMS_TOP_N 6000, RPN_POST_NMS_TOP_N 300,
# RPN_NMS_THRESH 0.7, RPN_MIN_SIZE 16, NMS 0.3), on one 600 x 800 image
FRCNN_VGG16 = {
    "image": (600, 800), "classes": 21, "trunk": VGG16_CONV1_4,
    "conv5": VGG16_CONV5, "rpn": 512, "ratios": [0.5, 1.0, 2.0],
    "scales": [8.0, 16.0, 32.0],
    "proposal": dict(pre_nms_topn=6000, post_nms_topn=300, nms_thresh=0.7,
                     min_size=16.0),
    "pooled": 7, "spatial_scale": 1.0 / 16, "fc": 4096,
    "detection": dict(n_classes=21, nms_thresh=0.3, conf_thresh=0.05,
                      keep_top_k=100),
}


def det_stage(nn, layers, **kw):
    """A ``Sequential`` of ``layers`` (see above) in package ``nn``: the
    port's, or the reference's in the CPU tests; ``kw`` goes to every
    layer with weights (the port's ``device``)."""
    seq = nn.Sequential()
    for layer in layers:
        if layer[0] == "pool":
            _, k, s, p = layer
            seq.add(nn.SpatialMaxPooling(k, k, s, s, p, p).ceil())
            continue
        cin, cout, k, s, p, d = tuple(layer[1:]) + (3, 1, 1, 1)[
            len(layer) - 3:]
        seq.add(nn.SpatialDilatedConvolution(cin, cout, k, k, s, s, p, p, d,
                                             d, **kw) if d > 1 else
                nn.SpatialConvolution(cin, cout, k, k, s, s, p, p, **kw))
        seq.add(nn.ReLU())
    return seq


def _width(layers):
    return [layer for layer in layers if layer[0] == "conv"][-1][2]


def ssd_build(nn, cfg, **kw):
    """SSD's layers from ``cfg`` (``SSD300``'s layout) in package ``nn``
    (``det_stage``): ``{"stages", "norm", "loc", "conf", "priors",
    "det"}``, the heads 3x3 pad-1 convolutions of each source map."""
    widths = [_width(s) for s in cfg["stages"]]
    priors = [nn.PriorBox([mn], [mx], ars, flip=True, clip=False,
                          variances=[0.1, 0.1, 0.2, 0.2],
                          img_size=cfg["image"], step=step)
              for mn, mx, ars, step in cfg["priors"]]

    def head(cin, cout):
        return nn.SpatialConvolution(cin, cout, 3, 3, 1, 1, 1, 1, **kw)

    return {"stages": [det_stage(nn, s, **kw) for s in cfg["stages"]],
            "norm": nn.NormalizeScale(scale=cfg["norm_scale"],
                                      size=(1, widths[0], 1, 1), **kw),
            "loc": [head(w, p.num_priors * 4)
                    for w, p in zip(widths, priors)],
            "conf": [head(w, p.num_priors * cfg["classes"])
                     for w, p in zip(widths, priors)],
            "priors": priors,
            "det": nn.DetectionOutputSSD(**cfg["detection"])}


def frcnn_build(nn, cfg, **kw):
    """Faster R-CNN's layers from ``cfg`` (``FRCNN_VGG16``'s layout) in
    package ``nn`` (``det_stage``): ``{"trunk", "conv5", "rpn_conv",
    "rpn_cls", "rpn_bbox", "proposal", "roi", "fc", "cls", "bbox",
    "det"}``."""
    a = len(cfg["ratios"]) * len(cfg["scales"])
    width, c, k = _width(cfg["conv5"]), cfg["classes"], cfg["pooled"]
    fc = nn.Sequential()
    for layer in (nn.Linear(width * k * k, cfg["fc"], **kw), nn.ReLU(),
                  nn.Linear(cfg["fc"], cfg["fc"], **kw), nn.ReLU()):
        fc.add(layer)
    return {"trunk": det_stage(nn, cfg["trunk"], **kw),
            "conv5": det_stage(nn, cfg["conv5"], **kw),
            "rpn_conv": nn.SpatialConvolution(width, cfg["rpn"], 3, 3, 1, 1,
                                              1, 1, **kw),
            "rpn_cls": nn.SpatialConvolution(cfg["rpn"], 2 * a, 1, 1, **kw),
            "rpn_bbox": nn.SpatialConvolution(cfg["rpn"], 4 * a, 1, 1, **kw),
            "proposal": nn.Proposal(ratios=cfg["ratios"],
                                    scales=cfg["scales"], **cfg["proposal"]),
            "roi": nn.RoiPooling(k, k, cfg["spatial_scale"]),
            "fc": fc, "cls": nn.Linear(cfg["fc"], c, **kw),
            "bbox": nn.Linear(cfg["fc"], 4 * c, **kw),
            "det": nn.DetectionOutputFrcnn(**cfg["detection"])}


def rpn_train_model(nn, parts):
    """conv5 and the RPN of ``frcnn_build``'s ``parts`` (the same
    modules) as one trainable ``Sequential``: it takes conv4_3's output
    and gives the table (rpn_cls_score reshaped to (N, 2, A*H, W), as the
    prototxt's ``rpn_cls_score_reshape``, and rpn_bbox_pred)."""
    score = nn.Sequential()
    score.add(parts["rpn_cls"])
    score.add(nn.InferReshape((0, 2, -1, 0)))
    heads = nn.ConcatTable()
    heads.add(score)
    heads.add(parts["rpn_bbox"])
    model = nn.Sequential()
    for layer in (parts["conv5"], parts["rpn_conv"], nn.ReLU(), heads):
        model.add(layer)
    return model


def rpn_criterion(nn):
    """The RPN's loss: softmax over the labelled anchors (-1 ignored) and
    smooth L1 (sigma 3) of the weighted box targets."""
    crit = nn.ParallelCriterion()
    crit.add(nn.SoftmaxWithCriterion(ignore_label=-1))
    crit.add(nn.SmoothL1CriterionWithWeights(sigma=3.0))
    return crit


def rpn_targets(np, rng, a, h, w, fg=64, bg=192):
    """Seeded RPN targets of one image, as py-faster-rcnn's
    AnchorTargetLayer lays them out: labels (1, A*H, W), 1 on ``fg`` and
    0 on ``bg`` sampled anchors, -1 elsewhere; box targets (1, 4A, H, W);
    inside weights 1 on the foreground anchors' four coordinates; outside
    weights 1/(fg + bg) on every sampled anchor."""
    picked = rng.permutation(a * h * w)[:fg + bg]
    lab = np.full(a * h * w, -1, np.int64)
    lab[picked[:fg]] = 1
    lab[picked[fg:]] = 0
    lab = lab.reshape(a, h, w)
    targets = rng.standard_normal((1, 4 * a, h, w)).astype(np.float32) * 0.5
    inside = np.repeat((lab == 1).astype(np.float32), 4, axis=0)[None]
    outside = np.repeat((lab >= 0).astype(np.float32) / (fg + bg), 4,
                        axis=0)[None]
    return lab.reshape(1, a * h, w), [targets, inside, outside]


def as_module(torch, parts):
    """``*_build``'s dict as one ``torch.nn.ModuleDict`` (lists as
    ``ModuleList``s): one state_dict, ``to`` and seeded weights."""
    return torch.nn.ModuleDict({
        k: torch.nn.ModuleList(v) if isinstance(v, list) else v
        for k, v in parts.items()})


def ssd_forward(torch, m, x, shapes=None):
    """(loc (N, P*4), conf (N, P*classes), priors (1, 2, P*4)) of SSD
    parts ``m`` on images ``x``: each source map's heads permuted to (N,
    H, W, channels) and flattened (Caffe's ``Permute`` and ``Flatten``),
    concatenated. ``shapes`` collects each stage's input and output (H,
    W)."""
    n = x.shape[0]
    locs, confs, priors = [], [], []
    h = x
    for i, stage in enumerate(m["stages"]):
        hw = tuple(h.shape[2:])
        h = stage(h)
        if shapes is not None:
            shapes.append((hw, tuple(h.shape[2:])))
        src = m["norm"](h) if i == 0 else h
        locs.append(m["loc"][i](src).permute(0, 2, 3, 1).reshape(n, -1))
        confs.append(m["conf"][i](src).permute(0, 2, 3, 1).reshape(n, -1))
        priors.append(m["priors"][i](src))
    return torch.cat(locs, 1), torch.cat(confs, 1), torch.cat(priors, 2)


def frcnn_rpn(torch, m, x):
    """conv5_3 and the RPN's maps on one image ``x``: (features, prob (1,
    2A, H, W), deltas (1, 4A, H, W)), prob the softmax over each anchor's
    (background, object) pair (the prototxt's ``rpn_cls_prob``)."""
    f = m["conv5"](m["trunk"](x))
    r = torch.relu(m["rpn_conv"](f))
    score = m["rpn_cls"](r)
    n, c2, h, w = score.shape
    prob = torch.softmax(score.reshape(n, 2, -1, w), 1).reshape(n, c2, h, w)
    return f, prob, m["rpn_bbox"](r)


def frcnn_classify(torch, m, pooled):
    """(class probabilities (R, classes), box deltas (R, 4 classes)) of
    the pooled RoIs (R, C, 7, 7)."""
    h = m["fc"](pooled.reshape(pooled.shape[0], -1))
    return torch.softmax(m["cls"](h), -1), m["bbox"](h)


def frcnn_head(torch, m, f, rois):
    """``frcnn_classify`` of ``rois`` pooled from conv5_3 ``f``."""
    return frcnn_classify(torch, m, m["roi"]([f, rois]))


def frcnn_forward(torch, m, x, im_info):
    """Faster R-CNN's test-time pass on one image: (rois, their scores,
    the detection rows)."""
    f, prob, deltas = frcnn_rpn(torch, m, x)
    rois, scores = m["proposal"]([prob, deltas, im_info])
    cls_prob, bbox_pred = frcnn_head(torch, m, f, rois)
    return rois, scores, m["det"]([cls_prob, bbox_pred, rois, im_info])


# the 39 criterions at small seeded shapes: name -> (criterion of package
# ``nn``, inputs (input, target) from numpy and a generator; lists are
# tables), one case per criterion and option set (the CPU tests hold each
# against the reference; ``detect`` the card against the CPU)
def _c_logits(np, r, *shape):
    return r.standard_normal(shape).astype(np.float32)


def _c_probs(np, r, n, c):
    e = np.exp(_c_logits(np, r, n, c))
    return (e / e.sum(1, keepdims=True)).astype(np.float32)


def _c_labels(np, r, n, c):
    return r.integers(0, c, n).astype(np.int64)


def _c_pm1(np, r, n):
    return (r.integers(0, 2, n) * 2 - 1).astype(np.float32)


def _c_near(np, r, x):
    """A target pointing near ``x``: a cosine loss of unrelated vectors
    averages terms of both signs to about 0."""
    return (x + 0.5 * r.standard_normal(x.shape)).astype(np.float32)


def _c_multi_hot(np, r, n, c):
    t = r.integers(0, 2, (n, c)).astype(np.float32)
    t[:, 0] = 1.0                       # every row has a positive class
    return t


def _c_bits(np, r, *shape):
    return r.integers(0, 2, shape).astype(np.float32)


def _c_rpn_labels(np, r, n=2, h=6, w=5):
    lab = r.integers(0, 2, (n, h, w)).astype(np.int64)
    lab[r.random((n, h, w)) < 0.3] = -1
    return lab


def _c_box_targets(np, r, *shape):
    return [_c_logits(np, r, *shape), _c_bits(np, r, *shape),
            np.full(shape, 0.25, np.float32)]


CRITERION_CASES = {
    "ClassNLLCriterion": (
        lambda nn: nn.ClassNLLCriterion(),
        lambda np, r: (np.log(_c_probs(np, r, 6, 5)),
                       _c_labels(np, r, 6, 5))),
    "ClassNLLCriterion_weights_padding": (
        lambda nn: nn.ClassNLLCriterion([1.0, 2.0, 0.5, 1.5, 1.0]),
        lambda np, r: (np.log(_c_probs(np, r, 6, 5)),
                       np.array([0, -1, 2, 4, -1, 1], np.int64))),
    "ClassNLLCriterion_probabilities": (
        lambda nn: nn.ClassNLLCriterion(log_prob_as_input=False,
                                        size_average=False),
        lambda np, r: (_c_probs(np, r, 6, 5), _c_labels(np, r, 6, 5))),
    "CrossEntropyCriterion": (
        lambda nn: nn.CrossEntropyCriterion(),
        lambda np, r: (_c_logits(np, r, 6, 5), _c_labels(np, r, 6, 5))),
    "MSECriterion": (
        lambda nn: nn.MSECriterion(),
        lambda np, r: (_c_logits(np, r, 4, 5), _c_logits(np, r, 4, 5))),
    "MSECriterion_sum": (
        lambda nn: nn.MSECriterion(size_average=False),
        lambda np, r: (_c_logits(np, r, 4, 5), _c_logits(np, r, 4, 5))),
    "AbsCriterion": (
        lambda nn: nn.AbsCriterion(),
        lambda np, r: (_c_logits(np, r, 4, 5), _c_logits(np, r, 4, 5))),
    "BCECriterion": (
        lambda nn: nn.BCECriterion(),
        lambda np, r: (_c_probs(np, r, 4, 5).clip(0.05, 0.95),
                       _c_bits(np, r, 4, 5))),
    "BCECriterion_weights": (
        lambda nn: nn.BCECriterion([1.0, 0.5, 2.0, 1.0, 3.0]),
        lambda np, r: (_c_probs(np, r, 4, 5).clip(0.05, 0.95),
                       _c_bits(np, r, 4, 5))),
    "BCECriterionWithLogits": (
        lambda nn: nn.BCECriterionWithLogits(),
        lambda np, r: (_c_logits(np, r, 4, 5) * 3, _c_bits(np, r, 4, 5))),
    "SmoothL1Criterion": (
        lambda nn: nn.SmoothL1Criterion(sigma=2.0),
        lambda np, r: (_c_logits(np, r, 4, 5), _c_logits(np, r, 4, 5))),
    "MarginCriterion": (
        lambda nn: nn.MarginCriterion(),
        lambda np, r: (_c_logits(np, r, 8), _c_pm1(np, r, 8))),
    "MarginCriterion_squared": (
        lambda nn: nn.MarginCriterion(margin=0.5, squared=True),
        lambda np, r: (_c_logits(np, r, 8), _c_pm1(np, r, 8))),
    "MarginRankingCriterion": (
        lambda nn: nn.MarginRankingCriterion(margin=0.5),
        lambda np, r: ([_c_logits(np, r, 8), _c_logits(np, r, 8)],
                       _c_pm1(np, r, 8))),
    "CosineEmbeddingCriterion": (
        lambda nn: nn.CosineEmbeddingCriterion(margin=0.1),
        lambda np, r: ([_c_logits(np, r, 6, 4), _c_logits(np, r, 6, 4)],
                       _c_pm1(np, r, 6))),
    "HingeEmbeddingCriterion": (
        lambda nn: nn.HingeEmbeddingCriterion(margin=1.5),
        lambda np, r: (_c_logits(np, r, 8), _c_pm1(np, r, 8))),
    "SoftMarginCriterion": (
        lambda nn: nn.SoftMarginCriterion(),
        lambda np, r: (_c_logits(np, r, 8), _c_pm1(np, r, 8))),
    "MultiMarginCriterion": (
        lambda nn: nn.MultiMarginCriterion(),
        lambda np, r: (_c_logits(np, r, 6, 5), _c_labels(np, r, 6, 5))),
    "MultiMarginCriterion_p2_weights": (
        lambda nn: nn.MultiMarginCriterion(p=2, margin=0.7,
                                           weights=[1.0, 2.0, 0.5, 1.0,
                                                    1.5]),
        lambda np, r: (_c_logits(np, r, 6, 5), _c_labels(np, r, 6, 5))),
    "MultiLabelMarginCriterion": (
        lambda nn: nn.MultiLabelMarginCriterion(),
        lambda np, r: (_c_logits(np, r, 6, 5),
                       _c_multi_hot(np, r, 6, 5))),
    "MultiLabelSoftMarginCriterion": (
        lambda nn: nn.MultiLabelSoftMarginCriterion([1.0, 2.0, 0.5, 1.0,
                                                     1.5]),
        lambda np, r: (_c_logits(np, r, 6, 5),
                       _c_multi_hot(np, r, 6, 5))),
    "DistKLDivCriterion": (
        lambda nn: nn.DistKLDivCriterion(),
        lambda np, r: (np.log(_c_probs(np, r, 4, 5)),
                       np.where(r.random((4, 5)) < 0.2, 0.0,
                                _c_probs(np, r, 4, 5)).astype(np.float32))),
    "KLDCriterion": (
        lambda nn: nn.KLDCriterion(),
        lambda np, r: ([_c_logits(np, r, 4, 5),
                        _c_logits(np, r, 4, 5) * 0.1], None)),
    "GaussianCriterion": (
        lambda nn: nn.GaussianCriterion(),
        lambda np, r: ([_c_logits(np, r, 4, 5),
                        _c_logits(np, r, 4, 5) * 0.1],
                       _c_logits(np, r, 4, 5))),
    "L1Cost": (lambda nn: nn.L1Cost(),
               lambda np, r: (_c_logits(np, r, 4, 5), None)),
    "DiceCoefficientCriterion": (
        lambda nn: nn.DiceCoefficientCriterion(epsilon=0.5),
        lambda np, r: (_c_probs(np, r, 4, 5), _c_bits(np, r, 4, 5))),
    "PGCriterion": (
        lambda nn: nn.PGCriterion(),
        lambda np, r: (_c_probs(np, r, 4, 5), _c_logits(np, r, 4, 5))),
    "PGCriterion_average": (
        lambda nn: nn.PGCriterion(True),
        lambda np, r: (_c_probs(np, r, 4, 5), _c_logits(np, r, 4, 5))),
    "MultiCriterion": (
        lambda nn: nn.MultiCriterion().add(nn.MSECriterion(), 0.5)
        .add(nn.AbsCriterion(), 2.0),
        lambda np, r: (_c_logits(np, r, 4, 5), _c_logits(np, r, 4, 5))),
    "ParallelCriterion": (
        lambda nn: nn.ParallelCriterion()
        .add(nn.SoftmaxWithCriterion(ignore_label=-1), 1.0)
        .add(nn.SmoothL1CriterionWithWeights(sigma=3.0, num=4), 0.5),
        lambda np, r: ([_c_logits(np, r, 2, 2, 6, 5),
                        _c_logits(np, r, 2, 8, 3, 5)],
                       [_c_rpn_labels(np, r),
                        _c_box_targets(np, r, 2, 8, 3, 5)])),
    "ParallelCriterion_repeat_target": (
        lambda nn: nn.ParallelCriterion(repeat_target=True)
        .add(nn.MSECriterion(), 1.0).add(nn.AbsCriterion(), 0.25),
        lambda np, r: ([_c_logits(np, r, 4, 5), _c_logits(np, r, 4, 5)],
                       _c_logits(np, r, 4, 5))),
    "TimeDistributedCriterion": (
        lambda nn: nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                               size_average=True),
        lambda np, r: (np.log(_c_probs(np, r, 12, 5)).reshape(3, 4, 5),
                       _c_labels(np, r, 12, 5).reshape(3, 4))),
    "TransformerCriterion": (
        lambda nn: nn.TransformerCriterion(nn.MSECriterion(), nn.Tanh(),
                                           nn.Square()),
        lambda np, r: (_c_logits(np, r, 4, 5), _c_logits(np, r, 4, 5))),
    "SoftmaxWithCriterion": (
        lambda nn: nn.SoftmaxWithCriterion(),
        lambda np, r: (_c_logits(np, r, 2, 3, 4, 5),
                       _c_labels(np, r, 40, 3).reshape(2, 4, 5))),
    "SoftmaxWithCriterion_ignore": (
        lambda nn: nn.SoftmaxWithCriterion(ignore_label=-1),
        lambda np, r: (_c_logits(np, r, 2, 2, 4, 5),
                       _c_rpn_labels(np, r, 2, 4, 5))),
    "SoftmaxWithCriterion_ignore_full": (
        lambda nn: nn.SoftmaxWithCriterion(ignore_label=-1,
                                           normalize_mode="FULL"),
        lambda np, r: (_c_logits(np, r, 2, 2, 4, 5),
                       _c_rpn_labels(np, r, 2, 4, 5))),
    "SoftmaxWithCriterion_all_ignored": (
        lambda nn: nn.SoftmaxWithCriterion(ignore_label=-1),
        lambda np, r: (_c_logits(np, r, 2, 3, 4),
                       np.full((2, 4), -1, np.int64))),
    "ClassSimplexCriterion": (
        lambda nn: nn.ClassSimplexCriterion(5),
        lambda np, r: (_c_logits(np, r, 6, 5), _c_labels(np, r, 6, 5))),
    "L1HingeEmbeddingCriterion": (
        lambda nn: nn.L1HingeEmbeddingCriterion(margin=4.0),
        lambda np, r: ([_c_logits(np, r, 6, 4), _c_logits(np, r, 6, 4)],
                       _c_pm1(np, r, 6))),
    "CosineDistanceCriterion": (
        lambda nn: nn.CosineDistanceCriterion(),
        lambda np, r: (_c_logits(np, r, 4, 5), _c_logits(np, r, 4, 5))),
    "CosineProximityCriterion": (
        lambda nn: nn.CosineProximityCriterion(),
        lambda np, r: (lambda x: (x, _c_near(np, r, x)))(
            _c_logits(np, r, 4, 5))),
    "DotProductCriterion": (
        lambda nn: nn.DotProductCriterion(),
        lambda np, r: (_c_logits(np, r, 4, 5), _c_logits(np, r, 4, 5))),
    "PoissonCriterion": (
        lambda nn: nn.PoissonCriterion(),
        lambda np, r: (_c_probs(np, r, 4, 5) * 3,
                       r.poisson(1.0, (4, 5)).astype(np.float32))),
    "KullbackLeiblerDivergenceCriterion": (
        lambda nn: nn.KullbackLeiblerDivergenceCriterion(),
        lambda np, r: (_c_probs(np, r, 4, 5), _c_probs(np, r, 4, 5))),
    "MeanAbsolutePercentageCriterion": (
        lambda nn: nn.MeanAbsolutePercentageCriterion(),
        lambda np, r: (_c_logits(np, r, 4, 5),
                       _c_logits(np, r, 4, 5) + 3.0)),
    "MeanSquaredLogarithmicCriterion": (
        lambda nn: nn.MeanSquaredLogarithmicCriterion(),
        lambda np, r: (np.abs(_c_logits(np, r, 4, 5)),
                       np.abs(_c_logits(np, r, 4, 5)))),
    "CategoricalCrossEntropy": (
        lambda nn: nn.CategoricalCrossEntropy(),
        lambda np, r: (_c_probs(np, r, 6, 5), _c_labels(np, r, 6, 5))),
    "SmoothL1CriterionWithWeights": (
        lambda nn: nn.SmoothL1CriterionWithWeights(sigma=3.0, num=5),
        lambda np, r: (_c_logits(np, r, 2, 8, 3, 3),
                       _c_box_targets(np, r, 2, 8, 3, 3))),
    "SmoothL1CriterionWithWeights_plain_target": (
        lambda nn: nn.SmoothL1CriterionWithWeights(),
        lambda np, r: (_c_logits(np, r, 4, 5), _c_logits(np, r, 4, 5))),
    "NegativeEntropyPenalty": (
        lambda nn: nn.NegativeEntropyPenalty(beta=0.05),
        lambda np, r: (_c_probs(np, r, 4, 5), None)),
    "TimeDistributedMaskCriterion": (
        lambda nn: nn.TimeDistributedMaskCriterion(nn.MSECriterion(), 0.0),
        lambda np, r: (_c_logits(np, r, 3, 4, 5),
                       np.where(r.random((3, 4, 5)) < 0.3, 0.0,
                                _c_logits(np, r, 3, 4, 5))
                       .astype(np.float32))),
    "TimeDistributedMaskCriterion_labels": (
        lambda nn: nn.TimeDistributedMaskCriterion(nn.ClassNLLCriterion(),
                                                   padding_value=0),
        lambda np, r: (np.log(_c_probs(np, r, 12, 5)).reshape(3, 4, 5),
                       _c_labels(np, r, 12, 5).reshape(3, 4))),
}


def criterion_seed(name):
    return sum(map(ord, name))


DETECT_SEED = 25
SSD_BATCH = 8
DETECT_TIMED = 3          # timed passes of each detector, after a warm-up
FRCNN_IM_INFO = (600.0, 800.0, 1.6, 1.6)   # a 375 x 500 VOC image at 600
FRCNN_LOGIT_STD = 2.0     # the seeded classifier's logits' spread
RPN_STEPS = 3
RPN_LR = 0.001            # py-faster-rcnn's base_lr, momentum 0.9
DETECT_OUT_REL = 1e-4     # card vs CPU maps, x max|CPU| (float32, TF32 off)
DETECT_LOSS_REL = 1e-5    # the RPN's first loss, card vs CPU
DETECT_FLIP_REL = 1e-5    # each flip on the CPU's own inputs, x max|CPU|
# every gradient against the CPU's run with the card's ReLU decisions
DETECT_MASKED_REL = 1e-4
DETECT_GRAD_REL = 1e-3    # train_cnn's bar against the plain CPU (reported)
# the near-tie rule of a detection head fed the same inputs on both
# devices (_rows_near_tie): an image's rows may differ only from a first
# differing row whose own decision the CPU head took by a margin under
# DETECT_TIE_EPS (scores and IoU; the card's softmax and exp differ from
# the CPU's by a few ulps, ~1e-7) or, for Proposal's min_size,
# DETECT_TIE_PX pixels
DETECT_TIE_EPS = 1e-6
DETECT_TIE_PX = 1e-3
DETECT_BOX_TOL = {"ssd": 1e-5, "frcnn": 1e-3}   # normalised / pixels
CRITERION_REL = 1e-5      # the criterions, card vs CPU


def _rel(got, want):
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                  1e-30)


def _add_routes(total, split, n=1):
    for kind in ("k9", "i2c"):
        for path in ("tc", "simt"):
            total[kind][path] += split[kind][path] * n
    total["library"] += split["library"] * n
    return total


def _no_routes():
    return {"k9": {"tc": 0, "simt": 0}, "i2c": {"tc": 0, "simt": 0},
            "library": 0}


def _ssd_rule(torch, head, inputs):
    """The decisions of ``DetectionOutputSSD`` ``head`` that the near-tie
    rule reads, on its inputs (loc, conf, priors): its thresholds, and
    each (image, class)'s scores either side of its ``nms_topk`` cut (N,
    classes, 2)."""
    from bigdl_tpu_torch.nn.detection import top_k
    loc, conf, _ = inputs
    n, p = loc.shape[0], loc.shape[1] // 4
    cut = None
    if head.nms_topk and head.nms_topk < p:
        c = conf.reshape(n, p, head.n_classes)
        if head.conf_post_process:
            c = torch.softmax(c, -1)
        s = c.permute(0, 2, 1)
        s = torch.where(s >= head.conf_thresh, s, torch.zeros_like(s))
        cut = top_k(s, head.nms_topk + 1)[0][..., -2:]
    return {"conf_thresh": head.conf_thresh, "nms_thresh": head.nms_thresh,
            "normalized": True, "cut": cut}


def _frcnn_rule(head):
    """The decisions of ``DetectionOutputFrcnn`` ``head`` that the
    near-tie rule reads (no top-k cut before its NMS)."""
    return {"conf_thresh": head.conf_thresh, "nms_thresh": head.nms_thresh,
            "normalized": False}


def _proposal_rule(torch, layer, inputs):
    """The decisions of ``Proposal`` ``layer`` that the near-tie rule
    reads, on its CPU inputs: the scores either side of its pre-NMS cut,
    its NMS threshold and its least box size in pixels (width, height)."""
    from bigdl_tpu_torch.nn.detection import top_k
    _, scores, pre, _ = layer._candidates(inputs)
    im_info = inputs[2]
    cut = top_k(scores, pre + 1)[0][-2:].reshape(1, 1, 2) \
        if pre < scores.shape[0] else None
    return {"nms_thresh": layer.nms_thresh, "normalized": False, "cut": cut,
            "min_size": (layer.min_size * float(im_info[0, 3]),
                         layer.min_size * float(im_info[0, 2]))}


def _proposal_rows(torch, rois, scores):
    """``Proposal``'s output as detection rows ``[label, score, box]``:
    label 0 and the score for a kept RoI, label -1 and 0 for a suppressed
    one (score -inf)."""
    kept = torch.isfinite(scores)
    zero = torch.zeros_like(scores)
    return torch.cat([torch.where(kept, zero, zero - 1)[:, None],
                      torch.where(kept, scores, zero)[:, None],
                      rois[:, 1:]], 1)


def _row_margins(torch, want, got_row, p, rule, image, box_tol):
    """The CPU head's margins at the decisions that could put the card's
    ``got_row`` where the CPU's rows ``want`` have row ``p`` (the rows
    before it equal on both): ``order``, the gap between the two rows'
    scores where the card's row stands later in the CPU's rows or ``p``
    is the last row (two candidates swapped); and for each of the two that
    is a candidate (label >= 0), its score to ``conf_thresh``
    (``conf_thresh``), to the scores either side of its label's top-k cut
    (``top_k``), its largest overlap with an earlier row of its label to
    the NMS threshold (``nms_iou``) and its size to ``min_size`` in pixels
    (``min_size``)."""
    import math

    from bigdl_tpu_torch.nn.detection import iou_matrix
    a, b = want[p], got_row
    m = {}

    def put(kind, v):
        m[kind] = min(m.get(kind, math.inf), float(v))

    if a[0] >= 0 and b[0] >= 0:
        later = want[p + 1:]
        moved = ((later[:, 0] == b[0])
                 & ((later[:, 1] - b[1]).abs() <= DETECT_TIE_EPS)
                 & ((later[:, 2:] - b[2:]).abs().amax(1) <= box_tol))
        if p == want.shape[0] - 1 or bool(moved.any()):
            put("order", (a[1] - b[1]).abs())
    for r in (a, b):
        if r[0] < 0:
            continue
        if rule.get("conf_thresh") is not None:
            put("conf_thresh", abs(float(r[1]) - rule["conf_thresh"]))
        if rule.get("cut") is not None:
            put("top_k", (rule["cut"][image, int(r[0])] - r[1]).abs().min())
        earlier = want[:p][want[:p, 0] == r[0]]
        if len(earlier):
            iou = iou_matrix(r[None, 2:], earlier[:, 2:], rule["normalized"])
            put("nms_iou", (iou - rule["nms_thresh"]).abs().min())
        if rule.get("min_size") is not None:
            put("min_size", min(
                abs(float(r[4] - r[2] + 1) - rule["min_size"][0]),
                abs(float(r[5] - r[3] + 1) - rule["min_size"][1])))
    return m


def _rows_near_tie(torch, name, got, want, box_tol, rule):
    """Detection rows (N, K, 6) ``[label, score, box]`` of the card
    against the CPU's on the same inputs, by the near-tie rule: an image's
    rows are equal (labels; scores within DETECT_TIE_EPS; boxes within
    ``box_tol``), or equal up to a first differing row that one of the CPU
    head's decisions about that row's candidates (``_row_margins``) took
    by a margin under DETECT_TIE_EPS (DETECT_TIE_PX pixels for
    ``min_size``); the rows after it follow from that decision. Such
    images are counted and printed with their margins. ``rule``: the
    head's decisions (``_ssd_rule``, ``_frcnn_rule``, ``_proposal_rule``).
    Returns the record."""
    got, want = got.detach().cpu(), want.detach().cpu()
    if got.dim() == 2:
        got, want = got[None], want[None]
    rec = {"images": int(got.shape[0]), "rows": int(got.shape[1]),
           "identical_images": 0, "near_tie_images": 0, "near_ties": []}
    for n in range(got.shape[0]):
        g, w = got[n], want[n]
        differ = ((g[:, 0] != w[:, 0])
                  | ((g[:, 1] - w[:, 1]).abs() > DETECT_TIE_EPS)
                  | ((g[:, 2:] - w[:, 2:]).abs().amax(1) > box_tol))
        if not bool(differ.any()):
            rec["identical_images"] += 1
            continue
        p = int(differ.nonzero()[0])
        margins = _row_margins(torch, w, g[p], p, rule, n, box_tol)
        near = {k: v for k, v in margins.items()
                if v < (DETECT_TIE_PX if k == "min_size" else DETECT_TIE_EPS)}
        print(f"detect {name}: image {n}: rows from {p} differ "
              f"({int(differ.sum())}); CPU row {w[p].tolist()}, card row "
              f"{g[p].tolist()}, margins {margins}", flush=True)
        check(bool(near), f"detect {name}: image {n}'s row {p} differs from "
                          f"the CPU's with no near tie at its decisions "
                          f"(margins {margins})")
        rec["near_tie_images"] += 1
        rec["near_ties"].append({"image": n, "first_row": p,
                                 "rows_differing": int(differ.sum()),
                                 "margins": margins})
    return rec


@contextlib.contextmanager
def _timed_nms(torch):
    """Every ``nms_keep`` call timed alone (the card synchronised around
    it): yields ``{"seconds", "calls"}``."""
    from bigdl_tpu_torch.nn import detection
    real = detection.nms_keep
    spent = {"seconds": 0.0, "calls": 0}

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **k)
        torch.cuda.synchronize()
        spent["seconds"] += time.perf_counter() - t0
        spent["calls"] += 1
        return out

    detection.nms_keep = timed
    try:
        yield spent
    finally:
        detection.nms_keep = real


def _seeded(torch, parts, device):
    """``parts`` as one module with the seeded weights of DETECT_SEED, in
    evaluation mode."""
    from bigdl_tpu_torch.nn.module import init_state_dict
    m = as_module(torch, parts)
    m.load_state_dict(init_state_dict(m, DETECT_SEED), strict=False)
    return m.to(device).eval()


def _cpu_copy(torch, build, card):
    m = as_module(torch, build("cpu"))
    m.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    return m.eval()


def _detect_ssd(torch, smi):
    """SSD300 (module docstring, 6l)."""
    import numpy as np
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models import conv_routes
    from bigdl_tpu_torch.nn.detection import SWEEP, reset_sweep_counts
    cfg = SSD300
    card = _seeded(torch, ssd_build(nn, cfg, device="cuda"), "cuda")
    rng = np.random.default_rng(DETECT_SEED)
    x = torch.from_numpy(rng.standard_normal(
        (SSD_BATCH, 3, cfg["image"], cfg["image"]), dtype=np.float32))
    xg = x.cuda().contiguous(memory_format=torch.channels_last)
    shapes = []
    with torch.no_grad():
        rows = card["det"](list(ssd_forward(torch, card, xg, shapes)))
        torch.cuda.synchronize()
        split = _no_routes()
        for i, (hw, out) in enumerate(shapes):
            for m, at in ((card["stages"][i], hw), (card["loc"][i], out),
                          (card["conf"][i], out)):
                _add_routes(split, conv_routes(m, at, torch.float32, False))
        _reset_conv_counts()
        reset_sweep_counts()
        t0 = time.perf_counter()
        for _ in range(DETECT_TIMED):
            heads = ssd_forward(torch, card, xg)
            rows = card["det"](list(heads))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _conv_counts()
        sweeps = dict(SWEEP)
        _check_routes("detect ssd300", counts, split, DETECT_TIMED)
        t0 = time.perf_counter()
        heads = ssd_forward(torch, card, xg)
        torch.cuda.synchronize()
        net_s = time.perf_counter() - t0
        with _timed_nms(torch) as nms:
            t0 = time.perf_counter()
            rows = card["det"](list(heads))
            torch.cuda.synchronize()
            head_s = time.perf_counter() - t0
    n_priors = heads[2].shape[2] // 4
    check(n_priors == SSD300_PRIORS and tuple(rows.shape) == (
        SSD_BATCH, cfg["detection"]["keep_top_k"], 6)
        and bool(torch.isfinite(rows).all()),
        f"detect ssd300: {n_priors} priors, rows {tuple(rows.shape)}")
    cpu = _cpu_copy(torch, lambda d: ssd_build(nn, cfg, device=d), card)
    with torch.no_grad():
        t0 = time.perf_counter()
        want = ssd_forward(torch, cpu, x[:1])
        cpu_s = time.perf_counter() - t0
        got = ssd_forward(torch, card, xg[:1])
        rel = {k: _rel(g, w) for k, g, w in zip(("loc", "conf", "priors"),
                                                got, want)}
        check(max(rel.values()) <= DETECT_OUT_REL,
              f"detect ssd300 card vs CPU at batch 1: {rel}")
        # the heads on the CPU's own inputs (batch 1) and on the card's
        # batch of 8 (copied to the CPU), each the same bits on both
        heads_c = [t.cpu() for t in heads]
        ties = {}
        for part, inputs in (("batch1", list(want)), ("batch8", heads_c)):
            ties[part] = _rows_near_tie(
                torch, f"ssd300 {part}",
                card["det"]([t.cuda() for t in inputs]),
                cpu["det"](inputs), DETECT_BOX_TOL["ssd"],
                _ssd_rule(torch, cpu["det"], inputs))
    launches = {k: counts[k] for k in ("k9", "k9_cuda_core", "i2c",
                                       "i2c_cuda_core")}
    return {"config": "ssd_pascal.py VGG_VOC0712_SSD_300x300",
            "batch": SSD_BATCH, "image": cfg["image"], "priors": n_priors,
            "dtype": "float32", "timed_passes": DETECT_TIMED,
            "images_per_s": SSD_BATCH * DETECT_TIMED / wall,
            "ms_per_batch": 1e3 * wall / DETECT_TIMED,
            "network_ms": 1e3 * net_s, "detection_output_ms": 1e3 * head_s,
            "nms_ms": 1e3 * nms["seconds"], "nms_calls": nms["calls"],
            "nms_sweep_per_batch": {k: v // DETECT_TIMED
                                    for k, v in sweeps.items()},
            "conv_routes_per_pass": split, "launches": launches,
            "library_calls": counts["library"],
            "detections_kept": int((rows[..., 0] >= 0).sum()),
            "cpu_rel": rel, "cpu_batch1_s": cpu_s, "heads_vs_cpu": ties,
            "card": smi}, launches


def _detect_frcnn(torch, smi):
    """Faster R-CNN VGG-16 at test time (module docstring, 6l). Returns
    the record, the launches, and the card's parts and conv4_3 for the
    RPN's steps."""
    import numpy as np
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models import conv_routes
    from bigdl_tpu_torch.nn.detection import SWEEP, reset_sweep_counts
    cfg = FRCNN_VGG16
    parts = frcnn_build(nn, cfg, device="cuda")
    card = _seeded(torch, parts, "cuda")
    rng = np.random.default_rng(DETECT_SEED + 1)
    x = torch.from_numpy(rng.standard_normal((1, 3) + cfg["image"],
                                             dtype=np.float32))
    xg = x.cuda().contiguous(memory_format=torch.channels_last)
    im_c = torch.tensor([FRCNN_IM_INFO])
    im_g = im_c.cuda()
    h, w = cfg["image"]
    with torch.no_grad():
        f4 = card["trunk"](xg)
        f5 = card["conv5"](f4)
        # at the initialiser's width the classifier's 21 probabilities all
        # sit near 1/21, under conf_thresh: widen its seeded weights so
        # its logits on this image spread with FRCNN_LOGIT_STD
        f, prob, deltas = frcnn_rpn(torch, card, xg)
        rois, _ = card["proposal"]([prob, deltas, im_g])
        pooled = card["roi"]([f, rois])
        logits = card["cls"](card["fc"](pooled.reshape(rois.shape[0], -1)))
        card["cls"].weight.mul_(FRCNN_LOGIT_STD / float(logits.std()))
        del f, prob, deltas, rois, pooled, logits
        split = _no_routes()
        for m, hw in ((card["trunk"], (h, w)), (card["conv5"], f4.shape[2:]),
                      (card["rpn_conv"], f5.shape[2:]),
                      (card["rpn_cls"], f5.shape[2:]),
                      (card["rpn_bbox"], f5.shape[2:])):
            _add_routes(split, conv_routes(m, tuple(hw), torch.float32,
                                           False))
        frcnn_forward(torch, card, xg, im_g)                # warm-up
        torch.cuda.synchronize()
        _reset_conv_counts()
        reset_sweep_counts()
        t0 = time.perf_counter()
        for _ in range(DETECT_TIMED):
            rois, scores, rows = frcnn_forward(torch, card, xg, im_g)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _conv_counts()
        sweeps = dict(SWEEP)
        _check_routes("detect faster_rcnn", counts, split, DETECT_TIMED)
        with _timed_nms(torch) as nms:
            t0 = time.perf_counter()
            frcnn_forward(torch, card, xg, im_g)
            torch.cuda.synchronize()
            nms_wall = time.perf_counter() - t0
        # RoiPooling's memory: what it allocates beyond its inputs
        f, prob, deltas = frcnn_rpn(torch, card, xg)
        rois_g, _ = card["proposal"]([prob, deltas, im_g])
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        pooled = card["roi"]([f, rois_g])
        torch.cuda.synchronize()
        roi_peak = torch.cuda.max_memory_allocated() - base
        gathered = rois_g.shape[0] * f[0].numel() * f.element_size()
    post = cfg["proposal"]["post_nms_topn"]
    check(tuple(rois.shape) == (post, 5) and tuple(scores.shape) == (post,)
          and tuple(rows.shape) == (cfg["detection"]["keep_top_k"], 6)
          and bool(torch.isfinite(rows).all())
          and tuple(pooled.shape) == (post, _width(cfg["conv5"]),
                                      cfg["pooled"], cfg["pooled"]),
          f"detect faster_rcnn: rois {tuple(rois.shape)}, rows "
          f"{tuple(rows.shape)}")
    check(roi_peak <= 1.1 * gathered,
          f"detect faster_rcnn: RoiPooling allocated {roi_peak} B beyond "
          f"its inputs; its RoIs' (R, C, H, W) map is {gathered} B")
    cpu = _cpu_copy(torch, lambda d: frcnn_build(nn, cfg, device=d), card)
    with torch.no_grad():
        t0 = time.perf_counter()
        f_c, prob_c, deltas_c = frcnn_rpn(torch, cpu, x)
        rois_c, scores_c = cpu["proposal"]([prob_c, deltas_c, im_c])
        pooled_c = cpu["roi"]([f_c, rois_c])
        cls_c, bbox_c = frcnn_classify(torch, cpu, pooled_c)
        rows_c = cpu["det"]([cls_c, bbox_c, rois_c, im_c])
        cpu_s = time.perf_counter() - t0
        f_g, prob_g, deltas_g = frcnn_rpn(torch, card, xg)
        rel = {"conv5_3": _rel(f_g, f_c), "rpn_cls_prob": _rel(prob_g, prob_c),
               "rpn_bbox_pred": _rel(deltas_g, deltas_c)}
        check(max(rel.values()) <= DETECT_OUT_REL,
              f"detect faster_rcnn card vs CPU: {rel}")
        # the card's own RoIs against the CPU's: reported (seeded RPN
        # scores lie within the trunk's rounding of each other at many
        # places, so the selections may part there)
        own_rois, own_scores, _ = frcnn_forward(torch, card, xg, im_g)
        own_same = int(((own_rois.cpu() - rois_c).abs()
                        <= DETECT_BOX_TOL["frcnn"]).all(1).sum())
        # each layer on the CPU's own inputs
        inputs = [prob_c, deltas_c, im_c]
        got = card["proposal"]([t.cuda() for t in inputs])
        prop = _rows_near_tie(
            torch, "faster_rcnn proposal", _proposal_rows(torch, *got),
            _proposal_rows(torch, rois_c, scores_c), DETECT_BOX_TOL["frcnn"],
            _proposal_rule(torch, cpu["proposal"], inputs))
        roi_err = float((card["roi"]([f_c.cuda(), rois_c.cuda()]).cpu()
                         - pooled_c).abs().max())
        check(roi_err == 0.0, f"detect faster_rcnn RoiPooling card vs CPU "
                              f"on the same inputs: {roi_err}")
        head_in = [cls_c, bbox_c, rois_c, im_c]
        det = _rows_near_tie(
            torch, "faster_rcnn detection_output",
            card["det"]([t.cuda() for t in head_in]), rows_c,
            DETECT_BOX_TOL["frcnn"], _frcnn_rule(cpu["det"]))
    launches = {k: counts[k] for k in ("k9", "k9_cuda_core", "i2c",
                                       "i2c_cuda_core")}
    rec = {"config": "py-faster-rcnn VGG16 faster_rcnn_end2end "
                     "test.prototxt", "image": list(cfg["image"]),
           "im_info": list(FRCNN_IM_INFO), "dtype": "float32",
           "timed_passes": DETECT_TIMED,
           "ms_per_image": 1e3 * wall / DETECT_TIMED,
           "nms_share": nms["seconds"] / nms_wall,
           "nms_ms_per_image": 1e3 * nms["seconds"], "nms_calls": nms["calls"],
           "nms_sweep_per_image": {k: v // DETECT_TIMED
                                   for k, v in sweeps.items()},
           "conv_routes_per_pass": split, "launches": launches,
           "library_calls": counts["library"],
           "roi_pooling_extra_bytes": roi_peak,
           "roi_gathered_map_bytes": gathered,
           "proposals_finite": int(torch.isfinite(scores).sum()),
           "detections_kept": int((rows[:, 0] >= 0).sum()),
           "cpu_rel": rel, "cpu_s": cpu_s,
           "own_rois_equal_to_cpu": own_same, "proposal_vs_cpu": prop,
           "roi_pooling_max_abs_vs_cpu": roi_err,
           "detection_output_vs_cpu": det, "card": smi}
    return rec, launches, (parts, f4)


@contextlib.contextmanager
def _rpn_hooks(torch, model, relu=None):
    """Hooks on ``model``'s 3x3 convolutions and ReLUs for one forward and
    backward: yields ``{"dy": name -> (the gradient at the convolution's
    output, its input's shape), "relu": name -> the mask of the ReLU's
    positive outputs}`` (a convolution's ``dy`` only where its input
    carries a gradient: where the step runs its input-gradient flip). With
    ``relu`` (name -> mask) each ReLU passes its input where that mask
    says, whatever its own sign: the ReLU decisions of another run."""
    from bigdl_tpu_torch import nn
    taps = {"dy": {}, "relu": {}}
    handles = []

    def conv_hook(name):
        def hook(mod, args, out):
            if args[0].requires_grad and mod.uses_kernel(*args[0].shape[2:]):
                def keep(g):
                    taps["dy"][name] = (g.detach().cpu(), tuple(args[0].shape))
                out.register_hook(keep)
        return hook

    def relu_hook(name):
        def hook(mod, args, out):
            taps["relu"][name] = (out > 0).detach().cpu()
            if relu is not None:
                mask = relu[name].to(out.device)
                return torch.where(mask, args[0], torch.zeros_like(args[0]))
        return hook

    for name, mod in model.named_modules():
        if isinstance(mod, nn.ReLU):
            handles.append(mod.register_forward_hook(relu_hook(name)))
        elif isinstance(mod, nn.SpatialConvolution):
            handles.append(mod.register_forward_hook(conv_hook(name)))
    try:
        yield taps
    finally:
        for h in handles:
            h.remove()


def _rpn_flips_vs_cpu(torch, model, dy, device="cuda"):
    """Each input-gradient flip of the RPN's step on ``device``, fed the
    CPU run's own output gradient ``dy`` (``_rpn_hooks``), against
    ``torch.nn.grad.conv2d_input`` on the CPU: by layer, the largest
    difference over the CPU's largest magnitude. The inputs are the same
    bits on both devices, so no upstream decision can move them."""
    from bigdl_tpu_torch.nn.conv import conv2d_input
    mods = dict(model.named_modules())
    rel = {}
    for name, (g, shape) in dy.items():
        w = mods[name].weight
        want = torch.nn.grad.conv2d_input(shape, w.detach().cpu(), g,
                                          padding=1)
        got = conv2d_input(g.permute(0, 2, 3, 1).contiguous().to(device),
                           w.detach().to(device), shape[2:],
                           padding=((1, 1), (1, 1)))
        rel[name] = _rel(got.permute(0, 3, 1, 2), want)
    return rel


def _detect_rpn(torch, parts, f4, smi):
    """Three SGD steps of conv5 and the RPN (module docstring, 6l)."""
    import copy
    import numpy as np
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models import conv_routes
    from bigdl_tpu_torch.optim import SGD, make_loss_and_grads, \
        make_train_step
    cfg = FRCNN_VGG16
    model = rpn_train_model(nn, parts)
    a = len(cfg["ratios"]) * len(cfg["scales"])
    h, w = (f4.shape[2] + 1) // 2, (f4.shape[3] + 1) // 2
    lab, box = rpn_targets(np, np.random.default_rng(DETECT_SEED + 2), a,
                           h, w)
    y_c = [torch.from_numpy(lab), [torch.from_numpy(t) for t in box]]
    y_g = [y_c[0].cuda(), [t.cuda() for t in y_c[1]]]
    crit = rpn_criterion(nn)
    cpu = copy.deepcopy(model).to("cpu")
    x_c = f4.detach().cpu()
    split = conv_routes(model, tuple(f4.shape[2:]), torch.float32)
    with _rpn_hooks(torch, model) as card_taps:
        loss_g, grads_g = make_loss_and_grads(model, crit)(f4, y_g)

    def cpu_run(x, relu=None):
        with _rpn_hooks(torch, cpu, relu) as taps:
            loss, grads = make_loss_and_grads(cpu, crit)(x, y_c)
        return float(loss), {k: g.clone() for k, g in grads.items()}, taps

    loss_c, grads_c, cpu_taps = cpu_run(x_c)
    # (1) each flip on the CPU run's own output gradients
    flips = _rpn_flips_vs_cpu(torch, model, cpu_taps["dy"])
    # (2) every gradient against the CPU's with the card's ReLU decisions
    # (the decisions the card's rounding took either way are its own; the
    # rest of the step is continuous)
    _, grads_m, _ = cpu_run(x_c, card_taps["relu"])
    relu_flips = {k: int((m != cpu_taps["relu"][k]).sum())
                  for k, m in card_taps["relu"].items()}
    masked = {k: _rel(grads_g[k], gm) for k, gm in grads_m.items()}
    # (3) reported: each gradient against the plain CPU run by train_cnn's
    # rule (the larger of 1e-3 of its largest magnitude and
    # RESNET_NOISE_FACTOR times its CPU noise floor, its move under a
    # 2^-22 change of the input), and cuDNN's (the library witness) too
    noise = {k: 0.0 for k in grads_c}
    for seed in (0, 1):
        _, moved, _ = cpu_run(_perturbed(torch, x_c, seed))
        for k, g in moved.items():
            noise[k] = max(noise[k], float((g - grads_c[k]).abs().max()))
    with _library_3x3():
        _, grads_l = make_loss_and_grads(model, crit)(f4, y_g)
    loss_rel = abs(float(loss_g) - loss_c) / abs(loss_c)
    grad = {}
    for k, gc in grads_c.items():
        top = max(float(gc.abs().max()), 1e-30)
        bar = max(DETECT_GRAD_REL * top, RESNET_NOISE_FACTOR * noise[k])
        diff = float((grads_g[k].cpu() - gc).abs().max())
        grad[k] = {"rel": diff / top, "vs_train_cnn_bar": diff / bar,
                   "cudnn_rel": _rel(grads_l[k], gc)}
    print(f"detect rpn step 1 card vs CPU: loss {loss_rel}, flips {flips}, "
          f"ReLU decisions differing {relu_flips}, gradients vs the CPU "
          f"with the card's ReLU decisions {masked}, vs the plain CPU "
          f"{json.dumps(grad)}", flush=True)
    # every 3x3 layer but conv5_1 (its input, pool4 of conv4_3, carries no
    # gradient) runs its flip in the step
    check(len(flips) == sum(isinstance(m, nn.SpatialConvolution)
                            and m.kernel_h == 3 for m in model.modules()) - 1,
          f"detect rpn: flips tapped {sorted(flips)}")
    check(loss_rel <= DETECT_LOSS_REL
          and max(flips.values()) <= DETECT_FLIP_REL
          and len(masked) == len(grads_c)
          and max(masked.values()) <= DETECT_MASKED_REL,
          f"detect rpn step 1 card vs CPU: loss {loss_rel}, flips {flips}, "
          f"gradients vs the CPU with the card's ReLU decisions {masked}")
    opt = SGD(learningrate=RPN_LR, momentum=0.9)
    step = make_train_step(model, crit, opt)
    opt_state = opt.init_state(dict(model.named_parameters()))
    torch.cuda.synchronize()
    _reset_conv_counts()
    t0 = time.perf_counter()
    losses = [step(opt_state, f4, y_g) for _ in range(RPN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _conv_counts()
    losses = [float(v) for v in losses]
    _check_routes("detect rpn", counts, split, RPN_STEPS)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0]
          and abs(losses[0] - float(loss_g)) <= DETECT_LOSS_REL
          * abs(float(loss_g)),
          f"detect rpn: losses {losses} (first step's check {float(loss_g)})")
    launches = {k: counts[k] for k in ("k9", "k9_cuda_core", "i2c",
                                       "i2c_cuda_core")}
    return {"trainable": "VGG-16 conv5 + RPN", "input": list(f4.shape),
            "anchors_labelled": {"fg": int((lab == 1).sum()),
                                 "bg": int((lab == 0).sum())},
            "optimizer": f"SGD({RPN_LR}, momentum 0.9)",
            "criterion": "ParallelCriterion(SoftmaxWithCriterion(-1), "
                         "SmoothL1CriterionWithWeights(3))",
            "losses": losses, "ms_per_step": 1e3 * wall / RPN_STEPS,
            "cpu_loss_rel": loss_rel, "flips_vs_cpu": flips,
            "relu_decisions_differing": relu_flips,
            "grad_vs_cpu_with_card_relu": masked, "grad_vs_cpu": grad,
            "conv_routes_per_step": split, "launches": launches,
            "card": smi}, launches


def _tensors(torch, x, device):
    if isinstance(x, list):
        return [_tensors(torch, v, device) for v in x]
    return None if x is None else torch.from_numpy(x).to(device)


def _flat(x):
    return [a for v in x for a in _flat(v)] if isinstance(x, list) else [x]


def _detect_criteria(torch):
    """Every criterion forward and backward on the card against the CPU
    (module docstring, 6l)."""
    import numpy as np
    from bigdl_tpu_torch import nn
    worst = {"loss": (0.0, None), "grad": (0.0, None)}
    for name, (make, inputs) in CRITERION_CASES.items():
        x, t = inputs(np, np.random.default_rng(criterion_seed(name)))
        out = {}
        for dev in ("cuda", "cpu"):
            crit = make(nn)
            xs, ts = _tensors(torch, x, dev), _tensors(torch, t, dev)
            loss = crit(xs, ts)
            out[dev] = (float(loss), [g.cpu() for g in
                                      _flat(crit.backward(xs, ts))])
        (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
        rel = {"loss": abs(lg - lc) / max(abs(lc), 1e-30),
               "grad": max(_rel(a, b) for a, b in zip(gg, gc))}
        for k, v in rel.items():
            if v > worst[k][0]:
                worst[k] = (v, name)
        check(max(rel.values()) <= CRITERION_REL,
              f"detect criterion {name} card vs CPU: {rel}")
    names = {n.split("_")[0] for n in CRITERION_CASES}
    return {"criterions": len(names), "cases": len(CRITERION_CASES),
            "tolerance": CRITERION_REL,
            "worst_loss_rel": worst["loss"][0],
            "worst_loss_case": worst["loss"][1],
            "worst_grad_rel": worst["grad"][0],
            "worst_grad_case": worst["grad"][1]}


def phase_detect(torch, kernels, smi):
    """SSD300 and Faster R-CNN VGG-16 on the card, the RPN's training
    steps and every criterion (see module docstring, 6l)."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False     # float32 in float32
    try:
        ssd, ssd_n = _detect_ssd(torch, smi)
        torch.cuda.empty_cache()
        frcnn, frcnn_n, (parts, f4) = _detect_frcnn(torch, smi)
        torch.cuda.empty_cache()
        rpn, rpn_n = _detect_rpn(torch, parts, f4, smi)
        del parts, f4
        torch.cuda.empty_cache()
        crits = _detect_criteria(torch)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for kind in ("k9", "i2c"):
        kernels[f"conv3x3_{kind}"].setdefault("launches_by_phase", {})[
            "detect"] = {part: n[f"{kind}_cuda_core"] for part, n in
                         (("ssd300", ssd_n), ("faster_rcnn", frcnn_n),
                          ("rpn_train", rpn_n))}
    emit({"phase": "detect", "ssd300": ssd, "faster_rcnn": frcnn,
          "rpn_train": rpn, "criteria": crits, "card": smi})


def main():
    import torch
    if "--sticky-child" in sys.argv:
        return _sticky_child()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script measures the "
              "GPU only", file=sys.stderr)
        return 1
    # the port itself; outside a checkout of the repo this import fails
    import bigdl_tpu_torch  # noqa: F401

    baseline = None
    if "--baseline" in sys.argv:
        # another checkout (the parent commit's) whose sampler is timed
        # beside this one's
        baseline = _baseline_sampler(sys.argv[sys.argv.index("--baseline")
                                              + 1])
    t_start = time.perf_counter()
    smi = phase_device(torch)
    seconds = {}

    def run(name, phase, *args, **kw):
        """One phase, its seconds kept, the card's cache freed after it."""
        t0 = time.perf_counter()
        out = phase(*args, **kw)
        torch.cuda.empty_cache()
        seconds[name] = time.perf_counter() - t0
        return out

    run("build", phase_build)
    kernels = run("kernels", phase_kernels, torch, baseline)
    f32_line, cpu_ref, slice_toks = run("slice", phase_slice, torch, kernels)
    spec_line, spec_toks = run("slice_spec", phase_slice_spec, torch,
                               kernels, f32_line, cpu_ref, slice_toks)
    dense_line, dense_toks = run("slice_dense", phase_slice_dense, torch,
                                 kernels, f32_line, cpu_ref)
    run("slice_dense_spec", phase_slice_dense_spec, torch, kernels,
        dense_line, cpu_ref, dense_toks)
    run("generate", phase_generate, torch, kernels)
    int8_line, int8_ref = run("slice_int8", phase_slice_int8, torch,
                              kernels, f32_line)
    run("slice_spec_int8", phase_slice_spec_int8, torch, kernels, f32_line,
        int8_line, int8_ref)
    run("slice_tp", phase_slice_tp, torch, kernels, f32_line, f32_line,
        cpu_ref, int8_kv=False)
    run("slice_spec_tp", phase_slice_spec_tp, torch, kernels, f32_line,
        spec_line, cpu_ref, spec_toks)
    run("slice_tp_int8", phase_slice_tp, torch, kernels, f32_line, int8_line,
        None, int8_kv=True)
    run("slice_tp_int8w", phase_slice_tp_int8w, torch, kernels, f32_line,
        int8_line, int8_ref)
    run("slice_recovery", phase_slice_recovery, torch, kernels, cpu_ref)
    run("slice_fault_sticky", phase_slice_fault_sticky, torch)
    run("slice_supervisor", phase_slice_supervisor, torch, smi)
    run("slice_host_tier", phase_slice_host_tier, torch, kernels, smi)
    run("slice_snapshot", phase_slice_snapshot, torch, kernels, smi)
    run("slice_lora", phase_slice_lora, torch, kernels, smi, f32_line,
        dense_line, cpu_ref)
    run("slice_control", phase_slice_control, torch, kernels, smi, cpu_ref)
    run("slice_fleet", phase_slice_fleet, torch, kernels, smi, f32_line)
    run("train_preempt", phase_train_preempt, torch, kernels, smi)
    sharded_losses = run("train_sharded", phase_train_sharded, torch,
                         kernels, smi)
    run("infer_int8", phase_infer_int8, torch, kernels, smi)
    run("train_rnn", phase_train_rnn, torch, kernels, smi)
    run("detect", phase_detect, torch, kernels, smi)
    run("load_native", phase_load_native, torch, kernels, smi, f32_line,
        sharded_losses)
    loss32 = run("train", phase_train, torch, kernels, smi)
    run("train_bf16", phase_train_bf16, torch, kernels, smi, loss32)
    run("train_resnet", phase_train_resnet, torch, kernels, smi)
    run("train_optimizer", phase_train_optimizer, torch, kernels, smi)
    run("train_distri", phase_train_distri, torch, kernels, smi)
    run("train_cnn", phase_train_cnn, torch, kernels, smi)
    run("load_interop", phase_load_interop, torch, kernels, smi)
    run("load_tf", phase_load_tf, torch, kernels, smi)
    run("load_tf_train", phase_load_tf_train, torch, kernels, smi)
    run("train_bert", phase_train_bert, torch, kernels, smi)
    emit({"phase": "run", "seconds": time.perf_counter() - t_start,
          "phase_seconds": seconds})
    emit({"kernels": list(kernels.values())})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
