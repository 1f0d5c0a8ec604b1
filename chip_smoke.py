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
     in two chunks a row (320 zero-padded to 512); each call on the path
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
                ("fwd", "dq", "dkv"))]
FLASH_DTYPES = ("float32", "bfloat16")
FLASH_TOL = {"float32": {"fwd": 2e-5, "grad": 1e-4}, "bfloat16": 2e-2}
# the cases timed beside SDPA
FLASH_TIMED = ("path", "d128", "d32", "d80", "d160", "d256", "d320", "d512",
               "d320_full", "d512_full")
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
            "head_dims": head_dims, "launches": 0, "shapes": shapes}
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


def _drive(engine, prompts, adapters=None):
    """Submit the traffic: 8 requests at once, then, once request 3's
    prefill registered the shared pages, the other 4 (which wait for free
    slots); request ``i`` under ``adapters[i]`` when given. Returns the
    handles."""
    t0 = time.perf_counter()
    adapters = adapters or [None] * 12
    handles = [engine.submit(prompts[i], N_NEW, temperature=TEMPS[i],
                             adapter=adapters[i])
               for i in range(8)]
    while handles[3].first_token_at is None:
        check(not handles[3].done.is_set() or handles[3].error is None,
              f"request 3 failed: {handles[3].error!r}")
        check(time.perf_counter() - t0 < 300, "request 3 stalled")
        time.sleep(0.005)
    return handles + [engine.submit(prompts[i], N_NEW,
                                    temperature=TEMPS[i],
                                    adapter=adapters[i])
                      for i in range(8, 12)]


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
                   before_run=None, after_run=None):
    """A warm-up request, then the 12-request traffic (request ``i`` under
    ``adapters[i]`` when given) with every count set to 0 just before it
    and read just after, then (``profiled``) the same traffic with fresh
    prompts once more under torch.profiler, LoRA delta products as their
    own range when there are ``adapters``. ``before_run()`` and
    ``after_run()`` are called just before the counted run and when its
    counts are read. Returns the run's record."""
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
        handles = _drive(engine, prompts, adapters)
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
        fresh.load_state_dict(torch.load(os.path.join(ckpt, f"model.{last}"),
                                         weights_only=True))
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
        fresh = ResNet(class_num=1000, depth=50, format="NHWC")
        fresh.load_state_dict(torch.load(os.path.join(ckpt, f"model.{last}"),
                                         weights_only=True))
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
               generator=None):
    """``make_train_step`` (SGD CNN_LR, momentum 0.9) on one seeded batch
    of CNN_BATCH: a warm-up step, then ``steps`` timed ones, launches held
    against the route table; then 2 steps under the profiler. Emits and
    returns the line."""
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
    line = {"phase": "train_cnn", "part": name, "format": "NCHW",
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
    emit({"phase": "profile", "path": f"train_cnn_{name}", "steps": 2,
          **profile})
    for kind in ("k9", "i2c"):
        kernels[f"conv3x3_{kind}"].setdefault("launches_by_phase", {})[
            f"train_cnn_{name}"] = {"tensor_cores": counts[kind],
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
        fresh.load_state_dict(torch.load(
            os.path.join(ckpt, f"model.{CNN_DISTRI_STEPS + 1}"),
            weights_only=True))
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


# ------------------------------------------------------------- resilience
# the no-fault phases' outputs (all 12 requests), by path: what the fault
# phases' greedy tokens are held to
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
    """Requests ``idx`` under ``adapters``, submitted while the scheduler
    waits on its lock (one admission pass sees them all). Returns their
    outputs {request: tokens}, the seconds, and {request id: request}."""
    t0 = time.perf_counter()
    with engine.scheduler._cond:
        hs = [engine.submit(prompts[i], n_new, adapter=a)
              for i, a in zip(idx, adapters)]
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
    loss32 = run("train", phase_train, torch, kernels, smi)
    run("train_bf16", phase_train_bf16, torch, kernels, smi, loss32)
    run("train_resnet", phase_train_resnet, torch, kernels, smi)
    run("train_optimizer", phase_train_optimizer, torch, kernels, smi)
    run("train_distri", phase_train_distri, torch, kernels, smi)
    run("train_cnn", phase_train_cnn, torch, kernels, smi)
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
