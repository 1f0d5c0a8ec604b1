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
     both kernels' tensor-core paths too, not timed.
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
    results = {}
    for kind, shapes in rows.items():
        name = f"conv3x3_{kind}"
        emit({"phase": "kernels", "kernel": name, "shapes": shapes,
              "ragged": ragged[kind]})
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
                max(r["max_abs_err"] / r["tolerance"],
                    r["flip_max_abs_err"] / r["flip_tolerance"])
                for r in shapes),
            "ms": t["ms"], "ms_spread": t["ms_spread"],
            "flip_ms": t["flip_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            # one F.conv2d call (cuDNN) on the same channels-last tensors
            "library_ms": t["library_ms"],
            "timed_shape": f"{t['N']}x{t['H']}x{t['W']}x{t['Cin']} -> "
                           f"{t['Cout']} bfloat16, tensor cores",
            "launches": 0, "shapes": shapes}
    return results


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


def _drive(engine, prompts):
    """Submit the traffic: 8 requests at once, then, once request 3's
    prefill registered the shared pages, the other 4 (which wait for free
    slots). Returns the handles."""
    t0 = time.perf_counter()
    handles = [engine.submit(prompts[i], N_NEW, temperature=TEMPS[i])
               for i in range(8)]
    while handles[3].first_token_at is None:
        check(not handles[3].done.is_set() or handles[3].error is None,
              f"request 3 failed: {handles[3].error!r}")
        check(time.perf_counter() - t0 < 300, "request 3 stalled")
        time.sleep(0.005)
    return handles + [engine.submit(prompts[i], N_NEW,
                                    temperature=TEMPS[i])
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
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and e.name not in ranges]
    if not dev:
        return {"wall_s": wall, "device_busy_s": "not measured"}
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name = {}
    for e in dev:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
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
    for name in ranges:
        hits = [e for e in prof.events() if e.name == name
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


# the serving profile's kernel families, by substrings of their names
SERVING_KERNEL_GROUPS = {"paged attention": "paged_attention_kernel",
                         "sampling": "fused_sample_kernel"}


def _serving_counts():
    """The serving path's launch counts (the flash forward's on both of
    its paths) and int8 products."""
    from bigdl_tpu_torch.nn.quantized import qmatmul
    from bigdl_tpu_torch.ops.flash_attention import flash_fwd
    from bigdl_tpu_torch.ops.paged_attention import paged_pool_attention
    from bigdl_tpu_torch.ops.sampling import fused_sample_logits
    return {"paged_attention": paged_pool_attention.launches,
            "paged_attention_int8": paged_pool_attention.int8_launches,
            "fused_sampling": fused_sample_logits.launches,
            "flash_fwd": flash_fwd.launches + flash_fwd.tc_launches,
            "int8_matmuls": qmatmul.calls}


def _reset_serving_counts():
    from bigdl_tpu_torch.nn.quantized import qmatmul
    from bigdl_tpu_torch.ops.paged_attention import paged_pool_attention
    from bigdl_tpu_torch.ops.sampling import fused_sample_logits
    paged_pool_attention.launches = 0
    paged_pool_attention.int8_launches = 0
    paged_pool_attention.sharded_calls = 0
    fused_sample_logits.launches = 0
    fused_sample_logits.long_row_launches = 0
    qmatmul.calls = 0
    _reset_flash_counts()


SPEC_KEYS = ("spec_proposed", "spec_accepted", "spec_rollbacks",
             "spec_accept_rate")


def _serve_traffic(torch, engine, rng):
    """A warm-up request, then the 12-request traffic with every count set
    to 0 just before it and read just after, then the same traffic (fresh
    prompts) once more under torch.profiler. Returns the run's record."""
    try:
        # warm-up (cuBLAS handles, allocator): not part of the run
        engine.generate(rng.integers(0, 50257, 80), 4, temperature=0.8,
                        timeout=300)
        _reset_serving_counts()
        engine.stats.reset()
        torch.cuda.reset_peak_memory_stats()
        prompts = _traffic(rng)
        t_run = time.perf_counter()
        handles = _drive(engine, prompts)
        outs = [h.result(timeout=600) for h in handles]
        wall = time.perf_counter() - t_run
        stats = engine.stats.snapshot()
        counts = _serving_counts()
        metrics = engine.metrics()
        peak = torch.cuda.max_memory_allocated()
        # where the time goes: the same traffic (fresh prompts) once more
        # under torch.profiler, after the counts were read
        fresh = _traffic(rng)
        profile = _profile(torch, lambda: [h.result(timeout=600)
                                           for h in _drive(engine, fresh)],
                           groups=SERVING_KERNEL_GROUPS)
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


def _greedy_slots(torch, model, prompts, n_steps, int8_kv, paged=True):
    """Prompts through a 2-slot ``PagedSlotManager`` (or, ``paged=False``,
    a dense ``SlotManager`` of one slot a prompt) on ``model``'s device,
    admitted together, then ``n_steps`` greedy decode steps. Returns the
    tokens (B, n_steps) and each step's float32 logits (B, n_steps, V) on
    the CPU."""
    import numpy as np
    from bigdl_tpu_torch.serving import PagedSlotManager, SlotManager
    if paged:
        slots = PagedSlotManager(model, max_slots=2, page_size=16,
                                 prefill_chunk=64, int8_kv=int8_kv)
    else:
        slots = SlotManager(model, max_slots=len(prompts),
                            window=len(prompts))
    slots.admit(prompts)
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


def main():
    import torch
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
    loss32 = run("train", phase_train, torch, kernels, smi)
    run("train_bf16", phase_train_bf16, torch, kernels, smi, loss32)
    run("train_resnet", phase_train_resnet, torch, kernels, smi)
    run("train_optimizer", phase_train_optimizer, torch, kernels, smi)
    run("train_distri", phase_train_distri, torch, kernels, smi)
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
