#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``bigdl_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

Phases, each printing one JSON line (any failure exits non-zero):

1. device  — require CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them.
2. build   — compile every kernel of the path from ``bigdl_tpu_torch/ops/
   csrc`` (one ``nvcc`` per source, all at once) and report the seconds.
3. kernels — call each kernel's wrapper on card tensors at the shapes the
   serving path gives it, hold it against its plain PyTorch version on
   the same inputs, and time both with CUDA events beside the kernel's
   roofline bound:
   * paged attention: 8 slots, 12 heads, head_dim 64, page_size 16, 64
     table entries, shared pages and sentinel tails; decode (C=1, all 8
     slots) and a prefill chunk (C=64, the 4-row prefill window); float32
     (max abs error <= 2e-5) and bfloat16 (atol = rtol = 2e-2);
   * fused sampling: 8 x 50257 logits, top_k 50, top_p 0.9, per-row
     temperatures, one injected gumbel draw; tokens must be identical
     except on a row whose kept-set boundary lies within 1e-5 of its level
     (such a row is printed).
4. slice   — GPT-2 small at full width (12 layers, hidden 768, 12 heads,
   vocab 50257, context 1024), float32, seeded random weights: the paged
   ``ServingEngine`` serves 12 requests (prompts of 24-700 tokens, two
   sharing a 256-token prefix, 8 greedy and 4 at temperature 0.8, 64 new
   tokens each). Checks: every request retires with its tokens; the
   paged-attention kernel launched once per layer for every prefill chunk
   and decode step, the sampler at least once; the prefix cache hit; the
   first 16 greedy tokens of two requests equal the port's run on the CPU
   (plain versions), or diverge only at a step whose top-2 logit gap on
   the CPU is below 1e-3 (printed). Then the same traffic, with fresh
   prompts, runs once more under ``torch.profiler`` (a ``profile`` line):
   the device's busy time against the wall time and the kernels that take
   the most device time.

Then a ``{"kernels": [...]}`` line (name, route, source, replaced TPU
kernel, launches on the serving run, max error, kernel / plain / bound
times in ms), the nvidia-smi line again, and last
``{"ok": true, "device": {...}}``.

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


def time_ms(torch, fn, iters, flush=None):
    """Mean device time of ``fn`` over ``iters`` runs after a warm-up,
    from CUDA events; with ``flush`` (a buffer larger than L2) the cache
    is overwritten before each run and only the run is timed."""
    for _ in range(3):
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
    t0 = time.perf_counter()
    compiled = _build.build("paged_attention", "sampling")
    secs = time.perf_counter() - t0
    ptxas = [ln.strip() for name in ("paged_attention", "sampling")
             for ln in _build.build_log(name).splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": secs, "compiled": compiled,
          "ptxas": ptxas})


def _paged_case(torch, dtype, b, c, starts, tables, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    n, h, ps, d = 512, 12, 16, 64
    kw = dict(generator=g, device="cuda", dtype=torch.float32)
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


def phase_kernels(torch):
    from bigdl_tpu_torch.ops import paged_attention as pa
    from bigdl_tpu_torch.ops import sampling as sm
    flush = torch.empty(80 * 2 ** 20 // 4, dtype=torch.float32,
                        device="cuda")
    results = {}

    # paged attention: decode over 8 slots (row 7 inactive, all sentinel;
    # rows 2 and 3 share 16 pages = a 256-token prefix) and one prefill
    # chunk of the 4-row window
    dec_len = [24, 100, 300, 310, 700, 1000, 513, 0]
    dec = dict(b=8, c=1, starts=[max(x - 1, 0) for x in dec_len],
               tables=_tables(dec_len, share=(2, 3, 16)))
    chk_start = [0, 192, 256, 640]
    chk = dict(b=4, c=64, starts=chk_start,
               tables=_tables([s + 64 for s in chk_start],
                              share=(1, 2, 12)))
    shapes = []
    for label, case in (("decode", dec), ("chunk", chk)):
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            q, pool, table, start = _paged_case(
                torch, dtype, case["b"], case["c"], case["starts"],
                case["tables"], seed=len(shapes))
            got = pa.paged_pool_attention(q, pool, table, start)
            torch.cuda.synchronize()
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
                  f"paged attention {label} {dtype}: non-finite output")
            check(ok, f"paged attention {label} {dtype}: max abs err "
                      f"{max_err} over tolerance {tol}")
            nbytes, flops = pa.bytes_and_flops(q, pool, table, start)
            b_ms, b_by = bound(nbytes, flops, dtype)
            ms = time_ms(torch, lambda: pa.paged_pool_attention(
                q, pool, table, start), 50, flush)
            plain_ms = time_ms(torch, lambda: pa.paged_pool_attention_ref(
                q, pool, table, start), 10, flush)
            shapes.append({"shape": label, "B": case["b"], "C": case["c"],
                           "dtype": str(dtype).replace("torch.", ""),
                           "max_abs_err": max_err, "tolerance": tol,
                           "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": b_ms, "bound_by": b_by,
                           "bytes": nbytes, "flops": flops})
    f32 = [s for s in shapes if s["dtype"] == "float32"]
    d32 = f32[0]
    results["paged_attention"] = {
        "name": "paged_attention", "route": "cuda",
        "source": "bigdl_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "bigdl_tpu/ops/paged_attention.py:69",
        "max_abs_err": max(s["max_abs_err"] for s in f32),
        "ms": d32["ms"], "plain_ms": d32["plain_ms"],
        "bound_ms": d32["bound_ms"], "bound_by": d32["bound_by"],
        # no single PyTorch call attends through a page table
        "library_ms": None, "timed_shape": "decode float32",
        "launches": 0, "shapes": shapes}
    emit({"phase": "kernels", "kernel": "paged_attention", "shapes": shapes})

    # fused sampling at the serving shape
    s_rows, vocab, top_k, top_p = 8, 50257, 50, 0.9
    g = torch.Generator(device="cuda").manual_seed(11)
    temps = torch.tensor([0.5, 0.8, 1.0, 1.3, 0.7, 0.9, 1.1, 0.6],
                         device="cuda")
    samples = []
    for dtype in (torch.float32, torch.bfloat16):
        logits = (3.0 * torch.randn((s_rows, vocab), generator=g,
                                    device="cuda")).to(dtype)
        gumbel = sm.gumbel_noise((s_rows, vocab), g, "cuda", dtype)
        got = sm.fused_sample_logits(logits, gumbel, temps, top_k, top_p)
        torch.cuda.synchronize()
        want = sm.fused_sample_logits_ref(logits, gumbel, temps, top_k,
                                          top_p)
        near = _near_boundary(torch, logits, temps, top_k, top_p)
        diff = (got != want).nonzero().flatten().tolist()
        for r in diff:
            print(f"sampling {dtype}: row {r} differs (kernel "
                  f"{int(got[r])}, plain {int(want[r])}), near boundary "
                  f"{bool(near[r])}", flush=True)
        bad = [r for r in diff if not near[r]]
        check(not bad, f"fused sampling {dtype}: rows {bad} differ away "
                       f"from a kept-set boundary")
        nbytes, flops = sm.bytes_and_flops(logits, top_k, top_p)
        b_ms, b_by = bound(nbytes, flops, dtype)
        ms = time_ms(torch, lambda: sm.fused_sample_logits(
            logits, gumbel, temps, top_k, top_p), 50)
        plain_ms = time_ms(torch, lambda: sm.fused_sample_logits_ref(
            logits, gumbel, temps, top_k, top_p), 5)
        ok_rows = [r for r in range(s_rows) if r not in diff] or [0]
        samples.append({"dtype": str(dtype).replace("torch.", ""),
                        "rows": s_rows, "vocab": vocab,
                        "differing_rows": diff,
                        "max_abs_err": float((got[ok_rows].long()
                                              - want[ok_rows].long())
                                             .abs().max()),
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "bytes": nbytes, "flops": flops})
    s32 = samples[0]
    results["fused_sampling"] = {
        "name": "fused_sampling", "route": "cuda",
        "source": "bigdl_tpu_torch/ops/csrc/sampling.cu",
        "replaces": "bigdl_tpu/ops/sampling.py:75",
        "max_abs_err": s32["max_abs_err"], "ms": s32["ms"],
        "plain_ms": s32["plain_ms"], "bound_ms": s32["bound_ms"],
        "bound_by": s32["bound_by"],
        # no single PyTorch call does top-k + top-p + the gumbel draw
        "library_ms": None, "timed_shape": "8x50257 float32",
        "launches": 0, "shapes": samples}
    emit({"phase": "kernels", "kernel": "fused_sampling", "shapes": samples})
    del flush
    return results


def _near_boundary(torch, logits, temps, top_k, top_p, eps=1e-5):
    """Per row: does the kept set's boundary lie within ``eps`` of its
    level? Top-k: the k-th and (k+1)-th scaled logits nearly tie; top-p:
    a cumulative softmax mass (after top-k) lies within ``eps`` of p."""
    l = logits.float() / temps.to(logits.dtype).float()[:, None].clamp_min(
        1e-6)
    srt = torch.sort(l, dim=-1, descending=True).values
    near = (srt[:, top_k - 1] - srt[:, top_k]).abs() < eps
    kept = srt[:, :top_k]
    probs = torch.softmax(kept, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
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


def _profile(torch, engine, prompts):
    """Run the traffic under torch.profiler and report the device's busy
    time (the union of CUDA kernel and copy intervals) against the wall
    time, with the largest kernels by device time. Without device events
    the device numbers are "not measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for h in _drive(engine, prompts):
            h.result(timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
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
    return {"wall_s": wall, "device_busy_s": busy / 1e6,
            "device_busy_share": busy / 1e6 / wall,
            "device_events": len(dev), "device_time_s": total / 1e6,
            "top": [{"name": k[:80], "calls": n, "s": t / 1e6,
                     "share_of_device_time": t / total}
                    for k, (n, t) in top]}


def phase_slice(torch, kernels):
    import numpy as np
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.models.gpt import gpt2_small
    from bigdl_tpu_torch.ops.paged_attention import paged_pool_attention
    from bigdl_tpu_torch.ops.sampling import fused_sample_logits
    from bigdl_tpu_torch.serving import ServingEngine
    from bigdl_tpu_torch.serving.paging import PagedSlotManager

    t0 = time.perf_counter()
    model = gpt2_small()
    params = convert.init_params(model, seed=0)
    engine = ServingEngine(model, params, max_slots=8, paged=True,
                           page_size=16, prefill_chunk=64, top_k=50,
                           top_p=0.9, seed=0)
    n_layers = len(model.gpt.layers)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    try:
        # warm-up (cuBLAS handles, allocator): not part of the run
        engine.generate(rng.integers(0, 50257, 80), 4, temperature=0.8,
                        timeout=300)
        # the counts start at 0 just before the serving run
        paged_pool_attention.launches = 0
        fused_sample_logits.launches = 0
        engine.stats.reset()
        prompts = _traffic(rng)
        t_run = time.perf_counter()
        handles = _drive(engine, prompts)
        outs = [h.result(timeout=600) for h in handles]
        wall = time.perf_counter() - t_run
        stats = engine.stats.snapshot()
        pa_launches = paged_pool_attention.launches
        fs_launches = fused_sample_logits.launches
        metrics = engine.metrics()
        # where the time goes: the same traffic (fresh prompts) once more
        # under torch.profiler, after the counts were read
        profile = _profile(torch, engine, _traffic(rng))
    finally:
        engine.shutdown()
    for i, (o, h) in enumerate(zip(outs, handles)):
        check(o.size == LENGTHS[i] + N_NEW and not h.truncated,
              f"request {i}: {o.size - LENGTHS[i]} of {N_NEW} tokens")
        check(((o >= 0) & (o < 50257)).all(), f"request {i}: bad token id")
    dispatches = stats["prefill_chunks"] + stats["steps"]
    check(pa_launches >= n_layers * dispatches,
          f"paged attention launched {pa_launches} times for {dispatches} "
          f"chunk+step dispatches of {n_layers} layers")
    check(fs_launches >= 1, "the fused sampler never launched")
    check(metrics["prefix_hits"] >= 1 and metrics["prefix_hit_tokens"]
          >= 256, f"no prefix-cache hit: {metrics['prefix_hits']}")
    kernels["paged_attention"]["launches"] = pa_launches
    kernels["fused_sampling"]["launches"] = fs_launches
    ttft = [h.first_token_at - h.submitted_at for h in handles]
    generated = sum(o.size - n for o, n in zip(outs, LENGTHS))

    # greedy tokens against the port's plain versions on the CPU
    cmp_idx = [0, 11]
    cpu_model = gpt2_small(device="cpu")
    cpu_model.load_state_dict(params)
    cpu_model.requires_grad_(False)
    slots = PagedSlotManager(cpu_model, max_slots=2, page_size=16,
                             prefill_chunk=64)
    slots.admit([prompts[i] for i in cmp_idx])
    n_cmp = 16
    cpu_toks, gaps = [], []
    for _ in range(n_cmp):
        top2 = torch.topk(slots._logits.float(), 2, dim=-1).values
        gaps.append((top2[:, 0] - top2[:, 1]).tolist())
        slots.reserve_block()
        cpu_toks.append(slots.step()[0])
    cpu_toks = np.stack(cpu_toks, axis=1)                   # (2, n_cmp)
    divergences = []
    for row, i in enumerate(cmp_idx):
        gpu = outs[i][LENGTHS[i]:LENGTHS[i] + n_cmp]
        miss = np.nonzero(gpu != cpu_toks[row])[0]
        if miss.size:
            step = int(miss[0])
            gap = gaps[step][row]
            print(f"request {i}: GPU and CPU greedy tokens diverge at step "
                  f"{step}, CPU top-2 logit gap {gap}", flush=True)
            check(gap < 1e-3, f"request {i} diverges at step {step} with a "
                              f"top-2 gap of {gap}")
            divergences.append({"request": i, "step": step, "gap": gap})
    emit({"phase": "slice", "model": "gpt2_small", "layers": n_layers,
          "requests": len(handles), "new_tokens_each": N_NEW,
          "generated_tokens": int(generated), "wall_s": wall,
          "tokens_per_s": generated / wall,
          "ttft_mean_s": float(np.mean(ttft)),
          "ttft_p50_s": float(np.median(ttft)),
          "ttft_max_s": float(np.max(ttft)),
          "prefill_chunks": stats["prefill_chunks"],
          "decode_steps": stats["steps"], "cow_copies": stats["copies"],
          "paged_attention_launches": pa_launches,
          "fused_sampling_launches": fs_launches,
          "prefix_hits": metrics["prefix_hits"],
          "prefix_hit_tokens": metrics["prefix_hit_tokens"],
          "greedy_checked": [int(i) for i in cmp_idx],
          "greedy_tokens_compared": n_cmp, "divergences": divergences,
          "setup_s": setup_s})
    emit({"phase": "profile", **profile})


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script measures the "
              "GPU only", file=sys.stderr)
        return 1
    # the port itself; outside a checkout of the repo this import fails
    import bigdl_tpu_torch  # noqa: F401

    smi = phase_device(torch)
    phase_build()
    kernels = phase_kernels(torch)
    phase_slice(torch, kernels)
    emit({"kernels": list(kernels.values())})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
