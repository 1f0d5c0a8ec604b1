#!/usr/bin/env python3
"""Measurements on one NVIDIA GPU that ``chip_smoke.py`` does not take.

    python3 chip_probe.py stamps              # the sampler's phases
    python3 chip_probe.py builds [--baseline DIR]

``stamps``: builds a copy of ``bigdl_tpu_torch/ops/csrc/sampling.cu`` with
clock stamps at its phase boundaries (thread 0 of rank 0 of row 0 writes
``clock64()`` into a device array), runs the sampler on
``chip_smoke.py``'s inputs (8 x 50257 and 8 x 128256 in float32 and
bfloat16 at its four (top_k, top_p) settings, its tied bfloat16 rows) and
prints, per case, the cycles between stamps (the median of five calls)
beside the call's time at S = 8 and S = 1 (``chip_smoke._steady_ms``)
and the SM clock. The stamped copy computes what the kernel does; its
tokens are checked against the plain version.

``builds``: compiles ``paged_attention.cu`` and ``sampling.cu`` alone,
one after the other, into a fresh directory, and prints each one's
seconds; with ``--baseline DIR``, the same for the checkout at DIR.

Each result is one JSON line; the script exits non-zero without CUDA.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
import time

STAMP = ("if (blockIdx.x == 0 && threadIdx.x == 0) "
         "g_probe[probe_n++] = clock64(); ")
# (a line of the kernel's source, the same line with stamps): the phase
# boundaries of fused_sample_kernel
ANCHORS = [
    ("  Shared* r0 = cluster.map_shared_rank(sh, 0);\n",
     "  Shared* r0 = cluster.map_shared_rank(sh, 0);\n  int probe_n = 0;\n  "
     + STAMP + "\n"),
    ("    sh->nreal = nr;\n  }\n  cluster.sync();\n",
     "    sh->nreal = nr;\n  }\n  " + STAMP + "\n  cluster.sync();\n  "
     + STAMP + "\n"),
    ("      if (at_or_above <=", "      " + STAMP + "\n      if (at_or_above <="),
    ("      cluster.sync();\n      if (rank != 0) return;\n",
     "      " + STAMP + "\n      cluster.sync();\n      if (rank != 0) "
     "return;\n      " + STAMP + "\n"),
    ("        if (paths) paths[s] = kPathSmall;\n      }\n      return;",
     "        if (paths) paths[s] = kPathSmall;\n      }\n      " + STAMP
     + "\n      return;"),
    ("      ++round;\n      if (d < 0) {",
     "      ++round;\n      " + STAMP + "\n      if (d < 0) {"),
    ("  finish(bv, bi, kPathRadix);",
     "  " + STAMP + "\n  finish(bv, bi, kPathRadix);"),
    ("    cluster.sync();\n    if (rank == 0 && tid == 0) {\n      float v",
     "    " + STAMP + "\n    cluster.sync();\n    " + STAMP
     + "\n    if (rank == 0 && tid == 0) {\n      float v"),
]
PROBE_API = ('#include "common.cuh"\n'
             '__device__ long long g_probe[64];\n'
             'extern "C" int probe_read(long long* h) {\n'
             '  return (int)cudaMemcpyFromSymbol(h, g_probe, sizeof(g_probe));\n'
             '}\n'
             'extern "C" int probe_zero() {\n'
             '  static long long z[64];\n'
             '  return (int)cudaMemcpyToSymbol(g_probe, z, sizeof(z));\n'
             '}\n')


def _nvcc_build(build, src_path, out_dir, name):
    """Compile ``src_path`` with ``build``'s flags into ``out_dir``;
    returns (library path, seconds, compiler output)."""
    so = os.path.join(out_dir, f"{name}.so")
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR),
           "-o", so, src_path]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src_path}:\n"
                           f"{(proc.stdout + proc.stderr)[-3000:]}")
    return so, secs, proc.stdout + proc.stderr


def stamps(torch):
    import chip_smoke as cs
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import sampling as sm

    src = (_build.CSRC_DIR / "sampling.cu").read_text()
    for plain, stamped in ANCHORS:
        if src.count(plain) != 1:
            raise RuntimeError(f"sampling.cu no longer has one {plain!r}")
        src = src.replace(plain, stamped)
    src = src.replace('#include "common.cuh"\n', PROBE_API)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = tempfile.mkdtemp(prefix="probe", dir=_build.BUILD_DIR)
    path = os.path.join(out, "sampling_stamped.cu")
    with open(path, "w") as f:
        f.write(src)
    so, _, _ = _nvcc_build(_build, path, out, "sampling_stamped")
    lib = ctypes.CDLL(so)
    sm._declare(lib)
    lib.probe_read.argtypes = [ctypes.c_void_p]
    _build._libs["sampling"] = lib     # the wrapper launches the copy
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    cs.emit({"probe": "stamps", "nvidia_smi": smi})
    flush = torch.empty(80 * 2 ** 20 // 4, dtype=torch.float32,
                        device="cuda")
    g = torch.Generator(device="cuda").manual_seed(11)
    cases = []
    for rows, vocab, _ in cs.SAMPLE_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x, gum = cs._sample_inputs(torch, g, rows, vocab, dtype)
            cases += [(f"{rows}x{vocab} {dtype}", x, gum, kp)
                      for kp in cs.SAMPLE_SETTINGS]
    x, gum = cs._sample_inputs(torch, g, 8, 50257, torch.bfloat16, ties=True)
    cases += [("ties 8x50257 bfloat16", x, gum, kp) for kp in cs.SAMPLE_TIES]
    temps = torch.tensor(cs.SAMPLE_CASES[0][2], device="cuda")
    fn = sm.fused_sample_logits
    for label, x, gum, (k, p) in cases:
        got = fn(x, gum, temps, k, p)
        want = sm.fused_sample_logits_ref(x, gum, temps, k, p)
        torch.cuda.synchronize()
        runs = []
        for _ in range(5):
            lib.probe_zero()
            fn(x, gum, temps, k, p)
            torch.cuda.synchronize()
            h = (ctypes.c_longlong * 64)()
            lib.probe_read(h)
            st = [v for v in h if v]
            runs.append([b - a for a, b in zip(st, st[1:])])
        n = min(len(r) for r in runs)
        cs.emit({"probe": "stamps", "case": label, "top_k": k, "top_p": p,
                 "tokens_equal_plain": bool((got == want).all()),
                 "cycles_between_stamps": [
                     sorted(r[i] for r in runs)[len(runs) // 2]
                     for i in range(n)],
                 "ms_s8": cs._steady_ms(torch, lambda: fn(
                     x, gum, temps, k, p), flush)[0],
                 "ms_s1": cs._steady_ms(torch, lambda: fn(
                     x[:1], gum[:1], temps[:1], k, p), flush)[0]})


def builds(baseline):
    import chip_smoke as cs
    trees = [("this", os.getcwd())] + (
        [("baseline", baseline)] if baseline else [])
    for tree, root in trees:
        build = cs._load_module(f"probe_build_{tree}",
                                f"{root}/bigdl_tpu_torch/ops/_build.py")
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = tempfile.mkdtemp(prefix="builds", dir=build.BUILD_DIR)
        for name in ("paged_attention", "sampling"):
            _, secs, log = _nvcc_build(build, str(build.CSRC_DIR /
                                                  f"{name}.cu"), out, name)
            cs.emit({"probe": "builds", "tree": tree, "source": f"{name}.cu",
                     "seconds": secs,
                     "kernels": log.count("Compiling entry function")})


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_probe: CUDA is not available", file=sys.stderr)
        return 1
    import bigdl_tpu_torch  # noqa: F401  (outside a checkout this fails)
    what = sys.argv[1] if len(sys.argv) > 1 else "stamps"
    if what == "stamps":
        stamps(torch)
    elif what == "builds":
        args = sys.argv[2:]
        builds(args[args.index("--baseline") + 1]
               if "--baseline" in args else None)
    else:
        print(f"chip_probe: unknown measurement {what!r}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
