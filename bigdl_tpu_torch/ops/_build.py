"""Build the CUDA sources under ``ops/csrc/`` at first use and load them
with ``ctypes``.

Each ``ops/csrc/<name>.cu`` exposes a plain C interface and compiles on
its own with ``nvcc`` into ``ops/_build/<name>-<hash>.so`` (``.gitignore``
lists the directory). ``<hash>`` covers the source, every shared
``*.cuh`` header and the compiler flags, so an edited source rebuilds and
an unchanged one loads the library already built. ``build`` starts one
``nvcc`` per missing library, all at once, and waits for them together.

The compiler is taken from ``CUDA_HOME``/``CUDA_PATH``, then from
PyTorch's own CUDA lookup, then from ``PATH``. Each build's compiler
output (including ``ptxas`` register and shared-memory use, from
``-Xptxas -v``) is kept beside the library as ``<name>-<hash>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}


def _nvcc():
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit that should build the kernels")
    return found


def _sources(name):
    src = CSRC_DIR / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(f"no kernel source {src}")
    return [src] + sorted(CSRC_DIR.glob("*.cuh"))


def lib_path(name):
    """Path of the library built from the current sources of ``name``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _sources(name):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_log(name):
    """Compiler output of the current build of ``name`` ("" if none)."""
    log = lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(*names):
    """Build every library in ``names`` that is missing, one ``nvcc``
    each, all started together; raise with the compiler's output if any
    fails. Returns the names that were compiled (not found built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        log = open(out.with_suffix(".log"), "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        try:
            proc = subprocess.Popen(cmd, stdout=log,
                                    stderr=subprocess.STDOUT)
        except BaseException:
            log.close()
            raise
        procs.append((name, proc, tmp, out, log))
    failed = []
    for name, proc, tmp, out, log in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out)     # atomic: a reader never sees half
        else:
            failed.append((name, rc, out.with_suffix(".log").read_text()))
    if failed:
        msg = "; ".join(f"{n} (nvcc exit {rc}):\n{text[-4000:]}"
                        for n, rc, text in failed)
        raise RuntimeError(f"kernel build failed: {msg}")
    return [p[0] for p in procs]


def load(name, declare):
    """The loaded library of kernel source ``name`` (built first if
    needed); ``declare(lib)`` sets its functions' ``argtypes`` and
    ``restype`` once, on first load."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(lib_path(name)))
            declare(lib)
            _libs[name] = lib
        return lib
