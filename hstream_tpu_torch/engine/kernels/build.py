"""Build the port's CUDA kernels from the repo's own sources.

`build()` compiles every `csrc/*.cu` with one `nvcc` per source, all
started together, and links them into one shared library with a plain C
interface (`csrc/hs_kernels.h`), which engine/kernels/binding.py loads
with ctypes. The library lands in `_build/` (git-ignored), named by a
hash of the sources and flags, so an unchanged tree builds once.

Why nvcc + ctypes and not `torch.utils.cpp_extension.load`: a source
that includes PyTorch's headers takes minutes to compile, a plain CUDA
file seconds, and every run on a fresh machine builds anew. Nothing here
runs at import time; the first CUDA launch calls `build()`.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import NamedTuple

from hstream_tpu_torch.common.tracing import note_compile
from hstream_tpu_torch.stats.devicecost import PROGRAMS

_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "_build")
SOURCES = ("decode.cu", "unpack.cu", "expr.cu", "scatter.cu", "topk.cu",
           "close.cu", "touched.cu", "rebase.cu", "session_step.cu",
           "session_merge.cu", "session_extract.cu", "session_remap.cu",
           "join_probe.cu", "join_insert.cu", "join_evict.cu")
HEADERS = ("hs_kernels.h", "record.cuh", "finalize.cuh", "lookback.cuh",
           "device.cuh", "session_chain.cuh", "join_core.cuh")
# sm_90a: Hopper. --fmad=false: no multiply-add contraction anywhere, so
# the dec decode and the finalize arithmetic round exactly like the
# plain PyTorch versions. --ftz=true: float32 subnormal operands and
# results flush to a zero of their sign, as XLA's CPU backend and a TPU
# flush them in the reference (the kernels flush explicitly where a
# float's bits reach an integer path; csrc/record.cuh).
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "--fmad=false", "--ftz=true", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_noted = False  # the first build() of the process counted as a compile


class Built(NamedTuple):
    path: str       # the shared library
    seconds: float  # compile + link time, 0.0 when it was already built
    log: str        # nvcc's and ptxas's output per source, "" if cached


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, torch's CUDA_HOME, or PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    for home in (os.environ.get("CUDA_HOME"), CUDA_HOME, "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def build() -> Built:
    """Compile and link the kernels if needed. The process's first call
    counts as one compile (common/tracing.RetraceGuard), whether it
    builds or finds the library built, and lands one row in the
    compiled-program inventory (stats.devicecost.PROGRAMS, keyed by the
    sources' digest); later calls count nothing."""
    global _noted
    with _lock:
        first = not _noted
        if first:
            _noted = True
            note_compile()
        t0 = time.perf_counter()
        digest = _digest()
        built = _build_locked(digest)
        if first:
            PROGRAMS.record("kernels.build", f"hs_kernels:{digest}",
                            (time.perf_counter() - t0) * 1e3)
        return built


def _build_locked(digest: str) -> Built:
    """The library of this digest: found, or compiled and linked."""
    lib = os.path.join(BUILD_DIR, f"libhs_kernels_{digest}.so")
    if os.path.exists(lib):
        return Built(lib, 0.0, "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in SOURCES:
        obj = os.path.join(BUILD_DIR, src + ".o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, src),
             "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for src, proc in zip(SOURCES, procs):
        out, _ = proc.communicate()
        logs.append(f"== {src}\n{out}")
        if proc.returncode != 0:
            failed.append(src)
    if failed:  # the failed sources' output, each cut to its end
        raise RuntimeError("nvcc failed on " + ", ".join(failed) + ":\n"
                           + "\n".join(log[-4000:] for src, log
                                       in zip(SOURCES, logs)
                                       if src in failed))
    tmp = lib + ".tmp"
    link = subprocess.run([nvcc, "-shared", *objs, "-o", tmp],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stderr[-4000:]}")
    os.replace(tmp, lib)
    return Built(lib, time.perf_counter() - t0, "\n".join(logs))
