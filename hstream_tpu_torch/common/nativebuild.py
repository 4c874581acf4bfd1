"""Build-on-demand for native host libraries (a copy of
hstream_tpu/common/nativebuild.py, safe across processes).

One canonical g++ invocation for every cbits-style source in the tree
(store/cpp/nstore.cpp, engine/cpp/encode.cpp, engine/cpp/jsondec.cpp)
— the dev-friendly analogue of the reference's cabal cxx-sources
builds. Each build writes a temporary file of its own process and
renames it over the library, so processes that build the same library
at once (test workers) each load a whole file: the rename is atomic."""

from __future__ import annotations

import os
import subprocess
import threading

_lock = threading.Lock()


def build_so(src: str, so: str, *, libs: tuple[str, ...] = (),
             opt: str = "-O2") -> str:
    """Compile `src` -> `so` if stale; returns the .so path."""
    with _lock:
        if (os.path.exists(so)
                and os.path.getmtime(so) >= os.path.getmtime(src)):
            return so
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = ["g++", "-std=c++17", opt, "-fPIC", "-shared", "-pthread",
               src, "-o", tmp] + [f"-l{lib}" for lib in libs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"native build of {os.path.basename(src)} failed:\n"
                f"{proc.stderr[-4000:]}")
        os.replace(tmp, so)
        return so
