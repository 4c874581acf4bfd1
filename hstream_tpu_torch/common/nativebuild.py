"""Build-on-demand for native host libraries (a copy of
hstream_tpu/common/nativebuild.py).

One canonical g++ invocation for every cbits-style source in the tree
(engine/cpp/encode.cpp) — the dev-friendly
analogue of the reference's cabal cxx-sources builds."""

from __future__ import annotations

import os
import subprocess
import threading

_lock = threading.Lock()


def build_so(src: str, so: str, *, opt: str = "-O2") -> str:
    """Compile `src` -> `so` if stale; returns the .so path."""
    with _lock:
        if (os.path.exists(so)
                and os.path.getmtime(so) >= os.path.getmtime(src)):
            return so
        tmp = so + ".tmp"
        cmd = ["g++", "-std=c++17", opt, "-fPIC", "-shared", "-pthread",
               src, "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"native build of {os.path.basename(src)} failed:\n"
                f"{proc.stderr[-4000:]}")
        os.replace(tmp, so)
        return so
