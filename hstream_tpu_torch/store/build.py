"""Build the native store shared library (g++, no external deps beyond
zlib). The .so is cached next to the source and rebuilt when the source
is newer — a dev-friendly analogue of the reference's cbits build
(hstream-store.cabal cxx-sources)."""

# A copy of hstream_tpu/store/build.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import os

from hstream_tpu_torch.common.nativebuild import build_so

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "cpp", "nstore.cpp")
SO = os.path.join(_DIR, "cpp", "libnstore.so")


def build() -> str:
    """Compile cpp/nstore.cpp -> cpp/libnstore.so if stale; returns the
    .so path."""
    return build_so(SRC, SO, libs=("z",))
