"""Build the JAX package's native libraries (store/cpp/nstore.cpp,
engine/cpp/jsondec.cpp) safely before a test of the port uses them.

The tests run in several worker processes, and the reference's build
writes every build to one fixed temporary file, so two workers building
one library at once can load a half-written file. The port's
nativebuild writes a temporary file per process and renames it into
place; the reference then finds its library up to date and builds
nothing."""

from __future__ import annotations

from hstream_tpu_torch.common.nativebuild import build_so


def build_reference_libs() -> None:
    from hstream_tpu.common import jsondec
    from hstream_tpu.store import build

    build_so(build.SRC, build.SO, libs=("z",))
    build_so(jsondec.SRC, jsondec.SO, opt="-O3")
