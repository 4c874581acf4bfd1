"""Unique id generation.

Snowflake-style 64-bit ids: 40 bits of milliseconds since a custom epoch,
14 bits of per-process sequence, 10 bits of node id — unique, roughly
time-ordered, and safe to mint concurrently. Mirrors the capability of the
reference's `genUnique` (common/HStream/Utils.hs:57-76) without copying its
exact bit split.
"""

# A copy of hstream_tpu/common/idgen.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import itertools
import os
import threading
import time

_EPOCH_MS = 1_577_836_800_000  # 2020-01-01T00:00:00Z

_SEQ_BITS = 14
_NODE_BITS = 10
_SEQ_MASK = (1 << _SEQ_BITS) - 1
_NODE_MASK = (1 << _NODE_BITS) - 1

_counter = itertools.count()
_node_id = (os.getpid() ^ (threading.get_ident() & 0xFFFF)) & _NODE_MASK


def gen_unique() -> int:
    """Return a fresh 64-bit id (time-ordered across one process)."""
    ms = int(time.time() * 1000) - _EPOCH_MS
    seq = next(_counter) & _SEQ_MASK
    return (ms << (_SEQ_BITS + _NODE_BITS)) | (seq << _NODE_BITS) | _node_id
