"""The placer: turn the load/health signal plane into
placement decisions.

Three decision surfaces over the load and health signals:

  * **placement** — rank candidate nodes by the load fold each node
    publishes to ``cluster/nodes/<node>`` (stats/cluster) and write the
    winner onto ``scheduler/query/<qid>`` in the CAS-versioned config
    store (the ``try_adopt`` discipline: racing placers converge).
  * **runtime adoption** — owners heartbeat their scheduler records;
    survivors adopt a crashed node's queries live through
    ``try_adopt_live`` once the heartbeat lease lapses, resuming from
    the last snapshot through the supervisor intake (no restart of the
    dead node needed).
  * **co-compile packing** — bucket compatible queries (same source /
    window shape / agg set) into ONE shared executor whose lattice is
    keyed by a synthetic ``__q`` slot column, so N queries ride one
    pow2-padded dispatch and the 2nd..Nth query compiles nothing.

The loop is **disarmed by default** (``--placer-interval-ms`` unset):
a single-server deployment keeps the pure boot-epoch adoption
semantics with zero new background writes.
"""

# A copy of hstream_tpu/placer/__init__.py; the port imports nothing of the JAX
# package.

from hstream_tpu_torch.placer.core import (
    DEFAULT_LEASE_MS,
    Placer,
)
from hstream_tpu_torch.placer.packing import (
    PackPool,
    PackRefusal,
    pack_signature,
    signature_text,
)
from hstream_tpu_torch.placer.score import node_score, rank_nodes

__all__ = [
    "DEFAULT_LEASE_MS",
    "PackPool",
    "PackRefusal",
    "Placer",
    "node_score",
    "pack_signature",
    "rank_nodes",
    "signature_text",
]
