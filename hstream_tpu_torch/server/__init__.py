"""hstream-tpu server: the gRPC HStreamApi service.

Layers (mirroring the reference's hstream/src/HStream/Server):
  context.py        ServerContext (store + registries + running tasks)
  handlers.py       the 35-RPC handler table
  tasks.py          managed continuous-query tasks
  subscriptions.py  fetch/ack runtime with gap-aware ack ranges
  views.py          materialized views + pull-query serving
  persistence.py    query/connector metadata (mem + store-KV backends)
  main.py           boot/CLI
"""

# A copy of hstream_tpu/server/__init__.py; the port imports nothing of the JAX
# package.

from hstream_tpu_torch.server.context import ServerContext
from hstream_tpu_torch.server.handlers import HStreamApiServicer
from hstream_tpu_torch.server.main import serve

__all__ = ["ServerContext", "HStreamApiServicer", "serve"]
