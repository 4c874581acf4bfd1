"""Flow control: admission quotas, overload shedding, delivery credits.

The subsystem between "fast" and "fast under overload": a hierarchical
token-bucket quota tree (cluster -> tenant -> stream) persisted through
the versioned config store, an overload detector that turns the
pipeline/latency/backlog signals the repo already produces into a
graded shed ladder, and credit windows bounding per-consumer in-flight
delivery. `FlowGovernor` (one per ServerContext) fronts all three.
"""

# A copy of hstream_tpu/flow/__init__.py; the port imports nothing of the JAX
# package.

from hstream_tpu_torch.flow.bucket import TokenBucket
from hstream_tpu_torch.flow.credit import CreditWindow
from hstream_tpu_torch.flow.governor import (
    DEFAULT_CREDIT_WINDOW,
    WORK_BACKGROUND,
    WORK_USER,
    FlowGovernor,
)
from hstream_tpu_torch.flow.overload import (
    ADMIT,
    DEFER,
    REJECT,
    OverloadDetector,
)
from hstream_tpu_torch.flow.quota import Quota, QuotaTree, tenant_of

__all__ = [
    "ADMIT", "DEFER", "REJECT", "DEFAULT_CREDIT_WINDOW",
    "WORK_BACKGROUND", "WORK_USER",
    "CreditWindow", "FlowGovernor", "OverloadDetector",
    "Quota", "QuotaTree", "TokenBucket", "tenant_of",
]
