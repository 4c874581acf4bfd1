"""protocheck: explicit-state model checking of the ownership protocol.

The analyzer certifies the lock layer (``hstream_tpu_torch.tools.analyze``
lockorder/atomicity); this package does the same for the DISTRIBUTED state
machine those locks protect: the query-ownership / heartbeat-lease /
boot-epoch protocol of ``server/scheduler.py`` + ``placer/core.py``,
and the epoch fence / promote rules of ``store/replica.py``.

The checker drives the REAL protocol functions — ``try_adopt``,
``try_adopt_live``, ``heartbeat_assignment``, ``offer_assignment``,
``owner_live``, the placer tick stages, ``FollowerService.Replicate``
and ``Promote`` — against an in-memory ``meta_cas`` config store under
a controlled scheduler: a virtual clock replaces the wall clock, every
placer stage / boot sweep / crash / pause / clock-skew step is one
atomic model action, and the explorer enumerates all interleavings of
those actions up to a bounded depth with visited-state dedup plus
sleep-set (DPOR-style) transition pruning.

Soundness notes (what a green run certifies):

* Actions are ATOMIC — one whole protocol function per step. Races
  *between* ticks (the distributed protocol) are exhaustively
  explored; races *inside* one function (CAS retry loops, the torn
  pack attach, the FAILED-status clobber) are thread-level and remain
  the domain of the analyzer's lockorder/atomicity certification.
* Time is quantized (``Scenario.quantum_ms``) and horizon-bounded, so
  the state space is finite; state keys are translation-invariant in
  time and rank-canonical in epochs, so depth bounds cut nothing a
  shifted clock would have reached.
* Sleep-set pruning only skips a transition whose effect is provably
  identical to an already-explored one (conservative independence:
  disjoint record footprints); visited-state dedup re-explores a state
  only for actions not yet tried from it. Every reachable state is
  visited and every (state, action) post-condition is either executed
  or a commuted copy of an executed one.

This is the port's copy of the reference's checker: it drives
``hstream_tpu_torch``'s placer, scheduler, persistence, versioned store,
replica and proto, never the JAX package's.

The checker is itself mutation-gated: ``mutants.py`` mechanically
reverts each ownership/replication fix and the gate requires a
counterexample trace for every mutant (see ``python -m
hstream_tpu_torch.tools.protocheck --mutants``).
"""

from hstream_tpu_torch.tools.protocheck.invariants import Violation  # noqa: F401
from hstream_tpu_torch.tools.protocheck.model import SCENARIOS, Model, Scenario  # noqa: F401
from hstream_tpu_torch.tools.protocheck.explore import (  # noqa: F401
    Counterexample,
    ExploreResult,
    explore,
    replay,
)
