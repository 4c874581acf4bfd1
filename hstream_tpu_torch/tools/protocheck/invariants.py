"""The certified invariants.

Three layers, matching what the protocol can promise at each horizon:

* **Transition post-conditions** — checked after every action against
  the record diff: a seizure (ownership claim over someone else's
  record) is legal ONLY through one of the sanctioned doors
  (``seizure-*``); a heartbeat pass leaves every local task backed by
  an owned record naming this node (``fence-post``) and never rewrites
  a peer's record (``hb-foreign-write``); a rebalance only emits
  offers for tasks it has already stopped (``offer-live-task``).
* **State invariants** — checked at every reachable state: record
  shape discipline (a disarmed owner's record must stay legacy — the
  stale-``hb_ms`` misread fix), and the zombie rule: a live node
  running a query its record does not grant must be ARMED (armed
  zombies self-fence on their next tick; a disarmed zombie never
  would — that is "two live owners" made permanent).
* **Convergence** — from every reachable state, the deterministic
  stabilization drive (``Model.stabilize``) must end with every
  RUNNING/rescuable query owned by exactly one live node, no offers
  pending, and no zombies: offered records converge, and no query is
  permanently unowned while a live armed node exists.

The seizure check is deliberately computed from the SPEC, not the
code: the effective lease is ``max(lease_ms, 3*interval_ms)`` (the
placer's clamp) and the heartbeat age is taken from the model's
ground-truth write times, discounted by the worst clock-skew spread.
A mutant that drops the clamp or the fresh-heartbeat refusal therefore
diverges from this spec and produces a counterexample.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from hstream_tpu_torch.server.persistence import TaskStatus


@dataclass
class Violation:
    rule: str
    message: str
    details: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {"rule": self.rule, "message": self.message,
                "details": self.details}


def _owner(rec: dict | None) -> str | None:
    return None if rec is None else rec.get("node")


def _state(rec: dict | None) -> str:
    return "absent" if rec is None else rec.get("state", "owned")


def check_transition(model, action: tuple,
                     pre: dict[str, tuple[bytes, dict]],
                     post: dict[str, tuple[bytes, dict]]
                     ) -> list[Violation]:
    """Post-conditions of one action, using the PRE-action ground
    truth (call before ``model.update_truth``)."""
    out: list[Violation] = []
    kind = action[0]
    if kind in ("advance", "pause", "resume", "skew", "crash"):
        return out  # these touch no records
    actor = model.nodes[action[1]]
    lease = model.scenario.effective_lease_ms
    spread = model.scenario.max_skew_spread_ms

    changed = [qid for qid in set(pre) | set(post)
               if (pre.get(qid) or (None,))[0]
               != (post.get(qid) or (None,))[0]]

    for qid in sorted(changed):
        pre_rec = pre[qid][1] if qid in pre else None
        post_rec = post[qid][1] if qid in post else None
        if post_rec is None:
            out.append(Violation(
                "record-dropped",
                f"{kind} by {actor.name} deleted the record of {qid}",
                {"query": qid}))
            continue
        post_state = post_rec.get("state", "owned")

        if kind == "hb":
            # a heartbeat refreshes records THIS node owns; any other
            # write from the heartbeat path keeps a peer's lease
            # alive on its behalf (or resurrects a dead record)
            if post_rec.get("node") != actor.name \
                    or post_state != "owned":
                out.append(Violation(
                    "hb-foreign-write",
                    f"heartbeat by {actor.name} rewrote the record "
                    f"of {qid}, which names "
                    f"{post_rec.get('node')!r} ({post_state})",
                    {"query": qid, "record": post_rec}))
            continue

        if post_state == "offered":
            if kind != "reb":
                out.append(Violation(
                    "offer-outside-rebalance",
                    f"{kind} by {actor.name} wrote an offered record "
                    f"for {qid}; only the rebalance stage offers",
                    {"query": qid, "record": post_rec}))
                continue
            if post_rec.get("src") != actor.name:
                out.append(Violation(
                    "offer-foreign-src",
                    f"rebalance by {actor.name} wrote an offer for "
                    f"{qid} with src {post_rec.get('src')!r}",
                    {"query": qid, "record": post_rec}))
            if qid in actor.running:
                # "the local task is dead before the offer is
                # visible" — otherwise the offer target and the
                # offerer are two live owners for a whole lease
                out.append(Violation(
                    "offer-live-task",
                    f"rebalance by {actor.name} offered {qid} away "
                    f"while still running it locally",
                    {"query": qid}))
            continue

        # owned post-record: a refresh of the actor's own ownership
        # is free; anything else is a SEIZURE and must come through a
        # sanctioned door
        if post_rec.get("node") != actor.name:
            out.append(Violation(
                "foreign-owner-write",
                f"{kind} by {actor.name} wrote an owned record for "
                f"{qid} naming {post_rec.get('node')!r}",
                {"query": qid, "record": post_rec}))
            continue
        if pre_rec is not None and _owner(pre_rec) == actor.name \
                and _state(pre_rec) == "owned":
            continue  # refresh / re-claim of an already-owned record
        if pre_rec is None:
            continue  # recordless claim (boot or live): sanctioned
        if _state(pre_rec) == "offered" \
                and pre_rec.get("node") == actor.name:
            continue  # the offer explicitly named this node
        if "hb_ms" not in pre_rec:
            # legacy record: the owner may be alive RIGHT NOW and
            # will never heartbeat — only a boot (fresh epoch over a
            # genuinely dead predecessor) may apply the epoch rule
            if kind != "reboot":
                out.append(Violation(
                    "seizure-legacy-live",
                    f"{kind} by {actor.name} seized the legacy "
                    f"record of {qid} from "
                    f"{pre_rec.get('node')!r}; the live sweep must "
                    f"never apply the epoch rule to legacy records",
                    {"query": qid, "prev": pre_rec}))
            elif int(pre_rec.get("epoch", 0)) >= actor.ctx.boot_epoch:
                out.append(Violation(
                    "seizure-epoch",
                    f"reboot of {actor.name} (epoch "
                    f"{actor.ctx.boot_epoch}) seized {qid} from an "
                    f"equal-or-newer epoch "
                    f"{pre_rec.get('epoch')}",
                    {"query": qid, "prev": pre_rec}))
            continue
        # heartbeated record: legal only once the TRUE stamp age has
        # lapsed the effective lease, discounted by the worst skew
        # spread (an observed lapse can under-read true age by at
        # most the spread)
        writer, stamp_true_ms = model.truth.get(qid, (None, 0))
        true_age = model.clock.true_ms - stamp_true_ms
        if true_age <= lease - spread:
            out.append(Violation(
                "seizure-fresh-lease",
                f"{kind} by {actor.name} seized {qid} from "
                f"{pre_rec.get('node')!r} ({_state(pre_rec)}) at true "
                f"heartbeat age {true_age}ms <= effective lease "
                f"{lease}ms - skew spread {spread}ms",
                {"query": qid, "prev": pre_rec, "true_age_ms": true_age,
                 "effective_lease_ms": lease, "skew_spread_ms": spread}))

    if kind == "hb":
        # fence post-condition: after a heartbeat pass every local
        # task is backed by an owned record naming this node — a
        # definitive heartbeat failure must have self-fenced
        for qid in sorted(actor.running):
            rec = post.get(qid, (None, None))[1]
            if rec is None or rec.get("node") != actor.name \
                    or rec.get("state", "owned") != "owned":
                out.append(Violation(
                    "fence-post",
                    f"after heartbeat, {actor.name} still runs {qid} "
                    f"but the record "
                    f"{'is gone' if rec is None else 'names ' + repr(rec.get('node'))}"
                    f" — the loser did not self-fence",
                    {"query": qid, "record": rec}))
    return out


def check_state(model) -> list[Violation]:
    """Invariants of every reachable state."""
    out: list[Violation] = []
    records = model.sched_records()
    epochs = [n.ctx.boot_epoch for n in model.nodes]
    if len(set(epochs)) != len(epochs):  # pragma: no cover — model bug
        out.append(Violation("epoch-collision",
                             f"duplicate boot epochs {epochs}", {}))
    max_epoch = max(epochs)
    for qid, (_raw, rec) in sorted(records.items()):
        if not isinstance(rec, dict):
            out.append(Violation(
                "record-shape",
                f"record of {qid} is not valid JSON", {"query": qid}))
            continue
        state = rec.get("state", "owned")
        owner_idx = model.name_to_idx.get(rec.get("node"))
        if owner_idx is None or state not in ("owned", "offered") \
                or not isinstance(rec.get("epoch"), int) \
                or int(rec.get("epoch", 0)) > max_epoch:
            out.append(Violation(
                "record-shape",
                f"malformed record for {qid}: {rec}",
                {"query": qid, "record": rec}))
            continue
        if state == "offered" and ("src" not in rec
                                   or "hb_ms" not in rec):
            out.append(Violation(
                "offer-shape",
                f"offered record for {qid} lacks src/hb_ms: {rec} — "
                f"an offer without a fresh heartbeat is instantly "
                f"seizable by any node",
                {"query": qid, "record": rec}))
            continue
        if state == "owned":
            owner = model.nodes[owner_idx]
            if not owner.armed and "hb_ms" in rec:
                out.append(Violation(
                    "disarmed-stamp",
                    f"record of {qid} is owned by disarmed "
                    f"{owner.name} but carries hb_ms — the stamp can "
                    f"never refresh and reads as a lapsed lease to "
                    f"every armed peer",
                    {"query": qid, "record": rec}))
    for n in model.nodes:
        if not n.alive:
            continue
        for qid in sorted(n.running):
            rec = records.get(qid, (None, None))[1]
            granted = (isinstance(rec, dict)
                       and rec.get("node") == n.name
                       and rec.get("state", "owned") == "owned")
            if not granted and not n.armed:
                # an armed zombie self-fences on its next heartbeat
                # tick; a disarmed one never ticks — a permanent
                # second live owner
                out.append(Violation(
                    "zombie-disarmed",
                    f"disarmed {n.name} runs {qid} but the record "
                    f"{'is gone' if rec is None else 'names ' + repr(_owner(rec))}"
                    f"; it can never self-fence",
                    {"query": qid, "node": n.name, "record": rec}))
    return out


def check_convergence(model) -> list[Violation]:
    """Asserted after ``Model.stabilize``: ownership has quiesced."""
    out: list[Violation] = []
    records = model.sched_records()
    alive_armed = any(n.alive and n.armed for n in model.nodes)
    if not alive_armed:
        return out
    runners: dict[str, list[str]] = {}
    for n in model.nodes:
        if not n.alive:
            continue
        for qid in n.running:
            runners.setdefault(qid, []).append(n.name)
    for info in model.persistence.get_queries():
        qid = info.query_id
        if info.status not in (TaskStatus.RUNNING, TaskStatus.CREATED):
            continue
        rec = records.get(qid, (None, None))[1]
        who = sorted(runners.get(qid, []))
        if rec is None:
            if info.status == TaskStatus.CREATED:
                continue  # recordless CREATED: boot-rescue only (the
                # creator is mid-write; documented model boundary)
            out.append(Violation(
                "convergence-unowned",
                f"{qid} (RUNNING) has no owner record after "
                f"stabilization with live armed nodes present",
                {"query": qid}))
            continue
        if not isinstance(rec, dict):
            continue  # record-shape already flagged
        if "hb_ms" not in rec:
            owner_idx = model.name_to_idx.get(rec.get("node"))
            owner = (model.nodes[owner_idx]
                     if owner_idx is not None else None)
            if owner is None or not owner.alive:
                continue  # dead legacy owner: boot-time adoption is
                # the rescue path for legacy records (by design)
            if who != [owner.name]:
                out.append(Violation(
                    "convergence-legacy",
                    f"{qid} is owned by live disarmed {owner.name} "
                    f"but runs on {who}",
                    {"query": qid, "runners": who}))
            continue
        if rec.get("state", "owned") == "offered":
            out.append(Violation(
                "convergence-offer",
                f"the offer of {qid} to {rec.get('node')!r} never "
                f"resolved: offered records must converge",
                {"query": qid, "record": rec}))
            continue
        owner_idx = model.name_to_idx.get(rec.get("node"))
        owner = model.nodes[owner_idx] if owner_idx is not None else None
        if owner is None or not owner.alive \
                or qid not in owner.running:
            out.append(Violation(
                "convergence-unowned",
                f"{qid} is recorded to {rec.get('node')!r} but "
                f"{'that node is dead' if owner is None or not owner.alive else 'it does not run the task'}"
                f" after stabilization",
                {"query": qid, "record": rec, "runners": who}))
            continue
        if who != [owner.name]:
            out.append(Violation(
                "convergence-two-owners",
                f"{qid} runs on {who} but the record grants only "
                f"{owner.name} — a second live owner survived "
                f"stabilization",
                {"query": qid, "runners": who}))
    for n in model.nodes:
        if not n.alive:
            continue
        for qid in sorted(n.running):
            rec = records.get(qid, (None, None))[1]
            if not (isinstance(rec, dict) and rec.get("node") == n.name
                    and rec.get("state", "owned") == "owned"):
                out.append(Violation(
                    "convergence-zombie",
                    f"{n.name} still runs {qid} without a granting "
                    f"record after stabilization",
                    {"query": qid, "node": n.name, "record": rec}))
    return out
