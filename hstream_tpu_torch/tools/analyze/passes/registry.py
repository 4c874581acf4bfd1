"""Registry pass: the observability registries match their call sites
(the reference's tools/metrics_lint.py, X-macro discipline, absorbed).

The reference gets this for free: a metric exists iff its `.inc` line
compiles. Python defers the mistake to runtime (a KeyError on a cold
path, or a histogram nobody ever looks for), so the pass restores the
compile-time property in both directions:

  registry-unknown  a `stream_stat_add` / `time_series_add` /
                    `gauge_set` / `gauge_fn` / `observe` /
                    `events.append(kind, ...)` call site whose metric
                    argument is a string literal names a metric absent
                    from the registries (hstream_tpu_torch/stats);
  registry-dead     a registered metric / event kind is referenced by
                    no call site anywhere in production code — dead
                    registry entries rot dashboards (this is how the
                    dead `append_failed` counter was found).

Dynamic call sites (metric passed as a variable) are skipped — those
hit the registries' own KeyError at runtime. Literal mentions inside
the registry/exposition modules and the port's tools give no liveness
credit.
"""

from __future__ import annotations

import ast
import sys

from hstream_tpu_torch.tools.analyze import Finding

NAME = "registry"

RULES = {
    "registry-unknown": (
        "metric/event call site names a string literal absent from "
        "the stats registries — a typo that would KeyError on a cold "
        "path"),
    "registry-dead": (
        "registered metric/event kind referenced by no production "
        "call site — a dead registry entry"),
    "registry-stage": (
        "trace-span stage / kernel-family literal absent from the "
        "declared sets (tracing.TRACE_STAGES / KERNEL_FAMILIES) — a "
        "renamed stage silently orphans its histogram series and its "
        "spans"),
    "registry-family": (
        "stat_add/stat_rate/... call site names a stat family absent "
        "from the declared table (stats/families.STAT_FAMILIES) — the "
        "X-macro property: a family exists iff its table row does, so "
        "an undeclared name would KeyError on a cold path and never "
        "reach the admin/exposition/federation surfaces"),
}

COUNTER_CALLS = {"stream_stat_add", "stream_stat_get",
                 "stream_stat_getall"}
TS_CALLS = {"time_series_add", "time_series_get_rate",
            "time_series_peek_rate", "time_series_streams", "_ts"}
# the declarative-family API: same registry kind as the
# legacy time-series shims (both resolve against STAT_FAMILIES), but
# violations report under their own rule — the `.inc` discipline the
# families table exists to enforce
FAMILY_CALLS = {"stat_add", "stat_rate", "stat_sum", "stat_avg",
                "stat_count", "stat_ladder", "stat_keys",
                "_family_series", "_peek_series"}
GAUGE_CALLS = {"gauge_set", "gauge_fn", "gauge_drop", "gauge_labels"}
HIST_CALLS = {"observe", "histogram_percentile", "_hist"}

# stage/family-literal call shapes: call name -> (positional
# index of the stage literal, declared-set kind). The spans and the
# stage-labeled histogram series both key on these names, so a rename
# at one call site silently forks the series.
STAGE_ARG_CALLS = {
    "trace_span": (1, "stage"),
    "record_span": (1, "stage"),
    "_observe_append_stage": (0, "stage"),
    "_trace_stage_span": (1, "stage"),
    "kernel_family": (0, "family"),
}
# histograms whose LABEL argument is a stage name
STAGE_LABELED_HISTOGRAMS = {"stage_latency_ms", "freshness_lag_ms"}

# files whose literals do NOT count as "referenced" for the dead-entry
# check: the registries themselves, the exposition layer (HELP text
# names every metric), and tools (a metric only lint mentions is still
# dead in production)
_NO_REFERENCE_CREDIT = (
    "hstream_tpu_torch/stats/__init__.py",
    "hstream_tpu_torch/stats/events.py",
    "hstream_tpu_torch/stats/families.py",
    "hstream_tpu_torch/stats/timeseries.py",
    "hstream_tpu_torch/stats/prometheus.py",
    "hstream_tpu_torch/tools/",
)

REGISTRY_FILE = "hstream_tpu_torch/stats/__init__.py"
# the files this pass names (the framework checks the tree holds them)
# and the modules _registries imports the live registries from
PATHS = tuple(p for p in _NO_REFERENCE_CREDIT if p.endswith(".py")) + (
    "hstream_tpu_torch/common/tracing.py",)


def _registries(repo: str) -> dict[str, set[str]]:
    """Import the live registries from the tree under analysis."""
    if repo not in sys.path:
        sys.path.insert(0, repo)
    from hstream_tpu_torch.common.tracing import KERNEL_FAMILIES, TRACE_STAGES
    from hstream_tpu_torch.stats import (
        GAUGES,
        HISTOGRAMS,
        PER_STREAM_COUNTERS,
    )
    from hstream_tpu_torch.stats.events import EVENT_KINDS
    from hstream_tpu_torch.stats.families import FAMILY_NAMES

    return {
        "counter": set(PER_STREAM_COUNTERS),
        # the declarative family table: the legacy time-series shims
        # and the stat_* API both resolve against it
        "time_series": set(FAMILY_NAMES),
        "gauge": set(GAUGES),
        "histogram": {name for name, _b, _l in HISTOGRAMS},
        "event": set(EVENT_KINDS),
        # stage/family vocabularies are checked in the UNKNOWN
        # direction only: their names are common words, so a literal
        # scan cannot prove deadness
        "stage": set(TRACE_STAGES),
        "family": set(KERNEL_FAMILIES),
    }


_CALL_KIND: dict[str, str] = {}
for _n in COUNTER_CALLS:
    _CALL_KIND[_n] = "counter"
for _n in TS_CALLS:
    _CALL_KIND[_n] = "time_series"
for _n in FAMILY_CALLS:
    _CALL_KIND[_n] = "time_series"
for _n in GAUGE_CALLS:
    _CALL_KIND[_n] = "gauge"
for _n in HIST_CALLS:
    _CALL_KIND[_n] = "histogram"


def _method_name(call: ast.Call) -> str | None:
    fn = call.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def _is_events_append(call: ast.Call) -> bool:
    """`<something>.events.append(...)` / `journal.append(...)` /
    `self._journal(...)`: the event-kind call shapes used in-tree."""
    fn = call.func
    if isinstance(fn, ast.Attribute) and fn.attr == "append":
        base = fn.value
        base_name = (base.attr if isinstance(base, ast.Attribute)
                     else base.id if isinstance(base, ast.Name) else "")
        return base_name in ("events", "journal", "_events", "_ring")
    if isinstance(fn, ast.Attribute) and fn.attr == "_journal":
        return True
    return False


def run(files, repo) -> list[Finding]:
    registries = _registries(repo)
    out: list[Finding] = []
    referenced: dict[str, set[str]] = {k: set() for k in registries}
    all_names = {n for names in registries.values() for n in names}
    for src in files:
        if not src.rel.startswith(_NO_REFERENCE_CREDIT):
            # dead-entry credit: ANY literal mention in production code
            # (call sites, routing dicts like handlers._RPC_HISTOGRAMS)
            for node in ast.walk(src.tree):
                if (isinstance(node, ast.Constant)
                        and isinstance(node.value, str)
                        and node.value in all_names):
                    for kind, names in registries.items():
                        if node.value in names:
                            referenced[kind].add(node.value)
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            name = _method_name(node)
            # stage/family literals sit at varying positions; dynamic
            # names are skipped like every other registry check
            ent = STAGE_ARG_CALLS.get(name or "")
            if ent is not None:
                idx, skind = ent
                if len(node.args) > idx:
                    arg = node.args[idx]
                    if (isinstance(arg, ast.Constant)
                            and isinstance(arg.value, str)
                            and arg.value not in registries[skind]):
                        out.append(Finding(
                            "registry-stage", src.rel, node.lineno,
                            f"{name}(... {arg.value!r} ...) names an "
                            f"undeclared {skind} (tracing."
                            f"{'TRACE_STAGES' if skind == 'stage' else 'KERNEL_FAMILIES'})"))
            first = node.args[0]
            if not (isinstance(first, ast.Constant)
                    and isinstance(first.value, str)):
                continue  # dynamic name: runtime KeyError covers it
            if (name in HIST_CALLS
                    and first.value in STAGE_LABELED_HISTOGRAMS
                    and len(node.args) > 1):
                lab = node.args[1]
                if (isinstance(lab, ast.Constant)
                        and isinstance(lab.value, str)
                        and lab.value not in registries["stage"]):
                    out.append(Finding(
                        "registry-stage", src.rel, node.lineno,
                        f"{name}({first.value!r}, {lab.value!r}, ...) "
                        f"labels a stage histogram with an undeclared "
                        f"stage (tracing.TRACE_STAGES)"))
            kind = _CALL_KIND.get(name or "")
            if kind is not None:
                metric = first.value
                if metric in registries[kind]:
                    referenced[kind].add(metric)
                elif name in FAMILY_CALLS:
                    out.append(Finding(
                        "registry-family", src.rel, node.lineno,
                        f"{name}({metric!r}, ...) names a stat "
                        f"family absent from the declared table "
                        f"(stats/families.STAT_FAMILIES)"))
                else:
                    out.append(Finding(
                        "registry-unknown", src.rel, node.lineno,
                        f"{name}({metric!r}, ...) names an "
                        f"unregistered {kind} metric"))
            elif _is_events_append(node):
                event = first.value
                if event in registries["event"]:
                    referenced["event"].add(event)
                else:
                    out.append(Finding(
                        "registry-unknown", src.rel, node.lineno,
                        f"events.append({event!r}) names an "
                        f"unregistered event kind"))
    # direction 2: registered but never referenced anywhere (stage/
    # family vocabularies excluded — see _registries)
    for kind, names in sorted(registries.items()):
        if kind in ("stage", "family"):
            continue
        for name in sorted(names - referenced[kind]):
            out.append(Finding(
                "registry-dead", REGISTRY_FILE, 1,
                f"{kind} metric {name!r} is registered but never "
                f"referenced by any call site"))
    return out
