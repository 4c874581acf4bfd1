"""The port's static analysis (hstream_tpu_torch/tools/analyze).

Four groups:

* parity over the reference's own fixtures: every pass carried
  unchanged, and blocking, gives, on the same source text (paths mapped
  into the port), the same (rule, line, message) as the reference's
  pass — each case replays one fixture test of tests/test_analyze.py
  with the reference passes recorded, then runs the port's pass on what
  they saw;
* the dispatch pass's torch idioms and the retrace rules the port keeps,
  on fixtures of their own;
* the live port tree, analyzed once for the module: no finding, an empty
  baseline, no dead waiver, errcontract's and registry's tables agree,
  every file a pass names is in the loaded tree;
* contract parity: every reference function with a `# contract:` budget
  has a counterpart in the port with one, each budget that differs is
  listed here with its reason, and every budget equals what the pass
  counts on the live tree.
"""

from __future__ import annotations

import ast
import inspect
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import test_analyze as ref_tests  # noqa: E402
from tools.analyze import passes as ref_passes  # noqa: E402

from hstream_tpu_torch.tools.analyze import (  # noqa: E402
    DROPPED_RULES,
    PATH_RULE,
    SourceFile,
    all_passes,
    load_baseline,
    load_tree,
    missing_paths,
    run_passes,
)
from hstream_tpu_torch.tools.analyze.passes import (  # noqa: E402
    dispatch,
    errcontract,
    retrace,
)

PORT = "hstream_tpu_torch"


def src(rel: str, code: str) -> SourceFile:
    return SourceFile(rel, rel, textwrap.dedent(code))


def run_one(mod, files):
    """Run one pass and apply waivers like the framework does."""
    by_rel = {f.rel: f for f in files}
    return [f for f in mod.run(files, REPO)
            if not (f.path in by_rel and by_rel[f.path].waived(f.line,
                                                                 f.rule))]


def rules_of(findings) -> set[str]:
    return {f.rule for f in findings}


# ---- parity over the reference's fixtures ---------------------------------

# the passes whose fixture findings equal the reference's, with the
# prefixes of their fixture tests in tests/test_analyze.py: the eight
# carried unchanged, and blocking, repointed only in the scrape file it
# names (errcontract and registry, also repointed, read the live tree)
CARRIED = {
    "locks": ("test_lock_guard_", "test_lock_order_"),
    "lockorder": ("test_lockorder_",),
    "atomicity": ("test_atomicity_",),
    "waitholding": ("test_waitholding_",),
    "blocking": ("test_blocking_",),
    "lifecycle": ("test_lifecycle_",),
    "overflow": ("test_overflow_",),
    "casdiscipline": ("test_cas_",),
    "timeunit": ("test_timeunit_",),
}


def _fixture_tests():
    """(pass, test name) of every fixture test of a carried pass: zero
    arguments, and no run over the reference's live tree."""
    out = []
    for name, fn in sorted(vars(ref_tests).items()):
        if not (name.startswith("test_") and callable(fn)):
            continue
        if inspect.signature(fn).parameters:
            continue
        if "load_tree" in inspect.getsource(fn):
            continue  # the reference's live tree, not a fixture
        for pname, prefixes in CARRIED.items():
            if name.startswith(prefixes):
                out.append((pname, name))
    return out


FIXTURE_TESTS = _fixture_tests()


def _to_port(text: str) -> str:
    """A reference path (or a message naming one) in the port's tree."""
    text = re.sub(r"\bhstream_tpu/", f"{PORT}/", text)
    return re.sub(r"(?<![\w/])tools/", f"{PORT}/tools/", text)


def test_every_carried_pass_has_fixture_cases():
    assert {p for p, _ in FIXTURE_TESTS} == set(CARRIED)
    assert len(FIXTURE_TESTS) >= 40


@pytest.mark.parametrize("pname,test", FIXTURE_TESTS,
                         ids=[f"{p}-{t[5:]}" for p, t in FIXTURE_TESTS])
def test_carried_pass_matches_the_reference_on_its_fixture(
        monkeypatch, pname, test):
    """Replay the reference's fixture test with every carried reference
    pass recorded; the port's pass gives the same findings on each run
    it recorded."""
    import importlib

    calls = []
    made = []
    for name in CARRIED:
        mod = importlib.import_module(f"tools.analyze.passes.{name}")
        orig = mod.run

        def rec(files, repo, _orig=orig, _name=name):
            out = _orig(files, repo)
            calls.append((_name, list(files), out))
            return out

        monkeypatch.setattr(mod, "run", rec)

    class Recorded(ref_tests.SourceFile):
        def __init__(self, *args):
            super().__init__(*args)
            made.append(self)

    monkeypatch.setattr(ref_tests, "SourceFile", Recorded)
    getattr(ref_tests, test)()
    if not any(c[0] == pname for c in calls):
        # the test reached into the pass's helpers: run the whole pass
        # on each fixture file it built
        ref_mod = importlib.import_module(f"tools.analyze.passes.{pname}")
        monkeypatch.undo()
        calls = [(pname, [f], ref_mod.run([f], REPO)) for f in made]
    assert calls, f"{test} built no fixture"
    port_passes = all_passes()
    for name, files, ref_out in calls:
        port_files = [SourceFile(f.path, _to_port(f.rel), f.text)
                      for f in files]
        got = sorted((f.rule, _to_port(f.path), f.line, f.message)
                     for f in port_passes[name].run(port_files, REPO))
        want = sorted((f.rule, _to_port(f.path), f.line,
                       _to_port(f.message)) for f in ref_out)
        assert got == want, (name, test)


def test_the_reference_helpers_stay_as_the_port_copied_them():
    """The port's shared AST helpers are the reference's, line for line
    (the carried passes lean on them)."""
    from hstream_tpu_torch.tools.analyze import passes as port_passes

    for name in ("dotted", "call_name", "has_timeout", "class_methods",
                 "walk_classes"):
        assert inspect.getsource(getattr(port_passes, name)) == \
            inspect.getsource(getattr(ref_passes, name)), name


# ---- dispatch: the port's idioms ------------------------------------------

HOT = f"{PORT}/engine/executor.py"
WRAPPERS = src(f"{PORT}/engine/lattice.py", '''
import torch

from hstream_tpu_torch.engine.kernels import binding as kb


def scatter_step(spec, state, batch):
    if batch.device.type == "cpu":
        return scatter_step_ref(spec, state, batch)
    kb.check(kb.lib().hs_scatter(0, 0), "scatter")
    scatter_step.launches += 1


def close_raw(spec, state, slots):
    kb.check(kb.lib().hs_close(0, 0), "close")


def step_program(spec, state, batch):
    scatter_step(spec, state, batch)


def scatter_step_ref(spec, state, batch):
    return state


scatter_step.launches = 0
''')


def test_dispatch_cpu_fetch_in_a_contract_loop_is_flagged():
    code = '''
    class Ex:
        # contract: dispatches<=0 fetches<=1
        def drain(self):
            out = []
            for packed in self._pending:
                out.append(packed.cpu().numpy())
            return out
    '''
    out = run_one(dispatch, [src(HOT, code)])
    assert rules_of(out) == {"dispatch-budget"}
    (f,) = out
    assert "fetch inside a loop" in f.message


def test_dispatch_kernel_wrapper_call_in_a_loop_is_flagged():
    """Wrappers come from the source: one that bumps its own launch
    counter, one that checks a launch through the binding, and a device
    program calling a wrapper all count as dispatches."""
    code = '''
    from hstream_tpu_torch.engine import lattice
    from hstream_tpu_torch.engine.lattice import close_raw


    class Ex:
        # contract: dispatches<=1 fetches<=0
        def step_all(self, batches):
            for b in batches:
                lattice.scatter_step(self.spec, self.state, b)

        # contract: dispatches<=1 fetches<=0
        def two(self, b):
            lattice.step_program(self.spec, self.state, b)
            close_raw(self.spec, self.state, [0])

        # contract: dispatches<=1 fetches<=0
        def one(self, b):
            lattice.scatter_step_ref(self.spec, self.state, b)
            lattice.scatter_step(self.spec, self.state, b)
    '''
    files = [WRAPPERS, src(f"{PORT}/engine/ex.py", code)]
    wrappers = dispatch.kernel_wrappers(files)
    assert wrappers == {(f"{PORT}.engine.lattice", "scatter_step"),
                        (f"{PORT}.engine.lattice", "close_raw")}
    assert (f"{PORT}.engine.lattice", "step_program") in \
        dispatch.device_functions(files)
    out = run_one(dispatch, files)
    assert [(f.rule, f.message.split(":")[0]) for f in out] == [
        ("dispatch-budget", "step_all"), ("dispatch-budget", "two")]
    assert "dispatch inside a loop over batches" in out[0].message
    assert "2 static dispatch site(s)" in out[1].message


def test_dispatch_struct_unpack_is_not_a_kernel():
    """Calls resolve through the file's imports: a stdlib `unpack` is not
    the lattice's `unpack` wrapper."""
    wrappers = src(f"{PORT}/engine/lattice.py", '''
    def unpack(x):
        unpack.launches += 1
    ''')
    code = '''
    import struct

    class Ex:
        # contract: dispatches<=0 fetches<=0
        def parse(self, raw):
            return struct.unpack("<i", raw)
    '''
    assert run_one(dispatch, [wrappers, src(HOT, code)]) == []


def test_dispatch_bare_synchronize_in_a_hot_file_is_flagged():
    code = '''
    import torch

    class Ex:
        def settle(self):
            torch.cuda.synchronize(self.device)

        def wait(self, ev):
            ev.synchronize()
    '''
    out = run_one(dispatch, [src(HOT, code)])
    assert [(f.rule, f.line) for f in out] == [
        ("dispatch-sync", 6), ("dispatch-sync", 9)]
    # outside the hot files it is host code
    assert run_one(dispatch, [src(f"{PORT}/server/x.py", code)]) == []


def test_dispatch_contract_typo_is_flagged():
    code = '''
    class Ex:
        # contract: dispatches<=1 fetch<=1
        def f(self):
            return 1
    '''
    out = run_one(dispatch, [src(HOT, code)])
    assert [f.rule for f in out] == ["dispatch-contract-syntax"]


INLINE_HELPERS = '''
import torch

class Ex:
    # contract: dispatches<=1 fetches<=0 inline
    def _launch(self, b):
        self._step(b)

    # contract: dispatches<=0 fetches<=1 inline
    def _stage(self, ev):
        ev.synchronize()

    # contract: dispatches<=0 fetches<=1
    def _refresh(self):
        return self._n.item()
'''


@pytest.mark.parametrize("body,found", [
    # one inline launch and one inline wait fit (1, 1)
    ("self._stage(ev)\n        self._launch(b)", []),
    # a second inline launch breaks the caller's budget
    ("self._launch(b)\n        self._launch(b)",
     ["2 static dispatch site(s)"]),
    # an inline launch in a loop cannot hold any budget
    ("for x in b:\n            self._launch(x)",
     ["dispatch inside a loop over b"]),
    # a helper without `inline` carries its own budget, as in the
    # reference: calling it twice costs the caller nothing
    ("self._refresh()\n        self._refresh()\n        self._launch(b)",
     []),
])
def test_dispatch_inline_helper_counts_in_its_caller(body, found):
    code = INLINE_HELPERS + f'''
    # contract: dispatches<=1 fetches<=1
    def run(self, b, ev):
        {body}
'''
    out = run_one(dispatch, [SourceFile(HOT, HOT, code)])
    assert [f.message.split(": ", 1)[1].split(" exceed")[0].split(
        " — ")[0] for f in out] == found


def test_dispatch_inline_wait_in_an_unannotated_hot_function_is_a_sync():
    code = INLINE_HELPERS + '''
    def settle(self, ev):
        self._stage(ev)
        self._refresh()
'''
    out = run_one(dispatch, [SourceFile(HOT, HOT, code)])
    assert [(f.rule, f.line) for f in out] == [("dispatch-sync", 18)]


def test_dispatch_a_return_inside_a_with_ends_its_arm():
    """`if ...: with ...: return launch()` leaves the function: the two
    launch arms take the max, not the sum."""
    code = '''
    from hstream_tpu_torch.engine import lattice

    class Ex:
        # contract: dispatches<=1 fetches<=0
        def extract(self, b):
            if self._sharded:
                with self._scope():
                    return lattice.scatter_step(self.spec, self.state, b)
            with self._scope():
                return lattice.close_raw(self.spec, self.state, b)
    '''
    assert run_one(dispatch, [WRAPPERS, src(HOT, code)]) == []


def test_dispatch_by_shape_stacking_stays_clean():
    """The batched drain: early returns take the max, the by_shape loop
    fetches once a buffer shape, and `x.cpu().numpy()` is one copy."""
    code = '''
    import torch

    class Ex:
        # contract: dispatches<=0 fetches<=1
        def drain_closed(self):
            if not self._pending:
                return []
            if len(self._pending) == 1:
                return [self._pending[0].cpu().numpy()]
            by_shape = {}
            for starts, packed in self._pending:
                by_shape.setdefault(tuple(packed.shape), []).append(packed)
            out = []
            for group in by_shape.values():
                out.append(torch.stack(group).cpu().numpy())
            return out
    '''
    assert run_one(dispatch, [src(HOT, code)]) == []


def test_dispatch_torch_fetch_shapes_count():
    """.to("cpu"), .item(), .tolist() of a tensor made on the card, an
    event's synchronize: four fetches against a budget of one."""
    code = '''
    import torch

    class Ex:
        # contract: dispatches<=0 fetches<=1
        def f(self, ev):
            n = torch.zeros(2, device=self.device)
            a = n.to("cpu")
            b = n.sum().item()
            c = n.tolist()
            ev.synchronize()
            return a, b, c
    '''
    out = run_one(dispatch, [src(HOT, code)])
    assert [f.message for f in out] == [
        "f: 4 static fetch site(s) exceed the declared fetches<=1"]
    # .tolist() of a host array (the dict of device state holds host
    # mirrors too) is not a fetch
    host = '''
    import numpy as np

    class Ex:
        def live(self):
            return np.nonzero(self._dev["mir_live"])[0].tolist()
    '''
    assert run_one(dispatch, [src(HOT, host)]) == []


def test_dispatch_sharded_lattice_methods_are_dispatches():
    """A sharded lattice stored in the device dict and read back under
    its key: its device methods are dispatches, its plain ones are not."""
    lat = src(f"{PORT}/parallel/lattice.py", '''
    def sharded_join_evict(stores):
        sharded_join_evict.launches += 1


    class ShardedJoinLattice:
        def evict(self, stores):
            return sharded_join_evict(stores)

        def init_store(self, cap):
            return cap
    ''')
    code = '''
    from hstream_tpu_torch.parallel.lattice import ShardedJoinLattice

    class Join:
        def _activate(self):
            sjl = ShardedJoinLattice()
            self._dev = {"sjl": sjl, "cap": sjl.init_store(8)}

        # contract: dispatches<=1 fetches<=0
        def _evict(self):
            sjl = self._dev.get("sjl")
            sjl.init_store(8)
            sjl.evict(self._dev)
            sjl.evict(self._dev)
    '''
    files = [lat, src(f"{PORT}/engine/join.py", code)]
    out = run_one(dispatch, files)
    assert [f.message for f in out] == [
        "_evict: 2 static dispatch site(s) exceed the declared "
        "dispatches<=1"]


def test_dispatch_compiled_bundle_attributes_are_dispatches():
    code = '''
    from hstream_tpu_torch.engine import lattice

    class Ex:
        def _compile(self):
            fns = lattice.compiled(self.spec)
            self._extract_touched = fns.extract_touched
            self._reset = self._count_close_kernel(fns.reset_slots)

        # contract: dispatches<=1 fetches<=1
        def close(self):
            self._reset(self.state, [0])
            state, packed = self._extract_touched(self.state)
            return packed.cpu()
    '''
    out = run_one(dispatch, [src(HOT, code)])
    assert [f.message for f in out] == [
        "close: 2 static dispatch site(s) exceed the declared "
        "dispatches<=1"]


# ---- retrace: the rules the port keeps ------------------------------------


def test_retrace_uncached_compile_site_flagged():
    code = '''
    import functools
    from hstream_tpu_torch.common.tracing import compile_site

    @compile_site("a")
    def bare(spec):
        return spec

    @compile_site("b")
    @functools.lru_cache(maxsize=8)
    def cache_below(spec):
        return spec

    @functools.lru_cache(maxsize=8)
    @compile_site("c")
    def good(spec):
        return spec

    def per_call(spec):
        return compile_site("d")(lambda s: s)(spec)
    '''
    out = run_one(retrace, [src(f"{PORT}/engine/x.py", code)])
    assert [(f.rule, f.line) for f in out] == [
        ("retrace-uncached-jit", 5), ("retrace-uncached-jit", 9),
        ("retrace-uncached-jit", 20)]


def test_retrace_raw_len_shape_key_flagged():
    code = '''
    from hstream_tpu_torch.engine import lattice

    def run(spec, rows):
        return lattice.compiled(spec, None, None, len(rows), None)

    def padded(spec, rows):
        return lattice.compiled(spec, None, None,
                                round_up_pow2(len(rows)), None)
    '''
    out = run_one(retrace, [src(f"{PORT}/engine/x.py", code)])
    assert [(f.rule, f.line) for f in out] == [("retrace-shape-key", 5)]


def test_every_dropped_rule_is_listed_with_its_reason():
    """purity and shardmap are not carried, nor two of retrace's four
    rules: each reference rule is either carried or listed with why,
    under --list-rules too."""
    from tools.analyze import all_passes as ref_all

    carried = {r for m in all_passes().values() for r in m.RULES}
    reference = {r for m in ref_all().values() for r in m.RULES}
    assert reference - carried == set(DROPPED_RULES)
    assert carried <= reference
    assert not set(all_passes()) & {"purity", "shardmap"}
    r = subprocess.run(
        [sys.executable, "-m", f"{PORT}.tools.analyze", "--list-rules"],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    for rid in DROPPED_RULES:
        assert f"{rid}: not carried — " in r.stdout
    for rid in carried | {PATH_RULE, "waiver-dead"}:
        assert re.search(rf"^{re.escape(rid)}: ", r.stdout, re.M), rid


# ---- the framework --------------------------------------------------------


def test_a_missing_path_is_a_finding_not_a_silent_pass():
    """A fixture tree without the files the passes name: every named
    file is an analyze-path finding."""
    files = [src(f"{PORT}/m.py", "x = 1\n")]
    out, rules = run_passes(files)
    named = {p for m in all_passes().values()
             for p in getattr(m, "PATHS", ())}
    missing = [f for f in out if f.rule == PATH_RULE]
    assert {f.message.split(" names ")[1].split(",")[0]
            for f in missing} == named
    assert all(f.path.startswith(f"{PORT}/tools/analyze/passes/")
               for f in missing)
    assert PATH_RULE in rules


def test_scan_roots_and_skips():
    from hstream_tpu_torch.tools.analyze import SCAN_ROOTS, _skipped

    assert SCAN_ROOTS == (PORT, "chip_smoke.py", "ab.py")
    assert _skipped(f"{PORT}/proto/api_pb2.py")
    assert _skipped(f"{PORT}/tools/analyze/passes/locks.py")
    assert _skipped(f"{PORT}/engine/kernels/_build/x.py")
    assert _skipped(f"{PORT}/x/__pycache__/y.py")
    # whole components, not substrings
    assert not _skipped(f"{PORT}/protocol.py")
    assert not _skipped(f"{PORT}/tools/protocheck/model.py")


def test_dead_waiver_and_comment_line_waiver():
    code = '''
    def f(now_ms, timeout_s, x_ms, y_ms):
        a = now_ms + timeout_s  # analyze: ok timeunit-mix
        b = x_ms + y_ms         # analyze: ok timeunit-mix
        # analyze: ok timeunit-mix
        c = now_ms + timeout_s
        return a + b + c
    '''
    out, _ = run_passes([src("m.py", code)], only=["timeunit"])
    assert [(f.rule, f.line) for f in out] == [("waiver-dead", 4)]


def test_cli_json_on_a_mini_tree(tmp_path):
    mini = tmp_path / "mini"
    (mini / PORT).mkdir(parents=True)
    (mini / PORT / "box.py").write_text(textwrap.dedent(
        ref_tests.LOCKED_CLASS.format(waiver="")))
    base = str(tmp_path / "b.json")
    cmd = [sys.executable, "-m", f"{PORT}.tools.analyze", "--only",
           "locks", "--repo", str(mini), "--baseline", base, "--json"]
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                       timeout=120)
    assert r.returncode == 1, r.stderr
    (rec,) = json.loads(r.stdout)
    assert (rec["pass"], rec["rule"], rec["path"]) == \
        ("locks", "lock-guard", f"{PORT}/box.py")
    (mini / PORT / "box.py").write_text("x = 1\n")
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                       timeout=120)
    assert r.returncode == 0 and json.loads(r.stdout) == []


# ---- the live port tree, analyzed once ------------------------------------


@pytest.fixture(scope="module")
def live():
    files = load_tree()
    findings, rules = run_passes(files)
    return files, findings


def test_live_port_tree_runs_clean(live):
    _files, findings = live
    assert [str(f) for f in findings] == []
    path = os.path.join(REPO, PORT, "tools", "analyze", "baseline.json")
    with open(path, encoding="utf-8") as f:
        assert json.load(f) == []
    assert load_baseline(path) == set()


def test_live_port_tree_scans_the_port_and_its_drivers(live):
    files, _ = live
    rels = {f.rel for f in files}
    assert "chip_smoke.py" in rels and "ab.py" in rels
    assert f"{PORT}/engine/executor.py" in rels
    assert f"{PORT}/tools/protocheck/model.py" in rels
    assert not any(r.startswith(("hstream_tpu/", "tools/")) for r in rels)
    assert not any(r.startswith(f"{PORT}/proto/") for r in rels)


def test_live_port_tree_has_no_dead_waiver(live):
    files, findings = live
    assert [f for f in findings if f.rule == "waiver-dead"] == []
    assert sum(len(f.waivers) for f in files) > 0


def test_live_registry_is_clean(live):
    _files, findings = live
    assert [f for f in findings if f.rule.startswith("registry")] == []


def test_every_path_a_pass_names_is_in_the_loaded_tree(live):
    files, _ = live
    rels = {f.rel for f in files}
    passes = all_passes()
    assert missing_paths(files, passes) == []
    for name, mod in passes.items():
        # every path-like literal of the pass's source, not only PATHS
        tree = ast.parse(inspect.getsource(mod))
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)
                    and node.value.startswith(f"{PORT}/")
                    and node.value.endswith(".py")):
                assert node.value in rels, (name, node.value)
                assert node.value in mod.PATHS, (name, node.value)


def test_errcontract_tables_agree_on_the_live_port(live):
    """Every status the port's server can emit has an HTTP mapping and a
    retry class, and every retried status is emitted or transport-made."""
    import grpc

    from hstream_tpu_torch.client import retry as retry_mod
    from hstream_tpu_torch.http_gateway import _STATUS

    files, _ = live
    by_rel = {f.rel: f for f in files}
    classes = errcontract._error_classes(
        by_rel[errcontract.ERRORS_FILE].tree)
    emitted = set(errcontract._emitted(files, classes))
    assert {"RESOURCE_EXHAUSTED", "NOT_FOUND", "UNAVAILABLE",
            "UNIMPLEMENTED"} <= emitted
    http = {c.name for c in _STATUS}
    retryable = {c.name for c in retry_mod.RETRYABLE_CODES}
    non_retryable = {c.name for c in retry_mod.NON_RETRYABLE_CODES}
    assert emitted <= http
    assert emitted <= (retryable | non_retryable)
    assert retryable <= emitted | errcontract.TRANSPORT_CODES
    assert not (retryable & non_retryable)
    hinted = {c.name for c in retry_mod.HINTED_RETRYABLE_CODES}
    assert hinted <= non_retryable
    assert grpc.StatusCode.UNAVAILABLE in retry_mod.HINTED_RETRYABLE_CODES
    assert _STATUS[grpc.StatusCode.UNIMPLEMENTED] == 501


def test_every_launch_counter_names_a_recognised_wrapper(live):
    """Each wrapper with a launch counter (`f.launches = 0` at module
    level) is a dispatch to the pass, so the derived set cannot miss a
    kernel a later slice adds."""
    files, _ = live
    wrappers = dispatch.kernel_wrappers(files)
    counters = set()
    for f in files:
        if not f.rel.startswith(f"{PORT}/") or "/tools/" in f.rel:
            continue
        mod = f.rel[:-3].replace("/", ".")
        for node in f.tree.body:
            if (isinstance(node, ast.Assign)
                    and isinstance(node.targets[0], ast.Attribute)
                    and node.targets[0].attr == "launches"
                    and isinstance(node.targets[0].value, ast.Name)):
                counters.add((mod, node.targets[0].value.id))
    assert len(counters) >= 30
    assert counters <= wrappers, sorted(counters - wrappers)


# ---- contract parity -------------------------------------------------------

_CONTRACT_RE = re.compile(r"#\s*contract:\s*(.+)$")

# budgets of the port that differ from the reference's, with why
DIFFERENT_BUDGETS = {
    ("stats/devicecost.py", "DeviceTimeSampler", "fence"):
        "the port's fence records a timing event behind the queued work "
        "instead of blocking on it; the sample's one wait is measure's",
    ("engine/executor.py", "QueryExecutor", "_run_step"):
        "the pinned upload on the copy stream (_device_stage) may wait "
        "on the oldest upload still in flight; the reference's "
        "device_put waits on nothing",
    ("engine/executor.py", "QueryExecutor", "stage_columnar"):
        "the same staging wait, on the encode worker",
    ("engine/session.py", "SessionExecutor", "_process_device"):
        "the same staging wait (_upload_packed), and a plan with computed "
        "inputs launches the expression kernel ahead of the session "
        "step, where the reference's one program ran both",
}

# contracts whose budget no site of their own reaches, with why
CROSS_OBJECT = {
    ("server/readcache.py", "serve_view"):
        "the one extract runs in the executor's snapshot_parts (another "
        "object's method), as in the reference; the budget documents "
        "the cache's read contract",
}


def _contracts(package: str) -> dict[tuple, str]:
    """(file under the package, class, function) -> budget text."""
    out: dict[tuple, str] = {}
    root = os.path.join(REPO, package)
    for dirpath, _dirs, names in os.walk(root):
        if "tools" in os.path.relpath(dirpath, root).split(os.sep):
            continue
        for n in names:
            if not n.endswith(".py"):
                continue
            path = os.path.join(dirpath, n)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            with open(path, encoding="utf-8") as f:
                text = f.read()
            lines = text.splitlines()
            sf = SourceFile(path, rel, text)

            def visit(node, cls):
                for ch in ast.iter_child_nodes(node):
                    if isinstance(ch, ast.ClassDef):
                        visit(ch, ch.name)
                    elif isinstance(ch, ast.FunctionDef):
                        budgets, line = dispatch._contract_of(sf, ch)
                        if line is not None:
                            m = _CONTRACT_RE.search(lines[line - 1])
                            out[(rel, cls, ch.name)] = m.group(1).strip()
                        visit(ch, cls)

            visit(sf.tree, None)
    return out


def test_every_reference_contract_has_a_port_counterpart():
    ref = _contracts("hstream_tpu")
    port = _contracts(PORT)
    assert len(ref) == 52
    missing = sorted(k for k in ref if k not in port)
    assert missing == []
    differ = {k for k in ref if port[k] != ref[k]}
    assert differ == set(DIFFERENT_BUDGETS)
    # the port's own contracts beside them
    extra = sorted(k for k in port if k not in ref)
    assert ("engine/executor.py", "QueryExecutor", "_launch_step") in extra
    assert ("engine/executor.py", "QueryExecutor", "_device_stage") in extra


def test_the_ported_dispatch_pass_checks_every_port_contract(live):
    """Every port contract parses and is budget-checked by the pass (in
    any file, not only the hot ones); the live run found no violation."""
    files, findings = live
    assert [f for f in findings if f.rule.startswith("dispatch")] == []
    port = _contracts(PORT)
    assert len(port) >= 52
    checked = set()
    for f in files:
        if not f.rel.startswith(f"{PORT}/"):
            continue
        for node in ast.walk(f.tree):
            if isinstance(node, ast.FunctionDef):
                budgets, line = dispatch._contract_of(f, node)
                if line is not None:
                    assert budgets is not None, (f.rel, node.name)
                    checked.add((f.rel[len(PORT) + 1:], node.name))
    assert {(k[0], k[2]) for k in port} <= checked


def test_every_port_contract_binds_its_budget(live):
    """The pass reaches each budget: the dispatches and fetches it counts
    in every contract function equal the declared ones, so a budget
    that matched nothing in the real tree cannot pass unseen."""
    files, _ = live
    sites = dispatch.contract_sites(files)
    port = _contracts(PORT)
    loose = {}
    for (rel, _cls, name), text in port.items():
        budgets = dispatch._parse_contract(text)
        want = (budgets.get("dispatches", 0), budgets.get("fetches", 0))
        got = sites[(f"{PORT}/{rel}", name)]
        if got != want:
            loose[(rel, name)] = (got, want)
    assert set(loose) == set(CROSS_OBJECT), loose
    assert sites[(f"{PORT}/engine/executor.py", "_close_windows")] == (1, 1)
    assert sites[(f"{PORT}/engine/executor.py", "_process_staged")] == (1, 0)
    assert sites[(f"{PORT}/engine/executor.py", "_run_step")] == (1, 1)


def _executor_with(live, old: str, new: str) -> list[SourceFile]:
    files, _ = live
    (ex,) = [f for f in files if f.rel == f"{PORT}/engine/executor.py"]
    assert ex.text.count(old) == 1
    return [SourceFile(ex.path, ex.rel, ex.text.replace(old, new))]


_STAGED_LAUNCH = """\
        self._launch_step(staged.combo, staged.bases, staged.words,
                          staged.ready, staged.n, wm_rel)
"""


@pytest.mark.parametrize("new,found", [
    (_STAGED_LAUNCH * 2, "_process_staged: 2 static dispatch site(s)"),
    ("        for _ in range(2):\n    "
     + _STAGED_LAUNCH.replace("\n ", "\n     "),
     "_process_staged: dispatch inside a loop over range(2)"),
])
def test_a_second_step_launch_in_process_staged_is_flagged(live, new, found):
    """The live executor with `_process_staged` launching its step twice,
    or in a loop: the restored budget catches both."""
    files = _executor_with(live, _STAGED_LAUNCH, new)
    out = run_one(dispatch, files)
    assert [f.message.split(" exceed")[0].split(" — ")[0]
            for f in out] == [found]

