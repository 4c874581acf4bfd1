"""Guards of the PyTorch/CUDA port (hstream_tpu_torch).

The port imports torch and numpy, never jax and nothing of hstream_tpu
(whose modules it keeps its own copies of), and it runs on the card
unless the caller asks for the CPU: without a card, an entry point that
was not given device="cpu" raises instead of carrying on on the CPU.
Plan features whose port has not landed raise NotPortedError naming
their ROADMAP item; the ones that landed give the JAX executor's rows,
and a session window is refused by QueryExecutor as the reference
refuses it (SessionExecutor runs it).
"""

from __future__ import annotations

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from hstream_tpu_torch.common.errors import (
    DeviceUnavailable,
    NotPortedError,
    SQLCodegenError,
)
from hstream_tpu_torch import device as devmod
from hstream_tpu_torch.engine import (
    AggKind,
    AggregateNode,
    AggSpec,
    ColumnType,
    QueryExecutor,
    Schema,
    SessionExecutor,
    SessionWindow,
    SourceNode,
    TumblingWindow,
)
from hstream_tpu_torch.engine.expr import Col
from torch_parity import BASE, drive, pair

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "hstream_tpu_torch"
SCHEMA = Schema.of(device=ColumnType.STRING, temp=ColumnType.FLOAT)


def _forbidden(name: str) -> bool:
    """jax, the JAX package, and the repo's top-level `tools` package
    (the reference's checkers, which import the JAX package)."""
    return any(name == top or name.startswith(top + ".")
               for top in ("jax", "hstream_tpu", "tools"))


def test_port_imports_with_jax_blocked_and_loads_no_jax_package_module():
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['tools'] = None\n"
        "import hstream_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    hstream_tpu_torch.__path__, 'hstream_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(n for n in sys.modules if n == 'hstream_tpu'\n"
        "             or n.startswith(('hstream_tpu.', 'tools.')))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15  # every module of the slice


SOURCES = sorted([p for p in PKG.rglob("*.py")] + [REPO / "chip_smoke.py"])


def test_the_source_guard_covers_every_slice():
    """The import guard below reads every module of the port, the SQL
    front end, the snapshots, the join slice, the log substrate
    (records, proto, decoders, store) and the sharded lattice
    (parallel/) among them."""
    names = {str(p.relative_to(REPO)) for p in SOURCES}
    for want in ("hstream_tpu_torch/common/logger.py",
                 "hstream_tpu_torch/common/faultinject.py",
                 "hstream_tpu_torch/common/records.py",
                 "hstream_tpu_torch/common/idgen.py",
                 "hstream_tpu_torch/common/colframe.py",
                 "hstream_tpu_torch/common/columnar.py",
                 "hstream_tpu_torch/common/jsondec.py",
                 "hstream_tpu_torch/common/nativebuild.py",
                 "hstream_tpu_torch/proto/__init__.py",
                 "hstream_tpu_torch/proto/api_pb2.py",
                 "hstream_tpu_torch/store/__init__.py",
                 "hstream_tpu_torch/store/api.py",
                 "hstream_tpu_torch/store/memstore.py",
                 "hstream_tpu_torch/store/streams.py",
                 "hstream_tpu_torch/store/checkpoint.py",
                 "hstream_tpu_torch/store/build.py",
                 "hstream_tpu_torch/store/native.py",
                 "hstream_tpu_torch/store/versioned.py",
                 "hstream_tpu_torch/store/dedup.py",
                 "hstream_tpu_torch/sql/ast.py",
                 "hstream_tpu_torch/sql/plans.py",
                 "hstream_tpu_torch/sql/codegen.py",
                 "hstream_tpu_torch/sql/__init__.py",
                 "hstream_tpu_torch/sql/lexer.py",
                 "hstream_tpu_torch/sql/parser.py",
                 "hstream_tpu_torch/sql/refine.py",
                 "hstream_tpu_torch/engine/snapshot.py",
                 "hstream_tpu_torch/engine/join.py",
                 "hstream_tpu_torch/engine/join_lattice.py",
                 "hstream_tpu_torch/engine/session.py",
                 "hstream_tpu_torch/parallel/__init__.py",
                 "hstream_tpu_torch/parallel/lattice.py",
                 "hstream_tpu_torch/parallel/executor.py",
                 "hstream_tpu_torch/store/replica.py",
                 "hstream_tpu_torch/connectors/__init__.py",
                 "hstream_tpu_torch/admin/__init__.py",
                 "hstream_tpu_torch/admin/__main__.py",
                 "hstream_tpu_torch/http_gateway/__init__.py",
                 "hstream_tpu_torch/http_gateway/__main__.py",
                 "hstream_tpu_torch/client/__init__.py",
                 "hstream_tpu_torch/client/__main__.py",
                 "hstream_tpu_torch/tools/analyze/__init__.py",
                 "hstream_tpu_torch/tools/analyze/__main__.py",
                 "hstream_tpu_torch/tools/analyze/passes/dispatch.py",
                 "hstream_tpu_torch/tools/protocheck/__init__.py",
                 "hstream_tpu_torch/tools/protocheck/__main__.py",
                 "hstream_tpu_torch/tools/protocheck/model.py",
                 "hstream_tpu_torch/tools/protocheck/mutants.py",
                 "hstream_tpu_torch/tools/protocheck/replica_model.py",
                 "chip_smoke.py"):
        assert want in names, want


ENTRY_POINTS = ["hstream_tpu_torch.store.replica", "hstream_tpu_torch.admin",
                "hstream_tpu_torch.http_gateway", "hstream_tpu_torch.client",
                "hstream_tpu_torch.server.main",
                "hstream_tpu_torch.tools.analyze",
                "hstream_tpu_torch.tools.protocheck"]


@pytest.mark.parametrize("module", ENTRY_POINTS)
def test_entry_point_help_runs_with_jax_blocked(module):
    """`python -m <module> --help` where importing jax, hstream_tpu or
    the top-level tools fails: the operator entry points and the port's
    checkers need none of them."""
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['hstream_tpu'] = None\n"
            "sys.modules['tools'] = None\n"
            f"sys.argv = [{module!r}, '--help']\n"
            f"runpy.run_module({module!r}, run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "usage:" in out.stdout, out.stdout


def test_no_not_ported_error_names_a5c():
    """The operator surfaces and replication (ROADMAP A5c) are ported: no
    module of the port raises NotPortedError naming that item."""
    for path in PKG.rglob("*.py"):
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", "") == "NotPortedError"):
                args = [a.value for a in node.args
                        if isinstance(a, ast.Constant)]
                assert "A5c" not in args, path


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_jax_package_import_in_source(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def _node(aggs, child=None, window=TumblingWindow(10_000, grace_ms=0)):
    return AggregateNode(child=child or SourceNode("s", SCHEMA),
                         group_keys=[Col("device")], window=window,
                         aggs=aggs)


COUNT = AggSpec(AggKind.COUNT_ALL, "cnt")


def test_executor_without_a_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable, match="device='cpu'"):
        QueryExecutor(_node([COUNT]), SCHEMA)
    with pytest.raises(DeviceUnavailable):
        QueryExecutor(_node([COUNT]), SCHEMA, device="cuda")
    with pytest.raises(DeviceUnavailable):
        devmod.resolve()
    ex = QueryExecutor(_node([COUNT]), SCHEMA, device="cpu")
    assert ex.device.type == "cpu"
    assert all(v.device.type == "cpu" for v in ex.state.values())


def _recipe(aggs, where=False):
    """A plan over (device, temp), in either package's namespace."""
    def recipe(m):
        schema = m.Schema.of(device=m.ColumnType.STRING,
                             temp=m.ColumnType.FLOAT)
        child = m.SourceNode("s", schema)
        if where:
            child = m.FilterNode(child, m.BinOp(">", m.Col("temp"),
                                                m.Lit(0.0)))
        return m.AggregateNode(
            child=child, group_keys=[m.Col("device")],
            window=m.TumblingWindow(10_000, grace_ms=0),
            aggs=aggs(m)), schema
    return recipe


def _seeded_rows(seed: int):
    """Three row batches over four keys, the last closing the first
    window; temps from a numpy seed, some negative, some missing."""
    rng = np.random.default_rng(seed)
    out = []
    for b, off in enumerate((0, 4_000, 12_000)):
        n = 40
        temps = np.rint(rng.normal(3, 4, n) * 10) / 10
        rows = [{"device": f"d{rng.integers(0, 4)}", "temp": float(t)}
                for t in temps]
        for r in rows[::9]:
            del r["temp"]
        out.append((rows, [BASE + off + 50 * i for i in range(n)]))
    return out


_FEATURES = {
    "count_col": (_recipe(lambda m: [m.AggSpec(m.AggKind.COUNT, "c",
                                               input=m.Col("temp"))]), {}),
    "quantile": (_recipe(lambda m: [m.AggSpec(
        m.AggKind.APPROX_QUANTILE, "q", input=m.Col("temp"),
        quantile=0.5)]), {}),
    "topk": (_recipe(lambda m: [m.AggSpec(m.AggKind.TOPK, "t",
                                          input=m.Col("temp"), k=3)]), {}),
    "topk_distinct": (_recipe(lambda m: [m.AggSpec(
        m.AggKind.TOPK_DISTINCT, "t", input=m.Col("temp"), k=3)]), {}),
    "computed_input": (_recipe(lambda m: [m.AggSpec(
        m.AggKind.SUM, "s", input=m.BinOp("*", m.Col("temp"),
                                          m.Lit(2.0)))]), {}),
    "where": (_recipe(lambda m: [m.AggSpec(m.AggKind.COUNT_ALL, "cnt")],
                      where=True), {}),
    "emit_changes": (_recipe(lambda m: [m.AggSpec(m.AggKind.COUNT_ALL,
                                                  "cnt")]),
                     {"emit_changes": True}),
}


@pytest.mark.parametrize("feature", list(_FEATURES))
def test_unported_plan_features_name_their_roadmap_item(feature):
    """The plan features ROADMAP A6 carried (once refused with
    NotPortedError naming A6) now build on device="cpu" and give the JAX
    executor's rows on a small seeded input (close-only unless the case
    is EMIT CHANGES itself; tolerances: tests/torch_parity.py)."""
    recipe, kw = _FEATURES[feature]
    mode = "changes" if kw.get("emit_changes") else "close"
    jex, tex = pair(recipe, mode)
    assert tex.device.type == "cpu"
    rows = drive(jex, tex, _seeded_rows(len(feature)),
                 quantiles=("q",))
    assert rows


def test_session_windows_and_null_inputs_are_not_ported():
    """A session window is refused by QueryExecutor as the reference
    refuses it (it belongs to SessionExecutor, which builds on the CPU;
    once refused with NotPortedError naming A7); NULL aggregate inputs,
    once refused (A6), now match the JAX executor's rows."""
    node = _node([COUNT], window=SessionWindow(5_000))
    with pytest.raises(SQLCodegenError,
                       match="session windows use SessionExecutor") as err:
        QueryExecutor(node, SCHEMA, device="cpu")
    assert not isinstance(err.value, NotPortedError)
    sex = SessionExecutor(node, SCHEMA, device="cpu")
    assert sex.device.type == "cpu"
    assert list(sex.process([{"device": "a"}], [BASE])) == []
    jex, tex = pair(_recipe(lambda m: [m.AggSpec(
        m.AggKind.SUM, "s", input=m.Col("temp"))]))
    drive(jex, tex, [([{"device": "a"}], [BASE]),
                     ([{"device": "a", "temp": 2.5}, {"device": "b"}],
                      [BASE + 10, BASE + 20])])
