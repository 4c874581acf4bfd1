"""Guards of the PyTorch/CUDA port (hstream_tpu_torch).

The port imports torch and numpy, never jax and nothing of hstream_tpu
(whose modules it keeps its own copies of), and it runs on the card
unless the caller asks for the CPU: without a card, an entry point that
was not given device="cpu" raises instead of carrying on on the CPU.
Plan features whose port has not landed raise NotPortedError naming
their ROADMAP item.
"""

from __future__ import annotations

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from hstream_tpu_torch.common.errors import DeviceUnavailable, NotPortedError
from hstream_tpu_torch import device as devmod
from hstream_tpu_torch.engine import (
    AggKind,
    AggregateNode,
    AggSpec,
    ColumnType,
    FilterNode,
    QueryExecutor,
    Schema,
    SessionWindow,
    SourceNode,
    TumblingWindow,
)
from hstream_tpu_torch.engine.expr import BinOp, Col, Lit

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "hstream_tpu_torch"
SCHEMA = Schema.of(device=ColumnType.STRING, temp=ColumnType.FLOAT)


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "hstream_tpu" or name.startswith("hstream_tpu."))


def test_port_imports_with_jax_blocked_and_loads_no_jax_package_module():
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "import hstream_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    hstream_tpu_torch.__path__, 'hstream_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(n for n in sys.modules if n == 'hstream_tpu'\n"
        "             or n.startswith('hstream_tpu.'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15  # every module of the slice


@pytest.mark.parametrize("path", sorted(
    [p for p in PKG.rglob("*.py")] + [REPO / "chip_smoke.py"]),
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


@pytest.mark.parametrize("make", [
    lambda: (_node([AggSpec(AggKind.COUNT, "c", input=Col("temp"))]), {}),
    lambda: (_node([AggSpec(AggKind.APPROX_QUANTILE, "q",
                            input=Col("temp"), quantile=0.5)]), {}),
    lambda: (_node([AggSpec(AggKind.TOPK, "t", input=Col("temp"), k=3)]),
             {}),
    lambda: (_node([AggSpec(AggKind.TOPK_DISTINCT, "t", input=Col("temp"),
                            k=3)]), {}),
    lambda: (_node([AggSpec(AggKind.SUM, "s", input=BinOp(
        "*", Col("temp"), Lit(2.0)))]), {}),
    lambda: (_node([COUNT], child=FilterNode(SourceNode("s", SCHEMA), BinOp(
        ">", Col("temp"), Lit(0.0)))), {}),
    lambda: (_node([COUNT]), {"emit_changes": True}),
], ids=["count_col", "quantile", "topk", "topk_distinct", "computed_input",
        "where", "emit_changes"])
def test_unported_plan_features_name_their_roadmap_item(make):
    node, kw = make()
    with pytest.raises(NotPortedError, match=r"ROADMAP A6") as e:
        QueryExecutor(node, SCHEMA, device="cpu", **kw)
    assert isinstance(e.value, NotImplementedError)


def test_session_windows_and_null_inputs_are_not_ported():
    with pytest.raises(NotPortedError, match="A7"):
        QueryExecutor(_node([COUNT], window=SessionWindow(5_000)), SCHEMA,
                      device="cpu")
    ex = QueryExecutor(_node([AggSpec(AggKind.SUM, "s", input=Col("temp"))]),
                       SCHEMA, device="cpu")
    with pytest.raises(NotPortedError, match="A6"):
        ex.process([{"device": "a"}], [1_700_000_000_000])
