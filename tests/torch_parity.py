"""Shared harness of the port's executor parity tests: build one plan in
both packages (hstream_tpu and hstream_tpu_torch) from the same recipe,
feed both QueryExecutors the same batches, and compare what they emit.

A recipe is a function of a package namespace `m` (engine exports plus
Col / Lit / BinOp / UnOp) returning (node, schema). Rows compare with
their keys and window bounds exact, counts and TOPK lists exact, and
float aggregates within rel 1e-6 (the reference sums in XLA's order);
an APPROX_QUANTILE value within rel 4e-6 (the same bucket's midpoint;
XLA contracts the exp's argument into an FMA, test_torch_changelog_
lattice.py).
"""

from __future__ import annotations

import types

import numpy as np
import pytest

import hstream_tpu.engine as J
from hstream_tpu.engine import expr as je
import hstream_tpu_torch.engine as T
from hstream_tpu_torch.engine import expr as te

BASE = 1_700_000_000_000


def _ns(engine, expr):
    ns = types.SimpleNamespace(**{k: getattr(engine, k)
                                  for k in engine.__all__})
    for k in ("Col", "Lit", "BinOp", "UnOp"):
        setattr(ns, k, getattr(expr, k))
    return ns


JM, TM = _ns(J, je), _ns(T, te)

# drain modes of an EMIT CHANGES executor
MODES = {
    "close": dict(emit_changes=False),
    "changes": dict(emit_changes=True),
    "deferred": dict(emit_changes=True, defer_change_decode=True,
                     change_drain_depth=2),
    "async": dict(emit_changes=True, defer_change_decode=True,
                  async_change_drain=True),
}


def pair(recipe, mode: str = "changes", **kw):
    """(JAX executor, port executor on the CPU) for a recipe and mode."""
    out = []
    for m, extra in ((JM, {}), (TM, {"device": "cpu"})):
        node, schema = recipe(m)
        opts = dict(MODES[mode])
        flags = {k: opts.pop(k) for k in ("defer_change_decode",
                                          "change_drain_depth",
                                          "async_change_drain")
                 if k in opts}
        ex = m.QueryExecutor(node, schema, initial_keys=8,
                             batch_capacity=256, **opts, **kw, **extra)
        for k, v in flags.items():
            setattr(ex, k, v)
        out.append(ex)
    return out


def rows_of(*triples, key="device", value="temp"):
    """(rows, ts) from (key, value, ts offset ms); value None = missing."""
    rows = [{key: k} if v is ... else {key: k, value: v}
            for k, v, _ in triples]
    return rows, [BASE + off for _, _, off in triples]


def _norm(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


def assert_rows_equal(want, got, quantiles=()):
    want, got = list(want), list(got)
    assert len(got) == len(want), (len(got), len(want))
    for w, g in zip(want, got):
        assert set(g) == set(w), (g, w)
        for k in w:
            wv, gv = _norm(w[k]), _norm(g[k])
            if isinstance(wv, float) and not isinstance(gv, list):
                tol = 4e-6 if k in quantiles else 1e-6
                assert gv == pytest.approx(wv, rel=tol, abs=0), (k, gv, wv)
            else:
                assert gv == wv, (k, gv, wv)


def drive(jex, tex, batches, columnar=False, quantiles=()):
    """Feed both executors the same batches (row or columnar), compare
    each call's rows (with the asynchronous drain, whose rows surface
    when its fetches finish, the whole stream), then the flushed tail;
    returns the port's rows."""
    whole = getattr(jex, "async_change_drain", False)
    want_all, out = [], []
    for b in batches:
        if columnar:
            want = jex.process_columnar(*b)
            got = tex.process_columnar(*b)
        else:
            want = jex.process(*b)
            got = tex.process(*b)
        if not whole:
            assert_rows_equal(want, got, quantiles)
        want_all.extend(want)
        out.extend(got)
    if jex.emit_changes:
        want_all.extend(jex.flush_changes())
        out.extend(tex.flush_changes())
        assert not tex.has_pending_changes()
    assert_rows_equal(want_all, out, quantiles)
    return out


def plan_from(obj):
    """The port's twin of a JAX-package plan object, rebuilt recursively:
    each dataclass or enum of `hstream_tpu.<mod>` becomes the class of
    the same name in `hstream_tpu_torch.<mod>` (SelectPlan, the engine's
    plan nodes, expressions, windows, schema types, the JOIN clause),
    with lists, tuples and dicts rebuilt element by element."""
    import dataclasses
    import enum
    import importlib

    def twin(cls):
        mod = cls.__module__
        assert mod.startswith("hstream_tpu."), mod
        return getattr(importlib.import_module(
            "hstream_tpu_torch." + mod.split(".", 1)[1]), cls.__name__)

    if isinstance(obj, enum.Enum):
        return twin(type(obj))[obj.name]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        vals = {f.name: plan_from(getattr(obj, f.name))
                for f in dataclasses.fields(obj) if f.init}
        return twin(type(obj))(**vals)
    if isinstance(obj, list):
        return [plan_from(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(plan_from(v) for v in obj)
    if isinstance(obj, dict):
        return {plan_from(k): plan_from(v) for k, v in obj.items()}
    return obj


def plan_tuple(obj):
    """Either package's plan as plain nested tuples, for comparing a JAX
    plan with a port plan field by field: a dataclass becomes (class
    name, (field, value), ...), an enum (class name, member name), lists
    and tuples tuples, a dict a tuple of (key, value) pairs in order."""
    import dataclasses
    import enum

    if isinstance(obj, enum.Enum):
        return (type(obj).__name__, obj.name)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,) + tuple(
            (f.name, plan_tuple(getattr(obj, f.name)))
            for f in dataclasses.fields(obj))
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__,) + tuple(plan_tuple(v) for v in obj)
    if isinstance(obj, dict):
        return ("dict",) + tuple((plan_tuple(k), plan_tuple(v))
                                 for k, v in obj.items())
    return obj
