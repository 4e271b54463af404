"""Run the reference's own test cases on the port, side by side with the
reference.

``port_cases(module, names)`` turns test functions of a reference test
module (``tests/<module>.py``) into test functions of the calling test
file.  Each runs the reference's case twice, in one process: first as it
is, on ``repro``, then as its port copy on ``repro_torch``.  The port copy
is the same source with three changes, made on its syntax tree:
- every import of ``repro`` or ``repro.*`` imports ``repro_torch`` instead,
  and string constants naming a ``repro.`` module name the port's;
- names the port leaves to a later slice (``MISSING``) are dropped from
  those imports;
- every ``SemanticContext(...)`` and ``VectorIndex(...)`` call is given
  ``device="cpu"`` (the port's entry points run on the GPU otherwise).

So each case keeps the reference's own assertions and margins, run on the
port.  While a side runs, ``Observer`` records what its ``Pipeline``s
show: every ``collect()`` table (or the error it raised) with the
context's ``ExecutionReport``s and provider counters, every ``explain()``
text, every ``check()`` diagnostic and every optimized plan's operators
and rewrites.  The two sides' records must be equal:
- floats within ``FLOAT_TOL`` (the cosine scores of the jnp and torch
  scans differ in the last f32 bits), every other value exactly;
- measured walls in ``explain()`` text masked (``<wall>``);
- a report's measured ``latencies`` by their count, its ``batch_sizes``
  and the list of reports as multisets (the scheduler completes them in
  any order).

Hypothesis cases run under ``settings(derandomize=True, database=None)``,
at most ``MAX_EXAMPLES`` draws, so both sides see the same draws.
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import inspect
import math
import re
import threading
import types
from pathlib import Path

import numpy as np

TESTS = Path(__file__).resolve().parent
FLOAT_TOL = 1e-5
MAX_EXAMPLES = 40
# names the port leaves to a later slice: none since the mesh-sharded
# scan (A.11) brought ``active_mesh``
MISSING = set()
DEVICE_CALLS = {"SemanticContext", "VectorIndex"}
_WALL = re.compile(r"(\d+\.\d{3})s\b")


# ---------------------------------------------------------------------------
# loading a reference test module as itself and as its port copy
# ---------------------------------------------------------------------------
def _to_port_name(name: str) -> str:
    if name == "repro" or name.startswith("repro."):
        return "repro_torch" + name[len("repro"):]
    return name


def _to_port_string(s: str) -> str:
    return _to_port_name(s) if s.startswith("repro.") else s


class _ToPort(ast.NodeTransformer):
    def visit_ImportFrom(self, node):
        if node.level == 0 and node.module:
            port = _to_port_name(node.module)
            if port != node.module:
                node.module = port
                node.names = [a for a in node.names
                              if a.name not in MISSING]
        return node

    def visit_Import(self, node):
        for alias in node.names:
            port = _to_port_name(alias.name)
            if port != alias.name:
                if alias.asname is None and "." in alias.name:
                    raise NotImplementedError(
                        f"'import {alias.name}' binds 'repro'")
                alias.name = port
        return node

    def visit_Constant(self, node):
        if isinstance(node.value, str):
            node.value = _to_port_string(node.value)
        return node

    def visit_Call(self, node):
        self.generic_visit(node)
        f = node.func
        name = (f.id if isinstance(f, ast.Name)
                else f.attr if isinstance(f, ast.Attribute) else None)
        if name in DEVICE_CALLS and not any(k.arg == "device"
                                            for k in node.keywords):
            node.keywords.append(ast.keyword("device", ast.Constant("cpu")))
        return node


@functools.lru_cache(maxsize=None)
def load(module: str, port: bool) -> types.ModuleType:
    """``tests/<module>.py`` as a fresh module: the reference's source, or
    its port copy (module docstring)."""
    path = TESTS / f"{module}.py"
    tree = ast.parse(path.read_text(encoding="utf-8"), str(path))
    if port:
        tree = ast.fix_missing_locations(_ToPort().visit(tree))
    mod = types.ModuleType(f"{'port' if port else 'ref'}_{module}")
    mod.__file__ = str(path)
    exec(compile(tree, str(path), "exec"), mod.__dict__)
    return mod


# ---------------------------------------------------------------------------
# what a side's Pipelines show
# ---------------------------------------------------------------------------
def _plain(v):
    """A value with numpy containers and scalars turned into python."""
    if isinstance(v, np.ndarray):
        return [_plain(x) for x in v.tolist()]
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def _report(rep) -> str:
    d = dataclasses.asdict(rep)
    d["latencies"] = len(d["latencies"])
    d["batch_sizes"] = sorted(d["batch_sizes"])
    return repr(d)


def _stats(provider) -> dict:
    s = provider.stats.snapshot()
    s.pop("latency_s", None)
    return s


def mask_walls(text: str) -> str:
    return _WALL.sub("<wall>s", text)


class Observer:
    """Records, while active, what every ``Pipeline`` of one package
    shows (module docstring)."""

    def __init__(self, package: str):
        import importlib
        self.cls = importlib.import_module(
            f"{package}.engine.pipeline").Pipeline
        self.log = []
        self._lock = threading.Lock()
        self._saved = {}

    def _add(self, item):
        with self._lock:
            self.log.append(item)

    def __enter__(self):
        obs, cls = self, self.cls
        collect, explain, check, plan = (cls.collect, cls.explain,
                                         cls.check, cls._plan)
        self._saved = dict(collect=collect, explain=explain, check=check,
                           _plan=plan)

        def collect_(self, *a, **kw):
            try:
                t = collect(self, *a, **kw)
            except Exception as e:
                obs._add(("collect raised", type(e).__name__,
                          mask_walls(str(e))))
                raise
            obs._add(("collect", _plain(t.columns),
                      sorted(_report(r) for r in self.ctx.reports),
                      _stats(self.ctx.provider)))
            return t

        def explain_(self, *a, **kw):
            text = explain(self, *a, **kw)
            obs._add(("explain", mask_walls(text)))
            return text

        def check_(self, *a, **kw):
            diags = check(self, *a, **kw)
            obs._add(("check", [str(d) for d in diags]))
            return diags

        def plan_(self, *a, **kw):
            p = plan(self, *a, **kw)
            obs._add(("plan", [n.op for n in p.nodes], list(p.rewrites)))
            return p

        cls.collect, cls.explain, cls.check, cls._plan = (
            collect_, explain_, check_, plan_)
        return self

    def __exit__(self, *exc):
        for k, v in self._saved.items():
            setattr(self.cls, k, v)
        return False


def same(a, b) -> bool:
    """Equal, floats within ``FLOAT_TOL``."""
    if isinstance(a, float) or isinstance(b, float):
        if not isinstance(a, (int, float)) or not isinstance(b, (int, float)):
            return False
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return a == b or abs(a - b) <= FLOAT_TOL
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def min_adjacent_gap(columns: dict) -> float:
    """The smallest gap between adjacent values of the float columns of a
    table, to tell a near-tie (ambiguous data) from a fault of the port."""
    gaps = [abs(x - y) for col in columns.values()
            for x, y in zip(col, col[1:])
            if isinstance(x, float) and isinstance(y, float)
            and x != y and not (math.isnan(x) or math.isnan(y))]
    return min(gaps, default=math.inf)


def assert_same_records(ref_log, port_log):
    assert len(port_log) == len(ref_log), (
        [r[0] for r in ref_log], [r[0] for r in port_log])
    for i, (r, p) in enumerate(zip(ref_log, port_log)):
        if same(r, p):
            continue
        note = ""
        if r[0] == "collect":
            parts = ("table", "reports", "provider counters")
            differ = [n for n, x, y in zip(parts, r[1:], p[1:])
                      if not same(x, y)]
            note = (f" in its {', '.join(differ)}"
                    f"; the reference table's smallest adjacent float gap "
                    f"is {min_adjacent_gap(r[1]):.3g} (tolerance "
                    f"{FLOAT_TOL})")
        raise AssertionError(f"record {i} ({r[0]}) differs{note}:\n"
                             f"reference {r!r}\nport      {p!r}")


# ---------------------------------------------------------------------------
# running a case on one side
# ---------------------------------------------------------------------------
def _derandomize(fn):
    """A hypothesis case under fixed draws (module docstring)."""
    from hypothesis import settings
    old = getattr(fn, "_hypothesis_internal_use_settings", None)
    if old is not None:
        fn._hypothesis_internal_use_settings = settings(
            old, derandomize=True, database=None, deadline=None,
            max_examples=min(old.max_examples, MAX_EXAMPLES))
    return fn


def _arguments(fn, mod, side, params, request) -> dict:
    """A case's arguments on one side: its parameters, the module's own
    fixtures (called as plain functions, with their own arguments) and
    ``tmp_path`` (a directory of the side's own)."""
    def value(name):
        if name in params:
            return params[name]
        if name == "tmp_path":
            path = request.getfixturevalue("tmp_path") / side
            path.mkdir(exist_ok=True)
            return path
        fixture = getattr(mod, name, None)
        if not hasattr(fixture, "_get_wrapped_function"):
            raise LookupError(f"no fixture {name!r} for the ported case")
        inner = fixture._get_wrapped_function()
        return inner(**{n: value(n)
                        for n in inspect.signature(inner).parameters})
    return {n: value(n) for n in inspect.signature(fn).parameters}


def run_side(module, name, port, params, request):
    """Run one case on one side; returns what its Pipelines showed."""
    mod = load(module, port)
    fn = getattr(mod, name)
    if hasattr(fn, "hypothesis"):
        _derandomize(fn)
    side = "port" if port else "ref"
    with Observer("repro_torch" if port else "repro") as obs:
        fn(**_arguments(fn, mod, side, params, request))
    return obs.log


def port_cases(module, names, port_only=(), timed=()):
    """Test functions, keyed by name, for the named cases of
    ``tests/<module>.py`` (module docstring).  A case in ``port_only``
    runs its port copy alone, with no record to compare.  A case in
    ``timed`` collects under a scheduler whose speculative tasks, packing
    linger or threads make request counts and the order of collects
    follow the host's timing, in both packages (its own assertions hold
    only its rows): its records keep only tables, texts and plans,
    compared as a multiset."""
    ref_mod = load(module, False)
    out = {}
    for name in names:
        fn = getattr(ref_mod, name)
        params = [p for p in inspect.signature(fn).parameters]
        marks = [m for m in getattr(fn, "pytestmark", [])
                 if m.name == "parametrize"]
        argnames = set()
        for m in marks:
            a = m.args[0]
            argnames |= set(a.split(",") if isinstance(a, str) else a)
        argnames = {a.strip() for a in argnames}
        out[name] = _case(module, name, [p for p in params
                                         if p in argnames],
                          marks, name in port_only, name in timed)
    return out


def _untimed(log):
    """A ``timed`` case's records: no request counts, in a fixed order."""
    return sorted((r[:2] if r[0] == "collect" else r for r in log),
                  key=repr)


def _case(module, name, argnames, marks, port_only, timed):
    def case(request, **params):
        if port_only:
            run_side(module, name, True, params, request)
            return
        ref_log = run_side(module, name, False, params, request)
        port_log = run_side(module, name, True, params, request)
        if timed:
            ref_log, port_log = _untimed(ref_log), _untimed(port_log)
        assert_same_records(ref_log, port_log)

    case.__name__ = case.__qualname__ = name
    case.__doc__ = (f"``tests/{module}.py::{name}`` on the port"
                    + ("" if port_only else ", records equal to the "
                       "reference's"))
    case.__signature__ = inspect.Signature(
        [inspect.Parameter("request", inspect.Parameter.KEYWORD_ONLY)]
        + [inspect.Parameter(a, inspect.Parameter.KEYWORD_ONLY)
           for a in argnames])
    if marks:
        case.pytestmark = list(marks)
    return case
