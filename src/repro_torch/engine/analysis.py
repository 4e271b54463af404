"""Static plan analysis: schema inference, pre-flight diagnostics, and
rewrite-soundness verification (paper §2.1's "resources are schema
objects" carried to its conclusion).

FlockMTL makes ``MODEL`` and ``PROMPT`` first-class, versioned schema
objects precisely so that references are *statically resolvable* — yet
a typo'd model name, a prompt placeholder naming a column the node
never sees, or an optimizer rewrite that silently changed a node's
output columns would all surface mid-``collect()``, after paid provider
requests have shipped.  This module closes that gap with three layers:

1. **Schema/provenance inference** — ``infer_schema(source, nodes)``
   assigns every plan node an inferred output schema: column names,
   best-effort dtypes sampled from the source/corpus tables, and a
   provenance label (``scan``, ``node[i]:llm_complete``,
   ``corpus[content]``).  Inference understands the full operator
   vocabulary: ``Table.lateral`` expansion with the ``_doc`` collision
   suffix exactly as ``retrieval_ops.make_retrieval_fn`` computes it,
   fused ``llm_fused`` multi-outputs, speculative chains, the
   map-past-filter (``llm_spec_map``) and retrieval-aware rerank
   (``spec_rerank``) speculation nodes, and grouped ``llm_rerank``.

2. **Pre-flight diagnostics** — ``analyze_plan(ctx, source, nodes)``
   resolves MODEL/PROMPT references against the context's
   ``core.resources.Catalog``, checks ``{placeholder}`` tokens in
   prompt templates against the node's visible input columns, and
   centralizes parameter validation (ann knobs, ``k > 0``, fusion
   method names).  Every finding is a ``Diagnostic`` with a stable
   ``FLK``-prefixed code, a severity, and the node span — and the whole
   pass is pure planning: **zero provider requests**.

3. **Rewrite-soundness obligations** — every rule in
   ``engine/optimizer.py`` emits a machine-checkable ``Obligation``
   (commute legality against the node's ``outs`` ban set, schema
   preservation, mask-equivalence for filter reorders/speculation,
   candidate-set recall contracts for ``ann_select``/``k_pushdown``).
   ``verify_rewrites`` discharges them on the optimized plan with an
   *independent* encoding of the legality rules, so a bug in either the
   optimizer or the verifier is caught by the other.

Diagnostic codes (stable; see docs/diagnostics.md):

=======  ========  ====================================================
code     severity  meaning
=======  ========  ====================================================
FLK001   error     MODEL reference not found in the catalog
FLK002   error     PROMPT reference not found in the catalog
FLK003   error     prompt placeholder not bound to a visible column
FLK004   error     column not present in the node's input schema
FLK005   error     invalid operator parameter (k, ann knobs, fusion)
FLK006   error/    output column collides with an existing column
         warning   (error when ``Table.lateral`` would raise)
FLK010   error     rewrite-soundness obligation failed
=======  ========  ====================================================

Entry points: ``Pipeline.check()`` and ``Pipeline.collect(verify=)``
wrap this module; ``explain()`` renders the inferred schemas.

A copy of ``repro/engine/analysis.py``.  Its one intended difference,
besides this paragraph: ``_discharge`` finds a ``commute`` obligation's
semantic node by identity (``payload["sem_node"]``) and falls back to
``_find_node``'s semantic key only when that node is gone from the
optimized plan (merged into a fused or speculative node).  The
reference looks it up by key alone, which finds the FIRST node with
that key: in a plan with two identical semantic nodes and a pushdown
past the second, it checks the pushed node against the earlier one and
reports a false FLK010.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.fusion import FUSION_METHODS

from .table import Table

# ops whose executors feed tuples to a provider-backed LLM call
LLM_OPS = ("llm_filter", "llm_complete", "llm_complete_json",
           "llm_embedding", "llm_rerank", "llm_fused", "llm_spec_chain",
           "llm_spec_map", "spec_rerank")
# retrieval operators (mirrors retrieval_ops.RETRIEVAL_OPS without the
# import: analysis must stay importable from the optimizer without
# cycles)
RETRIEVAL_OPS = ("vector_topk", "bm25_topk", "hybrid_topk")
# fusable op -> metaprompt kind (mirrors optimizer.FUSABLE)
_FUSABLE_KINDS = {"llm_filter": "filter", "llm_complete": "complete",
                  "llm_complete_json": "complete_json"}
# output dtype a semantic map op produces
_OUT_DTYPE = {"llm_complete": "str", "llm_complete_json": "json",
              "llm_embedding": "vector", "project": "any",
              "complete": "str", "complete_json": "json"}

# ``{placeholder}`` tokens in prompt templates: an identifier directly
# after the brace (so JSON-shaped prompt text like ``{"issue": ...}``
# never matches); ``{{`` escapes
_PLACEHOLDER_RE = re.compile(r"(?<!\{)\{([A-Za-z_][A-Za-z0-9_]*)\}")


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Diagnostic:
    """One analyzer finding: a stable ``FLK`` code, a severity
    (``error`` | ``warning``), the offending node's index and op, and a
    human message."""
    code: str
    severity: str
    message: str
    node: Optional[int] = None
    op: Optional[str] = None

    def __str__(self):
        span = ("" if self.node is None
                else f" @node[{self.node}]"
                     + (f" {self.op}" if self.op else ""))
        return f"{self.code} {self.severity}{span}: {self.message}"


class PlanValidationError(ValueError):
    """Raised by ``Pipeline.check()`` / ``collect(verify="strict")``
    when the analyzer finds error-severity diagnostics.  Carries the
    full list on ``.diagnostics``."""

    def __init__(self, diagnostics: Sequence[Diagnostic]):
        self.diagnostics = list(diagnostics)
        errors = [d for d in self.diagnostics if d.severity == "error"]
        lines = [f"plan failed static analysis "
                 f"({len(errors)} error(s)):"]
        lines += [f"  {d}" for d in self.diagnostics]
        super().__init__("\n".join(lines))


# ---------------------------------------------------------------------------
# schema model
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Column:
    """One inferred column: name, best-effort dtype, and provenance
    (which node or source table produced it)."""
    name: str
    dtype: str = "any"
    origin: str = "scan"


class Schema:
    """Ordered column set flowing between plan nodes."""

    def __init__(self, columns: Sequence[Column] = ()):
        self._cols: Dict[str, Column] = {c.name: c for c in columns}

    # ---- access ----------------------------------------------------------
    @property
    def names(self) -> List[str]:
        return list(self._cols)

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __len__(self):
        return len(self._cols)

    def get(self, name: str) -> Optional[Column]:
        return self._cols.get(name)

    def columns(self) -> List[Column]:
        return list(self._cols.values())

    # ---- derivation (immutable) -----------------------------------------
    def add(self, col: Column) -> "Schema":
        s = Schema(self.columns())
        s._cols[col.name] = col
        return s

    def restrict(self, names: Sequence[str]) -> "Schema":
        return Schema([self._cols[n] for n in names if n in self._cols])

    def render(self, max_cols: int = 8) -> str:
        cols = self.columns()
        body = ", ".join(f"{c.name}:{c.dtype}" for c in cols[:max_cols])
        if len(cols) > max_cols:
            body += f", ... ({len(cols)} cols)"
        return body


def _dtype_of(value: Any) -> str:
    if isinstance(value, bool):
        return "bool"
    if isinstance(value, int):
        return "int"
    if isinstance(value, float):
        return "float"
    if isinstance(value, str):
        return "str"
    if isinstance(value, dict):
        return "json"
    if isinstance(value, (list, tuple)) or hasattr(value, "shape"):
        return "vector"
    return "any"


def table_schema(table: Table, origin: str = "scan") -> Schema:
    """Schema sampled from a materialized table: dtype of the first
    non-None value per column."""
    cols = []
    for name in table.column_names:
        dtype = "any"
        for v in table.columns[name]:
            if v is not None:
                dtype = _dtype_of(v)
                break
        cols.append(Column(name, dtype, origin))
    return Schema(cols)


def _dtype_compatible(a: str, b: str) -> bool:
    if a == b or "any" in (a, b):
        return True
    return {a, b} <= {"int", "float", "bool"}     # numeric widening


# ---------------------------------------------------------------------------
# per-node schema inference + pre-flight checks
# ---------------------------------------------------------------------------
@dataclass
class PlanAnalysis:
    """Result of one static pass: per-node OUTPUT schemas (aligned with
    the node list) and the collected diagnostics."""
    schemas: List[Schema] = field(default_factory=list)
    diagnostics: List[Diagnostic] = field(default_factory=list)

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    @property
    def output_schema(self) -> Schema:
        return self.schemas[-1] if self.schemas else Schema()

    def raise_on_error(self):
        if self.errors:
            raise PlanValidationError(self.diagnostics)


def _check_model(ctx, spec, idx, op, diags: List[Diagnostic]):
    """Catalog resolution of a MODEL spec (FLK001) + inline-spec
    parameter sanity (FLK005)."""
    if not isinstance(spec, dict):
        diags.append(Diagnostic(
            "FLK005", "error",
            f"model spec must be a dict, got {type(spec).__name__}",
            idx, op))
        return
    if "model_name" in spec:
        if ctx is not None and ctx.catalog.get_model(
                spec["model_name"]) is None:
            diags.append(Diagnostic(
                "FLK001", "error",
                f"MODEL {spec['model_name']!r} not found in the catalog",
                idx, op))
        return
    for key, floor in (("context_window", 1), ("max_output_tokens", 0),
                       ("embedding_dim", 0), ("max_concurrency", 1)):
        if key in spec:
            try:
                ok = int(spec[key]) >= floor
            except (TypeError, ValueError):
                ok = False
            if not ok:
                diags.append(Diagnostic(
                    "FLK005", "error",
                    f"model spec {key}={spec[key]!r} must be an int "
                    f">= {floor}", idx, op))


def _check_prompt(ctx, spec, visible: Sequence[str], schema: Schema,
                  idx, op, diags: List[Diagnostic]):
    """Catalog resolution of a PROMPT spec (FLK002) + placeholder
    binding against the node's visible tuple columns (FLK003)."""
    if not isinstance(spec, dict):
        diags.append(Diagnostic(
            "FLK005", "error",
            f"prompt spec must be a dict, got {type(spec).__name__}",
            idx, op))
        return
    text = None
    if "prompt_name" in spec:
        if ctx is None:
            return
        p = ctx.catalog.get_prompt(spec["prompt_name"])
        if p is None:
            diags.append(Diagnostic(
                "FLK002", "error",
                f"PROMPT {spec['prompt_name']!r} not found in the "
                f"catalog", idx, op))
            return
        text = p.text
    else:
        text = spec.get("prompt", "")
    for name in dict.fromkeys(_PLACEHOLDER_RE.findall(text or "")):
        if name in visible:
            continue
        if name in schema:
            diags.append(Diagnostic(
                "FLK003", "error",
                f"prompt placeholder {{{name}}} names column {name!r}, "
                f"which exists but is not passed in cols={list(visible)}",
                idx, op))
        else:
            diags.append(Diagnostic(
                "FLK003", "error",
                f"prompt placeholder {{{name}}} does not match any "
                f"input column (have: {schema.names})", idx, op))


def _check_cols(cols, schema: Schema, idx, op,
                diags: List[Diagnostic], what: str = "cols"):
    for c in cols:
        if c not in schema:
            diags.append(Diagnostic(
                "FLK004", "error",
                f"{what} references column {c!r} not present in the "
                f"input schema (have: {schema.names})", idx, op))


def _check_ann(info: dict, idx, op, diags: List[Diagnostic]):
    ann = info.get("ann")
    if ann is not None and ann not in ("auto", "ivf", "exact"):
        diags.append(Diagnostic(
            "FLK005", "error",
            f"ann={ann!r}: expected 'auto', 'ivf', 'exact' or None",
            idx, op))
    rt = info.get("recall_target")
    if rt is not None and not (0.0 < float(rt) <= 1.0):
        diags.append(Diagnostic(
            "FLK005", "error",
            f"recall_target={rt!r} must be in (0, 1]", idx, op))
    for knob in ("nprobe", "nlist"):
        v = info.get(knob)
        if v is not None and int(v) < 1:
            diags.append(Diagnostic(
                "FLK005", "error", f"{knob}={v!r} must be >= 1",
                idx, op))
    np_, nl = info.get("nprobe"), info.get("nlist")
    if np_ is not None and nl is not None and int(np_) > int(nl):
        diags.append(Diagnostic(
            "FLK005", "warning",
            f"nprobe={np_} > nlist={nl}: clamped to nlist at scan time "
            f"(bit-identical to exact)", idx, op))
    if any(info.get(k) is not None
           for k in ("recall_target", "nprobe", "nlist")) and ann is None:
        diags.append(Diagnostic(
            "FLK005", "error",
            "recall_target/nprobe/nlist require ann= "
            "('auto', 'ivf' or 'exact')", idx, op))


def _add_out(schema: Schema, name: str, dtype: str, idx: int, op: str,
             diags: List[Diagnostic]) -> Schema:
    if name in schema:
        prev = schema.get(name)
        diags.append(Diagnostic(
            "FLK006", "warning",
            f"output column {name!r} overwrites an existing column "
            f"(from {prev.origin})", idx, op))
    return schema.add(Column(name, dtype, f"node[{idx}]:{op}"))


class _NodeShim:
    """Minimal stand-in for a ``PlanNode`` (op + info) so analysis can
    recurse into the retrieval node a ``spec_rerank`` wraps without
    importing ``engine.pipeline`` (which imports this module)."""
    __slots__ = ("op", "info")

    def __init__(self, op: str, info: dict):
        self.op, self.info = op, info


def _infer_retrieval(node, schema: Schema, idx: int,
                     diags: List[Diagnostic]) -> Schema:
    """Retrieval expansion: parent columns replicate, corpus columns
    join under the ``_doc`` collision suffix (exactly the rename
    ``make_retrieval_fn`` applies), plus the score and rank columns.
    A name that collides even after the suffix is an error — the
    runtime ``Table.lateral`` raises on it."""
    op, info = node.op, node.info
    corpus = info.get("corpus")
    corpus_sch = (table_schema(corpus, origin="corpus")
                  if corpus is not None else Schema())
    out = schema
    for col in corpus_sch.columns():
        name = col.name + "_doc" if col.name in schema else col.name
        if name in out:
            diags.append(Diagnostic(
                "FLK006", "error",
                f"corpus column {col.name!r} collides with parent "
                f"column {name!r} even after the _doc suffix — "
                f"Table.lateral will reject this plan", idx, op))
            continue
        out = out.add(Column(name, col.dtype,
                             f"corpus[{col.name}]"))
    for name, dtype in ((info.get("out"), "float"),
                        (str(info.get("out")) + "_rank", "int")):
        if name in out:
            diags.append(Diagnostic(
                "FLK006", "error",
                f"retrieval output column {name!r} collides with an "
                f"existing column — Table.lateral will reject this "
                f"plan", idx, op))
            continue
        out = out.add(Column(name, dtype, f"node[{idx}]:{op}"))
    return out


def _analyze_node(ctx, node, schema: Schema, idx: int,
                  diags: List[Diagnostic]) -> Schema:
    """One inference + pre-flight step: returns the node's OUTPUT
    schema, appending diagnostics along the way."""
    op, info = node.op, node.info

    if op == "scan":
        return schema

    if op == "select":
        _check_cols(info.get("cols", ()), schema, idx, op, diags,
                    "select")
        return schema.restrict(list(info.get("cols", ())))

    if op == "filter":
        if info.get("cols") is not None:
            _check_cols(info["cols"], schema, idx, op, diags, "filter")
        return schema

    if op == "order_by":
        if not info.get("key_is_callable") and info.get("key"):
            _check_cols([info["key"]], schema, idx, op, diags,
                        "order_by key")
        return schema

    if op == "limit":
        n = info.get("n")
        if n is not None and int(n) < 0:
            diags.append(Diagnostic(
                "FLK005", "error", f"limit n={n!r} must be >= 0",
                idx, op))
        return schema

    if op == "project":
        return _add_out(schema, info["out"], "any", idx, op, diags)

    if op in ("llm_complete", "llm_complete_json", "llm_embedding"):
        _check_cols(info.get("cols", ()), schema, idx, op, diags)
        _check_model(ctx, info.get("model"), idx, op, diags)
        if op != "llm_embedding":
            _check_prompt(ctx, info.get("prompt"),
                          list(info.get("cols", ())), schema, idx, op,
                          diags)
        return _add_out(schema, info["out"], _OUT_DTYPE[op], idx, op,
                        diags)

    if op == "llm_filter":
        _check_cols(info.get("cols", ()), schema, idx, op, diags)
        _check_model(ctx, info.get("model"), idx, op, diags)
        _check_prompt(ctx, info.get("prompt"),
                      list(info.get("cols", ())), schema, idx, op, diags)
        return schema

    if op == "llm_rerank":
        _check_cols(info.get("cols", ()), schema, idx, op, diags)
        _check_model(ctx, info.get("model"), idx, op, diags)
        _check_prompt(ctx, info.get("prompt"),
                      list(info.get("cols", ())), schema, idx, op, diags)
        if info.get("by") is not None:
            _check_cols([info["by"]], schema, idx, op, diags,
                        "rerank by")
        return schema

    if op == "llm_fused":
        _check_cols(info.get("cols", ()), schema, idx, op, diags)
        _check_model(ctx, info.get("model"), idx, op, diags)
        for p in info.get("prompts", ()):
            _check_prompt(ctx, p, list(info.get("cols", ())), schema,
                          idx, op, diags)
        out = schema
        outs = iter(info.get("outs", ()))
        for kind in info.get("kinds", ()):
            if kind == "filter":
                continue
            out = _add_out(out, next(outs), _OUT_DTYPE.get(kind, "any"),
                           idx, op, diags)
        return out

    if op == "llm_spec_chain":
        for member in info.get("member_specs", ()):
            _check_cols(member.get("cols", ()), schema, idx, op, diags)
            _check_model(ctx, member.get("model"), idx, op, diags)
            _check_prompt(ctx, member.get("prompt"),
                          list(member.get("cols", ())), schema, idx, op,
                          diags)
        return schema

    if op == "llm_spec_map":
        # filter members see the node's INPUT schema (the map runs
        # speculatively over the same rows)
        for member in info.get("member_specs", ()):
            _check_cols(member.get("cols", ()), schema, idx, op, diags)
            _check_model(ctx, member.get("model"), idx, op, diags)
            _check_prompt(ctx, member.get("prompt"),
                          list(member.get("cols", ())), schema, idx, op,
                          diags)
        _check_cols(info.get("cols", ()), schema, idx, op, diags)
        _check_model(ctx, info.get("model"), idx, op, diags)
        _check_prompt(ctx, info.get("prompt"),
                      list(info.get("cols", ())), schema, idx, op, diags)
        dtype = _OUT_DTYPE.get(info.get("map_op", "llm_complete"), "str")
        return _add_out(schema, info["out"], dtype, idx, op, diags)

    if op == "spec_rerank":
        # the wrapped retrieval node expands the schema exactly as the
        # standalone node would; the rerank spec then reads the
        # EXPANDED columns
        retr = _NodeShim(info["retr_op"], info["_retr"])
        out = _analyze_node(ctx, retr, schema, idx, diags)
        rr = info.get("_rerank", {})
        _check_cols(rr.get("cols", ()), out, idx, op, diags)
        _check_model(ctx, rr.get("model"), idx, op, diags)
        _check_prompt(ctx, rr.get("prompt"), list(rr.get("cols", ())),
                      out, idx, op, diags)
        if rr.get("by") is not None:
            _check_cols([rr["by"]], out, idx, op, diags, "rerank by")
        return out

    if op in RETRIEVAL_OPS:
        qcol = info.get("query_col")
        if qcol is not None:
            _check_cols([qcol], schema, idx, op, diags, "query_col")
        k = info.get("k")
        if k is None or int(k) < 1:
            diags.append(Diagnostic(
                "FLK005", "error",
                f"k={k!r} must be an int >= 1", idx, op))
        ck = info.get("candidate_k")
        if ck is not None:
            if int(ck) < 1:
                diags.append(Diagnostic(
                    "FLK005", "error",
                    f"candidate_k={ck!r} must be >= 1", idx, op))
            elif k is not None and int(ck) < int(k):
                diags.append(Diagnostic(
                    "FLK005", "warning",
                    f"candidate_k={ck} < k={k}: per-retriever depth "
                    f"truncates the final top-k", idx, op))
        if op == "hybrid_topk" and info.get(
                "fusion") not in FUSION_METHODS:
            diags.append(Diagnostic(
                "FLK005", "error",
                f"fusion={info.get('fusion')!r} is not one of "
                f"{FUSION_METHODS}", idx, op))
        if op != "bm25_topk":
            _check_model(ctx, info.get("model"), idx, op, diags)
            _check_ann(info, idx, op, diags)
        return _infer_retrieval(node, schema, idx, diags)

    diags.append(Diagnostic(
        "FLK005", "warning",
        f"unknown operator {op!r}: schema passed through unchanged",
        idx, op))
    return schema


def analyze_plan(ctx, source: Table, nodes: Sequence) -> PlanAnalysis:
    """Full static pass over a node list: per-node output schemas plus
    pre-flight diagnostics.  Pure planning — resolves resources against
    the catalog but never touches the provider."""
    res = PlanAnalysis()
    schema = table_schema(source)
    for idx, node in enumerate(nodes):
        schema = _analyze_node(ctx, node, schema, idx, res.diagnostics)
        res.schemas.append(schema)
    return res


def infer_schema(source: Table, nodes: Sequence) -> List[Schema]:
    """Per-node inferred OUTPUT schemas (catalog checks skipped —
    shape-only inference; use ``analyze_plan`` for full pre-flight)."""
    return analyze_plan(None, source, nodes).schemas


# ---------------------------------------------------------------------------
# rewrite-soundness obligations
# ---------------------------------------------------------------------------
@dataclass(frozen=False)
class Obligation:
    """One machine-checkable claim an optimizer rewrite must honour on
    the optimized plan.  ``rule`` is the human rewrite string (aligned
    with ``OptimizedPlan.rewrites``), ``kind`` selects the discharge
    procedure, ``payload`` carries the structured claim."""
    rule: str
    kind: str       # commute | fusion_exact | mask_equivalence |
    #                 selection_invariance | recall_contract |
    #                 index_shared | schema_preserved
    payload: dict = field(default_factory=dict)

    def __str__(self):
        return f"{self.kind}[{self.rule}]"


def semantic_key(node) -> dict:
    """Identity of a semantic/retrieval node that survives rebuilds:
    op + output column + corpus fingerprint + prompt spec.  Used by
    commute obligations to re-locate the node in the optimized plan
    (retrieval nodes are REBUILT by the retrieval rewrites, and fusable
    nodes may merge into an ``llm_fused``, so ``id()`` would dangle)."""
    info = node.info
    return {"op": node.op, "out": info.get("out"),
            "corpus_fp": info.get("corpus_fp"),
            "prompt": info.get("prompt")}


def _node_ban_set(node) -> set:
    """Columns node may produce — the pushdown ban set (mirrors
    ``Pipeline._node_outs`` plus the retrieval ``outs``)."""
    info = node.info
    banned = set(info.get("outs", ()))
    if info.get("out"):
        banned.add(info["out"])
        banned.add(info["out"] + "_rank")
    return banned


def commute_legal(rel, sem) -> Tuple[bool, str]:
    """Independent encoding of the pushdown legality table (the
    verifier's own, NOT a call into ``optimizer._commutes_before`` —
    so a bug in either is caught by the other).  Returns (legal,
    reason-when-not)."""
    r, s = rel.op, sem.op
    banned = _node_ban_set(sem)
    row_preserving = ("llm_complete", "llm_complete_json",
                      "llm_embedding", "project")
    if r == "limit":
        if s in row_preserving:
            return True, ""
        return False, (f"limit only commutes with row-preserving map "
                       f"ops, not {s}")
    if r == "filter":
        if s == "llm_filter":
            return True, ""     # conjunctive predicates commute
        deps = rel.info.get("cols")
        if deps is None:
            return False, "opaque filter predicate cannot cross"
        if s in row_preserving or s in RETRIEVAL_OPS:
            hit = set(deps) & banned
            if hit:
                return False, (f"filter reads {sorted(hit)} which "
                               f"{s} produces")
            return True, ""
        return False, f"filter does not commute with {s}"
    if r == "select":
        if s in ("llm_filter", "llm_rerank"):
            needed = set(sem.info.get("cols", ()))
            if sem.info.get("by") is not None:
                needed.add(sem.info["by"])
            missing = needed - set(rel.info.get("cols", ()))
            if missing:
                return False, (f"select drops columns {sorted(missing)} "
                               f"that {s} reads")
            return True, ""
        return False, f"select does not commute with {s}"
    if r == "order_by":
        if rel.info.get("key_is_callable"):
            return False, "callable sort key cannot cross"
        if s == "llm_filter":
            return True, ""
        if s in row_preserving:
            if rel.info.get("key") in banned:
                return False, (f"sort key {rel.info.get('key')!r} is "
                               f"produced by {s}")
            return True, ""
        return False, f"order_by does not commute with {s}"
    return False, f"{r} is not a pushdown-eligible relational op"


def _prompt_fingerprint(spec) -> str:
    if not isinstance(spec, dict):
        return repr(spec)
    return repr(sorted((k, repr(v)) for k, v in spec.items()))


def _plan_filter_multiset(ctx, nodes) -> Dict[str, int]:
    """Multiset of filter predicates a plan evaluates (as prompt
    fingerprints), counted across plain ``llm_filter`` nodes, fused
    filter sub-tasks, and speculative chain members — the invariant a
    mask-equivalence obligation checks: AND is commutative, so a sound
    reorder/fusion/speculation preserves exactly this multiset."""
    counts: Dict[str, int] = {}

    def bump(spec):
        fp = _prompt_fingerprint(spec)
        counts[fp] = counts.get(fp, 0) + 1

    for node in nodes:
        if node.op == "llm_filter":
            bump(node.info.get("prompt"))
        elif node.op == "llm_fused":
            for kind, p in zip(node.info.get("kinds", ()),
                               node.info.get("prompts", ())):
                if kind == "filter":
                    bump(p)
        elif node.op in ("llm_spec_chain", "llm_spec_map"):
            for member in node.info.get("member_specs", ()):
                bump(member.get("prompt"))
    return counts


def _find_node(nodes, key: dict) -> Optional[int]:
    """Locate the optimized-plan node carrying a semantic identity:
    directly, merged into an ``llm_fused`` node, or as a speculative
    chain member."""
    for i, node in enumerate(nodes):
        info = node.info
        if (node.op == key["op"]
                and info.get("out") == key.get("out")
                and info.get("corpus_fp") == key.get("corpus_fp")
                and (key.get("prompt") is None
                     or info.get("prompt") == key["prompt"])):
            return i
        if node.op == "llm_fused" and key["op"] in _FUSABLE_KINDS:
            if (key.get("out") and key["out"] in info.get("outs", ())) \
                    or (key.get("prompt") is not None
                        and key["prompt"] in info.get("prompts", ())):
                return i
        if (node.op in ("llm_spec_chain", "llm_spec_map")
                and key["op"] == "llm_filter"):
            for member in info.get("member_specs", ()):
                if member.get("prompt") == key.get("prompt"):
                    return i
        if node.op == "spec_rerank" and key["op"] in RETRIEVAL_OPS:
            ri = info.get("_retr", {})
            if (info.get("retr_op") == key["op"]
                    and ri.get("out") == key.get("out")
                    and ri.get("corpus_fp") == key.get("corpus_fp")):
                return i
    return None


def _retrieval_info(node) -> dict:
    """The retrieval-shaped info dict of a node: the node's own for a
    plain retrieval op, the wrapped ``_retr`` for ``spec_rerank``."""
    if node.op == "spec_rerank":
        return node.info.get("_retr", {})
    return node.info


def _discharge(ctx, source: Table, naive_nodes, opt_nodes,
               ob: Obligation) -> Optional[str]:
    """Check one obligation against the optimized plan.  Returns None
    when discharged, else the failure reason."""
    p = ob.payload

    if ob.kind == "commute":
        rel_idx = next((i for i, n in enumerate(opt_nodes)
                        if id(n) == p["rel_id"]), None)
        if rel_idx is None:
            return "pushed relational node vanished from the plan"
        sem_idx = next((i for i, n in enumerate(opt_nodes)
                        if n is p["sem_node"]), None)
        if sem_idx is None:
            sem_idx = _find_node(opt_nodes, p["sem_key"])
        if sem_idx is None:
            return (f"semantic node {p['sem_key']['op']} vanished from "
                    f"the plan")
        if rel_idx > sem_idx:
            return (f"pushdown claimed {opt_nodes[rel_idx].op} runs "
                    f"before {p['sem_key']['op']} but it does not")
        legal, why = commute_legal(opt_nodes[rel_idx], p["sem_node"])
        if not legal:
            return f"commute is illegal: {why}"
        # the pushed node's read-set must be satisfiable at its NEW
        # position — columns it reads exist before the semantic node
        schemas = infer_schema(source, opt_nodes)
        avail = (schemas[rel_idx - 1] if rel_idx > 0
                 else table_schema(source))
        reads = set(opt_nodes[rel_idx].info.get("cols") or ())
        if opt_nodes[rel_idx].op == "order_by":
            if not opt_nodes[rel_idx].info.get("key_is_callable"):
                reads = {opt_nodes[rel_idx].info.get("key")}
        missing = {c for c in reads if c and c not in avail}
        if missing:
            return (f"pushed {opt_nodes[rel_idx].op} reads "
                    f"{sorted(missing)}, unavailable at its new "
                    f"position")
        return None

    if ob.kind == "fusion_exact":
        for node in opt_nodes:
            if node.op != "llm_fused":
                continue
            info = node.info
            if (list(info.get("kinds", ())) == p["kinds"]
                    and list(info.get("cols", ())) == p["cols"]
                    and list(info.get("outs", ())) == p["outs"]
                    and list(info.get("prompts", ())) == p["prompts"]):
                if ctx is not None:
                    idents = set()
                    for spec in p["models"]:
                        try:
                            idents.add(ctx.resolve_model(spec))
                        except KeyError:
                            return ("fused member MODEL no longer "
                                    "resolves")
                    if len(idents) > 1:
                        return ("fused members resolve to different "
                                "models")
                return None
        return "no llm_fused node matches the fused group"

    if ob.kind == "mask_equivalence":
        naive_f = _plan_filter_multiset(ctx, naive_nodes)
        opt_f = _plan_filter_multiset(ctx, opt_nodes)
        if naive_f != opt_f:
            return (f"filter predicate multiset changed: "
                    f"{sorted(naive_f.items())} -> "
                    f"{sorted(opt_f.items())}")
        if p.get("spec_chain") or p.get("spec_map"):
            want = sorted(_prompt_fingerprint(s) for s in p["prompts"])
            # a chain chosen for chain-speculation may later be absorbed
            # into an llm_spec_map by the map-past-filter rule — either
            # node form discharges the chain's claim
            ops = (("llm_spec_chain", "llm_spec_map")
                   if p.get("spec_chain") else ("llm_spec_map",))
            for node in opt_nodes:
                if node.op not in ops:
                    continue
                got = sorted(
                    _prompt_fingerprint(m.get("prompt"))
                    for m in node.info.get("member_specs", ()))
                if got == want:
                    return None
            if p.get("spec_chain"):
                return "no llm_spec_chain node carries the chain members"
            return "no llm_spec_map node carries the filter members"
        return None

    if ob.kind == "selection_invariance":
        idx = _find_node(opt_nodes, p["key"])
        if idx is None:
            return "pruned retrieval node vanished from the plan"
        info = _retrieval_info(opt_nodes[idx])
        if not info.get("prune_corpus"):
            return "prune_corpus flag missing on the rewritten node"
        if info.get("corpus_filter") is None:
            return ("corpus predicate dropped — pruning may only move "
                    "WHERE the predicate applies, never remove it")
        return None

    if ob.kind == "recall_contract":
        idx = _find_node(opt_nodes, p["key"])
        if idx is None:
            return "retrieval node vanished from the plan"
        info = _retrieval_info(opt_nodes[idx])
        if p.get("spec_rerank"):
            node = opt_nodes[idx]
            if node.op != "spec_rerank":
                return "speculative rerank node vanished from the plan"
            if node.info.get("k") != p["k"]:
                return (f"spec_rerank k drifted: claimed {p['k']}, "
                        f"plan has {node.info.get('k')}")
            # reconciliation is structural: the authoritative retrieval
            # runs unchanged inside the node, so the final top-k is the
            # serial one by construction — only identity + k can drift
            return None
        if "candidate_k" in p:
            ck = info.get("candidate_k")
            if ck is None or ck < max(p["k"], 1):
                return (f"candidate depth {ck!r} no longer covers the "
                        f"final top-{p['k']}")
            if ck != p["candidate_k"]:
                return (f"candidate_k drifted: claimed "
                        f"{p['candidate_k']}, plan has {ck}")
            return None
        # ann_select contract
        if info.get("ann_resolved") != p["choice"]:
            return (f"ann choice drifted: claimed {p['choice']!r}, "
                    f"plan has {info.get('ann_resolved')!r}")
        if p["choice"] == "exact":
            return None
        nlist, nprobe = info.get("ann_nlist"), info.get("ann_nprobe")
        if not (nlist and nprobe and 1 <= nprobe <= nlist):
            return (f"IVF knobs out of range: nprobe={nprobe} "
                    f"nlist={nlist}")
        if (p.get("mode") == "auto"
                and p["recall_est"] < p["recall_target"]):
            return (f"auto-selected IVF misses the recall target: "
                    f"est {p['recall_est']:.2f} < "
                    f"{p['recall_target']:.2f}")
        return None

    if ob.kind == "index_shared":
        if ctx is None:
            return None
        hits = 0
        for node in opt_nodes:
            if node.op not in RETRIEVAL_OPS:
                continue
            if node.info.get("corpus_fp") != p["fp"]:
                continue
            if "model" not in node.info:
                continue
            try:
                if ctx.resolve_model(node.info["model"]).ref == p["ref"]:
                    hits += 1
            except KeyError:
                return "shared-index MODEL no longer resolves"
        if hits < 2:
            return (f"claimed shared corpus index but only {hits} "
                    f"node(s) reference (model={p['ref']}, corpus)")
        return None

    if ob.kind == "schema_preserved":
        naive_sch = infer_schema(source, naive_nodes)
        opt_sch = infer_schema(source, opt_nodes)
        a = naive_sch[-1] if naive_sch else table_schema(source)
        b = opt_sch[-1] if opt_sch else table_schema(source)
        if set(a.names) != set(b.names):
            only_a = sorted(set(a.names) - set(b.names))
            only_b = sorted(set(b.names) - set(a.names))
            return (f"output schema changed: optimized plan "
                    f"{'drops ' + str(only_a) if only_a else ''}"
                    f"{' adds ' + str(only_b) if only_b else ''}")
        for name in a.names:
            da, db = a.get(name).dtype, b.get(name).dtype
            if not _dtype_compatible(da, db):
                return (f"column {name!r} changed dtype: "
                        f"{da} -> {db}")
        return None

    return f"unknown obligation kind {ob.kind!r}"


def verify_rewrites(ctx, source: Table, naive_nodes: Sequence,
                    opt) -> List[Diagnostic]:
    """Discharge every obligation the optimizer emitted for one
    rewritten plan (``opt`` is an ``optimizer.OptimizedPlan``).  Each
    failure is an FLK010 error diagnostic; an empty return means every
    rewrite's soundness claim held on the optimized plan."""
    diags: List[Diagnostic] = []
    for ob in getattr(opt, "obligations", ()):
        try:
            reason = _discharge(ctx, source, list(naive_nodes),
                                list(opt.nodes), ob)
        except (KeyError, IndexError, TypeError) as exc:
            reason = f"verifier could not evaluate the claim: {exc!r}"
        if reason is not None:
            diags.append(Diagnostic(
                "FLK010", "error",
                f"obligation {ob} not discharged: {reason}"))
    return diags
