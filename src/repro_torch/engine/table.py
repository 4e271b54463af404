"""Minimal columnar Table (the DuckDB stand-in for paper Queries 1-3).

Columns are python lists / numpy arrays of equal length.  Operations are
vectorised where possible and always return new Tables (immutability keeps
plan re-execution deterministic for the cache/dedup benchmarks).

A copy of ``repro/engine/table.py``; its only difference is this
paragraph.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np


class Table:
    def __init__(self, columns: Dict[str, Sequence]):
        lens = {len(v) for v in columns.values()}
        if len(lens) > 1:
            raise ValueError(f"ragged columns: { {k: len(v) for k, v in columns.items()} }")
        self.columns = {k: list(v) for k, v in columns.items()}

    # ---- basics ------------------------------------------------------------
    def __len__(self):
        return len(next(iter(self.columns.values()), []))

    @property
    def column_names(self) -> List[str]:
        return list(self.columns)

    def column(self, name: str) -> list:
        return self.columns[name]

    def rows(self) -> List[dict]:
        names = self.column_names
        return [dict(zip(names, vals))
                for vals in zip(*[self.columns[n] for n in names])]

    def head(self, n: int = 5) -> "Table":
        return Table({k: v[:n] for k, v in self.columns.items()})

    # ---- relational ops ------------------------------------------------------
    def select(self, *names: str) -> "Table":
        return Table({n: self.columns[n] for n in names})

    def with_column(self, name: str, values: Sequence) -> "Table":
        cols = dict(self.columns)
        cols[name] = list(values)
        return Table(cols)

    def filter_mask(self, mask: Sequence[bool]) -> "Table":
        return Table({k: [x for x, m in zip(v, mask) if m]
                      for k, v in self.columns.items()})

    def filter(self, pred: Callable[[dict], bool]) -> "Table":
        return self.filter_mask([pred(r) for r in self.rows()])

    def order_by(self, key, desc: bool = False) -> "Table":
        if isinstance(key, str):
            vals = self.columns[key]
        else:
            vals = [key(r) for r in self.rows()]
        idx = np.argsort(np.asarray(vals), kind="stable")
        if desc:
            idx = idx[::-1]
        return self.take(idx)

    def take(self, indices) -> "Table":
        return Table({k: [v[i] for i in indices]
                      for k, v in self.columns.items()})

    def limit(self, n: int) -> "Table":
        return self.head(n)

    def lateral(self, fn) -> "Table":
        """LATERAL join: ``fn(i, row) -> Table`` of matches per row; the
        parent row's columns replicate once per match (paper Query 3:
        a retrieval operator expands each query row into its top-k
        candidate rows).  Match tables must share one schema; a row with
        an empty match table contributes no output rows."""
        parents = self.rows()
        matches = [fn(i, r) for i, r in enumerate(parents)]
        child_names: List[str] = []
        for m in matches:
            if m.column_names:
                child_names = m.column_names
                break
        out: Dict[str, list] = {n: [] for n in self.column_names}
        for n in child_names:
            if n in out:
                raise ValueError(
                    f"lateral match column {n!r} collides with a parent "
                    f"column")
            out[n] = []
        for row, m in zip(parents, matches):
            k = len(m)
            for n in self.column_names:
                out[n].extend([row[n]] * k)
            for n in child_names:
                out[n].extend(m.columns[n])
        return Table(out)

    def full_outer_join(self, other: "Table", on: str,
                        suffixes=("_l", "_r")) -> "Table":
        """FULL OUTER JOIN on one key column (paper Query 3 fusion step);
        missing side contributes None."""
        left_idx = {v: i for i, v in enumerate(self.columns[on])}
        right_idx = {v: i for i, v in enumerate(other.columns[on])}
        keys = list(dict.fromkeys(list(left_idx) + list(right_idx)))
        out: Dict[str, list] = {on: keys}
        for name in self.column_names:
            if name == on:
                continue
            n2 = name + (suffixes[0] if name in other.column_names else "")
            out[n2] = [self.columns[name][left_idx[k]]
                       if k in left_idx else None for k in keys]
        for name in other.column_names:
            if name == on:
                continue
            n2 = name + (suffixes[1] if name in self.column_names else "")
            out[n2] = [other.columns[name][right_idx[k]]
                       if k in right_idx else None for k in keys]
        return Table(out)

    def group_rows(self, key: str) -> Dict:
        groups: Dict = {}
        for r in self.rows():
            groups.setdefault(r[key], []).append(r)
        return groups

    def __repr__(self):
        n = len(self)
        cols = ", ".join(f"{k}" for k in self.column_names)
        lines = [f"Table[{n} rows: {cols}]"]
        for r in self.rows()[:8]:
            lines.append("  " + " | ".join(f"{k}={str(v)[:32]}"
                                           for k, v in r.items()))
        if n > 8:
            lines.append(f"  ... {n - 8} more")
        return "\n".join(lines)
