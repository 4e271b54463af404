"""BM25 full-text index (paper Query 3 step 3 — the FTS retriever).

Okapi BM25 with k1/b defaults matching DuckDB's FTS extension (k1=1.2,
b=0.75).  Pure numpy over a CSR-ish postings layout; scoring a query scans
only the postings of the query terms.

A copy of ``repro/retrieval/bm25.py``; its only difference is this
paragraph.
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import Dict, List, Sequence

import numpy as np

_TOKEN_RE = re.compile(r"[a-z0-9]+")


def tokenize(text: str) -> List[str]:
    return _TOKEN_RE.findall(str(text).lower())


class BM25Index:
    def __init__(self, k1: float = 1.2, b: float = 0.75):
        self.k1 = k1
        self.b = b
        self._postings: Dict[str, list] = {}
        self._doc_len = np.zeros(0, np.float64)
        self._n_docs = 0
        self._avgdl = 0.0

    @classmethod
    def build(cls, docs: Sequence[str], **kw) -> "BM25Index":
        idx = cls(**kw)
        postings: Dict[str, list] = defaultdict(list)
        lens = []
        for d, text in enumerate(docs):
            toks = tokenize(text)
            lens.append(len(toks))
            for term, tf in Counter(toks).items():
                postings[term].append((d, tf))
        idx._postings = {
            t: (np.array([d for d, _ in ps], np.int64),
                np.array([tf for _, tf in ps], np.float64))
            for t, ps in postings.items()}
        idx._doc_len = np.asarray(lens, np.float64)
        idx._n_docs = len(docs)
        idx._avgdl = float(idx._doc_len.mean()) if len(docs) else 0.0
        return idx

    def idf(self, term: str) -> float:
        n_t = len(self._postings.get(term, ((), ()))[0])
        # BM25+-style floor keeps idf non-negative
        return math.log(1.0 + (self._n_docs - n_t + 0.5) / (n_t + 0.5))

    def score(self, query: str) -> np.ndarray:
        """BM25 score of every document for ``query`` (0 when no overlap)."""
        scores = np.zeros(self._n_docs, np.float64)
        if not self._n_docs:
            return scores
        norm = 1.0 - self.b + self.b * self._doc_len / max(self._avgdl, 1e-9)
        for term, qf in Counter(tokenize(query)).items():
            if term not in self._postings:
                continue
            docs, tf = self._postings[term]
            idf = self.idf(term)
            s = idf * tf * (self.k1 + 1.0) / (tf + self.k1 * norm[docs])
            np.add.at(scores, docs, s * qf)
        return scores

    def score_many(self, queries: Sequence[str]) -> np.ndarray:
        """BM25 scores for a batch of queries in one vectorized pass:
        (len(queries), n_docs).

        Each term's per-doc score array is query-independent, so it is
        computed once per distinct term and scattered for every query
        that uses it with a single ``np.add.at``.  Scatter pairs are
        emitted in (query, per-query term) order — the same float
        accumulation order as ``score`` — so rows are bit-identical to
        the per-query path.
        """
        nq = len(queries)
        out = np.zeros((nq, self._n_docs), np.float64)
        if not self._n_docs or not nq:
            return out
        norm = 1.0 - self.b + self.b * self._doc_len / max(self._avgdl, 1e-9)
        term_scores: Dict[str, np.ndarray] = {}
        rows, cols, vals = [], [], []
        for qi, query in enumerate(queries):
            for term, qf in Counter(tokenize(str(query))).items():
                if term not in self._postings:
                    continue
                if term not in term_scores:
                    docs, tf = self._postings[term]
                    term_scores[term] = self.idf(term) * tf * (
                        self.k1 + 1.0) / (tf + self.k1 * norm[docs])
                docs = self._postings[term][0]
                rows.append(np.full(len(docs), qi, np.int64))
                cols.append(docs)
                vals.append(term_scores[term] * qf)
        if rows:
            np.add.at(out, (np.concatenate(rows), np.concatenate(cols)),
                      np.concatenate(vals))
        return out

    def topk(self, query: str, k: int = 100):
        scores = self.score(query)
        k = min(k, self._n_docs)
        idx = np.argpartition(-scores, k - 1)[:k] if k else np.array([], int)
        idx = idx[np.argsort(-scores[idx], kind="stable")]
        return idx, scores[idx]
