"""Adaptive context-window batching (paper §2.3 "Batching").

FlockMTL packs as many tuples as fit the model's context window into a
single request; if the provider reports an output/context overflow the
batch shrinks by 10% and retries; a single tuple that still overflows
yields NULL.  The same protocol drives the port's in-cluster
``LocalTorchProvider``.

A copy of ``repro/core/batching.py``; its only difference is this
docstring.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence


class ContextOverflowError(Exception):
    """Raised by providers when a request exceeds the context budget."""


@dataclass
class BatchPlan:
    batches: List[List[int]]            # tuple indices per request
    est_tokens: List[int]               # estimated prompt tokens per request


@dataclass
class BatchStats:
    requests: int = 0
    retries: int = 0
    nulls: int = 0
    packed: int = 0   # batches merged into another job's co-packed request
    batch_sizes: List[int] = field(default_factory=list)
    # wall seconds per successful provider request, in completion order;
    # feeds the calibrated cost model (SemanticContext.record_calibration)
    latencies: List[float] = field(default_factory=list)


def plan_batches(token_costs: Sequence[int], prefix_tokens: int,
                 context_window: int, max_output_tokens: int,
                 max_batch: int = 0, headroom: float = 1.0) -> BatchPlan:
    """Greedy fill until the context budget is reached (order-preserving).

    budget per request = (context_window - prefix_tokens) * headroom -
    expected output (output scales with batch size: ~max_output_tokens
    per tuple).  ``headroom`` < 1.0 deliberately under-fills: it is the
    calibration feedback path — a model whose requests routinely
    overflow (token estimates undercount serialization framing) plans
    smaller batches up front instead of paying split-and-requeue
    (``SemanticContext.batch_headroom``).

    ``est_tokens`` is the estimated PROMPT tokens per request (tuple
    payloads only; callers add prefix_tokens themselves) — expected
    output tokens participate in the budget accounting but are not part
    of the estimate.
    """
    batches, est = [], []
    cur, cur_tokens, cur_prompt = [], 0, 0
    budget = int((context_window - prefix_tokens) * headroom)
    for i, cost in enumerate(token_costs):
        out_cost = max_output_tokens
        add = cost + out_cost
        if cur and (cur_tokens + add > budget
                    or (max_batch and len(cur) >= max_batch)):
            batches.append(cur)
            est.append(cur_prompt)
            cur, cur_tokens, cur_prompt = [], 0, 0
        cur.append(i)
        cur_tokens += add
        cur_prompt += cost
    if cur:
        batches.append(cur)
        est.append(cur_prompt)
    return BatchPlan(batches=batches, est_tokens=est)


# NOTE: the deprecated ``run_adaptive`` compat alias was removed; the
# adaptive executor lives in ``scheduler.py`` as ``execute_serial`` (the
# ``scheduler=None`` path; the concurrent dispatch engine shares its
# split-and-requeue logic).  This module keeps only the pure planner.
