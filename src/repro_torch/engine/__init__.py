"""The port's plan layer, engine half (a copy of ``repro/engine``):
``Pipeline`` and its optimizer, analyzer and retrieval operators."""

from .table import Table
from .analysis import (Diagnostic, Obligation, PlanValidationError,
                       Schema, analyze_plan, infer_schema,
                       verify_rewrites)
from .pipeline import Pipeline, PlanNode, ask, copack_identity
from .retrieval_ops import RETRIEVAL_OPS
from .optimizer import (OptimizedPlan, PlanCost, estimate_plan_cost,
                        optimize_plan)
