"""Serving layer: continuous-batching engine with FASTLIBRA cache management
(PyTorch counterpart of ``repro.serving``)."""

from .engine import EngineConfig, ServingEngine
from .metrics import ServingReport, summarize
from .prefill import (
    BatchPrefill,
    PrefillStats,
    assemble_batch,
    bucket_for,
    make_buckets,
)
from .request import Phase, Request
from .scheduler import StepPlan, TokenBudgetController, plan_step

__all__ = [
    "BatchPrefill",
    "EngineConfig",
    "Phase",
    "PrefillStats",
    "Request",
    "ServingEngine",
    "ServingReport",
    "StepPlan",
    "TokenBudgetController",
    "assemble_batch",
    "bucket_for",
    "make_buckets",
    "plan_step",
    "summarize",
]
