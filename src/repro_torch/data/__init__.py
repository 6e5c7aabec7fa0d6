"""Synthetic workload traces matched to the paper's three scenarios."""

from .traces import SimQuery, TraceConfig, generate_trace, trace_stats

__all__ = ["SimQuery", "TraceConfig", "generate_trace", "trace_stats"]
