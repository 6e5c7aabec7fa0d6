"""Distributed substrate (PyTorch counterpart of ``repro.distributed``):
the sharding rules, checkpointing, elastic recovery and gradient
compression, with the names the reference exports; and the port's own
multi-device layer: the sharded train step (tensor parallelism over a
("data", "model") ``DeviceMesh``, ZeRO-1 moments), the sharded prefill and
decode steps, and the rank runner."""

from .checkpoint import CheckpointManager, RequestJournal
from .compression import CompressionState, compress_decompress, init_state, wire_bytes
from .elastic import ElasticPlan, build_mesh, plan_mesh, reshard
from .sharded_serve import (
    make_sharded_decode_step,
    make_sharded_prefill_step,
    serve_state_specs,
    sharded_model,
    whole_cache,
)
from .sharding import (
    batch_specs,
    cache_specs,
    make_shardings,
    moment_specs,
    param_specs,
)

__all__ = [
    "CheckpointManager",
    "CompressionState",
    "ElasticPlan",
    "RequestJournal",
    "batch_specs",
    "build_mesh",
    "cache_specs",
    "compress_decompress",
    "init_state",
    "make_sharded_decode_step",
    "make_sharded_prefill_step",
    "make_shardings",
    "moment_specs",
    "param_specs",
    "plan_mesh",
    "reshard",
    "serve_state_specs",
    "sharded_model",
    "whole_cache",
    "wire_bytes",
]
