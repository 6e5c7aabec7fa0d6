"""Discrete-event serving simulator (paper-scale figure reproduction)."""

from .hardware import DeployedModel, NPUSpec
from .simulator import ServingSimulator, SimConfig, SimRequest, SimResult

__all__ = [
    "DeployedModel",
    "NPUSpec",
    "ServingSimulator",
    "SimConfig",
    "SimRequest",
    "SimResult",
]
