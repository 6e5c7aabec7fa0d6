"""Architecture registry: one module per assigned architecture."""
from .base import (
    ARCH_IDS,
    LM_SHAPES,
    PAPER_ARCH_IDS,
    LoRAConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    RGLRUConfig,
    RWKVConfig,
    ShapeConfig,
    get,
    get_shape,
    reduced,
    shape_cells,
)

__all__ = [
    "ARCH_IDS", "LM_SHAPES", "PAPER_ARCH_IDS", "LoRAConfig", "MLAConfig",
    "ModelConfig", "MoEConfig", "RGLRUConfig", "RWKVConfig", "ShapeConfig",
    "get", "get_shape", "reduced", "shape_cells",
]
