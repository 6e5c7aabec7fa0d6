"""gemma-2b — dense MQA decoder [arXiv:2403.08295]."""
from .base import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,  # MQA
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    activation="gelu",  # GeGLU
    rope_theta=10000.0,
    tie_embeddings=True,
    lora=LoRAConfig(rank=32),
)
