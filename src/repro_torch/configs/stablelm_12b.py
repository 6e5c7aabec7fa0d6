"""stablelm-12b — dense GQA decoder [hf:stabilityai/stablelm-2-12b]."""
from .base import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100352,
    activation="silu",
    rope_theta=10000.0,
    tie_embeddings=False,
    lora=LoRAConfig(rank=32),
)
