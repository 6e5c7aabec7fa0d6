"""llama-13b — the paper's base model (simulator benchmarks)."""
from .base import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama-13b", family="dense", num_layers=40, d_model=5120,
    num_heads=40, num_kv_heads=40, head_dim=128, d_ff=13824,
    vocab_size=32000, activation="silu", tie_embeddings=False,
    lora=LoRAConfig(rank=32),
)
