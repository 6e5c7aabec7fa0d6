"""llama-34b — the paper's base model (simulator benchmarks)."""
from .base import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama-34b", family="dense", num_layers=48, d_model=8192,
    num_heads=64, num_kv_heads=8, head_dim=128, d_ff=22016,
    vocab_size=32000, activation="silu", tie_embeddings=False,
    lora=LoRAConfig(rank=32),
)
