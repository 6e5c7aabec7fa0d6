"""llama-7b — the paper's base model (simulator benchmarks)."""
from .base import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama-7b", family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=32, head_dim=128, d_ff=11008,
    vocab_size=32000, activation="silu", tie_embeddings=False,
    lora=LoRAConfig(rank=32),
)
