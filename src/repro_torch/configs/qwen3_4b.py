"""qwen3-4b — dense GQA decoder with qk-norm [hf:Qwen/Qwen3-4B]."""
from .base import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    activation="silu",
    qk_norm=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    lora=LoRAConfig(rank=32),
)
