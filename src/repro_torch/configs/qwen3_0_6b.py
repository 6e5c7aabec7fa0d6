"""qwen3-0.6b — dense GQA decoder with qk-norm [hf:Qwen/Qwen3-0.6B]."""
from .base import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    activation="silu",
    qk_norm=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    lora=LoRAConfig(rank=32),
)
