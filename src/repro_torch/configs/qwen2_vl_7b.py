"""qwen2-vl-7b — VLM backbone with M-RoPE [arXiv:2409.12191].

Backbone only: the vision tower is a STUB; input_specs() provides
precomputed patch embeddings merged into the token stream.
"""
from .base import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    activation="silu",
    rope_theta=1000000.0,
    mrope_sections=(16, 24, 24),  # t/h/w sections of head_dim//2
    tie_embeddings=False,
    frontend="vision",
    lora=LoRAConfig(rank=32),
)
