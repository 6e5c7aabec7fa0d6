"""seamless-m4t-large-v2 — enc-dec audio backbone [arXiv:2308.11596].

The modality frontend (speech encoder frontend) is a STUB: input_specs()
provides precomputed frame embeddings of shape (batch, src_len, d_model).
"""
from .base import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,          # decoder
    encoder_layers=24,      # encoder
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    activation="silu",
    rope_theta=10000.0,
    tie_embeddings=False,
    frontend="audio",
    lora=LoRAConfig(rank=32),
)
