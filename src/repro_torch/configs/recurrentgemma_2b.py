"""recurrentgemma-2b (Griffin) — RG-LRU + local attention 1:2
[arXiv:2402.19427]. Sub-quadratic: runs the long_500k shape."""
from .base import LoRAConfig, ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,  # MQA on the local-attention layers
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    activation="gelu",  # GeGLU
    rope_theta=10000.0,
    window_size=2048,
    tie_embeddings=True,
    rglru=RGLRUConfig(lru_width=2560, conv_width=4,
                      block_pattern=("rec", "rec", "attn")),
    subquadratic=True,
    lora=LoRAConfig(rank=32),
)
