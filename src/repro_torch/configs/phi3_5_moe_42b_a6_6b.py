"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE, GQA
[hf:microsoft/Phi-3.5-MoE-instruct]."""
from .base import LoRAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    activation="silu",
    rope_theta=10000.0,
    tie_embeddings=False,
    moe=MoEConfig(num_experts=16, top_k=2, num_shared=0, d_ff_expert=6400),
    lora=LoRAConfig(rank=32),
)
