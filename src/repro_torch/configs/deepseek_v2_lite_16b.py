"""deepseek-v2-lite-16b — MoE with multi-head latent attention
[arXiv:2405.04434]. MLA kv_lora=512; 2 shared + 64 routed experts, top-6."""
from .base import LoRAConfig, MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,  # MLA: shared latent, heads expand from kv_lora
    head_dim=128,
    d_ff=1408,  # expert hidden dim (spec)
    vocab_size=102400,
    activation="silu",
    rope_theta=10000.0,
    tie_embeddings=False,
    moe=MoEConfig(num_experts=64, top_k=6, num_shared=2, d_ff_expert=1408),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    lora=LoRAConfig(rank=32, targets=("q", "kv_a", "o")),
)
