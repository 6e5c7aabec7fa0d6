"""rwkv6-1.6b (Finch) — attention-free SSM with data-dependent decay
[arXiv:2404.05892]. Sub-quadratic: runs the long_500k shape."""
from .base import LoRAConfig, ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,       # d_model / rwkv.head_dim
    num_kv_heads=32,    # unused (attention-free)
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    activation="relu2",
    tie_embeddings=False,
    rwkv=RWKVConfig(head_dim=64, ddlerp_rank=32, decay_rank=64),
    subquadratic=True,
    lora=LoRAConfig(rank=32, targets=("r", "k", "v", "o")),
)
