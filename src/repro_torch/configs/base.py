"""Model / system configuration dataclasses and the architecture registry.

Every assigned architecture gets a ``src/repro/configs/<id>.py`` exporting a
``CONFIG`` built from these dataclasses; ``repro_torch.configs.get(name)`` resolves
them (``--arch <id>`` in the launchers). ``reduced()`` derives the small
CPU-smoke variant of any config.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared: int = 0
    d_ff_expert: int = 0  # per-expert hidden dim
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0  # 0 = full-rank q projection (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def kv_cache_dim(self) -> int:
        return self.kv_lora_rank + self.qk_rope_head_dim


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    ddlerp_rank: int = 32  # data-dependent token-shift low-rank
    decay_rank: int = 64


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0  # 0 = d_model
    conv_width: int = 4
    c_exponent: float = 8.0
    block_pattern: tuple[str, ...] = ("rec", "rec", "attn")


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 32
    alpha: float = 32.0
    targets: tuple[str, ...] = ("q", "k", "v", "o")
    max_adapters: int = 8  # resident simultaneously (HBM slot table)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 = d_model // num_heads
    activation: str = "silu"  # silu (SwiGLU) | gelu (GeGLU)
    qk_norm: bool = False
    rope_theta: float = 10000.0
    mrope_sections: Optional[tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    logit_softcap: float = 0.0  # gemma-style
    window_size: int = 0  # sliding-window size for local attention layers
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    rwkv: Optional[RWKVConfig] = None
    rglru: Optional[RGLRUConfig] = None
    lora: LoRAConfig = dataclasses.field(default_factory=LoRAConfig)
    # encoder-decoder (seamless): encoder depth; frontend embeddings replace
    # token embeddings on the encoder side (modality stub).
    encoder_layers: int = 0
    frontend: Optional[str] = None  # None | "audio" | "vision"
    # True if attention is sub-quadratic / state-based (long_500k eligible)
    subquadratic: bool = False
    # "jnp" (einsum correctness pin) or "pallas" (the kernels in
    # repro_torch.kernels drive gqa_cached / gqa_full / LoRA projections; interpret
    # mode is auto-detected on CPU). The serving engine overrides this from
    # EngineConfig.kernel_backend; see README.md §Kernels.
    kernel_backend: str = "jnp"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """Per-token KV-cache footprint — feeds the cache manager's block math."""
        if self.mla is not None:
            per_layer = self.mla.kv_cache_dim
        elif self.rwkv is not None:
            # state snapshot amortized per prefix node, not per token; use the
            # per-boundary snapshot size divided by the snapshot stride.
            hd = self.rwkv.head_dim
            heads = self.d_model // hd
            return (heads * hd * hd + 2 * self.d_model) * self.num_layers * dtype_bytes // 32
        else:
            per_layer = 2 * self.num_kv_heads * self.resolved_head_dim
        layers = self.num_layers
        if self.rglru is not None:
            pat = self.rglru.block_pattern
            attn_frac = pat.count("attn") / len(pat)
            layers = max(1, int(round(self.num_layers * attn_frac)))
        return per_layer * layers * dtype_bytes

    def num_params(self) -> int:
        """Approximate parameter count (embedding + blocks)."""
        d, ff, L = self.d_model, self.d_ff, self.num_layers
        hd = self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.mla is not None:
            m = self.mla
            attn = (
                d * self.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
                + self.num_heads * m.v_head_dim * d
            )
        elif self.rwkv is not None:
            attn = 6 * d * d  # r,k,v,g,o,w-ish
        else:
            attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
        if self.moe is not None:
            ffw = 3 * d * self.moe.d_ff_expert * (self.moe.num_experts + self.moe.num_shared)
            ffw += d * self.moe.num_experts  # router
        else:
            ffw = 3 * d * ff
        layers = L + self.encoder_layers
        return emb + layers * (attn + ffw)

    def active_params(self) -> int:
        """Activated parameters per token (MoE-aware) — for MODEL_FLOPS."""
        if self.moe is None:
            return self.num_params()
        d, L = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.mla is not None:
            m = self.mla
            attn = (
                d * self.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
                + self.num_heads * m.v_head_dim * d
            )
        else:
            attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
        ffw = 3 * d * self.moe.d_ff_expert * (self.moe.top_k + self.moe.num_shared)
        ffw += d * self.moe.num_experts
        return emb + L * (attn + ffw)

    def lora_bytes(self, rank: int, dtype_bytes: int = 2) -> int:
        """Size of one adapter at ``rank`` over ``lora.targets``."""
        d = self.d_model
        hd = self.resolved_head_dim
        out_dims = {
            "q": self.num_heads * hd,
            "k": self.num_kv_heads * hd,
            "v": self.num_kv_heads * hd,
            "o": d,
        }
        layers = self.num_layers + self.encoder_layers
        total = 0
        for t in self.lora.targets:
            od = out_dims.get(t, d)
            total += rank * (d + od)
        return total * layers * dtype_bytes


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode | long_decode


LM_SHAPES: tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "long_decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


ARCH_IDS = (
    "gemma-2b",
    "stablelm-12b",
    "qwen3-4b",
    "qwen3-0.6b",
    "seamless-m4t-large-v2",
    "qwen2-vl-7b",
    "rwkv6-1.6b",
    "deepseek-v2-lite-16b",
    "phi3.5-moe-42b-a6.6b",
    "recurrentgemma-2b",
)

# paper's own base models (for the simulator benchmarks)
PAPER_ARCH_IDS = ("llama-7b", "llama-13b", "llama-34b")

_MODULE_FOR = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS + PAPER_ARCH_IDS}


def get(name: str) -> ModelConfig:
    """Resolve ``--arch <id>`` to its ModelConfig."""
    if name not in _MODULE_FOR:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULE_FOR)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[name]}")
    return mod.CONFIG


def shape_cells(arch: str) -> list[ShapeConfig]:
    """The (arch × shape) dry-run cells, with documented skips applied."""
    cfg = get(arch)
    out = []
    for s in LM_SHAPES:
        if s.kind == "long_decode" and not cfg.subquadratic:
            continue  # full-attention archs skip long_500k (DESIGN.md §4)
        out.append(s)
    return out


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests."""
    kw: dict = dict(
        name=cfg.name + "-reduced",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads > 1 else 1,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
    )
    if cfg.mrope_sections is not None:
        half = kw["head_dim"] // 2
        a = half // 4
        kw["mrope_sections"] = (a, (half - a) // 2, half - a - (half - a) // 2)
    if cfg.moe is not None:
        # capacity_factor = E guarantees zero token drops (C == T·k) so the
        # smoke tests' prefill/forward parity is exact.
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=2, num_shared=min(1, cfg.moe.num_shared),
            d_ff_expert=32, capacity_factor=4.0,
        )
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(
            kv_lora_rank=32, q_lora_rank=0, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16,
        )
    if cfg.rwkv is not None:
        kw["rwkv"] = RWKVConfig(head_dim=16, ddlerp_rank=8, decay_rank=16)
    if cfg.rglru is not None:
        kw["rglru"] = dataclasses.replace(cfg.rglru, lru_width=64, conv_width=4)
        kw["num_layers"] = 3  # one full (rec, rec, attn) group
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
    if cfg.window_size:
        kw["window_size"] = 16
    kw["lora"] = LoRAConfig(rank=4, targets=cfg.lora.targets, max_adapters=4)
    return dataclasses.replace(cfg, **kw)
