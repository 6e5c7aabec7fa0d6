"""Shared neural building blocks (PyTorch counterpart of ``repro.models.common``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm computed in f32 with the ``(1 + scale)`` parametrization.
    ``F.rms_norm`` is the same ``x·rsqrt(mean(x²) + eps)`` in fewer
    launches (the decode step is bound by the host's launches)."""
    out = F.rms_norm(x.float(), (x.shape[-1],), eps=eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def init_rms(d: int, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.zeros((d,), dtype=dtype, device=device)  # (1 + scale)


def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: F.relu(x).square()
    raise ValueError(f"unknown activation {name!r}")


# --------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (..., seq, 1, head_dim/2), for ``positions``
    (..., seq) int. Every layer of one step rotates by the same tables, so
    a caller builds them once per step."""
    freqs = rope_freqs(head_dim, theta, positions.device)  # (hd/2,)
    angles = positions[..., :, None].float() * freqs  # (..., s, hd/2)
    return torch.cos(angles)[..., :, None, :], torch.sin(angles)[..., :, None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE by precomputed :func:`rope_tables`; x: (..., seq, heads, hd)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int. The two
    halves of head_dim rotate together (not interleaved)."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


def mrope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                 sections: tuple[int, int, int]) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of Qwen2-VL's multimodal RoPE, each (B, seq, 1,
    head_dim/2), for ``positions`` (3, B, seq) int: temporal, height and
    width position ids. The head_dim/2 frequency slots fall into 3
    ``sections``; slot i of section j rotates by ``positions[j]``. With the
    three streams equal this is :func:`rope_tables` (text only)."""
    freqs = rope_freqs(head_dim, theta, positions.device)  # (hd/2,)
    sec = torch.cat([torch.full((s,), i, dtype=torch.long, device=positions.device)
                     for i, s in enumerate(sections)])  # (hd/2,) in {0, 1, 2}
    pos = positions[sec].movedim(0, -1)  # (B, seq, hd/2)
    angles = pos.float() * freqs
    return torch.cos(angles)[..., :, None, :], torch.sin(angles)[..., :, None, :]


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE of x (B, seq, heads, head_dim) at
    ``positions`` (3, B, seq); see :func:`mrope_tables`."""
    return rotate(x, *mrope_tables(positions, x.shape[-1], theta, sections))


# ------------------------------------------------------------------- inits
def dense_init(gen: torch.Generator, shape: tuple[int, ...], dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Glorot-normal ``(..., d_in, d_out)``, drawn from ``gen`` on its own
    device and then moved to ``device``."""
    d_in, d_out = shape[-2], shape[-1]
    scale = (2.0 / (d_in + d_out)) ** 0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (w * scale).to(device=device, dtype=dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32, device=gen.device)
    return (w * 0.02).to(device=device, dtype=dtype)


# ----------------------------------------------------------------- LoRA op
def lora_delta(
    x: torch.Tensor,  # (B, S, d_in)
    lora_a: torch.Tensor,  # (n_slots, d_in, r)
    lora_b: torch.Tensor,  # (n_slots, r, d_out)
    adapter_ids: torch.Tensor,  # (B,) int; a negative id is a base-model row
    scale: float,
) -> torch.Tensor:
    """Batched multi-LoRA delta ``(x @ A_i) @ B_i · scale``; a negative id
    gives exactly 0 (the row runs with the adapter inactive)."""
    ids = adapter_ids.to(x.device).long()
    safe = ids.clamp(min=0)  # clamp so the gather stays in range
    h = torch.einsum("bsd,bdr->bsr", x, lora_a[safe])
    delta = torch.einsum("bsr,bro->bso", h, lora_b[safe]) * scale
    live = (ids >= 0).to(delta.dtype)[:, None, None]
    return delta * live


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                k_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Boolean (..., q, k) mask: key visible iff k_pos <= q_pos (and valid)."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if k_valid is not None:
        m = m & k_valid[..., None, :]
    return m


def window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int) -> torch.Tensor:
    """:func:`causal_mask` restricted to the last ``window`` positions:
    key visible iff q_pos - window < k_pos <= q_pos."""
    m = causal_mask(q_pos, k_pos)
    return m & (k_pos[..., None, :] > q_pos[..., :, None] - window)


def scaled(part, width: int):
    """A part [u0, u1) of heads or channels (None: all) as the part of
    their ``width``-wide columns (tensor parallelism's layouts)."""
    return None if part is None else (part[0] * width, part[1] * width)
