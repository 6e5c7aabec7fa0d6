"""Cache-aware GQA attention (PyTorch counterpart of ``repro.models.attention``).

Conventions follow the reference: ``p`` is one layer's parameter dict,
``lora`` maps a target to ``(A (slots, d_in, r), B (slots, r, d_out))`` and
``adapter_ids`` (B,) picks the slot per row. Only the dense GQA layout is
ported; sliding windows, int8 KV, logit softcap and MLA raise
``NotImplementedError`` (ROADMAP Queue 1 item 8).

Unlike the reference, which returns a new cache, :func:`gqa_cached` writes
the new K/V rows into the cache in place. Where it writes is decided once
per ``extend`` call by :func:`cached_step`, on the host: only real tokens of
kept rows, and only positions inside the cache (the reference's scatter
drops out-of-range rows without a word; torch indexing would raise).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..kernels import ops as kernel_ops
from .common import dense_init, init_rms, rms_norm, rope_tables, rotate

_UNPORTED = "not ported yet (ROADMAP Queue 1 item 8)"


def _proj(x, w, lora, name, adapter_ids, scale):
    """Base projection plus optional multi-LoRA delta. LoRA-targeted
    projections go through :func:`~repro_torch.kernels.fused_sgmv` (the CUDA
    kernel on the card, its plain version on the CPU); the rest are a plain
    matrix product."""
    if lora is not None and name in lora and adapter_ids is not None:
        a, b = lora[name]
        return kernel_ops.fused_sgmv(x, w, a, b, adapter_ids, scale=scale)
    return x @ w


def _page_size_for(T: int) -> int:
    """Largest preferred page size dividing the cache length."""
    for ps in (128, 64, 32, 16, 8):
        if T % ps == 0:
            return ps
    return 0  # no clean paging — caller falls back to ragged_extend


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the layouts this package does not run yet."""
    if cfg.mla is not None:
        raise NotImplementedError(f"MLA attention is {_UNPORTED}")
    if cfg.rwkv is not None or cfg.rglru is not None:
        raise NotImplementedError(
            "recurrent layouts are not ported yet (ROADMAP Queue 1 item 7)")
    if cfg.moe is not None:
        raise NotImplementedError(f"the MoE FFN is {_UNPORTED}")
    if cfg.window_size:
        raise NotImplementedError(f"sliding-window attention is {_UNPORTED}")
    if cfg.logit_softcap:
        raise NotImplementedError(f"logit softcap is {_UNPORTED}")
    if cfg.mrope_sections is not None:
        raise NotImplementedError(f"M-RoPE is {_UNPORTED}")
    if cfg.is_encdec:
        raise NotImplementedError(f"encoder-decoder models are {_UNPORTED}")


# =============================================================== GQA / MQA
def init_gqa(gen: torch.Generator, cfg: ModelConfig, n_layers: int,
             dtype=torch.float32, device=None) -> dict:
    """Layer-stacked GQA parameters, (n_layers, ...) per leaf."""
    d, hd, L = cfg.d_model, cfg.resolved_head_dim, n_layers
    p = {
        "wq": dense_init(gen, (L, d, cfg.num_heads * hd), dtype, device),
        "wk": dense_init(gen, (L, d, cfg.num_kv_heads * hd), dtype, device),
        "wv": dense_init(gen, (L, d, cfg.num_kv_heads * hd), dtype, device),
        "wo": dense_init(gen, (L, cfg.num_heads * hd, d), dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rms(hd, dtype, device).expand(L, hd).contiguous()
        p["k_norm"] = init_rms(hd, dtype, device).expand(L, hd).contiguous()
    return p


def _qkv(p, x, cfg: ModelConfig, rope, lora, adapter_ids, lora_scale):
    """q, k, v of one layer; ``rope`` is the step's (cos, sin) tables."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = _proj(x, p["wq"], lora, "q", adapter_ids, lora_scale)
    k = _proj(x, p["wk"], lora, "k", adapter_ids, lora_scale)
    v = _proj(x, p["wv"], lora, "v", adapter_ids, lora_scale)
    q = q.reshape(B, S, cfg.num_heads, hd)
    k = k.reshape(B, S, cfg.num_kv_heads, hd)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return rotate(q, *rope), rotate(k, *rope), v


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: torch.Tensor) -> torch.Tensor:
    """GQA scaled-dot-product attention, written out (the plain form).

    q: (B,S,Hq,D)  k/v: (B,T,Hkv,D)  mask: (B,S,T) or (1,S,T) bool.
    """
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    q = q.reshape(B, S, Hkv, G, D)
    logits = torch.einsum("bskgd,btkd->bkgst", q, k).float() / math.sqrt(D)
    logits = torch.where(mask[:, None, None, :, :], logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(B, S, Hq, v.shape[-1])


@dataclasses.dataclass
class CachedStep:
    """Where one ``extend`` call reads and writes the dense cache, shared by
    every layer. Index tensors live on the model's device."""

    rope: tuple[torch.Tensor, torch.Tensor]  # (cos, sin) at the positions
    start: torch.Tensor  # (B,) int32 — cache length before the chunk
    true_lens: Optional[torch.Tensor]  # (B,) int32; None: no token mask
    dst: torch.Tensor  # (n,) flat b·T + position of every written token
    src: torch.Tensor  # (n,) flat b·S + s of the same tokens
    page_size: int  # > 0: S == 1 without mask decodes through the pages
    tables: Optional[torch.Tensor]  # (B, T / page_size) int32
    lengths: Optional[torch.Tensor]  # (B,) int32 = start + 1


def cached_step(start, S: int, T: int, device, cfg: ModelConfig,
                true_lens=None, keep_rows=None) -> CachedStep:
    """Plan one ``extend`` of S tokens per row at offsets ``start``, with
    the RoPE tables of ``cfg`` at those positions.

    ``start``, ``true_lens`` (B,) and ``keep_rows`` (B,) bool are host-side
    values (numpy or CPU tensors; a CUDA tensor is copied to the host), so
    the plan costs no device round trip. A token is written iff it is real
    (``s < true_lens[b]``, or all S without ``true_lens``), its row is kept,
    and its position lies inside the cache."""
    start_h = torch.as_tensor(start).to("cpu", torch.int64)
    B = start_h.shape[0]
    ar = torch.arange(S)
    pos = start_h[:, None] + ar[None, :]  # (B, S)
    write = pos < T
    if true_lens is not None:
        tl_h = torch.as_tensor(true_lens).to("cpu", torch.int64)
        write &= ar[None, :] < tl_h[:, None]
    if keep_rows is not None:
        write &= torch.as_tensor(keep_rows).to("cpu", torch.bool)[:, None]
    b_idx, s_idx = write.nonzero(as_tuple=True)
    ps = _page_size_for(T) if (S == 1 and true_lens is None) else 0
    tables = lengths = None
    if ps:
        pages = T // ps
        tables = torch.arange(B * pages, dtype=torch.int32).reshape(B, pages)
        lengths = (start_h + 1).to(torch.int32)

    def dev(t):
        return None if t is None else t.to(device, non_blocking=True)

    return CachedStep(
        rope=rope_tables(dev(pos), cfg.resolved_head_dim, cfg.rope_theta),
        start=dev(start_h.to(torch.int32)),
        true_lens=None if true_lens is None else dev(tl_h.to(torch.int32)),
        dst=dev(b_idx * T + pos[b_idx, s_idx]),
        src=dev(b_idx * S + s_idx),
        page_size=ps,
        tables=dev(tables),
        lengths=dev(lengths),
    )


def gqa_cached(
    p: dict,
    x: torch.Tensor,  # (B, S, d)
    step: CachedStep,
    cache_k: torch.Tensor,  # (B, T, Hkv, D) — updated in place
    cache_v: torch.Tensor,
    cfg: ModelConfig,
    *,
    lora=None,
    adapter_ids=None,
    lora_scale: float = 1.0,
    window: int = 0,
) -> torch.Tensor:
    """Suffix attention against the dense cache (decode S=1, or chunked
    prefill). Writes the chunk's K/V into the cache as ``step`` says, then
    attends through the kernels on the reference's own routing
    (``repro.models.attention.gqa_cached``): S == 1 without a token mask and
    a page size dividing T decodes through ``paged_attention`` over the
    cache viewed as contiguous pages (tables = arange, lengths = start + 1);
    every other case goes through ``ragged_extend``."""
    if window or cfg.logit_softcap:
        raise NotImplementedError(f"windowed / softcapped attention is {_UNPORTED}")
    B, S, _ = x.shape
    T, Hkv, Dh = cache_k.shape[1], cache_k.shape[2], cache_k.shape[3]
    q, k, v = _qkv(p, x, cfg, step.rope, lora, adapter_ids, lora_scale)
    for cache, new in ((cache_k, k), (cache_v, v)):
        cache.view(B * T, Hkv, Dh).index_copy_(
            0, step.dst, new.reshape(B * S, Hkv, Dh).index_select(0, step.src))
    if S == 1 and step.true_lens is None:
        ps = step.page_size
        if ps > 0:
            pages = T // ps
            out = kernel_ops.paged_attention(
                q[:, 0],
                cache_k.view(B * pages, ps, Hkv, Dh),
                cache_v.view(B * pages, ps, Hkv, Dh),
                step.tables,
                step.lengths,
            )[:, None]
        else:
            out = kernel_ops.ragged_extend(
                q, cache_k, cache_v, step.start,
                torch.ones_like(step.start))
    else:
        true_lens = step.true_lens
        if true_lens is None:
            true_lens = torch.full_like(step.start, S)
        out = kernel_ops.ragged_extend(q, cache_k, cache_v, step.start, true_lens)
    out = out.reshape(B, S, -1)
    return _proj(out, p["wo"], lora, "o", adapter_ids, lora_scale)
