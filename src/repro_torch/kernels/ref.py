"""Plain PyTorch versions of the hand-written kernels.

Each function computes exactly what its kernel computes, with ordinary
tensor operations. The wrappers in ``kernels/`` take these for tensors that
lie on the CPU (the tests), and ``chip_smoke.py`` holds every CUDA kernel
against them on the card. Nothing on the main path calls them while a card
is present.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def sgmv_ref(
    x: torch.Tensor,  # (B, S, d_in)
    lora_a: torch.Tensor,  # (N, d_in, r)
    lora_b: torch.Tensor,  # (N, r, d_out)
    adapter_ids: torch.Tensor,  # (B,) int — negative marks a base-model row
    scale: float = 1.0,
) -> torch.Tensor:
    """Multi-LoRA delta alone: ``scale·(x·A[id])·B[id]``.

    A negative id gives a zero delta; the id is clamped only for the
    gather."""
    ids = adapter_ids.long()
    safe = ids.clamp(min=0)
    h = torch.einsum("bsd,bdr->bsr", x.float(), lora_a[safe].float())
    delta = torch.einsum("bsr,bro->bso", h, lora_b[safe].float()) * scale
    delta = delta * (ids >= 0).to(delta.dtype)[:, None, None]
    return delta.to(x.dtype)


def fused_sgmv_ref(
    x: torch.Tensor,  # (B, S, d_in)
    w: torch.Tensor,  # (d_in, d_out)
    lora_a: torch.Tensor,  # (N, d_in, r)
    lora_b: torch.Tensor,  # (N, r, d_out)
    adapter_ids: torch.Tensor,  # (B,) int — negative marks a base-model row
    scale: float = 1.0,
) -> torch.Tensor:
    """Fused base + LoRA projection: ``x·W + scale·(x·A[id])·B[id]``.

    A negative id keeps the base term and drops the delta."""
    base = torch.einsum("bsd,do->bso", x.float(), w.float())
    delta = sgmv_ref(x, lora_a, lora_b, adapter_ids, scale)
    return (base + delta.float()).to(x.dtype)


def ragged_extend_ref(
    q: torch.Tensor,  # (B, S, Hq, D)
    k: torch.Tensor,  # (B, T, Hkv, D)
    v: torch.Tensor,  # (B, T, Hkv, D)
    start: torch.Tensor,  # (B,) int
    true_lens: torch.Tensor,  # (B,) int
) -> torch.Tensor:
    """Suffix attention against the cache; padded query positions are zero.

    Query ``s`` of row ``b`` attends cache positions
    ``0 .. start[b] + s`` for ``s < true_lens[b]``."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    dev = q.device
    start = start.to(dev).long()
    true_lens = true_lens.to(dev).long()
    qg = q.float().reshape(B, S, Hkv, G, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / math.sqrt(D)
    q_pos = start[:, None] + torch.arange(S, device=dev)  # (B, S)
    k_pos = torch.arange(T, device=dev)
    valid = (k_pos[None, None, :] <= q_pos[:, :, None]) & (
        k_pos[None, None, :] < (start + true_lens)[:, None, None]
    )  # (B, S, T)
    logits = torch.where(valid[:, None, None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    w = torch.where(valid[:, None, None], w, 0.0)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    live = torch.arange(S, device=dev)[None, :] < true_lens[:, None]  # (B, S)
    out = out * live[:, :, None, None, None]
    return out.reshape(B, S, H, D).to(q.dtype)


def paged_attention_ref(
    q: torch.Tensor,  # (B, H, D)
    k_pages: torch.Tensor,  # (P, page_size, Hkv, D)
    v_pages: torch.Tensor,  # (P, page_size, Hkv, D)
    block_tables: torch.Tensor,  # (B, pages_per_seq) int
    lengths: torch.Tensor,  # (B,) int — tokens in each sequence
) -> torch.Tensor:
    """Single-token decode attention over a paged KV pool. A row whose
    length is 0 emits zeros, not mean(V)."""
    B, H, D = q.shape
    P, page, Hkv, _ = k_pages.shape
    pages_per_seq = block_tables.shape[1]
    G = H // Hkv
    dev = q.device
    tables = block_tables.to(dev).long()
    lengths = lengths.to(dev).long()
    T = pages_per_seq * page
    k = k_pages[tables].reshape(B, T, Hkv, D).float()
    v = v_pages[tables].reshape(B, T, Hkv, D).float()
    qg = q.float().reshape(B, Hkv, G, D)
    logits = torch.einsum("bkgd,btkd->bkgt", qg, k) / math.sqrt(D)
    valid = torch.arange(T, device=dev)[None, :] < lengths[:, None]  # (B, T)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    w = torch.where(valid[:, None, None, :], w, 0.0)
    out = torch.einsum("bkgt,btkd->bkgd", w, v)
    return out.reshape(B, H, D).to(q.dtype)

def flash_prefill_ragged_ref(
    q: torch.Tensor,  # (B, H, S, D) — S is the padded length
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,  # (B, Hkv, S, D)
    true_lens: torch.Tensor,  # (B,) int — live tokens per row (may be 0)
) -> torch.Tensor:
    """Causal attention over padded rows in the head-major layout; padded
    query positions and rows of length 0 are zeros. This is
    :func:`ragged_extend_ref` of a fresh sequence (start 0, T = S)."""
    start = torch.zeros((q.shape[0],), dtype=torch.int64, device=q.device)
    out = ragged_extend_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), start, true_lens)
    return out.transpose(1, 2)


def flash_prefill_ref(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,  # (B, Hkv, S, D)
) -> torch.Tensor:
    """Causal full-sequence GQA attention (fresh prefill)."""
    B, _, S, _ = q.shape
    full = torch.full((B,), S, dtype=torch.int64, device=q.device)
    return flash_prefill_ragged_ref(q, k, v, full)
